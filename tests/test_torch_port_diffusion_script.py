"""The baselines through the port's entry points on the CPU:
``scripts/train.py`` trains Diffusion Policy over an export (2 epochs x 3
steps, a checkpoint each epoch), ``policy_from_checkpoint`` rebuilds it
bit-equal, the EMA net included, and a fresh algo loaded from
``latest_full.state`` takes the writer's next step bit for bit; served
through the non-ICL ``RolloutPolicy`` and ``rollout_with_stats`` on the
synthetic env.

Reference fault (d), mirrored: the training script rolls out every
algorithm through ``ICLRolloutPolicy``, whose single-env call passes the
context batch where a baseline's ``get_action`` takes ``goal_dict`` too: a
baseline with rollouts on (single env, the default) raises TypeError at its
first rollout epoch, in the JAX script and in the port's; batched rollouts
run (the context batch lands in ``goal_dict``, which the baselines ignore).
"""

import json
import os

import numpy as np
import pytest
import torch

import lipvq_tpu.scripts.train as jax_train_script
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.export import hdf5_to_export
from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
from lipvq_tpu_torch.envs.rollout import rollout_with_stats
from lipvq_tpu_torch.scripts import train as port_train
from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

torch.set_num_threads(1)

LOW_DIM = ["robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "object"]


def _dp_config(data, output_dir, rollout=False, batched=False):
    return {
        "algo_name": "diffusion_policy",
        "train": {"data": data, "output_dir": output_dir, "num_epochs": 2, "batch_size": 4,
                  "cuda": False, "hdf5_cache_mode": "low_dim"},
        "experiment": {"epoch_every_n_steps": 3, "validate": False,
                       "rollout": {"enabled": rollout, "n": 2, "horizon": 4, "rate": 1,
                                   "batched": batched, "num_batch_envs": 2,
                                   "terminate_on_success": False},
                       "save": {"enabled": True, "every_n_epochs": 1},
                       "logging": {"terminal_output_to_txt": False, "log_tb": False}},
        "algo": {"unet": {"down_dims": [16, 32]},
                 "optim_params": {"policy": {"learning_rate": {"num_warmup_steps": 1}}},
                 "ddpm": {"num_train_timesteps": 10, "num_inference_timesteps": 10}},
        "observation": {"modalities": {"obs": {"low_dim": LOW_DIM}}},
    }


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    return make_synthetic_export(str(tmp_path_factory.mktemp("dp") / "export"), n_demos=4,
                                 demo_len=30)


@pytest.fixture(scope="module")
def run(export, tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_run")
    cfg_path = root / "dp.json"
    cfg_path.write_text(json.dumps(_dp_config(export, str(root / "out"))))
    return port_train.main(["--config", str(cfg_path)])


def test_script_trains_and_checkpoints(run):
    names = sorted(os.listdir(run))
    assert names == ["latest_full.state", "latest_full.state.epoch", "model_epoch_1.ckpt",
                     "model_epoch_2.ckpt"]
    with open(os.path.join(os.path.dirname(run), "logs", "scalars.json")) as f:
        logs = json.load(f)
    assert len(logs["Train/Loss"]) == 2 and all(np.isfinite(logs["Train/Loss"]))


def test_checkpoint_rebuilds_bit_equal_with_the_ema_net(run):
    model, ckpt = policy_from_checkpoint(os.path.join(run, "model_epoch_2.ckpt"), device="cpu")
    assert ckpt["algo_name"] == "diffusion_policy"
    state = torch.load(os.path.join(run, "latest_full.state"), weights_only=True)
    payload = state["model"]
    assert any(k.startswith("ema.") for k in payload)
    for k, v in model.serialize().items():
        assert torch.equal(v, payload[k]), k
    # the EMA net is not the trained net after 6 steps
    key = "unet.final_conv.weight"
    assert not torch.equal(payload["ema." + key], payload[key])
    assert state["optimizers"]["policy"]["steps"] == 6


def test_full_state_resumes_bit_exact(run, export):
    """Two algos loaded from latest_full.state take the same next step."""
    cfg = config_factory("diffusion_policy", _dp_config(export, "unused"))
    model, _ = policy_from_checkpoint(os.path.join(run, "model_epoch_2.ckpt"), device="cpu")
    twin, _ = policy_from_checkpoint(os.path.join(run, "model_epoch_2.ckpt"), device="cpu")
    rng = np.random.default_rng(0)
    raw = {"obs": {k: rng.standard_normal((4, 17, n), dtype=np.float32)
                   for k, n in zip(LOW_DIM, (3, 4, 2, 14))},
           "actions": rng.uniform(-1, 1, (4, 17, 12)).astype(np.float32)}
    losses = []
    for m in (model, twin):
        # a fresh read each: torch's optimizer adopts the loaded state's tensors
        m.deserialize_full(torch.load(os.path.join(run, "latest_full.state"),
                                      weights_only=True))
        assert m.policy_optimizer.steps == 6 and cfg.algo.ema.enabled
        losses.append(m.train_on_batch(m.process_batch_for_training(raw), 3)["losses"])
    assert torch.equal(losses[0]["action_loss"], losses[1]["action_loss"])
    for k, v in model.serialize().items():
        assert torch.equal(v, twin.serialize()[k]), k


def test_served_through_rollout_with_stats(run):
    model, ckpt = policy_from_checkpoint(os.path.join(run, "model_epoch_2.ckpt"), device="cpu")
    policy = RolloutPolicy(model, action_normalization_stats=ckpt[
        "action_normalization_stats_unpacked"])
    env = SyntheticKitchenEnv(seed=3)
    logs, _ = rollout_with_stats(policy, {"SyntheticKitchen": env}, horizon=10, num_episodes=2,
                                 frame_stack=2)
    stats = logs["SyntheticKitchen"]
    assert stats["Horizon"] == 10 and np.isfinite(stats["Return"])


def _bc_config(data, output_dir, batched):
    return {
        "algo_name": "bc",
        "train": {"data": data, "output_dir": output_dir, "num_epochs": 1, "batch_size": 4,
                  "hdf5_cache_mode": "low_dim", "hdf5_load_next_obs": False},
        "experiment": {"epoch_every_n_steps": 2, "validate": False,
                       "rollout": {"enabled": True, "n": 2, "horizon": 3, "rate": 1,
                                   "batched": batched, "num_batch_envs": 2},
                       "save": {"enabled": False}, "render_video": False,
                       "logging": {"terminal_output_to_txt": False, "log_tb": False}},
        "algo": {"gmm": {"enabled": True}, "actor_layer_dims": [16]},
        "observation": {"modalities": {"obs": {"low_dim": LOW_DIM}}},
    }


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_baseline_rollouts_in_the_script_as_jax(tmp_path, batched):
    """Reference fault (d), in both packages."""
    h5 = make_synthetic_dataset(str(tmp_path / "data.hdf5"), n_demos=4, demo_len=20)
    export = hdf5_to_export(h5, str(tmp_path / "export"))
    jax_cfg = jax_train_script.config_factory("bc", _bc_config(h5, str(tmp_path / "j"), batched))
    port_cfg = config_factory("bc", _bc_config(export, str(tmp_path / "p"), batched))
    if batched:
        jax_train_script.train(jax_cfg)
        port_train.train(port_cfg, device="cpu")
        return
    match = "get_action.. got multiple values for argument 'goal_dict'"
    with pytest.raises(TypeError, match=match):
        jax_train_script.train(jax_cfg)
    with pytest.raises(TypeError, match=match):
        port_train.train(port_cfg, device="cpu")
