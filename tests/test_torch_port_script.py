"""Port parity of the training script: ``lipvq_tpu_torch.scripts.train`` on
the CPU (``train.cuda`` false) against the JAX package's ``train()`` on the
same config and fixture (the JAX reads the HDF5 file, the port its
export): 2 epochs of 3 steps with validation, a checkpoint every epoch and
batched rollouts in the synthetic env. Both must write the same checkpoint
names and log the same keys. The JAX run's checkpoint, read with flax and
bridged into the port, gives the JAX policy's GMM parameters within the
fp32 forward's tolerance (rtol 1e-3 / atol 1e-4); ``eval_checkpoint``
evaluates a port checkpoint; the unported switches raise."""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import lipvq_tpu.scripts.train as jax_train_script
from lipvq_tpu.models.policy_nets import ICLGMMActorNetwork as JaxActor
from lipvq_tpu.utils import file_utils as jax_file_utils
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.export import hdf5_to_export
from lipvq_tpu_torch.scripts import train as port_train
from lipvq_tpu_torch.scripts.eval_checkpoint import evaluate_checkpoint
from lipvq_tpu_torch.scripts.eval_checkpoint import main as eval_main
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils.jax_weights import load_jax_params
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESOAK_PAN = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen_multi", "PreSoakPan")
# examples/kitchen_multitask_suite.py:83-97: fixed widths in every kitchen task
KITCHEN_OBS_KEYS = ("robot0_base_pos", "robot0_base_quat", "robot0_eef_pos", "robot0_eef_quat",
                    "robot0_gripper_qpos", "robot0_base_to_eef_pos", "fixture_state",
                    "obj_state", "lang_emb")


def _config_dict(data, output_dir):
    d = icl_test_config_overrides()
    d["algo_name"] = "icl"
    d["train"].update({"data": data, "output_dir": output_dir, "num_epochs": 2,
                       "cuda": False, "hdf5_filter_key": "train",
                       "hdf5_validation_filter_key": "valid"})
    d["experiment"]["rollout"] = {"enabled": True, "n": 2, "horizon": 3, "rate": 1,
                                  "batched": True, "num_batch_envs": 2,
                                  "terminate_on_success": False}
    d["algo"]["transformer"].update({"compute_dtype": "float32", "emb_dropout": 0.0,
                                     "attn_dropout": 0.0, "block_output_dropout": 0.0})
    return d


class _Capture:
    """Keeps the JAX DataLogger of a run, to read its records."""

    loggers: list = []

    @classmethod
    def wrap(cls, base):
        class Logger(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                cls.loggers.append(self)

        return Logger


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX train() and one port scripts/train.main() on the same config."""
    root = tmp_path_factory.mktemp("script")
    h5 = make_synthetic_dataset(str(root / "data.hdf5"), n_demos=6, demo_len=30)
    export = hdf5_to_export(h5, str(root / "export"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_script, "DataLogger", _Capture.wrap(jax_train_script.DataLogger))
        jax_cfg = jax_train_script.config_factory("icl", _config_dict(h5, str(root / "jax")))
        jax_ckpt_dir = jax_train_script.train(jax_cfg)
    jax_logs = dict(_Capture.loggers[-1]._data)
    cfg_path = root / "port.json"
    cfg_path.write_text(json.dumps(_config_dict(export, str(root / "port"))))
    port_ckpt_dir = port_train.main(["--config", str(cfg_path)])
    with open(os.path.join(os.path.dirname(port_ckpt_dir), "logs", "scalars.json")) as f:
        port_logs = json.load(f)
    return {"h5": h5, "export": export, "jax": (jax_ckpt_dir, jax_logs),
            "port": (port_ckpt_dir, port_logs), "root": root}


def test_script_writes_the_jax_checkpoint_names(runs):
    jax_names = sorted(os.listdir(runs["jax"][0]))
    port_names = sorted(os.listdir(runs["port"][0]))
    assert port_names == jax_names
    assert {"latest_full.state", "latest_full.state.epoch"} <= set(port_names)
    assert sum(n.startswith("model_epoch_1") for n in port_names) == 1
    assert "model_epoch_2.ckpt" in port_names or any(
        n.startswith("model_epoch_2_") for n in port_names)
    with open(os.path.join(runs["port"][0], "latest_full.state.epoch")) as f:
        assert f.read() == "2"


def test_script_logs_the_jax_keys(runs):
    jax_logs, port_logs = runs["jax"][1], runs["port"][1]
    assert sorted(port_logs) == sorted(jax_logs)
    assert {"Train/Loss", "Valid/Loss", "Rollout/Success_Rate/SyntheticKitchen",
            "Timing_Stats/Train_Data_Loading", "Timing_Stats/Train_Train_Batch"} <= set(port_logs)
    for k, v in port_logs.items():
        assert len(v) == len(jax_logs[k]) == 2, k
        assert all(np.isfinite(v)), k


def test_script_resumes_from_full_state(runs, tmp_path):
    """ckpt_path = latest_full.state, start_epoch 3: the run restores the
    optimizer step counters and goes on from epoch 3."""
    d = _config_dict(runs["export"], str(tmp_path))
    d["train"]["num_epochs"] = 3
    d["experiment"]["ckpt_path"] = os.path.join(runs["port"][0], "latest_full.state")
    d["experiment"]["start_epoch"] = 3
    d["experiment"]["rollout"]["enabled"] = False
    ckpt_dir = port_train.train(config_factory("icl", d), device="cpu")
    assert sorted(os.listdir(ckpt_dir)) == ["latest_full.state", "latest_full.state.epoch",
                                            "model_epoch_3.ckpt"]
    state = torch.load(os.path.join(ckpt_dir, "latest_full.state"), weights_only=True)
    assert state["optimizers"]["policy"]["steps"] == 3 * 3  # 2 epochs + 1, 3 steps each


def test_script_falls_back_from_a_corrupt_state(runs, tmp_path, capsys):
    """A truncated latest_full.state resumes from the newest .ckpt beside it."""
    src = runs["port"][0]
    ckpt = sorted((p for p in os.listdir(src) if p.endswith(".ckpt")),
                  key=lambda p: os.path.getmtime(os.path.join(src, p)))[-1]
    (tmp_path / ckpt).write_bytes((open(os.path.join(src, ckpt), "rb").read()))
    state = open(os.path.join(src, "latest_full.state"), "rb").read()
    (tmp_path / "latest_full.state").write_bytes(state[: len(state) // 2])
    d = _config_dict(runs["export"], str(tmp_path / "out"))
    d["train"]["num_epochs"] = 1
    d["experiment"]["ckpt_path"] = str(tmp_path / "latest_full.state")
    d["experiment"]["rollout"]["enabled"] = False
    port_train.train(config_factory("icl", d), device="cpu")
    out = capsys.readouterr().out
    assert "resume state unreadable" in out
    assert f"falling back to weights-only {tmp_path / ckpt}" in out


def test_script_follows_a_checkpoint_directory(runs, tmp_path, capsys):
    """ckpt_path = a directory: each epoch loads model_epoch_<e>.ckpt there."""
    src = runs["port"][0]
    d = _config_dict(runs["export"], str(tmp_path))
    d["experiment"]["ckpt_path"] = src
    d["experiment"]["rollout"]["enabled"] = False
    port_train.train(config_factory("icl", d), device="cpu")
    out = capsys.readouterr().out
    loaded = [f"follow-along: loading {os.path.join(src, f'model_epoch_{e}.ckpt')}"
              for e in (1, 2) if os.path.isfile(os.path.join(src, f"model_epoch_{e}.ckpt"))]
    assert loaded and all(line in out for line in loaded)


def _eval_inputs(shape_meta, t, ac_dim):
    rng = np.random.default_rng(3)
    obs = {k: rng.standard_normal((2, t, *s), dtype=np.float32)
           for k, s in shape_meta["all_shapes"].items()}
    ctx = {k: rng.standard_normal((2, t, *s), dtype=np.float32)
           for k, s in shape_meta["all_shapes"].items()}
    return obs, ctx, rng.uniform(-1, 1, (2, t, ac_dim)).astype(np.float32)


def test_jax_checkpoint_bridges_into_port(runs):
    path = os.path.join(runs["jax"][0], "model_epoch_2.ckpt")
    if not os.path.exists(path):
        path = sorted(p for p in os.listdir(runs["jax"][0]) if p.startswith("model_epoch_2"))[0]
        path = os.path.join(runs["jax"][0], path)
    jax_model, _ = jax_file_utils.policy_from_checkpoint(path)
    ckpt = jax_file_utils.load_checkpoint_dict(path)
    state = serialization.msgpack_restore(ckpt["model"])
    config = file_utils.config_from_checkpoint(ckpt)
    shape_meta = json.loads(ckpt["shape_metadata"])
    port = algo_factory(ckpt["algo_name"], config, shape_meta["all_shapes"],
                        ac_dim=shape_meta["ac_dim"], device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, state["params"]),
                    jax.tree.map(np.asarray, state["extra_vars"]))
    inputs = _eval_inputs(shape_meta, port.context_length, port.ac_dim)
    apply = jax.jit(functools.partial(jax_model.net.apply, train=False, low_noise_eval=False,
                                      method=JaxActor.forward_train))
    want, _ = apply({"params": jax_model.state.params},
                    *(jax.tree.map(jnp.asarray, a) for a in inputs))
    with torch.inference_mode():
        got, _ = port.nets.forward_train(*(port._put_infer(a) for a in inputs),
                                         low_noise_eval=False)
    for name, g, w in zip(("means", "scales", "logits"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4, err_msg=name)


def test_eval_checkpoint_runs_a_port_checkpoint(runs, capsys):
    path = os.path.join(runs["port"][0], sorted(
        p for p in os.listdir(runs["port"][0]) if p.endswith(".ckpt"))[-1])
    stats = evaluate_checkpoint(path, n=2, horizon=4, terminate_on_success=False,
                                device="cpu")
    assert stats["episodes"] == 2 and stats["Horizon"] == 4.0
    assert eval_main([path, "--n", "1", "--horizon", "2", "--no_terminate_on_success",
                      "--device", "cpu"])["episodes"] == 1
    assert capsys.readouterr().out.count("ep0 success=") == 2


def test_rollout_disabled_for_an_unported_env(tmp_path, capsys):
    """A multi-stage kitchen dataset (the committed PreSoakPan corpus) gets
    rollouts in its own env where ``mujoco`` is installed; without it the
    script prints "Rollout disabled" naming mujoco and trains on. (Until the
    multi-stage kitchen was ported, every multi-stage task was disabled.)"""
    d = _config_dict(PRESOAK_PAN, str(tmp_path))
    d["train"].update({"num_epochs": 1, "hdf5_filter_key": None,
                       "hdf5_validation_filter_key": None})
    d["experiment"]["validate"] = False
    d["experiment"]["rollout"].update({"batched": False, "n": 1, "horizon": 3})
    d["observation"]["modalities"]["obs"]["low_dim"] = list(KITCHEN_OBS_KEYS)
    ckpt_dir = port_train.train(config_factory("icl", d), device="cpu")
    out = capsys.readouterr().out
    if importlib.util.find_spec("mujoco") is None:
        assert "Rollout disabled (no env adapter): ModuleNotFoundError" in out
        assert "'mujoco'" in out
    else:
        assert "Rollout disabled" not in out
        assert "Rollout Epoch 1 [PreSoakPan]" in out
    assert any(n.startswith("model_epoch_1") and n.endswith(".ckpt") for n in os.listdir(ckpt_dir))


@pytest.mark.parametrize("override,item", [
    ({"train": {"num_devices": 2}}, "item 14"),
    ({"train": {"hdf5_cache_mode": "device"}}, "item 7"),
])
def test_unported_switches_raise(runs, tmp_path, override, item):
    """Both switches raised here until they were ported; now each trains
    through the script and writes its checkpoints: ``train.num_devices`` = 2
    in two spawned gloo ranks (item 14), item 7's device cache in
    process."""
    d = _config_dict(runs["export"], str(tmp_path))
    for section, values in override.items():
        for k, v in values.items():
            if isinstance(v, dict):
                d[section].setdefault(k, {}).update(v)
            else:
                d[section][k] = v
    ckpt_dir = port_train.train(config_factory("icl", d), device="cpu")
    assert "model_epoch_2.ckpt" in os.listdir(ckpt_dir)
