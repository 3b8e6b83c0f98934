"""The port's checkpoints: ``Algo.serialize``/``deserialize`` through the
self-describing checkpoint of ``utils/file_utils.py`` (reloads to bit-equal
GMM parameters), ``serialize_full``/``deserialize_full`` (a resumed run
takes the next step bit for bit as the run it came from), and the
``weights_only`` load that executes no code. A JAX checkpoint bridged into
the port is tested in ``test_torch_port_script.py``, beside the JAX
training run that writes it."""

import json
import pickle

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM, T, CODES, BATCH = 12, 10, 32, 8
STEPS = 2 * T - 1
SHAPE_META = {"ac_dim": AC_DIM, "all_shapes": OBS_SHAPES, "all_obs_keys": list(OBS_SHAPES),
              "use_images": False}


def _config(ema: bool, seed: int = 1, compute_dtype: str = "float32", warmup: bool = True):
    """Dropout 0.1 and (``warmup``) a warmup of 2 steps, so the restored
    generators and schedule counters decide the next step. A config that
    names ``num_warmup_steps`` does not load through ``config_factory`` (the
    key is not in the base config), so checkpoints use the default warmup."""
    cfg = config_factory("icl", {
        "train": {"max_grad_norm": 100.0, "seed": seed},
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {"initial": 1e-3, "scheduler_type": "constant_with_warmup"},
                "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                "causal": False, "embed_dim": 64, "num_layers": 2, "num_heads": 4,
                "vq_vae_enabled": True, "ln_act_enabled": False,
                "compute_dtype": compute_dtype,
                "emb_dropout": 0.1, "attn_dropout": 0.1, "block_output_dropout": 0.1,
            },
            "vq": {"num_codes": CODES, "ema_codebook": ema},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if warmup:
            cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 2
    return cfg


def _algo(ema: bool, seed: int = 1, **kw):
    return algo_factory("icl", _config(ema, seed, **kw), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")


def _batches(algo, n, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        items = [{"obs": {k: rng.standard_normal((STEPS, *s), dtype=np.float32)
                          for k, s in OBS_SHAPES.items()},
                  "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)}
                 for _ in range(BATCH)]
        out.append(algo.process_batch_for_training(stack_collate(items)))
    return out


def _spread_codebook(algo, rng):
    """At random init every latent maps to one code."""
    tok = algo.nets.net.encoder.action_network
    with torch.no_grad():
        tok.quantizer.codebook.copy_(tok.encode(torch.from_numpy(
            rng.uniform(-1, 1, (CODES, AC_DIM)).astype(np.float32))))


def _eval_dists(algo, rng_seed=5):
    rng = np.random.default_rng(rng_seed)
    obs = {k: rng.standard_normal((3, T, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}
    ctx = {k: rng.standard_normal((3, T, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}
    act = rng.uniform(-1, 1, (3, T, AC_DIM)).astype(np.float32)
    with torch.inference_mode():
        dists, _ = algo.nets.forward_train(algo._put_infer(obs), algo._put_infer(ctx),
                                           algo._put_infer(act), low_noise_eval=True)
    return dists


def _losses(info):
    return {k: v.clone() for k, v in info["losses"].items()}


@pytest.mark.parametrize("ema", [False, True], ids=["loss_codebook", "ema_codebook"])
def test_full_state_resume_is_bit_identical(tmp_path, ema):
    """3 uninterrupted steps == 2 steps, serialize_full to a file, load into
    an algo built from another seed (other weights, generators, lr), 1 step."""
    straight = _algo(ema)
    _spread_codebook(straight, np.random.default_rng(0))
    first = _algo(ema)
    first.deserialize(straight.serialize())
    batches = _batches(straight, 3)
    want = [_losses(straight.train_on_batch(b, 0)) for b in batches]
    got = [_losses(first.train_on_batch(b, 0)) for b in batches[:2]]
    path = tmp_path / "latest_full.state"
    torch.save(first.serialize_full(), path)
    resumed = _algo(ema, seed=99)
    assert not torch.equal(resumed.nets.net.embed_encoder.weight,
                           first.nets.net.embed_encoder.weight)
    resumed.deserialize_full(torch.load(path, map_location="cpu", weights_only=True))
    assert resumed.policy_optimizer.steps == 2
    got.append(_losses(resumed.train_on_batch(batches[2], 0)))
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for (k, a), b in zip(straight.nets.state_dict().items(), resumed.nets.state_dict().values()):
        assert torch.equal(a, b), k
    for name, opt in straight.optimizers().items():
        other = resumed.optimizers()[name]
        assert opt.steps == other.steps == 3
        assert opt.optimizer.param_groups[0]["lr"] == other.optimizer.param_groups[0]["lr"]
        for p, q in zip(opt.params, other.params):
            for key, v in opt.optimizer.state[p].items():
                assert torch.equal(v, other.optimizer.state[q][key]), (name, key)
    for name, g in straight.generators().items():
        assert torch.equal(g.get_state(), resumed.generators()[name].get_state()), name
    if ema:
        assert resumed.nets.net.encoder.action_network.ema_cluster_size.sum() > 0


def test_full_state_holds_optimizers_schedule_and_generators():
    algo = _algo(ema=True)
    algo.train_on_batch(_batches(algo, 1)[0], 0)
    state = algo.serialize_full()
    assert set(state) == {"model", "optimizers", "generators"}
    assert set(state["optimizers"]) == {"policy", "vq"}
    assert set(state["generators"]) == {"dropout", "sample"}
    assert state["optimizers"]["policy"]["steps"] == 1
    assert "net.encoder.action_network.ema_cluster_size" in state["model"]
    assert all(v.device.type == "cpu" for v in state["model"].values())
    other = _algo(ema=False)
    with pytest.raises(KeyError, match="optimizers"):
        other.deserialize_full({**state, "optimizers": {"policy": state["optimizers"]["policy"]}})
    with pytest.raises(RuntimeError, match="ema_cluster_size"):
        other.deserialize(state["model"])


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_checkpoint_reloads_to_bit_equal_gmm(tmp_path, compute_dtype):
    algo = _algo(ema=False, compute_dtype=compute_dtype, warmup=False)
    _spread_codebook(algo, np.random.default_rng(1))
    for b in _batches(algo, 2):
        algo.train_on_batch(b, 0)
    action_stats = {"actions": {"scale": np.full(AC_DIM, 0.5, np.float32),
                                "offset": np.linspace(-1, 1, AC_DIM).astype(np.float32)}}
    obs_stats = {"object": {"scale": np.ones(14, np.float32), "offset": np.zeros(14, np.float32)}}
    env_meta = {"env_name": "SyntheticKitchen", "type": 1, "env_kwargs": {}}
    path = str(tmp_path / "model_epoch_1.ckpt")
    file_utils.save_checkpoint(path, algo, algo.global_config, env_meta=env_meta,
                               shape_meta=SHAPE_META, obs_normalization_stats=obs_stats,
                               action_normalization_stats=action_stats, lang_backend="hash")
    model, ckpt = file_utils.policy_from_checkpoint(path, device="cpu")
    assert set(ckpt) >= {"model", "config", "algo_name", "lang_backend", "env_metadata",
                         "shape_metadata", "obs_normalization_stats",
                         "action_normalization_stats"}
    assert ckpt["algo_name"] == "icl" and ckpt["lang_backend"] == "hash"
    assert json.loads(ckpt["env_metadata"]) == env_meta
    assert json.loads(ckpt["shape_metadata"]) == SHAPE_META
    assert json.loads(ckpt["config"]) == json.loads(algo.global_config.dump())
    for unpacked, stats in ((ckpt["action_normalization_stats_unpacked"], action_stats),
                            (ckpt["obs_normalization_stats_unpacked"], obs_stats)):
        assert unpacked.keys() == stats.keys()
        for k in stats:
            for kk in ("scale", "offset"):
                np.testing.assert_array_equal(unpacked[k][kk], stats[k][kk])
    assert model.device.type == "cpu"
    for got, want in zip(_eval_dists(model), _eval_dists(algo)):
        assert torch.equal(got, want)


def test_checkpoint_without_stats(tmp_path):
    algo = _algo(ema=True, warmup=False)
    path = str(tmp_path / "m.ckpt")
    file_utils.save_checkpoint(path, algo, algo.global_config, shape_meta=SHAPE_META)
    model, ckpt = file_utils.policy_from_checkpoint(path, device="cpu")
    assert ckpt["action_normalization_stats_unpacked"] is None
    assert ckpt["obs_normalization_stats_unpacked"] is None
    for a, b in zip(model.nets.state_dict().values(), algo.nets.state_dict().values()):
        assert torch.equal(a, b)


class _Payload:
    def __reduce__(self):
        return (print, ("this would run on load",))


def test_checkpoint_load_executes_no_code(tmp_path):
    path = tmp_path / "evil.ckpt"
    torch.save({"model": _Payload()}, path)
    with pytest.raises(pickle.UnpicklingError):
        file_utils.load_checkpoint_dict(str(path))
