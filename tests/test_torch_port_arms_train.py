"""Training parity of the tokenizer-ablation arms on the GPT backbone (bin,
ln_act, raw) and of the non-GMM ``ICLTransformer``: 1 and 3
``train_on_batch`` steps in both packages from bridged identical weights, in
fp32 with dropout 0, comparing the metrics, every parameter and the
running-statistics buffers (the JAX ``bin_stats``/``spectral_stats``
collections); a validation step changes nothing. Then the port's
checkpoint reload and full-state resume of the bin and raw arms.

Tolerances as in ``test_torch_port_train.py``: losses and the gradient norm
rtol 1e-5 (1e-4 for the arms whose forward runs a sequence model: the Mamba
scan and the B*T attention sum in other orders), parameters atol 2e-5 +
rtol 1e-5, buffers rtol 1e-5 / atol 1e-6, ``num_step`` exactly.
"""

import jax
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.icl import ICLTransformer
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}  # latent 17: the raw arm's 1 head
AC_DIM, T, BATCH = 12, 10, 8
STEPS = 2 * T - 1
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5
# arm -> (transformer switches, gmm, loss rtol)
CASES = {
    "bin": ({"bin_enabled": True}, True, 1e-5),
    "ln_act": ({"ln_act_enabled": True}, True, 1e-4),
    "raw": ({}, True, 1e-4),
    "nongmm_bin": ({"bin_enabled": True}, False, 1e-5),
}


def _config(factory, arm: str, dropout: float = 0.0, warmup: int | None = 2):
    switches, gmm, _ = CASES[arm]
    seq = {"enabled": True, "supervise_all_steps": gmm, "pred_future_acs": gmm,
           "causal": False, "embed_dim": 32, "num_layers": 2, "num_heads": 4,
           "vq_vae_enabled": False, "ln_act_enabled": False, "compute_dtype": "float32",
           "emb_dropout": dropout, "attn_dropout": dropout, "block_output_dropout": dropout,
           **switches}
    cfg = factory("icl", {
        "train": {"max_grad_norm": 100.0, "seed": 1},
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {"initial": 1e-3, "scheduler_type": "constant_with_warmup"},
                "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": gmm},
            "loss": {"l2_weight": 1.0, "l1_weight": 0.5, "cos_weight": 0.3},
            "transformer": seq,
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if warmup is not None:
            cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = warmup
    return cfg


def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [stack_collate([
        {"obs": {k: rng.standard_normal((STEPS, *s), dtype=np.float32)
                 for k, s in OBS_SHAPES.items()},
         "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)}
        for _ in range(BATCH)]) for _ in range(n)]


def _state_dict(jax_algo):
    state = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_algo.state.params))
    for tree in jax_algo.state.extra_vars.values():
        state.update(state_dict_from_jax_params(jax.tree.map(np.asarray, tree)))
    return state


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    arm = request.param
    jax_algo = jax_algo_factory("icl", _config(jax_config_factory, arm), OBS_SHAPES,
                                ac_dim=AC_DIM)
    port = algo_factory("icl", _config(config_factory, arm), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, jax_algo.state.params),
                    jax.tree.map(np.asarray, jax_algo.state.extra_vars))
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    snaps = {}
    for step, raw in enumerate(_batches(3), start=1):
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want["losses"].items()},
                           {k: float(v) for k, v in got["losses"].items()},
                           _state_dict(jax_algo),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    val = _batches(1, seed=12)[0]
    before = {k: v.clone() for k, v in port.nets.state_dict().items()}
    want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(val), 0, validate=True)
    got = port.train_on_batch(port.process_batch_for_training(val), 0, validate=True)
    validation = ({k: float(v) for k, v in want["losses"].items()},
                  {k: float(v) for k, v in got["losses"].items()}, before,
                  port.nets.state_dict())
    return arm, port, start, snaps, validation


@pytest.mark.parametrize("step", [1, 3])
def test_arm_train_step_matches_jax(trained, step):
    arm, port, start, snaps, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    loss_rtol = CASES[arm][2]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=loss_rtol, atol=1e-7, err_msg=k)
    assert set(got_sd) == set(want_sd)
    buffers = {k for k, _ in port.nets.named_buffers()}
    for k, want in want_sd.items():
        if k.endswith("num_step"):
            assert int(got_sd[k]) == int(want) == step, k
        elif k in buffers:
            np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=k)
    # one optimizer covers every parameter, the tokenizer's included: its
    # weights move from step 2 on (warmup 2: lr 0 at step 0)
    moved = {k for k in want_sd if not torch.equal(got_sd[k], start[k])}
    tok = "net.encoder.action_network."
    assert any(k.startswith(tok) and k not in buffers for k in moved) == (step == 3)
    assert port.vq_optimizer is None
    if arm == "raw":
        assert f"{tok}sn1.u" in moved  # the spectral-norm vectors advance every step


def test_arm_validation_changes_nothing(trained):
    arm, _, _, _, (want_m, got_m, before, after) = trained
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=CASES[arm][2], atol=1e-7,
                                   err_msg=k)
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_nongmm_head_is_deterministic_tanh():
    port = algo_factory("icl", _config(config_factory, "nongmm_bin"), OBS_SHAPES,
                        ac_dim=AC_DIM, device="cpu")
    assert isinstance(port, ICLTransformer)
    raw = _batches(1, seed=13)[0]
    obs = {k: v[:2, :T] for k, v in raw["obs"].items()}
    ctx = {"obs": obs, "actions": raw["actions"][:2, :T]}
    a, b = port.get_action(obs, ctx), port.get_action(obs, ctx)
    assert a.shape == (2, AC_DIM) and np.array_equal(a, b) and np.abs(a).max() < 1


# -- checkpoints of the bin and raw arms ------------------------------------

@pytest.mark.parametrize("arm", ["bin", "raw"])
def test_arm_checkpoint_reload_and_resume_are_exact(arm, tmp_path):
    """Dropout 0.1 and a warmup: the reloaded .ckpt gives bit-equal outputs
    and buffers; a run resumed from ``serialize_full`` after 2 steps takes
    steps 3 and 4 bit for bit as the run it came from."""
    def make():
        return algo_factory("icl", _config(config_factory, arm, dropout=0.1, warmup=None),
                            OBS_SHAPES, ac_dim=AC_DIM, device="cpu")

    batches = [make().process_batch_for_training(b) for b in _batches(4, seed=21)]
    writer = make()
    for b in batches[:2]:
        writer.train_on_batch(b, 0)
    path = str(tmp_path / "model.ckpt")
    cfg = _config(config_factory, arm, dropout=0.1, warmup=None)
    file_utils.save_checkpoint(path, writer, cfg, shape_meta={
        "ac_dim": AC_DIM, "all_shapes": OBS_SHAPES, "all_obs_keys": list(OBS_SHAPES),
        "use_images": False})
    reloaded, _ = file_utils.policy_from_checkpoint(path, device="cpu")
    for (k, v), (k2, v2) in zip(writer.nets.state_dict().items(),
                                reloaded.nets.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    tok = writer.nets.net.encoder.action_network
    if arm == "bin":
        assert int(tok.num_step) == 2 and torch.isfinite(tok.running_min).all()
    state = str(tmp_path / "latest_full.state")
    torch.save(writer.serialize_full(), state)
    resumed = make()
    resumed.deserialize_full(torch.load(state, map_location="cpu", weights_only=True))
    for b in batches[2:]:
        want = writer.train_on_batch(b, 1)["losses"]
        got = resumed.train_on_batch(b, 1)["losses"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    for (k, v), (_, v2) in zip(writer.nets.state_dict().items(),
                               resumed.nets.state_dict().items()):
        assert torch.equal(v, v2), k
