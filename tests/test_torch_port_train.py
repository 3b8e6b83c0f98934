"""Port parity of the training slice: the LR schedules and optimizers against
optax, dropout, and ``ICLTransformerGMM.train_on_batch`` / ``run_epoch``
against the JAX package from bridged identical weights, in fp32 with
dropout 0, for the loss-based and the EMA codebook.

Tolerances: the two packages run the same fp32 arithmetic in other orders
(XLA's and torch's reductions and GEMMs), so losses and the gradient norm
agree to rtol 1e-5, and parameters to atol 2e-5 + rtol 1e-5. Adam divides
each gradient element by its own magnitude plus eps = 1e-8, so an element
whose gradient is a sum near eps (the LipVQ decoder's weights on saturated
sigmoid latents) moves by a fraction of its step that depends on the
gradient's last digits; the atol is 2 % of one step of lr 1e-3 (measured
worst case 1.44e-5, constant over 3 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import (
    algo_factory as jax_algo_factory,
    lr_schedule_from_config as jax_schedule,
    optimizer_from_optim_params as jax_optimizer,
)
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.data.loaders import DataLoader as JaxDataLoader
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.models.tokenizers.lipvq import apply_ema_codebook as jax_apply_ema
from lipvq_tpu.utils.train_utils import run_epoch as jax_run_epoch
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.base import lr_schedule_from_config, optimizer_from_optim_params
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.loaders import DataLoader
from lipvq_tpu_torch.models.base_nets import dropout
from lipvq_tpu_torch.models.tokenizers.lipvq import apply_ema_codebook
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params
from lipvq_tpu_torch.utils.train_utils import run_epoch

torch.set_num_threads(1)

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM, T, CODES, BATCH = 12, 10, 32, 8
STEPS = 2 * T - 1  # frame_stack - 1 + seq_length
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5


def _config(factory, ema: bool):
    cfg = factory("icl", {
        "train": {"max_grad_norm": 100.0, "seed": 1},
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
                "compute_dtype": "float32",
                "emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0,
            },
            "vq": {"num_codes": CODES, "ema_codebook": ema},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 2
    return cfg


def _item(rng):
    """One sample shaped like a SequenceDataset item."""
    return {"obs": {k: rng.standard_normal((STEPS, *s), dtype=np.float32)
                    for k, s in OBS_SHAPES.items()},
            "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)}


def _spread_codebook(params, rng):
    """Set the codebook to the latents of random actions: at random init
    every latent maps to one code."""
    tok = params["net"]["encoder"]["action_network"]
    latent = tok["quantizer"]["codebook"].shape[1]
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=latent, num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(rng.uniform(-1, 1, (CODES, AC_DIM)).astype(np.float32)),
        method=JaxLipVQVAE.encode)
    return {**params, "net": {**params["net"], "encoder": {
        **params["net"]["encoder"], "action_network": {
            **tok, "quantizer": {"codebook": codebook}}}}}


def _pair(ema: bool):
    """(JAX algo, port algo on the CPU) with identical weights and EMA state."""
    rng = np.random.default_rng(7)
    jax_algo = jax_algo_factory("icl", _config(jax_config_factory, ema), OBS_SHAPES,
                                ac_dim=AC_DIM)
    params = _spread_codebook(jax_algo.state.params, rng)
    jax_algo.state = jax_algo.state._replace(
        params=params, opt_state=jax_algo.tx.init(params))
    port = algo_factory("icl", _config(config_factory, ema), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, params),
                    jax.tree.map(np.asarray, jax_algo.state.extra_vars))
    return jax_algo, port


def _jax_state_dict(jax_algo):
    state = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_algo.state.params))
    for tree in jax_algo.state.extra_vars.values():
        state.update(state_dict_from_jax_params(jax.tree.map(np.asarray, tree)))
    return state


def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate

    return [stack_collate([_item(rng) for _ in range(BATCH)]) for _ in range(n)]


@pytest.fixture(scope="module", params=[False, True], ids=["loss_codebook", "ema_codebook"])
def trained(request):
    """Three train steps in both packages on the same batches; snapshots of
    the metrics and the state after steps 1 and 3, then one validation step."""
    ema = request.param
    jax_algo, port = _pair(ema)
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    snaps = {}
    for step, raw in enumerate(_batches(3), start=1):
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)
        if step in (1, 3):
            snaps[step] = (
                {k: float(v) for k, v in want["losses"].items()},
                {k: float(v) for k, v in got["losses"].items()},
                _jax_state_dict(jax_algo),
                {k: v.clone() for k, v in port.nets.state_dict().items()},
            )
    val = _batches(1, seed=12)[0]
    before = {k: v.clone() for k, v in port.nets.state_dict().items()}
    want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(val), 0, validate=True)
    got = port.train_on_batch(port.process_batch_for_training(val), 0, validate=True)
    validation = ({k: float(v) for k, v in want["losses"].items()},
                  {k: float(v) for k, v in got["losses"].items()}, before,
                  port.nets.state_dict())
    return ema, start, snaps, validation, port


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    ema, start, snaps, _, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    assert set(got_m) == set(want_m) == {"action_loss", "log_probs", "vq_loss",
                                         "policy_grad_norms"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    # the step really updates: the tokenizer from step 1 (constant lr), the
    # policy from step 2 (warmup 2: lr 0 at step 0)
    moved = {k for k in want_sd if not torch.equal(got_sd[k], start[k])}
    assert "net.encoder.action_network.enc1.weight" in moved
    assert ("net.embed_encoder.weight" in moved) == (step == 3)
    if ema:
        cluster = got_sd["net.encoder.action_network.ema_cluster_size"]
        assert (cluster > 0).sum() >= 4, cluster
        assert "net.encoder.action_network.quantizer.codebook" in moved


def test_validation_step_changes_nothing(trained):
    _, _, _, (want_m, got_m, before, after), _ = trained
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert got_m["policy_grad_norms"] == 0.0
    for k, v in before.items():
        assert torch.equal(after[k], v), k


def test_ema_codebook_update_matches_jax():
    rng = np.random.default_rng(2)
    codebook = rng.standard_normal((16, 5)).astype(np.float32)
    size = np.where(rng.random(16) < 0.5, 0.0, rng.random(16) * 3).astype(np.float32)
    embed_sum = rng.standard_normal((16, 5)).astype(np.float32)
    want = np.asarray(jax_apply_ema(jnp.asarray(codebook), jnp.asarray(size),
                                    jnp.asarray(embed_sum)))
    got = apply_ema_codebook(torch.from_numpy(codebook), torch.from_numpy(size),
                             torch.from_numpy(embed_sum)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    untouched = size == 0
    np.testing.assert_array_equal(got[untouched], codebook[untouched])


def test_weight_bridge_is_strict_about_ema_state():
    jax_algo, port = _pair(ema=True)
    params = jax.tree.map(np.asarray, jax_algo.state.params)
    with pytest.raises(RuntimeError, match="ema_cluster_size"):
        load_jax_params(port, params)  # the buffers are missing
    with pytest.raises(KeyError, match="intermediates"):
        load_jax_params(port, params, {"intermediates": {}})


# -- schedules and optimizers ------------------------------------------------

SCHEDULES = {
    "none": {"scheduler_type": "none"},
    "constant": {"scheduler_type": "constant"},
    "constant_with_warmup": {"scheduler_type": "constant_with_warmup", "num_warmup_steps": 7},
    "linear": {"scheduler_type": "linear", "num_warmup_steps": 9, "decay_factor": 0.2},
    "multistep": {"scheduler_type": "multistep", "epoch_schedule": [4, 11, 11],
                  "decay_factor": 0.5},
    "cosine": {"scheduler_type": "cosine", "num_warmup_steps": 5},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    optim = {"learning_rate": {"initial": 3e-4, **SCHEDULES[name]}}
    want = jax_schedule(optim, num_training_steps=20)
    got = lr_schedule_from_config(optim, num_training_steps=20)
    for step in range(25):
        w = float(want(step)) if callable(want) else want
        np.testing.assert_allclose(got(step), w, rtol=1e-6, atol=1e-12, err_msg=str(step))


def test_cosine_schedule_needs_training_steps():
    optim = {"learning_rate": {"initial": 3e-4, **SCHEDULES["cosine"]}}
    with pytest.raises(AssertionError):
        jax_schedule(optim)
    with pytest.raises(ValueError, match="num_training_steps"):
        lr_schedule_from_config(optim)


@pytest.mark.parametrize("opt_type", ["adam", "adamw"])
def test_optimizer_matches_optax_with_clip(opt_type):
    """Four steps on fixed gradients whose global norm (~12) is above the
    clip (0.5), with L2 0.05 and a warmup of 2."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 4).astype(np.float32) for s in shapes]
             for _ in range(4)]
    optim = {"optimizer_type": opt_type, "regularization": {"L2": 0.05},
             "learning_rate": {"initial": 1e-2, "scheduler_type": "constant_with_warmup",
                               "num_warmup_steps": 2}}
    tx = jax_optimizer(optim, max_grad_norm=0.5)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optimizer_from_optim_params(tp, optim, max_grad_norm=0.5)
    for g in grads:
        assert np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g)) > 0.5
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        opt.zero_grad()
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    assert not np.allclose(tp[0].detach().numpy(), params[0])


# -- dropout -----------------------------------------------------------------

def test_dropout_keep_rate_and_scale():
    x = torch.full((200_000,), 2.0)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0), train=True)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 5e-3
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / 0.9))
    yb = dropout(x.bfloat16(), 0.1, torch.Generator().manual_seed(0), train=True)
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb != 0, kept)


def test_dropout_is_identity_at_eval_and_p0():
    x = torch.randn(64, generator=torch.Generator().manual_seed(1))
    assert dropout(x, 0.5, None, train=False) is x
    assert dropout(x, 0.0, None, train=True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, None, train=True)


def test_dropout_same_seed_same_mask():
    x = torch.ones(4096)
    a = dropout(x, 0.3, torch.Generator().manual_seed(5), train=True)
    b = dropout(x, 0.3, torch.Generator().manual_seed(5), train=True)
    c = dropout(x, 0.3, torch.Generator().manual_seed(6), train=True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_train_step_with_dropout_trains():
    """bf16 compute with the template's dropout 0.1: the dropout masks and the
    EMA buffers move, the losses stay finite."""
    cfg = _config(config_factory, ema=True)
    with cfg.unlocked():
        cfg.algo.transformer.compute_dtype = "bfloat16"
        for k in ("emb_dropout", "attn_dropout", "block_output_dropout"):
            cfg.algo.transformer[k] = 0.1
    port = algo_factory("icl", cfg, OBS_SHAPES, ac_dim=AC_DIM, device="cpu")
    batch = port.process_batch_for_training(_batches(1)[0])
    a = port.train_on_batch(batch, 0, validate=True)["losses"]["action_loss"]
    b = port.train_on_batch(batch, 0, validate=True)["losses"]["action_loss"]
    assert torch.equal(a, b)  # no dropout in validation
    for _ in range(3):
        losses = port.train_on_batch(batch, 0)["losses"]
        assert all(torch.isfinite(v) for v in losses.values())
    assert port.nets.net.encoder.action_network.ema_cluster_size.sum() > 0


# -- run_epoch ---------------------------------------------------------------

class _Items:
    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = [_item(rng) for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_run_epoch_matches_jax():
    jax_algo, port = _pair(ema=False)
    data = _Items(3 * BATCH, seed=21)  # 3 batches a pass; 4 steps cycle it
    want = jax_run_epoch(jax_algo, JaxDataLoader(data, BATCH, seed=4), epoch=1, num_steps=4)
    got = run_epoch(port, DataLoader(data, BATCH, seed=4), epoch=1, num_steps=4)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("Time_"):
            assert got[k] >= 0.0
        else:
            np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert set(want) >= {"Loss", "Log_Likelihood", "VQ_Loss", "Policy_Grad_Norms"}
