"""The ``icl_mamba`` policy on the Jamba hybrid backbone (the port-only
``algo.mamba.hybrid``: attention where i % period == offset, multi-query
heads, a SiLU-gated MLP after every mixer, RMSNorms, dt/B/C norms) against
the benchmark's plain reference (``portbench/reference/icl_jamba.py``), at
a small size on the CPU: embed 64, 4 query heads and 1 key/value head,
d_state 4, 4 layers with attention at layer 2 (period 4, offset 2), MLP
128, T = 3, on the benchmark's seeded weights, in fp32.

Tolerances, all from fp32 summation order (no precision differs): the
port's scan forms exp(dt A) and dt B x over [b, t, d, n] and sums C . h by
einsum where the reference steps and sums per state, its convolution is an
unrolled stencil where the reference calls ``conv1d``, and its grouped
attention stacks the query heads where the reference repeats the key/value
head. So the GMM outputs and the losses agree to rtol 1e-5, each gradient
leaf to 1e-4 of its largest element, and the parameters after one AdamW
step to 2e-5 + rtol 1e-5 (Adam's first step normalizes each gradient
element, so an element near zero moves by up to the rate whatever its
size: the step is compared where the gradient is above 1e-3 of its leaf's
largest, the rest only for staying within twice the rate).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import ConfigLockError, config_factory
from lipvq_tpu_torch.config.algo_configs import MAMBA_HYBRID_DEFAULTS
from lipvq_tpu_torch.models.mamba import MambaBackbone
from lipvq_tpu_torch.ops import selective_scan as scan_ops
from lipvq_tpu_torch.utils import profile_utils
from portbench.harness import program, weights
from portbench.reference import icl_jamba as ref

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 2147483671
N_ITEMS = 6  # 3 context-query pairs
SMALL = {"context_length": 3, "embed_dim": 64, "num_heads": 4, "num_layers": 4, "d_state": 4,
         "compute_dtype": "float32"}
SMALL_HYBRID = {"attn_layer_period": 4, "attn_layer_offset": 2, "num_kv_heads": 1,
                "mlp_dim": 128, "dt_rank": 0}
OUT_RTOL, GRAD_RTOL, PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4, 2e-5, 1e-5


def _cfg(dropout: float = 0.0) -> dict:
    raw = json.loads((REPO / "portbench" / "configs" / "icl_lipvq_jamba2_3b.json").read_text())
    pc = copy.deepcopy(raw["port_config"])
    pc["algo"]["mamba"].update(SMALL, emb_dropout=dropout)
    pc["algo"]["mamba"]["hybrid"].update(SMALL_HYBRID)
    pc["algo"]["vq"]["num_codes"] = 32
    raw["port_config"] = pc
    return program.normalize(raw)


def _items(cfg: dict, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    steps = 2 * cfg["context_length"] - 1
    obs = {k: 0.5 * rng.standard_normal((N_ITEMS, steps, *s), dtype=np.float32)
           for k, s in cfg["obs"]}
    return {"obs": obs,
            "actions": 0.5 * rng.standard_normal((N_ITEMS, steps, cfg["ac_dim"]),
                                                 dtype=np.float32)}


def _policy(cfg: dict):
    w = weights.make(ref.param_specs(cfg), SEED, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    return w, program.build_policy(cfg, w, SEED, "cpu")


def test_param_specs_name_every_parameter_of_the_port():
    cfg = _cfg()
    _, algo = _policy(cfg)
    got = {k: tuple(v.shape) for k, v in algo.nets.state_dict().items()}
    assert got == {name: tuple(shape) for name, shape, _ in ref.param_specs(cfg)}
    assert isinstance(algo.nets.net.transformer, MambaBackbone)


def test_hybrid_policy_outputs_match_the_reference():
    cfg = _cfg()
    w, algo = _policy(cfg)
    items = _items(cfg)
    t = cfg["context_length"]
    obs = {k: torch.from_numpy(v[:, :t]) for k, v in items["obs"].items()}
    actions = torch.from_numpy(items["actions"][:, :t])
    with torch.no_grad():
        got, _ = algo.nets.net(obs, obs, actions)
        codes, _, _ = ref.tokenize(w, actions)
        feats = ref._features(obs, cfg)
        want = ref.policy_heads(w, cfg, feats, feats, codes)
    for key, value in zip(("mean", "scale", "logits"), want):
        torch.testing.assert_close(got[key].reshape(value.shape), value, rtol=OUT_RTOL,
                                   atol=OUT_RTOL * float(value.abs().max()))


@pytest.fixture(scope="module")
def one_step():
    """One ``train_on_batch`` of the port and one reference step from the
    same weights and batch, with embedding dropout 0.1 (the reference draws
    the program's masks), the schedule taken up at update 5000."""
    cfg = _cfg(dropout=0.1)
    w, algo = _policy(cfg)
    program.take_up_schedule(algo, 5000)
    items = _items(cfg)
    beta1 = program.betas(algo)
    log = algo.log_info(algo.train_on_batch(algo.process_batch_for_training(items), 0))
    grads = {k: v / (1.0 - beta1[k]) for k, v in program.exp_avg(algo).items()}
    trainer = ref.Trainer(w, cfg, seed=SEED, start=5000, micro=2)
    r = trainer.step({"obs": {k: torch.from_numpy(v) for k, v in items["obs"].items()},
                      "actions": torch.from_numpy(items["actions"])})
    return cfg, log, grads, program.device_state(algo), r, trainer


def test_hybrid_train_step_losses_match_the_reference(one_step):
    _, log, _, _, r, _ = one_step
    np.testing.assert_allclose(log["Loss"], r["action_loss"], rtol=OUT_RTOL)
    np.testing.assert_allclose(log["VQ_Loss"], r["vq_loss"], rtol=OUT_RTOL)


def test_hybrid_train_step_gradients_match_the_reference(one_step):
    _, _, grads, _, r, _ = one_step
    assert set(grads) == set(r["grads"])
    for k, g in grads.items():
        want = r["grads"][k]
        torch.testing.assert_close(g, want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(want.abs().max()) + 1e-12, msg=k)


def test_hybrid_adamw_step_matches_the_reference(one_step):
    cfg, _, _, state, r, trainer = one_step
    lr = max(trainer.pol_opt.lr(0), float(cfg["vq_optimizer"]["lr"]))
    for k, want in trainer.W.items():
        g = r["grads"][k]
        settled = g.abs() >= 1e-3 * g.abs().max()
        torch.testing.assert_close(state[k][settled], want[settled], atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, msg=k)
        assert float((state[k] - want).abs().max()) <= 2 * lr, k


def test_layer_pattern_puts_attention_where_i_mod_period_is_offset():
    bb = MambaBackbone(16, num_layers=11, d_state=2, num_heads=2, attn_layer_period=4,
                       attn_layer_offset=2, mlp_dim=8, norm="rms")
    attn = [i for i in range(11) if hasattr(bb, f"attn_{i}")]
    mamba = [i for i in range(11) if hasattr(bb, f"mamba_{i}")]
    assert attn == [2, 6, 10] and mamba == [i for i in range(11) if i not in attn]
    assert all(hasattr(bb, f"mlp_{i}") for i in range(11))
    plain = MambaBackbone(16, num_layers=3)
    assert not any(hasattr(plain, f"{p}_{i}") for p in ("attn", "mlp", "mlp_ln")
                   for i in range(3))


def _scan_inputs(dtype, b=2, t=5, d=3, n=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=g, dtype=dtype)
    dt = torch.rand(b, t, d, generator=g, dtype=dtype) + 0.1
    A = -torch.rand(d, n, generator=g, dtype=dtype) - 0.1
    B, C = (torch.randn(b, t, n, generator=g, dtype=dtype) for _ in range(2))
    D = torch.randn(d, generator=g, dtype=dtype)
    return [v.requires_grad_() for v in (x, dt, A, B, C, D)]


def test_scan_function_gradcheck_in_float64():
    assert torch.autograd.gradcheck(scan_ops.SelectiveScan.apply, _scan_inputs(torch.float64))


@pytest.mark.parametrize("t", [5, 40])
def test_scan_function_matches_autograd_of_the_plain_loop(t):
    """In float64 against autograd through the loop of
    ``scan_forward_plain``; the forward also against the fp32 loop of
    ``selective_scan_reference`` to fp32 rounding."""
    args = _scan_inputs(torch.float64, t=t)
    y_fn = scan_ops.SelectiveScan.apply(*args)
    y_loop = scan_ops.scan_forward_plain(*args)
    torch.testing.assert_close(y_fn, y_loop, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(scan_ops.selective_scan_reference(*(a.float() for a in args)),
                               y_fn.float(), rtol=1e-5, atol=1e-5)
    dy = torch.randn_like(y_fn)
    got = torch.autograd.grad(y_fn, args, dy)
    want = torch.autograd.grad(y_loop, args, dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_scan_dispatcher_takes_the_plain_loop_on_the_cpu():
    args = _scan_inputs(torch.float32)
    before = (scan_ops.selective_scan_cuda.launches, scan_ops.selective_scan_cuda.elems)
    y = scan_ops.selective_scan(*args)
    assert torch.equal(y, scan_ops.selective_scan_reference(*args))
    assert (scan_ops.selective_scan_cuda.launches, scan_ops.selective_scan_cuda.elems) == before
    with pytest.raises(ValueError, match="CUDA"):
        scan_ops.selective_scan_cuda(*args)


def _mamba_config(mamba: dict):
    return config_factory("icl_mamba", {"algo": {"gmm": {"enabled": True}, "mamba": {
        "enabled": True, "embed_dim": 32, "num_layers": 2, **mamba}}})


def _algo(cfg):
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    return algo_factory("icl_mamba", cfg, {"robot0_eef_pos": [3], "object": [14]}, ac_dim=12,
                        device="cpu")


def test_mamba_section_sizes_are_read():
    block = _algo(_mamba_config({"d_state": 5, "d_conv": 3, "expand": 3})).nets.net.transformer
    assert block.mamba_0.A_log.shape == (96, 5) and block.mamba_1.conv_kernel.shape == (3, 96)


def test_hybrid_section_at_its_defaults_is_the_plain_backbone():
    plain = _algo(_mamba_config({}))
    same = _algo(_mamba_config({"hybrid": dict(MAMBA_HYBRID_DEFAULTS)}))
    assert "hybrid" not in plain.global_config.algo.mamba
    sd, sd_same = plain.nets.state_dict(), same.nets.state_dict()
    assert list(sd) == list(sd_same) and all(torch.equal(sd[k], sd_same[k]) for k in sd)
    x = torch.randn(2, 6, 32)
    torch.testing.assert_close(same.nets.net.transformer(x), plain.nets.net.transformer(x),
                               rtol=0, atol=0)
    with pytest.raises(ConfigLockError):
        _mamba_config({"hybrid": {"mlp_width": 8}})


def test_spans_of_the_hybrid_backbone_are_recorded():
    cfg = _cfg()
    _, algo = _policy(cfg)
    items = _items(cfg)
    profile_utils.reset()
    profile_utils.enable()
    try:
        algo.train_on_batch(algo.process_batch_for_training(items), 0)
        spans = profile_utils.totals()["spans"]
    finally:
        profile_utils.disable()
        profile_utils.reset()
    assert spans["model.backbone.mamba"]["n"] == 3 and spans["model.backbone.attention"]["n"] == 1
    assert spans["model.backbone.mlp"]["n"] == 4
    inner = sum(spans[f"model.backbone.{s}"]["total_s"] for s in ("mamba", "attention", "mlp"))
    assert inner <= spans["model.backbone"]["total_s"]


def _template(gen, tmp_path, monkeypatch, hybrid) -> dict:
    """The icl_mamba template the generator writes with ``hybrid`` overlaid."""
    overlays = copy.deepcopy(gen.OVERLAYS)
    if hybrid is not None:
        overlays["icl_mamba"]["algo"]["mamba"]["hybrid"] = hybrid
    monkeypatch.setattr(gen, "OVERLAYS", overlays)
    monkeypatch.setattr(gen, "TEMPLATE_DIR", str(tmp_path))
    gen.main()
    return json.loads((tmp_path / "icl_mamba.json").read_text())


@pytest.mark.parametrize("hybrid", [dict(MAMBA_HYBRID_DEFAULTS), {"mlp_dim": 64}],
                         ids=["defaults", "set"])
def test_template_generator_keeps_the_hybrid_section_only_when_set(tmp_path, monkeypatch,
                                                                   hybrid):
    from lipvq_tpu_torch.scripts import generate_config_templates as gen

    base = _template(gen, tmp_path / "base", monkeypatch, None)
    got = _template(gen, tmp_path / "got", monkeypatch, hybrid)
    assert "hybrid" not in base["algo"]["mamba"]
    committed = json.loads((REPO / "exps" / "templates" / "icl_mamba.json").read_text())
    assert "hybrid" not in committed["algo"]["mamba"]
    if hybrid != MAMBA_HYBRID_DEFAULTS:
        assert got["algo"]["mamba"].pop("hybrid") == hybrid
    assert got == base
