"""The train-step profiler of the port (``scripts/profile_train_step.py``).

At a small width the FLOP count of one ICL train step must equal the
analytic count of its products: every Linear, attention product and the
LipVQ lookup, forward and backward (a weight gradient always; an input
gradient where the input needs one), plus 2 B N D for K1 (K2: + B D). The
JAX package's row keys stand, with the H100 peaks in place of v5e's."""

import json

import numpy as np
import pytest
import torch

from lipvq_tpu.scripts import profile_train_step as jax_profile
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.scripts import profile_train_step as P

torch.set_num_threads(1)

OBS = {"robot0_eef_pos": [3], "object": [14], "lang_emb": [15]}
D = sum(s[0] for s in OBS.values())  # the low-dim feature width = the LipVQ latent
E, LAYERS, HEADS, T, CODES, A, MODES, HIDDEN = 32, 2, 4, 10, 16, 12, 5, 128


def _model(ema: bool):
    cfg = config_factory("icl", {
        "train": {"max_grad_norm": 100.0},
        "algo": {"gmm": {"enabled": True, "num_modes": MODES},
                 "transformer": {"enabled": True, "supervise_all_steps": True,
                                 "pred_future_acs": True, "causal": False, "embed_dim": E,
                                 "num_layers": LAYERS, "num_heads": HEADS,
                                 "vq_vae_enabled": True, "ln_act_enabled": False},
                 "vq": {"num_codes": CODES, "ema_codebook": ema}}})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS)
    return algo_factory("icl", cfg, OBS, ac_dim=A, device="cpu")


def analytic_flops(batch: int, ema: bool) -> int:
    """The products of one step: each product of 2 m k n FLOPs forward
    costs as much again for its weight (or second operand's) gradient and,
    where its input needs a gradient, for that too."""
    h = batch // 2
    r, s = h * T, 3 * T  # context rows, tokens per sequence

    def lin(rows, k, n, input_grad=True):
        return 2 * rows * k * n * (3 if input_grad else 2)

    tokenizer = (lin(r, A, 64, input_grad=False) + lin(r, 64, HIDDEN) + lin(r, HIDDEN, D)
                 + lin(r, D, 64) + lin(r, 64, HIDDEN) + lin(r, HIDDEN, A))
    lookup = 2 * r * CODES * D + (r * D if ema else 0)
    embed = 3 * lin(r, D, E, input_grad=False)  # obs, context obs, detached latents
    block = (lin(h * s, E, 3 * E) + 2 * lin(h * HEADS * s, E // HEADS, s)
             + lin(h * s, E, E) + lin(h * s, E, 4 * E) + lin(h * s, 4 * E, E))
    heads = lin(r, E, MODES * A) * 2 + lin(r, E, MODES)
    return tokenizer + lookup + embed + LAYERS * block + heads


@pytest.mark.parametrize("ema", [False, True], ids=["loss_codebook", "ema_codebook"])
@pytest.mark.parametrize("batch", [4, 8])
def test_step_flops_equal_the_analytic_count(batch, ema):
    model = _model(ema)
    b = P.device_batch(model, OBS, batch)
    flops, nbytes = P.step_flops(model, b)
    assert flops == analytic_flops(batch, ema)
    assert nbytes > 0


def test_row_keys_are_jax_with_the_h100_peaks(capsys, monkeypatch):
    monkeypatch.setattr(P, "make_lowdim_model", lambda b, device=None, **kw: (_model(False), OBS))
    rows = P.main(["--mode", "lowdim", "--batches", "4", "--iters", "1", "--device", "cpu"])
    jax_keys = {"mode", "dtype", "activations", "remat", "batch", "step_ms", "samples_per_s",
                "step_gflops", "achieved_tflops", "step_gbytes", "hbm_floor_ms",
                "hbm_bw_util"}
    renamed = {"mfu_vs_h100_bf16_dense_peak", "mfu_vs_h100_fp32_peak", "device"}
    assert set(rows[0]) == jax_keys | renamed | {"launches_per_step", "ema_codebook"}
    assert not any("v5e" in k for k in rows[0])
    row = rows[0]
    assert round(row["step_gflops"] * 1e9) == analytic_flops(4, False)
    np.testing.assert_allclose(row["mfu_vs_h100_fp32_peak"],
                               100 * row["achieved_tflops"] * 1e12 / 66.9e12)
    np.testing.assert_allclose(row["hbm_floor_ms"], row["step_gbytes"] * 1e9 / 3.35e12 * 1e3)
    assert row["device"] == "cpu" and row["launches_per_step"] == {"k1": 0, "k1f": 0, "k2": 0}
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == {"profile": rows}


@pytest.mark.parametrize("mode", ["lowdim", "image"])
def test_models_take_the_jax_configs_key_for_key(mode, monkeypatch):
    """The configurations and observation shapes the JAX script builds its
    models from, compared as dumped JSON (the algo factories captured)."""
    import lipvq_tpu.algo.base as jax_base

    import lipvq_tpu_torch.algo as port_algo

    seen = {}

    def capture(name):
        def factory(algo_name, cfg, shapes, ac_dim, **kw):
            seen[name] = (algo_name, json.loads(cfg.dump()), shapes, ac_dim)
            return None
        return factory

    monkeypatch.setattr(jax_base, "algo_factory", capture("jax"))
    monkeypatch.setattr(port_algo, "algo_factory", capture("port"))
    make = f"make_{mode}_model"
    args = (100, "bfloat16", "bfloat16", True) if mode == "lowdim" else (
        16, 128, "bfloat16", "float32", True)
    getattr(jax_profile, make)(*args)
    getattr(P, make)(*args, device="cpu")
    assert seen["port"] == seen["jax"]
