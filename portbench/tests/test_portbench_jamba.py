"""The Jamba configuration's counts and its driver: ``counts/icl_jamba.py``'s
matrix products equal what ``FlopCounterMode`` counts over the plain
reference at a small size (the scan's elementwise operations are the
counts' own, which no counter sees); the scan's bytes are each tensor once;
the driver sets the mixers' A_log and dt bias as Mamba initializes them;
the control reads ``grad_err`` far above the program; and the scan's fault
is found where ``control.py`` looks for it."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import icl_jamba as counts
from portbench.harness import weights
from portbench.reference import icl_jamba as ref
from portbench.tests import tiny
from portbench.tests.tiny import config

B, T = 3, 10


def _scan_ops(cfg: dict, b: int, train: bool) -> int:
    per = (counts.SCAN_FWD_OPS + (counts.SCAN_BWD_OPS if train else 0))
    mamba_layers = sum(not ref.is_attention(cfg, i) for i in range(cfg["num_layers"]))
    return mamba_layers * per * b * 3 * cfg["context_length"] * cfg["expand"] * cfg[
        "embed_dim"] * cfg["d_state"]


def _obs(cfg, n, steps=T):
    return {k: torch.randn(n, steps, *s) for k, s in cfg["obs"]}


def test_served_forward_products():
    cfg = config("icl_lipvq_jamba2_3b")
    w = weights.make(ref.param_specs(cfg), 1, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    obs = _obs(cfg, B)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        codes, _, _ = ref.tokenize(w, torch.randn(B, T, cfg["ac_dim"]))
        feats = ref._features(obs, cfg)
        ref.policy_heads(w, cfg, feats, feats, codes)
    assert fc.get_total_flops() == sum(counts.policy(cfg, B).values()) - _scan_ops(cfg, B, False)


def test_train_step_products():
    cfg = config("icl_lipvq_jamba2_3b")
    w = weights.make(ref.param_specs(cfg), 2, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    trainer = ref.Trainer(w, cfg, micro=2)
    steps = 2 * T - 1
    batch = {"obs": _obs(cfg, 2 * B, steps), "actions": torch.randn(2 * B, steps, cfg["ac_dim"])}
    with FlopCounterMode(display=False) as fc:
        trainer.step(batch)
    want = sum(counts.policy(cfg, B, train=True).values()) - _scan_ops(cfg, B, True)
    # FlopCounterMode counts a grouped convolution's backward as if it were
    # ungrouped (d_inner times the depthwise kernel's work); its input and
    # weight gradients are each one forward's products
    by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    conv = by_op["aten.convolution"]
    assert by_op["aten.convolution_backward"] == conv * (1 + cfg["expand"] * cfg["embed_dim"])
    assert fc.get_total_flops() - by_op["aten.convolution_backward"] + 2 * conv == want


def test_scan_counts_each_tensor_once():
    c = counts.scan(2, 3, 5, 4)
    assert c["ops"] == 30 * 2 * 3 * 5 * 4
    assert c["bytes"] == 4 * (6 * 2 * 3 * 5 + 4 * 2 * 3 * 4 + 2 * 5 * 4 + 2 * 5)
    assert counts.k1(8, 4, 2) == {"ops": 2 * 8 * 4 * 2, "bytes": 4 * (8 * 2 + 4 * 2 + 8)}


def test_driver_sets_the_mixers_as_mamba_initializes_them():
    from portbench.harness.drivers import train_ssm

    cfg = config("icl_lipvq_jamba2_3b")
    specs = ref.param_specs(cfg)
    drawn = weights.make(specs, 2147483661, "cpu", ref.lipvq_encode, codebooks=[ref.TOK])
    w = train_ssm.published_ssm(specs, dict(drawn))
    changed = set()
    for name, shape, _ in specs:
        if name.endswith(".A_log"):
            want = torch.arange(1, cfg["d_state"] + 1, dtype=torch.float32).expand(shape)
            torch.testing.assert_close(torch.exp(w[name]), want)
            changed.add(name)
        elif name.endswith(".dt_proj.bias"):
            dt = torch.nn.functional.softplus(w[name])
            assert 1e-3 * (1 - 1e-5) <= float(dt.min()) and float(dt.max()) <= 0.1 * (1 + 1e-5)
            assert float(dt.max() / dt.min()) > 20  # log-uniform: the decades are spread
            changed.add(name)
    assert len(changed) == 2 * sum(not ref.is_attention(cfg, i) for i in range(cfg["num_layers"]))
    assert all(torch.equal(w[k], v) for k, v in drawn.items() if k not in changed)


def test_control_reads_far_above_the_program_on_grad_err():
    import contextlib
    import io
    import json
    import sys

    sys.path.insert(0, str(tiny.ROOT / "portbench"))
    import control
    import run as runmod

    wl, cfg, mix = tiny.cell("jamba.train384")
    ctl, _ = control.control(cfg, mix, 2147483663, 0.5, torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runmod.run(tiny.BENCH, wl, 2147483663, 0.5, 0, device="cpu", cfg=cfg, mix=mix)
    prog = json.loads(out.getvalue().strip().splitlines()[-1])["check"]["grad_err"]["value"]
    assert ctl["grad_err"] >= 3 * prog, (ctl, prog)


def test_the_scan_fault_is_found_where_control_looks(monkeypatch):
    import subprocess
    import sys

    code = ("from portbench import faults; from portbench.harness import program; "
            "program.load_config('icl_lipvq_jamba2_3b'); "
            "print(callable(getattr(faults, 'bf16_scan_state', None)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True"

    sys.path.insert(0, str(tiny.ROOT / "portbench"))
    import control
    from portbench.harness.drivers import train_ssm

    calls = []

    def counted(*args):
        calls.append(args[0].shape)
        return bf16(*args)

    bf16 = train_ssm._bf16_state_scan
    monkeypatch.setattr(train_ssm, "_bf16_state_scan", counted)
    wl, cfg, mix = tiny.cell("jamba.train384")
    worst, _ = control.program_reading(cfg, mix, 2147483667, 0.5, torch.device("cpu"),
                                       "bf16_scan_state")
    assert calls and {"grad_err", "change_gap"} <= set(worst)
