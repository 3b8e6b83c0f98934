"""The control (``control.py``: the reference in the program's place, one
precision lower) comes out not correct. On the CPU at a small size, where
TF32 does not exist, its float8 Dense layers read well above the program's
bf16; on the card, at the cell's own size, it fails the cell's limits."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from portbench.harness import program
from portbench.tests import tiny

sys.path.insert(0, str(tiny.ROOT / "portbench"))
import control  # noqa: E402
import run as runmod  # noqa: E402

SEPARATES = {"image.serve16": "head_gap", "lowdim.train1600": "grad_gap"}


@pytest.mark.parametrize("name", sorted(SEPARATES))
def test_control_reads_far_above_the_program(name):
    import contextlib
    import io

    wl, cfg, mix = tiny.cell(name)
    key = SEPARATES[name]
    ctl, _ = control.control(cfg, mix, 2147483663, 0.5, torch.device("cpu"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runmod.run(tiny.BENCH, wl, 2147483663, 0.5, 0, device="cpu", cfg=cfg, mix=mix)
    prog = json.loads(out.getvalue().strip().splitlines()[-1])["check"][key]["value"]
    assert ctl[key] >= 3 * prog, (ctl, prog)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in tiny.BENCH["workloads"]])
def test_control_fails_the_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    wl = next(w for w in tiny.BENCH["workloads"] if w["name"] == name)
    mix = json.loads((tiny.ROOT / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((tiny.ROOT / "portbench" / "limits" / f"{name}.json").read_text())
    cfg = program.load_config(wl["config"])
    worst, _ = control.control(cfg, mix, 2147483665, 4.0, torch.device("cuda", 0))
    assert any(not worst[k] <= v for k, v in limits["limits"].items()), worst
