"""A run with the timed path broken underneath comes out not correct: the
harness, past its look for a card, drives a tiny cell on the CPU with the
cell's committed limits, once sound and once with each fault the cell can
have (one chip: no exchange between chips to leave out)."""

from __future__ import annotations

import contextlib
import io
import json
import sys

import pytest

from portbench import faults
from portbench.tests import tiny

sys.path.insert(0, str(tiny.ROOT / "portbench"))
import run as runmod  # noqa: E402


def _run(name: str, seed: int = 2147483661) -> dict:
    wl, cfg, mix = tiny.cell(name)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert runmod.run(tiny.BENCH, wl, seed, 0.5, 0, device="cpu", cfg=cfg, mix=mix) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def _kind(name: str) -> str:
    wl = next(w for w in tiny.BENCH["workloads"] if w["name"] == name)
    mix = json.loads((tiny.ROOT / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    return mix["kind"]


FAULTS = {w["name"]: faults.BY_KIND[_kind(w["name"])] for w in tiny.BENCH["workloads"]}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["check"]
    assert r["failed"] == 0


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in sorted(FAULTS.items()) for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_fault_is_not_correct(name, fault):
    with fault():
        r = _run(name)
    assert not r["correct"], r["check"]
    assert r["failed"] >= 1
