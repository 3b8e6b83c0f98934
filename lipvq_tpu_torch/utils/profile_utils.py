"""Profiling / tracing harness (counterpart of
``lipvq_tpu/utils/profile_utils.py``).

Counterpart of reference per-phase timers (train_utils.py:1279-1328 —
kept as Time_* keys in run_epoch) with a device tracer: ``torch.profiler``
traces (CPU and CUDA activity) written as a Chrome trace, viewable in
Perfetto or ``chrome://tracing``, plus a timing helper that waits for the
device: CUDA launches return before the device finishes, so each timed
window ends in ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where a card is present) into ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            _synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _first_leaf(out):
    """The first tensor or array of a nested result (dict, list, tuple)."""
    if isinstance(out, dict):
        out = next(iter(out.values()))
        return _first_leaf(out)
    if isinstance(out, (list, tuple)) and out:
        return _first_leaf(out[0])
    return out


def timeit(fn, *args, iters: int = 10, warmup: int = 2,
           fetch: bool = True) -> dict:
    """Wall time of ``fn(*args)`` per call, after ``warmup`` calls.

    With ``fetch`` (default) the ``iters`` calls run back to back and the
    first leaf of the last result is copied to the host once at the end (a
    CUDA tensor's copy waits for the device): the mean over the window
    ("amortized"). Without it each call is timed alone and ends in
    ``torch.cuda.synchronize()``: mean and median ("synchronize").
    """
    for _ in range(warmup):
        out = fn(*args)
    _synchronize()
    if fetch:
        t0 = time.time()
        for _ in range(iters):
            out = fn(*args)
        leaf = _first_leaf(out)
        np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf)
        total = time.time() - t0
        return {"mean_s": total / iters, "iters": iters, "mode": "amortized"}
    times = []
    for _ in range(iters):
        t0 = time.time()
        out = fn(*args)
        _synchronize()
        times.append(time.time() - t0)
    return {
        "mean_s": float(np.mean(times)),
        "p50_s": float(np.median(times)),
        "iters": iters,
        "mode": "synchronize",
    }


class PhaseTimer:
    """Accumulating per-phase wall-clock timer emitting Time_* minutes
    (the reference's run_epoch timing keys)."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def logs(self) -> dict:
        return {f"Time_{k}": v / 60.0 for k, v in self.totals.items()}
