"""The one traffic generator: a mix file of ``traffic/`` names its ``kind``
and parameters, and the driver of that kind, ``drivers/<kind>.py``, builds
the program's inputs from the seed, warms up every shape it will use, runs
the measured window and, after it, holds what the window produced against
the configuration's reference. Each driver module holds ``Driver`` and
``Control`` (the reference, one precision lower, in the program's place).
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch

from portbench.harness import program


def load(kind: str):
    """The driver module of mix kind ``kind``."""
    return importlib.import_module(f"portbench.harness.drivers.{kind}")


def span(tracing: bool, name: str):
    return torch.profiler.record_function(name) if tracing else contextlib.nullcontext()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def k1_launches() -> int:
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda

    return vq_nearest_cuda.launches


class Driver:
    """A cell's run. ``window`` returns its units of work (requests, steps
    or calls); ``check`` returns ({number: worst value}, per-item numbers);
    ``spans`` the host spans of the first traced half, by name, which the
    readers take as they are."""

    checks_window = True  # what ``check`` compares comes from the window

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), torch.device(device)
        self.ref = program.reference(cfg)
        self.counts = program.counts(cfg)
        self.elapsed = None
        self.tracer = None
        self.marks = [("start", time.perf_counter())]

    def mark(self, name: str) -> None:
        """Note the end of a set-up phase (printed with the result)."""
        self.marks.append((name, time.perf_counter()))

    def phases(self) -> dict:
        return {n: round(t - p, 3) for (_, p), (n, t) in zip(self.marks, self.marks[1:])}

    def reset_spans(self) -> None:
        """Zero the host spans before a traced half."""

    def spans(self) -> dict:
        return {}

    def run_window(self, seconds: float, tracer=None) -> int:
        """The measured window: work until ``seconds`` have passed, ending on
        the device. With ``tracer``, two traced halves of ``seconds`` each
        (``trace.Tracer``); ``traced_units``, ``k1_launches`` and
        ``traced_spans`` are then those of the first."""
        self.tracer = tracer
        units = 0
        for _ in range(1 if tracer is None else 2):
            sync(self.device)
            k1_before = k1_launches() if self.device.type == "cuda" else 0
            self.reset_spans()
            if tracer is not None:
                tracer.start()
            t0 = time.perf_counter()
            done = self.window(t0, seconds)
            sync(self.device)
            self.elapsed = time.perf_counter() - t0
            if tracer is not None:
                tracer.stop()
            if units == 0:
                self.traced_units, self.traced_spans = done, self.spans()
                self.k1_launches = (k1_launches() - k1_before) if self.device.type == "cuda" else 0
            units += done
        self.units = units
        return units
