"""Profiling / tracing harness (counterpart of
``lipvq_tpu/utils/profile_utils.py``).

Counterpart of reference per-phase timers (train_utils.py:1279-1328 —
kept as Time_* keys in run_epoch) with a device tracer: ``torch.profiler``
traces (CPU and CUDA activity) written as a Chrome trace, viewable in
Perfetto or ``chrome://tracing``, plus a timing helper that waits for the
device: CUDA launches return before the device finishes, so each timed
window ends in ``torch.cuda.synchronize()``.

The port's own spans and counters live here too. ``span(name)`` marks a
layer boundary and ``count(name, n)`` adds to a counter; both do nothing
until ``enable`` is called, so the hot paths pay one flag test per site.
Once enabled, each span records (name, start, end, parent, request) in a
bounded in-memory list: ``parent`` is the enclosing span, ``request`` the
outermost one, shared by every span of one request or step. Times are on
the profiler's clock (the epoch in ns, as kineto stamps host events).
``enable(annotate=True)`` also enters ``torch.profiler.record_function``
for each span, so a profiler running at the same time shows the span on
the device's timeline. ``totals`` sums the spans by name, with self time
(the duration less what child spans cover), and the counters: those
``count`` adds to while recording, and those each kernel module declares
with ``register`` when it is imported (its launches and the work they did),
read as counts since ``reset``. This module knows no kernel module. Torch
is imported only where it is used: the host-side env modules import this
one.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import numpy as np

# most spans kept between two resets; later ones are counted, not recorded
MAX_SPANS = 1 << 18

_on = False
_annotate = False
_offset_ns = 0  # epoch ns minus perf_counter ns, taken at enable
_records: list = []  # [name, start, end, parent record, root record (None: itself)]
_counters: dict[str, int] = {}
_readers: dict = {}  # counter name -> its reader, from ``register``
_base: dict = {}  # counter name -> what its reader gave at the last ``reset``
_local = threading.local()  # each thread's stack of open spans
_count_lock = threading.Lock()


class _Noop:
    """The span handed out while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "ann")

    def __init__(self, name: str):
        self.rec = [name, 0, None, None, None]
        self.ann = None

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self.rec
        if len(_records) < MAX_SPANS:
            parent = stack[-1] if stack else None
            rec[3] = parent
            rec[4] = None if parent is None else parent[4] or parent
            _records.append(rec)
            stack.append(rec)
        else:
            count("spans_dropped")
            self.rec = None
        # the recorded span holds its annotation: stamped first, closed last
        rec[1] = time.perf_counter_ns()
        if _annotate:
            import torch

            self.ann = torch.profiler.record_function(rec[0])
            self.ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self.ann is not None:
            self.ann.__exit__(*exc)
        if self.rec is not None:
            self.rec[2] = time.perf_counter_ns()
            _local.stack.pop()
        return False


def span(name: str):
    """A context manager marking one span of the port's work, ``name``
    being its layer and step (``env.step``, ``model.backbone``). While
    recording is off it is a shared no-op that reads no clock."""
    if not _on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if _on:
        with _count_lock:
            _counters[name] = _counters.get(name, 0) + n


def register(readers: dict) -> None:
    """Declare counters kept outside this module, {name: reader}, which
    ``totals`` gives as counts since the last ``reset`` (since the process
    started, before the first). A reader returns a host int, or a dict of
    one-element tensors counted on the cards, one per card: ``reset``
    copies those in stream order, without waiting, and ``totals`` reads
    their sum less the copies, which waits for the cards."""
    _readers.update(readers)


def enable(annotate: bool = False) -> None:
    """Start recording spans and counters, adding to what is kept; with
    ``annotate`` each span is also a ``torch.profiler.record_function``."""
    global _on, _annotate, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _annotate = bool(annotate)
    _on = True


def disable() -> None:
    """Stop recording; what was recorded is kept until ``reset``."""
    global _on, _annotate
    _on = _annotate = False


def reset() -> None:
    """Forget the recorded spans and counters; the registered counters in
    ``totals`` start again from zero."""
    _records.clear()
    _counters.clear()
    for name, read in _readers.items():
        got = read()
        _base[name] = ({k: t.clone() for k, t in got.items()} if isinstance(got, dict)
                       else got)


def recording() -> bool:
    """Whether spans and counters are being recorded."""
    return _on


def _since(got, base) -> int:
    """A registered counter's count since the last ``reset``: ``got``, its
    reader's value now, less ``base``, its value then (None: none taken)."""
    if isinstance(got, dict):
        return sum(int(t - (base or {}).get(k, 0)) for k, t in got.items())
    return got - (base or 0)


def records() -> list[tuple]:
    """The recorded spans in the order they began: (name, start ns, end ns
    or None while open, parent index, request index), the times on the
    profiler's clock; an index is None where that span was not recorded
    (none, or before the last ``reset``)."""
    index = {id(r): i for i, r in enumerate(_records)}
    return [(name, start + _offset_ns, None if end is None else end + _offset_ns,
             index.get(id(parent)), i if root is None else index.get(id(root)))
            for i, (name, start, end, parent, root) in enumerate(_records)]


def totals() -> dict:
    """{"spans": {name: {"n", "total_s", "self_s"}}, "counters": {name: n}}
    over the closed spans since the last ``reset``; self time is a span's
    duration less its child spans' (which run one after another inside
    it). The counters hold what ``count`` added and, since the reset, the
    counts of every registered counter (those counted on a card are read
    from it: this waits for it)."""
    child_ns: dict[int, int] = {}
    for rec in _records:
        if rec[2] is not None and rec[3] is not None:
            key = id(rec[3])
            child_ns[key] = child_ns.get(key, 0) + rec[2] - rec[1]
    spans: dict[str, dict] = {}
    for rec in _records:
        if rec[2] is None:
            continue
        dur = rec[2] - rec[1]
        t = spans.setdefault(rec[0], {"n": 0, "total_s": 0.0, "self_s": 0.0})
        t["n"] += 1
        t["total_s"] += dur / 1e9
        t["self_s"] += (dur - child_ns.get(id(rec), 0)) / 1e9
    counters = dict(_counters)
    for name, read in _readers.items():
        counters[name] = _since(read(), _base.get(name))
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where a card is present) into ``log_dir/trace.json``, with
    the port's spans recorded and annotated in it for the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was = (_on, _annotate)
    with profile(activities=activities) as prof:
        enable(annotate=True)
        try:
            yield
        finally:
            _synchronize()
            if was[0]:
                enable(annotate=was[1])
            else:
                disable()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize() -> None:
    import torch

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
    import torch

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
    def phase(self, name: str, span_name: str | None = None):
        """Time the block as phase ``name``, always; with ``span_name`` it is
        also that span while recording is on."""
        t0 = time.perf_counter()
        try:
            with span(span_name) if span_name else _NOOP:
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def logs(self) -> dict:
        return {f"Time_{k}": v / 60.0 for k, v in self.totals.items()}
