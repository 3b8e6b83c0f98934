"""The traced window: torch.profiler, reduced to what the per-layer readers
and the breakdown need. The window has two halves of equal length: the
first traces the device alone (busy and idle time, kernel times and
counts: the host runs at its own pace), the second the device and the host
(which host op launched each kernel, what the host did in each idle gap;
tracing the host slows it, so this half's idle time is not reported).

Busy time as the union of the device's kernel and copy intervals, the
kernel-to-op link and ``kernel_name`` are copied from the repository's
``chip_smoke.py`` (``device_busy``, ``profile_convs``): each kernel's time
is credited to the innermost host op that launched it, which the readers
use to attribute time to layers (convolution ops, the optimizer's foreach
ops)."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field


def kernel_name(name: str) -> str:
    """A kernel's name without its return type, namespace noise, template
    and call arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0]


def merged(spans):
    """Sorted (start, end) spans -> their union as disjoint (start, end)."""
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class Summary:
    """One traced window. Times in seconds; ``device`` holds (name, start
    us, end us) of every kernel, copy and memset of the device-only half;
    ``op_kernel_s`` each host op's launched kernel time in the other half,
    as a share of that half's busy time."""

    window_s: float
    busy_s: float
    device: list
    op_kernel_s: dict
    units: int
    flops: float = 0.0
    k1: dict = field(default_factory=dict)
    spans: dict = field(default_factory=dict)
    peaks: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    def kernels(self):
        """(name, seconds) of the kernels (no copies, no memsets)."""
        return [(n, (e - s) / 1e6) for n, s, e in self.device
                if not n.startswith(("Memcpy", "Memset"))]

    def copies(self):
        return [(n, (e - s) / 1e6) for n, s, e in self.device if n.startswith("Memcpy")]


class Tracer:
    """``start`` and ``stop`` bracket each half (after a device
    synchronize); ``summary`` reduces both."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._profs = [profile(activities=[ProfilerActivity.CUDA]),
                       profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])]
        self.half = -1
        self.window_s = []

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self.half += 1
        self._profs[self.half].start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self.window_s.append(time.perf_counter() - self._t0)
        self._profs[self.half].stop()

    def _device(self, prof):
        cuda = self._torch.autograd.DeviceType.CUDA
        dev = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == cuda and not getattr(e, "is_user_annotation", False)),
                     key=lambda x: x[1])
        busy = merged([(s, e) for _, s, e in dev])
        return dev, busy, sum(e - s for s, e in busy) / 1e6

    def summary(self, units: int) -> Summary:
        """``units``: the work done in the first half."""
        cuda = self._torch.autograd.DeviceType.CUDA
        dev, busy, busy_s = self._device(self._profs[0])
        by_name: dict[str, float] = {}
        for n, s, e in dev:
            k = kernel_name(n)
            by_name[k] = by_name.get(k, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        host, op_kernel_s = [], {}
        for e in self._profs[1].events():
            if e.device_type != cuda:
                host.append((e.time_range.start, e.time_range.end, e.name))
                for k in e.kernels:
                    op_kernel_s[e.name] = op_kernel_s.get(e.name, 0.0) + k.duration / 1e6
        _, busy2, busy2_s = self._device(self._profs[1])
        return Summary(window_s=self.window_s[0], busy_s=busy_s, device=dev,
                       op_kernel_s={k: v / busy2_s for k, v in op_kernel_s.items()}
                       if busy2_s else {},
                       units=units,
                       breakdown={"device_ops": [[n, s] for n, s in top],
                                  "idle_gaps": idle_gaps(busy2, host)})


def idle_gaps(busy, host, top: int = 10, scan: int = 4000):
    """The device's idle gaps between busy spans, each named by the innermost
    host event running at its midpoint, summed by name: the ``top`` longest."""
    host = sorted(host)
    starts = [h[0] for h in host]
    by_name: dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        mid = (end + nxt) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "host"
        for j in range(i, max(i - scan, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (nxt - end) / 1e6
    return [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
