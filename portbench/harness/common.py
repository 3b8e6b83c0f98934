"""What every run shares: the card check, the set-up clock, the isolation
check, percentiles and the result line."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

# top-level module names that no run may load: the JAX stack and the JAX
# package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "lipvq_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``FORBIDDEN``, compared as whole names."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc/self/stat's start
    time against /proc/uptime, both in clock ticks of 10 ms)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def require_cards(count: int) -> None:
    """Exit with code 2, printing no result, unless CUDA has ``count`` cards."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {count} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        sys.exit(2)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output with
    the same numbers under ``check``, its last key."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = dict(result)
    line["check"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
