"""Run one cell of the benchmark of lipvq_tpu_torch once.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``, which names the port's algorithm, its plain
reference, ``reference/<name>.py``, and its analytic counts,
``counts/<name>.py``) and a traffic mix
(``traffic/<mix>.json``, whose ``kind`` names its driver,
``harness/drivers/<kind>.py``); ``limits/<workload>.json`` holds the limits
of the numbers that decide ``correct``, and each per-layer metric is read by
``metrics/<name>.py`` or, where there is none, by the reader of its stem
(the name before the first dot), ``metrics/<stem>.py``.
The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each compared number with its limit, which
also ends standard error. The run exits non-zero and prints no result where
CUDA has fewer cards than the cell asks for, or where JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent

# every cache of the program inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CHECKOUT / ".portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(CHECKOUT))


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, else ``metrics/<stem>.py``."""
    own = HERE / "metrics" / f"{name}.py"
    return own if own.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")


def per_layer_entries(bench: dict, wl: dict, reported: set) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric it reports."""
    return [m for m in bench["per_layer"]
            if (wl["name"] in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def end_to_end_entries(bench: dict, wl: dict) -> list:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or wl["name"] in m["workloads"]]


def judge(worst: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    wl = cell(bench, args.workload)
    from portbench.harness import common

    common.require_cards(wl["chips"])
    return run(bench, wl, args.seed, args.seconds, args.trace)


def run(bench: dict, wl: dict, seed: int, seconds: float, trace_: int, device="cuda",
        cfg=None, mix=None, limits=None) -> int:
    """One run of cell ``wl``, its result printed; ``device``, ``cfg``,
    ``mix`` and ``limits`` stand for the card and the cell's files in tests
    on the CPU."""
    import torch

    from portbench.harness import common, program, trace
    from portbench.harness import driver as base

    mix = mix or json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = limits or json.loads((HERE / "limits" / f"{wl['name']}.json").read_text())["limits"]
    cfg = cfg or program.load_config(wl["config"])
    device = torch.device(device)
    program.reference(cfg).set_fp32()
    card = "cpu"
    if device.type == "cuda":
        t0 = common.process_age_s()
        card = common.card_line()
        t1 = common.process_age_s()
        from lipvq_tpu_torch.ops import _build

        _build.build(["vq_nearest"])
        print(f"card: {card}; set-up before the cell: {t0:.2f} s to here, the card line "
              f"{t1 - t0:.2f} s, K1's build or load {common.process_age_s() - t1:.2f} s",
              file=sys.stderr)
    driver = base.load(mix["kind"]).Driver(cfg, mix, seed, device)
    age = common.process_age_s()
    driver.setup()
    setup_s = common.process_age_s()
    print(f"set-up: {setup_s:.2f} s, {age:.2f} s of it before the cell's set-up; "
          f"phases {driver.phases()}", file=sys.stderr)
    tracer = trace.Tracer() if trace_ else None
    if trace_:
        seconds = min(seconds, mix["trace_seconds"])
    driver.run_window(seconds, tracer)
    e2e = driver.end_to_end()
    if hasattr(driver, "host_summary"):
        print(f"host: {driver.host_summary()}", file=sys.stderr)
    dev_info = (common.device_info(wl["chips"]) if device.type == "cuda"
                else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    summary = tracer.summary(driver.traced_units) if tracer is not None else None
    del tracer
    driver.free()
    worst, per = driver.check()
    correct, checks = judge(worst, limits)
    failed = sum(any(p.get(k, -math.inf) > limits[k] for k in limits) for p in per)

    found = common.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3

    if trace_:
        b, n, d = driver.k1_shape()
        summary.flops = driver.flops_per_unit() * driver.traced_units
        summary.k1 = dict(driver.counts.k1(b, n, d), launches=driver.k1_launches)
        summary.spans = driver.traced_spans
        summary.peaks = json.loads((HERE / "counts" / "peaks.json").read_text())
        reported = {m["name"] for m in end_to_end_entries(bench, wl)}
        metrics = {}
        for m in per_layer_entries(bench, wl, reported):
            value = load_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        print(f"power limit beside the shares: {card}", file=sys.stderr)
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in end_to_end_entries(bench, wl)}
    result = {"correct": correct, "attempted": driver.units, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_:
        result["breakdown"] = summary.breakdown
    print(json.dumps({"per_item": per}, default=str), file=sys.stderr)
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
