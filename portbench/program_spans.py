"""One cell's traced run with the port's own spans and counters recorded
(``lipvq_tpu_torch/utils/profile_utils.py``), and the per-layer readings
they give.

    python portbench/program_spans.py --workload <name> --seed <n> --seconds <s> [--record 0|1]

It runs ``run.py``'s traced run (``--trace 1``) with the port's recording
switched on for each traced half: reset before the half, in memory in the
first (the device-only half, where the host runs at its own pace: the
readings come from it), annotated in the second as well, so that the result
line's ``breakdown.idle_gaps`` names the device's idle gaps by the program's
spans; off when the window ends. Then one more line: the first half's
units, time, span totals and the readings of ``METRICS``. ``--record 0``
runs the same without recording, to show what recording costs.

``run.py`` alone records nothing of the port: its drivers' ``reset_spans``
and ``spans`` keep only the benchmark's own spans, and ``METRICS`` are not
entries of ``BENCHMARK.json``. Moving them there takes ``recording``'s
three overrides into ``harness/driver.py::Driver`` (``drivers/train.py``'s
overrides calling it), each stem's reader into ``metrics/<stem>.py``, and the
entries into ``per_layer``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

import run as runmod  # noqa: E402  (sets the caches' paths before torch loads)


def _metric(name, unit, layer, moves, cell):
    return {"name": name, "unit": unit, "better": "lower", "source": "program_span",
            "layer": layer, "moves": moves, "workloads": [cell]}


SERVE, TRAIN, CORPUS = "image.serve16", "lowdim.train1600", "lowdim.corpus"
METRICS = [
    _metric("env_step_ms.serve", "ms", "env / rollout", "env_steps_per_s", SERVE),
    _metric("frame_stack_ms.serve", "ms", "env / rollout", "env_steps_per_s", SERVE),
    _metric("upload_ms.serve", "ms", "algo", "request_p95_ms", SERVE),
    _metric("upload_mb.serve", "MB", "algo", "request_p95_ms", SERVE),
    _metric("fetch_wait_ms.serve", "ms", "whole step", "request_p95_ms", SERVE),
    _metric("data_ms.train", "ms", "dataset / loader", "train_samples_per_s", TRAIN),
    _metric("step_host_ms.train", "ms", "algo", "train_samples_per_s", TRAIN),
    _metric("optimizer_host_ms.train", "ms", "optimizer", "train_samples_per_s", TRAIN),
    _metric("fetch_wait_ms.train", "ms", "whole step", "train_samples_per_s", TRAIN),
    _metric("upload_ms.corpus", "ms", "corpus driver", "corpus_rows_per_s", CORPUS),
    _metric("fetch_wait_ms.corpus", "ms", "whole step", "corpus_rows_per_s", CORPUS),
]


def _host_ms(s, names=(), suffix=None):
    """Host ms per unit of the first traced half in the program's spans
    ``names``, or in every span whose name ends in ``suffix``; None where the
    half recorded none of them (or nothing: a port without spans)."""
    prog = s.spans.get("program")
    if prog is None or not s.units:
        return None
    hit = [t["total_s"] for n, t in prog["spans"].items()
           if n in names or (suffix and n.endswith(suffix))]
    return 1e3 * sum(hit) / s.units if hit else None


def _upload_mb(s):
    prog = s.spans.get("program")
    if prog is None or not s.units or "h2d_bytes" not in prog["counters"]:
        return None
    return prog["counters"]["h2d_bytes"] / 1e6 / s.units


READERS = {
    "env_step_ms": lambda s: _host_ms(s, ("env.step",)),
    "frame_stack_ms": lambda s: _host_ms(s, ("env.frame_stack", "env.vector_stack")),
    "upload_ms": lambda s: _host_ms(s, suffix=".upload"),
    "upload_mb": _upload_mb,
    "fetch_wait_ms": lambda s: _host_ms(s, suffix=".fetch"),
    "data_ms": lambda s: _host_ms(s, ("train.data",)),
    "step_host_ms": lambda s: _host_ms(s, ("train.step",)),
    "optimizer_host_ms": lambda s: _host_ms(s, ("train.optimizer",)),
}


def recording(cls):
    """Driver class ``cls`` with the port's recording on for each traced
    half (reset before it, annotated in the second), its totals under
    ``program`` in the first half's spans, and off when the window ends.
    ``cls`` itself where the port has no ``span`` (a commit before it)."""
    from lipvq_tpu_torch.utils import profile_utils as pu

    if not hasattr(pu, "span"):
        return cls

    class Recording(cls):
        def reset_spans(self) -> None:
            super().reset_spans()
            if self.tracer is not None:
                pu.reset()
                pu.enable(annotate=self.tracer.half >= 0)

        def spans(self) -> dict:
            out = super().spans()
            return dict(out, program=pu.totals()) if pu.recording() else out

        def run_window(self, seconds: float, tracer=None) -> int:
            try:
                return super().run_window(seconds, tracer)
            finally:
                pu.disable()

    return Recording


def readings(workload: str, units: int, spans: dict) -> dict:
    """{metric: {value, unit}} of the cell's ``METRICS``, null where unread."""
    s = SimpleNamespace(units=units, spans=spans)
    return {m["name"]: {"value": READERS[m["name"].split(".")[0]](s), "unit": m["unit"]}
            for m in METRICS if workload in m["workloads"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    wl = runmod.cell(bench, args.workload)
    from portbench.harness import common
    from portbench.harness import driver as base

    common.require_cards(wl["chips"])
    made, load = [], base.load

    def load_driver(kind: str):
        cls = load(kind).Driver
        cls = recording(cls) if args.record else cls

        class Kept(cls):
            def setup(self) -> None:
                made.append(self)
                super().setup()

        return SimpleNamespace(Driver=Kept)

    base.load = load_driver
    rc = runmod.run(bench, wl, args.seed, args.seconds, 1)
    if rc:
        return rc
    d = made[0]
    print(json.dumps({"workload": wl["name"], "seed": args.seed, "record": args.record,
                      "units": d.traced_units, "window_s": d.tracer.window_s[0],
                      "program": d.traced_spans.get("program"),
                      "metrics": readings(wl["name"], d.traced_units, d.traced_spans)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
