"""``program_spans.py``: each reader of the port's spans from a hand-made
summary, null without the port's totals (a commit before them); the
recording hook on a tiny corpus cell on the CPU, in memory in the first
traced half and annotated in the second, and a driver left as it is where
the port has no ``span``."""

from __future__ import annotations

import pytest
from torch.profiler import ProfilerActivity, profile

from lipvq_tpu_torch.utils import profile_utils
from portbench import program_spans as ps
from portbench.harness import driver as base
from portbench.harness.trace import Summary
from portbench.tests import tiny


def _summary(spans: dict, counters: dict | None = None, units: int = 4) -> Summary:
    prog = {"spans": {n: {"n": 1, "total_s": t, "self_s": t} for n, t in spans.items()},
            "counters": counters or {}}
    return Summary(window_s=1.0, busy_s=0.5, device=[], op_kernel_s={}, units=units,
                   spans={"data_wait_s": 0.0, "program": prog})


CASES = [
    ("env_step_ms", {"env.step": 0.2, "env.frame_stack": 0.1}, 50.0),
    ("frame_stack_ms", {"env.step": 0.2, "env.frame_stack": 0.1, "env.vector_stack": 0.02},
     30.0),
    ("upload_ms", {"policy.upload": 0.04, "corpus.upload": 0.004, "model.head": 1.0}, 11.0),
    ("fetch_wait_ms", {"policy.fetch": 0.1, "train.fetch": 0.02, "env.step": 1.0}, 30.0),
    ("data_ms", {"train.data": 0.004, "train.step": 0.1}, 1.0),
    ("step_host_ms", {"train.step": 0.1, "train.optimizer": 0.01}, 25.0),
    ("optimizer_host_ms", {"train.step": 0.1, "train.optimizer": 0.01}, 2.5),
]


@pytest.mark.parametrize("stem,spans,want", CASES, ids=[c[0] for c in CASES])
def test_reader_takes_host_ms_per_unit(stem, spans, want):
    assert ps.READERS[stem](_summary(spans)) == pytest.approx(want)
    assert ps.READERS[stem](_summary({"other.span": 1.0})) is None
    parent = Summary(window_s=1.0, busy_s=0.5, device=[], op_kernel_s={}, units=4,
                     spans={"data_wait_s": 0.0})
    assert ps.READERS[stem](parent) is None


def test_upload_mb_reads_the_byte_counter():
    assert ps.READERS["upload_mb"](_summary({}, {"h2d_bytes": 400_000_000})) == 100.0
    assert ps.READERS["upload_mb"](_summary({}, {"k1_launches": 3})) is None
    assert ps.READERS["upload_mb"](Summary(1.0, 0.5, [], {}, 4)) is None


def test_every_metric_has_a_reader_and_a_cell():
    cells = {w["name"] for w in tiny.BENCH["workloads"]}
    e2e = {m["name"]: m for m in tiny.BENCH["end_to_end"]}
    layers = {m["layer"] for m in tiny.BENCH["per_layer"]} | {"env / rollout"}
    assert len(ps.METRICS) == 11 and len({m["name"] for m in ps.METRICS}) == 11
    for m in ps.METRICS:
        assert m["name"].split(".")[0] in ps.READERS and m["layer"] in layers
        assert set(m["workloads"]) <= cells
        assert set(m["workloads"]) <= set(e2e[m["moves"]]["workloads"])
    assert not {m["name"] for m in ps.METRICS} & {m["name"] for m in tiny.BENCH["per_layer"]}


class HalfTracer:
    """``trace.Tracer``'s halves on the CPU: a CPU profiler per half, whose
    event names are kept."""

    def __init__(self):
        self.half, self.names, self.window_s = -1, [], []

    def start(self):
        self.half += 1
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()

    def stop(self):
        self.prof.stop()
        self.names.append({e.name() for e in self.prof.profiler.kineto_results.events()})


@pytest.fixture(autouse=True)
def recording_off():
    profile_utils.disable()
    profile_utils.reset()
    yield
    profile_utils.disable()
    profile_utils.reset()


def _driver(cell: str):
    """Tiny cell ``cell``'s driver, recording, set up on the CPU."""
    _, cfg, mix = tiny.cell(cell)
    d = ps.recording(base.load(mix["kind"]).Driver)(cfg, mix, 2147483661, "cpu")
    d.setup()
    return d


def test_recording_hook_records_the_first_half_and_annotates_the_second():
    d = _driver("lowdim.corpus")
    assert not profile_utils.recording() and profile_utils.records() == []
    tracer = HalfTracer()
    d.run_window(0.2, tracer)
    assert not profile_utils.recording()
    prog = d.traced_spans["program"]["spans"]
    assert prog["corpus.upload"]["n"] == prog["corpus.fetch"]["n"] == d.traced_units >= 1
    assert prog["corpus.chunk"]["n"] == 4 * d.traced_units  # 512 rows in chunks of 128
    assert "corpus.chunk" not in tracer.names[0] and "corpus.chunk" in tracer.names[1]
    got = ps.readings("lowdim.corpus", d.traced_units, d.traced_spans)
    assert set(got) == {"upload_ms.corpus", "fetch_wait_ms.corpus"}
    assert all(v["value"] > 0 for v in got.values())
    # without a tracer (``--trace 0``) recording stays off
    profile_utils.reset()
    d.run_window(0.1)
    assert profile_utils.records() == [] and "program" not in d.spans()
    d.free()


def test_recording_hook_leaves_a_driver_without_port_spans_as_it_is(monkeypatch):
    monkeypatch.delattr(profile_utils, "span")
    cls = base.load("train").Driver
    assert ps.recording(cls) is cls


def test_recording_hook_keeps_the_train_drivers_own_span():
    d = _driver("lowdim.train1600")
    d.run_window(0.2, HalfTracer())
    spans = d.traced_spans
    assert spans["data_wait_s"] > 0
    prog = spans["program"]["spans"]
    steps = d.traced_units
    assert prog["train.step"]["n"] == prog["train.data"]["n"] == steps
    assert prog["train.fetch"]["n"] == steps // d.mix["epoch_steps"]
    got = ps.readings("lowdim.train1600", steps, spans)
    assert len(got) == 4 and all(v["value"] > 0 for v in got.values())
    d.free()
