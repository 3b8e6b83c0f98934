"""The port's spans and counters (``utils/profile_utils.py``): off, they
record nothing, read no clock and enter no ``record_function``; on, they
nest, share a request id and give self times; annotated, they lie in the
profiler's trace on its clock. Then the four instrumented paths on the
CPU: ``run_epoch`` of a tiny ICL policy, ``get_action``, ``VectorEnv`` with
frame stacking, and ``tokenize_array``."""

import functools
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
from lipvq_tpu_torch.envs.vector_env import VectorEnv
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.ops import fused_adamw, selective_scan, vq_lookup
from lipvq_tpu_torch.parallel.corpus import tokenize_array
from lipvq_tpu_torch.utils import obs_utils, profile_utils, train_utils
from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides, make_synthetic_export

torch.set_num_threads(1)

TIME_KEYS = {"Time_Data_Loading", "Time_Process_Batch", "Time_Train_Batch", "Time_Log_Info"}


@pytest.fixture(autouse=True)
def recording_off():
    profile_utils.disable()
    profile_utils.reset()
    yield
    profile_utils.disable()
    profile_utils.reset()


class FakeClock:
    """``time`` for ``profile_utils``: perf_counter_ns advances by hand."""

    def __init__(self):
        self.now = 1_000

    def perf_counter_ns(self):
        return self.now

    def time_ns(self):
        return 5_000_000

    def perf_counter(self):
        return self.now / 1e9


def _names(prof) -> list:
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_span_off_reads_no_clock_and_enters_no_record_function(monkeypatch):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"the off path read time.{name}")

    def no_annotation(*a, **k):
        raise AssertionError("the off path entered record_function")

    monkeypatch.setattr(profile_utils, "time", NoClock())
    monkeypatch.setattr(torch.profiler, "record_function", no_annotation)
    first = profile_utils.span("a")
    with first, profile_utils.span("b"):
        profile_utils.count("c", 3)
    assert profile_utils.span("d") is first  # one shared no-op, nothing allocated
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profile_utils.span("port.off"):
                torch.ones(2).sum()
    assert "port.off" not in _names(prof) and "aten::sum" in _names(prof)
    assert profile_utils.records() == []
    assert profile_utils.totals()["spans"] == {}
    assert "c" not in profile_utils.totals()["counters"]


def test_spans_nest_share_a_request_and_give_self_time(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(profile_utils, "time", clock)
    profile_utils.enable()
    for _ in range(2):  # two requests of: outer [inner, inner]
        with profile_utils.span("outer"):
            clock.now += 10
            for _ in range(2):
                with profile_utils.span("inner"):
                    clock.now += 30
            clock.now += 20
    with profile_utils.span("alone"):
        clock.now += 7
    profile_utils.disable()
    with profile_utils.span("after"):
        clock.now += 1
    recs = profile_utils.records()
    assert [r[0] for r in recs] == ["outer", "inner", "inner"] * 2 + ["alone"]
    assert [r[3] for r in recs] == [None, 0, 0, None, 3, 3, None]
    assert [r[4] for r in recs] == [0, 0, 0, 3, 3, 3, 6]
    offset = clock.time_ns() - 1_000
    assert recs[0][1] == 1_000 + offset and recs[0][2] == 1_090 + offset
    tot = profile_utils.totals()["spans"]
    assert tot["outer"] == {"n": 2, "total_s": pytest.approx(180e-9),
                            "self_s": pytest.approx(60e-9)}
    assert tot["inner"] == {"n": 4, "total_s": pytest.approx(120e-9),
                            "self_s": pytest.approx(120e-9)}
    assert tot["alone"]["n"] == 1 and "after" not in tot
    profile_utils.reset()
    assert profile_utils.records() == [] and profile_utils.totals()["spans"] == {}


def test_spans_past_the_bound_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(profile_utils, "MAX_SPANS", 3)
    profile_utils.enable()
    with profile_utils.span("root"):
        for _ in range(4):
            with profile_utils.span("leaf"):
                pass
    tot = profile_utils.totals()
    assert tot["spans"]["root"]["n"] == 1 and tot["spans"]["leaf"]["n"] == 2
    assert tot["counters"]["spans_dropped"] == 2


def test_threads_keep_their_own_nesting_and_lose_no_count():
    """8 threads, each 300 requests of a root span holding one child, then
    20000 additions to a shared counter, with the interpreter switching
    threads every microsecond: no count is lost and every child's parent
    and request is its own thread's root."""
    def work(k):
        for _ in range(300):
            with profile_utils.span(f"root{k}"):
                with profile_utils.span(f"child{k}"):
                    profile_utils.count(f"hits{k}", 2)
        for _ in range(20000):
            profile_utils.count("hits")

    profile_utils.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counters = profile_utils.totals()["counters"]
    assert counters["hits"] == 160000 and all(counters[f"hits{k}"] == 600 for k in range(8))
    recs = profile_utils.records()
    assert len(recs) == 4800
    for name, _, end, parent, request in recs:
        assert end is not None
        if name.startswith("child"):
            assert recs[parent][0] == "root" + name[5:] and request == parent
        else:
            assert parent is None


def test_annotated_spans_lie_in_the_profiler_trace_on_its_clock():
    """Each span appears once in kineto's events by name, starting at most
    1 ms after the span's own recorded start (and never before it)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profile_utils.enable(annotate=True)
        with profile_utils.span("clock.outer"):
            for i in range(3):
                with profile_utils.span(f"clock.inner{i}"):
                    torch.ones(8).sum()
        profile_utils.disable()
    starts = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("clock."):
            assert e.name() not in starts
            starts[e.name()] = e.start_ns()
    recs = profile_utils.records()
    assert sorted(starts) == sorted(r[0] for r in recs)
    for name, start, end, _, _ in recs:
        assert 0 <= starts[name] - start < 1_000_000, (name, starts[name] - start)
        assert end > start


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    with profile_utils.trace(str(tmp_path)):
        with profile_utils.span("trace.block"):
            torch.ones(4).sum()
    assert not profile_utils.recording()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "trace.block" for e in events)
    assert profile_utils.totals()["spans"]["trace.block"]["n"] == 1


def test_totals_count_launches_and_counters_since_reset(monkeypatch):
    monkeypatch.setattr(vq_lookup.vq_nearest_cuda, "launches", 40)
    monkeypatch.setattr(vq_lookup.vq_nearest_with_stats_cuda, "launches", 7)
    profile_utils.reset()
    profile_utils.enable()
    vq_lookup.vq_nearest_cuda.launches += 3
    vq_lookup.vq_nearest_with_stats_cuda.launches += 1
    profile_utils.count("rows")
    profile_utils.count("rows", 4)
    counters = profile_utils.totals()["counters"]
    assert counters == {"rows": 5, "k1_launches": 3, "k1f_launches": 0, "k2_launches": 1,
                        "k1_tc_launches": 0, "optimizer_fused_steps": 0,
                        "optimizer_fused_elems": 0, "optimizer_torch_steps": 0,
                        "k1_rescored_rows": 0, "k1_rescored_every_code_rows": 0,
                        "ssm_scan_launches": 0, "ssm_scan_elems": 0,
                        "ssm_mixer_fused": 0, "ssm_mixer_composed": 0,
                        "causal_conv1d_launches": 0}


@pytest.fixture
def registry(monkeypatch):
    """``profile_utils.register`` into a copy of the registry, which the
    test's end puts back."""
    monkeypatch.setattr(profile_utils, "_readers", dict(profile_utils._readers))
    monkeypatch.setattr(profile_utils, "_base", dict(profile_utils._base))


def test_a_registered_host_counter_reads_as_its_count_since_reset(registry):
    box = {"n": 11}
    profile_utils.register({"things": lambda: box["n"]})
    assert profile_utils.totals()["counters"]["things"] == 11  # before a reset: since start
    profile_utils.reset()
    box["n"] += 4
    assert profile_utils.totals()["counters"]["things"] == 4
    profile_utils.enable()  # recording plays no part
    box["n"] += 2
    assert profile_utils.totals()["counters"]["things"] == 6
    profile_utils.reset()
    assert profile_utils.totals()["counters"]["things"] == 0


def test_a_registered_tensor_counter_is_snapshotted_at_reset(registry):
    """A CPU tensor stands in for a card's: ``reset`` keeps a copy (later
    adds in place do not reach it), ``totals`` subtracts it and sums over
    the cards, a card first counted after the reset counting from 0."""
    per_card = {0: torch.tensor([7, 3], dtype=torch.int64)}
    profile_utils.register({"rows": lambda: {i: t[0] for i, t in per_card.items()},
                            "every": lambda: {i: t[1] for i, t in per_card.items()}})
    profile_utils.reset()
    per_card[0] += torch.tensor([5, 1])
    per_card[1] = torch.tensor([2, 2], dtype=torch.int64)
    counters = profile_utils.totals()["counters"]
    assert (counters["rows"], counters["every"]) == (7, 3)
    assert type(counters["rows"]) is int


def test_a_kernel_counter_needs_no_edit_of_profile_utils(monkeypatch):
    """The kernel modules register their counters; ``profile_utils`` names
    no ops module and looks none up."""
    import inspect

    src = inspect.getsource(profile_utils)
    assert "lipvq_tpu_torch.ops" not in src and "sys.modules" not in src
    scan, torch_step = selective_scan.selective_scan_cuda, fused_adamw.torch_step_
    monkeypatch.setattr(scan, "launches", scan.launches + 2)
    monkeypatch.setattr(torch_step, "steps", torch_step.steps + 1)
    counters = profile_utils.totals()["counters"]
    assert (counters["ssm_scan_launches"], counters["optimizer_torch_steps"]) == (2, 1)


# -- the instrumented paths ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_icl(tmp_path_factory):
    """A tiny ICL policy on the CPU and its training batches' loader."""
    root = tmp_path_factory.mktemp("tracing")
    export = make_synthetic_export(str(root / "export"), n_demos=3, demo_len=20)
    d = icl_test_config_overrides()
    d["train"].update({"data": export, "output_dir": str(root)})
    cfg = config_factory("icl", d)
    obs_utils.initialize_obs_utils_with_config(cfg)
    sm = get_shape_metadata_from_dataset(export, all_obs_keys=cfg.all_obs_keys)
    model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device="cpu")
    train_ds, _ = train_utils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"])
    loader, _, _ = train_utils.make_loaders(cfg, train_ds, None)
    return model, loader


def test_run_epoch_records_the_train_spans_and_keeps_its_time_keys(tiny_icl):
    model, loader = tiny_icl
    off = train_utils.run_epoch(model, loader, epoch=1, num_steps=2)
    profile_utils.enable()
    log = train_utils.run_epoch(model, loader, epoch=1, num_steps=2)
    profile_utils.disable()
    assert {k for k in off if k.startswith("Time_")} == TIME_KEYS
    assert set(log) == set(off) and np.isfinite(log["Loss"])
    tot = profile_utils.totals()["spans"]
    want = {"train.data": 2, "train.step": 2, "train.fetch": 1, "train.backward": 2,
            "train.optimizer": 2, "model.trunks": 2, "model.tokenizer": 2,
            "model.backbone": 2, "model.head": 2}
    assert {k: v["n"] for k, v in tot.items()} == want
    # the phases are minutes of the same blocks the spans time
    assert log["Time_Train_Batch"] * 60 >= tot["train.step"]["total_s"]
    assert log["Time_Train_Batch"] * 60 < tot["train.step"]["total_s"] + 0.05
    assert log["Time_Data_Loading"] * 60 >= tot["train.data"]["total_s"]
    recs = profile_utils.records()
    steps = [i for i, r in enumerate(recs) if r[0] == "train.step"]
    for name, _, _, parent, request in recs:
        if name.startswith("model.") or name in ("train.backward", "train.optimizer"):
            assert parent in steps and request == parent, name
    assert tot["train.step"]["self_s"] < tot["train.step"]["total_s"]


def test_get_action_records_the_policy_spans(tiny_icl):
    model, loader = tiny_icl
    batch = model.process_batch_for_training(next(iter(loader)))
    obs = {k: np.asarray(v[:2]) for k, v in batch["obs"].items()}
    ctx = {"obs": obs, "actions": np.asarray(batch["actions"][:2])}
    draws = model._generator.get_state()
    want = model.get_action(obs, ctx)
    model._generator.set_state(draws)
    profile_utils.enable()
    got = model.get_action(obs, ctx)
    profile_utils.disable()
    np.testing.assert_array_equal(got, want)
    recs = profile_utils.records()
    assert [r[0] for r in recs] == ["policy.upload", "model.trunks", "model.tokenizer",
                                    "model.backbone", "model.head", "policy.fetch"]
    # on the CPU nothing goes up to a card
    assert "h2d_bytes" not in profile_utils.totals()["counters"]


def test_put_infer_counts_the_bytes_host_leaves_send_to_a_device(tiny_icl):
    """``h2d_bytes`` counts host leaves as copied (uint8 frames as bytes,
    float64 as float32), and no tensor already on the device; on the
    ``meta`` device, which stands for a card here."""
    model, _ = tiny_icl
    meta = torch.device("meta")
    tree = {"frames": np.zeros((2, 3, 4, 4), np.uint8), "low": np.zeros((2, 5)),
            "cpu": torch.zeros(2, 3), "there": torch.zeros(7, device=meta)}
    monkey, model.device = model.device, meta
    try:
        model._put_infer(tree)  # recording off: nothing counted
        profile_utils.enable()
        out = model._put_infer(tree)
    finally:
        model.device = monkey
    assert all(v.device == meta and v.dtype == torch.float32 for v in out.values())
    assert profile_utils.totals()["counters"]["h2d_bytes"] == 2 * 3 * 16 + 2 * 5 * 4 + 6 * 4


@pytest.mark.parametrize("frame_stack", [None, 2])
def test_vector_env_step_holds_the_stacking_spans(frame_stack):
    envs = VectorEnv([functools.partial(SyntheticKitchenEnv, seed=s, horizon=8)
                      for s in range(3)], frame_stack=frame_stack)
    envs.reset()
    act = np.zeros((3, envs.action_dimension), np.float32)
    profile_utils.enable()
    obs, _, _, _ = envs.step(act)
    profile_utils.disable()
    recs = profile_utils.records()
    stacks = 3 if frame_stack else 0
    assert [r[0] for r in recs] == ["env.step"] + ["env.frame_stack"] * stacks + [
        "env.vector_stack"]
    assert all(r[3] == 0 and r[4] == 0 for r in recs[1:])
    if frame_stack:
        assert next(iter(obs.values())).shape[:2] == (3, frame_stack)


def test_tokenize_array_records_one_upload_each_chunk_and_one_fetch():
    torch.manual_seed(0)
    model = LipVQVAE(feature_dim=12, latent_dim=16, num_codes=32, hidden_dim=32)
    x = np.random.default_rng(0).uniform(-1, 1, (160, 12)).astype(np.float32)
    want = tokenize_array(model, x, device="cpu", chunk=64)
    profile_utils.enable()
    got = tokenize_array(model, x, device="cpu", chunk=64)  # 64 + 64 + 32 rows
    profile_utils.disable()
    np.testing.assert_array_equal(got, want)
    assert [r[0] for r in profile_utils.records()] == (
        ["corpus.upload"] + ["corpus.chunk"] * 3 + ["corpus.fetch"])
