"""BENCHMARK.json and the files it names: every configuration, traffic mix,
limit and per-layer metric is found by its name, and the file keeps to the
benchmark's contract (names, units, lengths, keys)."""

from __future__ import annotations

import importlib.util
import json
import re

import pytest

from portbench.tests.tiny import BENCH, ROOT

HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_found_by_name(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()
    assert (HERE / "counts" / f"{cfg['counts']}.py").is_file()
    assert isinstance(cfg["algo"], str) and isinstance(cfg["port_config"], dict)
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    # no width is ever reduced
    assert not any(k.endswith(("_dim", "_rank")) or "hidden" in k or "heads" in k
                   for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_files_are_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
    assert w["chips"] in (1, 4)
    assert any(c["name"] == w["config"] for c in BENCH["configs"])
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    assert (HERE / "harness" / "drivers" / f"{mix['kind']}.py").is_file()
    limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if "workloads" not in m or w["name"] in m["workloads"]]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(w["name"] in m.get("workloads", ()) or m["moves"] in e2e
               for m in BENCH["per_layer"])


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(m):
    assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", names)) <= names


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_is_found_by_name(m):
    assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES and _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])
    own = HERE / "metrics" / f"{m['name']}.py"
    path = own if own.is_file() else HERE / "metrics" / f"{m['name'].split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_metrics_of_one_layer_name_it_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({s.lower() for s in layers}) == len(layers)
    # every reader file reads a metric, by its whole name or its stem
    names = {m["name"] for m in BENCH["per_layer"]}
    assert {p.stem for p in (HERE / "metrics").glob("*.py")} <= (
        names | {n.split(".")[0] for n in names})
