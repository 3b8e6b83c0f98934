"""Tiny cells for the CPU tests: the benchmark's configurations and mixes at
small widths and sizes, run on the CPU with the kernels' plain versions."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from portbench.harness import program

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
LOOSE = 1e9  # no limit: the tests read the numbers themselves


def config(name: str, **transformer) -> dict:
    """Configuration ``name`` at small widths, with ``transformer`` keys of
    its port config set besides."""
    raw = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    pc = copy.deepcopy(raw["port_config"])
    pc["algo"]["transformer"].update(embed_dim=32, num_layers=2, num_heads=2, **transformer)
    pc["algo"]["vq"]["num_codes"] = 32
    if pc["observation"]["modalities"]["obs"].get("rgb"):
        raw["obs"] = [(k, (64, 64, 3) if len(s) == 3 else s) for k, s in raw["obs"]]
        pc["observation"]["encoder"]["rgb"]["obs_randomizer_kwargs"].update(
            crop_height=60, crop_width=60)
    raw["port_config"] = pc
    raw["corpus_tokenizer"] = {"feature_dim": 12, "latent_dim": 24, "num_codes": 64,
                               "hidden_dim": 32}
    return program.normalize(raw)


MIXES = {
    "closed_loop": {"kind": "closed_loop", "envs": 3, "horizon": 4, "frame_pool": 3,
                    "warmup_requests": 1, "check_requests": 3, "trace_seconds": 1},
    "train": {"kind": "train", "batch_size": 8, "items": 40, "tasks": 3, "epoch_steps": 2,
              "check_steps": 3, "warmup_epochs": 1, "schedule_step": 5000,
              "trace_seconds": 1, "frame_pool": 4},
    "corpus": {"kind": "corpus", "rows": 512, "arrays": 2, "action_std": 0.5, "chunk": 128,
               "precision": "highest", "check_calls": 2, "keep_range": 4, "trace_seconds": 1},
}


def cell(name: str) -> tuple[dict, dict, dict]:
    """(workload entry, tiny config, tiny mix) of a cell of BENCHMARK.json."""
    wl = next(w for w in BENCH["workloads"] if w["name"] == name)
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, config(wl["config"]), dict(MIXES[mix["kind"]])
