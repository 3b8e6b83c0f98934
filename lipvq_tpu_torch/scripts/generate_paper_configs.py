"""Generate the full paper experiment config set.

Counterpart of reference scripts/generate_paper_configs.py:1-1369,
which emits every training config used in the paper's tables from the
registered per-algo defaults. Organization mirrors the reference:

- ``core/``    one config per (algorithm x dataset suite) pairing
- ``subset/``  dataset-size ablations (10/25/50 demos filter keys)
- ``tokenizers/`` the paper's 5 action-tokenizer switches for ICL
  (LipVQ-VAE / bin / FAST / ln_act / raw — the headline comparison)

plus a top-level runner script of ``python -m lipvq_tpu_torch.scripts.train
--config <json>`` commands (reference generate_paper_configs.py
main loop).

    python -m lipvq_tpu_torch.scripts.generate_paper_configs \\
        --output_dir /tmp/paper_configs

The port's twin of ``lipvq_tpu/scripts/generate_paper_configs.py``,
built from the port's ``config_factory``; ``run_all.sh`` names the port's
train script.
"""

from __future__ import annotations

import argparse
import json
import os

from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.robocasa.dataset_registry import (
    MULTI_STAGE_TASK_DATASETS,
    SINGLE_STAGE_TASK_DATASETS,
    get_ds_path,
)

# algorithms appearing in the paper's comparison tables
CORE_ALGOS = (
    "bc", "bcq", "cql", "iql", "td3_bc", "gl", "hbc", "iris",
    "diffusion_policy", "act", "icl", "icl_mamba",
)

# the paper's tokenizer comparison (reference icl_config.py:154-157)
TOKENIZER_SWITCHES = {
    "lipvq": {"vq_vae_enabled": True},
    "bin": {"bin_enabled": True},
    "fast": {"fast_enabled": True},
    "ln_act": {"ln_act_enabled": True},
    "raw": {},
}

_ALL_FLAGS = ("vq_vae_enabled", "bin_enabled", "fast_enabled",
              "ln_act_enabled")


def _base_dict(algo_name, task, filter_key="50_demos"):
    cfg = config_factory(algo_name)
    d = json.loads(cfg.dump())
    d["experiment"]["name"] = f"{algo_name}_{task}_{filter_key}"
    d["train"]["data"] = get_ds_path(task, "human_im")
    d["train"]["hdf5_filter_key"] = filter_key
    return d


def generate_paper_configs(output_dir: str, tasks=None) -> list:
    tasks = tasks or (
        list(SINGLE_STAGE_TASK_DATASETS)[:8]
        + list(MULTI_STAGE_TASK_DATASETS)
    )
    paths = []
    runner = ["#!/bin/bash", ""]

    def emit(subdir, name, d):
        path = os.path.join(output_dir, subdir, f"{name}.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(d, f, indent=2, sort_keys=True)
        runner.append(f"python -m lipvq_tpu_torch.scripts.train --config {path}")
        paths.append(path)

    # core table: every algo on every task
    for algo in CORE_ALGOS:
        for task in tasks:
            d = _base_dict(algo, task)
            emit("core", f"{algo}_{task}", d)

    # dataset-size ablation (reference subset configs)
    for task in tasks[:3]:
        for fk in ("10_demos", "25_demos", "50_demos"):
            d = _base_dict("icl", task, filter_key=fk)
            emit("subset", f"icl_{task}_{fk}", d)

    # the tokenizer headline comparison
    for tok_name, switches in TOKENIZER_SWITCHES.items():
        for task in tasks[:4]:
            d = _base_dict("icl", task)
            for flag in _ALL_FLAGS:
                d["algo"]["transformer"][flag] = switches.get(flag, False)
            d["experiment"]["name"] = f"icl_{tok_name}_{task}"
            emit("tokenizers", f"icl_{tok_name}_{task}", d)

    os.makedirs(output_dir, exist_ok=True)
    script = os.path.join(output_dir, "run_all.sh")
    with open(script, "w") as f:
        f.write("\n".join(runner) + "\n")
    os.chmod(script, 0o755)
    return paths


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--tasks", type=str, nargs="*", default=None)
    args = parser.parse_args()
    paths = generate_paper_configs(args.output_dir, args.tasks)
    print(f"generated {len(paths)} paper configs under {args.output_dir}")


if __name__ == "__main__":
    main()
