"""Measure scripted-expert success rates across the registry tasks (the
port's twin of ``lipvq_tpu/robocasa/bench_expert_success.py``: the same
rollouts, lines and table).

The reference collects demos by human teleop, so its corpus coverage is
unquantified; our scripted experts replace teleop and their per-family
success *rates* bound the corpus bias (VERDICT r2 weak #5). This tool
rolls every dataset-registry task over N seeds with full layout/style
diversity and writes a markdown table.

Usage:
    python -m lipvq_tpu_torch.robocasa.bench_expert_success \
        [--seeds 20] [--tasks TASK ...] [--out table.md]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def rollout(task, seed, max_steps=1700):
    from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy

    env = REGISTERED_KITCHEN_ENVS[task](seed=seed)
    try:
        env.reset()
        pol = make_scripted_policy(task, env)
        for _ in range(max_steps):
            _, _, _, info = env.step(pol.get_action())
            if info["is_success"]["task"]:
                return True
            if pol.finished:
                break
        return bool(env.is_success()["task"])
    except Exception:
        return False
    finally:
        env.close()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--tasks", nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from lipvq_tpu_torch.robocasa.dataset_registry import (
        MULTI_STAGE_TASK_DATASETS,
        SINGLE_STAGE_TASK_DATASETS,
    )

    tasks = args.tasks or (
        sorted(SINGLE_STAGE_TASK_DATASETS) + sorted(MULTI_STAGE_TASK_DATASETS)
    )
    rows = []
    for task in tasks:
        t0 = time.time()
        wins = sum(rollout(task, seed) for seed in range(args.seeds))
        rate = wins / args.seeds
        rows.append((task, wins, args.seeds, rate, time.time() - t0))
        print(
            json.dumps(
                {"task": task, "success": wins, "n": args.seeds,
                 "rate": round(rate, 2), "secs": round(time.time() - t0, 1)}
            ),
            flush=True,
        )
    lines = [
        "| Task | success / N | rate |",
        "|---|---|---|",
    ]
    for task, wins, n, rate, _ in rows:
        lines.append(f"| {task} | {wins}/{n} | {rate:.2f} |")
    mean = sum(r[3] for r in rows) / max(len(rows), 1)
    lines.append(f"| **mean** | | **{mean:.2f}** |")
    table = "\n".join(lines)
    print(table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
