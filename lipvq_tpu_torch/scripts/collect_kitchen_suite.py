"""Collect an expert demo corpus for the kitchen benchmark suite (the
port's twin of ``lipvq_tpu/scripts/collect_kitchen_suite.py``).

The scripted experts generate the corpora the reference downloads: one
export per task (``data/export.py``), with episode language, exact-replay
states and the scene's XML, and by default the ``action_dict`` arrays. The
same arguments give the arrays of the JAX script's HDF5 file, bit for bit,
and the same ``<export>.coverage.json`` beside each export.

    python -m lipvq_tpu_torch.scripts.collect_kitchen_suite \\
        --output_dir datasets/kitchen --n_demos 20 \\
        --tasks OpenDrawer CloseDrawer TurnOnSinkFaucet

Defaults to every task with a scripted expert (``TASK_POLICIES``, the
multi-stage experts included).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _write_coverage(output_path: str, task: str, coverage: list):
    """Sidecar ``<corpus>.coverage.json``: per-attempt init records and a
    summary comparing successful with attempted initializations, the skew
    that retry-until-success collection brings."""
    summary = {"attempts": len(coverage),
               "successes": sum(r["success"] for r in coverage)}
    # per-language-variant (object / fixture category) success rates
    by_lang = {}
    for r in coverage:
        k = r.get("lang") or "?"
        s, n = by_lang.get(k, (0, 0))
        by_lang[k] = (s + int(r["success"]), n + 1)
    summary["per_lang"] = {
        k: {"rate": round(s / n, 3), "n": n}
        for k, (s, n) in sorted(by_lang.items())
    }
    xyz_ok = np.array([r["obj_xyz"] for r in coverage
                       if r["success"] and "obj_xyz" in r])
    xyz_all = np.array([r["obj_xyz"] for r in coverage if "obj_xyz" in r])
    if len(xyz_all) >= 2 and len(xyz_ok) >= 2:
        # std of successful starts over all attempted starts per axis:
        # 1.0 means no placement skew
        ratio = np.std(xyz_ok, axis=0) / np.maximum(np.std(xyz_all, axis=0), 1e-9)
        summary["placement_std_ratio_xyz"] = [round(float(v), 3) for v in ratio]
    with open(os.path.splitext(output_path)[0] + ".coverage.json", "w") as f:
        json.dump({"task": task, "summary": summary, "attempts": coverage}, f, indent=1)


def collect_task(task: str, output_path: str, n_demos: int, max_steps: int,
                 seed: int, with_action_dict: bool = True,
                 attempts_per_demo: int = 6, layout_ids=None,
                 style_ids=None, action_noise: float = 0.0,
                 dwell_prob: float = 0.0) -> dict:
    """Collect up to ``n_demos`` successful expert demos of ``task`` (at most
    ``n_demos * attempts_per_demo`` attempts) into an export at
    ``output_path`` -> {"task", "demos", "attempts", "path"}."""
    from lipvq_tpu_torch.envs.env_factory import create_env
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy
    from lipvq_tpu_torch.scripts.collect_demos import collect_demo, write_demos

    env = create_env(task, seed=seed, layout_ids=layout_ids, style_ids=style_ids)
    rng = np.random.default_rng(seed)
    trajs, attempts = [], 0
    coverage = []  # per-attempt initialization records
    while len(trajs) < n_demos and attempts < n_demos * attempts_per_demo:
        attempts += 1
        traj, success = collect_demo(
            env, None, max_steps, rng,
            policy_factory=lambda e: make_scripted_policy(task, e),
            action_noise=action_noise, dwell_prob=dwell_prob,
        )
        meta = env.get_ep_meta()
        first_obs = traj["obs"][0] if traj.get("obs") else {}
        rec = {"success": bool(success),
               "layout": meta.get("layout_id"),
               "style": meta.get("style_id"),
               "lang": meta.get("lang")}
        objst = first_obs.get("obj_state")
        if objst is not None and np.any(objst[:3]):
            rec["obj_xyz"] = [round(float(v), 4) for v in objst[:3]]
        # the initial object map from the first observation
        rec["objects"] = {
            k[:-4]: [round(float(v), 4) for v in np.asarray(val)[:3]]
            for k, val in first_obs.items()
            if k.endswith("_pos") and not k.startswith("robot")
        }
        coverage.append(rec)
        if not success:
            continue
        traj["ep_meta"] = meta
        trajs.append(traj)
    if trajs:
        write_demos(output_path, env, trajs)
        _write_coverage(output_path, task, coverage)
        if with_action_dict:
            from lipvq_tpu_torch.scripts.conversion.extract_action_dict import (
                extract_action_dict,
            )

            extract_action_dict(output_path)
    env.close()
    return {
        "task": task,
        "demos": len(trajs),
        "attempts": attempts,
        "path": output_path if trajs else None,
    }


def main(args=None):
    from lipvq_tpu_torch.robocasa.sim.scripted import TASK_POLICIES

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--tasks", type=str, nargs="*", default=None)
    parser.add_argument("--n_demos", type=int, default=20)
    parser.add_argument("--max_steps", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--layout_ids", type=int, default=None,
                        help="fix the layout (reference layout ids)")
    parser.add_argument("--style_ids", type=int, default=None)
    parser.add_argument("--action_noise", type=float, default=0.0,
                        help="DART-style exec noise (labels stay clean)")
    ns = parser.parse_args(args)

    tasks = ns.tasks or sorted(TASK_POLICIES)
    os.makedirs(ns.output_dir, exist_ok=True)
    manifest = []
    for task in tasks:
        path = os.path.join(ns.output_dir, task)
        stats = collect_task(task, path, ns.n_demos, ns.max_steps, ns.seed,
                             layout_ids=ns.layout_ids, style_ids=ns.style_ids,
                             action_noise=ns.action_noise)
        manifest.append(stats)
        print(f"{task}: {stats['demos']}/{ns.n_demos} demos ({stats['attempts']} attempts)")
    with open(os.path.join(ns.output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    total = sum(m["demos"] for m in manifest)
    print(f"suite: {total} demos across {len(manifest)} tasks -> {ns.output_dir}")
    return manifest


if __name__ == "__main__":
    main()
