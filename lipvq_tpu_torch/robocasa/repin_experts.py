"""Re-pin the RELIABLE scripted-expert seed matrix (the port's twin of
``lipvq_tpu/robocasa/repin_experts.py``).

The pinned (task, seed) pairs of the port's expert tests
(``tests/test_torch_port_kitchen_experts.py::RELIABLE``, the single-stage
tasks, and ``tests/test_torch_port_kitchen_multi_experts.py::RELIABLE``, the
multi-stage ones) are deterministic, but placement/physics changes shift
the episode RNG stream, so any sim-layer change invalidates some pins. This
tool keeps still-passing pins and scans forward for replacements:

    python -m lipvq_tpu_torch.robocasa.repin_experts [--scan 15]

Prints a ready-to-paste RELIABLE dict. The pins are read from the test
files' source (``ast``), not imported: those modules import the JAX
package, which the port never loads.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import time

TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests")
PIN_FILES = ("test_torch_port_kitchen_experts.py", "test_torch_port_kitchen_multi_experts.py")


def read_pins(path: str) -> dict:
    """The literal ``RELIABLE = {...}`` assignment of the module at ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "RELIABLE" for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"no RELIABLE assignment in {path}")


def rollout_expert(task, seed, max_steps=1700):
    """Whether the scripted expert solves ``task`` at ``seed`` (the JAX
    package's ``tests/test_scripted_experts.py::rollout_expert``)."""
    from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy

    env = REGISTERED_KITCHEN_ENVS[task](seed=seed)
    env.reset()
    pol = make_scripted_policy(task, env)
    for _ in range(max_steps):
        obs, reward, done, info = env.step(pol.get_action())
        if info["is_success"]["task"]:
            env.close()
            return True
        if pol.finished:
            break
    ok = env.is_success()["task"]
    env.close()
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scan", type=int, default=15,
                    help="max seed to scan for replacements")
    ap.add_argument("--tasks", nargs="*", default=None)
    args = ap.parse_args(argv)

    RELIABLE = {}
    for name in PIN_FILES:
        RELIABLE.update(read_pins(os.path.join(TESTS, name)))

    new = {}
    for task, seeds in sorted(RELIABLE.items()):
        if args.tasks and task not in args.tasks:
            new[task] = tuple(seeds)
            continue
        want = len(seeds)
        good, tried = [], set()
        t0 = time.time()
        for s in seeds:
            tried.add(s)
            if rollout_expert(task, s):
                good.append(s)
        scan = 0
        while len(good) < want and scan < args.scan:
            if scan not in tried:
                tried.add(scan)
                if rollout_expert(task, scan):
                    good.append(scan)
            scan += 1
        status = "ok" if len(good) >= want else "SHORT"
        print(f"[{status}] {task}: {sorted(good)} "
              f"(kept {[s for s in seeds if s in good]}, "
              f"{time.time()-t0:.0f}s)", flush=True)
        new[task] = tuple(sorted(good))
    print(json.dumps({k: list(v) for k, v in new.items()}, indent=0))
    print("\nRELIABLE = {")
    for k, v in new.items():
        print(f'    "{k}": {tuple(v) if len(v) != 1 else f"({v[0]},)"},')
    print("}")


if __name__ == "__main__":
    main()
