"""Per-phase failure diagnosis for scripted experts (the port's twin of
``lipvq_tpu/robocasa/diagnose_expert.py``: the same transitions and
sub-predicates).

`bench_expert_success` gives rates; this tool explains the losses. For
each failing seed it records every phase transition (done-fired vs
budget-exhausted vs retry-jump), the phase active at episode end, and
the task success sub-predicates — the data the expert-improvement loop
runs on (the reference's teleop pipeline has no analogue: a human IS
the recovery policy).

Usage:
    python -m lipvq_tpu_torch.robocasa.diagnose_expert --task RestockPantry \
        [--seeds 20] [--max_steps 1700]
"""

from __future__ import annotations

import argparse
import json
import sys


def traced_rollout(task, seed, max_steps=1700):
    import numpy as np

    from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy

    env = REGISTERED_KITCHEN_ENVS[task](seed=seed)
    events = []
    try:
        env.reset()
        pol = make_scripted_policy(task, env)
        last_idx, last_t = 0, 0
        for step in range(max_steps):
            a = pol.get_action()
            if pol._phases is not None and pol._idx != last_idx:
                # phase advanced: was the outgoing phase done, or did
                # its budget expire? (budget expiry resets _t to 0 at
                # the new phase too, so look at the step count spent)
                name = (pol._phases[last_idx].name
                        if last_idx < len(pol._phases) else "?")
                budget = (pol._phases[last_idx].budget
                          if last_idx < len(pol._phases) else 0)
                events.append({
                    "step": step, "phase": name, "spent": last_t,
                    "exhausted": last_t >= budget,
                    "jumped_back": pol._idx < last_idx,
                })
                last_idx = pol._idx
            last_t = pol._t
            _, _, _, info = env.step(a)
            if info["is_success"]["task"]:
                return True, events, _final_state(env), step
            if pol.finished:
                break
        # let physics settle (the bench's implicit tail)
        active = (pol._phases[pol._idx].name
                  if pol._phases and pol._idx < len(pol._phases)
                  else "FINISHED")
        events.append({"step": max_steps, "phase": active,
                       "spent": pol._t, "exhausted": False,
                       "active_at_end": True})
        return bool(env.is_success()["task"]), events, _final_state(env), step
    except Exception as exc:  # noqa: BLE001 — diagnosis must not die
        events.append({"exception": repr(exc)})
        return False, events, {}, -1
    finally:
        env.close()


def _final_state(env):
    """Task-relevant scalars at episode end (best-effort)."""
    import numpy as np

    out = {}
    try:
        for name in list(getattr(env, "objects", {})):
            out[f"pos:{name}"] = [round(float(x), 3)
                                  for x in env.object_pos(name)]
    except Exception:
        pass
    for attr in ("microwave", "coffee_machine", "sink", "stove", "cab"):
        fx = getattr(env, attr, None)
        if fx is None:
            continue
        try:
            st = fx.get_state() if hasattr(fx, "get_state") else {}
            out[f"state:{attr}"] = {
                k: (round(float(v), 3) if hasattr(v, "__float__") else v)
                for k, v in st.items()}
        except Exception:
            pass
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True)
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--max_steps", type=int, default=1700)
    ap.add_argument("--verbose", action="store_true",
                    help="print full event traces for failures")
    args = ap.parse_args(argv)

    wins, fails = 0, []
    for seed in range(args.seeds):
        ok, events, final, steps = traced_rollout(
            args.task, seed, args.max_steps)
        if ok:
            wins += 1
            print(json.dumps({"seed": seed, "ok": True, "steps": steps}),
                  flush=True)
            continue
        exhausted = [e["phase"] for e in events if e.get("exhausted")]
        end = next((e for e in events if e.get("active_at_end")), {})
        exc = next((e["exception"] for e in events if "exception" in e), None)
        fails.append({"seed": seed, "exhausted": exhausted,
                      "end_phase": end.get("phase"), "exception": exc,
                      "final": final})
        print(json.dumps(fails[-1]), flush=True)
        if args.verbose:
            for e in events:
                print("   ", json.dumps(e), flush=True)
    print(f"\n{args.task}: {wins}/{args.seeds} ok")
    # failure-mode histogram: first exhausted phase per losing seed
    from collections import Counter

    hist = Counter(
        (f["exhausted"][0] if f["exhausted"] else f["end_phase"] or "?")
        for f in fails)
    for phase, n in hist.most_common():
        print(f"  {n:2d}x first-stall: {phase}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
