"""PnP failure-mode probe: classify WHERE grasp-manipulation episodes die
(the port's twin of the JAX package's ``examples/pnp_probe.py``, with its
thresholds, classes, lines and JSON).

Roll a checkpoint on one PnP task and classify each episode from the
obj_state/eef kinematics into the stage where it failed:

  never_approached   eef never came within APPROACH_M of the object
  reach_no_grasp     approached but the object never lifted
  grasp_drop         lifted >LIFT_M but ended unsuccessful near origin
  moved_not_placed   lifted and carried >CARRY_M, still unsuccessful
  success            env success predicate fired

so the next ladder rung targets the binding stage (grasp precision vs
phase progression vs placement), instead of guessing.

    python -m lipvq_tpu_torch.examples.pnp_probe --ckpt .../model_epoch_90.ckpt \\
        --task PnPCabToCounter --corpus <corpus_dir>/PnPCabToCounter [--device cpu]

``--corpus`` is the task's export; the policy runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

APPROACH_M = 0.10   # eef-to-obj: "reached the object"
LIFT_M = 0.03       # height gain over episode-initial z: "grasped"
CARRY_M = 0.15      # xy displacement from start: "carried somewhere"


def classify(rec):
    if rec["success"]:
        return "success"
    if rec["min_obj_eef_dist"] > APPROACH_M:
        return "never_approached"
    if rec["max_lift"] < LIFT_M:
        return "reach_no_grasp"
    if rec["final_xy_disp"] > CARRY_M:
        return "moved_not_placed"
    return "grasp_drop"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--task", default="PnPCabToCounter")
    ap.add_argument("--corpus", required=True,
                    help="export corpus supplying the same-task context demo")
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="the policy's device (default cuda)")
    args = ap.parse_args(argv)

    from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata
    from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper
    from lipvq_tpu_torch.examples.kitchen_multitask_suite import task_horizon, task_policy
    from lipvq_tpu_torch.utils import file_utils as FileUtils
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    device = "cpu" if args.device == "cpu" else None
    model, ckpt = FileUtils.policy_from_checkpoint(args.ckpt, device=device)
    lang_encoder = LangEncoder(device=device)

    # context demo from the task corpus, with the TRAINING mixture's
    # normalization stats (the suite's evaluate() contract)
    ns = argparse.Namespace(
        train_seed=1, out="/tmp/pnp_probe_cfg", epochs=1, steps_per_epoch=1,
        batch_size=8, save_every=0, embed_dim=256, num_layers=4,
        tokenizer="vq", balance_tasks=False, pair_task_batches=False)
    policy, context_batch, cfg = task_policy(ns, model, ckpt, args.task, args.corpus,
                                             lang_encoder)

    env_meta = FileUtils.get_env_metadata_from_dataset(args.corpus)
    horizon = args.horizon or task_horizon(args.task)
    records = []
    for ep in range(args.episodes):
        meta = json.loads(json.dumps(env_meta))
        meta.setdefault("env_kwargs", {})["seed"] = 1000 + ep
        env = create_env_from_metadata(meta)
        fs = FrameStackWrapper(env, num_frames=cfg.train.frame_stack)
        ob = fs.reset()
        lang = getattr(env, "ep_lang_str", None)
        policy.start_episode(lang=lang)
        obj0 = np.array(ob["obj_state"][-1][:3])
        eef_last = np.array(ob["robot0_eef_pos"][-1])
        rec = {"episode": ep, "min_obj_eef_dist": float("inf"),
               "max_lift": 0.0, "final_xy_disp": 0.0, "success": False,
               "steps": 0, "t_approach": None, "t_lift": None}
        t0 = time.time()
        for t in range(horizon):
            ac = policy(ob, context_batch)
            ac = np.asarray(ac)[: env.action_dimension]
            ob, r, done, info = fs.step(ac)
            obj = np.array(ob["obj_state"][-1][:3])
            eef_last = np.array(ob["robot0_eef_pos"][-1])
            d = float(np.linalg.norm(obj - eef_last))
            if d < rec["min_obj_eef_dist"]:
                rec["min_obj_eef_dist"] = d
            if d < APPROACH_M and rec["t_approach"] is None:
                rec["t_approach"] = t
            lift = float(obj[2] - obj0[2])
            if lift > rec["max_lift"]:
                rec["max_lift"] = lift
            if lift > LIFT_M and rec["t_lift"] is None:
                rec["t_lift"] = t
            rec["final_xy_disp"] = float(np.linalg.norm(obj[:2] - obj0[:2]))
            rec["steps"] = t + 1
            if info.get("is_success", {}).get("task", False):
                rec["success"] = True
                break
            if done:
                break
        rec["min_obj_eef_dist"] = round(rec["min_obj_eef_dist"], 4)
        rec["max_lift"] = round(rec["max_lift"], 4)
        rec["final_xy_disp"] = round(rec["final_xy_disp"], 4)
        rec["class"] = classify(rec)
        rec["wall_s"] = round(time.time() - t0, 1)
        records.append(rec)
        print(f"[probe] ep{ep}: {rec['class']} (min_dist "
              f"{rec['min_obj_eef_dist']:.3f}, lift {rec['max_lift']:.3f}, "
              f"disp {rec['final_xy_disp']:.3f}, {rec['steps']} steps)",
              flush=True)
        env.close()

    hist = {}
    for r in records:
        hist[r["class"]] = hist.get(r["class"], 0) + 1
    summary = {"task": args.task, "ckpt": os.path.basename(args.ckpt),
               "episodes": args.episodes, "classes": hist,
               "success_rate": hist.get("success", 0) / args.episodes}
    print(json.dumps(summary))
    out = args.out or f"/tmp/pnp_diag_{args.task}.json"
    with open(out, "w") as f:
        json.dump({"summary": summary, "episodes": records}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
