"""Checkpoint evaluation config generator.

Counterpart of reference config_gen/eval_ckpt.py:5-80 (+ eval_icl_ckpt):
points the checkpoint's own stored config at the checkpoint with
num_epochs=0 and rollout.warmstart=-1 so train() runs only the rollout
branch (reference eval_ckpt.py:57-76 / SURVEY.md §3.2).

    python -m lipvq_tpu_torch.scripts.config_gen.eval_ckpt \
        --ckpt path/to/model.ckpt --name eval_run [--n_rollouts 50]

The port's twin of ``lipvq_tpu/scripts/config_gen/eval_ckpt.py``: it reads a
checkpoint of the port's (``utils/file_utils.load_checkpoint_dict``, a
``torch.save`` dict read with ``weights_only=True``).
"""

from __future__ import annotations

import argparse
import json
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--n_rollouts", type=int, default=50)
    parser.add_argument("--horizon", type=int, default=None)
    parser.add_argument("--output_dir", type=str, default="expdata")
    args = parser.parse_args()

    from lipvq_tpu_torch.utils.file_utils import load_checkpoint_dict

    ckpt = load_checkpoint_dict(args.ckpt)
    cfg = json.loads(ckpt["config"])
    cfg["experiment"]["name"] = args.name
    cfg["experiment"]["ckpt_path"] = os.path.abspath(args.ckpt)
    cfg["train"]["num_epochs"] = 0
    cfg["experiment"]["rollout"]["enabled"] = True
    cfg["experiment"]["rollout"]["warmstart"] = -1
    cfg["experiment"]["rollout"]["n"] = args.n_rollouts
    if args.horizon is not None:
        cfg["experiment"]["rollout"]["horizon"] = args.horizon

    out = os.path.join(args.output_dir, "configs", f"{args.name}_eval.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(cfg, f, indent=4)
    print(f"wrote {out}")
    print(f"run: python -m lipvq_tpu_torch.scripts.train --config {out} --eval_only")


if __name__ == "__main__":
    main()
