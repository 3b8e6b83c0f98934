"""Zero-shot checkpoint evaluation generator.

Counterpart of reference config_gen/eval_zr_ckpt.py: like eval_ckpt but
points the rollout at a *different* task than the checkpoint was trained
on (zero-shot transfer eval) by overriding the eval env and horizon from
the dataset registry.

    python -m lipvq_tpu_torch.scripts.config_gen.eval_zr_ckpt --ckpt m.ckpt \
        --name zr_eval --task OpenDrawer

The port's twin of ``lipvq_tpu/scripts/config_gen/eval_zr_ckpt.py``: it reads a
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
    parser.add_argument("--task", type=str, required=True,
                        help="zero-shot target task (dataset registry name)")
    parser.add_argument("--n_rollouts", type=int, default=50)
    parser.add_argument("--output_dir", type=str, default="expdata")
    args = parser.parse_args()

    from lipvq_tpu_torch.robocasa.dataset_registry import get_task_horizon
    from lipvq_tpu_torch.utils.file_utils import load_checkpoint_dict

    ckpt = load_checkpoint_dict(args.ckpt)
    cfg = json.loads(ckpt["config"])
    cfg["experiment"]["name"] = args.name
    cfg["experiment"]["ckpt_path"] = os.path.abspath(args.ckpt)
    cfg["train"]["num_epochs"] = 0
    cfg["experiment"]["env"] = args.task  # override eval env
    cfg["experiment"]["rollout"].update(
        enabled=True, warmstart=-1, n=args.n_rollouts,
        horizon=get_task_horizon(args.task),
    )

    out = os.path.join(args.output_dir, "configs", f"{args.name}_zr.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(cfg, f, indent=4)
    print(f"wrote {out}")
    print(f"run: python -m lipvq_tpu_torch.scripts.train --config {out} --eval_only")


if __name__ == "__main__":
    main()
