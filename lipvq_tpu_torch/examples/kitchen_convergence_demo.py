"""Closed-loop convergence on the first-party MuJoCo kitchen, the port's
twin of the JAX package's ``examples/kitchen_convergence_demo.py``, step for
step: the scripted expert collects OpenDrawer demonstrations (24 successful
ones at most 300 steps long, collection seed 11) as an export, the flagship
(ICL transformer, 3 layers x 128 wide, 4 heads, GMM head, LipVQ-VAE with
512 codes, the mobile base's proprio and ``lang_emb`` among the obs) trains
on them through ``scripts/train.py`` at batch 64, constant lr 1e-3, 12
epochs of 200 steps, with closed-loop rollouts in the kitchen (3 episodes
of 250 steps every 2 epochs).

    python -m lipvq_tpu_torch.examples.kitchen_convergence_demo [--device cpu]
        [--seed 11] [--n_demos 24] [--epochs 12] [--layout L] [--out DIR]

It needs ``mujoco``: without it the collection raises
``ModuleNotFoundError``. ``--seed`` seeds the collection, as the JAX
script's fixed 11 does. The curve (one success rate per rollout epoch) is
read back from the run's ``logs/scalars.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time


def demo_config(data: str, out: str, epochs: int = 12, steps_per_epoch: int = 200,
                rollout_episodes: int = 3, horizon: int = 250):
    """The JAX script's config (over ``icl_test_config_overrides``) on the
    export at ``data``, writing under ``out``."""
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides

    d = icl_test_config_overrides()
    d["train"].update({"data": data, "num_epochs": epochs, "batch_size": 64,
                       "output_dir": out})
    d["experiment"].update({
        "epoch_every_n_steps": steps_per_epoch,
        "rollout": {"enabled": True, "n": rollout_episodes, "horizon": horizon,
                    "rate": max(epochs // 6, 1)},
        "save": {"enabled": True, "every_n_epochs": epochs},
        "validate": False,
    })
    d["algo"]["transformer"].update({"embed_dim": 128, "num_layers": 3, "num_heads": 4})
    d["algo"]["optim_params"] = {"policy": {"learning_rate": {
        "initial": 1e-3, "scheduler_type": "none"}}}
    # the smoke-test config's 32 codes are too coarse for manipulation
    d["algo"]["vq"] = {"num_codes": 512}
    # the mobile base's proprio: the pull phase's arm / base switch keys on
    # the base-to-eef retraction
    d["observation"]["modalities"]["obs"]["low_dim"] = [
        "robot0_base_pos", "robot0_base_quat", "robot0_eef_pos",
        "robot0_eef_quat", "robot0_gripper_qpos",
        "robot0_base_to_eef_pos", "object", "lang_emb",
    ]
    return config_factory("icl", d)


def run(device=None, seed: int = 11, out: str | None = None, n_demos: int = 24,
        epochs: int = 12, task: str = "OpenDrawer", layout: int | None = None,
        steps_per_epoch: int = 200, rollout_episodes: int = 3, horizon: int = 250,
        log=print) -> dict:
    """Collect, train and evaluate as the JAX script does -> {"collect": the
    collection's stats, "curve": [{"epoch", "success", "horizon"}] per
    rollout epoch, "ckpt_dir", "seconds"}. ``steps_per_epoch``,
    ``rollout_episodes`` and ``horizon`` shorten the run (the script's
    values are the defaults)."""
    from lipvq_tpu_torch.scripts.collect_kitchen_suite import collect_task
    from lipvq_tpu_torch.scripts.train import train

    t0 = time.time()
    out = out or tempfile.mkdtemp(prefix="kitchen_conv_")
    data = f"{out}_demos"
    stats = collect_task(task, data, n_demos=n_demos, max_steps=300, seed=seed,
                         layout_ids=layout, style_ids=0 if layout is not None else None)
    log(f"collected {stats['demos']} demos in {time.time() - t0:.0f}s "
        f"({stats['attempts']} attempts)")
    t1 = time.time()
    ckpt_dir = train(demo_config(data, out, epochs, steps_per_epoch, rollout_episodes, horizon),
                     device=device)
    log(f"train + rollouts in {time.time() - t1:.0f}s")
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        scalars = json.load(f)
    rate = max(epochs // 6, 1)
    success = scalars.get(f"Rollout/Success_Rate/{task}", [])
    horizon = scalars.get(f"Rollout/Horizon/{task}", [])
    curve = [{"epoch": rate * (i + 1), "success": s, "horizon": h}
             for i, (s, h) in enumerate(zip(success, horizon))]
    return {"collect": stats, "curve": curve, "ckpt_dir": ckpt_dir,
            "seconds": time.time() - t0}


def main(args=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    parser.add_argument("--seed", type=int, default=11, help="seed of the demo collection")
    parser.add_argument("--n_demos", type=int, default=24)
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--task", type=str, default="OpenDrawer")
    parser.add_argument("--layout", type=int, default=None,
                        help="fix the kitchen layout (an easier, faster-converging demo)")
    ns = parser.parse_args(args)
    res = run(device=ns.device, seed=ns.seed, out=ns.out, n_demos=ns.n_demos,
              epochs=ns.epochs, task=ns.task, layout=ns.layout)
    for c in res["curve"]:
        print(f"epoch {c['epoch']}: success {c['success']:.2f} horizon {c['horizon']:.0f}")
    return res


if __name__ == "__main__":
    main()
