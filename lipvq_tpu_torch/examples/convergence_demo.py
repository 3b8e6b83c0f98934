"""End-to-end convergence demo, the port's twin of the JAX package's
``examples/convergence_demo.py``, step for step: 40 successful scripted
demos of ``SyntheticKitchen`` (seed 0, at most 120 steps) written as an
export, the flagship (ICL transformer, 4 layers x 256 wide, 8 heads, GMM
head, LipVQ-VAE tokenizer with 256 codes, ``lang_emb`` among the obs) at
batch 32, ``seq_length`` = ``frame_stack`` = 10, constant-lr AdamW at 3e-4,
12 epochs of 50 steps, and closed-loop evaluation by
``icl_rollout_with_stats`` in ``SyntheticKitchenEnv(seed=99, horizon=120)``:
5 episodes at epoch 0, 10 at epochs 4, 8 and 12.

    python -m lipvq_tpu_torch.examples.convergence_demo [--device cpu] [--seed 0]

For each evaluation it prints the success rate, the mean horizon, the last
epoch's loss, the K1 launches since the start (one per train step and one
per policy request on the card, none on the CPU) and the number of distinct
codes among the evaluation context's action tokens. ``--seed`` seeds the
demo collection, as the JAX script's fixed 0 does; the rollout env keeps
its seed 99.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

EPISODE_STEPS = 120


def demo_config(path: str):
    """The JAX script's config (over the ``icl`` defaults) on the export at
    ``path``."""
    from lipvq_tpu_torch.config import config_factory

    return config_factory("icl", {
        "train": {"data": path, "batch_size": 32, "seq_length": 10, "frame_stack": 10,
                  "max_grad_norm": 100.0, "hdf5_cache_mode": "all"},
        "experiment": {"epoch_every_n_steps": 50, "validate": False,
                       "logging": {"terminal_output_to_txt": False, "log_tb": False},
                       "rollout": {"enabled": False}},
        "algo": {"gmm": {"enabled": True},
                 "optim_params": {"policy": {
                     "optimizer_type": "adamw",
                     "learning_rate": {"initial": 3e-4, "scheduler_type": "constant"}}},
                 "transformer": {"enabled": True, "supervise_all_steps": True,
                                 "pred_future_acs": True, "causal": False,
                                 "embed_dim": 256, "num_layers": 4, "num_heads": 8,
                                 "vq_vae_enabled": True, "ln_act_enabled": False},
                 "vq": {"num_codes": 256}},
        "observation": {"modalities": {"obs": {"low_dim": [
            "robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "object",
            "lang_emb"]}}},
    })


def collect(path: str, seed: int = 0, n_demos: int = 40) -> str:
    """``n_demos`` successful scripted demos of the synthetic env, seeded,
    as an export at ``path``."""
    from lipvq_tpu_torch.envs.env_factory import create_env
    from lipvq_tpu_torch.scripts.collect_demos import collect_demo, scripted_policy, write_demos

    env = create_env("SyntheticKitchen", seed=seed)
    rng = np.random.default_rng(seed)
    trajs = []
    while len(trajs) < n_demos:
        traj, succ = collect_demo(env, scripted_policy, EPISODE_STEPS, rng)
        if succ:
            trajs.append(traj)
    return write_demos(path, env, trajs)


def _k1_launches() -> int:
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda

    return vq_nearest_cuda.launches


def _distinct_ids(model, ctx) -> int:
    """Distinct codes among the context's action tokens, by the plain lookup
    on the CPU (it launches nothing)."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_reference

    tok = model.nets.net.encoder.action_network
    with torch.inference_mode():
        acts = torch.as_tensor(np.asarray(ctx["actions"]), dtype=torch.float32,
                               device=model.device)
        z = tok.encode(acts.reshape(-1, acts.shape[-1])).cpu()
        ids = vq_nearest_reference(z, tok.quantizer.codebook.detach().cpu())
    return int(torch.unique(ids).numel())


def run(device=None, seed: int = 0, workdir: str | None = None, epochs: int = 12,
        steps_per_epoch: int = 50, eval_every: int = 4, first_episodes: int = 5,
        episodes: int = 10, n_demos: int = 40, log=print) -> dict:
    """Collect, train and evaluate as the JAX script does -> {"curve": one
    entry per evaluation, "train_steps", "requests", "seconds", and the
    trained "model", its "loader", "dataset", last evaluation "context" and
    rollout "policy"}. The keyword arguments past ``workdir`` shorten the
    run (the script's values are the defaults)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
    from lipvq_tpu_torch.envs.rollout import icl_rollout_with_stats
    from lipvq_tpu_torch.utils import obs_utils as ObsUtils
    from lipvq_tpu_torch.utils import train_utils as TrainUtils
    from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="convergence_demo_") as tmp:
        path = collect(os.path.join(workdir or tmp, "demos"), seed=seed, n_demos=n_demos)
        log(f"collected {n_demos} successful demos")
        cfg = demo_config(path)
        ObsUtils.initialize_obs_utils_with_config(cfg)
        sm = get_shape_metadata_from_dataset(path, all_obs_keys=cfg.all_obs_keys)
        model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device=device)
        lang = LangEncoder(device=model.device)
        train_ds, _ = TrainUtils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"],
                                                        lang_encoder=lang)
        loader, _, ctx_loader = TrainUtils.make_loaders(cfg, train_ds, None)
        requests = 0
        last = {}

        def rollout_eval(n):
            nonlocal requests
            ctx = model.process_batch_for_training(next(iter(ctx_loader)))
            policy = ICLRolloutPolicy(
                model, action_normalization_stats=train_ds.get_action_normalization_stats(),
                lang_encoder=lang)
            last.update(context=ctx, policy=policy)
            envs = {"SyntheticKitchen": SyntheticKitchenEnv(seed=99, horizon=EPISODE_STEPS)}
            logs, _ = icl_rollout_with_stats(policy, envs, ctx, horizon=EPISODE_STEPS,
                                             num_episodes=n, terminate_on_success=True,
                                             frame_stack=10)
            stats = logs["SyntheticKitchen"]
            requests += int(round(stats["Horizon"] * n))  # one request per env step
            return stats, _distinct_ids(model, ctx)

        curve = []
        s, distinct = rollout_eval(first_episodes)
        curve.append({"epoch": 0, "success": s["Success_Rate"], "horizon": s["Horizon"],
                      "loss": None, "k1_launches": _k1_launches(), "distinct_ids": distinct})
        log(f"epoch 0: success {s['Success_Rate']:.1f} horizon {s['Horizon']:.0f} "
            f"K1 launches {curve[-1]['k1_launches']} distinct ids {distinct}")
        for epoch in range(1, epochs + 1):
            step_log = TrainUtils.run_epoch(model, loader, epoch, num_steps=steps_per_epoch)
            if epoch % eval_every == 0:
                s, distinct = rollout_eval(episodes)
                curve.append({"epoch": epoch, "success": s["Success_Rate"],
                              "horizon": s["Horizon"], "loss": step_log["Loss"],
                              "k1_launches": _k1_launches(), "distinct_ids": distinct})
                log(f"epoch {epoch}: loss {step_log['Loss']:.2f} success "
                    f"{s['Success_Rate']:.1f} horizon {s['Horizon']:.0f} "
                    f"({(time.time() - t0) / 60:.1f} min) K1 launches "
                    f"{curve[-1]['k1_launches']} distinct ids {distinct}")
    return {"curve": curve, "train_steps": epochs * steps_per_epoch, "requests": requests,
            "seconds": time.time() - t0, "model": model, "loader": loader,
            "dataset": train_ds, **last}


def main(args=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    parser.add_argument("--seed", type=int, default=0, help="seed of the demo collection")
    ns = parser.parse_args(args)
    out = run(device=ns.device, seed=ns.seed)
    print(f"{out['train_steps']} train steps, {out['requests']} policy requests in "
          f"{out['seconds']:.1f} s")
    return out


if __name__ == "__main__":
    main()
