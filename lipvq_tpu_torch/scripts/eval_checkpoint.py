"""Evaluate a trained checkpoint with closed-loop rollouts (counterpart of
``lipvq_tpu/scripts/eval_checkpoint.py``): load a checkpoint onto the card,
rebuild the env from its recorded env_metadata, rebuild the ICL context
from the training data (a dataset export), and run N episodes.

    python -m lipvq_tpu_torch.scripts.eval_checkpoint path/to/model.ckpt \\
        --n 10 --horizon 300 [--env OtherTask] [--data other_export_dir] \\
        [--device cpu]

Prints one line per episode (success, horizon, episode language) and a
final JSON summary.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _j(x):
    return json.loads(x) if isinstance(x, str) else x


def evaluate_checkpoint(ckpt_path: str, n: int = 10, horizon: int = 300,
                        env_name: str | None = None,
                        data: str | None = None,
                        terminate_on_success: bool = True,
                        verbose: bool = True, device=None) -> dict:
    """Run closed-loop rollouts for a saved checkpoint on ``device`` (CUDA
    when None; raises without a GPU); returns stats."""
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata
    from lipvq_tpu_torch.envs.rollout import icl_run_rollout
    from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper
    from lipvq_tpu_torch.utils import train_utils as TrainUtils
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    model, ckpt_dict = policy_from_checkpoint(ckpt_path, device=device)
    cfg_d = _j(ckpt_dict["config"])
    shape_meta = _j(ckpt_dict["shape_metadata"])
    env_meta = _j(ckpt_dict["env_metadata"])
    cfg = config_factory(cfg_d["algo_name"], cfg_d)
    if data is not None:
        cfg.train.data = data
    if env_name is not None:
        env_meta["env_name"] = env_name

    lang_encoder = LangEncoder(device=model.device)
    train_ds, valid_ds = TrainUtils.load_data_for_training(
        cfg, obs_keys=shape_meta["all_obs_keys"], lang_encoder=lang_encoder
    )
    _, _, context_loader = TrainUtils.make_loaders(cfg, train_ds, valid_ds)
    context_batch = model.process_batch_for_training(
        next(iter(context_loader))
    )
    policy = ICLRolloutPolicy(
        model,
        obs_normalization_stats=(
            train_ds.get_obs_normalization_stats()
            if cfg.train.hdf5_normalize_obs else None
        ),
        action_normalization_stats=train_ds.get_action_normalization_stats(),
        lang_encoder=lang_encoder,
    )
    env = create_env_from_metadata(env_meta)
    env = FrameStackWrapper(env, num_frames=int(cfg.train.frame_stack))

    episodes = []
    for ep in range(n):
        r = icl_run_rollout(policy, env, context_batch, horizon,
                            terminate_on_success=terminate_on_success)
        lang = getattr(env.unwrapped, "_ep_lang_str", "")
        episodes.append({**r, "lang": lang})
        if verbose:
            print(f"ep{ep} success={r['Success_Rate']:.0f} "
                  f"H={r['Horizon']} lang={lang!r}", flush=True)
    env.close()
    stats = {
        "Success_Rate": float(np.mean([e["Success_Rate"] for e in episodes])),
        "Horizon": float(np.mean([e["Horizon"] for e in episodes])),
        "Return": float(np.mean([e["Return"] for e in episodes])),
        "episodes": len(episodes),
    }
    if verbose:
        print(json.dumps(stats, sort_keys=True))
    return stats


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt", type=str)
    parser.add_argument("--n", type=int, default=10)
    parser.add_argument("--horizon", type=int, default=300)
    parser.add_argument("--env", type=str, default=None,
                        help="override eval env (zero-shot eval)")
    parser.add_argument("--data", type=str, default=None,
                        help="override the context dataset export")
    parser.add_argument("--no_terminate_on_success", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA)")
    ns = parser.parse_args(args)
    return evaluate_checkpoint(
        ns.ckpt, n=ns.n, horizon=ns.horizon, env_name=ns.env,
        data=ns.data,
        terminate_on_success=not ns.no_terminate_on_success,
        device=ns.device,
    )


if __name__ == "__main__":
    main()
