"""RoboCasa environment helpers (counterpart of
``lipvq_tpu/robocasa/env_utils.py``; reference
robocasa/utils/env_utils.py:16-50).

``create_env`` builds a kitchen task (or ``SyntheticKitchen``) with its
layout, style and seed; its one implementation is
``lipvq_tpu_torch/envs/env_factory.py::create_env``, re-exported here.
``run_random_rollouts`` runs random-action episodes with the same numpy
draws as the JAX package's and returns their success stats.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_factory import create_env  # noqa: F401


def run_random_rollouts(env, num_rollouts: int, num_steps: int,
                        video_path: str | None = None, seed: int = 0):
    """Random-action episodes; returns success/horizon stats
    (reference env_utils.py run_random_rollouts)."""
    rng = np.random.default_rng(seed)
    writer = None
    if video_path is not None:
        import imageio

        writer = imageio.get_writer(video_path, fps=20)
    successes, horizons = [], []
    for _ in range(num_rollouts):
        env.reset()
        success = False
        t = 0
        for t in range(num_steps):
            a = rng.uniform(-1, 1, env.action_dimension)
            _, _, done, info = env.step(a)
            success = success or bool(
                info.get("is_success", {}).get("task", False)
            )
            if writer is not None:
                writer.append_data(
                    env.render(mode="rgb_array", height=256, width=256)
                )
            if done:
                break
        successes.append(float(success))
        horizons.append(t + 1)
    if writer is not None:
        writer.close()
    return {
        "num_success_rollouts": int(np.sum(successes)),
        "average_horizon": float(np.mean(horizons)),
    }
