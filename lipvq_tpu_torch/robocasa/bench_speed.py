"""Environment speed benchmark (the port's twin of
``lipvq_tpu/robocasa/bench_speed.py``, with the same keys in the same order).

Counterpart of reference robocasa/scripts/bench_speed.py:20-60,172:
reports env reset time and step fps (single env and, when multiple envs
are requested, a round-robin batch — the reference uses tianshou
SubprocVectorEnv; here a simple in-process pool suffices for the
fps measurement and keeps the benchmark hermetic).

    python -m lipvq_tpu_torch.robocasa.bench_speed --env SyntheticKitchen \
        --n_steps 1000
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from lipvq_tpu_torch.robocasa.env_utils import create_env


def bench_env(env_name: str, n_steps: int = 1000, n_resets: int = 10,
              n_envs: int = 1) -> dict:
    envs = [create_env(env_name, seed=i) for i in range(n_envs)]
    t0 = time.time()
    for env in envs:
        for _ in range(max(1, n_resets // n_envs)):
            env.reset()
    reset_time = (time.time() - t0) / max(1, n_resets)

    rng = np.random.default_rng(0)
    for env in envs:
        env.reset()
    t0 = time.time()
    for i in range(n_steps):
        env = envs[i % n_envs]
        env.step(rng.uniform(-1, 1, env.action_dimension))
    fps = n_steps / (time.time() - t0)
    return {
        "env": env_name,
        "n_envs": n_envs,
        "reset_time_s": round(reset_time, 4),
        "steps_per_sec": round(fps, 1),
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str, default="SyntheticKitchen")
    parser.add_argument("--n_steps", type=int, default=1000)
    parser.add_argument("--n_resets", type=int, default=10)
    parser.add_argument("--n_envs", type=int, default=1)
    args = parser.parse_args()
    print(json.dumps(bench_env(
        args.env, args.n_steps, args.n_resets, args.n_envs
    )))


if __name__ == "__main__":
    main()
