"""Closed-loop rollout engines (counterpart of ``lipvq_tpu/envs/rollout.py``).

- ``run_rollout`` (reference train_utils.py:279) / ``icl_run_rollout``
  (:487): one episode;
- ``rollout_with_stats`` (:698) / ``icl_rollout_with_stats`` (:904): N
  episodes per env with Return/Horizon/Success_Rate stats, video writing
  every ``video_skip`` steps, terminate-on-success;
- ``icl_batched_rollout_with_stats``: waves of lock-step vector envs.

The env steps on the host in numpy; each policy request runs one forward
on the policy's device; ``FrameStackWrapper`` keeps the [T, ...]
observation window the ICL policies consume.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict

import numpy as np

from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper


def icl_run_rollout(
    policy,
    env,
    context_batch,
    horizon: int,
    goal=None,
    render: bool = False,
    video_writer=None,
    video_skip: int = 5,
    terminate_on_success: bool = False,
):
    """One ICL episode (reference train_utils.py:487-695)."""
    ob_dict = env.reset()
    lang = getattr(env, "ep_lang_str", None) or getattr(
        env.unwrapped if hasattr(env, "unwrapped") else env, "_ep_lang_str", None
    )
    policy.start_episode(lang=lang)

    results = {}
    video_count = 0
    total_reward = 0.0
    success = {k: False for k in env.is_success()}
    step_i = 0
    for step_i in range(horizon):
        ac = policy(ob_dict, context_batch, goal=goal)
        ac = np.asarray(ac)[: env.action_dimension]
        if ac.shape[0] < env.action_dimension:
            ac = np.concatenate(
                [ac, np.zeros(env.action_dimension - ac.shape[0])]
            )
        ob_dict, r, done, info = env.step(ac)
        total_reward += r
        cur_success = info.get("is_success", env.is_success())
        for k in success:
            success[k] = success[k] or bool(cur_success.get(k, False))
        if video_writer is not None:
            if video_count % video_skip == 0:
                video_writer.append_data(
                    env.render(mode="rgb_array", height=512, width=512)
                )
            video_count += 1
        if render:
            env.render(mode="human")
        if done or (terminate_on_success and success["task"]):
            break
    results["Return"] = total_reward
    results["Horizon"] = step_i + 1
    results["Success_Rate"] = float(success["task"])
    for k in success:
        if k != "task":
            results[f"{k}_Success_Rate"] = float(success[k])
    return results


def run_rollout(policy, env, horizon, goal=None, render=False,
                video_writer=None, video_skip=5, terminate_on_success=False):
    """Non-ICL episode (reference train_utils.py:279-420)."""

    class _NoCtx:
        def __call__(self, ob, context_batch, goal=None):
            return policy(ob, goal=goal)

        def start_episode(self, lang=None):
            policy.start_episode(lang=lang)

    return icl_run_rollout(
        _NoCtx(), env, None, horizon, goal=goal, render=render,
        video_writer=video_writer, video_skip=video_skip,
        terminate_on_success=terminate_on_success,
    )


def icl_rollout_with_stats(
    policy,
    envs: dict,
    context_batch,
    horizon: int,
    num_episodes: int,
    render: bool = False,
    video_dir: str | None = None,
    epoch: int | None = None,
    video_skip: int = 5,
    terminate_on_success: bool = False,
    frame_stack: int | None = None,
):
    """N episodes over each env (reference train_utils.py:904-1110). Videos
    are written when ``video_dir`` is given and ``imageio`` is installed."""
    all_rollout_logs = OrderedDict()
    video_paths = OrderedDict()

    for env_name, env in envs.items():
        if frame_stack is not None and not isinstance(env, FrameStackWrapper):
            env = FrameStackWrapper(env, num_frames=frame_stack)
        video_writer = None
        if video_dir is not None:
            try:
                import imageio
            except ImportError:
                imageio = None
            if imageio is not None:
                video_path = os.path.join(video_dir, f"{env_name}_epoch_{epoch}.mp4")
                video_writer = imageio.get_writer(video_path, fps=20)
                video_paths[env_name] = video_path

        rollout_logs = []
        t_start = time.time()
        for _ in range(num_episodes):
            rollout_logs.append(
                icl_run_rollout(
                    policy, env, context_batch, horizon,
                    render=render, video_writer=video_writer,
                    video_skip=video_skip,
                    terminate_on_success=terminate_on_success,
                )
            )
        if video_writer is not None:
            video_writer.close()

        logs = {
            k: float(np.mean([r[k] for r in rollout_logs]))
            for k in rollout_logs[0]
        }
        logs["Time_Rollouts"] = (time.time() - t_start) / 60.0
        all_rollout_logs[env_name] = logs

    return all_rollout_logs, video_paths


def icl_batched_rollout_with_stats(
    policy,
    vec_envs: dict,
    context_batch,
    horizon: int,
    num_episodes: int,
    terminate_on_success: bool = False,
):
    """Batched counterpart of :func:`icl_rollout_with_stats`: each env name
    maps to a :class:`~lipvq_tpu_torch.envs.vector_env.VectorEnv`; waves of
    ``num_envs`` episodes run in lock-step (one policy request per step)
    until ``num_episodes`` episodes have been collected."""
    from lipvq_tpu_torch.envs.vector_env import batched_icl_rollout

    all_rollout_logs = OrderedDict()
    for env_name, vec in vec_envs.items():
        waves = max(1, -(-num_episodes // vec.num_envs))
        t_start = time.time()
        wave_logs = [
            batched_icl_rollout(
                policy, vec, context_batch, horizon,
                terminate_on_success=terminate_on_success,
            )
            for _ in range(waves)
        ]
        logs = {
            k: float(np.mean([w[k] for w in wave_logs]))
            for k in wave_logs[0]
        }
        logs["Num_Episodes"] = float(waves * vec.num_envs)
        logs["Time_Rollouts"] = (time.time() - t_start) / 60.0
        all_rollout_logs[env_name] = logs
    return all_rollout_logs, OrderedDict()


def rollout_with_stats(policy, envs, horizon, num_episodes, **kwargs):
    """Non-ICL variant (reference train_utils.py:698-903)."""

    class _Wrap:
        def __call__(self, ob, context_batch, goal=None):
            return policy(ob, goal=goal)

        def start_episode(self, lang=None):
            policy.start_episode(lang=lang)

    return icl_rollout_with_stats(
        _Wrap(), envs, None, horizon, num_episodes, **kwargs
    )
