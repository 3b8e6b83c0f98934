"""Batched environment rollout (counterpart of ``lipvq_tpu/envs/vector_env.py``).

``VectorEnv`` steps N envs in lock-step in this process, and
``batched_icl_rollout`` runs them to completion with one policy request per
step: the rollout policy's batched path takes obs [N, T, ...] to actions
[N, A], so N envs share one forward on the card (and one K1 launch).
``SubprocVectorEnv`` steps each env in a spawned process of its own (for
MuJoCo-class simulators), with the same interface; its env factories must
pickle (``functools.partial``, not a lambda).
"""

from __future__ import annotations

import multiprocessing as mp
from collections import OrderedDict

import numpy as np

from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper


class VectorEnv:
    """Lock-step batch of environments (in-process).

    ``obs_keys`` filters the stacked observation dict to the keys the
    policy consumes: env members of one task can sample different object
    counts, making task-object keys ragged across the batch (unstackable);
    proprio/camera keys are shape-stable."""

    def __init__(self, env_fns, frame_stack: int | None = None,
                 obs_keys=None):
        self.envs = [fn() for fn in env_fns]
        if frame_stack:
            self.envs = [FrameStackWrapper(e, frame_stack) for e in self.envs]
        self.num_envs = len(self.envs)
        self.obs_keys = set(obs_keys) if obs_keys is not None else None

    def reset(self):
        obs = [e.reset() for e in self.envs]
        return self._stack(obs, self.obs_keys)

    def step(self, actions: np.ndarray):
        results = [e.step(actions[i]) for i, e in enumerate(self.envs)]
        obs, rews, dones, infos = zip(*results)
        return (self._stack(obs, self.obs_keys), np.asarray(rews),
                np.asarray(dones), infos)

    def is_success(self):
        return [e.is_success() for e in self.envs]

    @property
    def action_dimension(self):
        return self.envs[0].action_dimension

    @property
    def ep_lang_str(self):
        return getattr(self.envs[0], "ep_lang_str", None)

    @property
    def ep_lang_strs(self):
        """Per-env episode language (valid after reset)."""
        out = []
        for e in self.envs:
            lang = getattr(e, "ep_lang_str", None)
            if lang is None and hasattr(e, "unwrapped"):
                lang = getattr(e.unwrapped, "_ep_lang_str", None)
            out.append(lang)
        return out

    @staticmethod
    def _stack(obs_list, obs_keys=None):
        keys = [
            k for k in obs_list[0]
            if obs_keys is None or k in obs_keys
        ]
        return {k: np.stack([o[k] for o in obs_list]) for k in keys}


def _subproc_worker(pipe, env_fn, frame_stack):
    env = env_fn()
    if frame_stack:
        env = FrameStackWrapper(env, frame_stack)
    while True:
        cmd, data = pipe.recv()
        if cmd == "reset":
            pipe.send(env.reset())
        elif cmd == "step":
            pipe.send(env.step(data))
        elif cmd == "is_success":
            pipe.send(env.is_success())
        elif cmd == "ep_lang_str":
            lang = getattr(env, "ep_lang_str", None)
            if lang is None and hasattr(env, "unwrapped"):
                lang = getattr(env.unwrapped, "_ep_lang_str", None)
            pipe.send(lang)
        elif cmd == "close":
            pipe.close()
            break


class SubprocVectorEnv:
    """One spawned subprocess per env (reference train.py:141-144 uses
    tianshou's equivalent for MuJoCo envs)."""

    def __init__(self, env_fns, frame_stack: int | None = None, obs_keys=None):
        self.obs_keys = set(obs_keys) if obs_keys is not None else None
        ctx = mp.get_context("spawn")
        self.pipes, self.procs = [], []
        for fn in env_fns:
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_subproc_worker, args=(child, fn, frame_stack))
            p.daemon = True
            p.start()
            self.pipes.append(parent)
            self.procs.append(p)
        self.num_envs = len(env_fns)

    def _ask(self, cmd: str, data=None) -> list:
        for p in self.pipes:
            p.send((cmd, data))
        return [p.recv() for p in self.pipes]

    def reset(self):
        return VectorEnv._stack(self._ask("reset"), self.obs_keys)

    def step(self, actions):
        for i, p in enumerate(self.pipes):
            p.send(("step", actions[i]))
        obs, rews, dones, infos = zip(*[p.recv() for p in self.pipes])
        return (VectorEnv._stack(obs, self.obs_keys), np.asarray(rews),
                np.asarray(dones), infos)

    def is_success(self):
        return self._ask("is_success")

    @property
    def ep_lang_strs(self):
        return self._ask("ep_lang_str")

    def close(self):
        for p in self.pipes:
            p.send(("close", None))
        for proc in self.procs:
            proc.join(timeout=5)


def batched_icl_rollout(
    policy,
    vec_env,
    context_batch,
    horizon: int,
    terminate_on_success: bool = True,
):
    """Run all envs to completion with one policy request per step.
    Returns the per-env means of {Return, Horizon, Success_Rate}."""
    obs = vec_env.reset()
    langs = getattr(vec_env, "ep_lang_strs", None)
    if langs is not None and any(langs):
        policy.start_episode(lang=[l or "" for l in langs])
    else:
        policy.start_episode(lang=getattr(vec_env, "ep_lang_str", None))
    n = vec_env.num_envs
    returns = np.zeros(n)
    horizons = np.zeros(n, int)
    success = np.zeros(n, bool)
    active = np.ones(n, bool)
    for _t in range(horizon):
        acts = policy.batched(obs, context_batch)
        obs, rews, dones, infos = vec_env.step(acts)
        returns += rews * active
        horizons += active
        for i, info in enumerate(infos):
            s = info.get("is_success", {}).get("task", False)
            success[i] = success[i] or bool(s)
        if terminate_on_success:
            active &= ~success
        active &= ~np.asarray(dones, bool)
        if not active.any():
            break
    return OrderedDict(
        Return=float(returns.mean()),
        Horizon=float(horizons.mean()),
        Success_Rate=float(success.mean()),
    )
