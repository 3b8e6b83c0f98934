"""Gymnasium adapter (counterpart of ``lipvq_tpu/envs/env_gym.py``;
reference envs/env_gym.py).

``gymnasium`` is imported when an env is built, never on import. A
non-dict observation comes out as ``{"flat": obs}``; ``reset`` takes no
seed, as the JAX adapter's does (seed the inner ``env.env`` to replay an
episode).
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_base import EnvBase, EnvType


class EnvGym(EnvBase):
    def __init__(self, env_name: str, **kwargs):
        import gymnasium

        self._name = env_name
        self.env = gymnasium.make(env_name, **kwargs)
        self._current_obs = None

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._current_obs = obs
        done = bool(terminated or truncated)
        info = dict(info)
        info.setdefault("is_success", {"task": bool(info.get("success", False))})
        return self.get_observation(obs), float(reward), done, info

    def reset(self):
        obs, _info = self.env.reset()
        self._current_obs = obs
        return self.get_observation(obs)

    def reset_to(self, state):
        raise NotImplementedError("gym envs do not support state restore")

    def render(self, mode="rgb_array", height=None, width=None, camera_name=None):
        return self.env.render()

    def get_observation(self, obs=None):
        if obs is None:
            obs = self._current_obs
        if isinstance(obs, dict):
            return {k: np.asarray(v) for k, v in obs.items()}
        return {"flat": np.asarray(obs)}

    def is_success(self):
        return {"task": False}

    @property
    def name(self):
        return self._name

    @property
    def action_dimension(self):
        return int(np.prod(self.env.action_space.shape))

    def serialize(self):
        return {"env_name": self._name, "type": EnvType.GYM_TYPE, "env_kwargs": {}}
