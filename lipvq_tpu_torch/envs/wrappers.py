"""Environment wrappers (copy of ``lipvq_tpu/envs/wrappers.py``):
``EnvWrapper`` passthrough base (reference wrappers.py:12) and
``FrameStackWrapper`` (reference :97), which keeps a rolling window of the
last ``num_frames`` observations per key: the ICL policies consume
[T, ...] stacked observations at rollout time."""

from __future__ import annotations

from collections import deque

import numpy as np

from lipvq_tpu_torch.utils.profile_utils import span


class EnvWrapper:
    def __init__(self, env):
        self.env = env

    def __getattr__(self, name):
        return getattr(self.env, name)

    @property
    def unwrapped(self):
        e = self.env
        while isinstance(e, EnvWrapper):
            e = e.env
        return e


class FrameStackWrapper(EnvWrapper):
    """Stack the last num_frames observations: each obs key becomes
    [num_frames, ...], padded by repeating the first frame at episode start
    (reference wrappers.py:97-180)."""

    def __init__(self, env, num_frames: int):
        super().__init__(env)
        assert num_frames > 0
        self.num_frames = num_frames
        self._frames = deque(maxlen=num_frames)

    def _stacked(self):
        keys = self._frames[0].keys()
        with span("env.frame_stack"):
            return {
                k: np.stack([f[k] for f in self._frames], axis=0) for k in keys
            }

    def reset(self):
        obs = self.env.reset()
        self._frames.clear()
        for _ in range(self.num_frames):
            self._frames.append(obs)
        return self._stacked()

    def reset_to(self, state):
        obs = self.env.reset_to(state)
        self._frames.clear()
        for _ in range(self.num_frames):
            self._frames.append(obs)
        return self._stacked()

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self._frames.append(obs)
        return self._stacked(), r, done, info
