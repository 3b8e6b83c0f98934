"""Synthetic test environment (copy of ``lipvq_tpu/envs/env_synthetic.py``),
a hermetic stand-in for the kitchen tasks in pure numpy: the policy must
drive a 3-D effector to a goal; success when within a threshold. Obs keys
mirror the robocasa low-dim set so ICL configs run unchanged."""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_base import EnvBase, EnvType


class SyntheticKitchenEnv(EnvBase):
    def __init__(self, env_name: str = "SyntheticKitchen", action_dim: int = 12,
                 horizon: int = 200, seed: int = 0, **kwargs):
        self._name = env_name
        self._action_dim = action_dim
        self._horizon = horizon
        self._rng = np.random.default_rng(seed)
        self._ep_lang_str = "drive the effector to the goal"
        self._t = 0
        self._pos = np.zeros(3, np.float32)
        self._goal = np.zeros(3, np.float32)

    # -- EnvBase -----------------------------------------------------------
    def reset(self):
        self._t = 0
        self._pos = self._rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        self._goal = self._rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        return self.get_observation()

    def reset_to(self, state):
        """Accepts the dict form {'pos', 'goal'} or a flattened state
        vector [pos(3), goal(3)] (also wrapped as {'states': vec})."""
        if isinstance(state, dict) and "states" in state:
            state = np.asarray(state["states"], np.float32).ravel()
        if isinstance(state, dict):
            self._pos = np.asarray(state["pos"], np.float32)
            self._goal = np.asarray(state["goal"], np.float32)
        else:
            flat = np.asarray(state, np.float32).ravel()
            self._pos = flat[:3].copy()
            self._goal = flat[3:6].copy()
        self._t = 0
        return self.get_observation()

    def get_state(self):
        return {"pos": self._pos.copy(), "goal": self._goal.copy()}

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32)[:3], -1, 1)
        self._pos = self._pos + 0.05 * a
        self._t += 1
        done = self._t >= self._horizon
        r = float(self.is_success()["task"])
        return self.get_observation(), r, done, {"is_success": self.is_success()}

    def get_observation(self, obs=None):
        return {
            "robot0_eef_pos": self._pos.copy(),
            "robot0_eef_quat": np.array([0, 0, 0, 1], np.float32),
            "robot0_gripper_qpos": np.zeros(2, np.float32),
            "object": np.concatenate(
                [self._goal, self._goal - self._pos, np.zeros(8)]
            ).astype(np.float32),
        }

    def is_success(self):
        return {"task": bool(np.linalg.norm(self._goal - self._pos) < 0.1)}

    def render(self, mode="rgb_array", height=64, width=64, camera_name=None):
        img = np.zeros((height, width, 3), np.uint8)

        def to_px(p):
            x = int((p[0] + 1) / 2 * (width - 1))
            y = int((p[1] + 1) / 2 * (height - 1))
            return np.clip(y, 0, height - 1), np.clip(x, 0, width - 1)

        gy, gx = to_px(self._goal)
        py, px = to_px(self._pos)
        img[gy, gx] = (0, 255, 0)
        img[py, px] = (255, 0, 0)
        return img

    @property
    def name(self):
        return self._name

    @property
    def action_dimension(self):
        return self._action_dim

    def serialize(self):
        return {
            "env_name": self._name,
            "type": EnvType.SYNTHETIC_TYPE,
            "env_kwargs": {"action_dim": self._action_dim},
        }
