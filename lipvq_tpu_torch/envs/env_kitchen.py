"""EnvBase adapter for the MuJoCo-direct kitchen (the port's copy of
``lipvq_tpu/envs/env_kitchen.py``; reference
robomimic/envs/env_robosuite.py:22-259).

Wraps a :class:`lipvq_tpu_torch.robocasa.sim.Kitchen` task in the EnvBase
API the training and rollout stack consumes: step / reset / reset_to /
render / get_observation / is_success, the episode language
(``ep_lang_str``, reference env_robosuite.py:122-150), camera images
flipped upside down as the reference does, and the self-describing
``serialize()`` env_meta stored in a dataset's ``env_args``.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_base import EnvBase, EnvType


class EnvKitchen(EnvBase):
    """Kitchen task adapter (reference env_robosuite.py:22)."""

    def __init__(self, env_name: str, render: bool = False,
                 render_offscreen: bool = False, use_image_obs: bool = False,
                 **kwargs):
        from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS

        if env_name not in REGISTERED_KITCHEN_ENVS:
            raise ValueError(
                f"unknown kitchen env {env_name!r}; registered: "
                f"{sorted(REGISTERED_KITCHEN_ENVS)[:8]}..."
            )
        kwargs.pop("env_name", None)
        self._name = env_name
        self._init_kwargs = dict(kwargs)
        self.env = REGISTERED_KITCHEN_ENVS[env_name](
            use_camera_obs=use_image_obs, **kwargs
        )
        self._ep_lang_str = ""

    # -- EnvBase -------------------------------------------------------
    def reset(self):
        obs = self.env.reset()
        self._ep_lang_str = self.env.get_ep_meta().get("lang", "")
        return self.get_observation(obs)

    def reset_to(self, state):
        obs = self.env.reset_to(state)
        self._ep_lang_str = self.env.get_ep_meta().get("lang", "")
        return self.get_observation(obs)

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        return self.get_observation(obs), reward, done, info

    def get_observation(self, obs=None):
        if obs is None:
            obs = self.env.get_observation()
        out = {}
        for k, v in obs.items():
            if k.endswith("_image"):
                # reference env_robosuite.py:242-259 flips images
                out[k] = np.ascontiguousarray(v[::-1])
            else:
                out[k] = np.asarray(v, dtype=np.float32)
        return out

    def get_state(self):
        return self.env.get_state()

    def is_success(self):
        return self.env.is_success()

    def render(self, mode="rgb_array", height=None, width=None, camera_name=None):
        return self.env.render(mode, height=height, width=width,
                               camera_name=camera_name)

    def get_ep_meta(self):
        return self.env.get_ep_meta()

    @property
    def ep_lang_str(self):
        return self._ep_lang_str

    @property
    def name(self):
        return self._name

    @property
    def action_dimension(self):
        from lipvq_tpu_torch.robocasa.sim.robot import ACTION_DIM

        return ACTION_DIM

    def serialize(self):
        """env_meta dict stored in dataset HDF5 attrs (SURVEY A.1)."""
        return {
            "env_name": self._name,
            "type": EnvType.ROBOSUITE_TYPE,
            "env_kwargs": dict(self._init_kwargs),
            "env_lang": self._ep_lang_str,
        }

    def close(self):
        self.env.close()
