"""robosuite / robocasa adapter (counterpart of
``lipvq_tpu/envs/env_robosuite.py``; reference envs/env_robosuite.py:22-260).

``robosuite`` is imported when an env is built, never on import. As in the
JAX adapter:

- ``reset`` keeps the episode's language, ``get_ep_meta()["lang"]``, in
  ``_ep_lang_str``;
- ``reset_to`` restores the MuJoCo XML (``model``) and the flattened sim
  state (``states``);
- observations whose key ends in ``_image`` are flipped vertically;
- ``is_success`` returns the env's per-subtask success dict, or
  ``{"task": bool}``; ``serialize`` carries the kwargs the env was built
  with.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_base import EnvBase, EnvType


class EnvRobosuite(EnvBase):
    def __init__(self, env_name: str, render: bool = False, render_offscreen: bool = False,
                 use_image_obs: bool = False, **kwargs):
        import robosuite

        self._name = env_name
        self._init_kwargs = dict(kwargs)
        self.use_image_obs = use_image_obs
        kwargs = dict(kwargs)
        kwargs.update(
            has_renderer=render,
            has_offscreen_renderer=(render_offscreen or use_image_obs),
            ignore_done=True,
            use_object_obs=True,
            use_camera_obs=use_image_obs,
        )
        self.env = robosuite.make(env_name, **kwargs)
        self._ep_lang_str = None

    def step(self, action):
        obs, reward, done, info = self.env.step(action)
        obs = self.get_observation(obs)
        info = dict(info)
        info["is_success"] = self.is_success()
        return obs, float(reward), bool(done), info

    def reset(self):
        di = self.env.reset()
        if hasattr(self.env, "get_ep_meta"):
            self._ep_lang_str = self.env.get_ep_meta().get("lang", None)
        return self.get_observation(di)

    def reset_to(self, state):
        if "model" in state:
            self.env.reset()
            xml = state["model"]
            if hasattr(self.env, "edit_model_xml"):
                xml = self.env.edit_model_xml(xml)
            self.env.reset_from_xml_string(xml)
            self.env.sim.reset()
        if "states" in state:
            self.env.sim.set_state_from_flattened(state["states"])
            self.env.sim.forward()
        if hasattr(self.env, "update_state"):
            self.env.update_state()
        if hasattr(self.env, "get_ep_meta"):
            self._ep_lang_str = self.env.get_ep_meta().get("lang", None)
        return self.get_observation()

    def get_state(self):
        xml = self.env.sim.model.get_xml()
        state = np.array(self.env.sim.get_state().flatten())
        return {"model": xml, "states": state}

    def render(self, mode="human", height=None, width=None, camera_name=None):
        if mode == "human":
            return self.env.render()
        im = self.env.sim.render(height=height or 512, width=width or 512,
                                 camera_name=camera_name or "agentview")
        return im[::-1]

    def get_observation(self, obs=None):
        if obs is None:
            obs = self.env._get_observations(force_update=True)
        out = {}
        for k, v in obs.items():
            if k.endswith("_image"):
                out[k] = np.asarray(v)[::-1].copy()  # flip (reference :249)
            else:
                out[k] = np.asarray(v)
        return out

    def is_success(self):
        succ = self.env._check_success()
        if isinstance(succ, dict):
            assert "task" in succ
            return {k: bool(v) for k, v in succ.items()}
        return {"task": bool(succ)}

    @property
    def name(self):
        return self._name

    @property
    def action_dimension(self):
        return int(self.env.action_spec[0].shape[0])

    def serialize(self):
        return {"env_name": self._name, "type": EnvType.ROBOSUITE_TYPE,
                "env_kwargs": self._init_kwargs}
