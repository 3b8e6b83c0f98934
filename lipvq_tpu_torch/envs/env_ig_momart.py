"""iGibson MOMART adapter (counterpart of ``lipvq_tpu/envs/env_ig_momart.py``;
reference envs/env_ig_momart.py:29-395, ``EnvGibsonMOMART``).

It wraps the iGibson environments of the MOMART datasets. ``igibson`` is
imported when an env is built; without it the constructor raises the JAX
adapter's ``ImportError``, word for word. As in the JAX adapter:

- the env is built from ``env_name`` and an iGibson config dict;
- ``reset_to`` restores a dumped scene state and re-syncs the simulator;
- rgb / depth frames are resized (nearest neighbour) to the configured
  observation size;
- ``is_success`` returns ``{"task": bool}``.

``MOMART_TASKS``, ``MOMART_DATASET_TYPES`` and ``momart_dataset_url`` give
the MOMART dataset registry's download layout; nothing is fetched here.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.envs.env_base import EnvBase, EnvType


class EnvIGMomart(EnvBase):
    def __init__(self, env_name: str, ig_config: dict | None = None,
                 postprocess_visual_obs: bool = True, render: bool = False,
                 render_offscreen: bool = False, use_image_obs: bool = False,
                 image_height: int = 120, image_width: int = 120, **kwargs):
        try:
            import igibson  # noqa: F401
            from igibson.envs.igibson_env import iGibsonEnv
        except ImportError as e:
            raise ImportError(
                "EnvIGMomart requires the `igibson` package (reference "
                "env_ig_momart.py:1-28); install iGibson + the MOMART "
                "assets to use the momart datasets"
            ) from e

        self._name = env_name
        self._init_kwargs = dict(kwargs)
        self.ig_config = dict(ig_config or {})
        self.postprocess_visual_obs = postprocess_visual_obs
        self.image_height = image_height
        self.image_width = image_width
        self.use_image_obs = use_image_obs

        mode = "gui" if render else "headless"
        self.env = iGibsonEnv(
            config_file=self.ig_config, mode=mode,
            action_timestep=kwargs.get("action_timestep", 1.0 / 10.0),
            physics_timestep=kwargs.get("physics_timestep", 1.0 / 120.0),
        )
        self._ep_lang_str = None

    def step(self, action):
        obs, reward, done, info = self.env.step(np.asarray(action))
        info = dict(info)
        info["is_success"] = self.is_success()
        return self.get_observation(obs), float(reward), bool(done), info

    def reset(self):
        di = self.env.reset()
        return self.get_observation(di)

    def reset_to(self, state):
        """Restore a dumped sim state (reference :153-171)."""
        if isinstance(state, dict) and "states" in state:
            state = state["states"]
        self.env.task.reset_scene(self.env)
        self.env.scene.restore_state(state)
        self.env.simulator.sync()
        return self.get_observation()

    def get_observation(self, di=None):
        if di is None:
            di = self.env.get_state()
        obs = {}
        for k, v in di.items():
            arr = np.asarray(v)
            if arr.ndim == 3 and self.postprocess_visual_obs:
                obs[k] = self.resize_obs_frame(arr)
            else:
                obs[k] = arr.astype(np.float32)
        return obs

    def resize_obs_frame(self, frame):
        """Nearest-neighbour resize to the configured obs frame (reference
        :203-208)."""
        h, w = frame.shape[:2]
        ys = np.linspace(0, h - 1, self.image_height).astype(int)
        xs = np.linspace(0, w - 1, self.image_width).astype(int)
        return np.ascontiguousarray(frame[ys][:, xs])

    def get_state(self):
        return {"states": self.env.scene.dump_state()}

    def is_success(self):
        success, _ = self.env.task.check_success()
        return {"task": bool(success)}

    def render(self, mode="rgb_array", height=None, width=None, camera_name="rgb"):
        frames = self.env.simulator.renderer.render(modes=("rgb",))
        frame = (np.asarray(frames[0])[..., :3] * 255).astype(np.uint8)
        if height and width:
            ys = np.linspace(0, frame.shape[0] - 1, height).astype(int)
            xs = np.linspace(0, frame.shape[1] - 1, width).astype(int)
            frame = frame[ys][:, xs]
        return frame

    @property
    def name(self):
        return self._name

    @property
    def action_dimension(self):
        return int(self.env.action_space.shape[0])

    def serialize(self):
        return {"env_name": self._name, "type": EnvType.IG_MOMART_TYPE,
                "env_kwargs": dict(self._init_kwargs, ig_config=self.ig_config)}

    def close(self):
        self.env.close()


# MOMART dataset registry (reference scripts/download_momart_datasets.py)
MOMART_TASKS = (
    "table_setup_from_dishwasher",
    "table_setup_from_dresser",
    "table_cleanup_to_dishwasher",
    "table_cleanup_to_sink",
    "unload_dishwasher_to_dresser",
)
MOMART_DATASET_TYPES = ("expert", "suboptimal", "generalize", "sample")
MOMART_BASE_URL = "http://downloads.cs.stanford.edu/downloads/rt_mm/"


def momart_dataset_url(task: str, dataset_type: str = "expert") -> str:
    """The download URL of a MOMART dataset (reference
    download_momart_datasets.py); a string only."""
    assert task in MOMART_TASKS, f"unknown momart task {task}"
    assert dataset_type in MOMART_DATASET_TYPES
    return f"{MOMART_BASE_URL}{dataset_type}/{task}/{task}_{dataset_type}.hdf5"
