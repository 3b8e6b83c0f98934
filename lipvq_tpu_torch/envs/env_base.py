"""Environment abstraction (copy of ``lipvq_tpu/envs/env_base.py``): the
``EnvBase`` API every adapter implements (reference env_base.py:19-80) and
the ``EnvType`` enum of env_meta dispatch (reference env_base.py:9-16)."""

from __future__ import annotations

import abc


class EnvType:
    ROBOSUITE_TYPE = 1
    GYM_TYPE = 2
    IG_MOMART_TYPE = 3
    SYNTHETIC_TYPE = 99  # lipvq_tpu extension for hermetic testing


class EnvBase(abc.ABC):
    """Abstract environment API (reference env_base.py:19-80)."""

    @abc.abstractmethod
    def step(self, action):
        """-> (obs dict, reward, done, info); info['is_success'] dict."""

    @abc.abstractmethod
    def reset(self):
        """-> obs dict; captures episode language if available."""

    @abc.abstractmethod
    def reset_to(self, state):
        """Restore a simulator state."""

    @abc.abstractmethod
    def render(self, mode="human", height=None, width=None, camera_name=None):
        ...

    @abc.abstractmethod
    def get_observation(self, obs=None):
        ...

    @abc.abstractmethod
    def is_success(self) -> dict:
        """{'task': bool, ...} per-subtask success flags."""

    @property
    @abc.abstractmethod
    def name(self) -> str:
        ...

    @property
    @abc.abstractmethod
    def action_dimension(self) -> int:
        ...

    @property
    def ep_lang_str(self) -> str | None:
        return getattr(self, "_ep_lang_str", None)

    def get_state(self):
        return None

    def close(self):
        """Release the simulator; adapters that hold one override this."""

    def serialize(self) -> dict:
        return {"env_name": self.name, "type": None, "env_kwargs": {}}
