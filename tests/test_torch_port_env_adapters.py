"""Port parity of the env adapters: ``lipvq_tpu_torch.envs.{env_gym,
env_robosuite, env_ig_momart, env_factory}`` against the JAX package's on
the same inputs, bit for bit.

- ``EnvGym`` on ``Pendulum-v1`` and ``Hopper-v4``: both adapters' reset
  takes no seed, so each test seeds the inner env (``env.env.reset(seed=)``,
  then ``get_observation``) and steps both with the same 20 seeded actions.
- ``EnvRobosuite`` and ``EnvIGMomart`` over fake ``robosuite`` / ``igibson``
  modules put into ``sys.modules`` (the same fake for both packages), and
  the ``igibson`` import gate with the package missing.
- The factory's dispatch for types 1 (a name that is not a kitchen task), 2
  and 3."""

import sys
import types

import numpy as np
import pytest

import lipvq_tpu.envs.env_factory as jax_factory
import lipvq_tpu.envs.env_gym as jax_gym
import lipvq_tpu.envs.env_ig_momart as jax_momart
import lipvq_tpu.envs.env_robosuite as jax_robosuite
import lipvq_tpu_torch.envs.env_factory as port_factory
import lipvq_tpu_torch.envs.env_gym as port_gym
import lipvq_tpu_torch.envs.env_ig_momart as port_momart
import lipvq_tpu_torch.envs.env_robosuite as port_robosuite

STEPS = 20


def _assert_same(a, b, where=""):
    """Equal trees, arrays by value, dtype and shape; numbers by type too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("name", ["Pendulum-v1", "Hopper-v4"])
def test_env_gym_matches_jax(name):
    pytest.importorskip("gymnasium")
    envs = [jax_gym.EnvGym(name), port_gym.EnvGym(name)]
    obs = [e.get_observation(e.env.reset(seed=7)[0]) for e in envs]
    _assert_same(*obs, "reset")
    assert list(obs[1]) == ["flat"]
    space = envs[0].env.action_space
    rng = np.random.default_rng(11)
    for t in range(STEPS):
        action = rng.uniform(space.low, space.high).astype(space.dtype)
        outs = [e.step(action) for e in envs]
        _assert_same(*outs[0:2], f"step {t}")
        _assert_same(*(e.get_observation() for e in envs), f"current obs {t}")
    assert outs[1][3]["is_success"] == {"task": False}
    for attr in ("name", "action_dimension"):
        assert getattr(envs[0], attr) == getattr(envs[1], attr)
    assert envs[1].action_dimension == int(np.prod(space.shape))
    assert envs[0].serialize() == envs[1].serialize() == {
        "env_name": name, "type": 2, "env_kwargs": {}}
    assert envs[0].is_success() == envs[1].is_success() == {"task": False}
    for e in envs:
        with pytest.raises(NotImplementedError, match="state restore"):
            e.reset_to({})


# -- a fake robosuite, the same module for both packages ---------------------


class _FakeSim:
    def __init__(self, env):
        self.env = env
        self.model = types.SimpleNamespace(get_xml=lambda: env.xml)

    def reset(self):
        self.env.calls.append("sim.reset")

    def set_state_from_flattened(self, state):
        self.env.qpos = np.array(state, np.float64)

    def forward(self):
        self.env.calls.append("sim.forward")

    def get_state(self):
        return types.SimpleNamespace(flatten=lambda: np.concatenate([[self.env.t], self.env.qpos]))

    def render(self, height, width, camera_name):
        return np.arange(height * width * 3, dtype=np.uint8).reshape(height, width, 3)


class _FakeRobosuiteEnv:
    """Observations and success are deterministic functions of the state."""

    def __init__(self, name, success_kind, **kwargs):
        self.name, self.success_kind, self.kwargs = name, success_kind, kwargs
        self.xml, self.calls = f"<mujoco model='{name}'/>", []
        self.t, self.qpos = 0, np.zeros(4)
        self.action_spec = (np.full(7, -1.0), np.full(7, 1.0))
        self.sim = _FakeSim(self)

    def _get_observations(self, force_update=False):
        image = (np.arange(4 * 5 * 3).reshape(4, 5, 3) * 3 + self.t).astype(np.uint8)
        return {"agentview_image": image, "robot0_eye_in_hand_image": image[:, ::-1] + 1,
                "robot0_eef_pos": self.qpos[:3].astype(np.float32),
                "object-state": np.float64(self.qpos.sum() * 0.5)}

    def reset(self):
        self.t, self.qpos = 0, np.linspace(0.1, 0.4, 4)
        return self._get_observations()

    def step(self, action):
        self.t += 1
        self.qpos = self.qpos + 0.01 * np.asarray(action)[:4]
        return self._get_observations(), np.float64(self.qpos[0]), self.t >= 3, {"t": self.t}

    def get_ep_meta(self):
        return {"lang": f"open the drawer {self.t} {self.xml}"}

    def edit_model_xml(self, xml):
        return xml.replace("model=", "edited=")

    def reset_from_xml_string(self, xml):
        self.xml = xml

    def update_state(self):
        self.calls.append("update_state")

    def _check_success(self):
        done = bool(self.qpos[0] > 0.1)
        if self.success_kind == "dict":
            return {"task": done, "grasp": np.bool_(self.t % 2)}
        return np.bool_(done)


def _fake_robosuite(success_kind):
    module = types.ModuleType("robosuite")
    module.made = []

    def make(env_name, **kwargs):
        module.made.append((env_name, kwargs))
        return _FakeRobosuiteEnv(env_name, success_kind, **kwargs)

    module.make = make
    return module


@pytest.mark.parametrize("success_kind", ["dict", "bool"])
def test_env_robosuite_matches_jax_over_a_fake(monkeypatch, success_kind):
    fake = _fake_robosuite(success_kind)
    monkeypatch.setitem(sys.modules, "robosuite", fake)
    kwargs = {"robots": ["PandaOmron"], "controller_configs": {"type": "OSC_POSE"}}
    envs = [m.EnvRobosuite("PnPCounterToCab", render_offscreen=True, **kwargs)
            for m in (jax_robosuite, port_robosuite)]
    assert fake.made[0] == fake.made[1]
    assert fake.made[1][1] == {**kwargs, "has_renderer": False, "has_offscreen_renderer": True,
                               "ignore_done": True, "use_object_obs": True,
                               "use_camera_obs": False}
    obs = [e.reset() for e in envs]
    _assert_same(*obs, "reset")
    raw = envs[1].env._get_observations()
    assert np.array_equal(obs[1]["agentview_image"], raw["agentview_image"][::-1])
    assert np.array_equal(obs[1]["robot0_eye_in_hand_image"],
                          raw["robot0_eye_in_hand_image"][::-1])
    assert envs[0]._ep_lang_str == envs[1]._ep_lang_str == envs[1].env.get_ep_meta()["lang"]
    rng = np.random.default_rng(5)
    for t in range(4):
        action = rng.uniform(-1, 1, 7)
        _assert_same(*(e.step(action) for e in envs), f"step {t}")
    want_success = ({"task": True, "grasp": False} if success_kind == "dict" else {"task": True})
    assert envs[0].is_success() == envs[1].is_success() == want_success
    states = [e.get_state() for e in envs]
    _assert_same(*states, "get_state")
    state = {"model": "<mujoco model='restored'/>", "states": np.array([0.5, 0.1, 0.2, 0.3])}
    restored = [e.reset_to(state) for e in envs]
    _assert_same(*restored, "reset_to")
    assert envs[1].env.xml == "<mujoco edited='restored'/>"
    assert np.array_equal(envs[1].env.qpos, state["states"])
    assert envs[0].env.calls == envs[1].env.calls == ["sim.reset", "sim.forward", "update_state"]
    assert envs[0]._ep_lang_str == envs[1]._ep_lang_str
    _assert_same(*(e.reset_to({"states": np.zeros(4)}) for e in envs), "reset_to states")
    _assert_same(*(e.render(mode="rgb_array", height=4, width=6) for e in envs), "render")
    for attr in ("name", "action_dimension"):
        assert getattr(envs[0], attr) == getattr(envs[1], attr)
    assert envs[1].action_dimension == 7
    assert envs[0].serialize() == envs[1].serialize() == {
        "env_name": "PnPCounterToCab", "type": 1, "env_kwargs": kwargs}


# -- iG-MoMart ----------------------------------------------------------------


def test_env_ig_momart_gate_matches_jax(monkeypatch):
    """Without ``igibson`` both constructors raise the same ImportError."""
    monkeypatch.setitem(sys.modules, "igibson", None)
    errors = []
    for m in (jax_momart, port_momart):
        with pytest.raises(ImportError) as info:
            m.EnvIGMomart("table_setup_from_dishwasher")
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1]) is ImportError
    assert str(errors[0]) == str(errors[1])
    assert "requires the `igibson` package" in str(errors[1])
    assert isinstance(errors[1].__cause__, ModuleNotFoundError)


def test_momart_dataset_urls_match_jax():
    assert port_momart.MOMART_TASKS == jax_momart.MOMART_TASKS
    assert port_momart.MOMART_DATASET_TYPES == jax_momart.MOMART_DATASET_TYPES
    assert port_momart.MOMART_BASE_URL == jax_momart.MOMART_BASE_URL
    for task in jax_momart.MOMART_TASKS:
        for kind in jax_momart.MOMART_DATASET_TYPES:
            assert port_momart.momart_dataset_url(task, kind) == \
                jax_momart.momart_dataset_url(task, kind)
    assert port_momart.momart_dataset_url(port_momart.MOMART_TASKS[0]) == \
        jax_momart.momart_dataset_url(jax_momart.MOMART_TASKS[0])
    for m in (jax_momart, port_momart):
        with pytest.raises(AssertionError):
            m.momart_dataset_url("no_such_task")
        with pytest.raises(AssertionError):
            m.momart_dataset_url(m.MOMART_TASKS[0], "no_such_type")


class _FakeIGEnv:
    def __init__(self, config_file, mode, action_timestep, physics_timestep):
        self.args = (dict(config_file), mode, action_timestep, physics_timestep)
        self.t = 0
        self.action_space = types.SimpleNamespace(shape=(11,))
        self.task = types.SimpleNamespace(reset_scene=lambda env: None,
                                          check_success=lambda: (self.t >= 2, {}))
        self.scene = types.SimpleNamespace(restore_state=self._restore,
                                           dump_state=lambda: np.array([self.t, 7.0]))
        self.simulator = types.SimpleNamespace(sync=lambda: None)

    def _restore(self, state):
        self.t = int(np.asarray(state)[0])

    def get_state(self):
        rgb = (np.arange(9 * 7 * 3).reshape(9, 7, 3) + self.t).astype(np.uint8)
        return {"rgb": rgb, "proprio": np.arange(5, dtype=np.float64) * self.t}

    def reset(self):
        self.t = 0
        return self.get_state()

    def step(self, action):
        self.t += 1
        return self.get_state(), np.float64(action.sum()), self.t >= 3, {"t": self.t}

    def close(self):
        pass


def _fake_igibson(monkeypatch):
    root, envs, ig_env = (types.ModuleType(n) for n in (
        "igibson", "igibson.envs", "igibson.envs.igibson_env"))
    ig_env.iGibsonEnv = _FakeIGEnv
    for name, module in (("igibson", root), ("igibson.envs", envs),
                         ("igibson.envs.igibson_env", ig_env)):
        monkeypatch.setitem(sys.modules, name, module)


def test_env_ig_momart_matches_jax_over_a_fake(monkeypatch):
    _fake_igibson(monkeypatch)
    kwargs = {"ig_config": {"scene": "Rs_int"}, "image_height": 4, "image_width": 5,
              "action_timestep": 0.2}
    envs = [m.EnvIGMomart("table_setup_from_dishwasher", **kwargs)
            for m in (jax_momart, port_momart)]
    assert envs[0].env.args == envs[1].env.args == ({"scene": "Rs_int"}, "headless", 0.2,
                                                    1.0 / 120.0)
    _assert_same(*(e.reset() for e in envs), "reset")
    assert envs[1].reset()["rgb"].shape == (4, 5, 3)
    for t in range(3):
        _assert_same(*(e.step(np.full(11, 0.1 * t)) for e in envs), f"step {t}")
    _assert_same(*(e.get_state() for e in envs), "get_state")
    _assert_same(*(e.reset_to({"states": np.array([1.0, 7.0])}) for e in envs), "reset_to")
    assert envs[0].is_success() == envs[1].is_success() == {"task": False}
    assert envs[0].action_dimension == envs[1].action_dimension == 11
    assert envs[0].serialize() == envs[1].serialize()
    assert envs[1].serialize()["type"] == 3


# -- the factory ----------------------------------------------------------------


def test_factory_dispatches_as_jax(monkeypatch):
    """Type 1 with a name that is no kitchen task builds ``EnvRobosuite``, type
    2 ``EnvGym``, type 3 ``EnvIGMomart``, in both packages; a kitchen task
    still builds the first-party ``EnvKitchen``."""
    pytest.importorskip("gymnasium")
    monkeypatch.setitem(sys.modules, "robosuite", _fake_robosuite("bool"))
    _fake_igibson(monkeypatch)
    cases = [({"env_name": "Lift", "type": 1, "env_kwargs": {"robots": "Panda"}}, "EnvRobosuite"),
             ({"env_name": "Pendulum-v1", "type": 2}, "EnvGym"),
             ({"env_name": "table_setup_from_dresser", "type": 3,
               "env_kwargs": {"ig_config": {}}}, "EnvIGMomart")]
    for env_meta, cls in cases:
        got = [f.create_env_from_metadata(env_meta) for f in (jax_factory, port_factory)]
        assert [type(e).__name__ for e in got] == [cls, cls]
        assert type(got[1]).__module__.startswith("lipvq_tpu_torch.")
        assert got[0].serialize() == got[1].serialize()
