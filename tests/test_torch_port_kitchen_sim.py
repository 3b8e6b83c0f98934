"""The port's MuJoCo kitchen against the JAX package's, bit for bit.

Both packages run the same numpy + mujoco code (``lipvq_tpu_torch/robocasa/
sim/`` is a copy of ``lipvq_tpu/robocasa/sim/``), so every single-stage task
built with the same seed must compile the same model and give the same reset
observation, the same observations, rewards, done flags and success over 30
seeded random-action steps, and the same state and ep_meta; a JAX state must
replay (``reset_to``) to the same observation in both. No tolerance: arrays
are compared with their dtypes, exactly. The twins of
``tests/test_kitchen_sim.py`` (layouts, fixture-state APIs, placement,
determinism, the adapter and the factory) follow.
"""

import json

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from lipvq_tpu.envs.env_factory import (  # noqa: E402
    create_env_from_metadata as jax_create_from_meta,
)
from lipvq_tpu.robocasa.sim import REGISTERED_KITCHEN_ENVS as JAX_ENVS  # noqa: E402

from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata  # noqa: E402
from lipvq_tpu_torch.robocasa.dataset_registry import ALL_TASK_DATASETS  # noqa: E402
from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS  # noqa: E402
from lipvq_tpu_torch.robocasa.sim.layouts import LAYOUT_GROUPS_TO_IDS, STYLES  # noqa: E402

# every single-stage task class that builds (``_PnPFixtureBase`` is abstract);
# the multi-stage ones are held in ``test_torch_port_kitchen_multi_sim_{a,b}.py``
TASKS = sorted(n for n, c in REGISTERED_KITCHEN_ENVS.items()
               if c.__module__.endswith("single_stage") and not n.startswith("_"))


def assert_obs_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def assert_state_equal(got: dict, want: dict):
    assert got["model"] == want["model"]
    assert got["ep_meta"] == want["ep_meta"]
    assert got["states"].dtype == want["states"].dtype
    assert np.array_equal(got["states"], want["states"])


def test_registry_is_the_single_stage_part_of_jax():
    """The registry equals the JAX package's, in its order: the 34
    single-stage tasks, the abstract ``_PnPFixtureBase``, then the 86
    multi-stage tasks, each class from the port's module of the same name."""
    assert list(REGISTERED_KITCHEN_ENVS) == list(JAX_ENVS) and len(JAX_ENVS) == 121
    for name, cls in REGISTERED_KITCHEN_ENVS.items():
        assert cls.__module__ == JAX_ENVS[name].__module__.replace("lipvq_tpu.", "lipvq_tpu_torch.")
        assert cls.__name__ == name
    jax_single = {n for n, c in JAX_ENVS.items() if c.__module__.endswith("single_stage")}
    assert set(TASKS) | {"_PnPFixtureBase"} == jax_single and len(TASKS) == 34
    assert set(ALL_TASK_DATASETS) <= set(REGISTERED_KITCHEN_ENVS)


def assert_task_bit_equal_to_jax(task: str, seed: int = 7):
    """Build ``task`` at ``seed`` in both packages: the same model, reset
    observation, 30 seeded random steps, state and ep_meta; a JAX state
    replays (``reset_to``) to the same observation in both."""
    jenv, penv = JAX_ENVS[task](seed=seed), REGISTERED_KITCHEN_ENVS[task](seed=seed)
    assert_obs_equal(penv.reset(), jenv.reset())
    for attr in ("nq", "nv", "nu", "nbody", "ngeom"):
        assert getattr(penv.model, attr) == getattr(jenv.model, attr), attr
    assert np.array_equal(penv.model.qpos0, jenv.model.qpos0)
    assert_state_equal(penv.get_state(), jenv.get_state())
    assert penv.get_ep_meta() == jenv.get_ep_meta()

    rng = np.random.default_rng(seed)
    for _ in range(30):
        a = rng.uniform(-1, 1, 12)
        (po, pr, pd, pi), (jo, jr, jd, ji) = penv.step(a.copy()), jenv.step(a.copy())
        assert_obs_equal(po, jo)
        assert (pr, pd, pi) == (jr, jd, ji)
        assert penv.is_success() == jenv.is_success()
    want = jenv.get_state()
    assert_state_equal(penv.get_state(), want)
    assert penv.get_ep_meta() == jenv.get_ep_meta()

    # a JAX state replays to the same observation in both packages
    p2, j2 = REGISTERED_KITCHEN_ENVS[task](seed=seed + 100), JAX_ENVS[task](seed=seed + 100)
    assert_obs_equal(p2.reset_to(want), j2.reset_to(want))
    assert_state_equal(p2.get_state(), j2.get_state())
    assert np.array_equal(p2.get_state()["states"], want["states"])
    for e in (penv, jenv, p2, j2):
        e.close()


@pytest.mark.parametrize("task", TASKS)
def test_task_bit_equal_to_jax(task):
    assert_task_bit_equal_to_jax(task)


def test_abstract_base_raises_in_both():
    for registry in (REGISTERED_KITCHEN_ENVS, JAX_ENVS):
        with pytest.raises(NotImplementedError):
            registry["_PnPFixtureBase"](seed=0).reset()


def test_layouts_all_compile():
    """Every layout compiles, with the JAX package's model."""
    for lid in LAYOUT_GROUPS_TO_IDS[-1]:
        env = REGISTERED_KITCHEN_ENVS["OpenDrawer"](layout_ids=lid, seed=3)
        jenv = JAX_ENVS["OpenDrawer"](layout_ids=lid, seed=3)
        assert_obs_equal(env.reset(), jenv.reset())
        assert env.layout_id == lid
        assert env.get_state()["model"] == jenv.get_state()["model"]
        env.close()
        jenv.close()
    assert len(STYLES) == 12


def test_env_determinism():
    """Same seed twice gives the same layout, style, objects and state."""

    def capture(seed):
        env = REGISTERED_KITCHEN_ENVS["PnPCounterToCab"](seed=seed)
        env.reset()
        state, meta = env.get_state(), env.get_ep_meta()
        env.close()
        return state, meta

    (s1, m1), (s2, m2) = capture(42), capture(42)
    assert m1 == m2
    assert_state_equal(s1, s2)


def test_reset_to_roundtrip():
    env = REGISTERED_KITCHEN_ENVS["PnPCounterToSink"](seed=5)
    env.reset()
    rng = np.random.default_rng(1)
    for _ in range(8):
        env.step(rng.uniform(-1, 1, 12))
    state = env.get_state()
    lang = env.get_ep_meta()["lang"]
    env2 = REGISTERED_KITCHEN_ENVS["PnPCounterToSink"](seed=777)
    env2.reset_to(state)
    assert np.array_equal(state["states"], env2.get_state()["states"])
    assert env2.get_ep_meta()["lang"] == lang
    env.close()
    env2.close()


def test_fixture_state_apis():
    """Knob and handle set + get round-trips, the same in both packages."""

    def run(registry):
        env = registry["TurnOnStove"](seed=2)
        env.reset()
        stove, knob = env.fixtures[env.stove.name], env.knob
        stove.set_knob_state(env=env, rng=env.rng, knob=knob, mode="on")
        q_on = stove.get_knobs_state(env)[knob]
        on = env._check_success()
        stove.set_knob_state(env=env, rng=env.rng, knob=knob, mode="off")
        off = env._check_success()
        sink = env.get_fixture(1)  # FixtureType.SINK
        sink.set_handle_state(env=env, rng=env.rng, mode="on")
        water_on = sink.get_handle_state(env)["water_on"]
        sink.set_handle_state(env=env, rng=env.rng, mode="off")
        water_off = sink.get_handle_state(env)["water_on"]
        env.close()
        return q_on, on, off, water_on, water_off

    q, on, off, water_on, water_off = got = run(REGISTERED_KITCHEN_ENVS)
    assert got == run(JAX_ENVS)
    assert 0.35 <= abs(q) <= 2 * np.pi - 0.35
    assert on and not off and water_on and not water_off


def test_fixture_state_observation_and_door_success():
    env = REGISTERED_KITCHEN_ENVS["OpenSingleDoor"](seed=4)
    fs = env.reset()["fixture_state"]
    assert fs.shape == (16,) and np.isfinite(fs).all()
    handle = env.geom_xpos(env.door_fxtr.handle_name)
    assert np.allclose(fs[:3], handle, atol=1e-6)
    assert fs[6] < 0.05 and not env._check_success()
    env.door_fxtr.set_door_state(min=0.95, max=1.0, env=env, rng=env.rng)
    mujoco.mj_forward(env.model, env.data)
    assert env.get_observation()["fixture_state"][6] > 0.9
    assert env._check_success()
    env.close()


@pytest.mark.parametrize("task", ["TurnOnSinkFaucet", "OpenSingleDoor"])
def test_placement_no_overlap(task):
    """Placed objects keep horizontal separation on one support."""
    pairs = 0
    for seed in (21, 22, 23):
        env = REGISTERED_KITCHEN_ENVS[task](seed=seed)
        env.reset()
        names = list(env.objects)
        assert len(names) >= 2
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                pa, pb = env.object_pos(a), env.object_pos(b)
                ra, rb = env.objects[a].horizontal_radius, env.objects[b].horizontal_radius
                if abs(pa[2] - pb[2]) > 0.10:
                    continue  # different shelves or fixtures
                pairs += 1
                assert np.linalg.norm(pa[:2] - pb[:2]) > 0.5 * (ra + rb), (seed, a, b)
        env.close()
    assert pairs > 0


def test_env_kitchen_adapter_and_factory():
    """``EnvKitchen`` through the factory, against the JAX adapter: the same
    observation, language, action dimension and serialized env_meta."""
    meta = {"env_name": "CloseDrawer", "type": 1, "env_kwargs": {"seed": 9}}
    env, jenv = create_env_from_metadata(meta), jax_create_from_meta(meta)
    assert type(env).__name__ == "EnvKitchen"
    assert_obs_equal(env.reset(), jenv.reset())
    assert env.ep_lang_str == jenv.ep_lang_str and env.ep_lang_str.startswith("close the")
    assert env.action_dimension == 12 and env.name == "CloseDrawer"
    assert env.serialize() == jenv.serialize()
    env2 = create_env_from_metadata(json.loads(json.dumps(env.serialize())))
    env2.reset_to(env.get_state())
    assert np.array_equal(env2.get_state()["states"], env.get_state()["states"])
    for e in (env, jenv, env2):
        e.close()


def test_camera_image_is_flipped():
    """``EnvKitchen.get_observation`` flips ``*_image`` arrays upside down
    and passes other keys as float32, as JAX's adapter does."""
    from lipvq_tpu.envs.env_kitchen import EnvKitchen as JaxEnvKitchen

    from lipvq_tpu_torch.envs.env_kitchen import EnvKitchen

    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    raw = {"cam_image": img, "robot0_eef_pos": np.arange(3, dtype=np.float64)}
    got = EnvKitchen.get_observation(None, raw)
    want = JaxEnvKitchen.get_observation(None, raw)
    assert_obs_equal(got, want)
    assert np.array_equal(got["cam_image"], img[::-1])
    assert got["robot0_eef_pos"].dtype == np.float32
