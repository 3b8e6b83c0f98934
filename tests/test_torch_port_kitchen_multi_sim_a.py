"""The port's multi-stage kitchen against the JAX package's, bit for bit:
the first ten activity groups (in the order ``multi_stage/__init__.py``
imports them); ``test_torch_port_kitchen_multi_sim_b.py`` holds the other
ten.

Every task of these groups, built with the same seed in both packages,
compiles the same model and gives the same reset observation, the same
observations, rewards, done flags, infos and success over 30 seeded
random-action steps, and the same state and ep_meta; a JAX state replays
(``reset_to``) to the same observation in both. No tolerance. The twins of
``tests/test_multi_stage_tasks.py`` (20 groups, 86 classes, each registered,
each episode with its language) follow.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import lipvq_tpu.robocasa.sim.multi_stage as jax_ms  # noqa: E402
from test_torch_port_kitchen_sim import assert_task_bit_equal_to_jax  # noqa: E402

import lipvq_tpu_torch.robocasa.sim.multi_stage as ms  # noqa: E402
from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS  # noqa: E402

GROUPS = ["baking", "boiling", "brewing", "chopping_food", "clearing_table",
          "defrosting_food", "restocking_supplies", "washing_dishes", "frying",
          "making_toast"]


def group_classes(package) -> dict:
    """{activity group: names of the task classes its module defines}."""
    out = {}
    for name in [m.name for m in pkgutil.iter_modules(package.__path__)]:
        mod = importlib.import_module(f"{package.__name__}.{name}")
        out[name] = [c.__name__ for c in vars(mod).values()
                     if inspect.isclass(c) and c.__module__ == mod.__name__]
    return out


TASKS = [t for g in GROUPS for t in group_classes(ms)[g]]


@pytest.mark.parametrize("task", TASKS)
def test_task_bit_equal_to_jax(task):
    assert_task_bit_equal_to_jax(task)


def test_registry_counts():
    """20 activity groups, 86 task classes, each registered, in the JAX
    package's grouping (``tests/test_multi_stage_tasks.py::
    test_registry_counts``)."""
    classes = group_classes(ms)
    assert len(classes) == 20, sorted(classes)
    assert sum(len(v) for v in classes.values()) == 86, classes
    assert classes == group_classes(jax_ms)
    for group, names in classes.items():
        assert names, f"activity group {group} registered no tasks"
        for n in names:
            assert REGISTERED_KITCHEN_ENVS[n].__module__ == f"{ms.__name__}.{group}"
    assert len(TASKS) == 43


@pytest.mark.parametrize("task", TASKS)
def test_task_validity(task):
    """``tests/test_multi_stage_tasks.py::test_task_validity``'s twin:
    construct, reset (an episode language is set), 20 small random
    actions; success stays boolean."""
    env = REGISTERED_KITCHEN_ENVS[task](seed=7)
    env.reset()
    assert env._ep_lang_str
    rng = np.random.default_rng(0)
    for _ in range(20):
        _, _, _, info = env.step(rng.uniform(-0.3, 0.3, size=12))
        assert isinstance(info["is_success"]["task"], (bool, np.bool_))
    env.close()
