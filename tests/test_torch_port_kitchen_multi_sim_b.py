"""The port's multi-stage kitchen against the JAX package's, bit for bit:
the last ten activity groups (in the order ``multi_stage/__init__.py``
imports them); ``test_torch_port_kitchen_multi_sim_a.py`` holds the first
ten.

Every task of these groups, built with the same seed in both packages,
compiles the same model and gives the same reset observation, the same
observations, rewards, done flags, infos and success over 30 seeded
random-action steps, and the same state and ep_meta; a JAX state replays
(``reset_to``) to the same observation in both. No tolerance. The twin of
``tests/test_multi_stage_tasks.py::test_task_validity`` follows.
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from test_torch_port_kitchen_multi_sim_a import group_classes  # noqa: E402
from test_torch_port_kitchen_sim import assert_task_bit_equal_to_jax  # noqa: E402

import lipvq_tpu_torch.robocasa.sim.multi_stage as ms  # noqa: E402
from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS  # noqa: E402

GROUPS = ["meat_preparation", "mixing_and_blending", "reheating_food", "sanitize_surface",
          "serving_food", "setting_the_table", "snack_preparation", "steaming_food",
          "tidying_cabinets_and_drawers", "washing_fruits_and_vegetables"]

TASKS = [t for g in GROUPS for t in group_classes(ms)[g]]


@pytest.mark.parametrize("task", TASKS)
def test_task_bit_equal_to_jax(task):
    assert_task_bit_equal_to_jax(task)


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
