"""The port's five multi-stage scripted experts against the JAX package's.

At the (task, seed) pairs ``tests/test_scripted_experts.py`` pins for the
paper's five multi-stage activities (``MULTI_STAGE_TASK_DATASETS``), the
port's expert in the port's kitchen and JAX's expert in JAX's kitchen run in
lockstep: every action, observation, reward, info and ``finished`` flag is
bit-equal, both succeed at the same step, and the port's expert solves its
task. A reference fault of the collectors (MicrowaveThawing ends at the
kitchen's horizon, unsolved) is pinned in both packages.
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from test_scripted_experts import RELIABLE as JAX_RELIABLE  # noqa: E402
from test_torch_port_kitchen_experts import assert_expert_bit_equal_to_jax  # noqa: E402

from lipvq_tpu_torch.robocasa.dataset_registry import MULTI_STAGE_TASK_DATASETS  # noqa: E402

# the multi-stage part of ``tests/test_scripted_experts.py::RELIABLE``
RELIABLE = {
    "ArrangeVegetables": (5,),
    "MicrowaveThawing": (1,),
    "RestockPantry": (8,),
    "PreSoakPan": (0,),
    "PrepareCoffee": (0, 4),
}


def test_pairs_are_the_pinned_ones():
    assert sorted(RELIABLE) == sorted(MULTI_STAGE_TASK_DATASETS)
    assert {t: JAX_RELIABLE[t] for t in RELIABLE} == RELIABLE


@pytest.mark.parametrize("task,seed", [(t, s) for t, seeds in RELIABLE.items() for s in seeds])
def test_expert_bit_equal_to_jax(task, seed):
    assert_expert_bit_equal_to_jax(task, seed)


def test_collection_ends_microwave_thawing_at_the_kitchen_horizon():
    """Reference fault, mirrored: the collectors build each task at the
    kitchen's default horizon of 500 steps, not the dataset registry's
    (1000 for MicrowaveThawing), and ``collect_demo`` stops at ``done``. The
    MicrowaveThawing expert needs ~750 steps, so an attempt at its pinned
    seed ends unsolved at step 500 in both packages, with equal actions."""
    from lipvq_tpu.robocasa.env_utils import create_env as jax_create_env
    from lipvq_tpu.robocasa.sim.scripted import make_scripted_policy as jax_policy
    from lipvq_tpu.scripts.collect_demos import collect_demo as jax_collect_demo

    from lipvq_tpu_torch.envs.env_factory import create_env
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy
    from lipvq_tpu_torch.scripts.collect_demos import collect_demo

    task = "MicrowaveThawing"
    assert MULTI_STAGE_TASK_DATASETS[task]["horizon"] == 1000
    runs = []
    for make, policy, collect in ((create_env, make_scripted_policy, collect_demo),
                                  (jax_create_env, jax_policy, jax_collect_demo)):
        env = make(task, seed=RELIABLE[task][0])
        traj, success = collect(env, None, 1000, np.random.default_rng(0),
                                policy_factory=lambda e, policy=policy: policy(task, e))
        assert env.env.horizon == 500 and not success
        assert len(traj["actions"]) == 500 and traj["dones"][-1] == 1.0
        runs.append(np.stack(traj["actions"]))
        env.close()
    assert np.array_equal(*runs)
