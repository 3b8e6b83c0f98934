"""The port's scripted kitchen experts against the JAX package's.

For every single-stage dataset task, at the seeds ``tests/
test_scripted_experts.py`` pins it to (``RELIABLE``), the port's expert in
the port's kitchen and JAX's expert in JAX's kitchen run in lockstep: every
action, observation and success flag is bit-equal, both finish at the same
step, and the port's expert solves the task as JAX's does. The multi-stage
experts are held in ``test_torch_port_kitchen_multi_experts.py``.
"""

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from lipvq_tpu.robocasa.sim import REGISTERED_KITCHEN_ENVS as JAX_ENVS  # noqa: E402
from lipvq_tpu.robocasa.sim.scripted import TASK_POLICIES as JAX_POLICIES  # noqa: E402
from lipvq_tpu.robocasa.sim.scripted import make_scripted_policy as jax_policy  # noqa: E402

from lipvq_tpu_torch.robocasa.dataset_registry import SINGLE_STAGE_TASK_DATASETS  # noqa: E402
from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS  # noqa: E402
from lipvq_tpu_torch.robocasa.sim.scripted import (  # noqa: E402
    TASK_POLICIES,
    make_scripted_policy,
)

# the single-stage part of ``tests/test_scripted_experts.py::RELIABLE``
RELIABLE = {
    "NavigateKitchen": (0, 1),
    "OpenDrawer": (0, 1),
    "CloseDrawer": (0, 2),
    "TurnOnMicrowave": (0,),
    "TurnOffMicrowave": (0,),
    "CoffeePressButton": (0,),
    "TurnOnSinkFaucet": (0,),
    "TurnOffSinkFaucet": (0,),
    "OpenSingleDoor": (0, 1),
    "CloseSingleDoor": (0, 1),
    "OpenDoubleDoor": (1,),
    "CloseDoubleDoor": (0,),
    "TurnSinkSpout": (0,),
    "TurnOnStove": (0,),
    "TurnOffStove": (1,),
    "PnPCounterToSink": (0,),
    "PnPSinkToCounter": (0,),
    "PnPCounterToCab": (0, 2),
    "PnPCabToCounter": (0, 2),
    "PnPCounterToMicrowave": (0, 1),
    "PnPMicrowaveToCounter": (1,),
    "PnPCounterToStove": (1,),
    "PnPStoveToCounter": (2, 5),
    "CoffeeSetupMug": (2, 3),
    "CoffeeServeMug": (0, 1),
}


def test_policy_table_matches_jax():
    assert list(TASK_POLICIES) == list(JAX_POLICIES)
    assert all(TASK_POLICIES[t].__name__ == JAX_POLICIES[t].__name__ for t in TASK_POLICIES)
    assert sorted(RELIABLE) == sorted(SINGLE_STAGE_TASK_DATASETS)
    with pytest.raises(KeyError, match="no scripted policy"):
        make_scripted_policy("PnP", None)


def assert_expert_bit_equal_to_jax(task: str, seed: int, max_steps: int = 1700):
    """Run the port's and JAX's experts for ``task`` at ``seed`` in
    lockstep: every action, observation, reward, info and ``finished`` flag
    equal; both succeed at the same step."""
    penv, jenv = REGISTERED_KITCHEN_ENVS[task](seed=seed), JAX_ENVS[task](seed=seed)
    po, jo = penv.reset(), jenv.reset()
    ppol, jpol = make_scripted_policy(task, penv), jax_policy(task, jenv)
    assert type(ppol).__name__ == type(jpol).__name__
    success = False
    for _ in range(max_steps):
        pa, ja = ppol.get_action(po), jpol.get_action(jo)
        assert np.asarray(pa).dtype == np.asarray(ja).dtype
        assert np.array_equal(pa, ja)
        (po, pr, _, pi), (jo, jr, _, ji) = penv.step(pa), jenv.step(ja)
        for k in jo:
            assert np.array_equal(po[k], jo[k]), k
        assert (pr, pi) == (jr, ji)
        assert ppol.finished == jpol.finished
        if ji["is_success"]["task"]:
            success = True
            break
        if jpol.finished:
            break
    success = success or jenv.is_success()["task"]
    assert penv.is_success() == jenv.is_success()
    assert success, f"{task} expert failed on seed {seed}"
    penv.close()
    jenv.close()


@pytest.mark.parametrize("task,seed", [(t, s) for t, seeds in sorted(RELIABLE.items())
                                       for s in seeds])
def test_expert_bit_equal_to_jax(task, seed):
    assert_expert_bit_equal_to_jax(task, seed)
