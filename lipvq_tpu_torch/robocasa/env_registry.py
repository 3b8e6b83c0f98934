"""Kitchen environment registry (the port's copy of
``lipvq_tpu/robocasa/env_registry.py``; reference
robocasa/environments/kitchen/kitchen.py:46-74).

``REGISTERED_KITCHEN_ENVS`` maps every dataset-registry task (SURVEY.md
§2.2) to a constructor of its ``EnvKitchen`` (the first-party MuJoCo
kitchen), plus the hermetic ``SyntheticKitchen``;
``ALL_KITCHEN_ENVIRONMENTS`` is the sorted view the validity tests use
(reference tests/test_tasks_validity.py:5).
"""

from __future__ import annotations

from collections import OrderedDict

from lipvq_tpu_torch.robocasa.dataset_registry import ALL_TASK_DATASETS

REGISTERED_KITCHEN_ENVS: dict = {}


def register_kitchen_env(name: str, factory=None):
    """Register a kitchen env constructor (reference kitchen.py:49-50)."""

    def decorator(fn):
        REGISTERED_KITCHEN_ENVS[name] = fn
        return fn

    if factory is not None:
        REGISTERED_KITCHEN_ENVS[name] = factory
        return factory
    return decorator


def _make_task_factory(task_name: str):
    def factory(**kwargs):
        # first-party MuJoCo kitchen sim (lipvq_tpu/robocasa/sim)
        from lipvq_tpu_torch.envs.env_kitchen import EnvKitchen

        return EnvKitchen(task_name, **kwargs)

    factory.__name__ = task_name
    return factory


# populate with the full RoboCasa task list
for _task in ALL_TASK_DATASETS:
    REGISTERED_KITCHEN_ENVS.setdefault(_task, _make_task_factory(_task))

# hermetic stand-in
def _synthetic_factory(**kwargs):
    from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv

    return SyntheticKitchenEnv(**kwargs)


REGISTERED_KITCHEN_ENVS.setdefault("SyntheticKitchen", _synthetic_factory)

ALL_KITCHEN_ENVIRONMENTS = OrderedDict(
    sorted(REGISTERED_KITCHEN_ENVS.items())
)
