"""MuJoCo-direct kitchen simulation layer (counterpart of
``lipvq_tpu/robocasa/sim/__init__.py``; reference robocasa L0).

A procedural rebuild of the RoboCasa kitchen environments on the
``mujoco`` runtime (no robosuite, no mesh or texture asset pack): fixtures
are primitive-geom builders over :class:`mujoco.MjSpec`, scenes are
assembled per layout and style id, and the robot is a floating-gripper
mobile base with robocasa's 12-dim action layout. ``docs/kitchen_sim.md``
lists the simplifications against the reference.

Importing this package registers the single-stage tasks and then the
multi-stage ones in ``REGISTERED_KITCHEN_ENVS``, in the JAX package's
order. Every module imports without ``mujoco``; building a kitchen then
raises ``ModuleNotFoundError`` (``Kitchen.__init__``).
"""

from lipvq_tpu_torch.robocasa.sim.fixtures import (  # noqa: F401
    FixtureType,
    Fixture,
    Counter,
    SingleCabinet,
    HingeCabinet,
    OpenCabinet,
    Drawer,
    Microwave,
    Sink,
    Stove,
    CoffeeMachine,
    Fridge,
    Dishwasher,
    Hood,
)
from lipvq_tpu_torch.robocasa.sim.kitchen import (  # noqa: F401
    Kitchen,
    REGISTERED_KITCHEN_ENVS,
    register_kitchen_env,
)

# importing the task modules populates REGISTERED_KITCHEN_ENVS
# (reference robocasa/environments/kitchen/__init__.py)
from lipvq_tpu_torch.robocasa.sim import single_stage as _single_stage  # noqa: E402,F401
from lipvq_tpu_torch.robocasa.sim import multi_stage as _multi_stage  # noqa: E402,F401
