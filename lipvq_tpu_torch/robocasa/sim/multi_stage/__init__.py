"""Multi-stage (composite) kitchen activities.

One module per activity group, mirroring reference
robocasa/environments/kitchen/multi_stage/ (20 activity directories,
86 task classes). Importing this package registers every task class in
REGISTERED_KITCHEN_ENVS via Kitchen.__init_subclass__.

The port's copy of ``lipvq_tpu/robocasa/sim/multi_stage/``: each module
is a statement-for-statement copy of its namesake there (only the
imports and docstrings differ), so the same seed gives bit-equal
scenes, observations and states in both packages
(``tests/test_torch_port_kitchen_multi_*.py``). Every module imports
without ``mujoco``; building a task then raises
``ModuleNotFoundError`` (``Kitchen.__init__``).
"""

from lipvq_tpu_torch.robocasa.sim.multi_stage.baking import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.boiling import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.brewing import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.chopping_food import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.clearing_table import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.defrosting_food import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.restocking_supplies import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.washing_dishes import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.frying import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.making_toast import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.meat_preparation import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.mixing_and_blending import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.reheating_food import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.sanitize_surface import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.serving_food import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.setting_the_table import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.snack_preparation import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.steaming_food import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.tidying_cabinets_and_drawers import *  # noqa: F401,F403
from lipvq_tpu_torch.robocasa.sim.multi_stage.washing_fruits_and_vegetables import *  # noqa: F401,F403
