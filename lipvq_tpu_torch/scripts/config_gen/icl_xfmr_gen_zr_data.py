"""ICL transformer generator for the zero-shot (held-out task) split.

Counterpart of reference scripts/config_gen/icl_xfmr_gen_zr_data.py:
train on the 8 demo task families and evaluate zero-shot on the
remaining atomic tasks (reference demo_tasks/eval_tasks split).

The port's twin of ``lipvq_tpu/scripts/config_gen/icl_xfmr_gen_zr_data.py``.
"""

from __future__ import annotations

import os

from lipvq_tpu_torch.scripts.config_gen.config_gen_utils import (
    TEMPLATE_DIR,
    get_argparser,
    get_robocasa_ds,
    make_generator,
)
from lipvq_tpu_torch.utils.hyperparam_utils import ConfigGenerator

# reference icl_xfmr_gen_zr_data.py demo_tasks
DEMO_TASKS = [
    "PnPCounterToCab",
    "PnPCounterToSink",
    "OpenSingleDoor",
    "OpenDrawer",
    "TurnOnSinkFaucet",
    "CoffeePressButton",
    "TurnOnMicrowave",
    "TurnOnStove",
]

ALL_TASKS = [
    "PnPCounterToCab", "PnPCabToCounter", "PnPCounterToSink",
    "PnPSinkToCounter", "PnPCounterToMicrowave", "PnPMicrowaveToCounter",
    "PnPCounterToStove", "PnPStoveToCounter", "OpenSingleDoor",
    "CloseSingleDoor", "OpenDoubleDoor", "CloseDoubleDoor", "OpenDrawer",
    "CloseDrawer", "TurnOnSinkFaucet", "TurnOffSinkFaucet", "TurnSinkSpout",
    "TurnOnStove", "TurnOffStove", "CoffeeSetupMug", "CoffeeServeMug",
    "CoffeePressButton",
]

EVAL_TASKS = [t for t in ALL_TASKS if t not in DEMO_TASKS]


def make_generator_helper(args):
    generator = ConfigGenerator(
        base_config_file=os.path.join(TEMPLATE_DIR, "icl_transformer.json"),
        wandb_proj_name=f"icl_zr_{args.name}",
    )
    ds = get_robocasa_ds(DEMO_TASKS, filter_key="50_demos")
    generator.add_param(
        "train/data", "ds", group=1, values=[ds], value_names=["zr-demo8"]
    )
    # zero-shot: rollouts run on held-out envs (experiment.env override,
    # one config per eval task)
    generator.add_param(
        "experiment/env", "task", group=2, values=EVAL_TASKS,
        value_names=EVAL_TASKS,
    )
    return generator


def main():
    args = get_argparser().parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
