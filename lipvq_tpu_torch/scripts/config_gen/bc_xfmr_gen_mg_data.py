"""BC transformer generator over MimicGen datasets.

Counterpart of reference scripts/config_gen/bc_xfmr_gen_mg_data.py:
same template as bc_xfmr_gen but trains on the machine-generated
3000-demo corpora (``ds_type="mg_im"``, filter_key ``3000_demos``),
one generator run per task (the paper's MimicGen workflow).

The port's twin of ``lipvq_tpu/scripts/config_gen/bc_xfmr_gen_mg_data.py``.
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


def make_generator_helper(args):
    generator = ConfigGenerator(
        base_config_file=os.path.join(TEMPLATE_DIR, "bc.json"),
        wandb_proj_name=f"bc_mg_{args.name}",
    )
    ds = get_robocasa_ds(
        args.task, ds_types=("mg_im",), filter_key="3000_demos"
    )
    generator.add_param(
        "train/data", "ds", group=1, values=[ds], value_names=["mg-3000"]
    )
    return generator


def main():
    args = get_argparser().parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
