"""MCR experiment generator (reference config_gen/mcr_gen.py).

The port's twin of ``lipvq_tpu/scripts/config_gen/mcr_gen.py``.
"""

from __future__ import annotations

import os

from lipvq_tpu_torch.scripts.config_gen.config_gen_utils import (
    TEMPLATE_DIR,
    get_argparser,
    make_generator,
)
from lipvq_tpu_torch.utils.hyperparam_utils import ConfigGenerator


def make_generator_helper(args):
    generator = ConfigGenerator(
        base_config_file=os.path.join(TEMPLATE_DIR, "mcr.json"),
        wandb_proj_name=f"mcr_{args.name}",
    )
    if args.mcr_ckpt:
        generator.add_param(
            "algo/mcr/pretrained_ckpt", "", group=0, values=[args.mcr_ckpt]
        )
    return generator


def main():
    parser = get_argparser()
    parser.add_argument("--mcr_ckpt", type=str, default=None)
    args = parser.parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
