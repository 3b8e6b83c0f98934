"""Diffusion Policy experiment generator
(reference config_gen/diffusion_gen.py).

The port's twin of ``lipvq_tpu/scripts/config_gen/diffusion_gen.py``.
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
        base_config_file=os.path.join(TEMPLATE_DIR, "diffusion_policy.json"),
        wandb_proj_name=f"diffusion_{args.name}",
    )
    generator.add_param("train/seq_length", "", group=0, values=[16])
    generator.add_param("train/frame_stack", "", group=0, values=[2])
    return generator


def main():
    args = get_argparser().parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
