"""ACT experiment generator (reference config_gen/act_gen.py).

The port's twin of ``lipvq_tpu/scripts/config_gen/act_gen.py``.
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
        base_config_file=os.path.join(TEMPLATE_DIR, "act.json"),
        wandb_proj_name=f"act_{args.name}",
    )
    generator.add_param("algo/act/chunk_size", "chunk", group=1, values=[10])
    return generator


def main():
    args = get_argparser().parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
