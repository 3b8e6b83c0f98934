"""ICL-Mamba experiment generator (reference config_gen/icl_mamba_gen.py).

The port's twin of ``lipvq_tpu/scripts/config_gen/icl_mamba_gen.py``.
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
        base_config_file=os.path.join(TEMPLATE_DIR, "icl_mamba.json"),
        wandb_proj_name=f"icl_mamba_{args.name}",
    )
    flags = {f"algo/mamba/{t}_enabled": False
             for t in ("vq_vae", "bin", "fast", "ln_act")}
    if args.tokenizer != "raw":
        flags[f"algo/mamba/{args.tokenizer}_enabled"] = True
    for key, val in flags.items():
        generator.add_param(key, "", group=0, values=[val])
    return generator


def main():
    parser = get_argparser()
    parser.add_argument(
        "--tokenizer", type=str, default="vq_vae",
        choices=["vq_vae", "bin", "fast", "ln_act", "raw"],
    )
    args = parser.parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
