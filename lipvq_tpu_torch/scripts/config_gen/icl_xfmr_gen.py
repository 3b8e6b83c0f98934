"""ICL transformer experiment generator.

Counterpart of reference scripts/config_gen/icl_xfmr_gen.py:4-60 — the
README "Policy Learning" entry point. Sweeps the four action-tokenizer
switches as named variants; run with e.g.:

    python -m lipvq_tpu_torch.scripts.config_gen.icl_xfmr_gen --name lipvq \
        --env robocasa --mod ld --tokenizer vq_vae --debug

The port's twin of ``lipvq_tpu/scripts/config_gen/icl_xfmr_gen.py``.
"""

from __future__ import annotations

import os

from lipvq_tpu_torch.scripts.config_gen.config_gen_utils import (
    TEMPLATE_DIR,
    get_argparser,
    make_generator,
)
from lipvq_tpu_torch.utils.hyperparam_utils import ConfigGenerator

TOKENIZER_FLAGS = ["vq_vae", "bin", "fast", "ln_act", "raw"]


def make_generator_helper(args):
    generator = ConfigGenerator(
        base_config_file=os.path.join(TEMPLATE_DIR, "icl_transformer.json"),
        wandb_proj_name=f"icl_{args.name}",
    )
    flags = {f"algo/transformer/{t}_enabled": False
             for t in ("vq_vae", "bin", "fast", "ln_act")}
    tok = args.tokenizer
    if tok != "raw":
        flags[f"algo/transformer/{tok}_enabled"] = True
    for key, val in flags.items():
        generator.add_param(key, "", group=0, values=[val])
    generator.add_param(
        "algo/transformer/context_length", "", group=0, values=[10]
    )
    return generator


def main():
    parser = get_argparser()
    parser.add_argument(
        "--tokenizer", type=str, default="vq_vae", choices=TOKENIZER_FLAGS
    )
    args = parser.parse_args()
    make_generator(args, make_generator_helper)


if __name__ == "__main__":
    main()
