"""Hyperparameter sweep starter script.

Counterpart of ``lipvq_tpu/scripts/hyperparam_helper.py`` (reference
scripts/hyperparam_helper.py:1-141) — the
documented example of building a :class:`ConfigGenerator` sweep by
hand (outside the config_gen CLI wrappers): take a base config json,
register swept parameters (same ``group`` => values move together),
and emit one config per combination plus a runner script.

    python -m lipvq_tpu_torch.scripts.hyperparam_helper \\
        --config exps/templates/icl_transformer.json --script /tmp/run.sh
"""

from __future__ import annotations

import argparse
import os

from lipvq_tpu_torch.utils.hyperparam_utils import ConfigGenerator


def make_generator(config_file: str, script_file: str) -> ConfigGenerator:
    """The reference's example sweep (hyperparam_helper.py:50-110):
    learning rate x GMM on/off x RNN/transformer width, grouped so lr
    and its name sweep together."""
    generator = ConfigGenerator(
        base_config_file=config_file,
        script_file=script_file,
        generated_config_dir=os.path.join(
            os.path.dirname(os.path.abspath(script_file)), "configs"
        ),
    )
    generator.add_param(
        key="algo/optim_params/policy/learning_rate/initial",
        name="plr",
        group=0,
        values=[1e-3, 1e-4],
    )
    generator.add_param(
        key="algo/gmm/enabled",
        name="gmm",
        group=1,
        values=[True, False],
        value_names=["t", "f"],
    )
    generator.add_param(
        key="algo/transformer/embed_dim",
        name="width",
        group=2,
        values=[256, 512],
    )
    return generator


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="base config json")
    parser.add_argument("--script", type=str, required=True,
                        help="runner script path to generate")
    args = parser.parse_args(args)
    generator = make_generator(args.config, args.script)
    paths = generator.generate()
    print(f"generated {len(paths)} configs; runner: {args.script}")
    return paths


if __name__ == "__main__":
    main()
