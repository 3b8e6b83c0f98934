"""Shared helpers for the config-generation CLIs.

Capability parity with reference scripts/config_gen/config_gen_utils.py
(13-694): ``make_generator`` builds a ConfigGenerator from a template +
CLI args, applying environment settings (robocasa action_config, obs key
lists, FiLM image encoders, crop randomizer, rollout protocol), modality
settings (im vs ld), debug mode, seeds and wandb — then emits configs +
a runner script.

The port's twin of ``lipvq_tpu/scripts/config_gen/config_gen_utils.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from lipvq_tpu_torch.robocasa.dataset_registry import (
    get_ds_path,
    get_task_horizon,
)

TEMPLATE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
    ),
    "exps", "templates",
)

# robocasa low-dim + image obs key sets (reference config_gen_utils.py:106-140)
ROBOCASA_LOWDIM_KEYS = [
    "robot0_base_pos",
    "robot0_base_quat",
    "robot0_eef_pos",
    "robot0_eef_quat",
    "robot0_gripper_qpos",
    "robot0_base_to_eef_pos",
    "robot0_base_to_eef_quat",
    "object",
    "lang_emb",
]
ROBOCASA_IMAGE_KEYS = [
    "robot0_agentview_left_image",
    "robot0_agentview_right_image",
    "robot0_eye_in_hand_image",
]

# robocasa action_config (reference config_gen_utils.py:46-87)
ROBOCASA_ACTION_CONFIG = {
    "actions": {"normalization": None},
    "action_dict/abs_pos": {"normalization": "min_max"},
    "action_dict/abs_rot_axis_angle": {
        "normalization": "min_max", "format": "rot_axis_angle",
    },
    "action_dict/abs_rot_6d": {"normalization": None, "format": "rot_6d"},
    "action_dict/rel_pos": {"normalization": None},
    "action_dict/rel_rot_axis_angle": {
        "normalization": None, "format": "rot_axis_angle",
    },
    "action_dict/rel_rot_6d": {"normalization": None, "format": "rot_6d"},
    "action_dict/gripper": {"normalization": None},
    "action_dict/base_mode": {"normalization": None},
}


def get_robocasa_ds(tasks, ds_types=("human_im",), src_ds_names=None,
                    filter_key=None, eval_horizon=None):
    """Dataset spec list for train.data (reference get_robocasa_ds:429-482)."""
    out = []
    for task in tasks:
        for ds_type in ds_types:
            path = get_ds_path(task, ds_type)
            out.append(
                {
                    "path": path,
                    "horizon": eval_horizon or get_task_horizon(task),
                    "filter_key": filter_key,
                }
            )
    return out


def set_env_settings(cfg: dict, env: str = "robocasa", mod: str = "ld",
                     abs_actions: bool = False):
    """Apply env-specific obs/action settings
    (reference set_env_settings:43-203)."""
    if env != "robocasa":
        return cfg
    obs = cfg.setdefault("observation", {}).setdefault("modalities", {})
    obs_group = obs.setdefault("obs", {})
    obs_group["low_dim"] = list(ROBOCASA_LOWDIM_KEYS)
    obs_group["rgb"] = list(ROBOCASA_IMAGE_KEYS) if mod == "im" else []

    train = cfg.setdefault("train", {})
    if abs_actions:
        train["action_keys"] = [
            "action_dict/abs_pos", "action_dict/abs_rot_6d",
            "action_dict/gripper", "action_dict/base_mode",
        ]
    else:
        train["action_keys"] = ["actions"]
    train["action_config"] = json.loads(json.dumps(ROBOCASA_ACTION_CONFIG))

    enc = cfg.setdefault("observation", {}).setdefault("encoder", {})
    rgb = enc.setdefault("rgb", {})
    if mod == "im":
        # FiLM language-conditioned visual cores + 116x116 crop randomizer
        # (reference config_gen_utils.py:89-105, 141-149)
        rgb["core_class"] = "VisualCoreLanguageConditioned"
        rgb["core_kwargs"] = {
            "feature_dimension": 64,
            "backbone_class": "ResNet18ConvFiLM",
            "pool_class": "SpatialSoftmax",
            "pool_kwargs": {"num_kp": 32},
        }
        rgb["obs_randomizer_class"] = "CropRandomizer"
        rgb["obs_randomizer_kwargs"] = {
            "crop_height": 116, "crop_width": 116,
            "num_crops": 1, "pos_enc": False,
        }
    # rollout protocol (reference :150-164)
    exp = cfg.setdefault("experiment", {})
    exp.setdefault("rollout", {}).update(n=50, horizon=500, rate=100)
    return cfg


def set_mod_settings(cfg: dict, mod: str = "ld"):
    """Train protocol per modality (reference set_mod_settings:206-259)."""
    train = cfg.setdefault("train", {})
    exp = cfg.setdefault("experiment", {})
    if mod == "im":
        train["batch_size"] = 16
        train["num_epochs"] = 1000
        train["num_data_workers"] = 5
        train["hdf5_cache_mode"] = None
        exp["epoch_every_n_steps"] = 500
    else:
        train["batch_size"] = 100
        train["num_epochs"] = 2000
        exp["epoch_every_n_steps"] = 100
    return cfg


def set_debug_mode(cfg: dict):
    """3-step debug config (reference set_debug_mode:261-300)."""
    exp = cfg.setdefault("experiment", {})
    exp["epoch_every_n_steps"] = 3
    exp["validation_epoch_every_n_steps"] = 3
    exp.setdefault("rollout", {}).update(n=2, horizon=30, rate=1)
    exp.setdefault("save", {})["every_n_epochs"] = 1
    cfg.setdefault("train", {})["num_epochs"] = 2
    return cfg


def get_argparser() -> argparse.ArgumentParser:
    """Shared CLI flags (reference config_gen_utils.py:485-566)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--name", type=str, required=True)
    parser.add_argument("--env", type=str, default="robocasa")
    parser.add_argument("--mod", type=str, default="ld", choices=["ld", "im"])
    parser.add_argument("--task", type=str, nargs="+",
                        default=["PnPCounterToCab"])
    parser.add_argument("--ds_type", type=str, default="human_im")
    parser.add_argument("--abs_actions", action="store_true")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument("--n_seeds", type=int, default=1)
    parser.add_argument("--output_dir", type=str, default="expdata")
    return parser


def make_generator(args, make_generator_helper):
    """Full flow (reference make_generator:569-640): helper builds a
    generator from a template; env/mod/debug settings are applied to the
    base config; generate() emits configs + runner script."""
    generator = make_generator_helper(args)

    with open(generator.base_config_file) as f:
        cfg = json.load(f)

    datasets = get_robocasa_ds(args.task, ds_types=(args.ds_type,))
    if len(datasets) == 1:
        cfg.setdefault("train", {})["data"] = datasets[0]["path"]
    else:
        # multi-task training: list spec -> weighted MetaDataset
        cfg.setdefault("train", {})["data"] = [
            {"path": d["path"], "filter_key": d["filter_key"]}
            for d in datasets
        ]
    cfg.setdefault("experiment", {}).setdefault("rollout", {})[
        "horizon"
    ] = datasets[0]["horizon"]
    set_env_settings(cfg, env=args.env, mod=args.mod,
                     abs_actions=args.abs_actions)
    set_mod_settings(cfg, mod=args.mod)
    if args.debug:
        set_debug_mode(cfg)
    cfg["experiment"]["name"] = args.name
    if args.no_wandb:
        cfg["experiment"].setdefault("logging", {})["log_wandb"] = False

    stamped = os.path.join(
        args.output_dir, "configs",
        f"{args.name}_{time.strftime('%Y%m%d')}_base.json",
    )
    os.makedirs(os.path.dirname(stamped), exist_ok=True)
    with open(stamped, "w") as f:
        json.dump(cfg, f, indent=4)
    generator.base_config_file = stamped
    generator.generated_config_dir = os.path.join(
        args.output_dir, "configs", args.name
    )
    generator.script_file = os.path.join(
        args.output_dir, f"run_{args.name}.sh"
    )

    if args.n_seeds > 1:
        generator.add_param(
            "train/seed", "seed", group=9999,
            values=list(range(1, args.n_seeds + 1)),
        )
    paths = generator.generate()
    print(f"generated {len(paths)} configs; runner: {generator.script_file}")
    return paths
