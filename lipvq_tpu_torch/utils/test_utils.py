"""Test fixtures (counterpart of ``lipvq_tpu/utils/test_utils.py``).

``make_synthetic_export`` writes the JAX fixture's synthetic dataset
(``make_synthetic_dataset``: smooth sinusoid trajectories, robomimic
schema) straight into a numpy export (``data/export.py``): it makes the
same numpy RNG calls in the same order, so its arrays equal the HDF5
fixture's, and it needs no ``h5py``. Camera keys (``image_key_shapes``)
add seeded uint8 frames from a generator of their own, so the other arrays
stay the fixture's.
"""

from __future__ import annotations

import json

import numpy as np

from lipvq_tpu_torch.data.export import ExportWriter


def make_synthetic_export(
    root: str,
    n_demos: int = 10,
    demo_len: int = 40,
    action_dim: int = 12,
    obs_key_shapes: dict | None = None,
    lang: str = "pick the object and place it in the sink",
    seed: int = 0,
    image_key_shapes: dict | None = None,
    transitions: bool = False,
) -> str:
    """Write a synthetic export with smooth sinusoid trajectories (and, for
    ``image_key_shapes`` {key: (H, W, C)}, uniform uint8 frames). With
    ``transitions`` each demo also gets ``next_obs/<key>`` (the obs shifted
    by one step, the last repeated, as the JAX package's ``write_demos``
    stores them) and a sparse success: reward 1 and done at its last step,
    for the offline-RL and hierarchical algorithms."""
    obs_key_shapes = obs_key_shapes or {
        "robot0_eef_pos": (3,),
        "robot0_eef_quat": (4,),
        "robot0_gripper_qpos": (2,),
        "object": (14,),
    }
    rng = np.random.default_rng(seed)
    frames = np.random.default_rng([seed, 1])
    writer = ExportWriter(root)
    env_args = {"env_name": "SyntheticKitchen", "type": 1, "env_kwargs": {}}
    total = 0
    for d in range(n_demos):
        t = np.arange(demo_len, dtype=np.float32)[:, None]
        phase = rng.uniform(0, 2 * np.pi, (1, action_dim)).astype(np.float32)
        freq = rng.uniform(0.05, 0.2, (1, action_dim)).astype(np.float32)
        arrays = {
            "actions": 0.8 * np.sin(freq * t + phase).astype(np.float32),
            "rewards": np.zeros(demo_len, np.float32),
            "dones": np.zeros(demo_len, np.float32),
            "states": rng.standard_normal((demo_len, 32)).astype(np.float32),
        }
        for k, shape in obs_key_shapes.items():
            ph = rng.uniform(0, 2 * np.pi, (1,) + tuple(shape)).astype(np.float32)
            fr = rng.uniform(0.05, 0.2, (1,) + tuple(shape)).astype(np.float32)
            tt = t.reshape((demo_len,) + (1,) * len(shape))
            arrays[f"obs/{k}"] = np.cos(fr * tt + ph).astype(np.float32)
        for k, shape in (image_key_shapes or {}).items():
            arrays[f"obs/{k}"] = frames.integers(0, 256, (demo_len, *shape), dtype=np.uint8)
        if transitions:
            for k in list(arrays):
                if k.startswith("obs/"):
                    obs = arrays[k]
                    arrays[f"next_{k}"] = np.concatenate([obs[1:], obs[-1:]], axis=0)
            arrays["rewards"][-1] = arrays["dones"][-1] = 1.0
        writer.add_demo(f"demo_{d}", {"num_samples": demo_len,
                                      "ep_meta": json.dumps({"lang": lang})}, arrays)
        total += demo_len
    names = [f"demo_{d}" for d in range(n_demos)]
    return writer.finish(
        {"env_args": json.dumps(env_args), "total": total},
        {"train": names[: max(1, n_demos - 2)], "valid": names[max(1, n_demos - 2):]})


def icl_test_config_overrides(debug_size: bool = True) -> dict:
    """Tiny ICL config for 3-step smoke trainings (reference
    test_utils.get_base_config:104-152)."""
    d = {
        "train": {
            "batch_size": 8,
            "seq_length": 10,
            "frame_stack": 10,
            "num_epochs": 1,
            "max_grad_norm": 100.0,
            "hdf5_cache_mode": "all",
        },
        "experiment": {
            "epoch_every_n_steps": 3,
            "validation_epoch_every_n_steps": 2,
            "validate": True,
            "rollout": {"enabled": False, "n": 1, "horizon": 10, "rate": 1},
            "save": {"enabled": True, "every_n_epochs": 1},
            "logging": {"terminal_output_to_txt": False, "log_tb": False},
        },
        "algo": {
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True,
                "supervise_all_steps": True,
                "pred_future_acs": True,
                "causal": False,
                "embed_dim": 64,
                "num_layers": 2,
                "num_heads": 4,
                "vq_vae_enabled": True,
                "ln_act_enabled": False,
            },
            "vq": {"num_codes": 32},
        },
        "observation": {
            "modalities": {
                "obs": {
                    "low_dim": [
                        "robot0_eef_pos",
                        "robot0_eef_quat",
                        "robot0_gripper_qpos",
                        "object",
                        "lang_emb",
                    ],
                    "rgb": [],
                }
            }
        },
    }
    return d
