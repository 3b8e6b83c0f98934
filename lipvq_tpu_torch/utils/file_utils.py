"""Dataset metadata + self-describing checkpoints (counterpart of
``lipvq_tpu/utils/file_utils.py``).

- ``get_env_metadata_from_dataset`` / ``get_shape_metadata_from_dataset``
  read a dataset export (``data/export.py``);
- a checkpoint has the JAX payload's logical keys: {model, config,
  algo_name, lang_backend, env_metadata, shape_metadata,
  obs_normalization_stats, action_normalization_stats}. It is written with
  ``torch.save`` and read with ``torch.load(..., weights_only=True)``: it
  holds only tensors, strings, numbers, dicts, lists and None, so loading an
  untrusted file executes no code (the property of the JAX package's
  msgpack checkpoints). Normalization stats are stored as CPU tensors and
  unpacked to numpy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from lipvq_tpu_torch.data.export import Export


def get_env_metadata_from_dataset(dataset_path: str) -> dict:
    return json.loads(Export(dataset_path).data_attrs["env_args"])


def get_shape_metadata_from_dataset(
    dataset_path: str, all_obs_keys=None, action_keys=("actions",)
) -> dict:
    """Shapes of obs keys + action dim (reference file_utils.py:111-180)."""
    meta = {}
    f = Export(dataset_path)
    demo_id = sorted(f.demos, key=lambda e: int(e[5:]))[0]
    ac_dim = 0
    for k in action_keys:
        shape = f.shape(demo_id, k)
        ac_dim += 1 if len(shape) == 1 else int(shape[1])
    meta["ac_dim"] = ac_dim
    obs_shapes = {}
    # an HDF5 group lists its members by name
    keys = all_obs_keys or sorted(f.keys(demo_id, "obs"))
    for k in keys:
        if k == "lang_emb":
            obs_shapes[k] = [768]
            continue
        if f.has(demo_id, f"obs/{k}"):
            obs_shapes[k] = list(f.shape(demo_id, f"obs/{k}")[1:])
    meta["all_shapes"] = obs_shapes
    meta["all_obs_keys"] = list(obs_shapes.keys())
    meta["use_images"] = any(len(s) >= 3 for s in obs_shapes.values())
    return meta


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(
    path: str,
    model,
    config,
    env_meta: dict | None = None,
    shape_meta: dict | None = None,
    obs_normalization_stats: dict | None = None,
    action_normalization_stats: dict | None = None,
    lang_backend: str | None = None,
):
    """Self-describing checkpoint (reference train_utils.py:1186-1235).

    ``lang_backend`` records which language-embedding backend produced the
    dataset's lang_emb inputs."""
    payload = {
        "model": model.serialize(),
        "config": config.dump(),
        "algo_name": config.algo_name,
        "lang_backend": lang_backend or "",
        "env_metadata": json.dumps(env_meta or {}),
        "shape_metadata": json.dumps(_jsonable(shape_meta or {})),
        "obs_normalization_stats": _pack_stats(obs_normalization_stats),
        "action_normalization_stats": _pack_stats(action_normalization_stats),
    }
    torch.save(payload, path)


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


def _pack_stats(stats):
    if stats is None:
        return None
    return {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
            for k, v in stats.items()}


def _unpack_stats(packed):
    if not packed:
        return None
    return {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in packed.items()}


def load_checkpoint_dict(path: str) -> dict:
    """The checkpoint's payload, tensors on the CPU; executes no code."""
    return torch.load(path, map_location="cpu", weights_only=True)


def config_from_checkpoint(ckpt_dict: dict):
    from lipvq_tpu_torch.config import config_factory

    raw = json.loads(ckpt_dict["config"])
    algo_name = raw.pop("algo_name")
    return config_factory(algo_name, raw)


def policy_from_checkpoint(path: str, device=None):
    """Rebuild (algo, ckpt_dict) from a checkpoint (reference
    file_utils.py:396-463), the algo on ``device`` (CUDA when None; raises
    without a GPU). The observation modalities are registered from the
    checkpoint's config first, as the train script does, so an image
    policy gets its visual cores in a fresh process too (the JAX package
    skips this step)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.utils.obs_utils import initialize_obs_utils_with_config

    ckpt = load_checkpoint_dict(os.path.expanduser(path))
    config = config_from_checkpoint(ckpt)
    initialize_obs_utils_with_config(config)
    shape_meta = json.loads(ckpt["shape_metadata"])
    model = algo_factory(
        ckpt["algo_name"], config,
        obs_key_shapes=shape_meta["all_shapes"],
        ac_dim=shape_meta["ac_dim"],
        device=device,
    )
    model.deserialize(ckpt["model"])
    ckpt["action_normalization_stats_unpacked"] = _unpack_stats(
        ckpt.get("action_normalization_stats"))
    ckpt["obs_normalization_stats_unpacked"] = _unpack_stats(
        ckpt.get("obs_normalization_stats"))
    return model, ckpt
