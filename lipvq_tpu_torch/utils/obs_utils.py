"""Observation modality registry + processing (copy of
``lipvq_tpu/utils/obs_utils.py``).

Capability parity with the reference's ObsUtils
(reference: robomimic/utils/obs_utils.py): a process-wide registry mapping
observation keys -> modalities (built once from config before model
construction, obs_utils.py:229-254), per-modality process/unprocess
transforms (rgb uint8 -> float/255, obs_utils.py:366-447), and
normalization helpers (obs_utils.py:464-545).

Deviation kept from the JAX package: images are processed to **NHWC**
(channel-last) instead of the reference's CHW, so both packages feed
their visual cores the same layout.
"""

from __future__ import annotations

import numpy as np

from lipvq_tpu_torch.macros import LANG_EMB_KEY  # noqa: F401  (reference macros.py:19)

# ---------------------------------------------------------------------------
# registry (module-level, mirrors reference globals obs_utils.py:27-44)
# ---------------------------------------------------------------------------

OBS_KEYS_TO_MODALITIES: dict[str, str] = {}
OBS_MODALITIES_TO_KEYS: dict[str, list[str]] = {}
DEFAULT_ENCODER_KWARGS: dict[str, dict] = {}

LANG_EMB_DIM = 768  # CLIP ViT-L/14 text width (reference lang_utils.py)


def initialize_obs_utils_with_config(config) -> None:
    """Build the key->modality maps from config.observation.modalities
    (reference obs_utils.py:229)."""
    OBS_KEYS_TO_MODALITIES.clear()
    OBS_MODALITIES_TO_KEYS.clear()
    DEFAULT_ENCODER_KWARGS.clear()
    for group in config.observation.modalities.values():
        for modality, keys in group.items():
            OBS_MODALITIES_TO_KEYS.setdefault(modality, [])
            for k in keys:
                OBS_KEYS_TO_MODALITIES[k] = modality
                if k not in OBS_MODALITIES_TO_KEYS[modality]:
                    OBS_MODALITIES_TO_KEYS[modality].append(k)
    for modality, enc_cfg in config.observation.encoder.items():
        DEFAULT_ENCODER_KWARGS[modality] = enc_cfg.to_dict()


def register_obs_keys(mapping: dict[str, str]) -> None:
    """Directly register key->modality (tests / programmatic use)."""
    OBS_KEYS_TO_MODALITIES.update(mapping)


def encoder_cores_from_config(obs_config, obs_shapes: dict) -> tuple:
    """Build the ((key, core_spec_str), ...) encoder-core spec consumed by
    ObservationEncoder from config.observation.encoder (the counterpart of
    reference obs_encoder_kwargs_from_config, obs_utils.py:254+).

    rgb keys get a VisualCore spec string encoding feature_dimension,
    keypoints, crop randomizer settings and FiLM conditioning (robocasa
    image config: FiLM ResNet18 + SpatialSoftmax + 116x116 crop —
    reference config_gen_utils.py:89-149).
    """
    cores = []
    for key, shape in obs_shapes.items():
        modality = OBS_KEYS_TO_MODALITIES.get(key)
        if modality != "rgb" or len(tuple(shape)) < 3:
            continue
        enc = obs_config.encoder.get("rgb", {})
        core_class = enc.get("core_class", "VisualCore") or "VisualCore"
        ck = enc.get("core_kwargs", {}) or {}
        kwargs = {
            "feature_dimension": int(ck.get("feature_dimension", 64) or 64),
            "num_kp": int(
                (ck.get("pool_kwargs", {}) or {}).get("num_kp", 32) or 32
            ),
        }
        backbone = ck.get("backbone_class", None)
        if backbone:
            kwargs["backbone"] = str(backbone)
        rand_cls = enc.get("obs_randomizer_class", None)
        rk = enc.get("obs_randomizer_kwargs", {}) or {}
        if rand_cls == "CropRandomizer":
            kwargs["crop_height"] = int(rk.get("crop_height", 76))
            kwargs["crop_width"] = int(rk.get("crop_width", 76))
            kwargs["num_crops"] = int(rk.get("num_crops", 1))
        elif rand_cls == "ColorRandomizer":
            kwargs["color_jitter"] = 1
        elif rand_cls == "GaussianNoiseRandomizer":
            kwargs["gaussian_noise"] = 1
        arg_str = ",".join(f"{k}={v}" for k, v in kwargs.items())
        cores.append((key, f"{core_class}:{arg_str}"))
    return tuple(cores)


def key_is_obs_modality(key: str, modality: str) -> bool:
    return OBS_KEYS_TO_MODALITIES.get(key) == modality


# ---------------------------------------------------------------------------
# per-modality processing (host-side numpy)
# ---------------------------------------------------------------------------

def process_frame(frame, channel_dim=3, scale=255.0):
    """uint8 [..., H, W, C] -> float32 [..., H, W, C] in [0, 1] (NHWC)."""
    frame = np.asarray(frame, dtype=np.float32)
    if scale:
        frame = frame / scale
    return frame


def process_obs(obs, obs_key: str | None = None, obs_modality: str | None = None):
    """Prepare a raw observation for network input (reference
    obs_utils.py:352-380)."""
    if obs_modality is None:
        obs_modality = OBS_KEYS_TO_MODALITIES.get(obs_key, "low_dim")
    if obs_modality in ("rgb", "depth"):
        return process_frame(obs)
    return np.asarray(obs, dtype=np.float32)


def process_obs_for_device(obs, obs_key: str | None = None):
    """``process_obs`` for a batch an algo copies to its device: a uint8
    rgb or depth frame stays uint8 (a quarter of the bytes to copy) and the
    algo's ``_put_infer`` divides it by 255 there, bit-equal to
    ``process_frame``."""
    obs = np.asarray(obs)
    modality = OBS_KEYS_TO_MODALITIES.get(obs_key, "low_dim")
    if modality in ("rgb", "depth") and obs.dtype == np.uint8:
        return np.ascontiguousarray(obs)
    return process_obs(obs, obs_key=obs_key)


def process_obs_dict(obs_dict: dict) -> dict:
    return {
        k: process_obs(v, obs_key=k) for k, v in obs_dict.items() if v is not None
    }


def unprocess_obs(obs, obs_key: str | None = None, obs_modality: str | None = None):
    if obs_modality is None:
        obs_modality = OBS_KEYS_TO_MODALITIES.get(obs_key, "low_dim")
    if obs_modality in ("rgb",):
        return (np.asarray(obs) * 255.0).astype(np.uint8)
    return np.asarray(obs)


# ---------------------------------------------------------------------------
# normalization (reference obs_utils.py:464-545)
# ---------------------------------------------------------------------------

def normalize_dict(d: dict, normalization_stats: dict) -> dict:
    """normalized = (x - offset) / scale, per key with stats."""
    out = dict(d)
    for k, stats in normalization_stats.items():
        if k not in out or out[k] is None:
            continue
        offset = np.asarray(stats["offset"], np.float32)
        scale = np.asarray(stats["scale"], np.float32)
        out[k] = (np.asarray(out[k], np.float32) - offset) / scale
    return out


def unnormalize_dict(d: dict, normalization_stats: dict) -> dict:
    """raw = x * scale + offset."""
    out = dict(d)
    for k, stats in normalization_stats.items():
        if k not in out or out[k] is None:
            continue
        offset = np.asarray(stats["offset"], np.float32)
        scale = np.asarray(stats["scale"], np.float32)
        out[k] = np.asarray(out[k], np.float32) * scale + offset
    return out
