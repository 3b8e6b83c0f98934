"""Nested-dict batch helpers (copy of the JAX-free part of
``lipvq_tpu/utils/tensor_utils.py``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


def pad_sequence_single(seq: np.ndarray, padding: tuple[int, int],
                        pad_same: bool = True, pad_values=0.0) -> np.ndarray:
    """Pad a [T, ...] array at the front/back of the time axis
    (reference pad_sequence semantics: repeat edge frames or constant)."""
    front, back = padding
    parts = []
    if front > 0:
        pad = np.repeat(seq[0:1], front, axis=0) if pad_same else np.full(
            (front,) + seq.shape[1:], pad_values, dtype=seq.dtype
        )
        parts.append(pad)
    parts.append(seq)
    if back > 0:
        pad = np.repeat(seq[-1:], back, axis=0) if pad_same else np.full(
            (back,) + seq.shape[1:], pad_values, dtype=seq.dtype
        )
        parts.append(pad)
    return np.concatenate(parts, axis=0) if len(parts) > 1 else seq


def stack_collate(items: list[dict]) -> dict:
    """Collate a list of nested sample dicts into batched arrays."""
    out: dict = OrderedDict()
    first = items[0]
    for k, v in first.items():
        if isinstance(v, dict):
            out[k] = stack_collate([it[k] for it in items])
        elif v is None:
            out[k] = None
        else:
            out[k] = np.stack([np.asarray(it[k]) for it in items], axis=0)
    return out
