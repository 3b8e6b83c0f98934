"""Nested-dict batch helpers (copy of the JAX-free part of
``lipvq_tpu/utils/tensor_utils.py``)."""

from __future__ import annotations

from collections import OrderedDict

import numpy as np


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
