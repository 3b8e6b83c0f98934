"""Nested-container tensor helpers (counterpart of
``lipvq_tpu/utils/tensor_utils.py``).

The helpers map over the leaves of nested dicts, lists and tuples of torch
tensors, as the JAX package's map over pytrees (``None`` stays ``None``);
``pad_sequence_single`` and ``stack_collate`` are copies of the JAX-free
batch helpers. ``to_jax`` has no counterpart.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import Callable

import numpy as np
import torch


def map_tensor(x, fn: Callable):
    """Apply ``fn`` to every leaf of a nested dict/list/tuple."""
    if isinstance(x, dict):
        return type(x)((k, map_tensor(v, fn)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a namedtuple
        return type(x)(*(map_tensor(v, fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(map_tensor(v, fn) for v in x)
    if x is None:
        return None
    return fn(x)


def _leaves_with_path(x, path=()):
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves_with_path(v, path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves_with_path(v, path + (i,))
    elif x is not None:
        yield path, x


def to_float32(x):
    """Floating leaves (tensors or arrays) to float32; others unchanged."""
    def cast(a):
        if isinstance(a, torch.Tensor):
            return a.float() if a.is_floating_point() else a
        if hasattr(a, "astype") and np.issubdtype(np.asarray(a).dtype, np.floating):
            return a.astype(np.float32)
        return a

    return map_tensor(x, cast)


def to_numpy(x):
    return map_tensor(x, lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else np.asarray(a))


def detach(x):
    return map_tensor(x, lambda a: a.detach())


def index_at_time(x, t: int):
    """Slice every [B, T, ...] leaf at time ``t`` -> [B, ...]."""
    return map_tensor(x, lambda a: a[:, t])


def slice_time(x, start: int, end: int):
    """Slice every [B, T, ...] leaf to [B, end-start, ...]."""
    return map_tensor(x, lambda a: a[:, start:end])


def join_dimensions(x, begin: int = 0, end: int = 1):
    """Merge dims [begin..end] of every leaf (reference join_dimensions)."""
    return map_tensor(x, lambda a: a.reshape(tuple(a.shape[:begin]) + (-1,)
                                             + tuple(a.shape[end + 1:])))


def reshape_dimensions(x, begin_axis: int, end_axis: int, target_dims):
    """Expand dims [begin..end] of every leaf into ``target_dims``."""
    return map_tensor(x, lambda a: a.reshape(tuple(a.shape[:begin_axis]) + tuple(target_dims)
                                             + tuple(a.shape[end_axis + 1:])))


def unsqueeze_expand_at(x, size: int, dim: int):
    """Insert a new axis at ``dim`` and tile it ``size`` times."""
    def _expand(a):
        a = a.unsqueeze(dim)
        reps = [1] * a.dim()
        reps[dim] = size
        return a.repeat(reps)

    return map_tensor(x, _expand)


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


def assert_size_at_dim(x, size: int, dim: int, msg: str = ""):
    for path, leaf in _leaves_with_path(x):
        if leaf.shape[dim] != size:
            raise ValueError(f"{msg} (got {tuple(leaf.shape)} at {path})")


def flatten_leading(x, n: int = 2):
    """[B, T, ...] -> [B*T, ...] for every leaf."""
    return map_tensor(x, lambda a: a.reshape((-1,) + tuple(a.shape[n:])))


def unflatten_leading(x, b: int, t: int):
    """[B*T, ...] -> [B, T, ...] for every leaf."""
    return map_tensor(x, lambda a: a.reshape((b, t) + tuple(a.shape[1:])))


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
