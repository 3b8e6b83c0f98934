"""Weight bridge from the JAX package's flax params to the port's modules.

The port mirrors the flax module tree, so a flax path maps to a state_dict
key by joining with dots, with two renames:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (transposed);
- a LayerNorm ``scale`` becomes ``weight``.

Every other leaf (``bias``, LipschitzDense ``W``/``b``/``ci``, the
quantizer ``codebook``, ``embed_timestep``) keeps its name and layout. The
EMA codebook's ``vq_stats`` collection (``ema_cluster_size``,
``ema_embed_sum``) maps onto the tokenizer's buffers of the same names. The
bridge takes the trees as numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side), so this module imports no JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def state_dict_from_jax_params(params_np: Mapping) -> dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> {state_dict key: fp32 tensor}."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            elif key == "scale":
                key = "weight"
            out[".".join(prefix + (key,))] = torch.tensor(arr)

    walk(params_np, ())
    return out


def load_jax_params(algo, params_np: Mapping, extra_vars_np: Mapping | None = None) -> None:
    """Load the JAX algo's ``state.params`` and, with the EMA codebook, its
    ``state.extra_vars`` (``{"vq_stats": ...}``), as numpy, into
    ``algo.nets``. Every key must match: a missing or extra parameter or
    buffer raises."""
    state = state_dict_from_jax_params(params_np)
    for collection, tree in (extra_vars_np or {}).items():
        if collection != "vq_stats":
            raise KeyError(f"the port has no counterpart of the {collection!r} collection")
        stats = state_dict_from_jax_params(tree)
        if stats.keys() & state.keys():
            raise KeyError(f"vq_stats repeats parameter keys {sorted(stats.keys() & state.keys())}")
        state.update(stats)
    algo.nets.load_state_dict(state, strict=True)
