"""Weight bridge from the JAX package's flax params to the port's modules.

The port mirrors the flax module tree (layer lists such as the FAST arm's
``fast_proj_0..2`` or the VQ-VAEs' ``enc_0..2`` keep flax's names), so a
flax path maps to a state_dict key by joining with dots, with these renames:

- a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (transposed); a
  ``DenseGeneral`` kernel of more than two axes (the attention of the raw
  tokenizer and of ACT: query/key/value [D, H, Dh], out [H, Dh, D]) becomes
  ``weight`` in its flax layout;
- a convolution's ``kernel`` [*taps, in, out] (the visual cores' 2-D ones,
  the UNet's 1-D [K, in, out]) becomes ``weight`` [out, in, *taps]; a 1-D
  transposed convolution's (the UNet's ``Upsample1d``) [K, in, out] becomes
  ``weight`` [in, out, K] with its taps reversed (``base_nets.ConvTranspose``);
  the port's module at the tree's root tells the three apart;
- a LayerNorm or GroupNorm ``scale`` becomes ``weight``;
- a flax ``OptimizedLSTMCell`` (``ii``/``if``/``ig``/``io`` kernels [in, H],
  ``hi``/``hf``/``hg``/``ho`` kernels [H, H] and biases) becomes the port's
  packed cell: ``w_ih`` [4H, in], ``w_hh`` [4H, H] and ``b_hh`` [4H], the
  gates in the order i, f, g, o.

Every other leaf (``bias``, LipschitzDense ``W``/``b``/``ci``, the
quantizer ``codebook``, the VQ-VAEs' ``embedding`` table, ``embed_timestep``,
``embed_timestep_table``, ACT's ``cls_embed`` / ``enc_pos_embed`` /
``query_embed``, a learned VAE prior's ``prior_mu`` / ``prior_logvar`` /
``prior_logits``, the bin tokenizer's ``embedding_tables``, Mamba's
``conv_kernel``/``conv_bias``/``A_log``/``D``, the CLIP tower's
``token_embedding.embedding`` [V, H], ``position_embedding`` [P, H] and
``text_projection`` [H, proj]) keeps its name and layout. The mutable collections map onto
buffers of the same names: ``batch_stats`` (each BatchNorm's ``mean`` and
``var``), ``vq_stats`` (``ema_cluster_size``,
``ema_embed_sum``), ``bin_stats`` (``running_min``, ``running_max``, the
int32 ``num_step``) and ``spectral_stats`` (each spectral-norm layer's
``u``). Diffusion Policy's ``ema_params`` tree has the params tree's layout
and goes into the algo's ``ema_nets``; an offline-RL algo's
``target_params`` (a tree per tracked network: critic, actor,
perturbation) goes into the target buffers under ``nets.target``, and
HBC's and IRIS's parts load one by one (``load_jax_parts``). Integer leaves
keep their integer type. The bridge takes the trees as numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side), so this module
imports no JAX. ``mcr_checkpoint_from_msgpack`` converts the JAX package's
MCR snapshot files (flax msgpack, decoded without flax) into the port's.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import Conv, ConvTranspose

COLLECTIONS = ("batch_stats", "vq_stats", "bin_stats", "spectral_stats")  # the mutable ones
LSTM_GATES = "ifgo"  # flax OptimizedLSTMCell's gates, in the packed order


def _module_at(module: nn.Module | None, prefix: tuple) -> nn.Module | None:
    if module is None:
        return None
    try:
        return module.get_submodule(".".join(prefix))
    except AttributeError:
        return None


def state_dict_from_jax_params(params_np: Mapping,
                               module: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> {state_dict key: fp32 tensor};
    ``module`` is the port's module at the tree's root, which decides each
    kernel's layout (pass it where the tree holds convolutions)."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        if set(tree) == {f"{kind}{g}" for kind in "ih" for g in LSTM_GATES}:
            def packed(kind, leaf):
                return np.concatenate([np.asarray(tree[f"{kind}{g}"][leaf], np.float32)
                                       for g in LSTM_GATES], -1)

            out[".".join(prefix + ("w_ih",))] = torch.tensor(packed("i", "kernel").T)
            out[".".join(prefix + ("w_hh",))] = torch.tensor(packed("h", "kernel").T)
            out[".".join(prefix + ("b_hh",))] = torch.tensor(packed("h", "bias"))
            return
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,))
                continue
            arr = np.asarray(value)
            arr = arr.astype(np.int32 if arr.dtype.kind in "iu" else np.float32)
            if key == "kernel":
                owner = _module_at(module, prefix)
                if isinstance(owner, Conv):
                    arr = arr.transpose((arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2)))
                elif isinstance(owner, ConvTranspose):
                    arr = arr[::-1].transpose(1, 2, 0)
                elif arr.ndim == 2:
                    arr = arr.T
                key, arr = "weight", np.ascontiguousarray(arr)
            elif key == "scale":
                key = "weight"
            out[".".join(prefix + (key,))] = torch.tensor(arr)

    walk(params_np, ())
    return out


def load_jax_params(algo, params_np: Mapping, extra_vars_np: Mapping | None = None,
                    ema_params_np: Mapping | None = None,
                    target_params_np: Mapping | None = None) -> None:
    """Load the JAX algo's ``state.params`` and its ``state.extra_vars``
    (the collections of ``COLLECTIONS``), as numpy, into ``algo.nets``,
    Diffusion Policy's ``ema_params`` tree into ``algo.ema_nets`` and an
    offline-RL algo's ``target_params`` (its per-network target copies) into
    the buffers under ``algo.nets.target``. Every key must match: a missing
    or extra parameter or buffer raises."""
    state = state_dict_from_jax_params(params_np, algo.nets)
    if target_params_np is not None:
        state.update({f"target.{k}": v for k, v in state_dict_from_jax_params(
            target_params_np, algo.nets.target).items()})
    for collection, tree in (extra_vars_np or {}).items():
        if collection not in COLLECTIONS:
            raise KeyError(f"the port has no counterpart of the {collection!r} collection")
        stats = state_dict_from_jax_params(tree)
        if stats.keys() & state.keys():
            raise KeyError(f"{collection} repeats keys {sorted(stats.keys() & state.keys())}")
        state.update(stats)
    algo.nets.load_state_dict(state, strict=True)
    if ema_params_np is not None:
        algo.ema_nets.load_state_dict(state_dict_from_jax_params(ema_params_np, algo.ema_nets),
                                      strict=True)


def load_jax_parts(algo, parts: Mapping[str, Mapping]) -> None:
    """HBC and IRIS: ``parts`` maps each of the algo's parts (``planner``,
    ``actor`` and IRIS's ``value``) to ``load_jax_params``' keyword
    arguments for that part, the JAX sub-algo's trees as numpy."""
    own = algo.parts()
    if set(parts) != set(own):
        raise KeyError(f"the algo has the parts {sorted(own)}, not {sorted(parts)}")
    for name, trees in parts.items():
        load_jax_params(own[name], **trees)


def _flax_msgpack_ext(code, data):
    """flax.serialization's msgpack extension types: an ndarray (1) or a
    numpy scalar (3) as msgpack (shape, dtype name, C-order bytes)."""
    import msgpack  # only where msgpack is installed; never at import

    if code not in (1, 3):
        raise ValueError(f"unknown flax msgpack extension type {code}")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)
    return arr if code == 1 else arr[()]


def mcr_checkpoint_from_msgpack(src: str, dst: str) -> str:
    """Convert an MCR file of the JAX package (flax msgpack) into the port's
    ``torch.save`` tree of the same layout (``algo/mcr.py``): the
    workspace's snapshot ``{"params", "extra", "global_step"}`` or the
    pretrainer's ``{"params": {"encoder", "head"}, "extra_vars"}``. Leaves
    are renamed and laid out as ``state_dict_from_jax_params`` does. Needs
    msgpack, which only this function imports."""
    import msgpack  # only where msgpack is installed; never at import

    from lipvq_tpu_torch.algo.mcr import MCREncoder, nest

    with open(src, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_flax_msgpack_ext, raw=False)

    def encoder_tree(params):
        module = MCREncoder(embed_dim=np.asarray(params["proj"]["kernel"]).shape[1])
        return nest(state_dict_from_jax_params(params, module))

    def stats_tree(extra):
        return {k: nest(state_dict_from_jax_params(v)) for k, v in extra.items()}

    params = tree["params"]
    if "encoder" in params:
        out = {"params": {"encoder": encoder_tree(params["encoder"]),
                          "head": nest(state_dict_from_jax_params(params["head"]))},
               "extra_vars": stats_tree(tree["extra_vars"])}
    else:
        out = {"params": encoder_tree(params), "extra": stats_tree(tree.get("extra", {})),
               "global_step": torch.tensor(int(tree.get("global_step", 0)))}
    torch.save(out, dst)
    return dst
