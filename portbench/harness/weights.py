"""Weights made from a seed on the device, in one draw, for the program and
the reference alike.

Every tensor of a layout (a reference's ``param_specs``) is a slice of one
standard-normal draw of a ``torch.Generator`` on the device, scaled by its
kind: GPT Dense weights N(0, 0.02), other weights N(0, 1 / fan_in),
convolutions He-scaled, LayerNorm and BatchNorm scales near 1, FiLM's
gamma near 1. The LipVQ codebook is the latents of seeded actions (a
trained codebook's rows lie among the latents), so the lookups spread over
the codes; the Lipschitz bounds ``ci`` near 3 spread the latents.
"""

from __future__ import annotations

import math

import torch

_CODE_ACTION_STD = 0.5


def _scaled(x: torch.Tensor, kind: str, shape) -> torch.Tensor:
    fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind == "gpt":
        return 0.02 * x
    if kind == "fan_in":
        return x / math.sqrt(fan_in)
    if kind == "conv":
        return x * math.sqrt(2.0 / fan_in)
    if kind == "unit":
        return x
    if kind == "small":
        return 0.05 * x
    if kind in ("one", "var"):
        return 1.0 + 0.05 * x if kind == "one" else 1.0 + 0.1 * x.abs()
    if kind == "ci":
        return 3.0 + 0.3 * x
    if kind == "film_w":
        return 0.1 * x
    if kind == "film_b":
        c = shape[0] // 2
        return torch.cat([1.0 + 0.05 * x[:c], 0.05 * x[c:]])
    raise ValueError(f"unknown kind {kind!r}")


def make(specs: list, seed: int, device, encode=None, codebooks=()) -> dict:
    """{name: tensor} for ``specs`` (the reference's ``param_specs``) from
    ``seed``; each prefix in ``codebooks`` names a LipVQ tokenizer whose
    codebook becomes the latents of seeded actions (0.5 N(0, 1)) under the
    reference's ``encode(weights, prefix, actions)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (name, shape, kind), n in zip(specs, sizes):
        x = flat[off:off + n]
        off += n
        if kind != "codebook":
            out[name] = _scaled(x, kind, shape).reshape(shape).contiguous()
    for p in codebooks:
        codes, _ = next(shape for name, shape, _ in specs if name == p + "quantizer.codebook")
        feature = next(shape for name, shape, _ in specs if name == p + "enc1.weight")[1]
        acts = _CODE_ACTION_STD * torch.randn(codes, feature, generator=gen, device=device)
        with torch.no_grad():
            out[p + "quantizer.codebook"] = encode(out, p, acts).contiguous()
    return out
