"""Base network building blocks (counterpart of ``lipvq_tpu/models/base_nets.py``).

Parameters are created empty: every module that owns parameters has an
``init_weights(generator)`` method, and ``seeded_init`` walks a module tree
in registration order and calls it, so one ``torch.Generator`` decides all
weights and the global RNG is never touched. Build on the CPU, initialize,
then move: the same seed then gives the same weights on every device.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn


def seeded_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every parameter of ``module`` from ``generator``."""
    for m in module.modules():
        init = getattr(m, "init_weights", None)
        if init is not None:
            init(generator)
    return module


class TorchLinear(nn.Module):
    """Linear layer with torch.nn.Linear's default initialization,
    U(+-1/sqrt(fan_in)) for weight and bias; fp32 math. ``weight`` is
    [out, in], the transpose of the flax ``kernel``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.bias is not None:
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class SpectralNormLinear(nn.Module):
    """Linear layer divided by its largest singular value, estimated by power
    iteration (``SpectralNormLinear`` of the JAX package, i.e.
    ``torch.nn.utils.spectral_norm`` on a Linear). ``weight`` is [out, in]
    and ``u`` [out] is the iteration's vector, a buffer (the flax
    ``spectral_stats`` collection). Every forward runs
    ``n_power_iterations`` steps from ``u`` and divides the weight by
    ``sigma = u . (W v)``, differentiable in W only; ``u`` is written back
    only with ``update_stats`` (training steps, never eval or validation)."""

    def __init__(self, in_features: int, features: int, n_power_iterations: int = 1,
                 eps: float = 1e-12):
        super().__init__()
        self.n_power_iterations = n_power_iterations
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("u", torch.empty(features))

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)
            self.u.normal_(generator=generator)

    def forward(self, x, update_stats: bool = True):
        w = self.weight
        with torch.no_grad():
            u = self.u.clone()
            for _ in range(self.n_power_iterations):
                v = w.T @ u
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                u = w @ v
                u = u / (torch.linalg.vector_norm(u) + self.eps)
            v = w.T @ u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
        sigma = u @ (w @ v)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
        return F.linear(x, w / sigma, self.bias)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(u < 1 - p, x / (1 - p), 0)`` with u drawn
    from ``generator`` (on ``x``'s device); identity outside training or at
    p = 0. Keeps ``x``'s dtype. ``F.dropout`` takes no generator, so the
    mask is drawn here."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def gelu_exact(x):
    """torch nn.GELU default: the exact erf formulation."""
    return F.gelu(x)


_ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "gelu": gelu_exact,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "none": lambda x: x,
}


def get_activation(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    return _ACTIVATIONS[name_or_fn]
