"""GMM action distribution (counterpart of ``lipvq_tpu/models/distributions.py``).

Matches torch's Independent(Normal) -> MixtureSameFamily composition used by
the reference GMM heads, as a parameter bundle with plain functions.
Sampling draws from an explicit ``torch.Generator`` on the tensors' device;
its numbers differ from JAX's PRNG, so parity is by statistics.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class GMMParams(NamedTuple):
    """Diagonal-Gaussian mixture over actions.

    means:  [..., M, A]
    scales: [..., M, A]
    logits: [..., M]
    """

    means: torch.Tensor
    scales: torch.Tensor
    logits: torch.Tensor


def gmm_log_prob(p: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """log prob of x [..., A] under the mixture -> [...]."""
    x = x[..., None, :]
    comp = -0.5 * (((x - p.means) / p.scales) ** 2
                   + 2.0 * torch.log(p.scales) + math.log(2.0 * math.pi))
    comp_lp = comp.sum(-1)
    mix_lp = torch.log_softmax(p.logits, dim=-1)
    return torch.logsumexp(comp_lp + mix_lp, dim=-1)


def gmm_sample(p: GMMParams, generator: torch.Generator | None, noise=None) -> torch.Tensor:
    """Ancestral sample: categorical mode (Gumbel-max), then diagonal
    Gaussian; ``noise`` = (mode ids [...], standard normals [..., A]) in
    place of the generator's draws."""
    if noise is not None:
        mode, eps = noise
        return _component_sample(p, mode, eps)
    u, eps = gmm_draws(p, generator)
    return gmm_sample_from_draws(p, u, eps)


def gmm_draws(p: GMMParams, generator: torch.Generator | None):
    """The draws ``gmm_sample`` takes from ``generator``, in its order: the
    Gumbel uniforms [..., M], then the standard normals [..., A]."""
    u = torch.rand(p.logits.shape, generator=generator, device=p.logits.device)
    eps = torch.randn(p.means.shape[:-2] + p.means.shape[-1:], generator=generator,
                      device=p.means.device, dtype=p.means.dtype)
    return u, eps


def gmm_sample_from_draws(p: GMMParams, u: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """``gmm_sample`` on given draws (``gmm_draws``): a function of tensors
    only, so an exported program can take the draws as inputs."""
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    mode = torch.argmax(p.logits.float() - torch.log(-torch.log(u)), dim=-1)
    return _component_sample(p, mode, eps)


def _component_sample(p: GMMParams, mode, eps) -> torch.Tensor:
    idx = mode.long()[..., None, None].expand(*mode.shape, 1, p.means.shape[-1])
    mean = p.means.gather(-2, idx).squeeze(-2)
    scale = p.scales.gather(-2, idx).squeeze(-2)
    return mean + scale * eps


def gmm_mean(p: GMMParams) -> torch.Tensor:
    """Mixture mean (probability-weighted component means)."""
    w = torch.softmax(p.logits, dim=-1)[..., None]
    return (w * p.means).sum(-2)


def make_gmm(raw_means, raw_scales, logits, *, min_std: float = 1e-4,
             std_activation: str = "softplus", use_tanh_mean: bool = True,
             low_noise: bool = False) -> GMMParams:
    """Tanh-squash the means (unless a tanh-wrapped distribution is used),
    then either fixed sigma = 1e-4 at low-noise eval or
    activation(raw_scales) + min_std."""
    means = torch.tanh(raw_means) if use_tanh_mean else raw_means
    if low_noise:
        scales = torch.full_like(means, 1e-4)
    elif std_activation == "softplus":
        scales = F.softplus(raw_scales) + min_std
    elif std_activation == "exp":
        scales = torch.exp(raw_scales) + min_std
    else:
        raise ValueError(std_activation)
    return GMMParams(means=means, scales=scales, logits=logits)
