"""Mamba selective state-space block (counterpart of
``lipvq_tpu/models/mamba.py``).

The recurrence, per channel d and state n,

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

runs in fp32 as a sequential loop over t, the JAX package's
``associative_scan`` written as its definition: the sequences are short (10
actions in the ln_act tokenizer, 30 tokens in the ICL backbone), so the
loop is 10 or 30 elementwise steps. The summation order differs from the
scan's tree, so the two agree to fp32 rounding, not bit for bit.

The block follows mamba_ssm's defaults: d_inner = expand * d_model, dt_rank
= ceil(d_model / 16), a depthwise causal convolution of width d_conv (an
unrolled stencil) + SiLU, data-dependent (dt, B, C), ``dt_proj``'s bias the
inverse softplus of a log-uniform dt in [1e-3, 0.1], A = -exp(A_log) with
A_log = log(1..d_state), D ones, a SiLU gate and ``out_proj``. Parameters
keep the flax names and layouts (``conv_kernel`` [d_conv, d_inner], ``A_log``
[d_inner, d_state], ``D`` [d_inner]; Dense kernels as ``weight`` [out, in]).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear
from lipvq_tpu_torch.models.transformer import LN_EPS


def selective_scan(x, dt, A, B, C, D):
    """x, dt [b, t, d]; A [d, n]; B, C [b, t, n]; D [d] -> y [b, t, d] in
    x's dtype, the state in fp32."""
    x32, dt32 = x.float(), dt.float()
    dA = torch.exp(dt32[..., None] * A[None, None])        # [b, t, d, n]
    dBx = (dt32 * x32)[..., None] * B.float()[:, :, None, :]  # [b, t, d, n]
    h = torch.zeros_like(dA[:, 0])
    states = []
    for i in range(x.shape[1]):
        h = dA[:, i] * h + dBx[:, i]
        states.append(h)
    y = torch.einsum("btdn,btn->btd", torch.stack(states, 1), C.float())
    return (y + x32 * D[None, None]).to(x.dtype)


class _DtProj(TorchLinear):
    """``dt_proj``: the torch Linear weight init, the bias mamba_ssm's
    inverse softplus of dt ~ log-uniform [1e-3, 0.1] (clamped at 1e-4)."""

    def init_weights(self, generator: torch.Generator) -> None:
        super().init_weights(generator)
        with torch.no_grad():
            u = torch.rand(self.bias.shape, generator=generator)
            dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            dt0 = torch.clamp(dt0, min=1e-4)
            self.bias.copy_(dt0 + torch.log(-torch.expm1(-dt0)))


class MambaBlock(nn.Module):
    """One Mamba block: in_proj -> causal depthwise conv -> SSM -> gate ->
    out_proj. x [b, t, d_model] -> [b, t, d_model]."""

    def __init__(self, d_model: int, d_state: int = 8, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.d_state, self.d_conv = d_state, d_conv
        self.d_inner = expand * d_model
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = TorchLinear(d_model, 2 * self.d_inner, bias=False)
        self.conv_kernel = nn.Parameter(torch.empty(d_conv, self.d_inner))
        self.conv_bias = nn.Parameter(torch.empty(self.d_inner))
        self.x_proj = TorchLinear(self.d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = _DtProj(self.dt_rank, self.d_inner)
        self.A_log = nn.Parameter(torch.empty(self.d_inner, d_state))
        self.D = nn.Parameter(torch.empty(self.d_inner))
        self.out_proj = TorchLinear(self.d_inner, d_model, bias=False)

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.d_conv)  # flax's fan_in of [d_conv, d_inner]
        with torch.no_grad():
            self.conv_kernel.uniform_(-bound, bound, generator=generator)
            self.conv_bias.zero_()
            self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                             .expand(self.d_inner, -1))
            self.D.fill_(1.0)

    def forward(self, x):
        t = x.shape[1]
        xs, z = self.in_proj(x).chunk(2, dim=-1)
        # depthwise causal conv over time: pad left d_conv - 1
        xp = F.pad(xs, (0, 0, self.d_conv - 1, 0))
        xs = sum(self.conv_kernel[k] * xp[:, k:k + t] for k in range(self.d_conv)) + self.conv_bias
        xs = F.silu(xs)
        dt, B, C = self.x_proj(xs).split([self.dt_rank, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(self.dt_proj(dt))
        y = selective_scan(xs, dt, -torch.exp(self.A_log), B, C, self.D)
        return self.out_proj(y * F.silu(z))


class MambaBackbone(nn.Module):
    """Residual Mamba blocks with pre-LN (``ln_{i}``, ``mamba_{i}``) and a
    final LayerNorm (``out_ln``): the ICL sequence backbone in place of the
    GPT. fp32 throughout and no dropout, as in the JAX package; ``train``
    and ``generator`` are taken for the GPT backbone's signature."""

    def __init__(self, d_model: int, num_layers: int = 1, d_state: int = 8, d_conv: int = 4,
                 expand: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"ln_{i}", nn.LayerNorm(d_model, eps=LN_EPS))
            self.add_module(f"mamba_{i}", MambaBlock(d_model, d_state=d_state, d_conv=d_conv,
                                                     expand=expand))
        self.out_ln = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            x = x + getattr(self, f"mamba_{i}")(getattr(self, f"ln_{i}")(x))
        return self.out_ln(x)
