"""Conditional UNet-1D for Diffusion Policy (counterpart of
``lipvq_tpu/models/diffusion_nets.py``).

SinusoidalPosEmb, Conv1dBlock (conv + GroupNorm + Mish),
ConditionalResidualBlock1D with FiLM scale + bias from the condition,
Down/Upsample1d and ConditionalUnet1D, with the flax modules' names. The
network takes and returns [B, T, C] as the JAX one does and computes
channels-first ([B, C, T]) inside, the layout of torch's convolutions.

Matching flax:
- every convolution is ``base_nets.Conv`` / ``ConvTranspose``: fp32 on the
  card, forward and backward (cuDNN's TF32 is on by default);
- ``Downsample1d`` is flax's stride-2 "SAME" convolution: one zero column on
  the right, none on the left (torch's symmetric ``padding=1`` is another
  function); ``Upsample1d`` is ``conv_transpose1d(stride=2, padding=1)``
  with the flax kernel's taps reversed;
- GroupNorm's epsilon is flax's 1e-6;
- mish uses ``F.softplus``, which returns x above 20 where flax's
  ``logaddexp(x, 0)`` adds log1p(e^-x) < 2.1e-9, under half an fp32 ulp of
  such an x: the two agree to the bit in fp32.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import Conv, ConvTranspose, TorchLinear

GN_EPS = 1e-6  # flax nn.GroupNorm default


def mish(x):
    return x * torch.tanh(F.softplus(x))


class SinusoidalPosEmb(nn.Module):
    """Diffusion timesteps [B] -> [B, dim]: sin then cos of t * 10000^(-i / (dim/2 - 1))."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half = self.dim // 2
        scale = math.log(10000.0) / (half - 1)
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32) * -scale)
        emb = t[:, None].float() * freqs[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class Conv1dBlock(nn.Module):
    """``conv`` (kernel k, padding k // 2 each side) -> ``gn`` -> mish."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 n_groups: int = 8):
        super().__init__()
        pad = kernel_size // 2
        self.conv = Conv(in_channels, out_channels, (kernel_size,), padding=[(pad, pad)])
        self.gn = nn.GroupNorm(n_groups, out_channels, eps=GN_EPS)

    def forward(self, x):
        return mish(self.gn(self.conv(x)))


class ConditionalResidualBlock1D(nn.Module):
    """Two Conv1dBlocks, the first's output modulated by FiLM: ``cond_encoder``
    maps mish(cond) to (scale, bias) per channel; a 1-wide ``residual_conv``
    where the channel count changes."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int,
                 kernel_size: int = 3, n_groups: int = 8):
        super().__init__()
        self.out_channels = out_channels
        self.block1 = Conv1dBlock(in_channels, out_channels, kernel_size, n_groups)
        self.cond_encoder = TorchLinear(cond_dim, 2 * out_channels)
        self.block2 = Conv1dBlock(out_channels, out_channels, kernel_size, n_groups)
        self.residual_conv = (Conv(in_channels, out_channels, (1,))
                              if in_channels != out_channels else None)

    def forward(self, x, cond):
        """x [B, C_in, T], cond [B, D] -> [B, C_out, T]."""
        h = self.block1(x)
        film = self.cond_encoder(mish(cond))[:, :, None]
        scale, bias = film[:, :self.out_channels], film[:, self.out_channels:]
        h = self.block2(h * scale + bias)
        if self.residual_conv is not None:
            x = self.residual_conv(x)
        return h + x


class Downsample1d(nn.Module):
    """T -> ceil(T / 2): flax's ``Conv(k=3, s=2, padding="SAME")``."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = Conv(dim, dim, (3,), stride=2, padding="SAME")

    def forward(self, x):
        return self.conv(x)


class Upsample1d(nn.Module):
    """T -> 2T: flax's ``ConvTranspose(k=4, s=2, padding="SAME")``."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = ConvTranspose(dim, dim, 4, stride=2)

    def forward(self, x):
        return self.conv(x)


class ConditionalUnet1D(nn.Module):
    """Epsilon predictor over action sequences [B, Tp, input_dim] conditioned
    on the diffusion timestep and global obs features [B, global_cond_dim]."""

    def __init__(self, input_dim: int, global_cond_dim: int,
                 diffusion_step_embed_dim: int = 256,
                 down_dims: Sequence[int] = (256, 512, 1024), kernel_size: int = 5,
                 n_groups: int = 8):
        super().__init__()
        dsed = diffusion_step_embed_dim
        dims = list(down_dims)
        self.num_levels = len(dims)
        cond_dim = dsed + global_cond_dim
        self.pos_emb = SinusoidalPosEmb(dsed)
        self.t1 = TorchLinear(dsed, dsed * 4)
        self.t2 = TorchLinear(dsed * 4, dsed)

        def res(name, c_in, c_out):
            self.add_module(name, ConditionalResidualBlock1D(c_in, c_out, cond_dim,
                                                             kernel_size, n_groups))

        c_in = input_dim
        for i, dim in enumerate(dims):
            res(f"down{i}_res0", c_in, dim)
            res(f"down{i}_res1", dim, dim)
            if i < len(dims) - 1:
                self.add_module(f"down{i}_ds", Downsample1d(dim))
            c_in = dim
        res("mid_res0", dims[-1], dims[-1])
        res("mid_res1", dims[-1], dims[-1])
        for i in reversed(range(len(dims) - 1)):
            self.add_module(f"up{i}_us", Upsample1d(dims[i + 1]))
            res(f"up{i}_res0", dims[i + 1] + dims[i], dims[i])
            res(f"up{i}_res1", dims[i], dims[i])
        self.final_block = Conv1dBlock(dims[0], dims[0], kernel_size, n_groups)
        self.final_conv = Conv(dims[0], input_dim, (1,))

    def forward(self, sample, timestep, global_cond):
        """sample [B, T, C]; timestep [B] int; global_cond [B, Dg] -> [B, T, C]."""
        t_emb = self.t2(mish(self.t1(self.pos_emb(timestep))))
        cond = torch.cat([t_emb, global_cond], dim=-1)
        x = sample.transpose(1, 2).contiguous()
        skips = []
        for i in range(self.num_levels):
            x = getattr(self, f"down{i}_res0")(x, cond)
            x = getattr(self, f"down{i}_res1")(x, cond)
            skips.append(x)
            if i < self.num_levels - 1:
                x = getattr(self, f"down{i}_ds")(x)
        x = self.mid_res1(self.mid_res0(x, cond), cond)
        for i in reversed(range(self.num_levels - 1)):
            x = torch.cat([getattr(self, f"up{i}_us")(x), skips[i]], dim=1)
            x = getattr(self, f"up{i}_res0")(x, cond)
            x = getattr(self, f"up{i}_res1")(x, cond)
        x = self.final_conv(self.final_block(x))
        return x.transpose(1, 2)
