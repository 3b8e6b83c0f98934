"""Mamba selective state-space block and the Mamba backbone (counterpart
of ``lipvq_tpu/models/mamba.py``), with the port's hybrid layout.

The recurrence, per channel d and state n,

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

is ``ops/selective_scan.py``'s: on the CPU a sequential loop over t in fp32,
the JAX package's ``associative_scan`` written as its definition (the
summation order differs from the scan's tree, so the two agree to fp32
rounding, not bit for bit); on the card the fused kernel, which keeps the
state on chip and recomputes it in the backward.

On the card the block takes the chain between ``in_proj``'s output and
``out_proj``'s operand into two kernels (``MambaBlock._fuses``): the conv,
its bias and SiLU in one (``ops/causal_conv1d.py``, which also writes
``x_proj``'s operand in the compute dtype), and softplus of dt, the scan
and the gate y * silu(z) in the other (``ops/selective_scan.py``'s gated
scan), each with its backward; the same values in fp32, rounded to the
compute dtype where the composed chain rounds. On the CPU, and where
``selective_scan`` here is not the ops module's own (a fault planted on
it), the composed chain runs. The counters ``ssm_mixer_fused`` and
``ssm_mixer_composed`` count the block's forwards on the card by path.

The block follows mamba_ssm's defaults: d_inner = expand * d_model, dt_rank
= ceil(d_model / 16), a depthwise causal convolution of width d_conv (an
unrolled stencil) + SiLU, data-dependent (dt, B, C), ``dt_proj``'s bias the
inverse softplus of a log-uniform dt in [1e-3, 0.1], A = -exp(A_log) with
A_log = log(1..d_state), D ones, a SiLU gate and ``out_proj``. Parameters
keep the flax names and layouts (``conv_kernel`` [d_conv, d_inner], ``A_log``
[d_inner, d_state], ``D`` [d_inner]; Dense kernels as ``weight`` [out, in]).

The hybrid layout (``MambaBackbone``'s keywords past ``expand``, all off by
default, which is the JAX package's backbone) follows Jamba (AI21's
``JambaForCausalLM``): layer i is multi-query attention where ``i %
attn_layer_period == attn_layer_offset`` and a Mamba mixer elsewhere; each
layer is ``x = x + mixer(norm(x))``, then with ``mlp_dim`` ``x = x +
mlp(norm(x))`` (the SiLU-gated ``GatedMLP``), RMSNorms with ``norm="rms"``,
a final norm; the mixer may normalize dt, B and C (RMSNorm, ``dt_bc_norm``)
before ``dt_proj`` and the scan, and take ``dt_rank`` from the config. With
a ``compute_dtype`` the Dense layers (``in_proj``, ``x_proj``, ``dt_proj``,
``out_proj``, attention, MLP) cast their operands to it with fp32 weights,
as the GPT's do; the convolution, the norms, the scan and its state, the
gate and the residual stream stay fp32. Where this composite differs from
the published model: Jamba's token embedding and LM head give way to the
ICL composite's embedding and GMM heads, the backbone sees 3T interleaved
tokens (the query tokens last, so causal order holds), and there is no
dropout inside it (Jamba's attention dropout is 0).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear
from lipvq_tpu_torch.models.transformer import (
    LN_EPS,
    GatedMLP,
    GroupedQueryAttention,
    RMSNorm,
    cast_linear,
)
from lipvq_tpu_torch.ops import causal_conv1d
from lipvq_tpu_torch.ops import selective_scan as scan_ops
from lipvq_tpu_torch.ops.selective_scan import selective_scan
from lipvq_tpu_torch.utils import profile_utils
from lipvq_tpu_torch.utils.profile_utils import span


def _dense(layer: TorchLinear, x, compute_dtype: torch.dtype | None):
    """``layer(x)``, or with ``compute_dtype`` its operands cast to it."""
    return cast_linear(x, layer.weight, layer.bias, compute_dtype)


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
    out_proj. x [b, t, d_model] -> [b, t, d_model] (fp32, or
    ``compute_dtype`` from ``out_proj``). ``dt_rank`` 0 is ceil(d_model /
    16); ``dt_bc_norm`` puts RMSNorms (``dt_norm``, ``b_norm``, ``c_norm``,
    eps ``norm_eps``) on dt, B and C."""

    # forwards on the card by path (module docstring)
    fused_forwards = 0
    composed_forwards = 0

    def __init__(self, d_model: int, d_state: int = 8, d_conv: int = 4, expand: int = 2,
                 dt_rank: int = 0, dt_bc_norm: bool = False, norm_eps: float = LN_EPS,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.d_state, self.d_conv = d_state, d_conv
        self.d_inner = expand * d_model
        self.dt_rank = dt_rank or math.ceil(d_model / 16)
        self.compute_dtype = compute_dtype
        self.in_proj = TorchLinear(d_model, 2 * self.d_inner, bias=False)
        self.conv_kernel = nn.Parameter(torch.empty(d_conv, self.d_inner))
        self.conv_bias = nn.Parameter(torch.empty(self.d_inner))
        self.x_proj = TorchLinear(self.d_inner, self.dt_rank + 2 * d_state, bias=False)
        self.dt_proj = _DtProj(self.dt_rank, self.d_inner)
        self.A_log = nn.Parameter(torch.empty(self.d_inner, d_state))
        self.D = nn.Parameter(torch.empty(self.d_inner))
        self.out_proj = TorchLinear(self.d_inner, d_model, bias=False)
        self.dt_bc_norm = dt_bc_norm
        if dt_bc_norm:
            self.dt_norm = RMSNorm(self.dt_rank, norm_eps)
            self.b_norm = RMSNorm(d_state, norm_eps)
            self.c_norm = RMSNorm(d_state, norm_eps)

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.d_conv)  # flax's fan_in of [d_conv, d_inner]
        with torch.no_grad():
            self.conv_kernel.uniform_(-bound, bound, generator=generator)
            self.conv_bias.zero_()
            self.A_log.copy_(torch.log(torch.arange(1, self.d_state + 1, dtype=torch.float32))
                             .expand(self.d_inner, -1))
            self.D.fill_(1.0)

    def forward(self, x):
        h = _dense(self.in_proj, x, self.compute_dtype)
        if self._fuses(h):
            MambaBlock.fused_forwards += 1
            return self._fused(h)
        if h.is_cuda:
            MambaBlock.composed_forwards += 1
        return self._composed(h)

    def _fuses(self, h) -> bool:
        """Whether the kernels take this forward: ``in_proj``'s output h on
        the card and the scan not replaced here. The kernels raise on
        tensors they do not take (a wider stencil, more states)."""
        return h.is_cuda and selective_scan is scan_ops.selective_scan

    def _project(self, xs):
        """(``dt_proj``'s output, B, C) from the conv's output (or its
        copy in the compute dtype)."""
        cd = self.compute_dtype
        dt, B, C = _dense(self.x_proj, xs, cd).float().split(
            [self.dt_rank, self.d_state, self.d_state], dim=-1)
        if self.dt_bc_norm:
            dt, B, C = self.dt_norm(dt), self.b_norm(B), self.c_norm(C)
        return _dense(self.dt_proj, dt, cd), B, C

    def _composed(self, h):
        """The chain in PyTorch operations, from ``in_proj``'s output h."""
        t, cd = h.shape[1], self.compute_dtype
        # .float() is a no-op on the fp32 path
        xs, z = h.float().chunk(2, dim=-1)
        # depthwise causal conv over time: pad left d_conv - 1
        xp = F.pad(xs, (0, 0, self.d_conv - 1, 0))
        xs = sum(self.conv_kernel[k] * xp[:, k:k + t] for k in range(self.d_conv)) + self.conv_bias
        xs = F.silu(xs)
        dt, B, C = self._project(xs)
        dt = F.softplus(dt.float())
        y = selective_scan(xs, dt, -torch.exp(self.A_log), B, C, self.D)
        return _dense(self.out_proj, y * F.silu(z), cd)

    def _fused(self, h):
        """The chain in the two kernels, from ``in_proj``'s output h: the
        halves are read in place, and their gradients meet in ``chunk``'s
        backward."""
        cd = self.compute_dtype
        xh, z = h.chunk(2, dim=-1)
        if cd is None:
            xs = xs_op = causal_conv1d.causal_conv1d_silu(xh, self.conv_kernel, self.conv_bias)
        else:
            xs, xs_op = causal_conv1d.causal_conv1d_silu(xh, self.conv_kernel, self.conv_bias,
                                                         copy=True)
        dt, B, C = self._project(xs_op)
        out = scan_ops.gated_selective_scan(xs, dt, -torch.exp(self.A_log), B, C, self.D, z)
        return _dense(self.out_proj, out, cd)


profile_utils.register({"ssm_mixer_fused": lambda: MambaBlock.fused_forwards,
                        "ssm_mixer_composed": lambda: MambaBlock.composed_forwards})


class MambaBackbone(nn.Module):
    """Residual Mamba blocks with pre-LN (``ln_{i}``, ``mamba_{i}``) and a
    final LayerNorm (``out_ln``): the ICL sequence backbone in place of the
    GPT. With the defaults fp32 throughout and no dropout, as in the JAX
    package; ``train`` and ``generator`` are taken for the GPT backbone's
    signature.

    The hybrid layout (module docstring): ``attn_{i}`` (a
    ``GroupedQueryAttention`` of ``num_heads`` query and ``num_kv_heads``
    key/value heads) in place of ``mamba_{i}`` where ``i %
    attn_layer_period == attn_layer_offset`` (period 0: none), ``mlp_ln_{i}``
    and ``mlp_{i}`` after each mixer with ``mlp_dim``, ``norm`` "layer" or
    "rms" of eps ``norm_eps`` for every norm, ``dt_bc_norm`` and ``dt_rank``
    for the mixers, and the Dense layers in ``compute_dtype``."""

    def __init__(self, d_model: int, num_layers: int = 1, d_state: int = 8, d_conv: int = 4,
                 expand: int = 2, *, num_heads: int = 8, causal: bool = True,
                 attn_layer_period: int = 0, attn_layer_offset: int = 0, num_kv_heads: int = 1,
                 mlp_dim: int = 0, norm: str = "layer", norm_eps: float = LN_EPS,
                 dt_bc_norm: bool = False, dt_rank: int = 0,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        if norm not in ("layer", "rms"):
            raise ValueError(f"norm is 'layer' or 'rms', got {norm!r}")
        self.num_layers = num_layers
        self.attn_layer_period, self.attn_layer_offset = attn_layer_period, attn_layer_offset
        self.mlp_dim = mlp_dim

        def make_norm():
            return (nn.LayerNorm(d_model, eps=norm_eps) if norm == "layer"
                    else RMSNorm(d_model, norm_eps))

        for i in range(num_layers):
            self.add_module(f"ln_{i}", make_norm())
            if self.is_attention(i):
                self.add_module(f"attn_{i}", GroupedQueryAttention(
                    d_model, num_heads, num_kv_heads, causal=causal,
                    compute_dtype=compute_dtype))
            else:
                self.add_module(f"mamba_{i}", MambaBlock(
                    d_model, d_state=d_state, d_conv=d_conv, expand=expand, dt_rank=dt_rank,
                    dt_bc_norm=dt_bc_norm, norm_eps=norm_eps, compute_dtype=compute_dtype))
            if mlp_dim:
                self.add_module(f"mlp_ln_{i}", make_norm())
                self.add_module(f"mlp_{i}", GatedMLP(d_model, mlp_dim, compute_dtype))
        self.out_ln = make_norm()

    def is_attention(self, i: int) -> bool:
        """Whether layer ``i`` is attention: i % period == offset."""
        return self.attn_layer_period > 0 and i % self.attn_layer_period == self.attn_layer_offset

    def forward(self, x, train: bool = False, generator: torch.Generator | None = None):
        for i in range(self.num_layers):
            h = getattr(self, f"ln_{i}")(x)
            if self.is_attention(i):
                with span("model.backbone.attention"):
                    x = x + getattr(self, f"attn_{i}")(h)
            else:
                with span("model.backbone.mamba"):
                    x = x + getattr(self, f"mamba_{i}")(h)
            if self.mlp_dim:
                with span("model.backbone.mlp"):
                    x = x + getattr(self, f"mlp_{i}")(getattr(self, f"mlp_ln_{i}")(x))
        return self.out_ln(x)
