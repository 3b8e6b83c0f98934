"""Base network building blocks (counterpart of ``lipvq_tpu/models/base_nets.py``).

Parameters are created empty: every module that owns parameters has an
``init_weights(generator)`` method, and ``seeded_init`` walks a module tree
in registration order and calls it, so one ``torch.Generator`` decides all
weights and the global RNG is never touched. Build on the CPU, initialize,
then move: the same seed then gives the same weights on every device.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from lipvq_tpu_torch.parallel.mesh import all_reduce_sum, draw_rows


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


class MLP(nn.Module):
    """The JAX package's ``MLP``: ``TorchLinear_0..n-1`` over ``layer_dims``,
    each followed by ``activation``, then ``TorchLinear_n`` to
    ``output_dim`` and the optional ``output_activation``."""

    def __init__(self, in_features: int, layer_dims, output_dim: int,
                 activation="relu", output_activation=None):
        super().__init__()
        self.activation = activation
        self.output_activation = output_activation
        widths = [in_features, *layer_dims, output_dim]
        self.num_linears = len(widths) - 1
        for i in range(self.num_linears):
            self.add_module(f"TorchLinear_{i}", TorchLinear(widths[i], widths[i + 1]))

    def forward(self, x):
        act = get_activation(self.activation)
        for i in range(self.num_linears):
            x = getattr(self, f"TorchLinear_{i}")(x)
            if i < self.num_linears - 1:
                x = act(x)
        if self.output_activation is not None:
            x = get_activation(self.output_activation)(x)
        return x


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


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's default kernel init (``lecun_normal``): a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's std
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` without a mask or dropout, in
    flax's parameter layout: ``query`` weight [D, H, Dh], ``key``/``value``
    weight [Dkv, H, Dh] and biases [H, Dh], ``out`` weight [H, Dh, D] and
    bias [D] (normal weights of variance 1 / fan_in, zero biases). ``Dkv``
    defaults to D (self-attention); H * Dh = D. The query is scaled by
    1/sqrt(Dh) before the product, the softmax is over the keys."""

    def __init__(self, dim: int, num_heads: int, kv_dim: int | None = None):
        super().__init__()
        head_dim = dim // num_heads
        for name, in_dim in (("query", dim), ("key", kv_dim or dim), ("value", kv_dim or dim)):
            proj = nn.Module()
            proj.weight = nn.Parameter(torch.empty(in_dim, num_heads, head_dim))
            proj.bias = nn.Parameter(torch.empty(num_heads, head_dim))
            self.add_module(name, proj)
        self.out = nn.Module()
        self.out.weight = nn.Parameter(torch.empty(num_heads, head_dim, dim))
        self.out.bias = nn.Parameter(torch.empty(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        heads, head_dim = self.query.bias.shape
        with torch.no_grad():
            for proj in (self.query, self.key, self.value, self.out):
                fan_in = heads * head_dim if proj is self.out else proj.weight.shape[0]
                proj.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
                proj.bias.zero_()

    def forward(self, x, kv=None):
        """x [..., L, D], kv [..., S, Dkv] (default x) -> [..., L, D]."""
        kv = x if kv is None else kv
        q = torch.einsum("...ld,dhk->...lhk", x, self.query.weight) + self.query.bias
        k, v = (torch.einsum("...ld,dhk->...lhk", kv, p.weight) + p.bias
                for p in (self.key, self.value))
        q = q / math.sqrt(q.shape[-1])
        att = torch.softmax(torch.einsum("...qhd,...khd->...hqk", q, k), dim=-1)
        y = torch.einsum("...hqk,...khd->...qhd", att, v)
        return torch.einsum("...qhd,hdo->...qo", y, self.out.weight) + self.out.bias


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN's TF32 off inside the block (it is on by default), the
    process's setting restored after: convolutions in fp32, as the JAX
    package's ``nn.Conv`` computes them."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class _ConvFp32(torch.autograd.Function):
    """``aten.convolution`` (no dilation, one group, no output padding)
    whose forward and backward each run under
    ``cudnn_fp32``: cuDNN reads the TF32 setting when the backward runs,
    outside any scope around the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, transposed=False):
        dims = len(padding)
        ctx.args = ([stride] * dims, padding, [1] * dims, transposed, [0] * dims, 1)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        ctx.save_for_backward(x, weight)
        with cudnn_fp32():
            return torch.ops.aten.convolution(x, weight, bias, *ctx.args)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.bias_sizes is not None and ctx.needs_input_grad[2]]
        with cudnn_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, weight, ctx.bias_sizes, *ctx.args, mask)
        return gx, gw, gb, None, None, None


class Conv(nn.Module):
    """flax ``nn.Conv`` over channels-first tensors ([B, C, L] or [B, C, H, W]).
    ``weight``
    is [out, in, *kernel], the flax kernel [*kernel, in, out] with its two
    last axes moved to the front; ``bias`` [out] where used. ``padding`` is
    explicit ((lo, hi) per spatial dim) or flax's default "SAME": output
    size ceil(in / stride), the padding split low = total // 2 as
    ``lax.padtype_to_pads`` does. flax's init: lecun-normal weights, zero
    bias. Forward and backward run in fp32 on the card (``cudnn_fp32``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple,
                 stride: int = 1, padding="SAME", bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.stride = int(stride)
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def _pads(self, sizes) -> list[tuple[int, int]]:
        if self.padding != "SAME":
            return [tuple(p) for p in self.padding]
        pads = []
        for size, k in zip(sizes, self.kernel_size):
            total = max((-(-size // self.stride) - 1) * self.stride + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return pads

    def forward(self, x):
        pads = self._pads(x.shape[2:])
        if any(lo != hi for lo, hi in pads):
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])  # last dim first
            pads = [(0, 0)] * len(pads)
        return _ConvFp32.apply(x, self.weight, self.bias, self.stride, [lo for lo, _ in pads])


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k,), strides=(s,), padding="SAME")``
    over [B, C, L] (output length L * s), as ``conv_transpose1d``. flax
    correlates the stride-dilated input, padded as ``lax.conv_transpose``
    pads for "SAME", with its kernel [k, in, out] as it is; torch's
    transposed convolution flips the taps, so ``weight`` [in, out, k] holds
    the flax kernel with its tap axis reversed (``utils/jax_weights.py``
    flips it). flax's init: lecun-normal weights, zero bias. Forward and
    backward run in fp32 on the card (``cudnn_fp32``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True):
        super().__init__()
        k, s = int(kernel_size), int(stride)
        # lax.conv_transpose's "SAME" padding of the dilated input
        pad_len = k + s - 2
        pad_lo = k - 1 if s > k - 1 else -(-pad_len // 2)
        if pad_len - pad_lo != pad_lo:
            raise ValueError(f"flax's SAME pads k={k}, s={s} unevenly; not supported")
        self.stride, self.padding = s, k - 1 - pad_lo
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, k))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[0] * self.weight.shape[2], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return _ConvFp32.apply(x, self.weight, self.bias, self.stride, [self.padding], True)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` (epsilon 1e-5) over dim 1 of a
    channels-first tensor: ``weight`` (flax's ``scale``, ones) and ``bias``
    (zeros); the buffers ``mean`` (zeros) and ``var`` (ones) are flax's
    ``batch_stats``. With ``train`` the batch's mean and biased variance
    normalize, and the buffers move to ``momentum * old + (1 - momentum) *
    batch`` with the biased variance, as flax does (torch's BatchNorm would
    store the unbiased one, n / (n - 1) larger); else the buffers
    normalize. Under a data-parallel ``mesh`` of several ranks the batch is
    the global one: the sums of x and x^2 and the counts are summed over
    the ranks (differentiably), and ``var = E[x^2] - E[x]^2`` as flax
    computes it."""

    mesh = None

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, train: bool = False):
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.weight, self.bias, False, 0.0,
                                self.eps)
        if self.mesh is not None and self.mesh.world > 1:
            return self._global_batch(x)
        with torch.no_grad():
            dims = [d for d in range(x.ndim) if d != 1]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            self._move_stats(mean, var)
        if x.numel() == x.shape[1]:
            # one value per channel: x - mean is 0 (flax's output is the bias,
            # where torch's batch_norm would raise)
            return self.bias.reshape((1, -1) + (1,) * (x.ndim - 2)) + 0.0 * x
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _move_stats(self, mean, var) -> None:
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)

    def _global_batch(self, x):
        dims = [d for d in range(x.ndim) if d != 1]
        count = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype, device=x.device)
        stats = all_reduce_sum(torch.cat([x.sum(dims), (x * x).sum(dims), count]))
        c = x.shape[1]
        n = stats[2 * c]
        mean, mean2 = stats[:c] / n, stats[c:2 * c] / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        with torch.no_grad():
            self._move_stats(mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.ndim - 2)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)


class CoordConv2d(nn.Module):
    """``CoordConv2d`` of the JAX package (reference base_nets.py:1287 — Liu
    et al. 2018 CoordConv) over channels-first [B, C, H, W]: the normalized
    (y, x) coordinate channels, each ``linspace(-1, 1)`` over its axis, are
    appended after the input's channels, then ``conv`` (flax's ``Conv``,
    "SAME" padding) maps the C + 2 channels to ``features``."""

    def __init__(self, in_channels: int, features: int, kernel_size: tuple = (3, 3),
                 stride: int = 1):
        super().__init__()
        self.conv = Conv(in_channels + 2, features, kernel_size, stride=stride, padding="SAME")

    def forward(self, x):
        b, _, h, w = x.shape
        ys = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
        xs = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
        coords = torch.stack([ys[:, None].expand(h, w), xs[None, :].expand(h, w)])
        return self.conv(torch.cat([x, coords.expand(b, 2, h, w)], dim=1))


class FeatureAggregator(nn.Module):
    """Aggregate features over an axis (reference base_nets.py:1688 —
    average pooling over e.g. multiple camera streams); no parameters."""

    def __init__(self, dim: int = 1, agg_type: str = "avg"):
        super().__init__()
        self.dim, self.agg_type = dim, agg_type

    def forward(self, x):
        assert self.agg_type == "avg"
        return torch.mean(x, dim=self.dim)


class FiLMLayer(nn.Module):
    """Feature-wise linear modulation (``FiLMLayer`` of the JAX package):
    ``TorchLinear_0`` maps the condition [B, Dc] to (gamma, beta) [B, C]
    each, and ``gamma * x + beta`` is broadcast over the spatial dims of a
    channels-first x."""

    def __init__(self, feature_dim: int, cond_dim: int):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(cond_dim, 2 * feature_dim)

    def forward(self, x, cond):
        gamma, beta = self.TorchLinear_0(cond).chunk(2, dim=-1)
        shape = gamma.shape + (1,) * (x.ndim - 2)
        return gamma.reshape(shape) * x + beta.reshape(shape)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)``, and 0 for an empty ``x`` (a data-parallel rank that
    holds no rows), where the mean would be NaN."""
    return torch.mean(x) if x.numel() else x.sum()


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None,
            train: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: ``where(u < 1 - p, x / (1 - p), 0)`` with u drawn
    from ``generator`` (on ``x``'s device); identity outside training or at
    p = 0. Keeps ``x``'s dtype. ``F.dropout`` takes no generator, so the
    mask is drawn here, as the whole batch would draw it under a
    data-parallel mesh (``parallel.mesh.draw_rows``)."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - p
    u = draw_rows(lambda shape: torch.rand(shape, generator=generator, device=x.device), x.shape)
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
