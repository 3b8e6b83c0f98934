"""The Mamba mixer's depthwise causal convolution + bias + SiLU: plain
PyTorch and a fused kernel, forward and backward.

For x [b, t, d] (the x half of ``in_proj``'s output, rows any distance
apart), taps w [k, d] and bias [d], per channel

    pre[s] = sum_j w[j] x[s - k + 1 + j] + bias     (x[s] = 0 for s < 0)
    xs[s]  = silu(pre[s])

- ``conv_silu_forward_plain`` / ``conv_silu_backward_plain``: the plain
  versions of the kernels in the taps' dtype: the forward is
  ``MambaBlock``'s composed stencil; the backward takes the gradient of xs
  and of its copy in x's dtype, adds them and returns (dx in x's dtype, dw,
  dbias).
- ``CausalConv1dSilu``: the autograd Function over the two: the kernels of
  ``csrc/causal_conv1d.cu`` on CUDA tensors, the plain versions on CPU
  tensors. With ``copy`` it also returns xs rounded to x's dtype (the next
  Dense layer's operand, as a cast rounds it), whose gradient the backward
  adds to xs's in fp32.
- ``causal_conv1d_silu``: the Function's caller, which checks what the
  kernels take (``fuses``). ``causal_conv1d_silu.launches`` counts the
  kernels' calls on the card, one a forward and one a backward, registered
  with ``utils/profile_utils`` at import as the counter
  ``causal_conv1d_launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.ops.selective_scan import GATE_DTYPES as DTYPES
from lipvq_tpu_torch.utils import profile_utils

MAX_WIDTH = 4  # csrc/causal_conv1d.cu: the widths it is built for
MAX_STEPS = 2**20  # within csrc/causal_conv1d.cu's grid of 64-step chunks


def conv_silu_forward_plain(x, w, bias):
    """silu(causal depthwise conv(x) + bias) in w's dtype, as the Mamba
    block composes it: x [b, t, d], w [k, d], bias [d] -> [b, t, d]."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x.to(w.dtype), (0, 0, k - 1, 0))
    return F.silu(sum(w[j] * xp[:, j:j + t] for j in range(k)) + bias)


def conv_silu_backward_plain(x, w, bias, dxs, dxs_copy=None):
    """(dx in x's dtype, dw, dbias) of ``conv_silu_forward_plain`` for the
    gradient dxs of its output, plus ``dxs_copy`` (the gradient of the
    output's copy) where given, added in w's dtype."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x.to(w.dtype), (0, 0, k - 1, 0))
    pre = sum(w[j] * xp[:, j:j + t] for j in range(k)) + bias
    g = dxs if dxs_copy is None else dxs + dxs_copy.to(dxs.dtype)
    s = torch.sigmoid(pre)
    gp = g * s * (1 + pre * (1 - s))
    gpp = F.pad(gp, (0, 0, 0, k - 1))
    dx = sum(w[j] * gpp[:, k - 1 - j:k - 1 - j + t] for j in range(k))
    dw = torch.stack([(gp * xp[:, j:j + t]).sum((0, 1)) for j in range(k)])
    return dx.to(x.dtype), dw, gp.sum((0, 1))


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """``_build.load``'s declaration of ``csrc/causal_conv1d.cu``'s entry
    points; its widest stencil must be this module's."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.causal_conv1d_fwd_launch.argtypes = [ptr, i32] + [ptr] * 4 + [i32] * 5 + [ptr]
    lib.causal_conv1d_fwd_launch.restype = i32
    lib.causal_conv1d_bwd_launch.argtypes = [ptr, i32] + [ptr] * 7 + [i32] * 5 + [ptr]
    lib.causal_conv1d_bwd_launch.restype = i32
    lib.causal_conv1d_bwd_scratch_elems.argtypes = [i32] * 4
    lib.causal_conv1d_bwd_scratch_elems.restype = ctypes.c_size_t
    if lib.causal_conv1d_max_width() != MAX_WIDTH:
        raise RuntimeError("causal_conv1d: the library's widest stencil differs from "
                           "ops/causal_conv1d.py's")


def _lib() -> ctypes.CDLL:
    return _build.load("causal_conv1d", _declare)


def _rows(x) -> torch.Tensor:
    """x itself where its rows are evenly spaced with unit channel stride
    (a half of a contiguous Dense output), else a contiguous copy."""
    b, t, _ = x.shape
    if x.stride(2) == 1 and x.stride(0) == t * x.stride(1):
        return x
    return x.contiguous()


def fuses(x, w) -> bool:
    """Whether the kernels take x [b, t, d] and taps w [k, d]: one CUDA
    device, x fp32 or bf16, w and the bias fp32, 1 <= k <= MAX_WIDTH, and
    indices within 32 bits."""
    b, t, d = x.shape
    return (x.is_cuda and w.device == x.device and x.dtype in DTYPES
            and w.dtype == torch.float32 and 1 <= w.shape[0] <= MAX_WIDTH
            and min(b, t, d) > 0 and b * t * max(d, x.stride(1)) < 2**31 and t <= MAX_STEPS)


def _forward_cuda(x, w, bias, copy: bool):
    b, t, d = x.shape
    xs = torch.empty(b, t, d, dtype=torch.float32, device=x.device)
    xs_copy = torch.empty(b, t, d, dtype=x.dtype, device=x.device) if copy else None
    _build.launch(_lib(), "causal_conv1d_fwd_launch", x.device, x.data_ptr(), x.stride(1),
                  w.data_ptr(), bias.data_ptr(), xs.data_ptr(),
                  xs_copy.data_ptr() if copy else None, b, t, d, w.shape[0], DTYPES[x.dtype])
    causal_conv1d_silu.launches += 1
    return xs, xs_copy


def _backward_cuda(x, w, bias, dxs, dxs_copy):
    b, t, d = x.shape
    k = w.shape[0]
    dx = torch.empty(b, t, d, dtype=x.dtype, device=x.device)
    dwb = torch.empty(k + 1, d, dtype=torch.float32, device=x.device)
    scratch = torch.empty(_lib().causal_conv1d_bwd_scratch_elems(b, t, d, k),
                          dtype=torch.float32, device=x.device)
    _build.launch(_lib(), "causal_conv1d_bwd_launch", x.device, x.data_ptr(), x.stride(1),
                  w.data_ptr(), bias.data_ptr(), dxs.data_ptr(),
                  None if dxs_copy is None else dxs_copy.data_ptr(), dx.data_ptr(),
                  dwb.data_ptr(), scratch.data_ptr(), b, t, d, k, DTYPES[x.dtype])
    causal_conv1d_silu.launches += 1
    return dx, dwb[:k], dwb[k]


class CausalConv1dSilu(torch.autograd.Function):
    """xs = silu(conv(x) + bias) in fp32 (the taps' dtype on the CPU) and,
    with ``copy``, xs in x's dtype: the kernels on CUDA tensors, the plain
    versions on CPU tensors. Only the inputs are kept for the backward,
    which recomputes the pre-activation."""

    @staticmethod
    def forward(ctx, x, w, bias, copy: bool):
        ctx.save_for_backward(x, w, bias)
        if x.is_cuda:
            xs, xs_copy = _forward_cuda(x, w, bias, copy)
        else:
            xs = conv_silu_forward_plain(x, w, bias)
            xs_copy = xs.to(x.dtype, copy=True) if copy else None
        return (xs, xs_copy) if copy else xs

    @staticmethod
    def backward(ctx, dxs, dxs_copy=None):
        x, w, bias = ctx.saved_tensors
        if dxs.is_cuda:
            dxs_copy = None if dxs_copy is None else dxs_copy.contiguous()
            dx, dw, db = _backward_cuda(x, w, bias, dxs.contiguous(), dxs_copy)
        else:
            dx, dw, db = conv_silu_backward_plain(x, w, bias, dxs, dxs_copy)
        return dx, dw, db, None


def causal_conv1d_silu(x, w, bias, copy: bool = False):
    """``CausalConv1dSilu`` of x [b, t, d] (rows evenly spaced or copied to
    be), taps w [k, d] and bias [d]; raises on CUDA tensors the kernels do
    not take."""
    if x.is_cuda and not fuses(x, w):
        raise ValueError(f"the causal conv kernel takes fp32 or bf16 x and fp32 taps of width "
                         f"1 to {MAX_WIDTH} on one CUDA device, got {x.dtype} x, "
                         f"{w.dtype} taps {tuple(w.shape)}")
    return CausalConv1dSilu.apply(_rows(x), w.contiguous(), bias.contiguous(), copy)


causal_conv1d_silu.launches = 0
profile_utils.register({"causal_conv1d_launches": lambda: causal_conv1d_silu.launches})
