"""The selective scan of the Mamba mixer: plain PyTorch and a fused kernel.

For x, dt [b, t, d], A [d, n], B, C [b, t, n] and D [d], per channel and
state

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t        (h_{-1} = 0)
    y_t = C_t . h_t + D x_t

- ``selective_scan_reference``: the recurrence as a sequential loop over t
  in fp32 (the JAX package's ``associative_scan`` written as its
  definition), autograd through every step. It writes exp(dt A) and
  dt B x as [b, t, d, n] tensors and autograd keeps each step's state.
- ``scan_forward_plain`` / ``scan_backward_plain``: the plain versions of
  the kernel's forward and backward, in any dtype: the backward recomputes
  the states and runs the adjoint dh_t = C_t dy_t + exp(dt_{t+1} A) dh_{t+1}
  back over t, as the kernel does.
- ``SelectiveScan``: the autograd Function over the two: the kernels of
  ``csrc/selective_scan.cu`` on CUDA tensors, the plain versions on CPU
  tensors (which is how the CPU tests hold its backward to autograd).
- ``selective_scan_cuda``: the Function on the card; raises on anything
  else. ``selective_scan_cuda.launches`` counts its forward and backward
  calls, ``selective_scan_cuda.elems`` the elements (b, t, d, n) they
  scanned, registered with ``utils/profile_utils`` at import as the
  counters ``ssm_scan_launches`` and ``ssm_scan_elems``.
- ``selective_scan``: the dispatcher the Mamba block's composed path calls:
  the kernel on a CUDA tensor, the plain loop on a CPU tensor. y comes back
  in x's dtype; the state is fp32 (the kernel's inputs are cast to fp32).
- The gated scan, the Mamba block's fused path (mamba_ssm's
  ``delta_softplus`` and ``z``): out = y * silu(z), y the scan of x with
  the step softplus(dt), dt being ``dt_proj``'s output and z the gate half
  of ``in_proj``'s, both in the Dense layers' dtype (fp32 or bf16), out in
  that dtype too; the softplus, the scan, its state and the gate in fp32.
  ``gated_scan_forward_plain`` / ``gated_scan_backward_plain`` are the
  kernels' plain versions, ``GatedScan`` the autograd Function (kernels on
  CUDA tensors, plain versions on CPU tensors) and ``gated_selective_scan``
  its caller. Its calls count in ``selective_scan_cuda``'s counters too.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.utils import profile_utils

MAX_STATE = 32  # csrc/selective_scan.cu: one warp's lanes per channel
# the gated kernels' element types (and the conv's), csrc/ssm_mixer.cuh's Dtype codes
GATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def selective_scan_reference(x, dt, A, B, C, D):
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


def _states(x, dt, A, B):
    """Every step's state [b, t, d, n] in the inputs' dtype."""
    h = torch.zeros(x.shape[0], x.shape[2], A.shape[1], dtype=x.dtype, device=x.device)
    out = []
    for i in range(x.shape[1]):
        h = torch.exp(dt[:, i, :, None] * A) * h + (dt[:, i] * x[:, i])[:, :, None] * B[:, i, None]
        out.append(h)
    return torch.stack(out, 1)


def scan_forward_plain(x, dt, A, B, C, D):
    """The kernel's forward in the inputs' dtype: y [b, t, d]."""
    return torch.einsum("btdn,btn->btd", _states(x, dt, A, B), C) + x * D


def scan_backward_plain(x, dt, A, B, C, D, dy):
    """The kernel's backward in the inputs' dtype: (dx, ddt, dA, dB, dC, dD)
    of y = scan_forward_plain(...) for the output's gradient dy."""
    h = _states(x, dt, A, B)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    eA = torch.exp(dt[..., None] * A)  # [b, t, d, n]
    dh = torch.zeros_like(h[:, 0])
    dhs = [None] * x.shape[1]
    for i in reversed(range(x.shape[1])):
        dh = dh + C[:, i, None] * dy[:, i, :, None]
        dhs[i] = dh
        dh = eA[:, i] * dh
    dh = torch.stack(dhs, 1)
    dx = (dh * B[:, :, None]).sum(-1) * dt + D * dy
    ddt = (dh * (h_prev * eA * A + B[:, :, None] * x[..., None])).sum(-1)
    dA = (dh * h_prev * eA * dt[..., None]).sum((0, 1))
    dB = (dh * (dt * x)[..., None]).sum(2)
    dC = (h * dy[..., None]).sum(2)
    dD = (dy * x).sum((0, 1))
    return dx, ddt, dA, dB, dC, dD


def gated_scan_forward_plain(x, dt, A, B, C, D, z):
    """The gated kernel's forward in A's dtype: out = y * silu(z) [b, t, d]
    in z's dtype, y the scan with the step softplus(dt)."""
    f = A.dtype
    y = scan_forward_plain(x.to(f), F.softplus(dt.to(f)), A, B.to(f), C.to(f), D)
    return (y * F.silu(z.to(f))).to(z.dtype)


def gated_scan_backward_plain(x, dt, A, B, C, D, z, dout):
    """The gated kernel's backward in A's dtype: (dx, ddt, dA, dB, dC, dD,
    dz) of ``gated_scan_forward_plain`` for out's gradient dout, ddt and dz
    in dt's and z's dtype; softplus' and silu' as torch writes them."""
    f = A.dtype
    x, dtr, B, C, zf, g = (v.to(f) for v in (x, dt, B, C, z, dout))
    step = F.softplus(dtr)
    y = scan_forward_plain(x, step, A, B, C, D)
    s = torch.sigmoid(zf)
    dz = g * y * s * (1 + zf * (1 - s))
    dx, dstep, dA, dB, dC, dD = scan_backward_plain(x, step, A, B, C, D, g * F.silu(zf))
    e = torch.exp(dtr)
    ddt = torch.where(dtr > 20, dstep, dstep * e / (e + 1))
    return dx, ddt.to(dt.dtype), dA, dB, dC, dD, dz.to(z.dtype)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """``_build.load``'s declaration of ``csrc/selective_scan.cu``'s entry
    points; its largest state must be this module's."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_fwd_launch.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
    lib.selective_scan_fwd_launch.restype = i32
    lib.selective_scan_bwd_launch.argtypes = [ptr] * 14 + [i32] * 4 + [ptr]
    lib.selective_scan_bwd_launch.restype = i32
    lib.selective_scan_gated_fwd_launch.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.selective_scan_gated_fwd_launch.restype = i32
    lib.selective_scan_gated_bwd_launch.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
    lib.selective_scan_gated_bwd_launch.restype = i32
    lib.selective_scan_bwd_scratch_elems.argtypes = [i32] * 4
    lib.selective_scan_bwd_scratch_elems.restype = ctypes.c_size_t
    lib.selective_scan_max_batch.restype = i32
    if lib.selective_scan_max_state() != MAX_STATE:
        raise RuntimeError("selective_scan: the library's largest state differs from "
                           "ops/selective_scan.py's")


def _lib() -> ctypes.CDLL:
    return _build.load("selective_scan", _declare)


def _check(x, dt, A, B, C, D, z=None) -> None:
    """Raise unless the kernels take these tensors: with the gate z, dt and
    z of one of ``GATE_DTYPES``, dt contiguous and z's rows evenly spaced."""
    ts = (x, dt, A, B, C, D) + (() if z is None else (z,))
    if not all(t.is_cuda and t.device == x.device for t in ts):
        raise ValueError("the selective scan kernel takes tensors on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    fp32 = (x, A, B, C, D) + ((dt,) if z is None else ())
    if not all(t.dtype == torch.float32 and t.is_contiguous() for t in fp32):
        raise ValueError("the selective scan kernel takes contiguous float32 tensors")
    b, t, d = x.shape
    n = A.shape[1]
    if z is not None and not (dt.dtype == z.dtype and z.dtype in GATE_DTYPES
                              and dt.is_contiguous() and z.shape == x.shape
                              and z.stride(2) == 1 and z.stride(0) == t * z.stride(1)):
        raise ValueError(f"the gated scan takes dt and z [b, t, d] of one of "
                         f"{list(GATE_DTYPES)}, dt contiguous and z's rows evenly spaced, got "
                         f"{dt.dtype} dt, {z.dtype} z of strides {z.stride()}")
    if (dt.shape != x.shape or A.shape != (d, n) or B.shape != (b, t, n)
            or C.shape != (b, t, n) or D.shape != (d,)):
        raise ValueError("the selective scan takes x, dt [b, t, d], A [d, n], B, C [b, t, n], "
                         f"D [d], got {[tuple(v.shape) for v in ts]}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"the selective scan kernel takes 1 to {MAX_STATE} states, got {n}")
    width = d if z is None else max(d, z.stride(1))
    if min(b, t, d) == 0 or b * t * max(width, n) >= 2**31:
        raise ValueError(f"the selective scan kernel takes non-empty inputs of fewer than "
                         f"2**31 elements, got {tuple(x.shape)} and {n} states")


def _forward_cuda(x, dt, A, B, C, D):
    _check(x, dt, A, B, C, D)
    y = torch.empty_like(x)
    (b, t, d), n = x.shape, A.shape[1]
    _build.launch(_lib(), "selective_scan_fwd_launch", x.device,
                  *[v.data_ptr() for v in (x, dt, A, B, C, D, y)], b, t, d, n)
    selective_scan_cuda.launches += 1
    selective_scan_cuda.elems += b * t * d * n
    return y


def _backward_cuda(x, dt, A, B, C, D, dy, z=None, steps=None):
    """The gradients of the plain call's inputs, or with the gate z and the
    forward's steps of the gated call's (dy then out's gradient): (dx, ddt,
    dA, dB, dC, dD), and dz last when gated."""
    b, t, d = x.shape
    n = A.shape[1]
    if b > _lib().selective_scan_max_batch():
        raise ValueError(f"the selective scan's backward takes at most "
                         f"{_lib().selective_scan_max_batch()} sequences, got {b}")
    out = [torch.empty_like(v) for v in (x, dt, A, B, C, D)]
    scratch = torch.empty(_lib().selective_scan_bwd_scratch_elems(b, t, d, n),
                          dtype=torch.float32, device=x.device)
    if z is None:
        _build.launch(_lib(), "selective_scan_bwd_launch", x.device,
                      *[v.data_ptr() for v in (x, dt, A, B, C, D, dy, *out, scratch)], b, t, d, n)
    else:
        out.append(torch.empty(b, t, d, dtype=z.dtype, device=z.device))
        dx, ddt, dA, dB, dC, dD, dz = out
        _build.launch(_lib(), "selective_scan_gated_bwd_launch", x.device,
                      *[v.data_ptr() for v in (x, dt, A, B, C, D, z, steps, dy, dx, ddt, dz, dA,
                                               dB, dC, dD, scratch)],
                      b, t, d, n, z.stride(1), GATE_DTYPES[z.dtype])
    selective_scan_cuda.launches += 1
    selective_scan_cuda.elems += b * t * d * n
    return tuple(out)


def _gated_forward_cuda(x, dt, A, B, C, D, z, keep_steps: bool = True):
    """(out, the fp32 steps softplus(dt), which the backward reads, or None
    without ``keep_steps``: then the kernel writes none)."""
    _check(x, dt, A, B, C, D, z)
    (b, t, d), n = x.shape, A.shape[1]
    out = torch.empty(b, t, d, dtype=z.dtype, device=x.device)
    steps = torch.empty_like(x) if keep_steps else None
    _build.launch(_lib(), "selective_scan_gated_fwd_launch", x.device,
                  *[v.data_ptr() for v in (x, dt, A, B, C, D, z, out)],
                  None if steps is None else steps.data_ptr(), b, t, d, n,
                  z.stride(1), GATE_DTYPES[z.dtype])
    selective_scan_cuda.launches += 1
    selective_scan_cuda.elems += b * t * d * n
    return out, steps


class SelectiveScan(torch.autograd.Function):
    """y = scan(x, dt, A, B, C, D): the kernels on CUDA tensors, their plain
    versions on CPU tensors. Only the inputs are kept for the backward,
    which recomputes the states."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        ctx.save_for_backward(x, dt, A, B, C, D)
        if x.is_cuda:
            return _forward_cuda(x, dt, A, B, C, D)
        return scan_forward_plain(x, dt, A, B, C, D)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        if dy.is_cuda:
            return _backward_cuda(*saved, dy.contiguous())
        return scan_backward_plain(*saved, dy)


def selective_scan_cuda(x, dt, A, B, C, D):
    """The fused scan on the card: inputs cast to contiguous fp32, y [b, t, d]
    in x's dtype. Raises on CPU tensors."""
    if not x.is_cuda:
        raise ValueError(f"selective_scan_cuda takes CUDA tensors, got {x.device}")
    y = SelectiveScan.apply(*(v.float().contiguous() for v in (x, dt, A, B, C, D)))
    return y.to(x.dtype)


selective_scan_cuda.launches = 0
selective_scan_cuda.elems = 0
profile_utils.register({"ssm_scan_launches": lambda: selective_scan_cuda.launches,
                        "ssm_scan_elems": lambda: selective_scan_cuda.elems})


def selective_scan(x, dt, A, B, C, D):
    """The kernel on a CUDA tensor, the plain loop on a CPU tensor."""
    if x.is_cuda:
        return selective_scan_cuda(x, dt, A, B, C, D)
    return selective_scan_reference(x, dt, A, B, C, D)


class GatedScan(torch.autograd.Function):
    """out = y * silu(z), y = scan(x, softplus(dt), A, B, C, D): the gated
    kernels on CUDA tensors, their plain versions on CPU tensors. The
    inputs are kept for the backward, which recomputes the states and y,
    and on the card the forward's fp32 steps where ``keep_steps`` (a
    backward may follow)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, z, keep_steps: bool):
        if x.is_cuda:
            out, steps = _gated_forward_cuda(x, dt, A, B, C, D, z, keep_steps)
        else:
            out, steps = gated_scan_forward_plain(x, dt, A, B, C, D, z), None
        ctx.save_for_backward(x, dt, A, B, C, D, z, steps)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, dt, A, B, C, D, z, steps = ctx.saved_tensors
        if dout.is_cuda:
            return *_backward_cuda(x, dt, A, B, C, D, dout.contiguous(), z, steps), None
        return *gated_scan_backward_plain(x, dt, A, B, C, D, z, dout), None


def gated_selective_scan(x, dt, A, B, C, D, z):
    """``GatedScan`` of the mixer's tensors: x [b, t, d] fp32, dt [b, t, d]
    ``dt_proj``'s output, A [d, n], B, C [b, t, n], D [d], z [b, t, d] the
    gate (rows evenly spaced) -> out [b, t, d] in z's dtype. The steps are
    kept only where a gradient may be taken."""
    ins = (x, dt, A, B, C, D, z)
    keep = torch.is_grad_enabled() and any(v.requires_grad for v in ins)
    return GatedScan.apply(x, dt.contiguous(), A.contiguous(), B.contiguous(), C.contiguous(),
                           D, z, keep)
