"""The Mamba mixer's fused chain on the CPU: the plain versions of the
causal conv + SiLU kernels (``ops/causal_conv1d.py``) and of the gated scan
(``ops/selective_scan.py``: softplus of dt, the scan, y * silu(z)) against
autograd of ``MambaBlock``'s composed chain, and the block's fused path
(``MambaBlock._fused``, which the card takes) against its composed path.

Tolerances: float64 gradchecks; in fp32 each element within 1e-5 of its
value plus 1e-6 of the tensor's largest (sums in another order: the plain
scan's einsum against the reference loop, the conv's input gradient as one
sum against autograd's accumulation of the shifted slices). With bf16
Dense layers the two paths round the same values to bf16 at the same
places, so they differ where an fp32 difference in the last place crosses
a bf16 rounding boundary: up to 1 % of a tensor's largest element.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.mamba import MambaBlock
from lipvq_tpu_torch.ops import causal_conv1d as conv_ops
from lipvq_tpu_torch.ops import selective_scan as scan_ops
from lipvq_tpu_torch.utils import profile_utils

torch.set_num_threads(1)


def _composed_conv(x, w, bias):
    """The block's composed stencil and SiLU (``MambaBlock._composed``)."""
    t, k = x.shape[1], w.shape[0]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    return F.silu(sum(w[j] * xp[:, j:j + t] for j in range(k)) + bias)


def _conv_inputs(b, t, d, k, dtype, seed=0, stride_pad=0):
    """x as a half of a Dense output ([b, t, d + stride_pad], the first d
    channels), taps and bias."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(b, t, d + stride_pad, generator=g, dtype=dtype)
    w = torch.randn(k, d, generator=g, dtype=dtype) / k ** 0.5
    bias = torch.randn(d, generator=g, dtype=dtype) * 0.1
    return h, w, bias


def _close(got, want, name, rel=1e-5, of_max=1e-6):
    torch.testing.assert_close(got, want, rtol=rel, atol=of_max * float(want.abs().max()) + 1e-30,
                               msg=name)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("copy", [False, True])
def test_conv_function_gradcheck_in_float64(k, copy):
    h, w, bias = _conv_inputs(2, 5, 3, k, torch.float64, stride_pad=3)
    args = [h.requires_grad_(), w.requires_grad_(), bias.requires_grad_()]

    def fn(h, w, bias):
        return conv_ops.CausalConv1dSilu.apply(h[..., :3], w, bias, copy)

    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("b,t,d,k", [(3, 7, 1, 4), (2, 9, 24, 4), (4, 5, 33, 3), (2, 2, 24, 4),
                                     (1, 1, 33, 4), (5, 70, 26, 2)],
                         ids=["d1", "d24", "d33", "t_short", "t1", "t70"])
def test_conv_plain_versions_match_autograd_of_the_composed_stencil(b, t, d, k):
    """fp32, x a strided half: the forward equals the block's stencil bit
    for bit; the backward (with the copy's gradient added) matches autograd
    through it."""
    h, w, bias = _conv_inputs(b, t, d, k, torch.float32, seed=d + t, stride_pad=d)
    x = h[..., :d]
    args = [x.detach().requires_grad_(), w.requires_grad_(), bias.requires_grad_()]
    want = _composed_conv(*args)
    torch.testing.assert_close(conv_ops.conv_silu_forward_plain(*args), want, rtol=0, atol=0)
    g = torch.Generator().manual_seed(1)
    dxs, dxs_copy = (torch.randn(b, t, d, generator=g) for _ in range(2))
    want_grads = torch.autograd.grad(want, args, dxs + dxs_copy)
    got = conv_ops.conv_silu_backward_plain(*(a.detach() for a in args), dxs, dxs_copy)
    for name, a, e in zip(("dx", "dw", "dbias"), got, want_grads):
        _close(a, e, name)


def test_conv_copy_rounds_as_a_cast():
    h, w, bias = _conv_inputs(2, 6, 8, 4, torch.bfloat16)
    xs, xs_copy = conv_ops.CausalConv1dSilu.apply(h, w.float(), bias.float(), True)
    assert xs.dtype == torch.float32 and xs_copy.dtype == torch.bfloat16
    assert torch.equal(xs_copy, xs.to(torch.bfloat16))
    torch.testing.assert_close(xs, _composed_conv(h, w.float(), bias.float()), rtol=0, atol=0)


def _gate_inputs(b, t, d, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=g, dtype=dtype)
    dt = torch.randn(b, t, d, generator=g, dtype=dtype) - 1.0
    A = -torch.rand(d, n, generator=g, dtype=dtype) - 0.1
    B, C = (torch.randn(b, t, n, generator=g, dtype=dtype) for _ in range(2))
    D = torch.randn(d, generator=g, dtype=dtype)
    z = torch.randn(b, t, d, generator=g, dtype=dtype)
    return [x, dt, A, B, C, D, z]


def _composed_gate(x, dt, A, B, C, D, z):
    """softplus, the reference scan and the gate as the block composes them."""
    y = scan_ops.selective_scan_reference(x, F.softplus(dt.float()), A, B, C, D)
    return y * F.silu(z.float())


def test_gated_scan_function_gradcheck_in_float64():
    args = [v.requires_grad_() for v in _gate_inputs(2, 5, 3, 4, torch.float64)]
    # a step past softplus's threshold
    with torch.no_grad():
        args[1][0, 0, 0] = 21.0
    assert torch.autograd.gradcheck(scan_ops.gated_selective_scan, args)


@pytest.mark.parametrize("b,t,d,n", [(3, 7, 1, 4), (2, 9, 24, 8), (4, 5, 33, 16), (2, 40, 26, 3)],
                         ids=["d1", "d24", "d33", "t40"])
def test_gated_scan_plain_versions_match_autograd_of_the_composed_chain(b, t, d, n):
    args = [v.requires_grad_() for v in _gate_inputs(b, t, d, n, torch.float32, seed=d)]
    want = _composed_gate(*args)
    got = scan_ops.gated_scan_forward_plain(*(a.detach() for a in args))
    _close(got, want.detach(), "out")
    dout = torch.randn(b, t, d, generator=torch.Generator().manual_seed(2))
    want_grads = torch.autograd.grad(want, args, dout)
    got_grads = scan_ops.gated_scan_backward_plain(*(a.detach() for a in args), dout)
    for name, a, e in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dz"), got_grads, want_grads):
        _close(a, e, name, rel=1e-4, of_max=1e-5)


def _block(d_model, compute_dtype=None, d_conv=4, seed=0, **kwargs):
    block = seeded_init(MambaBlock(d_model, d_conv=d_conv, compute_dtype=compute_dtype, **kwargs),
                        torch.Generator().manual_seed(seed))
    with torch.no_grad():  # spread the decays and steps as Mamba's init does
        block.A_log.add_(torch.rand(block.A_log.shape, generator=torch.Generator().manual_seed(1)))
        block.conv_bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    return block


def _both_paths(block, x):
    """(output, input gradient, parameter gradients) of the block's composed
    and fused paths from in_proj's output on, for one output gradient."""
    dout = torch.randn(*x.shape[:2], block.out_proj.weight.shape[0],
                       generator=torch.Generator().manual_seed(3))
    got = []
    for path in (block._composed, block._fused):
        xi = x.detach().requires_grad_()
        h = block.in_proj(xi) if block.compute_dtype is None else F.linear(
            xi.to(block.compute_dtype), block.in_proj.weight.to(block.compute_dtype))
        out = path(h)
        names, params = zip(*sorted(block.named_parameters()))
        grads = torch.autograd.grad(out, [xi, *params], dout.to(out.dtype))
        got.append((out.detach().float(), grads[0], dict(zip(names, grads[1:]))))
    return got


@pytest.mark.parametrize("d_model,t,d_conv,norm", [(12, 7, 4, True), (13, 3, 4, False),
                                                   (17, 9, 3, False), (24, 2, 4, True)],
                         ids=["d_inner24", "d_inner26_t_short", "d_inner34_conv3", "t2"])
def test_fused_block_matches_the_composed_block_in_fp32(d_model, t, d_conv, norm):
    block = _block(d_model, d_conv=d_conv, d_state=8, dt_bc_norm=norm)
    x = torch.randn(3, t, d_model, generator=torch.Generator().manual_seed(4))
    (out_c, dx_c, g_c), (out_f, dx_f, g_f) = _both_paths(block, x)
    _close(out_f, out_c, "out", rel=1e-4, of_max=1e-5)
    _close(dx_f, dx_c, "dx", rel=1e-4, of_max=1e-5)
    assert set(g_f) == set(g_c)
    for name in g_c:
        _close(g_f[name], g_c[name], name, rel=1e-4, of_max=1e-5)


def test_fused_block_matches_the_composed_block_in_bf16():
    block = _block(32, compute_dtype=torch.bfloat16, d_state=16, dt_rank=8, dt_bc_norm=True)
    x = torch.randn(4, 9, 32, generator=torch.Generator().manual_seed(5))
    (out_c, dx_c, g_c), (out_f, dx_f, g_f) = _both_paths(block, x)
    _close(out_f, out_c, "out", rel=0, of_max=1e-2)
    _close(dx_f, dx_c, "dx", rel=0, of_max=1e-2)
    for name in g_c:
        _close(g_f[name], g_c[name], name, rel=0, of_max=1e-2)


def test_the_cpu_takes_the_composed_chain_and_counts_nothing():
    block = _block(12, d_state=8)
    x = torch.randn(2, 5, 12)
    h = block.in_proj(x)
    assert not block._fuses(h)
    profile_utils.reset()
    before = profile_utils.totals()["counters"]
    assert {"ssm_mixer_fused", "ssm_mixer_composed"} <= set(before)
    torch.testing.assert_close(block(x), block._composed(h), rtol=0, atol=0)
    after = profile_utils.totals()["counters"]
    assert (after["ssm_mixer_fused"], after["ssm_mixer_composed"]) == (0, 0)
    assert after["causal_conv1d_launches"] == 0


def test_the_kernels_refuse_what_they_do_not_take():
    """``causal_conv1d.fuses``' conditions that hold off the card too."""
    x = torch.randn(2, 3, 8)
    assert not conv_ops.fuses(x, torch.randn(4, 8))  # the CPU
    with pytest.raises(ValueError, match="CUDA"):
        scan_ops.selective_scan_cuda(*_gate_inputs(1, 2, 3, 4, torch.float32)[:6])
