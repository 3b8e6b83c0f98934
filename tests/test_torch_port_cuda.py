"""Kernels K1, K1f and K2, the selective scan, the Mamba mixer's causal conv
and gated scan, and the optimizer's two passes on the card against their
plain PyTorch versions (and torch's own step).

These tests need an NVIDIA GPU and nvcc and skip without them. The machine
with the card has no JAX, so this file imports none and runs without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import ctypes

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.ops import _build, causal_conv1d, fused_adamw, selective_scan, vq_lookup
from lipvq_tpu_torch.ops.vq_lookup import (
    FAST_MAX_D,
    TC,
    plan_fast,
    plan_lookup,
    tc_bound,
    tc_norms,
    tie_gap,
    vq_cluster_stats,
    vq_nearest,
    vq_nearest_cuda,
    vq_nearest_fast,
    vq_nearest_fast_reference,
    vq_nearest_reference,
    vq_nearest_with_stats,
    vq_nearest_with_stats_cuda,
    vq_nearest_with_stats_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _both(z, c, dev):
    zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
    got = vq_nearest_cuda(zt, ct)
    torch.cuda.synchronize()
    return got.cpu().numpy(), vq_nearest_reference(zt, ct).cpu().numpy()


@pytest.mark.parametrize("b,n,d", [(80, 128, 12), (300, 1024, 208), (512, 256, 64),
                                   (1, 1, 1), (70, 65, 791)])
def test_k1_equals_reference(cuda, b, n, d):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((b, d), dtype=np.float32)
    c = rng.standard_normal((n, d), dtype=np.float32)
    got, want = _both(z, c, cuda)
    np.testing.assert_array_equal(got, want)


def test_k1_ties_take_lowest_index(cuda):
    z = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    c = np.asarray([[5.0, 5.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]],
                   np.float32)
    got, _ = _both(z, c, cuda)
    np.testing.assert_array_equal(got, [1, 3])


def test_k1_wrapper_checks_and_counts(cuda):
    z = torch.zeros(4, 3, device=cuda)
    c = torch.zeros(8, 3, device=cuda)
    before = vq_nearest_cuda.launches
    with pytest.raises(ValueError):
        vq_nearest_cuda(z.double(), c.double())
    with pytest.raises(ValueError):
        vq_nearest_cuda(torch.zeros(3, 4, device=cuda).T, c)
    assert vq_nearest_cuda.launches == before
    vq_nearest(z, c)
    assert vq_nearest_cuda.launches == before + 1


# K2's sums add each code's rows in ascending order; the plain version's
# one_hot^T z is a cuBLAS fp32 product that may order them otherwise
SUMS_RTOL, SUMS_ATOL = 1e-5, 1e-5


def _k2_both(z, c, dev):
    zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
    got = vq_nearest_with_stats_cuda(zt, ct)
    torch.cuda.synchronize()
    want = vq_nearest_with_stats_reference(zt, ct)
    return [a.cpu().numpy() for a in got], [a.cpu().numpy() for a in want]


@pytest.mark.parametrize("b,n,d", [(300, 64, 16), (1, 1, 1), (70, 65, 791),
                                   (300, 1024, 208)])
def test_k2_equals_reference(cuda, b, n, d):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((b, d), dtype=np.float32)
    c = rng.standard_normal((n, d), dtype=np.float32)
    (ids, counts, sums), (want_ids, want_counts, want_sums) = _k2_both(z, c, cuda)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(counts, want_counts)
    assert counts.sum() == b
    np.testing.assert_allclose(sums, want_sums, rtol=SUMS_RTOL, atol=SUMS_ATOL)


def test_k2_ties_take_lowest_index(cuda):
    z = np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]], np.float32)
    c = np.asarray([[5.0, 5.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]],
                   np.float32)
    (ids, counts, sums), _ = _k2_both(z, c, cuda)
    np.testing.assert_array_equal(ids, [1, 3, 1])
    np.testing.assert_array_equal(counts, [0, 2, 0, 1, 0])
    np.testing.assert_array_equal(sums, [[0, 0], [2, 0], [0, 0], [0, 1], [0, 0]])


def test_k2_sums_follow_row_order_and_repeat_bit_for_bit(cuda):
    """Many rows on few codes: the sums equal a sequential fp32 sum over
    ascending rows, exactly, and a second call gives the same bits."""
    rng = np.random.default_rng(1)
    z = (rng.standard_normal((4000, 33)) * 10.0 ** rng.integers(-3, 3, (4000, 1))
         ).astype(np.float32)
    c = rng.standard_normal((5, 33)).astype(np.float32)
    zt, ct = torch.from_numpy(z).to(cuda), torch.from_numpy(c).to(cuda)
    ids, counts, sums = vq_nearest_with_stats_cuda(zt, ct)
    again = vq_nearest_with_stats_cuda(zt, ct)
    torch.cuda.synchronize()
    for a, b in zip((ids, counts, sums), again):
        assert torch.equal(a, b)
    ids_np = ids.cpu().numpy()
    want = np.zeros((5, 33), np.float32)
    for r in range(len(z)):
        want[ids_np[r]] += z[r]  # one fp32 add per row, ascending
    np.testing.assert_array_equal(sums.cpu().numpy(), want)
    ref_counts, _ = vq_cluster_stats(zt, ids, 5)
    assert torch.equal(counts, ref_counts)


def test_k2_wrapper_checks_and_counts(cuda):
    z = torch.zeros(4, 3, device=cuda)
    c = torch.zeros(8, 3, device=cuda)
    before = vq_nearest_with_stats_cuda.launches
    k1_before = vq_nearest_cuda.launches
    with pytest.raises(ValueError):
        vq_nearest_with_stats_cuda(z.double(), c.double())
    with pytest.raises(ValueError):
        vq_nearest_with_stats_cuda(torch.zeros(3, 4, device=cuda).T, c)
    with pytest.raises(ValueError):
        vq_nearest_with_stats_cuda(z.cpu(), c)
    with pytest.raises(ValueError):
        vq_nearest_with_stats_cuda(z, torch.zeros(8, 4, device=cuda))
    assert vq_nearest_with_stats_cuda.launches == before
    ids, counts, sums = vq_nearest_with_stats(z, c)
    assert vq_nearest_with_stats_cuda.launches == before + 1
    assert vq_nearest_cuda.launches == k1_before  # K2 does not go through K1's wrapper
    assert ids.is_cuda and counts.shape == (8,) and sums.shape == (8, 3)


def _dyadic(rng, shape):
    """k/8 with |k| < 256: exact in bf16, every sum exact in fp32."""
    return (np.round(np.clip(rng.standard_normal(shape) * 8, -255, 255)) / 8).astype(np.float32)


# All three lookup configurations and their ragged edges. With the SM count
# taken as 1 the plan picks MEDIUM up to 128 rows and LARGE from 129 on, with
# one code split; with the card's own count, SMALL (up to 256 rows at
# N = 1024, and at N <= 65) and MEDIUM, with code splits.
SHAPES_B = [1, 63, 65, 160, 500, 4097]
SHAPES_N = [1, 65, 1024]
SHAPES_D = [1, 3, 208, 791]


@pytest.fixture(params=["card_sms", "one_sm"])
def plan_sms(request, cuda, monkeypatch):
    import lipvq_tpu_torch.ops.vq_lookup as vq_lookup

    monkeypatch.setattr(vq_lookup, "_PLANS", {})
    if request.param == "one_sm":
        monkeypatch.setattr(vq_lookup, "_SMS", {cuda.index or 0: 1})
    return request.param


def _ids_within_ties(z, c, got, want):
    """Ids may differ only where the chosen codes' fp64 distances differ by
    <= 1e-5 * max(1, d), the tie tolerance chip_smoke.py states."""
    bad = (got != want).nonzero().flatten()
    if bad.numel() == 0:
        return
    zb = z[bad].double()
    d_got = ((zb - c[got[bad].long()].double()) ** 2).sum(1)
    d_want = ((zb - c[want[bad].long()].double()) ** 2).sum(1)
    allowed = 1e-5 * torch.clamp(torch.minimum(d_got, d_want), min=1.0)
    assert bool(((d_got - d_want).abs() <= allowed).all()), f"{bad.numel()} ids differ"


def _gauss(b, n, d, dev, seed=0):
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
    return z, c


@pytest.mark.parametrize("d", SHAPES_D)
@pytest.mark.parametrize("n", SHAPES_N)
@pytest.mark.parametrize("b", SHAPES_B)
def test_k1_shapes_and_configs(cuda, plan_sms, b, n, d):
    z, c = _gauss(b, n, d, cuda)
    got = vq_nearest_cuda(z, c)
    torch.cuda.synchronize()
    assert got.shape == (b,) and got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < n
    _ids_within_ties(z, c, got, vq_nearest_reference(z, c))


# K1's tensor-core path (corpus-sized lookups) against the SIMT tiles: the
# same rows in 8192-row calls take MEDIUM, today's fp32 chain.
TC_ROWS, SIMT_ROWS = 1 << 16, 8192


def _corpus_latents(seed, rows, codes, dev, d=208):
    """LipVQ latents of 0.5 N(0, 1) actions under seeded encoder weights, the
    codebook the latents of other actions (the lowdim corpus cell's kind:
    sigmoid outputs close together, many near-ties)."""
    gen = torch.Generator().manual_seed(seed)
    w1, w2 = torch.randn(64, 12, generator=gen) / 12 ** 0.5, torch.randn(128, 64, generator=gen) / 8
    w = torch.randn(d, 128, generator=gen)
    ci = 3.0 + 0.3 * torch.randn(d, generator=gen)
    w = w * torch.clamp(torch.nn.functional.softplus(ci)[:, None] / w.abs().sum(1, keepdim=True),
                        max=1.0)
    gelu = torch.nn.functional.gelu

    def encode(x):
        return torch.sigmoid(gelu(gelu(x @ w1.T) @ w2.T) @ w.T).contiguous().to(dev)

    return (encode(0.5 * torch.randn(rows, 12, generator=gen)),
            encode(0.5 * torch.randn(codes, 12, generator=gen)))


def _tc_against_simt(z, c):
    """(ids of one tensor-core call, ids of the same rows in SIMT calls, the
    call's re-scored rows and every-code rows from the card's counters)."""
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    assert plan_lookup(z.shape[0], c.shape[0], sms, z.shape[1]).config == TC
    assert plan_lookup(SIMT_ROWS, c.shape[0], sms, z.shape[1]).config != TC
    launches = vq_nearest_cuda.tc_launches
    got = vq_nearest_cuda(z, c)
    counts = vq_lookup.rescored_rows()[z.device.index or 0]
    before = counts.clone()
    got = vq_nearest_cuda(z, c)
    after = counts.clone()
    want = torch.cat([vq_nearest_cuda(zc.contiguous(), c) for zc in z.split(SIMT_ROWS)])
    assert vq_nearest_cuda.tc_launches == launches + 2
    rescored, every = (after - before).tolist()
    return got, want, rescored, every


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2**31 + 5])
def test_k1_tensor_core_path_equals_the_simt_tiles_on_corpus_latents(cuda, seed):
    z, c = _corpus_latents(seed, TC_ROWS, 1024, cuda)
    got, want, rescored, every = _tc_against_simt(z, c)
    assert torch.equal(got, want)
    assert 0 < rescored < TC_ROWS and every <= rescored


@pytest.mark.parametrize("case", ["pairs", "copies"])
def test_k1_tensor_core_path_takes_the_lowest_of_duplicated_codes(cuda, case):
    """Exact ties: every code twice (re-scored over the candidates), or 41
    copies of one code (more than the lists hold: re-scored over every
    code); the ids must be the SIMT tiles' (lowest index)."""
    z, c = _corpus_latents(7, TC_ROWS, 1024, cuda)
    if case == "pairs":
        c[1::2] = c[0::2]
    else:
        c[100:140] = c[99]
        z[:64] = c[99]
    got, want, rescored, every = _tc_against_simt(z, c.contiguous())
    assert torch.equal(got, want)
    if case == "pairs":
        assert bool((got % 2 == 0).all()) and rescored > TC_ROWS // 2
    else:
        assert got[:64].tolist() == [99] * 64 and every >= 64


@pytest.mark.parametrize("gap_in_e", [0.0, 0.25, 0.5, 1.0, 2.0, 4.0])
def test_k1_tensor_core_path_near_ties_planted_at_the_bound(cuda, gap_in_e):
    """Rows between two codes, their distance gap a multiple of the bound E
    at the nearer: inside E + E both are candidates and K1's chain decides;
    beyond it the certificate does. Ids equal the SIMT tiles either way."""
    z, c = _corpus_latents(11, TC_ROWS, 1024, cuda)
    gen = torch.Generator().manual_seed(int(gap_in_e * 8))
    i = torch.randint(0, 1024, (4096,), generator=gen)
    j = (i + torch.randint(1, 1024, (4096,), generator=gen)) % 1024
    cc = c.cpu().double()
    delta = cc[i] - cc[j]
    mid = (cc[i] + cc[j]) / 2
    mu = c.cpu().mean(0)
    e = tc_bound(tc_norms(mid.float(), mu, rows=True), tc_norms(c.cpu(), mu, rows=False), 208)
    t = gap_in_e * e[torch.arange(4096), i] / (2.0 * (delta ** 2).sum(1))
    z[:4096] = (mid + t[:, None] * delta).float().to(cuda)
    got, want, _, _ = _tc_against_simt(z, c)
    assert torch.equal(got, want)


def test_k1_tensor_core_path_adds_no_host_sync(cuda):
    z, c = _corpus_latents(13, TC_ROWS, 1024, cuda)
    vq_nearest_cuda(z, c)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids = vq_nearest_cuda(z, c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ids.shape == (TC_ROWS,)


def test_k1_tensor_core_counters_reach_the_totals(cuda):
    from lipvq_tpu_torch.utils import profile_utils

    z, c = _corpus_latents(17, TC_ROWS, 1024, cuda)
    vq_nearest_cuda(z, c)
    counts = vq_lookup.rescored_rows()[cuda.index or 0]
    profile_utils.reset()
    before = counts.clone()
    vq_nearest_cuda(z, c)
    vq_nearest_cuda(z[:SIMT_ROWS].contiguous(), c)
    rescored, every = (counts - before).tolist()
    got = profile_utils.totals()["counters"]
    assert got["k1_launches"] == 2 and got["k1_tc_launches"] == 1
    assert got["k1_rescored_rows"] == rescored > 0
    assert got["k1_rescored_every_code_rows"] == every


def _sequential_sums(z, ids, n):
    """Each code's rows added one fp32 add at a time, ascending."""
    want = np.zeros((n, z.shape[1]), np.float32)
    np.add.at(want, ids.cpu().numpy(), z.cpu().numpy())
    return want


def _check_k2(z, c, got, order):
    ids, counts, sums = got
    n = c.shape[0]
    _ids_within_ties(z, c, ids, vq_nearest_reference(z, c))
    want_counts, _ = vq_cluster_stats(z, ids, n)
    assert torch.equal(counts, want_counts)
    assert torch.equal(order.long(), torch.argsort(ids.long(), stable=True))
    np.testing.assert_array_equal(sums.cpu().numpy(), _sequential_sums(z, ids, n))


@pytest.mark.parametrize("d", SHAPES_D)
@pytest.mark.parametrize("n", SHAPES_N)
@pytest.mark.parametrize("b", SHAPES_B)
def test_k2_shapes_and_configs(cuda, plan_sms, b, n, d):
    from lipvq_tpu_torch.ops.vq_lookup import _vq_stats_launch

    z, c = _gauss(b, n, d, cuda)
    *got, order = _vq_stats_launch(z, c)
    torch.cuda.synchronize()
    _check_k2(z, c, got, order)


@pytest.mark.parametrize("b,d", [(4097, 33), (70000, 208)])
def test_k2_all_rows_on_one_code(cuda, b, d):
    """One bucket longer than a histogram tile and than a short bucket: the
    sums are still the sequential ascending ones, and repeat bit for bit."""
    from lipvq_tpu_torch.ops.vq_lookup import _vq_stats_launch

    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(cuda)
    c = torch.full((65, d), 100.0, device=cuda)
    c[0] = z.mean(0)
    *got, order = _vq_stats_launch(z, c)
    again = vq_nearest_with_stats_cuda(z, c)
    torch.cuda.synchronize()
    assert int(got[1][0]) == b and int(got[1].sum()) == b
    _check_k2(z, c, got, order)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n", [49153, 65536, 131075])
def test_k2_beyond_one_histogram_range(cuda, n):
    """N above the 49152 codes one shared histogram holds: the sort runs
    over code ranges. Ids (bf16-exact operands, so both forms are exact and
    ties go to the lowest index) and counts equal the plain version's, the
    sums a sequential ascending fp32 sum, ``order`` a stable argsort."""
    from lipvq_tpu_torch.ops.vq_lookup import _vq_stats_launch

    rng = np.random.default_rng(4)
    b, d = 3000, 8
    z = torch.from_numpy(_dyadic(rng, (b, d))).to(cuda)
    c = torch.from_numpy(_dyadic(rng, (n, d))).to(cuda)
    # the last code of the last range is some row's nearest
    c[n - 1] = z[7]
    ids, counts, sums, order = _vq_stats_launch(z, c)
    torch.cuda.synchronize()
    want_ids, want_counts, _ = vq_nearest_with_stats_reference(z, c)
    assert torch.equal(ids, want_ids) and torch.equal(counts, want_counts)
    assert int(counts.sum()) == b and int(ids[7]) == n - 1  # beyond the first range
    assert torch.equal(order.long(), torch.argsort(ids.long(), stable=True))
    np.testing.assert_array_equal(sums.cpu().numpy(), _sequential_sums(z, ids, n))


def test_ema_step_beyond_one_histogram_range_matches_the_cpu(cuda):
    """One EMA-codebook train step of ``LipVQVAE`` at 65536 codes (two code
    ranges of K2's sort): the training forward launches K2 once on the card,
    and the step (forward, SGD on its loss, the EMA codebook written back)
    agrees with the same step on the CPU, whose path is K2's plain version.
    Each batch row's latent sits 1e-3 from its own code, so the ids are exact
    on both devices and spread over both ranges."""
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE

    codes, b, lr = 65536, 64, 0.5
    rng = np.random.default_rng(7)
    cpu = LipVQVAE(12, 8, num_codes=codes, ema_codebook=True)
    seeded_init(cpu, torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.uniform(-1, 1, (b, 12)).astype(np.float32))
    slots = torch.from_numpy(rng.permutation(codes)[:b])
    with torch.no_grad():
        cpu.to_latent.ci.fill_(30.0)
        codebook = cpu.encode(torch.from_numpy(rng.uniform(-1, 1, (codes, 12)).astype(np.float32)))
        codebook[slots] = cpu.encode(x) + torch.from_numpy(
            rng.normal(0.0, 1e-3, (b, 8)).astype(np.float32))
        cpu.quantizer.codebook.copy_(codebook)
    card = LipVQVAE(12, 8, num_codes=codes, ema_codebook=True).to(cuda)
    card.load_state_dict(cpu.state_dict())

    def step(model, xs):
        _, loss, ids = model(xs, train=True)
        model.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= lr * p.grad
        model.apply_ema_codebook()
        return float(loss.detach()), ids.cpu()

    before = vq_nearest_with_stats_cuda.launches
    got_loss, got_ids = step(card, x.to(cuda))
    assert vq_nearest_with_stats_cuda.launches == before + 1
    want_loss, want_ids = step(cpu, x)
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(got_ids.sort().values.long(), slots.sort().values)
    assert int((got_ids >= 49152).sum()) > 0 and int((got_ids < 49152).sum()) > 0
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    want = cpu.state_dict()
    for k, v in card.state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want[k].numpy(), atol=2e-5, rtol=1e-5,
                                   err_msg=k)


# -- K1f: one bf16 pass on the tensor cores ----------------------------------

@pytest.mark.parametrize("b,n,d", [(80, 128, 12), (300, 1024, 208), (70, 65, 791), (1, 1, 1),
                                   (129, 257, 33)])
def test_k1f_equals_reference_on_bf16_exact_inputs(cuda, b, n, d):
    rng = np.random.default_rng(0)
    z = torch.from_numpy(_dyadic(rng, (b, d))).to(cuda)
    c = torch.from_numpy(_dyadic(rng, (n, d))).to(cuda)
    got = vq_nearest_cuda(z, c, precision="fast")
    torch.cuda.synchronize()
    assert torch.equal(got, vq_nearest_fast_reference(z, c))


def test_k1f_ties_take_lowest_index(cuda):
    z = torch.tensor([[1.0, 0.0], [0.0, 1.0]], device=cuda)
    c = torch.tensor([[5.0, 5.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]], device=cuda)
    assert vq_nearest_cuda(z, c, precision="fast").tolist() == [1, 3]


@pytest.mark.parametrize("d", SHAPES_D)
@pytest.mark.parametrize("n", SHAPES_N)
@pytest.mark.parametrize("b", SHAPES_B)
def test_k1f_shapes_and_splits(cuda, plan_sms, b, n, d):
    """Ids within the near-tie rule of ``tie_gap`` of the plain version,
    with the card's SM count (code splits) and with one SM."""
    z, c = _gauss(b, n, d, cuda)
    got = vq_nearest_cuda(z, c, precision="fast")
    torch.cuda.synchronize()
    assert got.shape == (b,) and got.dtype == torch.int32
    assert int(got.min()) >= 0 and int(got.max()) < n
    gap, allowed = tie_gap(z, c, got, vq_nearest_fast_reference(z, c), bf16=True)
    assert bool((gap <= allowed).all())


@pytest.mark.parametrize("d", [63, 65, 129, FAST_MAX_D])
def test_k1f_widths_around_the_swizzle(cuda, plan_sms, d):
    """D off a multiple of the 64-column swizzle width, and the largest D:
    ids equal the plain version's on bf16-exact inputs and hold the
    near-tie rule on Gaussian ones, in both configurations."""
    rng = np.random.default_rng(5)
    z = torch.from_numpy(_dyadic(rng, (300, d))).to(cuda)
    c = torch.from_numpy(_dyadic(rng, (257, d))).to(cuda)
    got = vq_nearest_cuda(z, c, precision="fast")
    torch.cuda.synchronize()
    assert torch.equal(got, vq_nearest_fast_reference(z, c))
    z, c = _gauss(300, 257, d, cuda, seed=6)
    got = vq_nearest_cuda(z, c, precision="fast")
    gap, allowed = tie_gap(z, c, got, vq_nearest_fast_reference(z, c), bf16=True)
    assert bool((gap <= allowed).all())


@pytest.mark.parametrize("b,n,d,splits,lookup,copy", [
    (1 << 20, 1024, 208, 1, 1024, 1024 * 256 // 2),  # corpus: Dp = 256, 0.52 MB
    (160, 1024, 791, 64, 1024 + 2 * 10240, 1024 * 832 // 2),  # served: Dp = 832, 1.7 MB
    (500, 1024, 791, 32, 1024 + 2 * 16000, 1024 * 832 // 2),  # train
    (1, 1, 1, 1, 4, 64 // 2),
    (70, 65, 64, 5, 68 + 2 * 352, 65 * 64 // 2),
    (70, 65, 65, 5, 68 + 2 * 352, 65 * 128 // 2),
])
def test_k1f_scratch_holds_the_bf16_codebook_copy(cuda, b, n, d, splits, lookup, copy):
    """K1f's scratch, in 4-byte elements, as the library states it: the
    lookup's (cn [N] and, with splits, the partial distances and ids
    [splits, B], each rounded up to 4), 32 to align the copy to 128 bytes,
    then the bf16 copy [N, Dp] (2 to an element), Dp = D rounded up to 64."""
    lib = _build.load("vq_nearest_fast", vq_lookup._declare)
    assert plan_fast(b, n, d, 132).splits == splits
    assert lib.vq_lookup_scratch_elems(b, n, splits) == lookup
    assert lib.vq_nearest_fast_scratch_elems(b, n, d, splits) == lookup + 32 + copy


@pytest.mark.parametrize("module,name,entry,args", [
    (vq_lookup, "vq_nearest", "vq_nearest_launch",
     (None, None, None, None, None, 1, 1, 1, TC, 128, 2)),  # TC takes one code split
    (selective_scan, "selective_scan", "selective_scan_fwd_launch",
     (None,) * 7 + (1, 1, 1, 64)),  # more states than a warp has lanes
    (causal_conv1d, "causal_conv1d", "causal_conv1d_fwd_launch",
     (None, 1) + (None,) * 4 + (1, 1, 1, 5, 0)),  # a stencil wider than it is built for
    (fused_adamw, "fused_adamw", "fused_sq_norms",  # no group, nothing carried
     (0, None, None, 0, None, None, 0, None, None, None, ctypes.byref(ctypes.c_int(0)))),
], ids=["k1", "scan", "conv", "sq_norms"])
def test_a_refused_launch_raises_with_the_library_error_text(cuda, module, name, entry, args):
    """An entry point that returns a cudaError_t before it enqueues anything:
    ``_build.launch`` raises with the library's own text and code."""
    lib = _build.load(name, module._declare)
    with pytest.raises(RuntimeError, match=rf"^{entry} failed: invalid argument \(1\)$"):
        _build.launch(lib, entry, cuda, *args)


def test_k1f_wrapper_checks_and_counts(cuda):
    z = torch.zeros(4, 3, device=cuda)
    c = torch.zeros(8, 3, device=cuda)
    k1, k1f = vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches
    with pytest.raises(ValueError, match="D <="):
        vq_nearest_cuda(torch.zeros(4, FAST_MAX_D + 1, device=cuda),
                        torch.zeros(8, FAST_MAX_D + 1, device=cuda), precision="fast")
    with pytest.raises(ValueError):
        vq_nearest_cuda(z.double(), c.double(), precision="fast")
    assert (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches) == (k1, k1f)
    vq_nearest_fast(z, c)
    vq_nearest(z, c)  # the quantizer's dispatcher: K1, never K1f
    assert (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches) == (k1 + 1, k1f + 1)


# -- the VQ-VAE family and the tokenizer sweep -------------------------------

@pytest.mark.parametrize("codes", [128, 1024])
def test_vqvae_launches_k1_once_and_matches_the_cpu(cuda, codes):
    """``VQVAE`` at B = 500, latent 791: a forward and a backward on the
    card launch K1 once; the ids equal the CPU model's (near-ties of the
    expand form excepted, as ``tie_gap`` states) and the loss is the CPU's
    within rtol 1e-5."""
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.tokenizers.vqvae import VQVAE

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((500, 12), dtype=np.float32))
    cpu = seeded_init(VQVAE(12, 791, num_embeddings=codes), torch.Generator().manual_seed(4))
    with torch.no_grad():  # codes near latents of other inputs, so the ids spread
        cpu.embedding.copy_(cpu.encode(torch.from_numpy(
            rng.standard_normal((codes, 12), dtype=np.float32))))
    card = VQVAE(12, 791, num_embeddings=codes).to(cuda)
    card.load_state_dict(cpu.state_dict())
    k1, k2 = vq_nearest_cuda.launches, vq_nearest_with_stats_cuda.launches
    z, loss, ids = card(x.to(cuda))
    loss.backward()
    torch.cuda.synchronize()
    assert (vq_nearest_cuda.launches - k1, vq_nearest_with_stats_cuda.launches - k2) == (1, 0)
    _, want_loss, want_ids = cpu(x)
    z_e = cpu.encode(x).detach()
    gap, allowed = tie_gap(z_e, cpu.embedding.detach(), ids.cpu(), want_ids, bf16=False)
    assert bool((gap <= allowed).all())
    assert int((ids.cpu() == want_ids).sum()) >= 490
    np.testing.assert_allclose(float(loss.detach()), float(want_loss.detach()), rtol=1e-5)
    assert card.embedding.grad is not None and torch.isfinite(card.embedding.grad).all()


def test_sweep_ema_step_launches_k2_once(cuda):
    """One EMA-codebook step of the tokenizer sweep on the card: one K2
    launch, no K1; counts summing to the batch."""
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
    from lipvq_tpu_torch.scripts.tokenizer_sweep import train_step

    model = seeded_init(LipVQVAE(12, 64, num_codes=256, ema_codebook=True),
                        torch.Generator().manual_seed(5)).to(cuda)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
    x = torch.from_numpy(np.random.default_rng(6).uniform(-1, 1, (512, 12))
                         .astype(np.float32)).to(cuda)
    k1, k2 = vq_nearest_cuda.launches, vq_nearest_with_stats_cuda.launches
    loss = train_step(model, opt, x)
    torch.cuda.synchronize()
    assert (vq_nearest_cuda.launches - k1, vq_nearest_with_stats_cuda.launches - k2) == (0, 1)
    assert torch.isfinite(loss)
    np.testing.assert_allclose(float(model.ema_cluster_size.sum()), 0.01 * 512, rtol=1e-5)


@pytest.mark.parametrize("b,n,d", [(160, 256, 791), (10, 256, 791)],
                         ids=["closed_loop_train", "closed_loop_request"])
def test_k1_at_the_closed_loops_shapes(cuda, b, n, d):
    """The convergence twin's K1 shapes: a step's 16 context demos x 10
    steps and a single-env request's 10 steps, 256 codes, latent 791."""
    rng = np.random.default_rng(3)
    got, want = _both(rng.standard_normal((b, d), dtype=np.float32),
                      rng.standard_normal((n, d), dtype=np.float32), cuda)
    np.testing.assert_array_equal(got, want)


def _host_batches(n_batches: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [{"obs": {"x": rng.standard_normal((8, 10, 791), dtype=np.float32),
                     "frames": rng.integers(0, 256, (8, 10, 16, 16, 3), dtype=np.uint8)},
             "actions": rng.standard_normal((8, 10, 12), dtype=np.float32),
             "goal_obs": None} for _ in range(n_batches)]


def test_device_prefetch_loader_on_the_card(cuda):
    """Batches copied on a side stream from pinned memory equal the inner
    loader's, on the card, for work queued on the consumer's stream right
    after each one arrives."""
    from lipvq_tpu_torch.data.loaders import DevicePrefetchLoader

    batches = _host_batches(6, seed=4)
    loader = DevicePrefetchLoader(batches, cuda, size=2)
    sums = []
    for got in loader:
        assert got["goal_obs"] is None and got["obs"]["frames"].dtype == torch.uint8
        assert all(t.device.type == "cuda" for t in (got["obs"]["x"], got["actions"]))
        sums.append(torch.stack([got["obs"]["x"].double().sum(),
                                 got["obs"]["frames"].double().sum(),
                                 got["actions"].double().sum()]))
    want = [[b["obs"]["x"].astype(np.float64).sum(), b["obs"]["frames"].astype(np.float64).sum(),
             b["actions"].astype(np.float64).sum()] for b in batches]
    np.testing.assert_allclose(torch.stack(sums).cpu().numpy(), np.asarray(want), rtol=1e-12)


def test_device_cached_loader_gathers_on_the_card(cuda):
    """The tables live on the card and a gathered batch equals the host
    collate of the same items, bit for bit."""
    from lipvq_tpu_torch.data.loaders import DeviceCachedLoader
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate

    rng = np.random.default_rng(5)
    items = [{"obs": {"x": rng.standard_normal((10, 23), dtype=np.float32),
                      "lang": np.ones((10, 768), np.float32) * (i % 2)},
              "actions": rng.standard_normal((10, 12), dtype=np.float32)} for i in range(50)]

    class Identity:
        device = cuda

        def process_batch_for_training(self, batch):
            return batch

    loader = DeviceCachedLoader(items, batch_size=8, model=Identity(), seed=0, chunk=16)
    assert all(t.device.type == "cuda" for t in loader._tables)
    assert [len(t) for t in loader._tables] == [50, 2, 50]
    idx = np.array([3, 3, 49, 0, 17])
    got = loader.gather(idx)
    want = stack_collate([items[i] for i in idx])
    for k in ("x", "lang"):
        assert torch.equal(got["obs"][k].cpu(), torch.from_numpy(want["obs"][k]))
    assert torch.equal(got["actions"].cpu(), torch.from_numpy(want["actions"]))


@pytest.mark.parametrize("name,counter", [("vq_nearest", "launches"),
                                          ("vq_nearest_fast", "fast_launches"),
                                          ("vq_nearest_with_stats", None)])
def test_registered_ops_launch_their_kernels(cuda, name, counter):
    """Each registered op launches its kernel once per call on the current
    stream, and equals the kernel's own wrapper."""
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((300, 208), dtype=np.float32)).to(cuda)
    c = torch.from_numpy(rng.standard_normal((1024, 208), dtype=np.float32)).to(cuda)
    counts = (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches,
              vq_nearest_with_stats_cuda.launches)
    got = getattr(torch.ops.lipvq_tpu_torch, name)(z, c)
    after = (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches,
             vq_nearest_with_stats_cuda.launches)
    slot = {"launches": 0, "fast_launches": 1, None: 2}[counter]
    assert [a - b for a, b in zip(after, counts)] == [int(i == slot) for i in range(3)]
    if name == "vq_nearest_with_stats":
        for g, w in zip(got, vq_nearest_with_stats_cuda(z, c)):
            assert torch.equal(g, w)
    else:
        want = vq_nearest_cuda(z, c, precision="fast" if counter == "fast_launches" else
                               "highest")
        assert torch.equal(got, want)


def test_inference_moved_from_the_card_to_the_cpu(cuda):
    """An ICL policy trained on the card, then ``set_inference_device("cpu")``:
    with the same draws the served actions equal the card's within the
    card-vs-CPU tolerance, and the context ids agree but for near-ties."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.scripts.export_policy import serving_inputs

    cfg = config_factory("icl", {"algo": {
        "gmm": {"enabled": True},
        "transformer": {"enabled": True, "embed_dim": 64, "num_layers": 2, "num_heads": 4,
                        "vq_vae_enabled": True, "ln_act_enabled": False,
                        "compute_dtype": "float32"},
        "vq": {"num_codes": 64}}})
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(shapes)
    algo = algo_factory("icl", cfg, shapes, ac_dim=12, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"obs": {k: rng.standard_normal((8, 10, *s), dtype=np.float32)
                     for k, s in shapes.items()},
             "actions": rng.uniform(-1, 1, (8, 10, 12)).astype(np.float32), "goal_obs": None}
    algo.train_on_batch(batch, 0)
    obs, ctx_obs, ctx_act = serving_inputs(algo, 4)
    obs = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape), dtype=np.float32))
           for k, v in obs.items()}
    ctx_obs = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape), dtype=np.float32))
               for k, v in ctx_obs.items()}
    ctx_act = torch.from_numpy(rng.uniform(-1, 1, tuple(ctx_act.shape)).astype(np.float32))
    u, eps = torch.rand(4, 10, 5), torch.randn(4, 10, 12)

    def serve(dev):
        with torch.no_grad():
            put = lambda t: {k: v.to(dev) for k, v in t.items()} if isinstance(t, dict) \
                else t.to(dev)  # noqa: E731
            tok = algo.nets.net.encoder.action_network
            ids = tok.tokenize(ctx_act.reshape(-1, 12).to(dev))
            act = algo._get_action_impl(put(obs), put(ctx_obs), put(ctx_act), None,
                                        draws=(u.to(dev), eps.to(dev)))
            return act.cpu(), ids.cpu(), tok.encode(ctx_act.reshape(-1, 12).to(dev)).cpu()

    card = serve(cuda)
    algo.set_inference_device("cpu")
    assert all(p.device.type == "cpu" for p in algo.nets.parameters())
    cpu = serve(torch.device("cpu"))
    codebook = algo.nets.net.encoder.action_network.quantizer.codebook.detach()
    gap, allowed = tie_gap(cpu[2], codebook, card[1], cpu[1], bf16=False)
    assert bool((gap <= allowed).all())
    if torch.equal(card[1], cpu[1]):
        np.testing.assert_allclose(cpu[0].numpy(), card[0].numpy(), rtol=1e-4, atol=1e-5)


# -- the selective scan (ops/selective_scan.py, csrc/selective_scan.cu) -------

def _scan_args(b, t, d, n, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, d, generator=g, device=dev)
    dt = torch.nn.functional.softplus(torch.randn(b, t, d, generator=g, device=dev))
    A = -torch.rand(d, n, generator=g, device=dev) * 2.0 - 0.1
    B, C = (torch.randn(b, t, n, generator=g, device=dev) for _ in range(2))
    D = torch.randn(d, generator=g, device=dev)
    return [x, dt, A, B, C, D]


def _close(got, want, name):
    """fp32 sums in another order (over the states, the steps and, for dB and
    dC, up to b x d x t terms): each element within 1e-4 of its value plus
    1e-5 of the tensor's largest."""
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("b,t,d,n", [(192, 30, 5120, 16), (3, 70, 100, 8), (5, 10, 33, 32),
                                     (2, 70, 300, 16), (1, 1, 1, 1), (4, 33, 24, 3),
                                     (9, 10, 26, 4)])
def test_selective_scan_kernel_matches_its_plain_version(cuda, b, t, d, n):
    from lipvq_tpu_torch.ops import selective_scan as ss

    args = [v.requires_grad_() for v in _scan_args(b, t, d, n, cuda)]
    launches, elems = ss.selective_scan_cuda.launches, ss.selective_scan_cuda.elems
    y = ss.selective_scan_cuda(*args)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    assert ss.selective_scan_cuda.launches == launches + 2
    assert ss.selective_scan_cuda.elems == elems + 2 * b * t * d * n
    with torch.no_grad():
        plain = [v.detach() for v in args]
        _close(y.detach(), ss.scan_forward_plain(*plain), "y")
        want = ss.scan_backward_plain(*plain, dy)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads, want):
        _close(g, w, name)


def test_mamba_block_on_the_card_takes_the_kernel_and_matches_the_cpu(cuda):
    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.mamba import MambaBlock
    from lipvq_tpu_torch.ops import selective_scan as ss

    block = seeded_init(MambaBlock(64, d_state=16, dt_rank=8, dt_bc_norm=True),
                        torch.Generator().manual_seed(0))
    x = torch.randn(6, 30, 64, generator=torch.Generator().manual_seed(1))
    want = block(x)
    launches = ss.selective_scan_cuda.launches
    got = block.to(cuda)(x.to(cuda))
    torch.cuda.synchronize()
    assert ss.selective_scan_cuda.launches == launches + 1
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().numpy(), rtol=1e-4,
                               atol=1e-5)


def test_hybrid_step_on_the_card_counts_its_scans(cuda):
    """One step of the small hybrid policy on the card: two scan calls (a
    forward and a backward) per Mamba layer in the port's counters."""
    import copy
    import json
    from pathlib import Path

    from lipvq_tpu_torch.utils import profile_utils
    from portbench.harness import program, weights
    from portbench.reference import icl_jamba as ref

    path = Path(__file__).resolve().parents[1] / "portbench/configs/icl_lipvq_jamba2_3b.json"
    raw = json.loads(path.read_text())
    raw["port_config"] = pc = copy.deepcopy(raw["port_config"])
    pc["algo"]["mamba"].update(context_length=3, embed_dim=64, num_heads=4, num_layers=4,
                               d_state=4)
    pc["algo"]["mamba"]["hybrid"].update(attn_layer_period=4, attn_layer_offset=2, mlp_dim=128,
                                         dt_rank=0)
    pc["algo"]["vq"]["num_codes"] = 32
    cfg = program.normalize(raw)
    w = weights.make(ref.param_specs(cfg), 5, cuda, ref.lipvq_encode, codebooks=[ref.TOK])
    algo = program.build_policy(cfg, w, 5, cuda)
    rng = np.random.default_rng(0)
    items = {"obs": {k: rng.standard_normal((6, 5, *s), dtype=np.float32) for k, s in cfg["obs"]},
             "actions": rng.standard_normal((6, 5, cfg["ac_dim"]), dtype=np.float32)}
    profile_utils.reset()
    profile_utils.enable()
    try:
        algo.train_on_batch(algo.process_batch_for_training(items), 0)
        counters = profile_utils.totals()["counters"]
    finally:
        profile_utils.disable()
        profile_utils.reset()
    mamba_layers = 3
    b, t = 3, 3 * cfg["context_length"]
    assert counters["ssm_scan_launches"] == 2 * mamba_layers
    assert counters["ssm_scan_elems"] == 2 * mamba_layers * b * t * 2 * 64 * 4


# -- the mixer's chain (ops/causal_conv1d.py, the gated scan) ------------------

def _close_in(got, want, name):
    """``_close`` in the tensors' own type: a bf16 result computed in fp32
    from values that agree to fp32 rounding may also round to the next
    bf16 value (up to 2**-7 of it)."""
    rtol = 1e-4 + (2.0**-7 if got.dtype == torch.bfloat16 else 0.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * float(want.abs().max().float()),
                               msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("b,t,d,k,dtype", [
    (192, 30, 5120, 4, torch.bfloat16), (3, 70, 100, 4, torch.float32),
    (2, 150, 24, 3, torch.bfloat16), (4, 2, 33, 4, torch.float32), (1, 1, 1, 1, torch.float32),
    (9, 10, 26, 2, torch.bfloat16)],
    ids=["jamba", "two_chunks", "narrow_three_chunks", "t_short", "one", "d26"])
def test_causal_conv1d_kernel_matches_its_plain_version(cuda, b, t, d, k, dtype):
    """x a half of a Dense output (rows 2d apart), with the copy in x's type:
    xs and its copy, then the gradients from both outputs'."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, t, 2 * d, generator=g, device=cuda).to(dtype)[..., :d]
    w = torch.randn(k, d, generator=g, device=cuda) / k ** 0.5
    bias = 0.1 * torch.randn(d, generator=g, device=cuda)
    args = [x.requires_grad_(), w.requires_grad_(), bias.requires_grad_()]
    xs, xs_copy = causal_conv1d.causal_conv1d_silu(*args, copy=True)
    assert xs.dtype == torch.float32 and torch.equal(xs_copy, xs.detach().to(dtype))
    dxs = torch.randn(b, t, d, generator=g, device=cuda)
    dxs_copy = torch.randn(b, t, d, generator=g, device=cuda).to(dtype)
    grads = torch.autograd.grad((xs, xs_copy), args, (dxs, dxs_copy))
    torch.cuda.synchronize()
    with torch.no_grad():
        plain = [a.detach() for a in args]
        _close_in(xs.detach(), causal_conv1d.conv_silu_forward_plain(*plain), "xs")
        want = causal_conv1d.conv_silu_backward_plain(*plain, dxs, dxs_copy)
    for name, got, w_ in zip(("dx", "dw", "dbias"), grads, want):
        _close_in(got, w_, name)


def _gated_args(b, t, d, n, dtype, dev, seed=0):
    """x, dt_proj's output (one step past softplus's threshold), A, B, C, D
    and the gate as a half of a Dense output (rows 2d apart)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, d, generator=g, device=dev)
    dt = (1.5 * torch.randn(b, t, d, generator=g, device=dev) - 2.0)
    dt[0, 0, 0] = 25.0
    A = -torch.rand(d, n, generator=g, device=dev) * 2.0 - 0.1
    B, C = (torch.randn(b, t, n, generator=g, device=dev) for _ in range(2))
    D = torch.randn(d, generator=g, device=dev)
    z = torch.randn(b, t, 2 * d, generator=g, device=dev).to(dtype)[..., d:]
    return [x, dt.to(dtype), A, B, C, D, z]


@pytest.mark.parametrize("b,t,d,n,dtype", [
    (192, 30, 5120, 16, torch.bfloat16), (3, 70, 100, 8, torch.float32),
    (5, 10, 33, 32, torch.bfloat16), (1, 1, 1, 1, torch.float32), (9, 10, 26, 4, torch.bfloat16),
    (4, 33, 24, 3, torch.float32)],
    ids=["jamba", "three_chunks", "d33_n32", "one", "d26", "d24_n3"])
def test_gated_scan_kernel_matches_its_plain_version(cuda, b, t, d, n, dtype):
    args = [v.requires_grad_() for v in _gated_args(b, t, d, n, dtype, cuda)]
    scan = selective_scan.selective_scan_cuda
    launches, elems = scan.launches, scan.elems
    out = selective_scan.gated_selective_scan(*args)
    assert out.dtype == dtype
    dout = torch.randn(b, t, d, device=cuda).to(dtype)
    grads = torch.autograd.grad(out, args, dout)
    torch.cuda.synchronize()
    assert (scan.launches, scan.elems) == (launches + 2, elems + 2 * b * t * d * n)
    with torch.no_grad():
        plain = [v.detach() for v in args]
        _close_in(out.detach(), selective_scan.gated_scan_forward_plain(*plain), "out")
        want = selective_scan.gated_scan_backward_plain(*plain, dout)
    for name, got, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD", "dz"), grads, want):
        assert got.dtype == w.dtype, name
        _close_in(got, w, name)


@pytest.mark.parametrize("b,t,d,n,dtype", [
    (192, 30, 5120, 16, torch.bfloat16), (9, 10, 26, 4, torch.float32)], ids=["jamba", "d26"])
def test_gated_scan_keeps_no_steps_without_a_gradient(cuda, b, t, d, n, dtype):
    """Without a gradient to take the forward writes no steps, and its
    output is the same, bit for bit."""
    args = _gated_args(b, t, d, n, dtype, cuda)
    kept, steps = selective_scan._gated_forward_cuda(*args)
    bare, none = selective_scan._gated_forward_cuda(*args, keep_steps=False)
    assert steps is not None and none is None and torch.equal(bare, kept)
    with torch.inference_mode():
        served = selective_scan.gated_selective_scan(*args)
    assert torch.equal(served, kept)


def _mixer(cuda, d_model, d_state, dt_rank, norm, compute_dtype, seed=0, d_conv=4):
    """A Mamba block on the card with Mamba's spread of decays and steps
    (A_log = log(1..n), the dt bias a log-uniform dt's inverse softplus) and
    a conv bias that is not zero."""
    import math

    from lipvq_tpu_torch.models.base_nets import seeded_init
    from lipvq_tpu_torch.models.mamba import MambaBlock

    block = seeded_init(MambaBlock(d_model, d_state=d_state, d_conv=d_conv, dt_rank=dt_rank,
                                   dt_bc_norm=norm, norm_eps=1e-6, compute_dtype=compute_dtype),
                        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        u = torch.rand(block.d_inner, generator=g)
        step = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        block.dt_proj.bias.copy_(step + torch.log(-torch.expm1(-step)))
        block.conv_bias.normal_(0, 0.1, generator=g)
    return block.to(cuda)


@pytest.mark.parametrize("d_model,b,t,n,dt_rank,norm,bf16", [
    (2560, 192, 30, 16, 160, True, True), (512, 50, 30, 8, 0, False, False),
    (12, 6, 30, 8, 0, False, False), (13, 5, 7, 4, 0, True, False)],
    ids=["jamba_layer", "arm_train", "d_inner24", "d_inner26"])
def test_fused_mamba_block_matches_the_composed_block_on_the_card(cuda, d_model, b, t, n,
                                                                 dt_rank, norm, bf16):
    """The block's fused and composed chains from the same in_proj output:
    the output, the input's gradient and every parameter's."""
    from lipvq_tpu_torch.models.mamba import _dense

    cd = torch.bfloat16 if bf16 else None
    block = _mixer(cuda, d_model, n, dt_rank, norm, cd)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(b, t, d_model, generator=g, device=cuda)
    dout = torch.randn(b, t, d_model, generator=g, device=cuda)
    names, params = zip(*sorted(block.named_parameters()))
    got = []
    for path in (block._composed, block._fused):
        xi = x.clone().requires_grad_()
        h = _dense(block.in_proj, xi, cd)
        assert block._fuses(h)
        out = path(h)
        grads = torch.autograd.grad(out, [xi, *params], dout.to(out.dtype))
        got.append((out.detach(), grads))
        del h, out
    (want, want_g), (out, out_g) = got
    _close(out.float(), want.float(), "out")
    for name, a, w in zip(("x", *names), out_g, want_g):
        _close(a, w, name)


def test_mamba_block_counts_its_forwards_by_path(cuda, monkeypatch):
    from lipvq_tpu_torch.models import mamba
    from lipvq_tpu_torch.utils import profile_utils

    block = _mixer(cuda, 12, 8, 0, False, None)
    x = torch.randn(2, 5, 12, device=cuda)
    profile_utils.reset()
    block(x)
    block(x)
    counters = profile_utils.totals()["counters"]
    assert (counters["ssm_mixer_fused"], counters["ssm_mixer_composed"]) == (2, 0)
    assert counters["causal_conv1d_launches"] == 2
    # a scan put in the ops module's place (a planted fault) takes the composed chain
    monkeypatch.setattr(mamba, "selective_scan", lambda *args: selective_scan.selective_scan(*args))
    block(x)
    counters = profile_utils.totals()["counters"]
    assert (counters["ssm_mixer_fused"], counters["ssm_mixer_composed"]) == (2, 1)
    assert counters["causal_conv1d_launches"] == 2


@pytest.mark.parametrize("d_conv,d_state", [(5, 8), (4, 33)], ids=["d_conv5", "d_state33"])
def test_mamba_block_on_the_card_raises_on_what_the_kernels_do_not_take(cuda, d_conv, d_state):
    """A wider stencil or more states than the kernels are built for fail
    loudly on the card, and do not fall back to PyTorch's operations."""
    block = _mixer(cuda, 12, d_state, 0, False, None, d_conv=d_conv)
    with pytest.raises(ValueError, match="takes"):
        block(torch.randn(2, 5, 12, device=cuda))


# -- the optimizer's two passes (ops/fused_adamw.py, csrc/fused_adamw.cu) ------

# odd sizes, an empty and a one-element tensor, several chunks of either pass
ADAM_SHAPES = [(3, 5), (7,), (0,), (1,), (8193,), (130, 257), (16385,)]
# the clip-engaged grads' nonzero elements by tensor: squares whose sum is a
# square ((2, 3, 6) x 14: 784 + 1764 + 7056 = 98^2)
ADAM_EXACT = [0, 0, 0, 0, 784, 1764, 7056]
ADAM_KINDS = {"adamw": (torch.optim.AdamW, 0.01), "adam_l2": (torch.optim.Adam, 0.01),
              "adam": (torch.optim.Adam, 0.0)}


def _adam_pair(dev, kind: str, clip, shapes=ADAM_SHAPES, seed: int = 0, lr: float = 1e-3):
    """Two ScheduledOptimizers over the same starting weights on ``dev``."""
    from lipvq_tpu_torch.algo.base import ScheduledOptimizer

    cls, wd = ADAM_KINDS[kind]
    g = torch.Generator(device=dev).manual_seed(seed)
    start = [torch.randn(s, generator=g, device=dev) for s in shapes]
    return [ScheduledOptimizer([torch.nn.Parameter(t.clone()) for t in start], cls,
                               lambda step: lr, max_grad_norm=clip, weight_decay=wd, eps=1e-8)
            for _ in range(2)]


def _adam_grads(shapes, gen, dev, exact: bool):
    """N(0, 1) grads, or (``exact``) +-2^e on the first ADAM_EXACT[i]
    elements: every norm exact in fp32 whatever the order of sums, so the
    clip's scale is the same bit for bit on both paths."""
    out = []
    if not exact:
        return [torch.randn(s, generator=gen, device=dev) for s in shapes]
    e = int(torch.randint(-2, 3, (), generator=gen, device=dev))
    for s, k in zip(shapes, ADAM_EXACT):
        g = torch.zeros(s, device=dev).reshape(-1)
        g[:k] = (torch.randint(0, 2, (k,), generator=gen, device=dev) * 2 - 1) * 2.0 ** e
        out.append(g.reshape(s))
    return out


def _torch_block(opts):
    """The block without the kernels: the logged norm, each clip, torch's
    foreach step."""
    from lipvq_tpu_torch.algo.base import clip_by_global_norm_, global_norm

    norm = global_norm([p.grad for o in opts for p in o.params])
    for o in opts:
        if o.max_grad_norm is not None:
            clip_by_global_norm_([p.grad for p in o.params], o.max_grad_norm)
        o.optimizer.step()
        o._advance()
    return norm


def _within_4_ulp(got, want, name):
    tol = 4 * torch.finfo(torch.float32).eps * want.abs() + 1e-12
    bad = (got - want).abs() > tol
    assert not bool(bad.any()), (name, float((got - want).abs().max()))


def _assert_adam_equal(fused, plain):
    for of, op in zip(fused, plain):
        for i, (pf, pp) in enumerate(zip(of.params, op.params)):
            sf, sp = of.optimizer.state[pf], op.optimizer.state[pp]
            assert float(sf["step"]) == float(sp["step"]) and sf["step"].is_cpu
            _within_4_ulp(pf.detach(), pp.detach(), f"p {i}")
            _within_4_ulp(sf["exp_avg"], sp["exp_avg"], f"exp_avg {i}")
            _within_4_ulp(sf["exp_avg_sq"], sp["exp_avg_sq"], f"exp_avg_sq {i}")


@pytest.mark.parametrize("clip", ["engaged", "not_engaged"])
@pytest.mark.parametrize("kind", ADAM_KINDS)
def test_fused_adamw_matches_torchs_foreach_step(cuda, kind, clip):
    from lipvq_tpu_torch.algo.base import step_optimizers

    exact = clip == "engaged"
    fused, plain = _adam_pair(cuda, kind, 1.0 if exact else 1e6)
    gen = torch.Generator(device=cuda).manual_seed(1)
    before = fused_adamw.adam_step_.steps
    for _ in range(10):
        grads = _adam_grads(ADAM_SHAPES, gen, cuda, exact)
        for o in (fused, plain):
            for p, g in zip(o.params, grads):
                p.grad = g.clone()
        got = step_optimizers([fused])
        want = _torch_block([plain])
        if exact:
            assert float(want) > 1.0  # the clip engaged
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert fused_adamw.adam_step_.steps == before + 10
    _assert_adam_equal([fused], [plain])


def test_fused_adamw_takes_several_launches_and_two_optimizers(cuda):
    """More tensors than one launch of either pass takes (160 for the
    norms, 80 for the update), two optimizers with their own rates, one
    clipped, in one call; 16-byte misaligned tensors take the element path.
    The launches counted are those the argument blocks call for: the
    clipped optimizer's norm pass and finalize, its update, the other's
    update, and a norm pass over the other's grads with the first sum
    carried in."""
    from lipvq_tpu_torch.algo.base import step_optimizers

    lim = fused_adamw.limits()
    sizes = [(1 + 37 * i) % 301 for i in range(lim["norm_tensors"] + 45)]
    first, second = [(n,) for n in sizes[:130]], [(n,) for n in sizes[130:]]
    opts = [_adam_pair(cuda, "adamw", 5.0, first, seed=2, lr=1e-3),
            _adam_pair(cuda, "adam_l2", None, second, seed=3, lr=3e-4)]
    fused, plain = [o[0] for o in opts], [o[1] for o in opts]
    for o in (fused[1], plain[1]):  # views one element in: not 16-byte aligned
        base = torch.randn(1 + sum(sizes[130:140]), device=cuda)
        cuts = torch.split(base[1:], sizes[130:140])
        o.params[:10] = [torch.nn.Parameter(c) for c in cuts]
        o.optimizer.param_groups[0]["params"][:10] = o.params[:10]
    with torch.no_grad():
        for pf, pp in zip(fused[1].params[:10], plain[1].params[:10]):
            pf.copy_(pp)
    gen = torch.Generator(device=cuda).manual_seed(4)
    nonempty = [sum(1 for n in part if n) for part in (sizes[:130], sizes[130:])]
    blocks = [-(-k // lim["norm_tensors"]) + 1 for k in nonempty]  # and the finalize
    updates = [-(-k // lim["adam_tensors"]) for k in nonempty]
    assert updates[0] >= 2
    launches = (fused_adamw.sq_norms.launches, fused_adamw.adam_step_.launches)
    for _ in range(10):
        for of, op in zip(fused, plain):
            for pf, pp in zip(of.params, op.params):
                pf.grad = torch.randn(pf.shape, generator=gen, device=cuda)
                pp.grad = pf.grad.clone()
        got = step_optimizers(fused)
        want = _torch_block(plain)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert fused_adamw.sq_norms.launches - launches[0] == 10 * sum(blocks)
    assert fused_adamw.adam_step_.launches - launches[1] == 10 * sum(updates)
    # the clip's scale differs in its last bits: within a hundredth of a step
    for of, op, lr in zip(fused, plain, (1e-3, 3e-4)):
        for pf, pp in zip(of.params, op.params):
            torch.testing.assert_close(pf, pp, rtol=0, atol=1e-2 * lr)
            for k in ("exp_avg", "exp_avg_sq"):
                want = op.optimizer.state[pp][k]
                largest = float(want.abs().max()) if want.numel() else 0.0
                torch.testing.assert_close(of.optimizer.state[pf][k], want, rtol=1e-5,
                                           atol=1e-6 * largest)


def test_fused_adamw_adds_no_host_sync(cuda):
    from lipvq_tpu_torch.algo.base import step_optimizers

    fused, _ = _adam_pair(cuda, "adamw", 1.0)
    second, _ = _adam_pair(cuda, "adam", None, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    for i in range(2):
        for o in (fused, second):
            for p, g in zip(o.params, _adam_grads(ADAM_SHAPES, gen, cuda, False)):
                p.grad = g
        torch.cuda.synchronize()
        if i:
            torch.cuda.set_sync_debug_mode("error")
        try:
            norm = step_optimizers([fused, second])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert norm.is_cuda and norm.shape == ()


def test_fused_adamw_counters_reach_the_totals(cuda):
    from lipvq_tpu_torch.algo.base import step_optimizers
    from lipvq_tpu_torch.utils import profile_utils

    fused, _ = _adam_pair(cuda, "adamw", 1.0)
    second, _ = _adam_pair(cuda, "adam", None, seed=5)
    gen = torch.Generator(device=cuda).manual_seed(7)
    profile_utils.reset()
    for _ in range(3):
        for o in (fused, second):
            for p, g in zip(o.params, _adam_grads(ADAM_SHAPES, gen, cuda, False)):
                p.grad = g
        step_optimizers([fused, second])
    got = profile_utils.totals()["counters"]
    profile_utils.reset()
    assert got["optimizer_fused_steps"] == 6 and got["optimizer_torch_steps"] == 0
    assert got["optimizer_fused_elems"] == 3 * 2 * sum(int(np.prod(s)) for s in ADAM_SHAPES)


def test_fused_adamw_kernels_run_under_foreach_ops(cuda):
    """The profiler credits every kernel of the step to a host op whose name
    holds ``_foreach`` (``portbench/metrics/optimizer_share.py`` reads those)."""
    from torch.profiler import ProfilerActivity, profile

    from lipvq_tpu_torch.algo.base import step_optimizers

    fused, _ = _adam_pair(cuda, "adamw", 1.0)
    gen = torch.Generator(device=cuda).manual_seed(8)
    for i in range(2):
        for p, g in zip(fused.params, _adam_grads(ADAM_SHAPES, gen, cuda, False)):
            p.grad = g
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_optimizers([fused])
            torch.cuda.synchronize()
    cuda_type = torch.autograd.DeviceType.CUDA
    device = [e for e in prof.events() if e.device_type == cuda_type]
    credited = {}
    for e in prof.events():
        if e.device_type != cuda_type and "_foreach" in e.name:
            for k in e.kernels:
                credited[e.name] = credited.get(e.name, 0.0) + k.duration
    assert set(credited) == {"lipvq_tpu_torch::_foreach_sq_norms",
                             "lipvq_tpu_torch::_foreach_clip_adamw_"}
    assert {n for e in device for n in ("sq_norms", "clip_adamw") if n in e.name} == {
        "sq_norms", "clip_adamw"}
    # every kernel of the step is credited to one of the two ops
    np.testing.assert_allclose(sum(credited.values()),
                               sum(e.time_range.end - e.time_range.start for e in device),
                               rtol=1e-6)


def test_icl_step_on_the_card_takes_the_fused_optimizer(cuda):
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory

    cfg = config_factory("icl", {"algo": {
        "gmm": {"enabled": True},
        "transformer": {"enabled": True, "embed_dim": 64, "num_layers": 2, "num_heads": 4,
                        "vq_vae_enabled": True, "ln_act_enabled": False},
        "vq": {"num_codes": 64}}})
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(shapes)
    algo = algo_factory("icl", cfg, shapes, ac_dim=12, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"obs": {k: rng.standard_normal((8, 10, *s), dtype=np.float32)
                     for k, s in shapes.items()},
             "actions": rng.uniform(-1, 1, (8, 10, 12)).astype(np.float32), "goal_obs": None}
    counters = (fused_adamw.adam_step_.steps, fused_adamw.torch_step_.steps,
                fused_adamw.sq_norms.launches, fused_adamw.adam_step_.launches)
    out = algo.train_on_batch(batch, 0)["losses"]
    assert fused_adamw.adam_step_.steps - counters[0] == 2  # policy and tokenizer
    assert fused_adamw.torch_step_.steps == counters[1]
    assert fused_adamw.sq_norms.launches > counters[2]
    assert fused_adamw.adam_step_.launches - counters[3] == 2
    assert out["policy_grad_norms"].is_cuda and float(out["policy_grad_norms"]) > 0
