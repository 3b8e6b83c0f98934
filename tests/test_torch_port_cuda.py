"""Kernels K1, K1f and K2 on the card against their plain PyTorch versions.

These tests need an NVIDIA GPU and nvcc and skip without them. The machine
with the card has no JAX, so this file imports none and runs without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.ops.vq_lookup import (
    FAST_MAX_D,
    plan_fast,
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
    import lipvq_tpu_torch.ops.vq_lookup as vq_lookup

    lib = vq_lookup._bind("vq_nearest_fast")
    assert plan_fast(b, n, d, 132).splits == splits
    assert lib.vq_lookup_scratch_elems(b, n, splits) == lookup
    assert lib.vq_nearest_fast_scratch_elems(b, n, d, splits) == lookup + 32 + copy


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
