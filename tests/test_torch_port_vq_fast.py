"""K1f's plain version (``vq_nearest_fast_reference``), its dispatcher and its
launch plan, on the CPU. K1f itself runs on the card only
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

XLA on the CPU runs ``Precision.DEFAULT`` in full fp32, so the JAX package
cannot show the bf16 rounding here. The plain version is held two ways:
- on operands that are exactly representable in bf16 (k/8 with |k| < 256,
  every sum exact in fp32) its ids equal the Pallas kernel's
  ``precision="fast"`` ids in interpret mode exactly;
- on Gaussian operands its ids equal a float64 argmin over the
  bf16-rounded operands on every row whose two best fp64 distances are
  further apart than the fp32 evaluation's error (tie-free rows; the test
  asserts that nearly all rows are).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.ops.vq_lookup import vq_nearest_pallas
from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.ops.vq_lookup import (
    FAST_MAX_D,
    FAST_NARROW,
    FAST_TILES,
    FAST_WIDE,
    FAST_WIDE_MAX_D,
    tie_gap,
    plan_fast,
    vq_nearest,
    vq_nearest_cuda,
    vq_nearest_fast,
    vq_nearest_fast_reference,
    vq_nearest_reference,
)

torch.set_num_threads(1)


def _dyadic(rng, shape):
    return (np.round(np.clip(rng.standard_normal(shape) * 8, -255, 255)) / 8).astype(np.float32)


@pytest.mark.parametrize("b,n,d", [(80, 128, 12), (300, 256, 208), (70, 65, 791), (1, 1, 1)])
def test_fast_reference_equals_pallas_fast_on_bf16_exact_inputs(b, n, d):
    rng = np.random.default_rng(0)
    z, c = _dyadic(rng, (b, d)), _dyadic(rng, (n, d))
    assert np.array_equal(torch.from_numpy(z).bfloat16().float().numpy(), z)
    want = np.asarray(vq_nearest_pallas(jnp.asarray(z), jnp.asarray(c), precision="fast",
                                        interpret=True))
    got = vq_nearest_fast_reference(torch.from_numpy(z), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_reference_ties_take_lowest_index():
    z = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    c = torch.tensor([[5.0, 5.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]])
    assert vq_nearest_fast_reference(z, c).tolist() == [1, 3]


@pytest.mark.parametrize("b,n,d", [(400, 1024, 208), (160, 1024, 791)])
def test_fast_reference_equals_fp64_argmin_over_bf16_operands(b, n, d):
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    zb, cb = z.bfloat16().double(), c.bfloat16().double()
    dist = (c.double() ** 2).sum(1)[None, :] - 2.0 * zb @ cb.T  # exact but for fp64 rounding
    two = dist.topk(2, dim=1, largest=False)
    # the fp32 evaluation's error bound on each distance (tie_gap's)
    err = (d + 1) * 2.0 ** -23 * (2.0 * (zb.abs() @ cb.abs().T) + (c.double() ** 2).sum(1))
    margin = two.values[:, 1] - two.values[:, 0]
    tie_free = margin > 2 * err.max(1).values
    assert tie_free.float().mean() > 0.97, float(tie_free.float().mean())
    got = vq_nearest_fast_reference(z, c)
    assert torch.equal(got[tie_free].long(), two.indices[tie_free, 0])


def test_tie_gap_accepts_near_ties_and_rejects_others():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((500, 64), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((256, 64), dtype=np.float32))
    ids = vq_nearest_fast_reference(z, c)
    assert tie_gap(z, c, ids, ids, bf16=True)[0].numel() == 0
    other = (ids + 1) % 256  # a far code for almost every row
    gap, allowed = tie_gap(z, c, other, ids, bf16=True)
    assert gap.numel() == 500 and float((gap / allowed).median()) > 1
    # a duplicated code is an exact tie: ratio 0
    c2 = torch.cat([c, c[:1]])
    rows = (ids == 0).nonzero().flatten()
    assert rows.numel() > 0
    dup = ids.clone()
    dup[rows] = 256
    assert float(tie_gap(z, c2, dup, ids, bf16=True)[0].max()) == 0.0


def test_fast_dispatch_on_cpu_and_wrapper_raises():
    rng = np.random.default_rng(3)
    z = torch.from_numpy(rng.standard_normal((33, 20), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((40, 20), dtype=np.float32))
    assert torch.equal(vq_nearest_fast(z, c), vq_nearest_fast_reference(z, c))
    for precision in ("highest", "fast"):
        with pytest.raises(ValueError, match="CUDA"):
            vq_nearest_cuda(z, c, precision=precision)
    with pytest.raises(ValueError, match="precision"):
        vq_nearest_cuda(z, c, precision="bf16")
    # the quantizer's dispatcher never takes the fast lookup
    assert list(inspect.signature(vq_nearest).parameters) == ["z_e", "codebook"]
    assert torch.equal(vq_nearest(z, c), vq_nearest_reference(z, c))
    assert vq_nearest_cuda.launches == 0 and vq_nearest_cuda.fast_launches == 0


@pytest.mark.parametrize("b", [1, 64, 65, 160, 500, 4097, 1 << 20])
@pytest.mark.parametrize("n", [1, 65, 128, 1024])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_fast_covers_every_code(b, n, sms):
    for d in (1, 208, FAST_WIDE_MAX_D, FAST_WIDE_MAX_D + 1, 791, FAST_MAX_D):
        plan = plan_fast(b, n, d, sms)
        rows, codes = FAST_TILES[plan.config]
        assert plan.row_tiles == -(-b // rows)
        assert plan.codes_per_split % codes == 0
        assert plan.splits * plan.codes_per_split >= n > (plan.splits - 1) * plan.codes_per_split
        # WIDE only where its z tile fits and its tiles alone give every SM a CTA
        wide_tiles = -(-b // FAST_TILES[FAST_WIDE][0]) * -(-n // FAST_TILES[FAST_WIDE][1])
        assert (plan.config == FAST_WIDE) == (d <= FAST_WIDE_MAX_D and wide_tiles >= sms)
        if b <= 500 and n == 1024 and sms == 132:
            # small batches: NARROW's 16-code tiles split the codes finely
            assert plan.config == FAST_NARROW and plan.splits >= 32


@pytest.mark.parametrize("b", [160, 500])
def test_plan_fast_fills_the_card_at_small_batches(b):
    """The served (160) and train (500) batches give every one of 132 SMs a
    CTA: 3 x 64 and 8 x 32 CTAs."""
    plan = plan_fast(b, 1024, 791, 132)
    assert plan.config == FAST_NARROW and plan.ctas >= 132
    assert plan.ctas == {160: 192, 500: 256}[b]
    # the corpus shape runs WIDE in one split of 4096 row tiles
    assert plan_fast(1 << 20, 1024, 208, 132) == (FAST_WIDE, 4096, 1, 1024)


def test_fast_source_builds_into_its_own_library():
    assert (_build.CSRC_DIR / "vq_nearest_fast.cu").is_file()
    path = _build.library_path("vq_nearest_fast")
    assert path.name.startswith("libvq_nearest_fast-") and path != _build.library_path(
        "vq_nearest")
    assert FAST_MAX_D >= 1632 and FAST_WIDE_MAX_D >= 208
