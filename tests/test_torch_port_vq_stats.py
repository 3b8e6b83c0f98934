"""Port parity of the cluster statistics: K2's plain PyTorch version against
the JAX stats kernel (``vq_nearest_with_stats_pallas`` in interpret mode)
and ``vq_cluster_stats``. Ids and counts must be exactly equal; sums agree
to rtol 1e-5 / atol 1e-5, as the JAX package's own stats test allows (the
one-hot products sum the rows in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.ops.vq_lookup import (
    vq_cluster_stats as jax_cluster_stats,
    vq_nearest_reference as jax_reference,
    vq_nearest_with_stats_pallas,
)
from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.ops.vq_lookup import (
    vq_cluster_stats,
    vq_nearest_with_stats,
    vq_nearest_with_stats_cuda,
    vq_nearest_with_stats_reference,
)

torch.set_num_threads(1)

SUMS_RTOL, SUMS_ATOL = 1e-5, 1e-5


@pytest.mark.parametrize("b,n,d", [(300, 64, 16), (70, 65, 791)])
def test_stats_reference_matches_jax_kernel(b, n, d):
    rng = np.random.default_rng(0)
    z = rng.standard_normal((b, d), dtype=np.float32)
    c = rng.standard_normal((n, d), dtype=np.float32)
    want_ids, want_counts, want_sums = (np.asarray(a) for a in vq_nearest_with_stats_pallas(
        jnp.asarray(z), jnp.asarray(c), block_b=128, interpret=True))
    np.testing.assert_array_equal(want_ids, np.asarray(jax_reference(jnp.asarray(z),
                                                                     jnp.asarray(c))))
    ref_counts, ref_sums = (np.asarray(a) for a in jax_cluster_stats(
        jnp.asarray(z), jnp.asarray(want_ids), n))
    ids, counts, sums = (a.numpy() for a in vq_nearest_with_stats_reference(
        torch.from_numpy(z), torch.from_numpy(c)))
    assert ids.dtype == np.int32 and counts.dtype == np.float32 and sums.dtype == np.float32
    np.testing.assert_array_equal(ids, want_ids)
    # the Pallas kernel pads B to 128 rows and subtracts the pad rows' counts
    # again; nothing is padded here, and the counts still match
    np.testing.assert_array_equal(counts, want_counts)
    np.testing.assert_array_equal(counts, ref_counts)
    assert counts.sum() == b
    for want in (want_sums, ref_sums):
        np.testing.assert_allclose(sums, want, rtol=SUMS_RTOL, atol=SUMS_ATOL)


def test_cluster_stats_chunks_agree_with_one_product(monkeypatch):
    """Accumulating the one-hot product over row chunks gives the counts
    exactly and the sums within fp32 rounding."""
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.standard_normal((257, 9), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, 11, 257).astype(np.int32))
    whole = vq_cluster_stats(z, ids, 11)
    import lipvq_tpu_torch.ops.vq_lookup as vq_lookup

    monkeypatch.setattr(vq_lookup, "_REFERENCE_CHUNK_ELEMS", 11 * 16)  # 16-row chunks
    chunked = vq_cluster_stats(z, ids, 11)
    assert torch.equal(chunked[0], whole[0])
    torch.testing.assert_close(chunked[1], whole[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(whole[0].numpy(), np.bincount(ids.numpy(), minlength=11))


def test_dispatcher_runs_the_plain_version_on_cpu_and_detaches():
    rng = np.random.default_rng(2)
    z = torch.from_numpy(rng.standard_normal((40, 6), dtype=np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((8, 6), dtype=np.float32)).requires_grad_()
    before = vq_nearest_with_stats_cuda.launches
    got = vq_nearest_with_stats(z, c)
    want = vq_nearest_with_stats_reference(z.detach(), c.detach())
    assert vq_nearest_with_stats_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w) and not g.requires_grad


def test_k2_wrapper_raises_on_cpu_tensors():
    z, c = torch.zeros(4, 3), torch.zeros(8, 3)
    before = vq_nearest_with_stats_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        vq_nearest_with_stats_cuda(z, c)
    assert vq_nearest_with_stats_cuda.launches == before


def test_library_digest_covers_shared_headers(tmp_path, monkeypatch):
    """Editing a header under csrc/ renames the library, so a stale build is
    never loaded."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert len({first, second, _build.library_path("k")}) == 3
    assert first.name.startswith("libk-") and first.suffix == ".so"
