"""Port parity of the nearest-code lookup: the port's plain PyTorch versions
against the JAX reference and the Pallas kernel (interpret mode) on the
fixtures of tests/test_vq_lookup.py. Ids must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.ops.vq_lookup import (
    vq_distances_reference as jax_distances,
    vq_nearest_pallas,
    vq_nearest_reference as jax_reference,
)
from lipvq_tpu_torch.ops.vq_lookup import (
    vq_distances_reference,
    vq_nearest,
    vq_nearest_cuda,
    vq_nearest_expand,
    vq_nearest_reference,
)

torch.set_num_threads(1)


def _jax_ids(z, c):
    ref = np.asarray(jax_reference(jnp.asarray(z), jnp.asarray(c)))
    fused = np.asarray(vq_nearest_pallas(jnp.asarray(z), jnp.asarray(c),
                                         block_b=128, interpret=True))
    np.testing.assert_array_equal(fused, ref)
    return ref


def _port_ids(z, c):
    zt, ct = torch.from_numpy(z), torch.from_numpy(c)
    ids = {
        "reference": vq_nearest_reference(zt, ct),
        "expand": vq_nearest_expand(zt, ct),
        "dispatch": vq_nearest(zt, ct),
    }
    for name, got in ids.items():
        assert got.dtype == torch.int32, name
    return {name: got.numpy() for name, got in ids.items()}


@pytest.mark.parametrize("b,n,d", [(80, 128, 12), (300, 1024, 208), (512, 256, 64)])
def test_port_ids_equal_jax(rng, b, n, d):
    z = rng.standard_normal((b, d), dtype=np.float32)
    c = rng.standard_normal((n, d), dtype=np.float32)
    want = _jax_ids(z, c)
    for name, got in _port_ids(z, c).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_port_ids_sigmoid_saturated(rng):
    b, n, d = 400, 256, 32
    z = np.array(jax.nn.sigmoid(10.0 * rng.standard_normal((b, d)).astype(np.float32)))
    c = np.array(jax.nn.sigmoid(10.0 * rng.standard_normal((n, d)).astype(np.float32)))
    want = _jax_ids(z, c)
    for name, got in _port_ids(z, c).items():
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_port_tie_breaking_lowest_index():
    z = np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32)
    c = np.asarray([[5.0, 5.0], [1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]],
                   np.float32)
    np.testing.assert_array_equal(_jax_ids(z, c), [1, 3])
    for name, got in _port_ids(z, c).items():
        np.testing.assert_array_equal(got, [1, 3], err_msg=name)


def test_port_reference_chunks_rows(rng, monkeypatch):
    """A chunk smaller than the batch gives the same ids as one chunk."""
    import lipvq_tpu_torch.ops.vq_lookup as vq

    z = torch.from_numpy(rng.standard_normal((50, 16), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((64, 16), dtype=np.float32))
    whole = vq.vq_nearest_reference(z, c)
    monkeypatch.setattr(vq, "_REFERENCE_CHUNK_ELEMS", 7 * 64 * 16)
    np.testing.assert_array_equal(vq.vq_nearest_reference(z, c).numpy(), whole.numpy())


def test_port_distances_expand_form(rng):
    z = rng.standard_normal((40, 24), dtype=np.float32)
    c = rng.standard_normal((32, 24), dtype=np.float32)
    want = np.asarray(jax_distances(jnp.asarray(z), jnp.asarray(c)))
    got = vq_distances_reference(torch.from_numpy(z), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dispatch_detaches_inputs(rng):
    z = torch.from_numpy(rng.standard_normal((8, 5), dtype=np.float32)).requires_grad_()
    c = torch.from_numpy(rng.standard_normal((16, 5), dtype=np.float32)).requires_grad_()
    ids = vq_nearest(z, c)
    assert not ids.requires_grad
    np.testing.assert_array_equal(ids.numpy(), vq_nearest_reference(z.detach(), c.detach()).numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the K1 wrapper raises instead of launching, and its
    launch count does not move."""
    before = vq_nearest_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        vq_nearest_cuda(torch.zeros(4, 3), torch.zeros(8, 3))
    assert vq_nearest_cuda.launches == before
