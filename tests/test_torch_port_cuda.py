"""Kernel K1 on the card against its plain PyTorch version.

These tests need an NVIDIA GPU and nvcc and skip without them. The machine
with the card has no JAX, so this file imports none and runs without the
repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.ops.vq_lookup import vq_nearest, vq_nearest_cuda, vq_nearest_reference

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
