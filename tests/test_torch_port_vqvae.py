"""The port's sibling VQ tokenizers (``models/tokenizers/vqvae.py``) against
the JAX package's, on the same seeded numpy inputs and bridged weights.

Tolerances:
- ``VQVAE``: ids exactly equal (the plain lookup on the CPU in both
  packages, on inputs without near-ties), the latent, loss and every
  gradient rtol 1e-5 / atol 1e-7 (fp32 GEMMs in other orders);
- ``LFQVAE``, ``SpectralLFQVAE`` (its power-iteration vectors ``u``
  advancing), the flax LSTM cell alone and ``LSTMVQVAE``: rtol 1e-4 /
  atol 1e-5 (normalizations, ten recurrent steps and a softmax over the
  codes compound the GEMMs' rounding).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models.tokenizers import vqvae as jax_vqvae
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.tokenizers import vqvae
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

VQ_TOL = {"rtol": 1e-5, "atol": 1e-7}
SEQ_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    state = {}
    for tree in variables.values():
        state.update(state_dict_from_jax_params(_np(tree)))
    module.load_state_dict(state, strict=True)
    return module


def _grads(port, jax_grads) -> list[tuple[str, np.ndarray, np.ndarray]]:
    """(name, port grad, bridged JAX grad) for every parameter."""
    want = state_dict_from_jax_params(_np(jax_grads))
    return [(n, p.grad.numpy(), want[n].numpy()) for n, p in port.named_parameters()]


@pytest.mark.parametrize("feature_dim,latent,codes", [(12, 32, 128), (7, 48, 16)])
def test_vqvae_matches_jax(feature_dim, latent, codes):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, feature_dim), dtype=np.float32)
    jm = jax_vqvae.VQVAE(feature_dim, latent, num_embeddings=codes)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    # codes near the latents of other inputs, so the ids vary
    params = _np(variables["params"])
    others = jnp.asarray(rng.standard_normal((codes, feature_dim), dtype=np.float32))
    params["embedding"] = (np.asarray(jm.apply(variables, others, method=jm.encode))
                           + rng.normal(0, 0.01, (codes, latent))).astype(np.float32)
    variables = {"params": params}
    port = _load(vqvae.VQVAE(feature_dim, latent, num_embeddings=codes), variables)

    def loss_fn(p):
        z, loss, ids = jm.apply({"params": p}, jnp.asarray(x))
        return loss, (z, ids)

    (want_loss, (want_z, want_ids)), jax_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(jax.tree.map(jnp.asarray, params))
    z, loss, ids = port(torch.from_numpy(x))
    loss.backward()
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert len(np.unique(ids.numpy())) > 1
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **VQ_TOL)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), **VQ_TOL)
    assert not z.requires_grad
    for name, got, want in _grads(port, jax_grads):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * max(1, np.abs(want).max()),
                                   err_msg=name)


def test_lfqvae_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((30, 12), dtype=np.float32)
    jm = jax_vqvae.LFQVAE(12, 24)
    variables = jm.init(jax.random.PRNGKey(3), jnp.asarray(x))
    port = _load(vqvae.LFQVAE(12, 24), variables)

    def loss_fn(p):
        z, loss = jm.apply({"params": p}, jnp.asarray(x))
        return loss, z

    (want_loss, want_z), jax_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    z, loss = port(torch.from_numpy(x))
    loss.backward()
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **SEQ_TOL)
    np.testing.assert_allclose(np.linalg.norm(z.numpy(), axis=-1)[np.abs(z.numpy()).sum(-1) > 0],
                               1.0, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), **SEQ_TOL)
    for name, got, want in _grads(port, jax_grads):
        np.testing.assert_allclose(got, want, **SEQ_TOL, err_msg=name)


def test_spectral_lfqvae_matches_jax_with_u_advancing():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((30, 12), dtype=np.float32)
    jm = jax_vqvae.SpectralLFQVAE(12, 24)
    state = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    port = _load(vqvae.SpectralLFQVAE(12, 24), state)
    u0 = port.enc_0.u.clone()
    for _ in range(3):  # training forwards, u carried between them
        (want_z, want_loss), upd = jm.apply(state, jnp.asarray(x), update_stats=True,
                                            mutable=["spectral_stats"])
        state = {"params": state["params"], **upd}
        z, loss = port(torch.from_numpy(x), update_stats=True)
        np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **SEQ_TOL)
        np.testing.assert_allclose(float(loss), float(want_loss), **SEQ_TOL)
        bridged = state_dict_from_jax_params(_np(state["spectral_stats"]))
        for name, u in bridged.items():
            np.testing.assert_allclose(port.get_buffer(name).numpy(), u.numpy(), **SEQ_TOL,
                                       err_msg=name)
    assert not torch.equal(port.enc_0.u, u0)
    frozen = port.enc_0.u.clone()
    want_z, want_loss = jm.apply(state, jnp.asarray(x), update_stats=False)
    z, loss = port(torch.from_numpy(x), update_stats=False)
    assert torch.equal(port.enc_0.u, frozen)
    np.testing.assert_allclose(float(loss), float(want_loss), **SEQ_TOL)


def test_flax_lstm_cell_alone_matches_the_packed_cell():
    """One flax OptimizedLSTMCell scanned over a sequence by nn.RNN (zero
    carry, batch-major) against the port's packed cell: the gate order and
    the kernels' transposes."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 10, 5), dtype=np.float32)
    rnn = fnn.RNN(fnn.OptimizedLSTMCell(features=7), time_major=False)
    variables = rnn.init(jax.random.PRNGKey(7), jnp.asarray(x))
    params = _np(variables["params"])
    assert set(params["cell"]) == {"ii", "if", "ig", "io", "hi", "hf", "hg", "ho"}
    # distinct biases per gate, so a swapped gate cannot pass
    for g, shift in zip("ifgo", (0.3, -0.2, 0.1, 0.5)):
        params["cell"][f"h{g}"]["bias"] = (params["cell"][f"h{g}"]["bias"] + shift).astype(
            np.float32)
    cell = vqvae.LSTMCell(5, 7)
    cell.load_state_dict(state_dict_from_jax_params(params["cell"]), strict=True)
    want = rnn.apply({"params": params}, jnp.asarray(x))
    got = cell(torch.from_numpy(x))
    assert got.shape == (3, 10, 7)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SEQ_TOL)


@pytest.mark.parametrize("feature_dim,latent,codes", [(12, 16, 32), (6, 24, 128)])
def test_lstm_vqvae_matches_jax(feature_dim, latent, codes):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((40, feature_dim), dtype=np.float32)  # 4 windows of 10
    jm = jax_vqvae.LSTMVQVAE(feature_dim, latent, num_embeddings=codes)
    variables = jm.init(jax.random.PRNGKey(9), jnp.asarray(x))
    assert {f"OptimizedLSTMCell_{i}" for i in range(3)} == set(variables["params"]["enc_lstm"])
    port = _load(vqvae.LSTMVQVAE(feature_dim, latent, num_embeddings=codes), variables)

    def loss_fn(p):
        z, loss = jm.apply({"params": p}, jnp.asarray(x))
        return loss, z

    (want_loss, want_z), jax_grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    z, loss = port(torch.from_numpy(x))
    loss.backward()
    assert z.shape == (40, latent)
    np.testing.assert_allclose(z.numpy(), np.asarray(want_z), **SEQ_TOL)
    np.testing.assert_allclose(float(loss), float(want_loss), **SEQ_TOL)
    for name, got, want in _grads(port, jax_grads):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(1, np.abs(want).max()),
                                   err_msg=name)


@pytest.mark.parametrize("cls,args", [(vqvae.VQVAE, (12, 16)), (vqvae.LFQVAE, (12, 16)),
                                      (vqvae.SpectralLFQVAE, (12, 16)),
                                      (vqvae.LSTMVQVAE, (12, 16))])
def test_seeded_init_is_deterministic_and_finite(cls, args):
    a = seeded_init(cls(*args), torch.Generator().manual_seed(3))
    b = seeded_init(cls(*args), torch.Generator().manual_seed(3))
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w) and torch.isfinite(v).all(), k
    if hasattr(a, "embedding"):
        bound = 1.0 / a.embedding.shape[0]
        assert float(a.embedding.abs().max()) <= bound
