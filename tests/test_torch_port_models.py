"""Port parity of the model modules: LipVQ-VAE, the GPT backbone and the GMM
distribution, each run by the JAX package and by the port on the same
weights (bridged from flax) and the same numpy inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models.distributions import (
    GMMParams as JaxGMM,
    gmm_log_prob as jax_gmm_log_prob,
    gmm_mean as jax_gmm_mean,
    make_gmm as jax_make_gmm,
)
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.models.transformer import (
    GPTBackbone as JaxGPTBackbone,
    sinusoidal_position_encoding as jax_sinusoidal,
)
from lipvq_tpu_torch.models.distributions import (
    GMMParams,
    gmm_log_prob,
    gmm_mean,
    gmm_sample,
    make_gmm,
)
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.models.transformer import GPTBackbone, sinusoidal_position_encoding
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

FEATURE, LATENT, CODES, HIDDEN = 12, 37, 32, 128


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def lipvq():
    """JAX LipVQ-VAE whose codebook is the latents of 32 random actions, so
    queries spread over many codes (at random init every latent would take
    the same code), and the port loaded with the same weights."""
    rng = np.random.default_rng(0)
    jax_model = JaxLipVQVAE(feature_dim=FEATURE, latent_dim=LATENT,
                            num_codes=CODES, hidden_dim=HIDDEN)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((2, FEATURE)))["params"]
    # ci = 200 on every 4th latent row: softplus(ci) exceeds the row's L1
    # norm there, so both branches of the Lipschitz bound are exercised
    ci = params["to_latent"]["ci"].at[::4].set(200.0)
    params = {**params, "to_latent": {**params["to_latent"], "ci": ci}}
    code_actions = rng.standard_normal((CODES, FEATURE), dtype=np.float32)
    codebook = jax_model.apply({"params": params}, jnp.asarray(code_actions),
                               method=JaxLipVQVAE.encode)
    params = {**params, "quantizer": {"codebook": codebook}}
    port = LipVQVAE(FEATURE, LATENT, num_codes=CODES, hidden_dim=HIDDEN)
    port.load_state_dict(state_dict_from_jax_params(_np_tree(params)), strict=True)
    x = rng.standard_normal((64, FEATURE), dtype=np.float32)
    return jax_model, {"params": params}, port, x


def test_lipvq_forward_matches_jax(lipvq):
    jax_model, variables, port, x = lipvq
    z_lat, loss, ids = jax_model.apply(variables, jnp.asarray(x))
    z_e = jax_model.apply(variables, jnp.asarray(x), method=JaxLipVQVAE.encode)
    recon = jax_model.apply(variables, z_lat, method=JaxLipVQVAE.decode)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        p_lat, p_loss, p_ids = port(xt)
        p_z_e = port.encode(xt)
        p_recon = port.decode(p_lat)
    assert len(np.unique(np.asarray(ids))) >= 8
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids))
    for got, want in ((p_z_e, z_e), (p_lat, z_lat), (p_recon, recon), (p_loss, loss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_lipvq_tokenize_detokenize_match_jax(lipvq):
    jax_model, variables, port, x = lipvq
    ids = jax_model.apply(variables, jnp.asarray(x), method=JaxLipVQVAE.tokenize)
    recon = jax_model.apply(variables, ids, method=JaxLipVQVAE.detokenize)
    with torch.no_grad():
        p_ids = port.tokenize(torch.from_numpy(x))
        p_recon = port.detokenize(p_ids)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(p_recon.numpy(), np.asarray(recon), rtol=1e-5, atol=1e-6)


def test_lipvq_gradients_follow_the_stop_gradients(lipvq):
    """No straight-through estimator: the encoder gets gradient only through
    the commitment loss, the codebook through recon + codebook loss, and the
    returned latent carries none."""
    _, _, port, x = lipvq
    z_lat, loss, _ = port(torch.from_numpy(x))
    assert not z_lat.requires_grad
    loss.backward()
    assert port.quantizer.codebook.grad.abs().sum() > 0
    assert port.enc1.weight.grad.abs().sum() > 0
    port.zero_grad()


BACKBONE_CASES = {
    # name: (compute_dtype, activation_dtype, causal, activation, rtol, atol)
    "fp32-bidirectional": (None, None, False, "gelu", 1e-4, 1e-5),
    "fp32-causal-geglu": (None, None, True, "geglu", 1e-4, 1e-5),
    "bf16-bidirectional": ("bfloat16", None, False, "gelu", 0.0, 3e-2),
    "bf16-residual-bf16": ("bfloat16", "bfloat16", False, "gelu", 0.0, 3e-2),
}


@pytest.mark.parametrize("case", sorted(BACKBONE_CASES))
def test_gpt_backbone_matches_jax(case):
    cd, ad, causal, activation, rtol, atol = BACKBONE_CASES[case]
    d, t = 64, 30
    jax_model = JaxGPTBackbone(embed_dim=d, context_length=t, causal=causal,
                               num_layers=2, num_heads=4, activation=activation,
                               compute_dtype=cd, activation_dtype=ad)
    params = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, t, d)))["params"]
    # widen the init (N(0, 0.02)) so attention and MLP move the output
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 10.0 if path[-1].key == "kernel" else v, params)
    x = np.random.default_rng(1).standard_normal((3, t, d), dtype=np.float32)
    apply = jax.jit(functools.partial(jax_model.apply, train=False))
    want = np.asarray(apply({"params": params}, jnp.asarray(x)), np.float32)

    dtype = {None: None, "bfloat16": torch.bfloat16}
    port = GPTBackbone(d, t, causal=causal, num_layers=2, num_heads=4,
                       activation=activation, compute_dtype=dtype[cd],
                       activation_dtype=dtype[ad])
    port.load_state_dict(state_dict_from_jax_params(_np_tree(params)), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_sinusoidal_position_encoding_matches_jax():
    ts = np.tile(np.arange(7, dtype=np.float32)[None], (2, 1))
    want = np.asarray(jax_sinusoidal(jnp.asarray(ts), 16))
    got = sinusoidal_position_encoding(torch.from_numpy(ts), 16).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _raw_gmm(rng, lead=(4, 3), modes=5, ac=6):
    return (rng.standard_normal(lead + (modes, ac), dtype=np.float32),
            rng.standard_normal(lead + (modes, ac), dtype=np.float32),
            rng.standard_normal(lead + (modes,), dtype=np.float32))


@pytest.mark.parametrize("low_noise", [False, True])
def test_gmm_log_prob_and_mean_match_jax(rng, low_noise):
    raw = _raw_gmm(rng)
    x = np.tanh(rng.standard_normal((4, 3, 6), dtype=np.float32))
    jd = jax_make_gmm(*map(jnp.asarray, raw), low_noise=low_noise)
    pd = make_gmm(*map(torch.from_numpy, raw), low_noise=low_noise)
    for got, want in zip(pd, jd):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want_lp = np.asarray(jax_gmm_log_prob(JaxGMM(*jd), jnp.asarray(x)))
    got_lp = gmm_log_prob(pd, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_lp, want_lp, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gmm_mean(pd).numpy(), np.asarray(jax_gmm_mean(JaxGMM(*jd))),
                               rtol=1e-6, atol=1e-6)


def test_gmm_sample_statistics():
    """Mode frequencies follow softmax(logits) and each sample sits at its
    mode's mean with its mode's scale."""
    n = 20000
    means = torch.tensor([[-2.0, 0.0], [0.0, 3.0], [4.0, -1.0]])
    scales = torch.tensor([[0.1, 0.2], [0.3, 0.1], [0.2, 0.2]])
    logits = torch.tensor([0.0, 1.0, -1.0])
    p = GMMParams(means.expand(n, 3, 2), scales.expand(n, 3, 2), logits.expand(n, 3))
    s = gmm_sample(p, torch.Generator().manual_seed(0))
    mode = torch.cdist(s, means).argmin(-1)
    freq = torch.bincount(mode, minlength=3).float() / n
    np.testing.assert_allclose(freq.numpy(), torch.softmax(logits, 0).numpy(), atol=0.015)
    for m in range(3):
        sel = s[mode == m]
        np.testing.assert_allclose(sel.mean(0).numpy(), means[m].numpy(), atol=0.02)
        np.testing.assert_allclose(sel.std(0).numpy(), scales[m].numpy(), rtol=0.05)
