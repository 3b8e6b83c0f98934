"""Port parity of the conditional VAE (``models/vae_nets.py``) with each prior
of the JAX module (fixed, learned, conditioned, GMM with fixed or learned
weights, categorical with Gumbel-softmax), the MLP, and the config
templates of the baselines, against the JAX package in fp32 on the CPU.

The JAX module's draws are replayed: its forward and ``sample_prior`` take
their key explicitly, and the test hands the port the numbers drawn from it
(normals, Gumbel uniforms, mode and class ids).

Tolerances: outputs atol 1e-5 (magnitudes ~1; fp32 GEMMs in other orders),
the loss's gradients atol 1e-5 * max(1, |g|max) + rtol 1e-4.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models.base_nets import MLP as JaxMLP
from lipvq_tpu.models.vae_nets import VAE as JaxVAE
from lipvq_tpu.models.vae_nets import kl_divergence as jax_kl
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models.base_nets import MLP
from lipvq_tpu_torch.models.vae_nets import VAE, kl_divergence
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
X_DIM, LATENT, COND, B, CLASSES = 7, 3, 5, 6, 4
ATOL = 1e-5

PRIORS = {
    "fixed": {},
    "learned": {"prior_learn": True},
    "learned_conditioned": {"prior_learn": True, "prior_is_conditioned": True},
    "gmm": {"prior_learn": True, "prior_use_gmm": True, "prior_gmm_num_modes": 3},
    "gmm_learned_weights": {"prior_learn": True, "prior_use_gmm": True,
                            "prior_gmm_num_modes": 3, "prior_gmm_learn_weights": True},
    "gmm_conditioned": {"prior_learn": True, "prior_is_conditioned": True,
                        "prior_use_gmm": True, "prior_gmm_num_modes": 3,
                        "prior_gmm_learn_weights": True},
    "categorical": {"prior_use_categorical": True, "prior_categorical_dim": CLASSES,
                    "prior_categorical_gumbel_temp": 0.7},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(prior):
    kw = dict(input_dim=X_DIM, latent_dim=LATENT, cond_dim=COND, encoder_layer_dims=(16,),
              decoder_layer_dims=(16,), prior_layer_dims=(16,), **PRIORS[prior])
    jm = JaxVAE(**kw)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (B, X_DIM)).astype(np.float32)
    cond = rng.standard_normal((B, COND)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), x, cond, rng=jax.random.PRNGKey(1))["params"]
    # move the zero-initialized prior parameters off zero
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 * jax.random.normal(jax.random.PRNGKey(len(path)), v.shape)
        if path[0].key.startswith("prior_") and len(path) == 1 else v, params)
    pm = VAE(**kw)
    pm.load_state_dict(state_dict_from_jax_params(_np(params), pm), strict=True)
    return jm, params, pm, x, cond


def _forward_noise(prior, key):
    if prior == "categorical":
        return jax.random.uniform(key, (B, LATENT, CLASSES), minval=1e-10, maxval=1.0)
    return jax.random.normal(key, (B, LATENT))


@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_vae_forward_and_gradients_match_jax(prior):
    jm, params, pm, x, cond = _pair(prior)
    key = jax.random.PRNGKey(7)
    want = jm.apply({"params": params}, x, cond, rng=key)
    got = pm(torch.from_numpy(x), torch.from_numpy(cond),
             noise=torch.from_numpy(np.array(_forward_noise(prior, key))))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=ATOL, err_msg=k)
    if PRIORS[prior].get("prior_learn"):
        assert float(want["kl_loss"]) != float(jax_kl(want["mu"], want["logvar"]))

    def loss(p):
        out = jm.apply({"params": p}, x, cond, rng=key)
        return out["reconstruction_loss"] + out["kl_loss"]

    jgrad = state_dict_from_jax_params(_np(jax.grad(loss)(params)), pm)
    (got["reconstruction_loss"] + got["kl_loss"]).backward()
    assert {n for n, _ in pm.named_parameters()} == set(jgrad)
    for name, q in pm.named_parameters():
        scale = max(1.0, float(jgrad[name].abs().max()))
        np.testing.assert_allclose(q.grad.numpy(), jgrad[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * scale, err_msg=name)


def _prior_noise(prior, jm, params, cond, key):
    if prior == "categorical":
        return torch.from_numpy(np.array(jax.random.randint(key, (B, LATENT), 0, CLASSES)))
    if not PRIORS[prior].get("prior_learn"):
        return torch.from_numpy(np.array(jax.random.normal(key, (B, LATENT))))
    k_mode, k_normal = jax.random.split(key)
    _, _, logits = jm.apply({"params": params}, cond, B, method=JaxVAE._prior_params)
    mode = np.array(jax.random.categorical(k_mode, logits, axis=-1))
    eps = np.array(jax.random.normal(k_normal, (B, LATENT)))
    return torch.from_numpy(mode), torch.from_numpy(eps)


@pytest.mark.parametrize("prior", sorted(PRIORS))
def test_vae_sample_prior_matches_jax(prior):
    jm, params, pm, _, cond = _pair(prior)
    key = jax.random.PRNGKey(9)
    want = jm.apply({"params": params}, key, B, cond, method=JaxVAE.sample_prior)
    noise = _prior_noise(prior, jm, params, cond, key)
    got = pm.sample_prior(B, torch.from_numpy(cond), noise=noise)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)
    drawn = pm.sample_prior(B, torch.from_numpy(cond), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (B, X_DIM) and torch.isfinite(drawn).all()


def test_kl_divergence_matches_jax():
    rng = np.random.default_rng(1)
    mu, logvar = (rng.standard_normal((B, LATENT)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(kl_divergence(torch.from_numpy(mu), torch.from_numpy(logvar)),
                               float(jax_kl(jnp.asarray(mu), jnp.asarray(logvar))), rtol=1e-6)


@pytest.mark.parametrize("layer_dims,activation,output_activation",
                         [((16, 8), "relu", None), ((), "relu", None),
                          ((12,), "gelu", "tanh")])
def test_mlp_matches_jax(layer_dims, activation, output_activation):
    x = np.random.default_rng(2).standard_normal((4, 9)).astype(np.float32)
    jm = JaxMLP(layer_dims, 5, activation=activation, output_activation=output_activation)
    params = jm.init(jax.random.PRNGKey(0), x)["params"]
    pm = MLP(9, layer_dims, 5, activation=activation, output_activation=output_activation)
    pm.load_state_dict(state_dict_from_jax_params(_np(params)), strict=True)
    np.testing.assert_allclose(pm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply({"params": params}, x)), rtol=0, atol=ATOL)


@pytest.mark.parametrize("algo", ["bc", "act", "diffusion_policy"])
def test_config_from_template_equals_jax(algo):
    """exps/templates/{algo}.json through both config factories: every key
    equal, and every key of the template set as the template says."""
    template = json.loads((REPO / "exps" / "templates" / f"{algo}.json").read_text())
    port = json.loads(config_factory(algo, template).dump())
    want = json.loads(jax_config_factory(algo, template).dump())
    assert port == want

    def leaves(d, prefix=()):
        for k, v in d.items():
            if isinstance(v, dict) and v:
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    for path, value in leaves(template):
        node = port
        for k in path:
            node = node[k]
        assert node == value, path
