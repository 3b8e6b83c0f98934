"""Port parity of the tokenizer-ablation arms and the Mamba backbone: each
module of the port against its JAX counterpart on the same seeded numpy
inputs and bridged weights (``utils/jax_weights.py``), in fp32.

Tolerances, by the arithmetic each comparison runs:
- MLPs, spectral norm, bin embeddings: rtol 1e-5 / atol 1e-6 (the same fp32
  GEMMs and reductions in other orders);
- the selective scan, Mamba, attention and the ICL composite: rtol 1e-4 /
  atol 1e-5 (the scan sums its recurrence in another order than
  ``associative_scan``; softmax over B*T keys and LayerNorms compound it);
- bin indices exactly equal off the bin boundaries; an input exactly on a
  boundary within one bin, as ``tests/test_tokenizer_parity.py`` allows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lipvq_tpu.models import mamba as jax_mamba
from lipvq_tpu.models.base_nets import SpectralNormLinear as JaxSN
from lipvq_tpu.models.obs_nets import ICLMIMOTransformer as JaxICL
from lipvq_tpu.models.obs_nets import LnActTokenizer as JaxLnAct
from lipvq_tpu.models.obs_nets import RawActionTokenizer as JaxRaw
from lipvq_tpu.models.tokenizers.bin_action import AdaptiveBinActionEmbedding as JaxBin
from lipvq_tpu_torch.models import mamba
from lipvq_tpu_torch.models.base_nets import SpectralNormLinear
from lipvq_tpu_torch.models.obs_nets import (
    ICLMIMOTransformer,
    LnActTokenizer,
    RawActionTokenizer,
    obs_spec,
)
from lipvq_tpu_torch.models.tokenizers.bin_action import AdaptiveBinActionEmbedding
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

MLP_TOL = {"rtol": 1e-5, "atol": 1e-6}
SEQ_TOL = {"rtol": 1e-4, "atol": 1e-5}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    """Bridge every collection of flax ``variables`` into ``module``
    (strict)."""
    state = {}
    for tree in variables.values():
        state.update(state_dict_from_jax_params(_np(tree)))
    module.load_state_dict(state, strict=True)
    return module


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# -- spectral norm -----------------------------------------------------------

@pytest.mark.parametrize("iterations", [1, 3])
def test_spectral_norm_linear_updates_u_like_jax(iterations):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((9, 6), dtype=np.float32)
    jm = JaxSN(5, n_power_iterations=iterations)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = _load(SpectralNormLinear(6, 5, n_power_iterations=iterations), variables)
    state = variables
    for _ in range(4):  # several training updates, u carried between them
        want, upd = jm.apply(state, jnp.asarray(x), update_stats=True,
                             mutable=["spectral_stats"])
        state = {"params": state["params"], **upd}
        got = port(_t(x), update_stats=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MLP_TOL)
        np.testing.assert_allclose(port.u.numpy(), np.asarray(state["spectral_stats"]["u"]),
                                   **MLP_TOL)


def test_spectral_norm_eval_leaves_u_unchanged():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 3), dtype=np.float32)
    jm = JaxSN(7)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    port = _load(SpectralNormLinear(3, 7), variables)
    u0 = port.u.clone()
    want = jm.apply(variables, jnp.asarray(x), update_stats=False)
    got = port(_t(x), update_stats=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MLP_TOL)
    assert torch.equal(port.u, u0)
    # the gradient reaches the weight through sigma as well
    got.sum().backward()
    assert port.weight.grad is not None and torch.isfinite(port.weight.grad).all()


# -- bin tokenizer -----------------------------------------------------------

def test_bin_discretize_matches_jax():
    rng = np.random.default_rng(2)
    a_dim, bins = 3, 20
    jm = JaxBin(a_dim, 16, num_bins=bins)
    bound = jm.bind(jm.init(jax.random.PRNGKey(4), jnp.zeros((4, a_dim)), update_stats=False))
    port = AdaptiveBinActionEmbedding(a_dim, 16, num_bins=bins)
    lo = np.array([-1.0, 0.0, -2.0], np.float32)
    hi = np.array([1.0, 4.0, 2.0], np.float32)
    a = (rng.uniform(-0.2, 1.2, (300, a_dim)) * (hi - lo) + lo).astype(np.float32)
    want = np.asarray(bound._discretize(jnp.asarray(a), jnp.asarray(lo), jnp.asarray(hi)))
    got = port.discretize(_t(a), _t(lo), _t(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    # inputs exactly on a boundary: within one bin
    edges = np.stack([np.linspace(lo[i], hi[i], bins + 1) for i in range(a_dim)],
                     axis=1).astype(np.float32)
    want = np.asarray(bound._discretize(jnp.asarray(edges), jnp.asarray(lo), jnp.asarray(hi)))
    got = port.discretize(_t(edges), _t(lo), _t(hi)).numpy()
    assert np.abs(got - want).max() <= 1


def test_bin_running_stats_and_output_match_jax():
    """Five updating calls with num_step_stop 3: the bounds freeze after the
    third; the output of each call and of an eval call equals JAX's."""
    rng = np.random.default_rng(3)
    jm = JaxBin(2, 16, num_bins=5, num_step_stop=3)
    variables = jm.init(jax.random.PRNGKey(5), jnp.zeros((4, 2)), update_stats=False)
    port = _load(AdaptiveBinActionEmbedding(2, 16, num_bins=5, num_step_stop=3), variables)
    # before any update: the batch's own bounds
    first = rng.standard_normal((8, 2)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(first), update_stats=False)
    np.testing.assert_allclose(port(_t(first), update_stats=False).detach().numpy(),
                               np.asarray(want), **MLP_TOL)
    assert int(port.num_step) == 0 and torch.isinf(port.running_min).all()
    state = variables
    batches = [rng.standard_normal((8, 2)).astype(np.float32) * (i + 1) for i in range(5)]
    for b in batches:
        want, upd = jm.apply(state, jnp.asarray(b), update_stats=True, mutable=["bin_stats"])
        state = {"params": state["params"], **upd}
        got = port(_t(b), update_stats=True)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **MLP_TOL)
        for k in ("running_min", "running_max", "num_step"):
            np.testing.assert_array_equal(getattr(port, k).numpy(),
                                          np.asarray(state["bin_stats"][k]), err_msg=k)
    assert int(port.num_step) == 3
    np.testing.assert_array_equal(port.running_min.numpy(),
                                  np.concatenate(batches[:3]).min(0))
    frozen = port.running_max.clone()
    port(_t(batches[-1] * 10), update_stats=False)
    assert torch.equal(port.running_max, frozen) and int(port.num_step) == 3


# -- raw and ln_act tokenizers -----------------------------------------------

@pytest.mark.parametrize("output_dim", [16, 13])  # 13: one head of 13
def test_raw_action_tokenizer_matches_jax(output_dim):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (24, 12)).astype(np.float32)  # B*T = 24: one sequence
    jm = JaxRaw(output_dim=output_dim, num_layers=2)
    variables = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))
    port = _load(RawActionTokenizer(12, output_dim, num_layers=2), variables)
    heads = port.attn_0.query.weight.shape[1]
    assert heads == (8 if output_dim % 8 == 0 else 1)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    got = port(_t(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SEQ_TOL)
    want, upd = jm.apply(variables, jnp.asarray(x), train=True, mutable=["spectral_stats"])
    got = port(_t(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **SEQ_TOL)
    np.testing.assert_allclose(port.sn3.u.numpy(),
                               np.asarray(upd["spectral_stats"]["sn3"]["u"]), **MLP_TOL)


def test_ln_act_tokenizer_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (3 * 10, 12)).astype(np.float32)
    jm = JaxLnAct(action_dim=12, output_dim=20, seq_len=10)
    variables = jm.init(jax.random.PRNGKey(7), jnp.asarray(x))
    port = _load(LnActTokenizer(12, 20, seq_len=10), variables)
    want = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), np.asarray(want), **SEQ_TOL)


# -- Mamba -------------------------------------------------------------------

def test_selective_scan_matches_associative_scan():
    rng = np.random.default_rng(6)
    b, t, d, n = 2, 30, 8, 4
    x = rng.standard_normal((b, t, d), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, d)))).astype(np.float32)
    A = -np.exp(rng.standard_normal((d, n))).astype(np.float32)
    B, C = (rng.standard_normal((b, t, n), dtype=np.float32) for _ in range(2))
    D = rng.standard_normal(d).astype(np.float32)
    want = jax_mamba.selective_scan(*(jnp.asarray(v) for v in (x, dt, A, B, C, D)))
    got = mamba.selective_scan(*(_t(v) for v in (x, dt, A, B, C, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SEQ_TOL)


def test_mamba_block_and_backbone_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 30, 24), dtype=np.float32)
    jb = jax_mamba.MambaBlock(d_model=24)
    variables = jb.init(jax.random.PRNGKey(8), jnp.asarray(x))
    port = _load(mamba.MambaBlock(24), variables)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(jb.apply(variables, jnp.asarray(x))), **SEQ_TOL)
    jbb = jax_mamba.MambaBackbone(d_model=24, num_layers=2)
    variables = jbb.init(jax.random.PRNGKey(9), jnp.asarray(x))
    port = _load(mamba.MambaBackbone(24, num_layers=2), variables)
    np.testing.assert_allclose(port(_t(x)).detach().numpy(),
                               np.asarray(jbb.apply(variables, jnp.asarray(x))), **SEQ_TOL)


# -- the ICL composite -------------------------------------------------------

OBS = obs_spec({"eef": (3,), "object": (5,)})
ARMS = {"vq": {"vq_vae_enabled": True}, "bin": {"bin_enabled": True},
        "ln_act": {"ln_act_enabled": True}, "raw": {}}
EMBEDDINGS = {"learned": {"nn_parameter_for_timesteps": True},
              "sinusoidal": {"nn_parameter_for_timesteps": False,
                             "sinusoidal_embedding": True},
              "table": {"nn_parameter_for_timesteps": False}}
CASES = ([(arm, "learned", bb) for arm in ARMS for bb in ("transformer", "mamba")]
         + [("ln_act", emb, bb) for emb in ("sinusoidal", "table")
            for bb in ("transformer", "mamba")])


@pytest.mark.parametrize("arm,embedding,backbone", CASES)
def test_icl_composite_matches_jax(arm, embedding, backbone):
    """Eval forward and one training forward (running statistics advanced
    in both packages) of ICLMIMOTransformer with each arm on both backbones,
    and each timestep embedding."""
    t, b = 10, 2
    kw = dict(output_spec=obs_spec({"action": (12,)}), backbone=backbone, embed_dim=32,
              num_layers=2, num_heads=4, context_length=t, causal=False, emb_dropout=0.0,
              attn_dropout=0.0, block_output_dropout=0.0, action_input_shape=12,
              vq_num_codes=16, **ARMS[arm], **EMBEDDINGS[embedding])
    rng = np.random.default_rng(8)
    obs, ctx = ({k: rng.standard_normal((b, t, *s), dtype=np.float32) for k, s in OBS}
                for _ in range(2))
    act = rng.uniform(-1, 1, (b, t, 12)).astype(np.float32)
    jm = JaxICL(group_specs=(("obs", OBS),), **kw)
    jin = (jax.tree.map(jnp.asarray, obs), jax.tree.map(jnp.asarray, ctx), jnp.asarray(act))
    variables = jm.init(jax.random.PRNGKey(10), *jin)
    port = _load(ICLMIMOTransformer(group_specs=(("obs", OBS),), **kw), variables)
    tin = ({k: _t(v) for k, v in obs.items()}, {k: _t(v) for k, v in ctx.items()}, _t(act))
    (want, want_aux) = jm.apply(variables, *jin)
    got, got_aux = port(*tin)
    np.testing.assert_allclose(got["action"].detach().numpy(), np.asarray(want["action"]),
                               **SEQ_TOL)
    np.testing.assert_allclose(float(got_aux.detach()), float(want_aux), rtol=1e-5, atol=1e-7)
    mutable = [c for c in ("bin_stats", "spectral_stats") if c in variables]
    (want, _), upd = jm.apply(variables, *jin, train=True, mutable=mutable)
    got, _ = port(*tin, train=True)
    np.testing.assert_allclose(got["action"].detach().numpy(), np.asarray(want["action"]),
                               **SEQ_TOL)
    bridged = {}
    for tree in upd.values():
        bridged.update(state_dict_from_jax_params(_np(tree)))
    buffers = dict(port.named_buffers())
    assert set(bridged) <= set(buffers)
    for k, v in bridged.items():
        np.testing.assert_allclose(buffers[k].numpy(), v.numpy(), **MLP_TOL, err_msg=k)
