"""Port parity of the served slice: ``ICLTransformerGMM`` built through
``config_factory`` by both packages at a small width, the port loaded with
the JAX algo's ``state.params`` through the weight bridge."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.algo.rollout_policy import RolloutPolicy as JaxRolloutPolicy
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models.policy_nets import ICLGMMActorNetwork as JaxActor
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy, RolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils.jax_weights import load_jax_params

torch.set_num_threads(1)

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM, T, CODES = 12, 10, 32


def _config(factory, compute_dtype="bfloat16"):
    cfg = factory("icl", {
        "algo": {
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                "causal": False, "embed_dim": 64, "num_layers": 2, "num_heads": 4,
                "vq_vae_enabled": True, "ln_act_enabled": False,
                "compute_dtype": compute_dtype,
            },
            "vq": {"num_codes": CODES},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def _obs(rng, b, t=T):
    return {k: rng.standard_normal((b, t, *s), dtype=np.float32)
            for k, s in OBS_SHAPES.items()}


@pytest.fixture(scope="module")
def slice_models():
    """The JAX algo (bf16 compute, the config default) with a codebook set
    to the latents of 32 random actions, its params as numpy, and the port
    in bf16 and fp32 with the same weights."""
    rng = np.random.default_rng(0)
    jax_algo = jax_algo_factory("icl", _config(jax_config_factory), OBS_SHAPES, ac_dim=AC_DIM)
    params = jax_algo.state.params
    tok = params["net"]["encoder"]["action_network"]
    latent = tok["quantizer"]["codebook"].shape[1]
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=latent, num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(rng.standard_normal((CODES, AC_DIM), dtype=np.float32)),
        method=JaxLipVQVAE.encode)
    params = jax.tree.map(np.asarray, params)
    params["net"]["encoder"]["action_network"]["quantizer"]["codebook"] = np.asarray(codebook)
    ports = {}
    for dtype in ("bfloat16", "float32"):
        ports[dtype] = algo_factory("icl", _config(config_factory, dtype), OBS_SHAPES,
                                    ac_dim=AC_DIM, device="cpu")
        load_jax_params(ports[dtype], params)
    inputs = (_obs(rng, 3), _obs(rng, 3), rng.standard_normal((3, T, AC_DIM), dtype=np.float32))
    return jax_algo, params, ports, inputs


def _jax_dists(jax_algo, params, inputs, compute_dtype, low_noise_eval=False):
    net = jax_algo.net if compute_dtype == "bfloat16" else jax_algo.net.clone(compute_dtype=None)
    obs, ctx_obs, ctx_act = (jax.tree.map(jnp.asarray, a) for a in inputs)
    apply = jax.jit(functools.partial(net.apply, train=False, low_noise_eval=low_noise_eval,
                                      method=JaxActor.forward_train))
    dists, aux = apply({"params": params}, obs, ctx_obs, ctx_act)
    return [np.asarray(a, np.float32) for a in dists], float(aux)


TOLERANCES = {"float32": (1e-4, 1e-5), "bfloat16": (0.0, 3e-2)}


@pytest.mark.parametrize("compute_dtype", sorted(TOLERANCES))
def test_forward_train_matches_jax(slice_models, compute_dtype):
    jax_algo, params, ports, inputs = slice_models
    want, want_aux = _jax_dists(jax_algo, params, inputs, compute_dtype)
    port = ports[compute_dtype]
    with torch.inference_mode():
        dists, aux = port.nets.forward_train(*(port._put_infer(a) for a in inputs),
                                             low_noise_eval=False)
    rtol, atol = TOLERANCES[compute_dtype]
    for name, got, w in zip(("means", "scales", "logits"), dists, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=rtol, atol=atol, err_msg=name)
    assert abs(float(aux) - want_aux) <= 1e-5


def test_context_tokens_match_jax(slice_models):
    """The context actions take >= 8 distinct codes, the same in both."""
    jax_algo, params, ports, inputs = slice_models
    tok = params["net"]["encoder"]["action_network"]
    latent = tok["quantizer"]["codebook"].shape[1]
    acts = inputs[2].reshape(-1, AC_DIM)
    want = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=latent, num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(acts), method=JaxLipVQVAE.tokenize)
    got = ports["float32"].nets.net.encoder.action_network.tokenize(torch.from_numpy(acts))
    assert len(np.unique(np.asarray(want))) >= 8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_process_batch_for_training_matches_jax(slice_models):
    jax_algo, _, ports, _ = slice_models
    rng = np.random.default_rng(3)
    batch = {"obs": _obs(rng, 4, 2 * T - 1),
             "actions": rng.standard_normal((4, 2 * T - 1, AC_DIM), dtype=np.float32),
             "goal_obs": None}
    want = jax_algo.process_batch_for_training(batch)
    got = ports["float32"].process_batch_for_training(batch)
    np.testing.assert_array_equal(got["actions"], want["actions"])
    assert got["actions"].shape == (4, T, AC_DIM)
    for k in OBS_SHAPES:
        np.testing.assert_array_equal(got["obs"][k], want["obs"][k])
    assert got["goal_obs"] is None


def _near_a_mode(actions, means, tol=1e-3):
    """Every action row lies within ``tol`` of one of its row's mode means
    (low-noise eval samples with sigma = 1e-4)."""
    dist = np.abs(actions[:, None, :] - means).max(-1).min(-1)
    assert dist.max() <= tol, dist


def test_get_action_samples_a_mode_mean(slice_models):
    jax_algo, params, ports, inputs = slice_models
    (means, _, _), _ = _jax_dists(jax_algo, params, inputs, "float32", low_noise_eval=True)
    obs, ctx_obs, ctx_act = inputs
    acts = ports["float32"].get_action(obs, {"obs": ctx_obs, "actions": ctx_act})
    assert acts.shape == (3, AC_DIM) and np.isfinite(acts).all()
    _near_a_mode(acts, means[:, 0])  # pred_future_acs: the first step


def test_rollout_policy_batched_and_single(slice_models):
    jax_algo, params, ports, _ = slice_models
    rng = np.random.default_rng(4)
    n = 4
    context = {"obs": _obs(rng, 1),
               "actions": rng.standard_normal((1, T, AC_DIM), dtype=np.float32)}
    obs = _obs(rng, n)
    tiled = [{k: np.repeat(v, n, 0) for k, v in context["obs"].items()},
             np.repeat(context["actions"], n, 0)]
    (means, _, _), _ = _jax_dists(jax_algo, params, (obs, *tiled), "float32",
                                  low_noise_eval=True)
    policy = ICLRolloutPolicy(ports["float32"])
    acts = policy.batched(obs, context)
    assert acts.shape == (n, AC_DIM)
    _near_a_mode(acts, means[:, 0])
    # the context stays cached on the device for the same (context, n)
    assert policy._device_context(context, n) is policy._device_context(context, n)

    single = policy({k: v[0] for k, v in obs.items()}, context)
    assert single.shape == (AC_DIM,)
    _near_a_mode(single[None], means[:1, 0])


def test_postprocess_action_matches_jax():
    rng = np.random.default_rng(5)
    stats = {
        "actions_pos": {"offset": rng.standard_normal((1, 3)), "scale": rng.random((1, 3)) + 0.5},
        "actions_rot_6d": {"offset": rng.standard_normal((1, 6)) * 0.1,
                           "scale": rng.random((1, 6)) + 0.5},
        "actions_gripper": {"offset": np.zeros((1, 1)), "scale": np.ones((1, 1))},
    }
    ac = rng.standard_normal(10).astype(np.float32)
    want = JaxRolloutPolicy(None, action_normalization_stats=stats)._postprocess_action(ac)
    got = RolloutPolicy(None, action_normalization_stats=stats)._postprocess_action(ac)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (7,)
