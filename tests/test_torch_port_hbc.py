"""Port parity of the hierarchical algorithms against the JAX package on
bridged weights, in fp32 on the CPU: GL and GL-VAE steps, GL-VAE's
``sample_subgoals`` on JAX's draws, IRIS's ``ValuePlanner`` picking JAX's
subgoal, HBC's ``get_action`` over 12 calls (the subgoal refreshed at calls
0 and 10) and after ``reset``, the latent-subgoal mode, and IRIS's train
step (the GL-VAE planner, the goal-conditioned BC-GMM actor, the BCQ value).

The JAX draws are replayed: GL-VAE's posterior key is flax's
``make_rng("sample")`` in the scope ``vae`` under ``fold_in(rng, 7)`` of
the key the step was traced with, and the same numbers serve every step
(reference fault (f), below); the sampling calls split the planner's key;
IRIS's value BCQ draws as in tests/test_torch_port_rl.py.

The reference faults of this family, pinned in both packages (ROADMAP
queue 3): (f) GL-VAE trains on one fixed posterior noise; (g) IRIS's full
state drops its value BCQ; the GL / HBC / IRIS templates' ``seq_length`` 1
cannot reach ``subgoal_horizon`` 10; HBC and IRIS keep their subgoal and
call counter across episodes (fault (a) again); and the keys the classes
never read: GL-VAE's ``vae.{latent_clip, decoder.is_conditioned,
prior.is_conditioned, prior.use_categorical, prior_layer_dims}``, HBC's
actor switches (``gmm.enabled``, ``rnn.enabled``, ``transformer.enabled``:
the actor is always an MLP BC-GMM) and IRIS's ``discount``.

Tolerances: tests/test_torch_port_rl.py's (metrics rtol 1e-5, parameters
atol 2e-5 + rtol 1e-5, BCQ's atol 1e-4, forwards atol 1e-5); a sampled
action lies within 1e-3 of one of JAX's mode means (low-noise eval, sigma
1e-4).
"""

import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_rl import (
    AC_DIM,
    BATCH,
    FWD_ATOL,
    OBS_SHAPES,
    PARAM_ATOL,
    PARAM_ATOL_BCQ,
    _merge,
    assert_metrics,
    bcq_draws,
    normal,
    np_tree,
    rl_batches,
    scope_key,
)

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.algo.rollout_policy import RolloutPolicy as JaxRolloutPolicy
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.config.config import Config
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, load_jax_parts
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params as to_sd

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
HORIZON, LATENT = 3, 4
SMALL_VAE = {"latent_dim": LATENT, "encoder_layer_dims": [32, 32], "decoder_layer_dims": [32, 32]}
PLANNER = {"subgoal_horizon": HORIZON, "ae": {"planner_layer_dims": [32, 32]},
           "optim_params": {"goal_network": {"learning_rate": {"initial": 1e-3}}}}
ACTOR = {"actor_layer_dims": [32, 32], "gmm": {"num_modes": 3},
         "optim_params": {"policy": {"learning_rate": {"initial": 1e-3,
                                                       "scheduler_type": "constant"}}}}
# IRIS's value BCQ, cut down (the JAX IRIS merges algo.value over BCQ's defaults)
VALUE = {"critic": {"layer_dims": [32, 32], "num_action_samples": 3},
         "action_sampler": {"vae": {"latent_dim": LATENT}}}
# variant -> (algo name, algo overrides)
VARIANTS = {
    "gl": ("gl", PLANNER),
    "gl_vae": ("gl", {**PLANNER, "vae": {**SMALL_VAE, "enabled": True, "kl_weight": 0.5}}),
    "hbc": ("hbc", {"planner": PLANNER, "actor": ACTOR}),
    "hbc_latent": ("hbc", {"planner": {**PLANNER, "vae": {**SMALL_VAE, "enabled": True}},
                           "actor": ACTOR, "latent_subgoal": {"enabled": True}}),
    "iris": ("iris", {"planner": {**PLANNER, "vae": SMALL_VAE}, "actor": ACTOR,
                      "num_subgoal_samples": 4}),
}


def hier_config(factory, algo, over, value=VALUE):
    cfg = factory(algo, {"train": {"seed": 1, "batch_size": BATCH}, "algo": over})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
        if algo == "iris":
            cfg.algo.value = Config(value)
    return cfg


def jax_parts(jax_algo) -> dict:
    """The JAX algo's trees by part, as ``load_jax_parts`` takes them."""
    planner = getattr(jax_algo, "_raw_planner", getattr(jax_algo, "planner", None))
    if planner is None:  # GL / GL-VAE
        return {"": {"params_np": np_tree(jax_algo.state.params)}}
    parts = {"planner": {"params_np": np_tree(planner.state.params)},
             "actor": {"params_np": np_tree(jax_algo.actor.state.params),
                       "extra_vars_np": np_tree(jax_algo.actor.state.extra_vars)}}
    if hasattr(jax_algo, "value_bcq"):
        parts["value"] = {"params_np": np_tree(jax_algo.value_bcq.state.params),
                          "target_params_np": np_tree(jax_algo.value_bcq.state.target_params)}
    return parts


def make_pair(variant, extra=None, value=VALUE):
    algo, over = VARIANTS[variant]
    over = _merge(over, extra or {})
    jax_algo = jax_algo_factory(algo, hier_config(jax_config_factory, algo, over, value),
                                OBS_SHAPES, ac_dim=AC_DIM)
    port = algo_factory(algo, hier_config(config_factory, algo, over, value), OBS_SHAPES,
                        ac_dim=AC_DIM, device="cpu")
    parts = jax_parts(jax_algo)
    if "" in parts:
        load_jax_params(port, **parts[""])
    else:
        load_jax_parts(port, parts)
    return jax_algo, port


def jax_state_dict(jax_algo) -> dict:
    out = {}
    for part, trees in jax_parts(jax_algo).items():
        prefix = f"{part}." if part else ""
        out.update({prefix + k: v for k, v in to_sd(trees["params_np"]).items()})
        if "target_params_np" in trees:
            out.update({f"{prefix}target.{k}": v
                        for k, v in to_sd(trees["target_params_np"]).items()})
    return out


def vae_draws(gl_vae):
    """GL-VAE's posterior normals: the JAX step's fixed key (fault (f))."""
    key = scope_key(jax.random.fold_in(gl_vae.state.rng, 7), ["vae"])
    return {"noise": normal(key, (BATCH, gl_vae.latent_dim))}


def step_draws(jax_algo):
    name = type(jax_algo).__name__
    if name == "GLVAE":
        return vae_draws(jax_algo)
    if name == "HBC" and type(jax_algo.planner).__name__ == "GLVAE":
        return {"planner": vae_draws(jax_algo.planner)}
    if name == "IRIS":
        return {"planner": vae_draws(jax_algo._raw_planner),
                "value": bcq_draws(jax_algo.value_bcq, BATCH)}
    return None


def hier_batches(n, seed=11):
    return rl_batches(n, seed=seed, steps=HORIZON)


def snapshot(port):
    return {k: v.clone() for k, v in port.nets.state_dict().items()}


@pytest.fixture(scope="module")
def runs():
    """Each variant's pair after 3 parity steps, made once for the module."""
    cache = {}

    def run(variant):
        if variant not in cache:
            cache[variant] = _train_three(variant)
        return cache[variant]

    return run


def _train_three(variant):
    jax_algo, port = make_pair(variant)
    start = jax_state_dict(jax_algo)
    assert start.keys() == port.nets.state_dict().keys()
    snaps = []
    for raw in hier_batches(3):
        jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
        draws = step_draws(jax_algo)
        want = jax_algo.train_on_batch(jb, 0)["losses"]
        got = port.train_on_batch(pb, 0, draws=draws)["losses"]
        snaps.append(({k: float(v) for k, v in want.items()},
                      {k: float(v) for k, v in got.items()}, jax_state_dict(jax_algo),
                      snapshot(port)))
    return variant, start, snaps, jax_algo, port


@pytest.fixture(params=sorted(VARIANTS))
def trained(request, runs):
    return runs(request.param)


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    _, start, snaps, _, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step - 1]
    assert_metrics(got_m, want_m)
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        atol = PARAM_ATOL_BCQ if k.startswith("value.") else PARAM_ATOL
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=atol, rtol=1e-5,
                                   err_msg=k)
    # the same tensors move in both packages (the value BCQ's perturbation,
    # off, only by the rounding of polyak_ toward an equal net)
    skip = ("value.target.perturb.",)
    moved = {k for k in got_sd if not torch.equal(got_sd[k], start[k]) and not k.startswith(skip)}
    assert moved == {k for k in want_sd
                     if not torch.equal(want_sd[k], start[k]) and not k.startswith(skip)}


def test_validation_step_matches_jax(trained):
    _, _, _, jax_algo, port = trained
    raw = hier_batches(1, seed=4)[0]
    jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
    before = snapshot(port)
    draws = step_draws(jax_algo)
    want = jax_algo.train_on_batch(jb, 0, validate=True)["losses"]
    got = port.train_on_batch(pb, 0, validate=True, draws=draws)["losses"]
    assert_metrics(got, want)
    assert all(torch.equal(port.nets.state_dict()[k], v) for k, v in before.items())
    assert port.log_info({"losses": got}).keys() == jax_algo.log_info({"losses": want}).keys()


def _obs(seed, b=2):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((b, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}


def _close(got, want, atol=FWD_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_gl_vae_samples_subgoals_from_jax_draws():
    jax_gl, port = make_pair("gl_vae")
    obs = _obs(5, b=3)
    z = normal(jax.random.split(jax_gl.state.rng)[1], (3 * 4, LATENT))
    want = jax_gl.sample_subgoals(obs, num_samples=4)
    got = port.sample_subgoals(obs, num_samples=4, noise=z)
    for k in OBS_SHAPES:
        assert got[k].shape == (12, *OBS_SHAPES[k])
        _close(got[k], want[k])
    # posterior means and prior latents
    subgoals = _obs(6, b=3)
    _close(port.encode_latent_subgoals(obs, subgoals),
           jax_gl.encode_latent_subgoals(obs, subgoals))
    z = normal(jax.random.split(jax_gl.state.rng)[1], (3, LATENT))
    _close(jax_gl.sample_latent_subgoals(obs), z, atol=0)
    assert port.sample_latent_subgoals(obs).shape == (3, LATENT)


def test_value_planner_picks_jax_subgoal(runs):
    _, _, _, jax_iris, port = runs("iris")
    obs = _obs(7, b=3)
    n, planner, bcq = 4, jax_iris._raw_planner, jax_iris.value_bcq
    noise = {"subgoals": normal(jax.random.split(planner.state.rng)[1], (3 * n, LATENT)),
             "value": normal(jax.random.split(bcq.state.rng)[1],
                             (3 * n * bcq.n_samples, bcq.sampler.latent_dim))}
    want = jax_iris.planner.get_subgoal_predictions(obs)
    got = port.subgoal_planner.get_subgoal_predictions(obs, noise=noise)
    samples = port.planner.sample_subgoals(obs, num_samples=n, noise=noise["subgoals"])
    values = port.value_bcq.state_values(samples, noise=noise["value"]).reshape(3, n)
    assert (values.max(1).values > values.min(1).values).all()  # the pick matters
    for k in OBS_SHAPES:
        _close(got[k], want[k])
        _close(got[k], samples[k].reshape(3, n, -1)[torch.arange(3), values.argmax(1)])


def _jax_actor_means(jax_hbc, obs, goal):
    actor = jax_hbc.actor
    dists = actor.net.apply({"params": actor.state.params, **actor.state.extra_vars}, obs,
                            goal=jax.tree.map(jnp.asarray, goal), train=False,
                            method=type(actor.net).forward_train)
    return np.asarray(dists.means)


def test_hbc_get_action_refreshes_subgoals_and_resets():
    jax_hbc, port = make_pair("hbc")
    obs_seq = [_obs(20 + i) for i in range(12)]
    for i, obs in enumerate(obs_seq + obs_seq[:1]):
        if i == 12:  # a reset clears the subgoal and the counter in both
            for algo in (jax_hbc, port):
                algo.reset()
                assert algo.current_subgoal is None and algo._step_counter == 0
        want, got = jax_hbc.get_action(obs), port.get_action(obs)
        assert got.shape == want.shape == (2, AC_DIM) and np.isfinite(got).all()
        source = obs_seq[0] if i < 10 or i == 12 else obs_seq[10]
        expected = jax_hbc.planner.get_subgoal_predictions(source)
        for k in OBS_SHAPES:
            _close(jax_hbc.current_subgoal[k], expected[k], atol=0)
            _close(port.current_subgoal[k], expected[k])
        means = _jax_actor_means(jax_hbc, obs, jax_hbc.current_subgoal)
        assert np.abs(got[:, None] - means).max(-1).min(-1).max() <= 1e-3
        assert np.abs(want[:, None] - means).max(-1).min(-1).max() <= 1e-3


def test_hbc_latent_subgoals(runs):
    _, _, _, jax_hbc, port = runs("hbc_latent")
    assert port.latent_subgoal and port.actor.goal_shapes == {"latent_subgoal": (LATENT,)}
    obs = _obs(8)
    jax_hbc.reset()
    port.reset()
    z = normal(jax.random.split(jax_hbc.planner.state.rng)[1], (2, LATENT))
    jax_hbc.get_action(obs)
    _close(jax_hbc.current_subgoal["latent_subgoal"], z, atol=0)
    got = port.get_action(obs)
    assert port.current_subgoal["latent_subgoal"].shape == (2, LATENT) and got.shape == (2, AC_DIM)
    goal = {"latent_subgoal": z}
    with torch.no_grad():
        mine = port.actor.nets.forward_train(port.actor._put_infer(obs),
                                             goal=port.actor._put_infer(goal))
    _close(mine.means, _jax_actor_means(jax_hbc, obs, goal))


# -- reference faults ------------------------------------------------------------


def test_gl_vae_trains_on_one_fixed_noise_in_both_packages():
    """Fault (f): the JAX GL-VAE step reads ``state.rng`` at trace time and
    never advances it, so every step (and every validation) uses one
    posterior noise; the port draws one per batch size. In each package two
    validations of the same batch, with the sampling key or generator moved
    between them, give the same loss, and a loss on other noise differs."""
    jax_gl, port = make_pair("gl_vae")
    raw = hier_batches(1, seed=13)[0]
    jb, pb = jax_gl.process_batch_for_training(raw), port.process_batch_for_training(raw)
    first = float(jax_gl.train_on_batch(jb, 0, validate=True)["losses"]["goal_loss"])
    rng = jax_gl.state.rng
    jax_gl.state = jax_gl.state._replace(rng=jax.random.PRNGKey(99))
    assert float(jax_gl.train_on_batch(jb, 0, validate=True)["losses"]["goal_loss"]) == first
    eager = float(jax_gl._loss(jax_gl.state.params, jax_gl._put_batch(jb))[0])
    assert eager != first
    jax_gl.state = jax_gl.state._replace(rng=rng)
    jax_gl.train_on_batch(jb, 0)
    assert np.array_equal(np.asarray(jax_gl.state.rng), np.asarray(rng))

    noise = port.posterior_noise(BATCH)
    mine = float(port.train_on_batch(pb, 0, validate=True)["losses"]["goal_loss"])
    port.sample_subgoals(_obs(3), num_samples=2)  # moves the generator
    assert float(port.train_on_batch(pb, 0, validate=True)["losses"]["goal_loss"]) == mine
    other = {"noise": torch.randn((BATCH, LATENT), generator=torch.Generator().manual_seed(5))}
    assert float(port.train_on_batch(pb, 0, validate=True, draws=other)["losses"][
        "goal_loss"]) != mine
    port.train_on_batch(pb, 0)
    assert port.posterior_noise(BATCH) is noise


def test_iris_full_state_drops_the_value_bcq_in_both_packages():
    """Fault (g): IRIS's full state holds only the planner's and the actor's
    (HBC's ``serialize_full``), so a resumed IRIS starts its value BCQ at its
    init, optimizer state included, in both packages."""
    jax_iris, port = make_pair("iris")
    init_jax = np_tree(jax_iris.value_bcq.state.params)
    init_port = snapshot(port)
    for raw in hier_batches(2, seed=14):
        draws = step_draws(jax_iris)
        jax_iris.train_on_batch(jax_iris.process_batch_for_training(raw), 0)
        port.train_on_batch(port.process_batch_for_training(raw), 0, draws=draws)
    fresh_jax, fresh = make_pair("iris")
    fresh_jax.deserialize_full(jax_iris.serialize_full())
    for a, b in zip(jax.tree.leaves(fresh_jax.value_bcq.state.params), jax.tree.leaves(init_jax)):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(fresh_jax.value_bcq.state.step) == 0 and int(jax_iris.value_bcq.state.step) == 2
    for a, b in zip(jax.tree.leaves(fresh_jax.actor.state.params),
                    jax.tree.leaves(jax_iris.actor.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    buf = io.BytesIO()
    torch.save(port.serialize_full(), buf)
    buf.seek(0)
    fresh.deserialize_full(torch.load(buf, weights_only=True))
    assert set(port.serialize_full()) == {"planner", "actor"}
    state, trained_sd = fresh.nets.state_dict(), port.nets.state_dict()
    for k, v in state.items():
        assert torch.equal(v, init_port[k] if k.startswith("value.") else trained_sd[k]), k
    assert fresh.value_bcq.step == 0 and port.value_bcq.step == 2
    assert all(o.steps == 0 for o in fresh.value_bcq.optimizers().values())


@pytest.mark.parametrize("algo", ["gl", "hbc", "iris"])
def test_templates_cannot_reach_the_subgoal_horizon_in_both_packages(algo):
    """The GL, HBC and IRIS templates set ``train.seq_length`` 1 with a
    ``subgoal_horizon`` of 10: the subgoal ``next_obs[:, 9]`` is out of a
    one-step window, so the batch preparation raises IndexError in both
    packages (the JAX tests train with ``seq_length`` = the horizon)."""
    template = json.loads((REPO / "exps" / "templates" / f"{algo}.json").read_text())
    planner = template["algo"] if algo == "gl" else template["algo"]["planner"]
    assert template["train"]["seq_length"] == 1 and planner["subgoal_horizon"] == 10
    over = {"subgoal_horizon": 10} if algo == "gl" else {"planner": {"subgoal_horizon": 10}}
    variant = {"gl": "gl", "hbc": "hbc", "iris": "iris"}[algo]
    jax_algo, port = make_pair(variant, over)
    raw = rl_batches(1, seed=15, steps=template["train"]["seq_length"])[0]
    for a in (jax_algo, port):
        with pytest.raises(IndexError):
            a.process_batch_for_training(raw)


@pytest.mark.parametrize("variant", ["hbc", "iris"])
def test_subgoal_state_survives_episode_start_in_both_packages(variant):
    """Fault (a) again: ``RolloutPolicy.start_episode`` does not call
    ``reset``, so a new episode's first actions follow the previous
    episode's subgoal until the call counter reaches the next multiple of
    ``subgoal_update_interval``, in both packages."""
    jax_algo, port = make_pair(variant)
    for algo, cls in ((jax_algo, JaxRolloutPolicy), (port, RolloutPolicy)):
        policy = cls(algo)
        policy.start_episode()
        for i in range(3):
            policy({k: v[0] for k, v in _obs(30 + i).items()})
        kept = {k: np.array(v) for k, v in algo.current_subgoal.items()}
        policy.start_episode()
        policy({k: v[0] for k, v in _obs(40).items()})
        assert algo._step_counter == 4
        for k, v in kept.items():
            np.testing.assert_array_equal(np.asarray(algo.current_subgoal[k]), v)


UNREAD = {
    "gl_vae": {"vae": {"latent_clip": 0.5, "decoder": {"is_conditioned": False},
                       "prior": {"is_conditioned": True, "use_categorical": True,
                                 "categorical_dim": 3},
                       "prior_layer_dims": [8]}},
    "hbc": {"actor": {"gmm": {"enabled": False}, "rnn": {"enabled": True},
                      "transformer": {"enabled": True}}},
    "iris": {"discount": 0.5},
}


@pytest.mark.parametrize("variant", sorted(UNREAD))
def test_unread_keys_in_both_packages(variant):
    """GL-VAE reads none of ``vae.latent_clip``, ``decoder.is_conditioned``,
    ``prior.is_conditioned``, ``prior.use_categorical`` (a Gaussian VAE
    whatever it says) or ``prior_layer_dims``; HBC's actor is an MLP BC-GMM
    whatever its ``gmm`` / ``rnn`` / ``transformer`` switches say; IRIS
    reads no ``discount`` (its value BCQ has its own). With them changed,
    each package builds the same networks and takes the same step, bit for
    bit."""
    plain_jax, plain = make_pair(variant)
    odd_jax, odd = make_pair(variant, UNREAD[variant])
    raw = hier_batches(1, seed=16)[0]
    draws = step_draws(plain_jax)
    want = plain_jax.train_on_batch(plain_jax.process_batch_for_training(raw), 0)["losses"]
    got = odd_jax.train_on_batch(odd_jax.process_batch_for_training(raw), 0)["losses"]
    assert all(float(got[k]) == float(want[k]) for k in want)
    want_sd, got_sd = jax_state_dict(plain_jax), jax_state_dict(odd_jax)
    assert want_sd.keys() == got_sd.keys()
    assert all(torch.equal(got_sd[k], v) for k, v in want_sd.items())
    want = plain.train_on_batch(plain.process_batch_for_training(raw), 0, draws=draws)["losses"]
    got = odd.train_on_batch(odd.process_batch_for_training(raw), 0, draws=draws)["losses"]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert plain.nets.state_dict().keys() == odd.nets.state_dict().keys()
    assert all(torch.equal(odd.nets.state_dict()[k], v)
               for k, v in plain.nets.state_dict().items())
