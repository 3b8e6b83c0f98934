"""Port parity of the offline-RL family against the JAX package on bridged
weights, in fp32 on the CPU: ``rl_common`` (``process_rl_batch`` with
``n_step`` 1 and 3 and ``infinite_horizon``, ``td_target``, ``huber``,
``polyak_``), the value networks (bounds, the ensemble, the distributional
one), and for TD3-BC, IQL, CQL and BCQ (the perturbation off, as in the
template, and on): the factory's dispatch, 1 and 3 train steps (metrics,
every parameter, the target networks, CQL's ``log_alpha``), the validation
step, ``get_action``, and the checkpoint and full-state round trips.
TD3-BC's first three steps move the actor on steps 0 and 2 only and the
targets on every step, in both packages.

The JAX steps' draws are replayed: each test splits the JAX state's key
as the step does (TD3-BC's smoothing noise, CQL's five-way split, BCQ's
four-way split, where the VAE's posterior key is flax's
``make_rng("sample")`` in the scope ``vae``, found with a probe module at
that path) and hands the numbers to the port (``draws=``, ``noise=``).

The template keys the JAX classes never read are pinned in both packages
(ROADMAP queue 3): with them changed, each package builds the same
networks and takes the same step as with the defaults, bit for bit.

Tolerances (tests/test_torch_port_bc.py's): metrics rtol 1e-5, parameters
atol 2e-5 + rtol 1e-5 (Adam's per-element normalization at lr <= 1e-3: an
element whose gradient is near Adam's eps moves by a share of its step that
the gradient's last digits decide), eval forwards atol 1e-5. BCQ's
parameters take atol 1e-4, a tenth of its template's lr of 1e-3: its action
VAE is 300 x 400 whatever the config says (120000 weights in one layer), and
one of them, in ``sampler.vae.enc_mlp.TorchLinear_1.weight``, measured
2.28e-5 from JAX's after the first step, the case above.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo import rl_common as jax_rl
from lipvq_tpu.algo.base import ALGO_REGISTRY as JAX_REGISTRY
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models import value_nets as jax_value_nets
from lipvq_tpu.models.obs_nets import obs_spec as jax_obs_spec
from lipvq_tpu_torch.algo import algo_factory, rl_common
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models import value_nets
from lipvq_tpu_torch.models.obs_nets import obs_spec
from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint, save_checkpoint
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, BATCH, STEPS = 7, 8, 4
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5
PARAM_ATOL_BCQ = 1e-4  # a tenth of BCQ's lr of 1e-3 (the docstring argues it)
FWD_ATOL, METRIC_RTOL = 1e-5, 1e-5
SMALL = {"layer_dims": [32, 32]}
# variant -> (algo name, algo overrides)
VARIANTS = {
    "td3_bc": ("td3_bc", {"actor": SMALL, "critic": SMALL}),
    "iql": ("iql", {"actor": SMALL, "critic": SMALL}),
    "iql_gmm": ("iql", {"actor": {**SMALL, "net": {"type": "gmm", "gmm": {"num_modes": 3}}},
                        "critic": SMALL, "adv": {"clip_adv_value": 0.1}}),
    "cql": ("cql", {"actor": SMALL, "critic": {**SMALL, "num_random_actions": 4}}),
    "bcq": ("bcq", {"critic": {**SMALL, "num_action_samples": 4},
                    "action_sampler": {"vae": {"latent_dim": 4}}}),
    "bcq_perturb": ("bcq", {"critic": {**SMALL, "num_action_samples": 4},
                            "actor": {"enabled": True, "perturbation_scale": 0.3},
                            "action_sampler": {"vae": {"latent_dim": 4}}}),
}
CLASSES = {"td3_bc": "TD3_BC", "iql": "IQL", "cql": "CQL", "bcq": "BCQ"}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _merge(d: dict, over: dict) -> dict:
    d = dict(d)
    for k, v in over.items():
        d[k] = _merge(d.get(k, {}), v) if isinstance(v, dict) else v
    return d


def rl_config(factory, algo, over):
    cfg = factory(algo, {"train": {"seed": 1, "batch_size": BATCH}, "algo": over})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def make_pair(variant, extra=None):
    algo, over = VARIANTS[variant]
    over = _merge(over, extra or {})
    jax_algo = jax_algo_factory(algo, rl_config(jax_config_factory, algo, over), OBS_SHAPES,
                                ac_dim=AC_DIM)
    port = algo_factory(algo, rl_config(config_factory, algo, over), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")
    load_jax_params(port, np_tree(jax_algo.state.params),
                    target_params_np=np_tree(jax_algo.state.target_params))
    return jax_algo, port


def rl_batches(n, seed=11, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [{"obs": {k: rng.standard_normal((BATCH, steps, *s), dtype=np.float32)
                     for k, s in OBS_SHAPES.items()},
             "next_obs": {k: rng.standard_normal((BATCH, steps, *s), dtype=np.float32)
                          for k, s in OBS_SHAPES.items()},
             "actions": rng.uniform(-0.9, 0.9, (BATCH, steps, AC_DIM)).astype(np.float32),
             "rewards": rng.standard_normal((BATCH, steps)).astype(np.float32),
             "dones": (rng.uniform(size=(BATCH, steps)) < 0.3).astype(np.float32)}
            for _ in range(n)]


class Probe(fnn.Module):
    """The key that flax's ``make_rng("sample")`` gives at the scope path
    ``scopes`` under the root's rngs."""

    scopes: tuple

    @fnn.compact
    def __call__(self):
        if not self.scopes:
            return self.make_rng("sample")
        return Probe(self.scopes[1:], name=self.scopes[0])()


def scope_key(key, path):
    return Probe(tuple(path)).apply({}, rngs={"sample": key})


def normal(key, shape):
    return np.array(jax.random.normal(key, shape))


def bcq_draws(jax_bcq, b):
    """BCQ's step draws: the VAE's posterior normals, the next obs'
    candidates' prior normals and the perturbation loss's."""
    _, k_vae, k_next, k_pert = jax.random.split(jax_bcq.state.rng, 4)
    latent, n = jax_bcq.sampler.latent_dim, jax_bcq.n_samples
    return {"vae": normal(scope_key(k_vae, ["vae"]), (b, latent)),
            "next": normal(k_next, (b * n, latent)), "perturb": normal(k_pert, (b, latent))}


def step_draws(jax_algo, b=BATCH):
    """The numbers the JAX algo's next train step draws."""
    name = type(jax_algo).__name__
    if name == "TD3_BC":
        return {"noise": normal(jax.random.split(jax_algo.state.rng)[1], (b, AC_DIM))}
    if name == "CQL":
        _, k1, k2, k3, k4 = jax.random.split(jax_algo.state.rng, 5)
        shape = (b, AC_DIM)
        return {"next_eps": normal(k1, shape), "pi_eps": normal(k3, shape),
                "actor_eps": normal(k4, shape),
                "rand": np.array(jax.random.uniform(k2, (jax_algo.num_rand, *shape),
                                                    minval=-1.0, maxval=1.0))}
    if name == "BCQ":
        return bcq_draws(jax_algo, b)
    return None


def jax_state_dict(jax_algo):
    """The JAX algo's params and target params as the port's state_dict."""
    sd = state_dict_from_jax_params(np_tree(jax_algo.state.params))
    sd.update({f"target.{k}": v for k, v in
               state_dict_from_jax_params(np_tree(jax_algo.state.target_params)).items()})
    return sd


def assert_params(got_sd, want_sd, atol=PARAM_ATOL):
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=atol,
                                   rtol=PARAM_RTOL, err_msg=k)


def assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=k)


def snapshot(port):
    return {k: v.clone() for k, v in port.nets.state_dict().items()}


# -- rl_common ---------------------------------------------------------------

@pytest.mark.parametrize("n_step,infinite", [(1, False), (3, False), (3, True)])
def test_process_rl_batch_matches_jax(n_step, infinite):
    raw = rl_batches(1, seed=3)[0]
    want = jax_rl.process_rl_batch(raw, n_step=n_step, discount=0.9, infinite_horizon=infinite)
    got = rl_common.process_rl_batch(raw, n_step=n_step, discount=0.9,
                                     infinite_horizon=infinite)
    assert set(got) == set(want)
    for k in ("actions", "rewards", "dones"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for group in ("obs", "next_obs"):
        for k in OBS_SHAPES:
            np.testing.assert_array_equal(got[group][k], want[group][k])
    with pytest.raises(KeyError, match="next_obs"):
        rl_common.process_rl_batch({k: v for k, v in raw.items() if k != "next_obs"})


def test_td_target_huber_and_polyak_match_jax():
    rng = np.random.default_rng(5)
    r, v = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    d = (rng.uniform(size=64) < 0.5).astype(np.float32)
    x = (3 * rng.standard_normal(256)).astype(np.float32)
    t, o = (rng.standard_normal((16, 8)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        rl_common.td_target(*map(torch.from_numpy, (r, d, v)), 0.99, 3).numpy(),
        np.asarray(jax_rl.td_target(r, d, v, 0.99, 3)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rl_common.huber(torch.from_numpy(x), 1.5).numpy(),
                               np.asarray(jax_rl.huber(jnp.asarray(x), 1.5)), rtol=1e-6)
    mine = torch.from_numpy(t.copy())
    rl_common.polyak_([mine], [torch.from_numpy(o)], 0.005)
    np.testing.assert_allclose(mine.numpy(), np.asarray(jax_rl.polyak(t, o, 0.005)),
                               rtol=1e-6, atol=1e-7)


def test_frozen_copy_holds_buffers():
    net = value_nets.QEnsemble(obs_spec_group(), AC_DIM, layer_dims=(8,))
    copy = rl_common.frozen_copy(net)
    assert not list(copy.parameters())
    assert {k for k, _ in copy.named_buffers()} == {k for k, _ in net.named_parameters()}


# -- value networks ----------------------------------------------------------

def obs_spec_group():
    return (("obs", obs_spec(OBS_SHAPES)),)


def _value_inputs(seed):
    rng = np.random.default_rng(seed)
    obs = {k: rng.standard_normal((5, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}
    return obs, rng.uniform(-1, 1, (5, AC_DIM)).astype(np.float32)


@pytest.mark.parametrize("kind,bounds", [("v", None), ("v", (-2.0, 3.0)), ("q", None),
                                         ("q", (0.0, 10.0)), ("ensemble", (-1.0, 1.0)),
                                         ("distributional", (-1.0, 20.0))])
def test_value_networks_match_jax(kind, bounds):
    specs = (("obs", jax_obs_spec(OBS_SHAPES)),)
    obs, act = _value_inputs(7)
    dims = (16, 24)
    if kind == "v":
        jmod = jax_value_nets.ValueNetwork(specs, dims, bounds)
        mine = value_nets.ValueNetwork(obs_spec_group(), dims, bounds)
        args = (obs,)
    elif kind == "q":
        jmod = jax_value_nets.ActionValueNetwork(specs, AC_DIM, dims, bounds)
        mine = value_nets.ActionValueNetwork(obs_spec_group(), AC_DIM, dims, bounds)
        args = (obs, act)
    elif kind == "ensemble":
        jmod = jax_value_nets.QEnsemble(specs, AC_DIM, 3, dims, bounds)
        mine = value_nets.QEnsemble(obs_spec_group(), AC_DIM, 3, dims, bounds)
        args = (obs, act)
    else:
        jmod = jax_value_nets.DistributionalActionValueNetwork(specs, AC_DIM, 11, bounds, dims)
        mine = value_nets.DistributionalActionValueNetwork(obs_spec_group(), AC_DIM, 11, bounds,
                                                           dims)
        args = (obs, act)
    params = jmod.init(jax.random.PRNGKey(3), *args)["params"]
    mine.load_state_dict(state_dict_from_jax_params(np_tree(params)), strict=True)
    t_args = [({k: torch.from_numpy(v) for k, v in a.items()} if isinstance(a, dict)
               else torch.from_numpy(a)) for a in args]
    with torch.no_grad():
        np.testing.assert_allclose(mine(*t_args).numpy(),
                                   np.asarray(jmod.apply({"params": params}, *args)),
                                   rtol=0, atol=FWD_ATOL)
        if kind == "distributional":
            np.testing.assert_allclose(
                mine(*t_args, return_logits=True).numpy(),
                np.asarray(jmod.apply({"params": params}, *args, return_logits=True)),
                rtol=0, atol=FWD_ATOL)
            np.testing.assert_allclose(mine.atoms.numpy(), jmod.atoms, rtol=1e-6)


# -- the four algorithms -------------------------------------------------------

def test_factory_dispatch_matches_jax():
    for variant, (algo, over) in VARIANTS.items():
        jax_cls, _ = JAX_REGISTRY[algo](rl_config(jax_config_factory, algo, over).algo)
        port = port_algo(variant)
        assert type(port).__name__ == jax_cls.__name__ == CLASSES[algo]


def port_algo(variant):
    algo, over = VARIANTS[variant]
    return algo_factory(algo, rl_config(config_factory, algo, over), OBS_SHAPES, ac_dim=AC_DIM,
                        device="cpu")


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def trained(request):
    variant = request.param
    jax_algo, port = make_pair(variant)
    assert sorted(port.optimizers()) == sorted(jax_algo.tx)
    assert set(port.nets.target) == set(jax_algo.state.target_params)
    start = jax_state_dict(jax_algo)
    snaps = []
    for raw in rl_batches(3):
        jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
        draws = step_draws(jax_algo)
        want = jax_algo.train_on_batch(jb, 0)["losses"]
        got = port.train_on_batch(pb, 0, draws=draws)["losses"]
        snaps.append(({k: float(v) for k, v in want.items()},
                      {k: float(v) for k, v in got.items()}, jax_state_dict(jax_algo),
                      snapshot(port), port.step))
    return variant, start, snaps, jax_algo, port


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    variant, start, snaps, _, _ = trained
    want_m, got_m, want_sd, got_sd, port_step = snaps[step - 1]
    assert_metrics(got_m, want_m)
    assert_params(got_sd, want_sd, PARAM_ATOL_BCQ if variant.startswith("bcq") else PARAM_ATOL)
    # the same tensors move in both packages: all but those of an exact
    # gradient 0 (IQL's one-mode logits) or of the perturbation when it is
    # off (its target then moves toward an equal net: by the port's rounding
    # of polyak_, up to an ulp, held above with the parameters)
    moved = {k for k in got_sd if not torch.equal(got_sd[k], start[k])
             and not k.startswith("target.perturb.")}
    assert moved == {k for k in want_sd if not torch.equal(want_sd[k], start[k])
                     and not k.startswith("target.perturb.")}
    assert {k for k in got_sd if not k.startswith("target.perturb.")} - moved == (
        {k for k in got_sd if k.startswith("perturb.")} if variant == "bcq" else
        {"actor.logits.weight", "actor.logits.bias"} if variant == "iql" else set())
    assert port_step == step


def test_validation_step_matches_jax(trained):
    _, _, _, jax_algo, port = trained
    raw = rl_batches(1, seed=4)[0]
    jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
    before, step = snapshot(port), port.step
    draws = step_draws(jax_algo)
    want = jax_algo.train_on_batch(jb, 0, validate=True)["losses"]
    got = port.train_on_batch(pb, 0, validate=True, draws=draws)["losses"]
    assert_metrics(got, want)
    assert all(torch.equal(port.nets.state_dict()[k], v) for k, v in before.items())
    assert port.step == step
    assert port.log_info({"losses": got}).keys() == jax_algo.log_info({"losses": want}).keys()


def test_td3_bc_updates_the_actor_every_other_step_in_both_packages():
    jax_algo, port = make_pair("td3_bc")
    jax_actor = [np_tree(jax_algo.state.params["actor"])]
    jax_targets = [np_tree(jax_algo.state.target_params)]
    port_sd = [snapshot(port)]
    for raw in rl_batches(3, seed=8):
        draws = step_draws(jax_algo)
        jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        losses = port.train_on_batch(port.process_batch_for_training(raw), 0, draws=draws)
        jax_actor.append(np_tree(jax_algo.state.params["actor"]))
        jax_targets.append(np_tree(jax_algo.state.target_params))
        port_sd.append(snapshot(port))
        assert (float(losses["losses"]["actor_loss"]) == 0.0) == (port.step == 2)

    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))

    def port_same(a, b, prefix):
        return all(torch.equal(a[k], b[k]) for k in a if k.startswith(prefix))

    # steps 0, 1, 2: the actor moves on 0 and 2; both targets on all three
    assert [same(jax_actor[i], jax_actor[i + 1]) for i in range(3)] == [False, True, False]
    assert [port_same(port_sd[i], port_sd[i + 1], "actor.") for i in range(3)] == [
        False, True, False]
    for prefix in ("target.actor.", "target.critic."):
        assert not any(port_same(port_sd[i], port_sd[i + 1], prefix) for i in range(3))
    assert not any(same(jax_targets[i], jax_targets[i + 1]) for i in range(3))
    assert int(jax_algo.state.step) == port.step == 3
    assert port.optim["actor"].steps == 2 and port.optim["critic"].steps == 3


def _obs(seed, lead=(3,)):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}


def _action_noise(jax_algo, obs):
    """The numbers the JAX algo's next ``get_action`` draws."""
    key = jax.random.split(jax_algo.state.rng)[1]
    b = next(iter(obs.values())).shape[0]
    name = type(jax_algo).__name__
    if name == "CQL":
        return normal(key, (b, AC_DIM))
    if name == "BCQ":
        return normal(key, (b * jax_algo.n_samples, jax_algo.sampler.latent_dim))
    if name == "IQL":
        from lipvq_tpu.models.policy_nets import GMMActorNetwork

        dists = jax_algo.actor.apply({"params": jax_algo.state.params["actor"]}, obs,
                                     method=GMMActorNetwork.forward_train)
        k_mode, k_normal = jax.random.split(key)
        return (np.array(jax.random.categorical(k_mode, dists.logits, axis=-1)),
                normal(k_normal, (b, AC_DIM)))
    return None


def test_get_action_matches_jax(trained):
    _, _, _, jax_algo, port = trained
    obs = _obs(3)
    noise = _action_noise(jax_algo, obs)
    want = jax_algo.get_action(obs)
    got = port.get_action(obs) if noise is None else port.get_action(obs, noise=noise)
    assert got.shape == (3, AC_DIM) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    # a time axis is cut to its last step
    stacked = {k: np.stack([np.zeros_like(v), v], 1) for k, v in obs.items()}
    again = port.get_action(stacked) if noise is None else port.get_action(stacked, noise=noise)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("variant", ["td3_bc", "iql", "cql", "bcq"])
def test_checkpoint_and_full_state_round_trip(variant, tmp_path):
    algo_name, over = VARIANTS[variant]
    port = port_algo(variant)
    batches = [port.process_batch_for_training(b) for b in rl_batches(3, seed=9)]
    gen = torch.Generator().manual_seed(0)

    def draws():
        shapes = {"td3_bc": {"noise": (BATCH, AC_DIM)}, "iql": {},
                  "cql": {k: (BATCH, AC_DIM) for k in ("next_eps", "pi_eps", "actor_eps")},
                  "bcq": {"vae": (BATCH, 4), "next": (BATCH * 4, 4), "perturb": (BATCH, 4)}}
        out = {k: torch.randn(s, generator=gen) for k, s in shapes[variant].items()}
        if variant == "cql":
            out["rand"] = torch.rand((4, BATCH, AC_DIM), generator=gen) * 2 - 1
        return out

    port.train_on_batch(batches[0], 0, draws=draws())
    path = str(tmp_path / f"{variant}.ckpt")
    cfg = rl_config(config_factory, algo_name, over)
    save_checkpoint(path, port, cfg, shape_meta={"all_shapes": OBS_SHAPES, "ac_dim": AC_DIM})
    loaded, ckpt = policy_from_checkpoint(path, device="cpu")
    assert type(loaded) is type(port) and ckpt["algo_name"] == algo_name
    assert loaded.nets.state_dict().keys() == port.nets.state_dict().keys()
    for k, v in port.nets.state_dict().items():
        assert torch.equal(loaded.nets.state_dict()[k], v), k
    # the full state: a fresh algo takes the writer's next steps bit for bit,
    # TD3-BC's skipped actor update included
    buf = io.BytesIO()
    torch.save(port.serialize_full(), buf)
    fresh = algo_factory(algo_name, cfg, OBS_SHAPES, ac_dim=AC_DIM, device="cpu")
    buf.seek(0)
    fresh.deserialize_full(torch.load(buf, weights_only=True))
    assert fresh.step == port.step == 1
    for batch in batches[1:]:
        d = draws()
        want = port.train_on_batch(batch, 0, draws=d)["losses"]
        got = fresh.train_on_batch(batch, 0, draws=d)["losses"]
        assert all(torch.equal(got[k], want[k]) for k in want)
    for k, v in port.nets.state_dict().items():
        assert torch.equal(fresh.nets.state_dict()[k], v), k


# -- reference faults: template keys no class reads -------------------------------

UNREAD = {
    "bcq": {"n_step": 3, "infinite_horizon": True,
            "critic": {"use_huber": True, "max_gradient_norm": 1e-3, "value_bounds": [0.0, 1.0]},
            "actor": {"layer_dims": [8]}, "action_sampler": {"vae": {"kl_weight": 5.0}}},
    "iql": {"actor": {"net": {"gaussian": {"init_last_fc_weight": 0.5, "init_std": 3.0,
                                           "fixed_std": True}},
                      "max_gradient_norm": 1e-3},
            "critic": {"use_huber": True, "max_gradient_norm": 1e-3}},
    "td3_bc": {"critic": {"max_gradient_norm": 1e-3, "ensemble": {"weight": 0.5}}},
}


@pytest.mark.parametrize("variant", sorted(UNREAD))
def test_unread_template_keys_in_both_packages(variant):
    """Reference fault, mirrored (ROADMAP queue 3): BCQ reads none of
    ``n_step``, ``infinite_horizon``, ``critic.{use_huber,
    max_gradient_norm, value_bounds}``, ``actor.layer_dims`` (its
    perturbation is always 300 x 400) or ``action_sampler.vae.kl_weight``
    (its step weighs the KL by a constant 0.5); IQL none of
    ``actor.net.gaussian.*``, ``actor.max_gradient_norm`` or
    ``critic.{use_huber, max_gradient_norm}``; TD3-BC neither
    ``critic.max_gradient_norm`` nor ``critic.ensemble.weight`` (its target
    takes the ensemble's min). With them changed each package builds the
    same networks from the same seed and takes the same step, bit for bit."""
    plain_jax, plain = make_pair(variant)
    odd_jax, odd = make_pair(variant, UNREAD[variant])
    raw = rl_batches(1, seed=12)[0]
    for a, b in ((plain_jax, odd_jax), (plain, odd)):
        pa, pb = a.process_batch_for_training(raw), b.process_batch_for_training(raw)
        for k in ("actions", "rewards", "dones"):
            np.testing.assert_array_equal(pa[k], pb[k])
    draws = step_draws(plain_jax)
    want = plain_jax.train_on_batch(plain_jax.process_batch_for_training(raw), 0)["losses"]
    got = odd_jax.train_on_batch(odd_jax.process_batch_for_training(raw), 0)["losses"]
    assert all(float(got[k]) == float(want[k]) for k in want)
    for x, y in zip(jax.tree.leaves(plain_jax.state), jax.tree.leaves(odd_jax.state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    want = plain.train_on_batch(plain.process_batch_for_training(raw), 0, draws=draws)["losses"]
    got = odd.train_on_batch(odd.process_batch_for_training(raw), 0, draws=draws)["losses"]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert plain.nets.state_dict().keys() == odd.nets.state_dict().keys()
    for k, v in plain.nets.state_dict().items():
        assert torch.equal(odd.nets.state_dict()[k], v), k
