"""Port parity of the closed loop: the synthetic env, the frame stack and the
vector env give identical observations for one seed and action sequence;
the env factory raises for the unported adapters; the rollout engines give
the JAX package's results with a deterministic policy; and teacher-forced
rollout actions of the ICL policy match JAX's on the same observation
stream.

For the teacher-forced actions both algos sample deterministically: the
GMM head's action is replaced by the mixture mean in both packages (the two
draw their random samples from other generators), so the action is a
function of the forward alone. The forward runs in fp32 from bridged
weights, within the forward's tolerance (rtol 1e-3 / atol 1e-4 as in the
JAX-to-port bridge)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.algo.rollout_policy import ICLRolloutPolicy as JaxICLRolloutPolicy
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.envs import rollout as jax_rollout
from lipvq_tpu.envs.env_synthetic import SyntheticKitchenEnv as JaxSyntheticKitchenEnv
from lipvq_tpu.envs.vector_env import VectorEnv as JaxVectorEnv
from lipvq_tpu.envs.vector_env import batched_icl_rollout as jax_batched_icl_rollout
from lipvq_tpu.envs.wrappers import FrameStackWrapper as JaxFrameStackWrapper
from lipvq_tpu.models.distributions import gmm_mean as jax_gmm_mean
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder
import lipvq_tpu_torch.algo.icl as port_icl
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.envs import rollout
from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata
from lipvq_tpu_torch.envs.env_synthetic import SyntheticKitchenEnv
from lipvq_tpu_torch.envs.vector_env import VectorEnv, batched_icl_rollout
from lipvq_tpu_torch.envs.wrappers import FrameStackWrapper
from lipvq_tpu_torch.models.distributions import gmm_mean
from lipvq_tpu_torch.utils.jax_weights import load_jax_params
from lipvq_tpu_torch.utils.lang_utils import LangEncoder

torch.set_num_threads(1)

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM, T, CODES = 12, 10, 32
RTOL, ATOL = 1e-3, 1e-4


def _actions(seed, n, dim=AC_DIM):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, dim)).astype(np.float32)


def _assert_obs_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("frame_stack", [None, 1, 4])
def test_synthetic_env_matches_jax(frame_stack):
    got, want = SyntheticKitchenEnv(seed=3, horizon=7), JaxSyntheticKitchenEnv(seed=3, horizon=7)
    if frame_stack:
        got, want = FrameStackWrapper(got, frame_stack), JaxFrameStackWrapper(want, frame_stack)
    for episode in range(2):
        _assert_obs_equal(got.reset(), want.reset())
        for a in _actions(episode, 8):
            g, w = got.step(a), want.step(a)
            _assert_obs_equal(g[0], w[0])
            assert g[1:] == w[1:]
        assert got.ep_lang_str == want.ep_lang_str
    state = {"pos": np.full(3, 0.2, np.float32), "goal": np.full(3, 0.25, np.float32)}
    _assert_obs_equal(got.reset_to(state), want.reset_to(state))
    flat = {"states": np.arange(6, dtype=np.float32) / 10}
    _assert_obs_equal(got.reset_to(flat), want.reset_to(flat))
    assert got.is_success() == want.is_success()
    np.testing.assert_array_equal(got.render(), want.render())
    assert got.serialize() == want.serialize() and got.name == want.name
    assert got.action_dimension == want.action_dimension


def test_vector_env_matches_jax():
    def fns(cls):
        return [lambda i=i: cls(seed=10 + i) for i in range(3)]

    keys = ["robot0_eef_pos", "object"]
    got = VectorEnv(fns(SyntheticKitchenEnv), frame_stack=5, obs_keys=keys)
    want = JaxVectorEnv(fns(JaxSyntheticKitchenEnv), frame_stack=5, obs_keys=keys)
    _assert_obs_equal(got.reset(), want.reset())
    assert got.ep_lang_strs == want.ep_lang_strs and got.num_envs == 3
    for t in range(4):
        acts = _actions(t, 3)
        g, w = got.step(acts), want.step(acts)
        _assert_obs_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
        assert g[3] == w[3]
    assert got.is_success() == want.is_success()


@pytest.mark.parametrize("env_meta,item", [
    ({"env_name": "NutAssemblySquare", "type": 1}, "item 15"),
    ({"env_name": "Lift", "type": 1}, "item 15"),
    ({"env_name": "Hopper-v4", "type": 2}, "item 15"),
    ({"env_name": "Momart", "type": 3}, "item 15"),
])
def test_unported_envs_raise(env_meta, item):
    with pytest.raises(NotImplementedError, match=item):
        create_env_from_metadata(env_meta)


def test_env_factory_synthetic_and_unknown():
    env = create_env_from_metadata({"env_name": "SyntheticKitchen", "type": 1,
                                    "env_kwargs": {"seed": 4}}, horizon=5)
    _assert_obs_equal(env.reset(), JaxSyntheticKitchenEnv(seed=4).reset())
    assert isinstance(create_env_from_metadata({"env_name": "X", "type": 99}),
                      SyntheticKitchenEnv)
    with pytest.raises(ValueError, match="No environment adapter"):
        create_env_from_metadata({"env_name": "X", "type": 7})


class _Scripted:
    """A deterministic numpy policy: the same actions in both packages."""

    def __init__(self):
        self.t = 0

    def start_episode(self, lang=None):
        self.t = 0

    def __call__(self, ob, goal=None):
        self.t += 1
        return np.concatenate([-ob["object"][-1, 3:6] if ob["object"].ndim == 2
                               else -ob["object"][3:6], np.full(9, 0.1 * self.t)])


@pytest.mark.parametrize("terminate_on_success", [False, True])
def test_rollout_engines_match_jax(terminate_on_success):
    def run(mod, env_cls):
        envs = {"SyntheticKitchen": env_cls(seed=2, horizon=30)}
        return mod.rollout_with_stats(_Scripted(), envs, horizon=12, num_episodes=3,
                                      terminate_on_success=terminate_on_success,
                                      frame_stack=2)

    (got, got_videos), (want, want_videos) = (run(rollout, SyntheticKitchenEnv),
                                              run(jax_rollout, JaxSyntheticKitchenEnv))
    assert list(got) == list(want) and got_videos == want_videos == {}
    for name in want:
        assert set(got[name]) == set(want[name])
        for k in want[name]:
            if not k.startswith("Time_"):
                assert got[name][k] == want[name][k], k
    single = rollout.run_rollout(_Scripted(), FrameStackWrapper(SyntheticKitchenEnv(seed=1), 2),
                                 horizon=6)
    assert single == jax_rollout.run_rollout(
        _Scripted(), JaxFrameStackWrapper(JaxSyntheticKitchenEnv(seed=1), 2), horizon=6)


def _config(factory):
    cfg = factory("icl", {
        "algo": {
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                "causal": False, "embed_dim": 64, "num_layers": 2, "num_heads": 4,
                "vq_vae_enabled": True, "ln_act_enabled": False, "compute_dtype": "float32",
            },
            "vq": {"num_codes": CODES},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


@pytest.fixture(scope="module")
def policies():
    """(JAX ICLRolloutPolicy, port ICLRolloutPolicy, context batch) on the
    same fp32 weights, both acting with the GMM's mixture mean."""
    rng = np.random.default_rng(0)
    jax_algo = jax_algo_factory("icl", _config(jax_config_factory), OBS_SHAPES, ac_dim=AC_DIM)
    params = jax.tree.map(np.asarray, jax_algo.state.params)
    tok = params["net"]["encoder"]["action_network"]
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=tok["quantizer"]["codebook"].shape[1],
                           num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(rng.uniform(-1, 1, (CODES, AC_DIM)).astype(np.float32)),
        method=JaxLipVQVAE.encode)
    tok["quantizer"]["codebook"] = np.asarray(codebook)
    jax_algo.state = jax_algo.state._replace(params=jax.tree.map(jnp.asarray, params))
    jax_algo._action_from_head = lambda dists, key: jax_gmm_mean(dists)
    port = algo_factory("icl", _config(config_factory), OBS_SHAPES, ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, params)
    stats = {"actions": {"scale": np.linspace(0.5, 2, AC_DIM).astype(np.float32),
                         "offset": np.linspace(-0.3, 0.3, AC_DIM).astype(np.float32)}}
    obs_stats = {k: {"offset": np.full(s, 0.1, np.float32), "scale": np.full(s, 0.9, np.float32)}
                 for k, s in OBS_SHAPES.items() if k != "lang_emb"}
    context = {"obs": {k: rng.standard_normal((1, T, *s), dtype=np.float32)
                       for k, s in OBS_SHAPES.items()},
               "actions": rng.uniform(-1, 1, (1, T, AC_DIM)).astype(np.float32)}
    want = JaxICLRolloutPolicy(jax_algo, obs_normalization_stats=obs_stats,
                               action_normalization_stats=stats, lang_encoder=JaxLangEncoder())
    got = ICLRolloutPolicy(port, obs_normalization_stats=obs_stats,
                           action_normalization_stats=stats, lang_encoder=LangEncoder())
    return want, got, context


class _Recorder:
    """Wraps the JAX rollout policy and records what it was asked."""

    def __init__(self, policy):
        self.policy, self.calls = policy, []

    def start_episode(self, lang=None):
        self.calls.append(("start", lang, None))
        self.policy.start_episode(lang=lang)

    def __call__(self, ob, context_batch, goal=None):
        ac = self.policy(ob, context_batch, goal=goal)
        self.calls.append(("single", ob, ac))
        return ac

    def batched(self, obs, context_batch):
        acs = self.policy.batched(obs, context_batch)
        self.calls.append(("batched", obs, acs))
        return acs


def _replay(calls, port_policy, context, monkeypatch):
    """Feed the JAX rollout's observation stream to the port's policy."""
    monkeypatch.setattr(port_icl, "gmm_sample", lambda dists, generator: gmm_mean(dists))
    n = 0
    for kind, ob, want in calls:
        if kind == "start":
            port_policy.start_episode(lang=ob)
            continue
        got = port_policy(ob, context) if kind == "single" else port_policy.batched(ob, context)
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        n += 1
    return n


def test_teacher_forced_rollout_actions_match_jax(policies, monkeypatch):
    want, got, context = policies
    rec = _Recorder(want)
    env = JaxFrameStackWrapper(JaxSyntheticKitchenEnv(seed=5), T)
    for _ in range(2):
        jax_rollout.icl_run_rollout(rec, env, context, horizon=6)
    assert _replay(rec.calls, got, context, monkeypatch) == 12


def test_teacher_forced_batched_rollout_actions_match_jax(policies, monkeypatch):
    want, got, context = policies
    rec = _Recorder(want)
    vec = JaxVectorEnv([lambda i=i: JaxSyntheticKitchenEnv(seed=20 + i) for i in range(3)],
                       frame_stack=T, obs_keys=[k for k in OBS_SHAPES if k != "lang_emb"])
    jax_batched_icl_rollout(rec, vec, context, horizon=5, terminate_on_success=False)
    assert _replay(rec.calls, got, context, monkeypatch) == 5


@pytest.mark.parametrize("batched", [False, True])
def test_port_rollout_with_stats_runs(policies, batched, monkeypatch):
    """The port's engines end to end with the port's own policy: the keys
    and episode counts of the JAX engines, finite stats."""
    _, got, context = policies
    monkeypatch.setattr(port_icl, "gmm_sample", lambda dists, generator: gmm_mean(dists))
    if batched:
        vec = VectorEnv([lambda i=i: SyntheticKitchenEnv(seed=i) for i in range(2)],
                        frame_stack=T, obs_keys=[k for k in OBS_SHAPES if k != "lang_emb"])
        logs, videos = rollout.icl_batched_rollout_with_stats(got, {"Synthetic": vec}, context,
                                                              horizon=4, num_episodes=3)
        assert logs["Synthetic"]["Num_Episodes"] == 4.0
        assert batched_icl_rollout(got, vec, context, horizon=2)["Horizon"] == 2.0
    else:
        logs, videos = rollout.icl_rollout_with_stats(
            got, {"Synthetic": SyntheticKitchenEnv(seed=0)}, context, horizon=4,
            num_episodes=2, frame_stack=T)
        assert logs["Synthetic"]["Horizon"] == 4.0
    assert videos == {}
    assert {"Return", "Horizon", "Success_Rate", "Time_Rollouts"} <= set(logs["Synthetic"])
    assert all(np.isfinite(v) for v in logs["Synthetic"].values())
