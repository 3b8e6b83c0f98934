"""The port's kitchen end to end, the twin of ``tests/test_kitchen_e2e.py``:
the flagship trains on a kitchen export through the port's ``train.main`` on
the CPU with closed-loop rollouts in the port's kitchen, and its checkpoint
reloads; without ``mujoco`` the script says "Rollout disabled" and trains
on. Then the policy against the JAX package's in JAX's kitchen: JAX's policy
drives JAX's OpenDrawer for 20 steps, and the port's policy, on the weights
carried across by ``utils/jax_weights.py``, fed the same observation stream
and the same GMM draws (uniforms for the Gumbel-max mode, normals for the
component), must give JAX's actions within the fp32 tolerance of
``tests/test_torch_port_train.py`` (rtol 1e-5, atol 2e-5). The learning
floor's twin (``tests/test_learning_floor.py``) is marked slow, as JAX's is.
"""

import glob
import json
import os

import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import torch  # noqa: E402

from lipvq_tpu_torch.config import config_factory  # noqa: E402
from lipvq_tpu_torch.data.export import Export  # noqa: E402
from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata  # noqa: E402
from lipvq_tpu_torch.scripts import train as port_train  # noqa: E402
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen", "OpenDrawer")
# examples/kitchen_multitask_suite.py's observation keys
OBS_KEYS = ["robot0_base_pos", "robot0_base_quat", "robot0_eef_pos", "robot0_eef_quat",
            "robot0_gripper_qpos", "robot0_base_to_eef_pos", "fixture_state", "obj_state",
            "lang_emb"]
RTOL, ATOL = 1e-5, 2e-5  # tests/test_torch_port_train.py: LOSS_RTOL, PARAM_ATOL
T, AC_DIM, CODES = 10, 12, 32


def _config_dict(output_dir: str, rollout: dict) -> dict:
    d = icl_test_config_overrides()
    d["algo_name"] = "icl"
    d["train"].update({"data": CORPUS, "output_dir": output_dir})
    d["experiment"]["rollout"] = rollout
    d["experiment"]["render_video"] = False
    d["observation"]["modalities"]["obs"]["low_dim"] = list(OBS_KEYS)
    return d


def _train_main(tmp_path, rollout: dict) -> str:
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_config_dict(str(tmp_path / "out"), rollout)))
    ckpt_dir = port_train.main(["--config", str(path), "--device", "cpu"])
    assert ckpt_dir is not None
    return ckpt_dir


def test_train_main_with_kitchen_rollouts_and_reload(tmp_path, capsys):
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint

    ckpt_dir = _train_main(tmp_path, {"enabled": True, "n": 1, "horizon": 20, "rate": 1})
    out = capsys.readouterr().out
    assert "Rollout Epoch 1 [OpenDrawer]" in out and "Rollout disabled" not in out
    with open(os.path.join(os.path.dirname(ckpt_dir), "logs", "scalars.json")) as f:
        logs = json.load(f)
    assert logs["Rollout/Horizon/OpenDrawer"] == [20.0]
    assert all(np.isfinite(v).all() for v in logs.values())

    ckpts = glob.glob(os.path.join(ckpt_dir, "*.ckpt"))
    assert ckpts
    model, ckpt = policy_from_checkpoint(ckpts[0], device="cpu")
    t = model.context_length
    obs = {k: np.zeros((1, t) + tuple(s), np.float32) for k, s in model.obs_shapes.items()}
    a = model.get_action(obs, {"obs": obs, "actions": np.zeros((1, t, model.ac_dim),
                                                                np.float32)})
    assert a.shape == (1, model.ac_dim) and np.isfinite(a).all()
    env_meta = ckpt["env_metadata"]
    env_meta = json.loads(env_meta) if isinstance(env_meta, str) else env_meta
    assert env_meta["env_name"] == "OpenDrawer"
    env = create_env_from_metadata(env_meta)
    assert type(env).__name__ == "EnvKitchen" and env.reset()["fixture_state"].shape == (16,)


def test_train_batched_rollout_on_kitchen(tmp_path, capsys):
    """rollout.batched drives the VectorEnv engine through the script: 2
    waves of 2 kitchens."""
    _train_main(tmp_path, {"enabled": True, "n": 4, "horizon": 10, "rate": 1,
                           "batched": True, "num_batch_envs": 2})
    assert '"Num_Episodes": 4.0' in capsys.readouterr().out


def test_rollout_disabled_without_mujoco(tmp_path, capsys, monkeypatch):
    """Without ``mujoco`` the kitchen raises ``ModuleNotFoundError``; the
    script prints "Rollout disabled" naming it and trains on, as the JAX
    script does for any error (``lipvq_tpu/scripts/train.py:193-194``)."""
    import lipvq_tpu_torch.robocasa.sim.kitchen as kitchen

    monkeypatch.setattr(kitchen, "mujoco", None)
    ckpt_dir = _train_main(tmp_path, {"enabled": True, "n": 1, "horizon": 5, "rate": 1})
    out = capsys.readouterr().out
    assert "Rollout disabled (no env adapter): ModuleNotFoundError" in out
    assert "'mujoco'" in out and "Rollout Epoch" not in out
    assert glob.glob(os.path.join(ckpt_dir, "*.ckpt"))


def test_rollout_runs_on_where_no_video_writer_opens(tmp_path, monkeypatch):
    """Where ``imageio`` cannot open an mp4 writer (no ffmpeg) the episodes
    run without a video, in both packages (the script's ``render_video``
    defaults to true)."""
    import imageio

    from lipvq_tpu.envs import rollout as jax_rollout

    from lipvq_tpu_torch.envs import rollout

    def no_backend(*args, **kwargs):
        raise ValueError("Could not find a backend to open the mp4 file")

    monkeypatch.setattr(imageio, "get_writer", no_backend)

    class Still:
        def start_episode(self, lang=None):
            pass

        def __call__(self, ob, context_batch, goal=None):
            return np.zeros(AC_DIM)

    results = []
    for engine, env in ((rollout, create_env_from_metadata(
            {"env_name": "OpenDrawer", "type": 1, "env_kwargs": {"seed": 2}})),
            (jax_rollout, None)):
        if env is None:
            from lipvq_tpu.envs.env_kitchen import EnvKitchen as JaxEnvKitchen

            env = JaxEnvKitchen("OpenDrawer", seed=2)
        logs, videos = engine.icl_rollout_with_stats(
            Still(), {"OpenDrawer": env}, {}, horizon=3, num_episodes=1,
            video_dir=str(tmp_path), epoch=1, frame_stack=T)
        assert videos == {}
        results.append({k: v for k, v in logs["OpenDrawer"].items() if k != "Time_Rollouts"})
    assert results[0] == results[1] and results[0]["Horizon"] == 3.0


def test_kitchen_convergence_twin_short_run(tmp_path):
    """The twin's wiring on the CPU, shortened: collection, the script with
    kitchen rollouts, the curve read back from its scalars."""
    from lipvq_tpu_torch.examples import kitchen_convergence_demo

    out = kitchen_convergence_demo.run(
        device="cpu", out=str(tmp_path / "run"), n_demos=2, epochs=1, layout=0,
        steps_per_epoch=2, rollout_episodes=1, horizon=5, log=lambda *_: None)
    assert out["collect"]["demos"] == 2
    assert [(c["epoch"], c["horizon"]) for c in out["curve"]] == [(1, 5.0)]
    assert 0.0 <= out["curve"][0]["success"] <= 1.0
    assert Export(str(tmp_path / "run_demos")).demos == ["demo_0", "demo_1"]


def _policies():
    """(JAX algo, JAX ICLRolloutPolicy, port algo, port ICLRolloutPolicy,
    context) on the same fp32 weights at the corpus's shapes; the JAX head
    samples with Gumbel-max draws derived from its key, recorded per call."""
    import jax
    import jax.numpy as jnp

    import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
    from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
    from lipvq_tpu.algo.rollout_policy import ICLRolloutPolicy as JaxICLRolloutPolicy
    from lipvq_tpu.config import config_factory as jax_config_factory
    from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
    from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.utils.jax_weights import load_jax_params
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    ex = Export(CORPUS)
    shapes = {k: list(ex.shape("demo_0", f"obs/{k}")[1:]) for k in OBS_KEYS if k != "lang_emb"}
    shapes["lang_emb"] = [768]

    def config(factory):
        cfg = factory("icl", {"algo": {
            "gmm": {"enabled": True},
            "transformer": {"enabled": True, "supervise_all_steps": True,
                            "pred_future_acs": True, "causal": False, "embed_dim": 64,
                            "num_layers": 2, "num_heads": 4, "vq_vae_enabled": True,
                            "ln_act_enabled": False, "compute_dtype": "float32"},
            "vq": {"num_codes": CODES}}})
        with cfg.unlocked():
            cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
        return cfg

    rng = np.random.default_rng(0)
    jax_algo = jax_algo_factory("icl", config(jax_config_factory), shapes, ac_dim=AC_DIM)
    params = jax.tree.map(np.asarray, jax_algo.state.params)
    tok = params["net"]["encoder"]["action_network"]
    acts = np.concatenate([ex.load(d, "actions") for d in ex.demos])
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=tok["quantizer"]["codebook"].shape[1],
                           num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(acts[rng.permutation(len(acts))[:CODES]]),
        method=JaxLipVQVAE.encode)
    tok["quantizer"]["codebook"] = np.asarray(codebook)
    jax_algo.state = jax_algo.state._replace(params=jax.tree.map(jnp.asarray, params))
    shapes_seen = {}

    def jax_head(dists, key):
        shapes_seen["logits"], shapes_seen["means"] = dists.logits.shape, dists.means.shape
        u, eps = jax_draws(key, dists.logits.shape, dists.means.shape)
        u = jnp.maximum(u, jnp.finfo(u.dtype).tiny)
        mode = jnp.argmax(dists.logits - jnp.log(-jnp.log(u)), axis=-1)
        pick = mode[..., None, None]
        mean = jnp.take_along_axis(dists.means, pick, axis=-2)[..., 0, :]
        scale = jnp.take_along_axis(dists.scales, pick, axis=-2)[..., 0, :]
        return mean + scale * eps

    def jax_draws(key, logits_shape, means_shape):
        ku, ke = jax.random.split(key)
        return (jax.random.uniform(ku, logits_shape, jnp.float32),
                jax.random.normal(ke, tuple(means_shape[:-2]) + tuple(means_shape[-1:]),
                                  jnp.float32))

    jax_algo._action_from_head = jax_head
    port = algo_factory("icl", config(config_factory), shapes, ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, params)
    lo, hi = acts.min(0), acts.max(0)
    stats = {"actions": {"scale": ((hi - lo) / 2 + 1e-3).astype(np.float32),
                         "offset": ((hi + lo) / 2).astype(np.float32)}}
    demo = ex.demos[1]
    context = {"obs": {k: ex.load(demo, f"obs/{k}")[None, :T] for k in OBS_KEYS
                       if k != "lang_emb"},
               "actions": ((ex.load(demo, "actions")[None, :T] - stats["actions"]["offset"])
                           / stats["actions"]["scale"]).astype(np.float32)}
    context["obs"]["lang_emb"] = np.tile(
        np.asarray(LangEncoder().get_lang_emb(
            json.loads(ex.demo_attrs(demo)["ep_meta"])["lang"]), np.float32)[None, None],
        (1, T, 1))
    want = JaxICLRolloutPolicy(jax_algo, action_normalization_stats=stats,
                               lang_encoder=JaxLangEncoder())
    got = ICLRolloutPolicy(port, action_normalization_stats=stats, lang_encoder=LangEncoder())
    return jax_algo, want, port, got, context, jax_draws, shapes_seen


def test_policy_matches_jax_in_jax_kitchen(monkeypatch):
    import jax

    from lipvq_tpu.envs import rollout as jax_rollout
    from lipvq_tpu.envs.env_kitchen import EnvKitchen as JaxEnvKitchen
    from lipvq_tpu.envs.wrappers import FrameStackWrapper as JaxFrameStackWrapper

    from lipvq_tpu_torch.models.distributions import gmm_sample_from_draws

    jax_algo, want, port, got, context, jax_draws, shapes_seen = _policies()
    calls = []

    class Recorder:
        def start_episode(self, lang=None):
            calls.append(("start", lang, None, None))
            want.start_episode(lang=lang)

        def __call__(self, ob, context_batch, goal=None):
            key = jax.random.split(jax_algo.state.rng)[1]  # get_action's key
            ac = want(ob, context_batch, goal=goal)
            calls.append(("act", {k: np.array(v) for k, v in ob.items()}, key, ac))
            return ac

    env = JaxFrameStackWrapper(JaxEnvKitchen("OpenDrawer", seed=5), T)
    results = jax_rollout.icl_run_rollout(Recorder(), env, context, horizon=20)
    assert results["Horizon"] == 20
    queue = []

    def port_head(dists, draws=None):
        return gmm_sample_from_draws(dists, *queue.pop(0))

    monkeypatch.setattr(port, "_action_from_head", port_head)
    n, worst = 0, 0.0
    for kind, ob, key, ac in calls:
        if kind == "start":
            got.start_episode(lang=ob)
            continue
        u, eps = jax_draws(key, shapes_seen["logits"], shapes_seen["means"])
        queue.append((torch.from_numpy(np.array(u)), torch.from_numpy(np.array(eps))))
        action = got(ob, context)
        assert not queue
        assert action.shape == np.asarray(ac).shape
        np.testing.assert_allclose(action, ac, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(action - ac).max()))
        n += 1
    assert n == 20 and np.isfinite(worst)


@pytest.mark.slow
def test_icl_lipvq_learns_kitchen_demos(tmp_path):
    """The 3L / 128d flagship on a fixed-layout OpenDrawer corpus: the train
    NLL must fall by more than 2 nats and end below 5 within 150 steps
    (``tests/test_learning_floor.py``'s floor)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.scripts.collect_kitchen_suite import collect_task
    from lipvq_tpu_torch.utils import file_utils as FileUtils
    from lipvq_tpu_torch.utils import obs_utils as ObsUtils
    from lipvq_tpu_torch.utils import train_utils as TrainUtils
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    data = str(tmp_path / "demos")
    stats = collect_task("OpenDrawer", data, n_demos=8, max_steps=300, seed=3, layout_ids=0,
                         style_ids=0)
    assert stats["demos"] >= 6, stats
    d = icl_test_config_overrides()
    d["train"].update({"data": data, "num_epochs": 3, "batch_size": 24,
                       "output_dir": str(tmp_path / "run")})
    d["experiment"].update({"epoch_every_n_steps": 50, "rollout": {"enabled": False},
                            "save": {"enabled": False}, "validate": False})
    d["algo"]["transformer"].update({"embed_dim": 128, "num_layers": 3, "num_heads": 4})
    d["algo"]["optim_params"] = {"policy": {"learning_rate": {
        "initial": 1e-3, "scheduler_type": "none"}}}
    d["algo"]["vq"] = {"num_codes": 128}
    d["observation"]["modalities"]["obs"]["low_dim"] = [
        "robot0_base_pos", "robot0_base_quat", "robot0_eef_pos", "robot0_eef_quat",
        "robot0_gripper_qpos", "robot0_base_to_eef_pos", "object", "lang_emb"]
    cfg = config_factory("icl", d)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    shape_meta = FileUtils.get_shape_metadata_from_dataset(data, all_obs_keys=cfg.all_obs_keys)
    model = algo_factory("icl", cfg, shape_meta["all_shapes"], ac_dim=shape_meta["ac_dim"],
                         device="cpu")
    train_ds, _ = TrainUtils.load_data_for_training(
        cfg, obs_keys=shape_meta["all_obs_keys"], lang_encoder=LangEncoder(device="cpu"))
    loader, _, _ = TrainUtils.make_loaders(cfg, train_ds, None)
    losses = []
    for epoch in range(1, cfg.train.num_epochs + 1):
        log = TrainUtils.run_epoch(model, loader, epoch,
                                   num_steps=cfg.experiment.epoch_every_n_steps)
        model.on_epoch_end(epoch)
        losses.append(float(log["Loss"]))
    initial, final = losses[0], losses[-1]
    assert np.isfinite(losses).all(), losses
    assert final < initial - 2.0, f"no learning: {losses}"
    assert final < 5.0, f"final NLL too high: {losses}"
