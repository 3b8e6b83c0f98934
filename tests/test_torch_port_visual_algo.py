"""Port parity of an ICL policy with an image observation: one 24 x 24 rgb
camera through ``VisualCoreLanguageConditioned`` (FiLM ResNet-18 on
``lang_emb``, SpatialSoftmax, a crop randomizer) beside ``lang_emb`` and a
low-dim key, the loss-based LipVQ codebook. The JAX algo and the port are
built once from bridged identical weights (BatchNorm statistics moved off
their init in both) and held on the eval forward, ``get_action``, the
rollout policy and one and three fp32 train steps with dropout 0.

The crop takes the full frame (its identity setting: every random offset
is 0), so the two packages' random streams play no part in training; the
eval forward crops the center either way. Tolerances as for the low-dim
flagship (``test_torch_port_train.py``): losses and the gradient norm to
rtol 1e-5, parameters and buffers to atol 2e-5 + rtol 1e-5. Measured worst
cases over three steps of either codebook: losses 4.5e-7 relative, state
3.3e-6 absolute (a BatchNorm ``var`` near 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models.tokenizers.lipvq import LipVQVAE as JaxLipVQVAE
from lipvq_tpu.utils import obs_utils as jax_obs_utils
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import obs_utils
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

CAM = "robot0_agentview_left_image"
OBS_SHAPES = {"robot0_eef_pos": [3], "lang_emb": [768], CAM: [24, 24, 3]}
AC_DIM, T, CODES, BATCH = 12, 10, 16, 4
STEPS = 2 * T - 1
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5


def image_config(factory, ema: bool, crop: int = 24):
    cfg = factory("icl", {
        "train": {"max_grad_norm": 100.0, "seed": 1, "batch_size": BATCH},
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {"initial": 1e-3, "scheduler_type": "constant_with_warmup"},
                "regularization": {"L2": 0.01}}},
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True, "pred_future_acs": True,
                "causal": False, "embed_dim": 64, "num_layers": 1, "num_heads": 4,
                "vq_vae_enabled": True, "ln_act_enabled": False, "compute_dtype": "float32",
                "emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0,
            },
            "vq": {"num_codes": CODES, "ema_codebook": ema},
        },
        "observation": {
            "modalities": {"obs": {"low_dim": ["robot0_eef_pos", "lang_emb"], "rgb": [CAM]}},
            "encoder": {"rgb": {
                "core_class": "VisualCoreLanguageConditioned",
                "core_kwargs": {"feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
                                "pool_kwargs": {"num_kp": 8}},
                "obs_randomizer_class": "CropRandomizer",
                "obs_randomizer_kwargs": {"crop_height": crop, "crop_width": crop,
                                          "num_crops": 1}}},
        },
    })
    with cfg.unlocked():
        cfg.algo.optim_params.policy.learning_rate.num_warmup_steps = 2
    return cfg


def image_items(rng, n: int) -> list[dict]:
    """Samples shaped like SequenceDataset items: uint8 frames, a per-demo
    language embedding, 12-d actions."""
    items = []
    for _ in range(n):
        lang = np.repeat(rng.standard_normal((1, 768), dtype=np.float32), STEPS, 0)
        items.append({"obs": {
            "robot0_eef_pos": rng.standard_normal((STEPS, 3), dtype=np.float32),
            "lang_emb": lang,
            CAM: rng.integers(0, 256, (STEPS, 24, 24, 3)).astype(np.uint8)},
            "actions": rng.uniform(-1, 1, (STEPS, AC_DIM)).astype(np.float32)})
    return items


def _set_modalities(cfg):
    jax_obs_utils.initialize_obs_utils_with_config(cfg)
    obs_utils.initialize_obs_utils_with_config(cfg)


def _moved_stats(extra_vars, rng):
    """BatchNorm statistics off their init (mean 0, var 1)."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (
            (0.1 * rng.standard_normal(v.shape)).astype(np.float32) if k == "mean"
            else rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tree.items()}

    return {**extra_vars, "batch_stats": walk(jax.tree.map(np.asarray,
                                                           extra_vars["batch_stats"]))}


def image_pair(ema: bool, crop: int = 24):
    """(JAX algo, port algo on the CPU) with identical weights, BatchNorm
    statistics and codebook (the latents of random actions: at init every
    latent would take one code)."""
    rng = np.random.default_rng(7)
    _set_modalities(image_config(jax_config_factory, ema, crop))
    jax_algo = jax_algo_factory("icl", image_config(jax_config_factory, ema, crop),
                                OBS_SHAPES, ac_dim=AC_DIM)
    params = jax_algo.state.params
    tok = params["net"]["encoder"]["action_network"]
    latent = tok["quantizer"]["codebook"].shape[1]
    codebook = JaxLipVQVAE(feature_dim=AC_DIM, latent_dim=latent, num_codes=CODES).apply(
        {"params": tok}, jnp.asarray(rng.uniform(-1, 1, (CODES, AC_DIM)).astype(np.float32)),
        method=JaxLipVQVAE.encode)
    params = {**params, "net": {**params["net"], "encoder": {
        **params["net"]["encoder"], "action_network": {
            **tok, "quantizer": {"codebook": codebook}}}}}
    extra = _moved_stats(jax_algo.state.extra_vars, rng)
    jax_algo.state = jax_algo.state._replace(
        params=params, opt_state=jax_algo.tx.init(params),
        extra_vars=jax.tree.map(jnp.asarray, extra))
    port = algo_factory("icl", image_config(config_factory, ema, crop), OBS_SHAPES,
                        ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, extra))
    return jax_algo, port


def jax_state_dict(jax_algo, port):
    state = state_dict_from_jax_params(jax.tree.map(np.asarray, jax_algo.state.params),
                                       port.nets)
    for tree in jax_algo.state.extra_vars.values():
        state.update(state_dict_from_jax_params(jax.tree.map(np.asarray, tree)))
    return state


def jax_dists(jax_algo, obs, ctx_obs, ctx_act, low_noise_eval=False):
    put = jax_algo._put_infer
    dists, aux, _ = jax_algo._apply_forward(
        jax_algo.state.params, jax_algo.state.extra_vars, put(obs), put(ctx_obs),
        put(ctx_act), None, jax.random.PRNGKey(0), train=False,
        low_noise_eval=low_noise_eval)
    return [np.asarray(a) for a in dists], float(aux)


@pytest.fixture(scope="module")
def pair():
    return image_pair(ema=False)


@pytest.fixture(scope="module")
def batch(pair):
    """A processed batch in each package's form: the JAX package's frames
    float /255, the port's uint8."""
    jax_algo, port = pair
    raw = stack_collate(image_items(np.random.default_rng(3), BATCH))
    return raw, jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)


def test_process_batch_keeps_frames_uint8(pair, batch):
    """The port's batch keeps the frames uint8; the algo's copy to the device
    gives JAX's float frames bit for bit; every other leaf is equal."""
    _, port = pair
    _, want, got = batch
    assert got["obs"][CAM].dtype == np.uint8 and want["obs"][CAM].dtype == np.float32
    on_device = port._put_batch(got)["obs"][CAM].numpy()
    np.testing.assert_array_equal(on_device.view(np.int32), want["obs"][CAM].view(np.int32))
    for k in ("robot0_eef_pos", "lang_emb"):
        np.testing.assert_array_equal(got["obs"][k], want["obs"][k])
    np.testing.assert_array_equal(got["actions"], want["actions"])


def test_eval_forward_matches_jax(pair, batch):
    """Running statistics, the center crop: GMM parameters to rtol 1e-4 /
    atol 1e-5, the VQ loss to 1e-5."""
    jax_algo, port = pair
    _, want_b, got_b = batch
    mid = BATCH // 2
    args = ({k: v[mid:] for k, v in want_b["obs"].items()},
            {k: v[:mid] for k, v in want_b["obs"].items()}, want_b["actions"][:mid])
    want, want_aux = jax_dists(jax_algo, *args)
    with torch.inference_mode():
        put = port._put_infer
        dists, aux = port.nets.forward_train(
            put({k: v[mid:] for k, v in got_b["obs"].items()}),
            put({k: v[:mid] for k, v in got_b["obs"].items()}),
            put(got_b["actions"][:mid]), low_noise_eval=False)
    for name, g, w in zip(("means", "scales", "logits"), dists, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)
    assert abs(float(aux) - want_aux) <= 1e-5


def _near_a_mode(actions, means, tol=1e-3):
    """Every action row lies within ``tol`` of one of its row's mode means
    (low-noise eval samples with sigma = 1e-4)."""
    dist = np.abs(actions[:, None, :] - means).max(-1).min(-1)
    assert dist.max() <= tol, dist


def test_get_action_and_rollout_policy_match_jax(pair, batch):
    """get_action, the rollout policy's batched path (frames as the caller
    gives them, the context tiled to 3 envs) and its single-env path (raw
    uint8 frames, processed on the host) each sample a mode mean of JAX's
    low-noise forward on the same inputs."""
    jax_algo, port = pair
    _, want_b, got_b = batch
    obs = {k: v[:2] for k, v in want_b["obs"].items()}
    ctx_jax = {"obs": {k: v[2:] for k, v in want_b["obs"].items()},
               "actions": want_b["actions"][2:]}
    ctx_port = {"obs": {k: v[2:] for k, v in got_b["obs"].items()},
                "actions": got_b["actions"][2:]}
    (means, _, _), _ = jax_dists(jax_algo, obs, ctx_jax["obs"], ctx_jax["actions"],
                                 low_noise_eval=True)
    acts = port.get_action(obs, ctx_port)
    assert acts.shape == (2, AC_DIM)
    _near_a_mode(acts, means[:, 0])

    n = 3
    context = {"obs": {k: v[2:3] for k, v in got_b["obs"].items()},
               "actions": got_b["actions"][2:3]}
    context_jax = {k: np.repeat(v[2:3], n, 0) for k, v in want_b["obs"].items()}
    query = {k: np.repeat(v[:1], n, 0) for k, v in want_b["obs"].items()}
    (means, _, _), _ = jax_dists(jax_algo, query, context_jax,
                                 np.repeat(want_b["actions"][2:3], n, 0), low_noise_eval=True)
    policy = ICLRolloutPolicy(port)
    batched = policy.batched(query, context)
    assert batched.shape == (n, AC_DIM)
    _near_a_mode(batched, means[:, 0])
    raw, _, _ = batch
    single = policy({k: v[0, :T] for k, v in raw["obs"].items()}, context)
    _near_a_mode(single[None], means[:1, 0])


@pytest.fixture(scope="module")
def trained(pair):
    """Three train steps in both packages on the same batches; the metrics
    and the states after steps 1 and 3, then one validation step."""
    jax_algo, port = pair
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    rng = np.random.default_rng(11)
    snaps = {}
    for step in (1, 2, 3):
        raw = stack_collate(image_items(rng, BATCH))
        want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
        got = port.train_on_batch(port.process_batch_for_training(raw), 0)
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want["losses"].items()},
                           {k: float(v) for k, v in got["losses"].items()},
                           jax_state_dict(jax_algo, port),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    val = stack_collate(image_items(rng, BATCH))
    before = {k: v.clone() for k, v in port.nets.state_dict().items()}
    want = jax_algo.train_on_batch(jax_algo.process_batch_for_training(val), 0, validate=True)
    got = port.train_on_batch(port.process_batch_for_training(val), 0, validate=True)
    validation = ({k: float(v) for k, v in want["losses"].items()},
                  {k: float(v) for k, v in got["losses"].items()}, before,
                  port.nets.state_dict())
    return start, snaps, validation


def hold_state(got_sd, want_sd):
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)


@pytest.mark.parametrize("step", [1, 3])
def test_train_steps_match_jax(trained, step):
    """Metrics, every parameter, the BatchNorm statistics and the VQ buffers."""
    start, snaps, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    hold_state(got_sd, want_sd)
    moved = {k for k in want_sd if not torch.equal(got_sd[k], start[k])}
    core = "net.encoder.group_encoder.enc_obs.core_" + CAM
    # two encoder calls a step: the statistics move, the conv weights from
    # the policy's first nonzero lr (warmup 2) on
    assert f"{core}.backbone.layer4_1.bn2.var" in moved
    assert (f"{core}.backbone.stem_conv.weight" in moved) == (step == 3)
    assert (f"{core}.backbone.film2.TorchLinear_0.weight" in moved) == (step == 3)


def test_validation_changes_nothing(trained):
    """Validation normalizes by the running statistics and moves none."""
    _, _, (want_m, got_m, before, after) = trained
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
