"""Port parity of Diffusion Policy: the DDPM / DDIM schedulers, the
conditional UNet-1D and its flax layout traps, and ``DiffusionPolicyUNet``
(train steps with the EMA, DDPM and DDIM samples through the action queue)
against the JAX package on bridged weights, in fp32 on the CPU.

The JAX package's random draws are replayed: the test takes the same
``jax.random`` splits as the JAX step (noise and timesteps of a train step,
the initial sample and each step's noise of a DDPM chain) and hands the
numbers to the port (``draws=`` / ``noise=``).

Tolerances: the schedulers' float64 tables are equal bit for bit and their
float32 copies too. mish agrees to rtol 1e-6 (the libraries' tanh and
softplus differ by ulps) and equals x above 20 in both. One scheduler step on the same inputs agrees to rtol
1e-6 / atol 1e-6 (the same fp32 formulas; XLA may fuse a product into an
FMA). The UNet forward agrees to atol 2e-5 on outputs of magnitude ~3
(fp32 convolutions and GroupNorms summed in other orders; measured ~2e-6).
Whole samples run a 10-step chain whose clipped x0 amplifies a
model difference little: atol 1e-4. Train steps: losses rtol 1e-5,
parameters and the EMA tree atol 2e-5 + rtol 1e-5 (Adam divides each
gradient element by its own magnitude, so an element whose gradient is
near eps moves by a fraction of its lr-1e-3 step that depends on the
gradient's last digits; measured worst ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
import lipvq_tpu.ops.diffusion_schedulers as jsched
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.models.diffusion_nets import (
    ConditionalUnet1D as JaxUnet,
    Downsample1d as JaxDownsample1d,
    Upsample1d as JaxUpsample1d,
    mish as jax_mish,
)
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.models.diffusion_nets import (
    ConditionalUnet1D,
    Downsample1d,
    Upsample1d,
    mish,
)
from lipvq_tpu_torch.ops import diffusion_schedulers as sched
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, BATCH, STEPS = 7, 6, 19
N_TRAIN = 10
STEP_TOL = dict(rtol=1e-6, atol=1e-6)
UNET_ATOL = 2e-5
SAMPLE_ATOL = 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- schedulers ----------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "linear"])
def test_beta_schedule_matches_jax(schedule):
    want = jsched.make_beta_schedule(100, schedule)
    got = sched.make_beta_schedule(100, schedule)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    jax_s, port_s = jsched.make_scheduler(100, schedule), sched.make_scheduler(100, schedule)
    np.testing.assert_array_equal(port_s.betas, np.asarray(jax_s.betas))
    np.testing.assert_array_equal(port_s.alphas_cumprod, np.asarray(jax_s.alphas_cumprod))
    np.testing.assert_array_equal(port_s.alphas_cumprod_device.numpy(),
                                  np.asarray(jax_s.alphas_cumprod))


def test_add_noise_matches_jax():
    rng = np.random.default_rng(0)
    x0, eps = (rng.standard_normal((5, 16, AC_DIM)).astype(np.float32) for _ in range(2))
    t = rng.integers(0, 100, 5)
    want = jsched.add_noise(jsched.make_scheduler(100), jnp.asarray(x0), jnp.asarray(eps),
                            jnp.asarray(t))
    got = sched.add_noise(sched.make_scheduler(100), torch.from_numpy(x0),
                          torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "sample"])
@pytest.mark.parametrize("t", [0, 1, 57, 99])
def test_ddpm_step_matches_jax(t, prediction_type):
    rng = np.random.default_rng(t)
    out, x = (rng.standard_normal((4, 16, AC_DIM)).astype(np.float32) * 2 for _ in range(2))
    key = jax.random.PRNGKey(t)
    noise = np.array(jax.random.normal(key, x.shape, jnp.float32))
    js = jsched.make_scheduler(100, prediction_type=prediction_type)
    want = jsched.ddpm_step(js, jnp.asarray(out), t, jnp.asarray(x), key)
    got = sched.ddpm_step(sched.make_scheduler(100, prediction_type=prediction_type),
                          torch.from_numpy(out), t, torch.from_numpy(x),
                          torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


@pytest.mark.parametrize("t,prev", [(90, 80), (9, -1), (50, 40)])
def test_ddim_step_matches_jax(t, prev):
    rng = np.random.default_rng(t)
    out, x = (rng.standard_normal((4, 16, AC_DIM)).astype(np.float32) for _ in range(2))
    want = jsched.ddim_step(jsched.make_scheduler(100), jnp.asarray(out), t, prev,
                            jnp.asarray(x))
    got = sched.ddim_step(sched.make_scheduler(100), torch.from_numpy(out), t, prev,
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)


def _toy_model(framework):
    """A fixed eps model of x and t in either framework."""
    w = np.random.default_rng(5).standard_normal((AC_DIM, AC_DIM)).astype(np.float32) * 0.3
    if framework == "jax":
        return lambda x, t: jnp.tanh(x @ jnp.asarray(w) + 0.01 * t[:, None, None])
    tw = torch.from_numpy(w)
    return lambda x, t: torch.tanh(x @ tw + 0.01 * t[:, None, None].float())


def ddpm_draws(key, shape, steps):
    """The initial sample and per-step noise ``ddpm_sample`` draws from ``key``."""
    key, init_key = jax.random.split(key)
    x = jax.random.normal(init_key, shape)
    per_step = []
    for _ in range(steps):
        key, step_key = jax.random.split(key)
        per_step.append(jax.random.normal(step_key, shape))
    return torch.from_numpy(np.array(x)), torch.from_numpy(np.stack(per_step))


@pytest.mark.parametrize("steps", [10, 5])
def test_ddpm_sample_matches_jax(steps):
    shape, key = (3, 16, AC_DIM), jax.random.PRNGKey(11)
    want = jsched.ddpm_sample(jsched.make_scheduler(N_TRAIN), _toy_model("jax"), shape, key,
                              num_inference_timesteps=steps)
    got = sched.ddpm_sample(sched.make_scheduler(N_TRAIN), _toy_model("torch"), shape,
                            num_inference_timesteps=steps, noise=ddpm_draws(key, shape, steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SAMPLE_ATOL)


def test_ddim_sample_matches_jax():
    shape, key = (3, 16, AC_DIM), jax.random.PRNGKey(12)
    want = jsched.ddim_sample(jsched.make_scheduler(100), _toy_model("jax"), shape, key,
                              num_inference_timesteps=10)
    x = torch.from_numpy(np.asarray(jax.random.normal(key, shape)))
    got = sched.ddim_sample(sched.make_scheduler(100), _toy_model("torch"), shape,
                            num_inference_timesteps=10, noise=x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SAMPLE_ATOL)


def test_samplers_draw_from_the_generator():
    shape = (2, 16, AC_DIM)
    runs = [sched.ddpm_sample(sched.make_scheduler(N_TRAIN), _toy_model("torch"), shape,
                              torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.isfinite(runs[0]).all() and runs[0].abs().max() <= 1.5


def test_ddpm_step_takes_the_previous_train_step_whatever_the_spacing():
    """Reference fault (c), mirrored: with 5 inference steps over 10 train
    steps the JAX step (and the port's) uses alphas_cumprod[t - 1] where
    diffusers uses alphas_cumprod[t - 2]; the two differ."""
    rng = np.random.default_rng(3)
    out, x = (rng.standard_normal((2, 16, AC_DIM)).astype(np.float32) for _ in range(2))
    t = sched.ddpm_timesteps(N_TRAIN, 5)[0]
    assert t == 9 and sched.ddpm_timesteps(N_TRAIN, 5)[1] == 7
    key = jax.random.PRNGKey(0)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, x.shape)))
    js, ps = jsched.make_scheduler(N_TRAIN), sched.make_scheduler(N_TRAIN)
    want = np.asarray(jsched.ddpm_step(js, jnp.asarray(out), t, jnp.asarray(x), key))
    got = sched.ddpm_step(ps, torch.from_numpy(out), t, torch.from_numpy(x), noise).numpy()
    np.testing.assert_allclose(got, want, **STEP_TOL)
    # diffusers' previous step under the 5-step spacing
    spaced = ps._replace(alphas_cumprod=np.concatenate(
        [ps.alphas_cumprod[:8], [ps.alphas_cumprod[7]], ps.alphas_cumprod[9:]]))
    diffusers = sched.ddpm_step(spaced, torch.from_numpy(out), t, torch.from_numpy(x),
                                noise).numpy()
    assert np.abs(diffusers - want).max() > 1e-2


# -- the UNet ------------------------------------------------------------------

def _unet_pair(down_dims=(16, 32, 64), cond=20, kernel=5):
    j = JaxUnet(input_dim=AC_DIM, global_cond_dim=cond, down_dims=down_dims, kernel_size=kernel)
    x = np.zeros((2, 16, AC_DIM), np.float32)
    params = j.init(jax.random.PRNGKey(0), x, np.zeros(2, np.int32),
                    np.zeros((2, cond), np.float32))["params"]
    p = ConditionalUnet1D(AC_DIM, cond, down_dims=down_dims, kernel_size=kernel)
    p.load_state_dict(state_dict_from_jax_params(_np(params), p), strict=True)
    return j, params, p


@pytest.mark.parametrize("horizon", [16, 8])
def test_unet_forward_matches_jax(horizon):
    j, params, p = _unet_pair()
    rng = np.random.default_rng(horizon)
    x = rng.standard_normal((3, horizon, AC_DIM)).astype(np.float32)
    t = np.array([0, 5, 99])
    c = rng.standard_normal((3, 20)).astype(np.float32)
    want = np.asarray(j.apply({"params": params}, x, t, c))
    got = p(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)).detach().numpy()
    assert got.shape == (3, horizon, AC_DIM)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_ATOL)


def test_unet_backward_matches_jax():
    j, params, p = _unet_pair(down_dims=(16, 32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, AC_DIM)).astype(np.float32)
    t, c = np.array([1, 2, 3]), rng.standard_normal((3, 20)).astype(np.float32)
    jgrad = jax.grad(lambda prm: jnp.sum(j.apply({"params": prm}, x, t, c) ** 2))(params)
    loss = (p(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)) ** 2).sum()
    loss.backward()
    want = state_dict_from_jax_params(_np(jgrad), p)
    for name, prm in p.named_parameters():
        scale = float(want[name].abs().max())
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1.0), err_msg=name)


def test_template_unet_has_89_87m_parameters():
    """At the flagship's 791-wide low-dim obs, To = 2."""
    unet = ConditionalUnet1D(12, 2 * 791)
    assert sum(q.numel() for q in unet.parameters()) == 89_874_188


@pytest.mark.parametrize("length", [16, 8, 5])
def test_downsample_is_flax_same_padding(length):
    """flax's stride-2 SAME conv pads one zero on the right only at an even
    length, where torch's symmetric padding=1 is another function (at an odd
    length both pad one each side)."""
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, length, 8)).astype(np.float32)
    jm = JaxDownsample1d(8)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    pm = Downsample1d(8)
    pm.load_state_dict(state_dict_from_jax_params(_np(params), pm), strict=True)
    got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    assert got.shape == (2, -(-length // 2), 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    sym = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2), pm.conv.weight,
                                     pm.conv.bias, stride=2, padding=1)
    sym_err = np.abs(sym.transpose(1, 2).detach().numpy() - want).max()
    assert sym_err > 1e-2 if length % 2 == 0 else sym_err <= 1e-5


def test_upsample_is_flax_transposed_conv_with_flipped_taps():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8)).astype(np.float32)
    jm = JaxUpsample1d(8)
    params = jm.init(jax.random.PRNGKey(2), x)["params"]
    want = np.asarray(jm.apply({"params": params}, x))
    pm = Upsample1d(8)
    pm.load_state_dict(state_dict_from_jax_params(_np(params), pm), strict=True)
    got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).detach().numpy()
    assert got.shape == (2, 16, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the kernel as flax lays it out, unflipped, is another function
    kernel = torch.from_numpy(np.asarray(params["conv"]["kernel"]).transpose(1, 2, 0).copy())
    unflipped = torch.nn.functional.conv_transpose1d(
        torch.from_numpy(x).transpose(1, 2), kernel, pm.conv.bias, stride=2, padding=1)
    assert np.abs(unflipped.transpose(1, 2).detach().numpy() - want).max() > 1e-2


def test_mish_and_group_norm_epsilon_match_flax():
    x = np.linspace(-30, 30, 1001, dtype=np.float32)
    got, want = mish(torch.from_numpy(x)).numpy(), np.asarray(jax_mish(jnp.asarray(x)))
    # the libraries' tanh and softplus differ by ulps; above 20 both are x
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got[x > 20], x[x > 20])
    np.testing.assert_array_equal(want[x > 20], x[x > 20])
    # GroupNorm at a small variance, where eps 1e-5 against 1e-6 shows
    h = (np.random.default_rng(0).standard_normal((2, 5, 16)) * 3e-3).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=8)
    want = np.asarray(gn.apply(gn.init(jax.random.PRNGKey(0), h), h))
    _, _, p = _unet_pair(down_dims=(16, 32))
    got = p.final_block.gn(torch.from_numpy(h).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-3, atol=1e-4)


# -- the algorithm ---------------------------------------------------------------

def _config(factory, ddim: bool = False, **algo):
    cfg = factory("diffusion_policy", {
        "train": {"seed": 1, "num_epochs": 1, "batch_size": BATCH},
        "algo": {
            "optim_params": {"policy": {"learning_rate": {"initial": 1e-3,
                                                          "num_warmup_steps": 2}}},
            "unet": {"down_dims": [16, 32]},
            "ddpm": {"num_train_timesteps": N_TRAIN, "num_inference_timesteps": N_TRAIN},
            "ddim": {"enabled": ddim, "num_train_timesteps": N_TRAIN,
                     "num_inference_timesteps": 5},
            **algo,
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def make_pair(ddim: bool = False, **algo):
    """(JAX algo, port algo on the CPU) with identical weights and EMA tree."""
    jax_algo = jax_algo_factory("diffusion_policy", _config(jax_config_factory, ddim, **algo),
                                OBS_SHAPES, ac_dim=AC_DIM)
    port = algo_factory("diffusion_policy", _config(config_factory, ddim, **algo), OBS_SHAPES,
                        ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, _np(jax_algo.state.params), _np(jax_algo.state.extra_vars),
                    ema_params_np=_np(jax_algo._ema_params))
    return jax_algo, port


def batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [{"obs": {k: rng.standard_normal((BATCH, STEPS, *s), dtype=np.float32)
                     for k, s in OBS_SHAPES.items()},
             "actions": rng.uniform(-1, 1, (BATCH, STEPS, AC_DIM)).astype(np.float32)}
            for _ in range(n)]


def train_draws(jax_algo, actions_shape):
    """The noise and timesteps the JAX step draws from its state's key."""
    _, noise_key, t_key = jax.random.split(jax_algo.state.rng, 3)
    return {"noise": np.asarray(jax.random.normal(noise_key, actions_shape)),
            "timesteps": np.asarray(jax.random.randint(
                t_key, (actions_shape[0],), 0, jax_algo.scheduler.num_train_timesteps))}


@pytest.fixture(scope="module")
def trained():
    jax_algo, port = make_pair()
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    snaps = {}
    for step, raw in enumerate(batches(3), start=1):
        jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
        draws = train_draws(jax_algo, jb["actions"].shape)
        want = jax_algo.train_on_batch(jb, 0)["losses"]
        got = port.train_on_batch(pb, 0, draws=draws)["losses"]
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want.items()},
                           {k: float(v) for k, v in got.items()},
                           state_dict_from_jax_params(_np(jax_algo.state.params), port.nets),
                           state_dict_from_jax_params(_np(jax_algo._ema_params), port.nets),
                           {k: v.clone() for k, v in port.nets.state_dict().items()},
                           {k: v.clone() for k, v in port.ema_nets.state_dict().items()})
    return start, snaps, jax_algo, port


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    start, snaps, _, _ = trained
    want_m, got_m, want_p, want_ema, got_p, got_ema = snaps[step]
    assert set(got_m) == set(want_m) == {"action_loss"}
    np.testing.assert_allclose(got_m["action_loss"], want_m["action_loss"], rtol=LOSS_RTOL)
    for want, got in ((want_p, got_p), (want_ema, got_ema)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL, err_msg=k)
    # warmup 2: lr 0 at the first step; the EMA moves toward the params
    moved = {k for k in got_p if not torch.equal(got_p[k], start[k])}
    assert (len(moved) > 0) == (step == 3)
    if step == 3:
        key = "unet.final_conv.weight"
        assert not torch.equal(got_ema[key], got_p[key])
        assert not torch.equal(got_ema[key], start[key])


def test_ema_decay_schedule():
    _, port = make_pair()
    assert port.ema_decay(1) == pytest.approx(1 - 2 ** -0.75, rel=1e-6)
    assert port.ema_decay(0) == 0.0
    assert port.ema_decay(10 ** 9) == pytest.approx(0.9999, rel=1e-7)


def test_validation_step_changes_nothing(trained):
    _, _, jax_algo, port = trained
    raw = batches(1, seed=5)[0]
    jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
    draws = train_draws(jax_algo, jb["actions"].shape)
    before = {k: v.clone() for k, v in port.serialize().items()}
    want = float(jax_algo.train_on_batch(jb, 0, validate=True)["losses"]["action_loss"])
    got = float(port.train_on_batch(pb, 0, validate=True, draws=draws)["losses"]["action_loss"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    after = port.serialize()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def _obs(seed, n=2, t=2):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n, t, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}


@pytest.mark.parametrize("ddim", [False, True], ids=["ddpm", "ddim"])
def test_get_action_through_the_queue_matches_jax(ddim):
    """Two chunks: a sample from the EMA net at the first call and after Ta
    calls, its Ta actions from step To - 1 served one per call."""
    jax_algo, port = make_pair(ddim=ddim)
    obs = [_obs(s) for s in range(2 * port.Ta)]
    steps = port.num_inference_timesteps
    for i, o in enumerate(obs):
        noise = None
        if i % port.Ta == 0:  # a new chunk: the draws the JAX call will make
            _, key = jax.random.split(jax_algo.state.rng)
            shape = (2, port.Tp, AC_DIM)
            noise = (torch.from_numpy(np.asarray(jax.random.normal(key, shape))) if ddim
                     else ddpm_draws(key, shape, steps))
        want = jax_algo.get_action(o)
        got = port.get_action(o, noise=noise)
        assert got.shape == (2, AC_DIM)
        np.testing.assert_allclose(got, want, rtol=0, atol=SAMPLE_ATOL, err_msg=str(i))
        assert len(port._action_queue) == len(jax_algo._action_queue)


def test_get_action_samples_the_ema_net():
    """The served chunk comes from the EMA weights: with the trained net
    perturbed, the actions stay; with the EMA perturbed, they move."""
    _, port = make_pair()
    o = _obs(3)
    first = port.sample(port._put_infer(o), noise=ddpm_draws(jax.random.PRNGKey(0),
                                                              (2, port.Tp, AC_DIM), N_TRAIN))
    with torch.no_grad():
        for q in port.nets.parameters():
            q.add_(1.0)
    again = port.sample(port._put_infer(o), noise=ddpm_draws(jax.random.PRNGKey(0),
                                                              (2, port.Tp, AC_DIM), N_TRAIN))
    assert torch.equal(first, again)
    port.ema_enabled = False
    other = port.sample(port._put_infer(o), noise=ddpm_draws(jax.random.PRNGKey(0),
                                                              (2, port.Tp, AC_DIM), N_TRAIN))
    assert not torch.equal(first, other)


def test_unread_unet_settings_in_both_packages():
    """Reference fault (b), mirrored: diffusion_step_embed_dim and n_groups
    are not read; the UNet keeps 256 and 8."""
    jax_algo, port = make_pair(unet={"down_dims": [16, 32], "diffusion_step_embed_dim": 64,
                                     "n_groups": 4})
    assert np.asarray(jax_algo.state.params["unet"]["t1"]["kernel"]).shape == (256, 1024)
    assert port.nets.unet.t1.weight.shape == (1024, 256)
    assert port.nets.unet.down0_res0.block1.gn.num_groups == 8


def test_cosine_schedule_counts_epochs_times_steps():
    _, port = make_pair()
    sched_fn = port.policy_optimizer.schedule
    # max(1 epoch x 100 steps, 1000): the cosine reaches 0 at step 1000
    assert sched_fn(1000) == pytest.approx(0.0, abs=1e-12)
    assert sched_fn(500) > 0


def test_episode_start_keeps_the_queue_in_both_packages():
    """Reference fault (a), mirrored: RolloutPolicy.start_episode does not
    reset the algo, so a new episode is served the previous one's queue."""
    from lipvq_tpu.algo.rollout_policy import RolloutPolicy as JaxRolloutPolicy
    from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy

    jax_algo, port = make_pair()
    for algo, policy_cls in ((jax_algo, JaxRolloutPolicy), (port, RolloutPolicy)):
        policy = policy_cls(algo)
        policy.start_episode()
        policy({k: v[0] for k, v in _obs(0).items()})
        queued = np.array(algo._action_queue[0])
        policy.start_episode()
        np.testing.assert_array_equal(policy({k: v[0] for k, v in _obs(1).items()}), queued[0])
        assert len(algo._action_queue) == algo.Ta - 2
