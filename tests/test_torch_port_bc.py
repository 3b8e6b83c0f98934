"""Port parity of the BC family against the JAX package on bridged weights,
in fp32 on the CPU: the factory's dispatch, 1 and 3 train steps of each
variant (BC, BC-Gaussian, BC-GMM, BC-VAE, BC-RNN-GMM, BC-Transformer-GMM:
metrics and every parameter), the eval forward and ``get_action``, and the
checkpoint round trip.

BC-VAE's normals are the JAX step's: the test derives the key its VAE draws
from (``make_rng("sample")`` in the flax scope ``vae`` under the step's key)
and hands the numbers to the port (``draws={"noise": ...}``). The GMM
variants sample with their own generators: ``get_action`` is held to lie
on one of the JAX forward's mode means (low-noise eval, sigma 1e-4).

Tolerances: metrics rtol 1e-5 (rtol 1e-4 for the RNN and the transformer,
whose forward runs a sequence model summed in other orders), parameters
atol 2e-5 + rtol 1e-5 (Adam's per-element normalization at lr 1e-3, as in
tests/test_torch_port_train.py: an element whose gradient is a sum near
Adam's eps of 1e-8 moves by a fraction of its step that the gradient's last
digits decide). The transformer's parameters take atol 1e-4, a tenth of one
step: its first block's qkv and second block's mlp_proj each have one such
element (of 768 and 1024), measured 5.13e-5 and 3.24e-5 from the first step
on. Eval forwards atol 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint, save_checkpoint
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, BATCH, STEPS, T = 7, 6, 12, 10
LR = 1e-3
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5
FWD_ATOL = 1e-5

SEQ = {"enabled": True, "embed_dim": 16, "num_layers": 2, "num_heads": 2,
       "context_length": T, "emb_dropout": 0.0, "attn_dropout": 0.0,
       "block_output_dropout": 0.0}
# variant -> (algo overrides, expected class, metrics rtol, parameters atol)
VARIANTS = {
    "bc": ({"loss": {"l2_weight": 1.0, "l1_weight": 0.5, "cos_weight": 0.3}}, "BC", 1e-5,
           PARAM_ATOL),
    "gaussian": ({"gaussian": {"enabled": True}}, "BCGaussian", 1e-5, PARAM_ATOL),
    "gmm": ({"gmm": {"enabled": True}}, "BCGMM", 1e-5, PARAM_ATOL),
    "vae": ({"vae": {"enabled": True, "latent_dim": 4, "encoder_layer_dims": [16],
                     "decoder_layer_dims": [16], "prior_layer_dims": [16]}}, "BCVAE", 1e-5,
            PARAM_ATOL),
    "rnn": ({"gmm": {"enabled": True}, "rnn": {"enabled": True, "hidden_dim": 16,
                                               "horizon": T}}, "BCRNNGMM", 1e-4, PARAM_ATOL),
    "transformer": ({"gmm": {"enabled": True}, "transformer": SEQ}, "BCTransformerGMM", 1e-4,
                    1e-4),
    "transformer_all_steps": ({"gmm": {"enabled": True},
                               "transformer": {**SEQ, "supervise_all_steps": True}},
                              "BCTransformerGMM", 1e-4, 1e-4),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _config(factory, variant, over=None):
    over = VARIANTS[variant][0] if over is None else over
    cfg = factory("bc", {
        "train": {"seed": 1, "batch_size": BATCH, "max_grad_norm": 100.0},
        "algo": {"optim_params": {"policy": {"learning_rate": {
                     "initial": LR, "scheduler_type": "constant"}}},
                 "actor_layer_dims": [32, 32], **over},
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def make_pair(variant, over=None):
    jax_algo = jax_algo_factory("bc", _config(jax_config_factory, variant, over), OBS_SHAPES,
                                ac_dim=AC_DIM)
    port = algo_factory("bc", _config(config_factory, variant, over), OBS_SHAPES,
                        ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, _np(jax_algo.state.params), _np(jax_algo.state.extra_vars))
    return jax_algo, port


def batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [{"obs": {k: rng.standard_normal((BATCH, STEPS, *s), dtype=np.float32)
                     for k, s in OBS_SHAPES.items()},
             "actions": rng.uniform(-0.9, 0.9, (BATCH, STEPS, AC_DIM)).astype(np.float32)}
            for _ in range(n)]


class _VaeScope(fnn.Module):
    """The key that ``make_rng("sample")`` gives in the scope ``vae``."""

    @fnn.compact
    def __call__(self):
        return _MakeRng(name="vae")()


class _MakeRng(fnn.Module):
    @fnn.compact
    def __call__(self):
        return self.make_rng("sample")


def vae_draws(jax_algo, batch):
    """The standard normals BC-VAE's JAX train step draws."""
    _, step_rng = jax.random.split(jax_algo.state.rng)
    key = _VaeScope().apply({}, rngs={"sample": step_rng})
    latent = int(jax_algo.algo_config.vae.latent_dim)
    return {"noise": np.array(jax.random.normal(key, (batch["actions"].shape[0], latent)))}


def test_factory_dispatch_matches_jax():
    for variant, (_, cls, _, _) in VARIANTS.items():
        jax_algo, port = make_pair(variant)
        assert type(port).__name__ == type(jax_algo).__name__ == cls, variant
        assert getattr(port, "sequence", False) == getattr(jax_algo, "sequence", False)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def trained(request):
    variant = request.param
    jax_algo, port = make_pair(variant)
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    snaps = {}
    for step, raw in enumerate(batches(3), start=1):
        jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
        draws = vae_draws(jax_algo, jb) if variant == "vae" else None
        want = jax_algo.train_on_batch(jb, 0)["losses"]
        got = port.train_on_batch(pb, 0, draws=draws)["losses"]
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want.items()},
                           {k: float(v) for k, v in got.items()},
                           state_dict_from_jax_params(_np(jax_algo.state.params)),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    return variant, start, snaps, jax_algo, port


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    variant, start, snaps, _, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    assert set(got_m) == set(want_m) and "policy_grad_norms" in got_m
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=VARIANTS[variant][2], atol=1e-7,
                                   err_msg=k)
    assert set(got_sd) == set(want_sd)
    for k, want in want_sd.items():
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=VARIANTS[variant][3],
                                   rtol=PARAM_RTOL, err_msg=k)
    moved = [k for k in got_sd if not torch.equal(got_sd[k], start[k])]
    assert len(moved) >= len(got_sd) - 2, sorted(set(got_sd) - set(moved))


def test_validation_step_matches_jax(trained):
    variant, _, _, jax_algo, port = trained
    raw = batches(1, seed=4)[0]
    jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
    draws = vae_draws(jax_algo, jb) if variant == "vae" else None
    before = {k: v.clone() for k, v in port.nets.state_dict().items()}
    want = jax_algo.train_on_batch(jb, 0, validate=True)["losses"]
    got = port.train_on_batch(pb, 0, validate=True, draws=draws)["losses"]
    assert set(got) == set(want) and "policy_grad_norms" not in got
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=VARIANTS[variant][2],
                                   atol=1e-7, err_msg=k)
    assert all(torch.equal(port.nets.state_dict()[k], v) for k, v in before.items())
    assert port.log_info({"losses": got}).keys() == jax_algo.log_info({"losses": want}).keys()


def _obs(port, seed):
    rng = np.random.default_rng(seed)
    lead = (3, T) if port.sequence else (3,)
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}


def _jax_dists(jax_algo, obs):
    return jax_algo.net.apply({"params": jax_algo.state.params}, obs, train=False,
                              method=type(jax_algo.net).forward_train)


@pytest.mark.parametrize("variant", ["bc", "gaussian", "gmm", "rnn", "transformer"])
def test_get_action_matches_jax(variant):
    jax_algo, port = make_pair(variant)
    obs = _obs(port, 3)
    got = port.get_action(obs)
    assert got.shape == (3, AC_DIM) and np.isfinite(got).all()
    if variant == "bc":
        np.testing.assert_allclose(got, jax_algo.get_action(obs), rtol=0, atol=FWD_ATOL)
        return
    want = _jax_dists(jax_algo, obs)
    with torch.inference_mode():
        mine = port.nets.forward_train(port._put_infer(obs))
    for w, g in zip(want, mine):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL)
    means = np.asarray(want.means)
    if port.sequence:
        means = means[:, -1]
    # low-noise eval: the action is one mode's mean, sigma 1e-4
    gap = np.abs(got[:, None, :] - means).max(-1).min(-1).max()
    assert gap <= 1e-3, gap
    assert jax_algo.get_action(obs).shape == got.shape


def test_vae_get_action_decodes_prior_draws():
    jax_algo, port = make_pair("vae")
    obs = _obs(port, 5)
    _, key = jax.random.split(jax_algo.state.rng)
    root = jax_algo.net.apply({"params": jax_algo.state.params},
                              method=lambda m: m.make_rng("sample"), rngs={"sample": key})
    z = np.array(jax.random.normal(root, (3, 4)))
    want = jax_algo.get_action(obs)
    with torch.inference_mode():
        got = port.nets(port._put_infer(obs), None, noise=torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL)
    assert port.get_action(obs).shape == (3, AC_DIM)


def test_transformer_ignores_remat_and_dtypes_in_both_packages():
    """Reference fault (e), mirrored: BC-Transformer-GMM does not read
    ``transformer.remat``, ``compute_dtype`` or ``activation_dtype``. With
    remat on and bf16 named for both, each package builds and runs the same
    fp32 network without remat as with the defaults: the same parameters
    and, on the same inputs, the same forward bit for bit."""
    over = {"gmm": {"enabled": True},
            "transformer": {**SEQ, "remat": True, "compute_dtype": "bfloat16",
                            "activation_dtype": "bfloat16"}}
    jax_algo, port = make_pair("transformer", over)
    jax_plain, plain = make_pair("transformer")
    obs = _obs(port, 5)
    assert jax.tree.structure(jax_algo.state.params) == jax.tree.structure(
        jax_plain.state.params)
    want = _jax_dists(jax_plain, obs)
    got = jax_algo.net.apply({"params": jax_plain.state.params}, obs, train=False,
                             method=type(jax_algo.net).forward_train)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    backbone = port.nets.net.transformer
    assert not backbone.remat and backbone.activation_dtype is None
    assert all(p.dtype == torch.float32 for p in port.nets.parameters())
    assert all(getattr(m, "compute_dtype", None) is None for m in backbone.modules())
    port.nets.load_state_dict(plain.nets.state_dict())
    with torch.inference_mode():
        mine = port.nets.forward_train(port._put_infer(obs))
        theirs = plain.nets.forward_train(plain._put_infer(obs))
    for m, t in zip(mine, theirs):
        assert m.dtype == torch.float32
        assert torch.equal(m, t)


@pytest.mark.parametrize("variant", ["bc", "gmm", "vae", "rnn", "transformer"])
def test_checkpoint_round_trip(variant, tmp_path):
    _, port = make_pair(variant)
    port.train_on_batch(port.process_batch_for_training(batches(1)[0]), 0)
    path = str(tmp_path / "bc.ckpt")
    save_checkpoint(path, port, _config(config_factory, variant),
                    shape_meta={"all_shapes": OBS_SHAPES, "ac_dim": AC_DIM})
    loaded, ckpt = policy_from_checkpoint(path, device="cpu")
    assert type(loaded) is type(port) and ckpt["algo_name"] == "bc"
    for k, v in port.nets.state_dict().items():
        assert torch.equal(loaded.nets.state_dict()[k], v), k
    obs = port._put_infer(_obs(port, 6))
    with torch.inference_mode():
        if variant == "bc":
            assert torch.equal(loaded.nets(obs), port.nets(obs))
        elif variant == "vae":
            z = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
            assert torch.equal(loaded.nets(obs, None, noise=z), port.nets(obs, None, noise=z))
        else:
            for a, b in zip(loaded.nets.forward_train(obs), port.nets.forward_train(obs)):
                assert torch.equal(a, b)
