"""Port parity of ACT (the Action Chunking Transformer CVAE) against the JAX
package on bridged weights, in fp32 on the CPU: the style encoder and
decoder forward, 1 and 3 train steps (losses and every parameter), the
chunk queue of ``get_action``, the checkpoint round trip, and the queue
that an episode's start does not clear (reference fault (a)).

The reparameterization's normals are the JAX step's: the test derives the
key its network draws from (``make_rng("sample")`` at the root of the flax
module under the step's ``sample`` key) and hands the numbers to the port
(``draws={"eps": ...}``).

Tolerances: the forward agrees to atol 1e-5 (fp32 GEMMs and softmaxes
summed in other orders; measured ~1e-6 on outputs of magnitude ~1). Train
steps: losses rtol 1e-5, parameters atol 2e-5 + rtol 1e-5 (Adam's
per-element normalization, as in tests/test_torch_port_train.py; lr 1e-3).
The attention's key biases are the exception: the softmax is invariant to
them, so their exact gradient is 0 and each package's Adam steps them by its
own rounding noise, normalized to up to one lr a step; they are held, in
both packages, within the steps' lr of their start (the raw tokenizer's key
bias, ``hold_step(zero=...)`` in chip_smoke.py, is the same case).
"""

import jax
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.algo.rollout_policy import RolloutPolicy as JaxRolloutPolicy
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.rollout_policy import RolloutPolicy
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils.jax_weights import load_jax_params, state_dict_from_jax_params

torch.set_num_threads(1)

OBS_SHAPES = {"robot0_eef_pos": [3], "object": [14]}
AC_DIM, BATCH, STEPS, CHUNK = 7, 6, 10, 5
FWD_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 2e-5, 1e-5
LR = 1e-3


def _zero_grad(name: str) -> bool:
    """An attention key bias: the softmax is invariant to it."""
    return name.endswith(("_attn.key.bias", "_cross.key.bias"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _config(factory):
    cfg = factory("act", {
        "train": {"seed": 1, "batch_size": BATCH},
        "algo": {
            "optim_params": {"policy": {"learning_rate": {
                "initial": LR, "scheduler_type": "constant"}}},
            "act": {"hidden_dim": 32, "ff_dim": 64, "enc_layers": 1, "dec_layers": 1,
                    "chunk_size": CHUNK, "latent_dim": 8},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def make_pair():
    jax_algo = jax_algo_factory("act", _config(jax_config_factory), OBS_SHAPES, ac_dim=AC_DIM)
    port = algo_factory("act", _config(config_factory), OBS_SHAPES, ac_dim=AC_DIM, device="cpu")
    load_jax_params(port, _np(jax_algo.state.params))
    return jax_algo, port


def batches(n, seed=11):
    rng = np.random.default_rng(seed)
    return [{"obs": {k: rng.standard_normal((BATCH, STEPS, *s), dtype=np.float32)
                     for k, s in OBS_SHAPES.items()},
             "actions": rng.uniform(-1, 1, (BATCH, STEPS, AC_DIM)).astype(np.float32)}
            for _ in range(n)]


def jax_eps(jax_algo, batch):
    """The standard normals the JAX step's reparameterization draws."""
    _, s_rng = jax.random.split(jax_algo.state.rng)
    key = jax_algo.net.apply({"params": jax_algo.state.params},
                             method=lambda m: m.make_rng("sample"), rngs={"sample": s_rng})
    latent = jax_algo.state.params["latent_mu"]["bias"].shape[0]
    return np.array(jax.random.normal(key, (batch["actions"].shape[0], latent)))


def test_forward_matches_jax():
    jax_algo, port = make_pair()
    raw = batches(1)[0]
    jb = jax_algo.process_batch_for_training(raw)
    key = jax_algo.net.apply({"params": jax_algo.state.params},
                             method=lambda m: m.make_rng("sample"),
                             rngs={"sample": jax.random.PRNGKey(0)})
    want = jax_algo.net.apply({"params": jax_algo.state.params}, jb["obs"], jb["actions"],
                              rng=key)
    eps = np.array(jax.random.normal(key, want[1].shape))
    got = port.nets(port._put_infer(jb["obs"]), port._put_infer(jb["actions"]),
                    eps=torch.from_numpy(eps))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=FWD_ATOL)
    # inference: z = 0, no style encoding
    want = jax_algo.net.apply({"params": jax_algo.state.params}, jb["obs"], None)
    got = port.nets(port._put_infer(jb["obs"]))
    assert got[0].shape == (BATCH, CHUNK, AC_DIM)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=0,
                               atol=FWD_ATOL)


@pytest.fixture(scope="module")
def trained():
    jax_algo, port = make_pair()
    start = {k: v.clone() for k, v in port.nets.state_dict().items()}
    snaps = {}
    for step, raw in enumerate(batches(3), start=1):
        jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
        eps = jax_eps(jax_algo, jb)
        want = jax_algo.train_on_batch(jb, 0)["losses"]
        got = port.train_on_batch(pb, 0, draws={"eps": eps})["losses"]
        if step in (1, 3):
            snaps[step] = ({k: float(v) for k, v in want.items()},
                           {k: float(v) for k, v in got.items()},
                           state_dict_from_jax_params(_np(jax_algo.state.params)),
                           {k: v.clone() for k, v in port.nets.state_dict().items()})
    return start, snaps, jax_algo, port


@pytest.mark.parametrize("step", [1, 3])
def test_train_step_matches_jax(trained, step):
    start, snaps, _, _ = trained
    want_m, got_m, want_sd, got_sd = snaps[step]
    assert set(got_m) == set(want_m) == {"action_loss", "l1_loss", "kl_loss"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL, err_msg=k)
    assert set(got_sd) == set(want_sd)
    zero = [k for k in want_sd if _zero_grad(k)]
    assert len(zero) == 3, zero
    for k, want in want_sd.items():
        if k in zero:
            for moved in (got_sd[k] - start[k], want - start[k]):
                assert float(moved.abs().max()) <= step * LR * 1.01, k
            continue
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL, err_msg=k)
    assert all(not torch.equal(got_sd[k], start[k]) for k in
               ("cls_embed", "enc_pos_embed", "query_embed", "enc0_attn.query.weight",
                "dec0_cross.key.weight", "latent_logvar.bias"))


def test_validation_step_matches_jax_and_changes_nothing(trained):
    _, _, jax_algo, port = trained
    raw = batches(1, seed=4)[0]
    jb, pb = jax_algo.process_batch_for_training(raw), port.process_batch_for_training(raw)
    eps = jax_eps(jax_algo, jb)
    before = {k: v.clone() for k, v in port.nets.state_dict().items()}
    want = jax_algo.train_on_batch(jb, 0, validate=True)["losses"]
    got = port.train_on_batch(pb, 0, validate=True, draws={"eps": eps})["losses"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    assert all(torch.equal(port.nets.state_dict()[k], v) for k, v in before.items())


def _obs(seed, t=None):
    rng = np.random.default_rng(seed)
    lead = (3,) if t is None else (3, t)
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32) for k, s in OBS_SHAPES.items()}


def test_get_action_serves_the_chunk_through_the_queue():
    """A chunk predicted at the first call (from the last step of [B, T, ...]
    obs) is served one action per call; the next chunk after CHUNK calls."""
    jax_algo, port = make_pair()
    for i in range(2 * CHUNK):
        o = _obs(i, t=2)
        want, got = jax_algo.get_action(o), port.get_action(o)
        assert got.shape == (3, AC_DIM)
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_ATOL, err_msg=str(i))
        assert len(port._action_queue) == len(jax_algo._action_queue) == CHUNK - 1 - i % CHUNK


def test_episode_start_keeps_the_queue_in_both_packages():
    """Reference fault (a), mirrored: RolloutPolicy.start_episode does not
    reset the algo, so the next episode's first action is the previous
    episode's queued one."""
    jax_algo, port = make_pair()
    for algo, policy_cls in ((jax_algo, JaxRolloutPolicy), (port, RolloutPolicy)):
        policy = policy_cls(algo)
        policy.start_episode()
        first = policy({k: v[0] for k, v in _obs(0).items()})
        queued = algo._action_queue[0].copy()
        policy.start_episode()
        nxt = policy({k: v[0] for k, v in _obs(1).items()})
        np.testing.assert_array_equal(nxt, queued[0])
        assert len(algo._action_queue) == CHUNK - 2
        assert first.shape == (AC_DIM,)
        algo.reset()
        assert not algo._action_queue


def test_checkpoint_round_trip(tmp_path):
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint, save_checkpoint

    _, port = make_pair()
    port.train_on_batch(port.process_batch_for_training(batches(1)[0]), 0)
    path = str(tmp_path / "act.ckpt")
    save_checkpoint(path, port, _config(config_factory),
                    shape_meta={"all_shapes": OBS_SHAPES, "ac_dim": AC_DIM})
    loaded, ckpt = policy_from_checkpoint(path, device="cpu")
    assert ckpt["algo_name"] == "act" and type(loaded).__name__ == "ACT"
    for k, v in port.nets.state_dict().items():
        assert torch.equal(loaded.nets.state_dict()[k], v), k
    o = _obs(5, t=1)
    np.testing.assert_array_equal(loaded.get_action(o), port.get_action(o))
