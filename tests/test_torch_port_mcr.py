"""Port parity of MCR's pretraining half (``lipvq_tpu_torch/algo/mcr_data.py``,
``algo/mcr.py::MCRPretrainer``, ``scripts/train_mcr_representation.py``)
against the JAX package on the CPU, from bridged weights and the same numpy
inputs.

- The synthetic corpus, the buffer's draws and its crops are numpy in both
  packages: held bit for bit, in the HDF5 and the manifest layout.
- One pretrainer step and two workspace steps (fp32, 64 x 64 frames): the
  metrics to rtol 1e-4 / atol 1e-6 (the language loss is a mean of cosines
  near 0); each parameter's gradient from Adam's first moment (the JAX
  state's ``mu`` against torch's ``exp_avg``, (1 - b1) g after one step).
  The projection's and the head's gradients agree to rtol 1e-3 of each
  tensor's largest element. The trunk's do not elementwise: train-mode
  BatchNorm renormalizes by batch statistics, and at 12-20 frames of
  64 x 64 (layer4 2 x 2) the backward cancels most of each element, so the
  two packages' fp32 rounding moves a trunk gradient by up to 4.0e-2 of its
  norm (measured: the pretrainer's worst tensor, layer4's first BatchNorm
  bias); each trunk gradient is held as a whole, to a relative Frobenius
  error of 0.1. The workspace's projection bias has an exact gradient of 0
  (its losses see embeddings only through differences): held below 1e-5
  of the largest moment in both. Parameters after the first step: Adam
  moves an element by ~lr * sign(g); among the elements with |g| >= 1e-5
  in both, at least 90 % of each tensor's share their sign, and there the
  updates agree to 2e-3 lr. The BatchNorm statistics to atol 1e-5. The
  workspace's second step starts from JAX's parameters and statistics
  after the first (the port's own Adam moments kept), so the first step's
  rounding does not compound into the second's metrics.
- ``evaluate`` against JAX's (rtol 1e-4), leaving the state bit-equal; the
  snapshot round trip bit-equal.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from lipvq_tpu.algo import mcr_data as jax_mcr_data
from lipvq_tpu.algo.mcr import MCRPretrainer as JaxMCRPretrainer
from lipvq_tpu.scripts.train_mcr_representation import (
    RepresentationWorkspace as JaxWorkspace,
)
from lipvq_tpu_torch.algo import mcr_data
from lipvq_tpu_torch.algo.mcr import MCRPretrainer
from lipvq_tpu_torch.scripts import train_mcr_representation as port_script
from lipvq_tpu_torch.scripts.train_mcr_representation import RepresentationWorkspace
from lipvq_tpu_torch.utils.jax_weights import state_dict_from_jax_params

torch.set_num_threads(1)

METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
HEAD_RTOL = 1e-3  # of a tensor's largest |g|: the projection and the head
TRUNK_FROBENIUS = 0.1  # a trunk gradient or update as a whole
STATS_ATOL = 1e-5
UPDATE_ATOL_IN_LR, UPDATE_COVERAGE = 2e-3, 0.9
LR = 1e-4  # both packages' default for the pretrainer and the workspace
HW = (64, 64)
# the workspace's losses see embeddings only through differences (L2
# distances, eg - e0): the projection's bias has an exact gradient of 0
WORKSPACE_ZERO = ("proj.bias",)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mu(opt_state):
    """The Adam first moment tree of an optax state (plain or chained)."""
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return _np(leaf.mu)
    raise KeyError("no Adam state")


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The synthetic corpus: JAX's HDF5, the port's HDF5 and the port's
    manifest directory, from the same seed (smaller than the default)."""
    root = tmp_path_factory.mktemp("mcr")
    kw = {"n_videos": 5, "length": 12, "hw": (48, 48), "seed": 3}
    jax_h5 = jax_mcr_data.build_synthetic_corpus(str(root / "jax.hdf5"), **kw)
    port_h5 = mcr_data.build_synthetic_corpus(str(root / "port.hdf5"), **kw)
    os.makedirs(root / "manifest")
    manifest = mcr_data.build_synthetic_corpus(str(root / "manifest"), **kw)
    return jax_h5, port_h5, manifest


def test_synthetic_corpus_matches_jax_in_both_layouts(corpora):
    import h5py

    jax_h5, port_h5, manifest = corpora
    with h5py.File(jax_h5, "r") as a, h5py.File(port_h5, "r") as b:
        assert sorted(a["videos"]) == sorted(b["videos"]) == [f"vid_{i}" for i in range(5)]
        for k in a["videos"]:
            np.testing.assert_array_equal(a["videos"][k][()], b["videos"][k][()])
            assert a["videos"][k].attrs["txt"] == b["videos"][k].attrs["txt"]
            frames = np.stack([np.load(os.path.join(manifest, k, f"{t:06d}.npy"))
                               for t in range(1, 13)])
            np.testing.assert_array_equal(frames, a["videos"][k][()])
    with open(os.path.join(manifest, "manifest.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["path"] for r in rows] == [f"vid_{i}" for i in range(5)]
    assert {r["len"] for r in rows} == {"12"}


@pytest.mark.parametrize("seed", [0, 7])
def test_random_resized_crop_matches_jax(seed):
    frames = np.random.default_rng(seed).integers(0, 256, (5, 40, 52, 3), dtype=np.uint8)
    a = jax_mcr_data.random_resized_crop(np.random.default_rng(seed), frames, (24, 20))
    b = mcr_data.random_resized_crop(np.random.default_rng(seed), frames, (24, 20))
    assert b.dtype == np.float32 and b.shape == (5, 24, 20, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("layout", ["hdf5", "manifest"])
@pytest.mark.parametrize("doaug,alpha", [("rctraj", 0.2), ("none", 0.0)])
def test_buffer_draws_match_jax(corpora, layout, doaug, alpha):
    """The same clips, tuples, crops and labels as JAX's buffer on the same
    corpus, batch after batch."""
    jax_h5, port_h5, manifest = corpora
    path = manifest if layout == "manifest" else port_h5
    want_path = manifest if layout == "manifest" else jax_h5
    kw = {"alpha": alpha, "doaug": doaug, "out_hw": (32, 32), "seed": 5}
    want, got = jax_mcr_data.MCRBuffer(want_path, **kw), mcr_data.MCRBuffer(path, **kw)
    try:
        assert len(got) == len(want) == 5
        for _ in range(3):
            (wf, wl), (gf, gl) = want.sample_batch(4), got.sample_batch(4)
            assert gf.dtype == np.float32 and gf.shape == (4, 5, 32 if doaug != "none" else 48,
                                                            32 if doaug != "none" else 48, 3)
            np.testing.assert_array_equal(gf, wf)
            assert gl == wl
    finally:
        want.close()
        got.close()


def _bridge_encoder(port_encoder, params, batch_stats):
    state = state_dict_from_jax_params(_np(params), port_encoder)
    state.update(state_dict_from_jax_params(_np(batch_stats)))
    port_encoder.load_state_dict(state, strict=True)


def _rel_frobenius(got, want):
    return float((got - want).norm() / want.norm())


def _hold_grads(port_module, exp_avg, mu_tree, label, zero=()):
    """Each parameter's first moment against JAX's ``mu``: the trunk's as
    wholes, the rest elementwise, and those in ``zero`` (an exact gradient
    of 0) below 1e-5 of the largest moment in both; returns the worst trunk
    error."""
    want = state_dict_from_jax_params(mu_tree, port_module)
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, p in port_module.named_parameters():
        got = exp_avg(p)
        if name in zero:
            assert max(float(got.abs().max()), float(want[name].abs().max())) < 1e-5 * top
        elif name.startswith("backbone."):
            err = _rel_frobenius(got, want[name])
            assert err <= TRUNK_FROBENIUS, f"{label} {name}: {err}"
            worst = max(worst, err)
        else:
            scale = float(want[name].abs().max())
            np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=HEAD_RTOL,
                                       atol=HEAD_RTOL * scale, err_msg=f"{label} {name}")
    return worst


def _hold_params(port_module, before, params_tree, exp_avg, mu_tree, label):
    """The parameters after Adam's first step, p0 - lr g / (|g| + 1e-8):
    among the elements with |g| >= 1e-5 in both packages (there the step is
    lr * sign(g) to 1e-3 of lr), at least UPDATE_COVERAGE of each tensor's
    have the same sign in both, and on those the two updates agree to
    UPDATE_ATOL_IN_LR lr."""
    want = state_dict_from_jax_params(_np(params_tree), port_module)
    mu = state_dict_from_jax_params(mu_tree, port_module)
    for name, p in port_module.named_parameters():
        g_port, g_jax = exp_avg(p) / 0.1, mu[name] / 0.1
        sized = torch.minimum(g_port.abs(), g_jax.abs()) >= 1e-5
        mask = sized & (torch.sign(g_port) == torch.sign(g_jax))
        assert int(mask.sum()) >= UPDATE_COVERAGE * int(sized.sum()), f"{label} {name}"
        moved, want_moved = p.detach() - before[name], want[name] - before[name]
        np.testing.assert_allclose(moved[mask].numpy(), want_moved[mask].numpy(), rtol=0,
                                   atol=UPDATE_ATOL_IN_LR * LR, err_msg=f"{label} {name}")


def _hold_stats(port_module, batch_stats):
    want = state_dict_from_jax_params(_np(batch_stats))
    for name, b in port_module.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=0, atol=STATS_ATOL,
                                   err_msg=name)


def test_pretrainer_step_matches_jax():
    jax_pre = JaxMCRPretrainer(embed_dim=16, action_dim=12, seed=0)
    port = MCRPretrainer(embed_dim=16, action_dim=12, seed=0, device="cpu")
    _bridge_encoder(port.nets.encoder, jax_pre.params["encoder"],
                    jax_pre.extra_vars["batch_stats"])
    port.nets.head.load_state_dict(state_dict_from_jax_params(_np(jax_pre.params["head"])),
                                   strict=True)
    before = {n: p.detach().clone() for n, p in port.nets.named_parameters()}
    rng = np.random.default_rng(0)
    frames = rng.random((4, 3, *HW, 3), dtype=np.float32)
    actions = rng.standard_normal((4, 12)).astype(np.float32)
    want, got = jax_pre.train_step(frames, actions), port.train_step(frames, actions)
    assert set(got) == set(want) == {"loss", "nce_loss", "bc_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    mu = _mu(jax_pre.opt_state)
    exp_avg = lambda p: port.optimizer.state[p]["exp_avg"]  # noqa: E731
    worst = _hold_grads(port.nets.encoder, exp_avg, mu["encoder"], "encoder")
    _hold_grads(port.nets.head, exp_avg, mu["head"], "head")
    assert worst > 1e-3  # the trunk's train-mode conditioning is real
    for part in ("encoder", "head"):
        _hold_params(getattr(port.nets, part),
                     {k[len(part) + 1:]: v for k, v in before.items() if k.startswith(part)},
                     jax_pre.params[part], exp_avg, mu[part], part)
    _hold_stats(port.nets.encoder, jax_pre.extra_vars["batch_stats"])


@pytest.fixture(scope="module")
def workspaces(corpora):
    """JAX's and the port's workspace on the manifest corpus (64 x 64 crops,
    batch 4, embed 16, langweight 0.1), bridged, and the record of two
    steps: the first from the same weights, the second from JAX's weights
    and statistics after the first."""
    _, _, manifest = corpora
    kw = {"embed_dim": 16, "batch_size": 4, "out_hw": HW, "langweight": 0.1, "seed": 0}
    jax_ws = JaxWorkspace(manifest, **kw)
    port = RepresentationWorkspace(manifest, device="cpu", **kw)
    _bridge_encoder(port.encoder, jax_ws.params, jax_ws.extra["batch_stats"])
    opt = port.optimizer.optimizer
    steps = []
    for _ in range(2):
        before = {n: p.detach().clone() for n, p in port.encoder.named_parameters()}
        want, got = jax_ws.train(1, log_every=0)[0], port.train(1, log_every=0)[0]
        steps.append({
            "want": want, "got": got, "before": before, "params": jax_ws.params,
            "stats": jax_ws.extra["batch_stats"], "mu": _mu(jax_ws.opt_state),
            "exp_avg": {n: opt.state[p]["exp_avg"].clone()
                        for n, p in port.encoder.named_parameters()},
            "port_params": {n: p.detach().clone() for n, p in port.encoder.named_parameters()},
            "port_stats": {n: b.clone() for n, b in port.encoder.named_buffers()}})
        _bridge_encoder(port.encoder, jax_ws.params, jax_ws.extra["batch_stats"])
    return jax_ws, port, steps


@pytest.mark.parametrize("step", [0, 1])
def test_workspace_steps_match_jax(workspaces, step):
    """Each of two steps: the TCN, aligned, language and full losses, the
    first moments (the clipped gradient's 0.1 g1, then 0.09 g1 + 0.1 g2),
    and after the first step the parameters and the BatchNorm statistics."""
    jax_ws, port, steps = workspaces
    rec = steps[step]
    assert set(rec["got"]) == set(rec["want"]) == {"tcnloss", "aligned", "langloss",
                                                   "full_loss"}
    for k in rec["want"]:
        np.testing.assert_allclose(rec["got"][k], rec["want"][k], rtol=METRIC_RTOL,
                                   atol=METRIC_ATOL, err_msg=k)
    assert port.global_step == jax_ws.global_step == 2
    names = dict(port.encoder.named_parameters())
    ids = {id(p): n for n, p in names.items()}
    exp_avg = lambda p: rec["exp_avg"][ids[id(p)]]  # noqa: E731
    _hold_grads(port.encoder, exp_avg, rec["mu"], f"workspace step {step + 1}",
                zero=WORKSPACE_ZERO)
    if step == 0:
        params = rec["port_params"]
        with torch.no_grad():
            current = {n: p.clone() for n, p in names.items()}
            for n, p in names.items():
                p.copy_(params[n])
            try:
                _hold_params(port.encoder, rec["before"], rec["params"], exp_avg, rec["mu"],
                             "workspace")
            finally:
                for n, p in names.items():
                    p.copy_(current[n])
        want = state_dict_from_jax_params(_np(rec["stats"]))
        for name, b in rec["port_stats"].items():
            np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=0,
                                       atol=STATS_ATOL, err_msg=name)


def test_evaluate_matches_jax_and_changes_nothing(workspaces):
    jax_ws, port, _ = workspaces
    _bridge_encoder(port.encoder, jax_ws.params, jax_ws.extra["batch_stats"])
    state = {k: v.clone() for k, v in port.encoder.state_dict().items()}
    want, got = jax_ws.evaluate(), port.evaluate()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=k)
    for k, v in port.encoder.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_snapshot_round_trip_is_bit_equal(workspaces, corpora, tmp_path):
    _, port, _ = workspaces
    path = str(tmp_path / "mcr.pt")
    port.save_snapshot(path)
    fresh = RepresentationWorkspace(corpora[2], embed_dim=16, batch_size=4, out_hw=HW,
                                    seed=9, device="cpu")
    fresh.load_snapshot(path)
    assert fresh.global_step == port.global_step == 2
    for (k, a), b in zip(port.encoder.state_dict().items(),
                         fresh.encoder.state_dict().values()):
        assert torch.equal(a, b), k
    snap = torch.load(path, weights_only=True)
    assert set(snap) == {"params", "extra", "global_step"}
    assert set(snap["params"]) == {"backbone", "proj"}


def test_workspace_refuses_several_devices(corpora):
    """Several devices need their ranks started first (the mesh's process
    group); ``tests/test_torch_port_ddp.py`` runs the workspace in two."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        RepresentationWorkspace(corpora[2], num_devices=2, device="cpu")


def test_main_builds_the_synthetic_corpus_and_trains(tmp_path):
    """``main --build-synthetic DIR`` writes the manifest layout and trains."""
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    ws = port_script.main(["--build-synthetic", str(corpus), "--steps", "1",
                           "--batch_size", "2", "--device", "cpu",
                           "--snapshot", str(tmp_path / "s.pt")])
    assert (corpus / "manifest.csv").is_file() and (tmp_path / "s.pt").is_file()
    assert ws.global_step == 1 and ws.train_buffer.out_hw == (112, 112)
