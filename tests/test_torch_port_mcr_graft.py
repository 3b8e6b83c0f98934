"""Port parity of MCR's policy half (``lipvq_tpu_torch/algo/mcr.py::
MCRTransformerGMM``, the graft of a pretrained trunk, and
``utils/jax_weights.py::mcr_checkpoint_from_msgpack``) against the JAX
package on the CPU, and the reference faults of the MCR pipeline, each
pinned in both packages.

The graft copies numbers: every comparison here is bit for bit. The
``mcr`` template is built with a 64 x 64 ``rgb`` camera (the template names
none) and a 1-layer, 32-wide transformer with context 3."""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.algo.mcr import MCRPretrainer as JaxMCRPretrainer
from lipvq_tpu.algo.mcr_data import MCRBuffer as JaxMCRBuffer
from lipvq_tpu.algo.mcr_data import build_synthetic_corpus as jax_build_corpus
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.scripts.train_mcr_representation import (
    RepresentationWorkspace as JaxWorkspace,
)
from lipvq_tpu.utils import obs_utils as jax_obs_utils
from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.algo.mcr import MCREncoder, MCRPretrainer, flatten
from lipvq_tpu_torch.algo.mcr_data import MCRBuffer, build_synthetic_corpus
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.scripts.train_mcr_representation import RepresentationWorkspace
from lipvq_tpu_torch.utils import obs_utils
from lipvq_tpu_torch.utils.jax_weights import (
    mcr_checkpoint_from_msgpack,
    state_dict_from_jax_params,
)
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.tensor_utils import stack_collate

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CAM = "agentview_image"
LOW_DIM = {"robot0_eef_pos": [3], "robot0_eef_quat": [4], "robot0_gripper_qpos": [2],
           "object": [14]}
SHAPES = {**LOW_DIM, CAM: [64, 64, 3]}  # layer4 2 x 2: SpatialSoftmax passes a gradient
AC_DIM, T = 12, 3
CORE = f"net.encoder.enc_obs.core_{CAM}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _template(ckpt=None, rgb=True, freeze=False):
    """exps/templates/mcr.json, small, with the checkpoint and the camera."""
    d = json.loads((REPO / "exps" / "templates" / "mcr.json").read_text())
    d["algo"]["transformer"].update({"embed_dim": 32, "num_layers": 1, "num_heads": 2,
                                     "context_length": T, "emb_dropout": 0.0,
                                     "attn_dropout": 0.0, "block_output_dropout": 0.0})
    d["algo"]["mcr"].update({"pretrained_ckpt": ckpt, "freeze_backbone": freeze})
    d["algo"]["optim_params"]["policy"]["learning_rate"]["scheduler_type"] = "constant"
    if rgb:
        d["observation"]["modalities"]["obs"]["rgb"] = [CAM]
    return d


def _pair(ckpt_jax=None, ckpt_port=None, rgb=True, freeze=False):
    shapes = SHAPES if rgb else LOW_DIM
    jcfg = jax_config_factory("mcr", _template(ckpt_jax, rgb, freeze))
    jax_obs_utils.initialize_obs_utils_with_config(jcfg)
    jax_algo = jax_algo_factory("mcr", jcfg, shapes, ac_dim=AC_DIM)
    cfg = config_factory("mcr", _template(ckpt_port, rgb, freeze))
    obs_utils.initialize_obs_utils_with_config(cfg)
    return jax_algo, algo_factory("mcr", cfg, shapes, ac_dim=AC_DIM, device="cpu")


def _find(tree, key, path=()):
    """Paths of every ``key`` subtree in a nested dict."""
    out = []
    for k, v in tree.items():
        if k == key:
            out.append(path + (k,))
        elif isinstance(v, dict):
            out += _find(v, key, path + (k,))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """A JAX workspace snapshot (msgpack) with trunk and statistics moved off
    any init, its conversion, and a JAX pretrainer file and its conversion."""
    root = tmp_path_factory.mktemp("mcr_graft")
    corpus = jax_build_corpus(str(root / "corpus.hdf5"), n_videos=2, length=8, hw=(32, 32))
    ws = JaxWorkspace(corpus, embed_dim=16, batch_size=2, out_hw=(32, 32), seed=5)
    rng = np.random.default_rng(1)
    ws.extra = jax.tree.map(lambda a: (rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
                            _np(ws.extra))
    ws.global_step = 7
    snap = str(root / "ws.msgpack")
    ws.save_snapshot(snap)
    pre = JaxMCRPretrainer(embed_dim=16, seed=2)
    pre_file = str(root / "pre.msgpack")
    pre.save(pre_file)
    return {"ws": ws, "snap": snap, "snap_pt": mcr_checkpoint_from_msgpack(snap, str(
        root / "ws.pt")), "pre": pre, "pre_file": pre_file,
        "pre_pt": mcr_checkpoint_from_msgpack(pre_file, str(root / "pre.pt"))}


def test_converter_keeps_every_leaf(snapshots):
    ws = snapshots["ws"]
    snap = torch.load(snapshots["snap_pt"], weights_only=True)
    assert set(snap) == {"params", "extra", "global_step"} and int(snap["global_step"]) == 7
    encoder = MCREncoder(16)
    want = state_dict_from_jax_params(_np(ws.params), encoder)
    want.update(state_dict_from_jax_params(_np(ws.extra["batch_stats"])))
    got = {**flatten(snap["params"]), **flatten(snap["extra"]["batch_stats"])}
    assert got.keys() == want.keys() == encoder.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the pretrainer's file: its encoder, head and statistics load into the port
    pre = MCRPretrainer(embed_dim=16, device="cpu")
    pre.load(snapshots["pre_pt"])
    jax_pre = snapshots["pre"]
    for part in ("encoder", "head"):
        want = state_dict_from_jax_params(_np(jax_pre.params[part]), getattr(pre.nets, part))
        for k, p in getattr(pre.nets, part).named_parameters():
            assert torch.equal(p.detach(), want[k]), (part, k)


def test_graft_from_a_converted_jax_snapshot(snapshots):
    """Both packages copy the snapshot's trunk parameters into the visual
    core, the same numbers; the core's BatchNorm statistics stay as
    initialised in both (reference fault: the graft leaves them out)."""
    jax_algo, port = _pair(snapshots["snap"], snapshots["snap_pt"])
    assert type(port).__name__ == "MCRTransformerGMM"
    core = port.nets.get_submodule(CORE)
    want = state_dict_from_jax_params(_np(snapshots["ws"].params["backbone"]), core.backbone)
    got = dict(core.backbone.named_parameters())
    assert len(got) == 60 and got.keys() == {k for k in want}
    jax_paths = _find(_np(jax_algo.state.params), "backbone")
    assert len(jax_paths) == 1
    jax_trunk = state_dict_from_jax_params(_at(_np(jax_algo.state.params), jax_paths[0]),
                                           core.backbone)
    for k, p in got.items():
        assert torch.equal(p.detach(), want[k]), k
        assert torch.equal(jax_trunk[k], want[k]), k
    for name, b in core.backbone.named_buffers():
        assert torch.equal(b, torch.zeros_like(b) if name.endswith("mean") else
                           torch.ones_like(b)), name
    jax_stats = _at(_np(jax_algo.state.extra_vars["batch_stats"]), jax_paths[0])
    assert all(np.array_equal(v, np.zeros_like(v) if k[-1] == "mean" else np.ones_like(v))
               for k, v in _flat_np(jax_stats))


def _flat_np(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_np(v, path + (k,))
        else:
            yield path + (k,), v


def test_pretrainer_file_grafts_nothing_in_both_packages(snapshots):
    """Reference fault: the pretrainer saves its trunk under
    ``params/encoder/backbone`` and the graft reads ``params["backbone"]``:
    the trunk stays as initialised, silently, in both packages."""
    jax_plain, port_plain = _pair()
    jax_algo, port = _pair(snapshots["pre_file"], snapshots["pre_pt"])
    assert "backbone" not in torch.load(snapshots["pre_pt"], weights_only=True)["params"]
    for (k, a), b in zip(port_plain.nets.state_dict().items(), port.nets.state_dict().values()):
        assert torch.equal(a, b), k
    same = jax.tree.map(np.array_equal, _np(jax_plain.state.params), _np(jax_algo.state.params))
    assert all(jax.tree.leaves(same))


def test_template_names_no_camera_so_nothing_is_grafted_in_both_packages(snapshots):
    """Reference fault: ``exps/templates/mcr.json`` names no ``rgb`` key, so
    the policy has no trunk and the snapshot goes nowhere, in both."""
    jax_algo, port = _pair(snapshots["snap"], snapshots["snap_pt"], rgb=False)
    assert not _find(_np(jax_algo.state.params), "backbone")
    assert not [n for n, _ in port.nets.named_modules() if n.endswith("backbone")]
    assert port._graft_backbone(torch.load(snapshots["snap_pt"],
                                           weights_only=True)["params"]["backbone"]) == []


def _items(rng, n):
    return [{"obs": {**{k: rng.standard_normal((T, *s)).astype(np.float32)
                        for k, s in LOW_DIM.items()},
                     CAM: rng.integers(0, 256, (T, *SHAPES[CAM]), dtype=np.uint8)},
             "actions": rng.uniform(-1, 1, (T, AC_DIM)).astype(np.float32)} for _ in range(n)]


def test_freeze_backbone_is_not_read_in_both_packages(snapshots):
    """Reference fault: ``algo.mcr.freeze_backbone`` true builds the same
    policy and optimizer in both packages (the JAX optimizer's state covers
    the trunk either way), and the port's step still trains the grafted
    trunk."""
    (jax_free, port_free), (jax_algo, port) = (
        _pair(snapshots["snap"], snapshots["snap_pt"], freeze=f) for f in (False, True))
    same = jax.tree.map(np.array_equal, _np(jax_free.state.params), _np(jax_algo.state.params))
    assert all(jax.tree.leaves(same))
    mu = next(leaf.mu for leaf in jax.tree.leaves(
        jax_algo.state.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(leaf, "mu"))
    assert len(_find(_np(mu), "backbone")) == 1
    assert (jax.tree.structure(jax_free.state.opt_state)
            == jax.tree.structure(jax_algo.state.opt_state))
    assert [id(p) for p in port.policy_optimizer.params] == [
        id(p) for p in port.nets.parameters()]
    core = port.nets.get_submodule(CORE)
    before = {k: p.detach().clone() for k, p in core.backbone.named_parameters()}
    raw = stack_collate(_items(np.random.default_rng(3), 4))
    port.train_on_batch(port.process_batch_for_training(raw), 0)
    moved = [k for k, p in core.backbone.named_parameters() if not torch.equal(p.detach(),
                                                                               before[k])]
    assert len(moved) >= 50, moved


def test_visual_bc_trains_in_the_port_where_the_jax_step_raises(snapshots):
    """A reference fault the port repairs: the JAX BC step applies its
    network in train mode without letting ``batch_stats`` change, so a BC
    policy with a visual core (MCR's whole purpose) raises at its first
    step; the port's step trains and moves the BatchNorm statistics, as
    flax's train mode would where they are mutable."""
    import flax

    jax_algo, port = _pair(snapshots["snap"], snapshots["snap_pt"])
    raw = stack_collate(_items(np.random.default_rng(3), 4))
    with pytest.raises(flax.errors.ModifyScopeVariableError, match="batch_stats"):
        jax_algo.train_on_batch(jax_algo.process_batch_for_training(raw), 0)
    core = port.nets.get_submodule(CORE)
    info = port.train_on_batch(port.process_batch_for_training(raw), 0)
    assert np.isfinite(float(info["losses"]["action_loss"]))
    assert not torch.equal(core.backbone.stem_bn.mean, torch.zeros(64))


def test_train_and_validation_buffers_read_the_same_clips_in_both_packages(tmp_path):
    """Reference fault: ``MCRBuffer`` drops ``split`` and the workspace gives
    both buffers one ``datapath``: a "val" buffer draws the train clips."""
    path = build_synthetic_corpus(str(tmp_path / "c.hdf5"), n_videos=3, length=8, hw=(32, 32))
    for buffer in (JaxMCRBuffer, MCRBuffer):
        a, b = buffer(path, "train", seed=4), buffer(path, "val", seed=4)
        (fa, la), (fb, lb) = a.sample_batch(3), b.sample_batch(3)
        np.testing.assert_array_equal(fa, fb)
        assert la == lb
        a.close()
        b.close()
    ws = RepresentationWorkspace(path, embed_dim=8, batch_size=2, out_hw=(32, 32), device="cpu")
    assert ws.train_buffer.datapath == ws.val_buffer.datapath == path


def test_caption_prefix_depends_on_the_layout_in_both_packages(tmp_path):
    """Reference fault: the HDF5 layout keeps a caption's leading "C ", the
    manifest layout strips it, so one corpus gives two language embeddings."""
    h5 = build_synthetic_corpus(str(tmp_path / "c.hdf5"), n_videos=2, length=8, hw=(32, 32))
    (tmp_path / "m").mkdir()
    manifest = build_synthetic_corpus(str(tmp_path / "m"), n_videos=2, length=8, hw=(32, 32))
    for buffer in (JaxMCRBuffer, MCRBuffer):
        labels = {buffer(p, seed=0).sample()[1] for p in (h5, manifest)}
        assert {lab[:2] == "C " for lab in labels} == {True, False}, labels
    kept, stripped = (MCRBuffer(p, seed=0).sample()[1] for p in (h5, manifest))
    assert kept == "C " + stripped
    for enc in (JaxLangEncoder(), LangEncoder(device="cpu")):
        a, b = enc.get_lang_emb([kept, stripped])
        assert float(np.dot(a, b)) < 0.5
