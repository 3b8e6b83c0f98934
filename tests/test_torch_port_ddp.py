"""Data-parallel training in the port (``parallel/mesh.py``,
``Algo.attach_mesh``, ``train.num_devices``) against the JAX package's
2-device mesh and the port's single process.

Two gloo ranks on the CPU, spawned once for every case: each rank builds the
algo from the same config, loads the same weights (the JAX package's,
carried), attaches the mesh and trains 4 steps on the same global batches.
The cases: the flagship with the loss codebook and with the EMA codebook
(K2's counts and sums reduced; the codebook held), the image protocol's ICL
at a small width (the BatchNorm statistics held), a batch of 6 whose
halves do not divide by 2 (3 pairs: 2 and 1 per rank, so each rank's
losses are normalized by the global count), a batch of 2 (one rank holds no
pair and joins every collective with zeros), and the test config's dropout
0.1. Losses are held at rtol 1e-4, the tolerance of the JAX package's own
``tests/test_multichip_train.py``; parameters and buffers at rtol 1e-4 and
atol 2e-5 (Adam's eps argument of ``test_torch_port_train.py``).

The JAX trajectories run with dropout 0: the two packages' random streams
differ, so dropout masks cannot match across packages. Across layouts they
do: every rank draws the global batch's mask and takes its rows
(``mesh.draw_rows``), so the dropout case holds the 2-rank trajectory
against the port's single process.

Every one of the 13 algorithms, at a small width, and ICL with the bin
tokenizer (its running bounds are buffers), takes 2 steps in both ranks: the
parameters and buffers must be bit-equal across ranks. The MCR workspace
with ``num_devices=2`` builds the mesh and, as in the JAX package, does not
use it (reference fault (s)). The rank functions import no JAX.
"""

import contextlib
import copy
import glob
import os
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

WORLD, STEPS = 2, 4
LOSS_RTOL = 1e-4
STATE_TOL = {"rtol": 1e-4, "atol": 2e-5}
LOW_DIM = {"robot0_eef_pos": [3], "object": [14]}
SEQ = 20
# the 13 algorithms at small widths (tests/test_torch_port_isolation.py's)
ALGOS = {
    "bc": {"algo": {"gmm": {"enabled": True}, "actor_layer_dims": [16]}},
    "act": {"algo": {"act": {"hidden_dim": 16, "ff_dim": 16, "enc_layers": 1,
                             "dec_layers": 1}}},
    "diffusion_policy": {"algo": {"unet": {"down_dims": [16, 32]}}},
    "td3_bc": {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}},
    "iql": {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}},
    "cql": {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}},
    "bcq": {"algo": {"critic": {"layer_dims": [16]}}},
    "gl": {"algo": {"ae": {"planner_layer_dims": [16]}, "vae": {"enabled": True}}},
    "hbc": {"algo": {"planner": {"ae": {"planner_layer_dims": [16]}},
                     "actor": {"actor_layer_dims": [16]}}},
    "iris": {"algo": {"actor": {"actor_layer_dims": [16]}}},
    "mcr": {"algo": {"transformer": {"embed_dim": 16, "num_layers": 1, "num_heads": 2}}},
    "icl": {"algo": {"gmm": {"enabled": True},
                     "transformer": {"enabled": True, "embed_dim": 16, "num_layers": 1,
                                     "num_heads": 2, "vq_vae_enabled": True,
                                     "ln_act_enabled": False},
                     "vq": {"num_codes": 8, "ema_codebook": True}}},
    "icl_bin": {"algo": {"gmm": {"enabled": True},
                         "transformer": {"enabled": True, "embed_dim": 16, "num_layers": 1,
                                         "num_heads": 2, "bin_enabled": True,
                                         "ln_act_enabled": False}}},
    "icl_mamba": {"algo": {"gmm": {"enabled": True},
                           "mamba": {"enabled": True, "embed_dim": 16, "num_layers": 1,
                                     "vq_vae_enabled": True, "ln_act_enabled": False},
                           "vq": {"num_codes": 8}}},
}


# ---- the ranks (no JAX) -----------------------------------------------------
def _algo(config, shapes, ac_dim):
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.utils import obs_utils

    obs_utils.initialize_obs_utils_with_config(config)
    return algo_factory(config.algo_name, config, shapes, ac_dim=ac_dim, device="cpu")


def run_trajectory(case: dict, mesh=None) -> dict:
    """The case's algo from its weights, ``len(batches)`` steps: the losses
    and the final state."""
    algo = _algo(case["config"], case["shapes"], case["ac_dim"])
    algo.nets.load_state_dict(case["state"], strict=True)
    if mesh is not None:
        algo.attach_mesh(mesh)
    losses = [float(algo.train_on_batch(copy.deepcopy(b), 0)["losses"]["action_loss"])
              for b in case["batches"]]
    return {"losses": losses,
            "state": {k: v.clone() for k, v in algo.nets.state_dict().items()}}


def _raw_batch(rng, b: int) -> dict:
    return {"obs": {k: rng.standard_normal((b, SEQ, *s), dtype=np.float32)
                    for k, s in LOW_DIM.items()},
            "next_obs": {k: rng.standard_normal((b, SEQ, *s), dtype=np.float32)
                         for k, s in LOW_DIM.items()},
            "actions": rng.uniform(-0.9, 0.9, (b, SEQ, 12)).astype(np.float32),
            "rewards": rng.standard_normal((b, SEQ)).astype(np.float32),
            "dones": (rng.uniform(size=(b, SEQ)) < 0.3).astype(np.float32),
            "goal_obs": None}


def algo_config(name: str):
    from lipvq_tpu_torch.config import config_factory

    over = copy.deepcopy(ALGOS[name])
    over.setdefault("train", {}).update({"seq_length": SEQ, "batch_size": 4})
    cfg = config_factory(name.removesuffix("_bin"), over)
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(LOW_DIM)
    return cfg


def run_algo(name: str, mesh) -> dict:
    """Two steps of the algo at a small width: its state."""
    algo = _algo(algo_config(name), LOW_DIM, 12)
    algo.attach_mesh(mesh)
    rng = np.random.default_rng(5)
    for _ in range(2):
        algo.train_on_batch(algo.process_batch_for_training(_raw_batch(rng, 4)), 0)
    return {k: v.clone() for k, v in algo.nets.state_dict().items()}


def _mcr_losses(corpus: str, num_devices) -> list:
    from lipvq_tpu_torch.scripts.train_mcr_representation import RepresentationWorkspace

    ws = RepresentationWorkspace(corpus, embed_dim=16, batch_size=4, out_hw=(32, 32), seed=3,
                                 num_devices=num_devices, device="cpu")
    return [ws.mesh is not None] + [h["full_loss"] for h in ws.train(2, log_every=0)]


def _rank(rank: int, world: int, tmp: str) -> None:
    from lipvq_tpu_torch.parallel.mesh import init_group, make_mesh

    torch.set_num_threads(1)
    init_group(rank, world, os.path.join(tmp, "store"), torch.device("cpu"))
    try:
        spec = torch.load(os.path.join(tmp, "cases.pt"), weights_only=False)
        mesh = make_mesh(world, devices=["cpu"])
        out = {name: run_trajectory(case, mesh) for name, case in spec["cases"].items()}
        out["algos"] = {name: run_algo(name, mesh) for name in ALGOS}
        bad = spec["cases"]["loss"]
        algo = _algo(bad["config"], bad["shapes"], bad["ac_dim"])
        algo.attach_mesh(mesh)
        try:
            algo.train_on_batch(spec["odd_batch"], 0)
        except ValueError as e:
            out["divisibility"] = str(e)
        out["mcr"] = [_mcr_losses(spec["corpus"], None), _mcr_losses(spec["corpus"], 2)]
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- the parent: the JAX references and the comparisons ---------------------
def _jax_mesh_losses(jax_algo, start, batches) -> list:
    """The JAX algo's trajectory from ``start`` on a 2-device mesh."""
    import jax
    import jax.numpy as jnp

    from lipvq_tpu.parallel.mesh import make_mesh

    jax_algo.state = jax.tree.map(lambda a: jnp.array(a, copy=True), start)  # steps donate
    jax_algo.attach_mesh(make_mesh(WORLD))
    return [float(jax_algo.train_on_batch(copy.deepcopy(b), 0)["losses"]["action_loss"])
            for b in batches]


def _case(port, config, shapes, ac_dim, raws, batch=None):
    """A port case: config, weights and the processed batches (the first
    ``batch`` rows of each)."""
    from lipvq_tpu_torch.utils.tensor_utils import stack_collate

    raws = [stack_collate(r[:batch]) for r in raws]
    return {"config": config, "shapes": shapes, "ac_dim": ac_dim,
            "state": {k: v.clone() for k, v in port.nets.state_dict().items()},
            "batches": [port.process_batch_for_training(r) for r in raws]}, raws


def _flagship_cases() -> tuple[dict, dict]:
    """The flagship of ``test_torch_port_train.py`` with carried weights:
    the port cases and the JAX mesh trajectories."""
    from test_torch_port_train import AC_DIM, OBS_SHAPES, _config, _item, _pair

    from lipvq_tpu_torch.config import config_factory

    rng = np.random.default_rng(11)
    raws = [[_item(rng) for _ in range(8)] for _ in range(STEPS)]
    cases, jax_runs = {}, {}
    for ema in (False, True):
        jax_algo, port = _pair(ema)
        start = jax_algo.state
        for name, batch in ((("ema", 8),) if ema else (("loss", 8), ("b6", 6), ("b2", 2))):
            cfg = _config(config_factory, ema)
            cases[name], batch_raws = _case(port, cfg, OBS_SHAPES, AC_DIM, raws, batch)
            jax_runs[name] = _jax_mesh_losses(jax_algo, start, [
                jax_algo.process_batch_for_training(r) for r in batch_raws])
        if not ema:
            cfg = _config(config_factory, False)
            with cfg.unlocked():
                for key in ("emb_dropout", "attn_dropout", "block_output_dropout"):
                    cfg.algo.transformer[key] = 0.1  # the JAX test config's
            cases["dropout"], _ = _case(port, cfg, OBS_SHAPES, AC_DIM, raws)
    return cases, jax_runs


def _image_case() -> tuple[dict, list]:
    from test_torch_port_visual_algo import AC_DIM, BATCH, OBS_SHAPES, image_config
    from test_torch_port_visual_algo import image_items, image_pair

    from lipvq_tpu_torch.config import config_factory

    jax_algo, port = image_pair(ema=False)
    rng = np.random.default_rng(11)
    raws = [image_items(rng, BATCH) for _ in range(STEPS)]
    case, batch_raws = _case(port, image_config(config_factory, False), OBS_SHAPES, AC_DIM, raws)
    return case, _jax_mesh_losses(jax_algo, jax_algo.state, [
        jax_algo.process_batch_for_training(r) for r in batch_raws])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from lipvq_tpu_torch.algo.mcr_data import build_synthetic_corpus

    tmp = str(tmp_path_factory.mktemp("ddp"))
    cases, jax_runs = _flagship_cases()
    cases["image"], jax_runs["image"] = _image_case()
    first = cases["loss"]["batches"][0]  # 5 rows: not divisible by 2 ranks
    odd = {"obs": {k: v[:5] for k, v in first["obs"].items()}, "actions": first["actions"][:5],
           "goal_obs": None}
    corpus = build_synthetic_corpus(str(tmp_path_factory.mktemp("mcr")), n_videos=2, length=8,
                                    hw=(32, 32))
    torch.save({"cases": cases, "odd_batch": odd, "corpus": corpus},
               os.path.join(tmp, "cases.pt"))
    mp.spawn(_rank, args=(WORLD, tmp), nprocs=WORLD, join=True)
    ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    single = {name: run_trajectory(case) for name, case in cases.items()}
    return {"jax": jax_runs, "ranks": ranks, "single": single, "cases": cases, "odd": odd}


def _hold_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **STATE_TOL)


@pytest.mark.parametrize("name", ["loss", "ema", "image", "b6", "b2"])
def test_two_ranks_equal_the_jax_mesh_and_the_single_process(runs, name):
    ranks, single = runs["ranks"], runs["single"][name]
    for r in ranks:
        assert r[name]["losses"] == ranks[0][name]["losses"]
    np.testing.assert_allclose(ranks[0][name]["losses"], runs["jax"][name], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0][name]["losses"], single["losses"], rtol=LOSS_RTOL)
    _hold_state(ranks[0][name]["state"], single["state"])
    for k, v in ranks[0][name]["state"].items():
        assert torch.equal(ranks[1][name]["state"][k], v), k


def test_ema_codebook_statistics_are_reduced(runs):
    """K2's counts and sums are summed over the ranks before the EMA update:
    the EMA buffers and the codebook the update writes equal the single
    process's, and the 2-rank codebook moved from its start."""
    got, want = runs["ranks"][0]["ema"]["state"], runs["single"]["ema"]["state"]
    tok = "net.encoder.action_network."
    for leaf in ("ema_cluster_size", "ema_embed_sum", "quantizer.codebook"):
        np.testing.assert_allclose(got[tok + leaf].numpy(), want[tok + leaf].numpy(),
                                   **STATE_TOL)
    start = runs["cases"]["ema"]["state"][tok + "quantizer.codebook"]
    assert not torch.equal(got[tok + "quantizer.codebook"], start)
    # one rank alone would count half the rows: the sum over ranks counts all
    assert float(got[tok + "ema_cluster_size"].sum()) > 0


def test_batchnorm_statistics_are_global(runs):
    got, want = runs["ranks"][0]["image"]["state"], runs["single"]["image"]["state"]
    keys = [k for k in want if k.endswith((".mean", ".var")) and "bn" in k]
    assert keys
    start = runs["cases"]["image"]["state"]
    assert any(not torch.equal(got[k], start[k]) for k in keys)
    _hold_state({k: got[k] for k in keys}, {k: want[k] for k in keys})


def test_dropout_masks_match_across_layouts(runs):
    """The test config's dropout 0.1: the 2-rank trajectory equals the single
    process's (the masks are the global batch's); JAX's masks come from
    another random stream, so it is not compared."""
    got, want = runs["ranks"][0]["dropout"], runs["single"]["dropout"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    _hold_state(got["state"], want["state"])
    assert got["losses"] != runs["single"]["loss"]["losses"]  # dropout took part


@pytest.mark.parametrize("name", sorted(ALGOS))
def test_parameters_bit_equal_across_ranks(runs, name):
    a, b = (r["algos"][name] for r in runs["ranks"])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_divisibility_error_matches_jax(runs):
    """A batch of 5 over 2 ranks: the JAX package's message, word for word."""
    from test_torch_port_train import _pair

    from lipvq_tpu.parallel.mesh import make_mesh

    jax_algo, _ = _pair(False)
    jax_algo.attach_mesh(make_mesh(WORLD))
    with pytest.raises(ValueError) as e:
        jax_algo.train_on_batch(copy.deepcopy(runs["odd"]), 0)
    assert runs["ranks"][0]["divisibility"] == runs["ranks"][1]["divisibility"] == str(e.value)


def test_mcr_workspace_mesh_is_unused_in_both_packages(runs, tmp_path):
    """Reference fault (s): ``num_devices`` builds a mesh that nothing uses;
    the workspace takes the single-device step on every rank."""
    from lipvq_tpu.scripts.train_mcr_representation import (
        RepresentationWorkspace as JaxWorkspace,
    )

    for r in runs["ranks"]:
        single, meshed = r["mcr"]
        assert single[0] is False and meshed[0] is True
        assert meshed[1:] == single[1:]
    jax_ws = JaxWorkspace(_corpus(tmp_path), embed_dim=16, batch_size=4, out_hw=(32, 32),
                          seed=3, num_devices=WORLD)
    assert jax_ws.mesh is not None and jax_ws.mesh.shape["data"] == WORLD
    assert "mesh" not in JaxWorkspace._update_impl.__code__.co_names


def _corpus(tmp_path) -> str:
    from lipvq_tpu.algo.mcr_data import build_synthetic_corpus

    return build_synthetic_corpus(str(tmp_path / "corpus.hdf5"), n_videos=2, length=8,
                                  hw=(32, 32))


def test_train_script_with_two_ranks_writes_once_and_resumes(tmp_path):
    """``train.num_devices=2`` spawns two gloo ranks: each epoch's checkpoint
    and the full state are written once (rank 0), and a run resumed from
    that state with two ranks trains on."""
    from test_torch_port_script import _config_dict

    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.scripts import train as port_train
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=6, demo_len=30)
    d = _config_dict(export, str(tmp_path / "out"))
    d["train"]["num_devices"] = WORLD
    ckpt_dir = port_train.train(config_factory("icl", d), device="cpu")
    names = sorted(os.listdir(ckpt_dir))
    assert names.count("model_epoch_2.ckpt") == 1 and "latest_full.state" in names
    assert len(glob.glob(str(tmp_path / "out" / "*" / "*"))) == 1  # one run directory
    d["experiment"]["ckpt_path"] = os.path.join(ckpt_dir, "latest_full.state")
    resumed = port_train.train(config_factory("icl", d), device="cpu")
    assert "model_epoch_2.ckpt" in os.listdir(resumed)
    assert pathlib.Path(resumed) != pathlib.Path(ckpt_dir)


def test_more_cards_than_there_are_raises(monkeypatch, tmp_path):
    from test_torch_port_script import _config_dict

    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.scripts import train as port_train

    d = _config_dict(str(tmp_path / "none"), str(tmp_path))
    d["train"]["num_devices"] = 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 CUDA device"):
        port_train.train(config_factory("icl", d), device="cuda")
    with contextlib.suppress(Exception):
        dist.destroy_process_group()
