"""The image protocol's host side in the port: the worker loaders and
``make_loaders``' choice of them (against the JAX package's), the
prediction-MSE metrics (against ``lipvq_tpu/utils/vis_utils.py`` on the same
predictions) and ``scripts/train.py`` over a small image export with worker
processes and the MSE visualizer on, its checkpoints reloaded bit-equal."""

import gc
import json
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.utils import train_utils as jax_train_utils
from lipvq_tpu.utils import vis_utils as jax_vis_utils
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.dataset import SequenceDataset
from lipvq_tpu_torch.data.loaders import DataLoader, MultiprocessLoader, PrefetchLoader
from lipvq_tpu_torch.scripts import train as train_script
from lipvq_tpu_torch.utils import file_utils, train_utils, vis_utils
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides, make_synthetic_export

torch.set_num_threads(1)

CAM = "robot0_agentview_left_image"


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    """6 demos x 30 steps: low-dim keys and one 24 x 24 uint8 camera."""
    return make_synthetic_export(str(tmp_path_factory.mktemp("images") / "export"),
                                 n_demos=6, demo_len=30, image_key_shapes={CAM: (24, 24, 3)})


def _window_dataset(root):
    """One-step windows: item i's actions row identifies i."""
    return SequenceDataset(root, obs_keys=("robot0_eef_pos", CAM), dataset_keys=("actions",),
                           frame_stack=1, seq_length=1, hdf5_cache_mode=None)


def _indices(ds, batch):
    rows = {ds[i]["actions"].tobytes(): i for i in range(len(ds))}
    return [rows[a.tobytes()] for a in batch["actions"]]


def test_prefetch_loader_yields_the_data_loaders_batches(export):
    ds = _window_dataset(export)
    want = list(DataLoader(ds, 8, seed=3))
    got = list(PrefetchLoader(DataLoader(ds, 8, seed=3)))
    assert len(got) == len(want) == len(ds) // 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["actions"], b["actions"])
        np.testing.assert_array_equal(a["obs"][CAM], b["obs"][CAM])
        assert a["obs"][CAM].dtype == np.uint8
    # an abandoned iteration stops its thread
    it = iter(PrefetchLoader(DataLoader(ds, 8, seed=3)))
    next(it)
    it.close()


@pytest.mark.parametrize("workers", [2, min((os.cpu_count() or 1) + 1, 12)],
                         ids=["2", "many"])
def test_multiprocess_loader_epochs(export, workers):
    """Each epoch yields every index of the seeded permutation's batches
    exactly once (in completion order), epoch after epoch, with 2 workers
    and with more workers than cores (up to 12); the frames arrive uint8
    and equal to the dataset's."""
    ds = _window_dataset(export)
    loader = MultiprocessLoader(ds, 8, seed=5, num_workers=workers)
    rng = np.random.default_rng(5)
    shm_before = set(os.listdir("/dev/shm"))
    procs_before = len(multiprocessing.active_children())
    def want():
        order = rng.permutation(len(ds))
        return {frozenset(order[b * 8:(b + 1) * 8].tolist()) for b in range(len(ds) // 8)}

    try:
        for _ in range(2):
            batches = list(loader)
            got = [_indices(ds, b) for b in batches]
            assert {frozenset(g) for g in got} == want() and len(got) == len(ds) // 8
            np.testing.assert_array_equal(batches[0]["obs"][CAM][3],
                                          ds[got[0][3]]["obs"][CAM])
        # an abandoned epoch's batches do not leak into the next one
        it = iter(loader)
        next(it)
        it.close()
        want()
        got = [frozenset(_indices(ds, b)) for b in loader]
        assert set(got) == want() and len(got) == len(ds) // 8
        assert len(multiprocessing.active_children()) == procs_before + workers
    finally:
        loader.close()
    assert len(multiprocessing.active_children()) == procs_before
    # every batch's shared-memory block is unlinked, the abandoned ones too
    # (the worker queues' semaphores go once their feeder threads have ended
    # and their objects are collected)
    for _ in range(100):
        gc.collect()
        if set(os.listdir("/dev/shm")) <= shm_before:
            break
        time.sleep(0.1)
    assert set(os.listdir("/dev/shm")) <= shm_before


def test_multiprocess_loader_raises_a_workers_failure(export, tmp_path):
    """A worker whose reads fail sends the failure back: the loader raises
    it, naming the indices, rather than hang."""
    import shutil

    root = shutil.copytree(export, tmp_path / "export")
    ds = _window_dataset(str(root))
    os.remove(root / "data" / "demo_0" / "actions.npy")
    loader = MultiprocessLoader(ds, 8, seed=5, num_workers=2)
    try:
        with pytest.raises(RuntimeError, match="data worker failed on indices"):
            list(loader)
    finally:
        loader.close()


@pytest.mark.parametrize("workers,want", [(0, "DataLoader"), (1, "PrefetchLoader"),
                                          (5, "MultiprocessLoader")])
def test_make_loaders_picks_the_jax_packages_loader(export, workers, want):
    ds = _window_dataset(export)
    got = []
    for factory, utils in ((jax_config_factory, jax_train_utils),
                           (config_factory, train_utils)):
        cfg = factory("icl", {"train": {"num_data_workers": workers, "batch_size": 8}})
        loaders = utils.make_loaders(cfg, ds, None)
        got.append(type(loaders[0]).__name__)
        if hasattr(loaders[0], "shutdown"):
            loaders[0].shutdown()
    assert got == [want, want]
    # the device cache needs the model: without one both packages fall back
    # to the host loader (the cache itself: tests/test_torch_port_device_cache.py)
    got = [type(utils.make_loaders(factory("icl", {"train": {"hdf5_cache_mode": "device"}}),
                                   ds, None)[0]).__name__
           for factory, utils in ((jax_config_factory, jax_train_utils),
                                  (config_factory, train_utils))]
    assert got == ["DataLoader", "DataLoader"]


def test_mse_metrics_match_jax():
    rng = np.random.default_rng(0)
    pred = rng.standard_normal((40, 12)).astype(np.float32)
    true = pred + rng.standard_normal((40, 12)).astype(np.float32) * 10.0 ** rng.integers(
        -4, 0, (40, 12))
    assert vis_utils.compute_mse_metrics(pred, true) == jax_vis_utils.compute_mse_metrics(
        pred, true)


class _Policy:
    """A deterministic stand-in policy (the same in both packages' calls):
    its action is the mean of the window's first obs row, tiled."""

    def process_batch_for_training(self, batch):
        return {"obs": batch["obs"], "actions": np.asarray(batch["actions"])[:, :2]}

    def get_action(self, obs, context_batch=None):
        x = obs["robot0_eef_pos"][:, 0].mean(-1, keepdims=True)
        if context_batch is not None:
            x = x + context_batch["actions"].mean()
        return np.repeat(x, 12, axis=-1)


@pytest.mark.parametrize("icl", [False, True])
def test_mse_visualize_matches_jax(export, tmp_path, icl):
    ds = SequenceDataset(export, obs_keys=("robot0_eef_pos",), dataset_keys=("actions",),
                         frame_stack=1, seq_length=3, hdf5_cache_mode="all")
    ctx = DataLoader(ds, 1, seed=2, drop_last=False) if icl else None
    jax_ctx = DataLoader(ds, 1, seed=2, drop_last=False) if icl else None
    got = vis_utils.compute_mse_visualize(_Policy(), ds, num_samples=7,
                                          savedir=str(tmp_path), context_loader=ctx)
    want = jax_vis_utils.compute_mse_visualize(_Policy(), ds, num_samples=7,
                                               context_loader=jax_ctx)
    assert got == want and set(got) == {"action_mse", "action_accuracy@0.001",
                                        "action_accuracy@0.0001", "action_accuracy@1e-05"}
    assert os.path.isfile(tmp_path / "model_prediction.png")


def _script_config(export, out):
    cfg = icl_test_config_overrides()
    cfg["algo_name"] = "icl"
    cfg["train"].update({"data": export, "output_dir": out, "num_epochs": 2, "batch_size": 4,
                         "num_data_workers": 2, "hdf5_cache_mode": None, "seed": 1,
                         "hdf5_load_next_obs": False})
    cfg["experiment"].update({"name": "visual", "epoch_every_n_steps": 2, "validate": False,
                              "mse": {"enabled": True, "every_n_epochs": 1,
                                      "num_samples": 3, "visualize": True}})
    cfg["algo"]["transformer"].update({"num_layers": 1, "compute_dtype": "float32"})
    cfg["algo"]["vq"]["num_codes"] = 16
    cfg["observation"]["modalities"]["obs"]["rgb"] = [CAM]
    cfg["observation"]["encoder"] = {"rgb": {
        "core_class": "VisualCoreLanguageConditioned",
        "core_kwargs": {"feature_dimension": 16, "backbone_class": "ResNet18ConvFiLM",
                        "pool_kwargs": {"num_kp": 8}},
        "obs_randomizer_class": "CropRandomizer",
        "obs_randomizer_kwargs": {"crop_height": 20, "crop_width": 20, "num_crops": 1}}}
    return cfg


def test_train_script_on_an_image_export(export, tmp_path, monkeypatch):
    """2 epochs x 2 steps with 2 worker processes and the MSE visualizer on:
    checkpoints each epoch, finite MSE logs and their plot; the last
    checkpoint reloads into an algo bit-equal to the one that trained,
    BatchNorm statistics (moved off their init) included."""
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(_script_config(export, str(tmp_path / "out"))))
    seen = {}
    run_epoch = train_utils.run_epoch

    def observed(model, loader, epoch, validate=False, num_steps=None):
        seen["algo"], seen["loader"] = model, loader
        return run_epoch(model, loader, epoch, validate=validate, num_steps=num_steps)

    monkeypatch.setattr(train_utils, "run_epoch", observed)
    procs_before = len(multiprocessing.active_children())
    ckpt_dir = train_script.main(["--config", str(cfg_path), "--device", "cpu"])
    # the script stopped the loader's worker processes
    assert isinstance(seen["loader"], MultiprocessLoader)
    assert len(multiprocessing.active_children()) == procs_before
    names = sorted(os.listdir(ckpt_dir))
    assert {"model_epoch_1.ckpt", "model_epoch_2.ckpt", "latest_full.state"} <= set(names)
    exp_dir = os.path.dirname(ckpt_dir)
    with open(os.path.join(exp_dir, "logs", "scalars.json")) as f:
        logs = json.load(f)
    assert len(logs["MSE/action_mse"]) == 2 and np.isfinite(logs["MSE/action_mse"]).all()
    assert os.path.isfile(os.path.join(exp_dir, "videos", "mse_epoch_2", "model_prediction.png"))

    algo = seen["algo"]
    reloaded, _ = file_utils.policy_from_checkpoint(os.path.join(ckpt_dir, "model_epoch_2.ckpt"),
                                                    device="cpu")
    want = algo.nets.state_dict()
    got = reloaded.nets.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    var = f"net.encoder.group_encoder.enc_obs.core_{CAM}.backbone.layer2_0.bn1.var"
    assert not torch.equal(got[var], torch.ones_like(got[var]))
    fresh = algo_factory("icl", file_utils.config_from_checkpoint(
        file_utils.load_checkpoint_dict(os.path.join(ckpt_dir, "model_epoch_2.ckpt"))),
        reloaded.obs_key_shapes, ac_dim=reloaded.ac_dim, device="cpu")
    fresh.deserialize_full(torch.load(os.path.join(ckpt_dir, "latest_full.state"),
                                      weights_only=True))
    for k, v in fresh.nets.state_dict().items():
        assert torch.equal(v, want[k]), k
