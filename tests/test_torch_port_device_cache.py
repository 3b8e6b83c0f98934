"""Port twins of ``tests/test_device_cache.py``: the device-resident corpus
(``train.hdf5_cache_mode="device"``, ``data/loaders.py::DeviceCachedLoader``)
on the CPU, held against the host path and against the JAX package's loader
on the same fixture (the JAX reads the HDF5 file, the port its export).

Everything compared here is data, not arithmetic: batches are held bit for
bit (the host path's ``process_batch_for_training`` of the same items, and
the JAX loader's batch for the same seed), the sampling weights to 1e-12
(float64 sums of the same weights). Plus ``DevicePrefetchLoader`` and
``R2D2Dataset``."""

import glob
import os

import numpy as np
import pytest
import torch

import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
from lipvq_tpu.config import config_factory as jax_config_factory
from lipvq_tpu.data.loaders import DeviceCachedLoader as JaxDeviceCachedLoader
from lipvq_tpu.utils import obs_utils as jax_obs_utils
from lipvq_tpu.utils import train_utils as jax_train_utils
from lipvq_tpu.utils.file_utils import get_shape_metadata_from_dataset as jax_shape_meta
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data.dataset import SequenceDataset
from lipvq_tpu_torch.data.loaders import DataLoader, DeviceCachedLoader, DevicePrefetchLoader
from lipvq_tpu_torch.utils import obs_utils
from lipvq_tpu_torch.utils import train_utils
from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
from lipvq_tpu_torch.utils.tensor_utils import stack_collate
from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides, make_synthetic_export

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus_pair(tmp_path_factory):
    """The fixture of ``tests/test_device_cache.py`` in both formats:
    (HDF5 a, HDF5 b), (export a, export b) with the same arrays."""
    root = tmp_path_factory.mktemp("device_cache")
    shapes = {"n_demos": 4, "demo_len": 30}, {"n_demos": 2, "demo_len": 60}
    h5 = tuple(make_synthetic_dataset(str(root / f"{n}.hdf5"), **kw)
               for n, kw in zip("ab", shapes))
    ex = tuple(make_synthetic_export(str(root / n), **kw) for n, kw in zip("ab", shapes))
    return h5, ex


def _build(overrides, data, tmp_path):
    d = icl_test_config_overrides()
    d["train"].update({"data": data, "output_dir": str(tmp_path), **overrides})
    cfg = config_factory("icl", d)
    obs_utils.initialize_obs_utils_with_config(cfg)
    first = data[0]["path"] if isinstance(data, list) else data
    sm = get_shape_metadata_from_dataset(first, all_obs_keys=cfg.all_obs_keys)
    model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device="cpu")
    train_ds, _ = train_utils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"])
    return cfg, model, train_ds


def _build_jax(overrides, data, tmp_path):
    d = icl_test_config_overrides()
    d["train"].update({"data": data, "output_dir": str(tmp_path), **overrides})
    cfg = jax_config_factory("icl", d)
    jax_obs_utils.initialize_obs_utils_with_config(cfg)
    first = data[0]["path"] if isinstance(data, list) else data
    sm = jax_shape_meta(first, all_obs_keys=cfg.all_obs_keys)
    model = jax_algo_factory("icl", cfg, obs_key_shapes=sm["all_shapes"], ac_dim=sm["ac_dim"])
    train_ds, _ = jax_train_utils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"])
    return cfg, model, train_ds


def _leaves(tree, path=()):
    """{path: numpy array} of a batch tree (None leaves skipped)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _leaves(v, path + (k,)).items()}
    if tree is None:
        return {}
    return {path: tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)}


def test_device_cache_batches_match_host_path(corpus_pair, tmp_path):
    """A gathered batch is bit-equal to the host path's
    ``process_batch_for_training`` of the same items and to the JAX loader's
    batch of the same indices; the first batch of an iteration draws the JAX
    loader's indices from the same seed; item-constant leaves (the corpus's
    one ``lang_emb``) shrink to a small table."""
    (a_h5, _), (a, _) = corpus_pair
    _, model, ds = _build({"hdf5_cache_mode": "device"}, a, tmp_path)
    loader = DeviceCachedLoader(ds, batch_size=4, model=model, seed=0)
    idx = np.array([0, 3, 7, 11])
    got = _leaves(loader.gather(idx))
    want = _leaves(model.process_batch_for_training(stack_collate([ds[int(i)] for i in idx])))
    assert got.keys() == want.keys() and ("obs", "lang_emb") in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert min(len(t) for t in loader._tables) < loader._n
    assert all(t.device == model.device for t in loader._tables)

    _, jax_model, jax_ds = _build_jax({"hdf5_cache_mode": "device"}, a_h5, tmp_path)
    jax_loader = JaxDeviceCachedLoader(jax_ds, batch_size=4, model=jax_model, seed=0)
    assert loader._n == jax_loader._n
    jax_got = _leaves(jax_loader.gather(idx))
    assert jax_got.keys() == got.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], jax_got[k], err_msg=str(k))
    first, jax_first = _leaves(next(iter(loader))), _leaves(next(iter(jax_loader)))
    for k in first:
        np.testing.assert_array_equal(first[k], jax_first[k], err_msg=str(k))


def test_device_cache_trains_and_matches_loss_scale(corpus_pair, tmp_path):
    """run_epoch over the device loader: batches are not processed again,
    the losses are finite; the context loader stays a host loader."""
    _, (a, _) = corpus_pair
    cfg, model, ds = _build({"hdf5_cache_mode": "device"}, a, tmp_path)
    loader, _, ctx = train_utils.make_loaders(cfg, ds, None, model=model)
    assert isinstance(loader, DeviceCachedLoader) and loader.preprocessed
    assert not getattr(ctx, "preprocessed", False)
    calls = []
    process = model.process_batch_for_training
    model.process_batch_for_training = lambda b: calls.append(1) or process(b)
    log = train_utils.run_epoch(model, loader, epoch=1, num_steps=3)
    assert not calls
    assert np.isfinite(log["Loss"]) and log["Time_Process_Batch"] >= 0
    # without a model the mode falls back to a host loader, as in JAX
    assert isinstance(train_utils.make_loaders(cfg, ds, None)[0], DataLoader)


def test_device_cache_preserves_metadataset_weights(corpus_pair, tmp_path):
    """A MetaDataset's weights carry over: the loader draws from the
    sampler's per-item probabilities, the JAX loader's (to 1e-12), each
    corpus holding half the mass in the balanced mode."""
    (a_h5, b_h5), (a, b) = corpus_pair
    over = {"hdf5_cache_mode": "device", "normalize_weights_by_ds_size": True}

    def data(x, y):
        return [{"path": x, "weight": 1.0}, {"path": y, "weight": 1.0}]

    d = icl_test_config_overrides()
    d["train"].update({"data": data(a, b), "output_dir": str(tmp_path), **over})
    cfg = config_factory("icl", d)
    obs_utils.initialize_obs_utils_with_config(cfg)
    sm = get_shape_metadata_from_dataset(a, all_obs_keys=cfg.all_obs_keys)
    model = algo_factory("icl", cfg, sm["all_shapes"], ac_dim=sm["ac_dim"], device="cpu")
    ds, _ = train_utils.load_data_for_training(cfg, obs_keys=sm["all_obs_keys"])
    loader, _, _ = train_utils.make_loaders(cfg, ds, None, model=model)
    p = loader._p
    assert p is not None and np.isclose(p.sum(), 1.0)
    n_a = len(ds.datasets[0])
    assert np.isclose(p[:n_a].sum(), 0.5, atol=1e-6)
    idx = loader._rng.choice(len(ds), size=256, replace=True, p=p)
    assert (idx < n_a).any() and (idx >= n_a).any()

    jcfg = jax_config_factory("icl", {**d, "train": {**d["train"], "data": data(a_h5, b_h5)}})
    jax_obs_utils.initialize_obs_utils_with_config(jcfg)
    jsm = jax_shape_meta(a_h5, all_obs_keys=jcfg.all_obs_keys)
    jmodel = jax_algo_factory("icl", jcfg, obs_key_shapes=jsm["all_shapes"],
                              ac_dim=jsm["ac_dim"])
    jds, _ = jax_train_utils.load_data_for_training(jcfg, obs_keys=jsm["all_obs_keys"])
    jloader, _, _ = jax_train_utils.make_loaders(jcfg, jds, None, model=jmodel)
    np.testing.assert_allclose(p, jloader._p, rtol=0, atol=1e-12)


def test_device_cache_train_e2e(corpus_pair, tmp_path):
    """The training script with the device cache over a MetaDataset: a
    checkpoint is written."""
    from lipvq_tpu_torch.scripts.train import train

    _, (a, b) = corpus_pair
    d = icl_test_config_overrides()
    d["train"].update({"data": [{"path": a, "weight": 1.0}, {"path": b, "weight": 1.0}],
                       "hdf5_cache_mode": "device", "output_dir": str(tmp_path),
                       "cuda": False})
    ckpt_dir = train(config_factory("icl", d))
    assert glob.glob(os.path.join(ckpt_dir, "*.ckpt"))


def test_device_cache_rejects_oversized_corpus(corpus_pair, tmp_path):
    _, (a, _) = corpus_pair
    cfg, model, ds = _build({"hdf5_cache_mode": "device"}, a, tmp_path)
    with pytest.raises(ValueError, match="GB"):
        DeviceCachedLoader(ds, batch_size=4, model=model, max_bytes=1)
    with cfg.unlocked():
        cfg.train.group_task_batches = True
    with pytest.raises(ValueError, match="group_task_batches"):
        train_utils.make_loaders(cfg, ds, None, model=model)


def test_device_prefetch_loader_yields_the_inner_batches(corpus_pair):
    """``DevicePrefetchLoader`` on the CPU: the inner loader's batches (after
    the transform), in order, as tensors on the device, None kept."""
    _, (a, _) = corpus_pair
    ds = SequenceDataset(a, obs_keys=("robot0_eef_pos", "object"),
                                     seq_length=10, frame_stack=10)
    want = [_leaves(b) for b in DataLoader(ds, 4, seed=3)]
    seen = []
    pre = DevicePrefetchLoader(DataLoader(ds, 4, seed=3), "cpu", size=2,
                               transform=lambda b: seen.append(1) or {**b, "goal_obs": None})
    got = list(pre)
    assert len(got) == len(want) == len(pre) == len(seen)
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in (*g["obs"].values(), g["actions"]))
        assert "goal_obs" in g and g["goal_obs"] is None
        for k in w:
            np.testing.assert_array_equal(_leaves(g)[k], w[k])


def test_r2d2_dataset_defers_to_sequence_dataset(corpus_pair):
    """Both of ``R2D2Dataset``'s branches are ``SequenceDataset``'s, in both
    packages: the same items as the plain dataset."""
    from lipvq_tpu.data.dataset import R2D2Dataset as JaxR2D2Dataset
    from lipvq_tpu_torch.data.dataset import R2D2Dataset

    (a_h5, _), (a, _) = corpus_pair
    kw = {"obs_keys": ("robot0_eef_pos", "object"), "seq_length": 4}
    plain, r2d2 = SequenceDataset(a, **kw), R2D2Dataset(a, gripper_dim=6, **kw)
    jax_r2d2 = JaxR2D2Dataset(a_h5, gripper_dim=6, **kw)
    assert len(plain) == len(r2d2) == len(jax_r2d2) == 120
    for i in (0, 57, 119):
        want, got, jax_item = _leaves(plain[i]), _leaves(r2d2[i]), _leaves(jax_r2d2[i])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], jax_item[k])
