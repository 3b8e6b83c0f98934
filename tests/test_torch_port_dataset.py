"""Port parity of the data slice: the numpy export and its converter, the
port's ``SequenceDataset``/``MetaDataset`` against the JAX package's on the
same fixture (the JAX HDF5 from ``make_synthetic_dataset``; the port reads
its ``hdf5_to_export`` conversion and ``make_synthetic_export``'s direct
write), the samplers, the dataset metadata, the hash language encoder and
the loader factory. Every item, stat and index stream must be exactly
equal: both sides run the same numpy code on the same arrays."""

import json
import os

import h5py
import numpy as np
import pytest

from lipvq_tpu.data.dataset import MetaDataset as JaxMetaDataset
from lipvq_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
from lipvq_tpu.data.loaders import DataLoader as JaxDataLoader
from lipvq_tpu.utils import file_utils as jax_file_utils
from lipvq_tpu.utils.lang_utils import LangEncoder as JaxLangEncoder
from lipvq_tpu.utils.tensor_utils import pad_sequence_single as jax_pad_sequence_single
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.data import export as export_mod
from lipvq_tpu_torch.data.dataset import MetaDataset, SequenceDataset
from lipvq_tpu_torch.data.export import Export, ExportArray, hdf5_to_export
from lipvq_tpu_torch.data.loaders import DataLoader
from lipvq_tpu_torch.utils import file_utils
from lipvq_tpu_torch.utils import train_utils
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.tensor_utils import pad_sequence_single
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

OBS_KEYS = ("robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos", "object",
            "lang_emb")
N_DEMOS, DEMO_LEN = 12, 20  # demo_10 and demo_11 sort after demo_9


def _add_next_obs(path):
    """next_obs/<k> = obs shifted one step (the last frame repeated)."""
    with h5py.File(path, "a") as f:
        for demo in f["data"]:
            g = f["data"][demo]
            for k in g["obs"]:
                obs = g["obs"][k][()]
                g.create_dataset(f"next_obs/{k}", data=np.concatenate([obs[1:], obs[-1:]]))
    return path


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """{name: (JAX HDF5 path, port export dir)}: "converted" and "rich" are
    hdf5_to_export conversions ("rich" adds next_obs), "written" is
    make_synthetic_export's direct write of the same fixture."""
    root = tmp_path_factory.mktemp("data")
    h5 = make_synthetic_dataset(str(root / "plain.hdf5"), n_demos=N_DEMOS,
                                demo_len=DEMO_LEN, seed=0)
    rich = _add_next_obs(make_synthetic_dataset(str(root / "rich.hdf5"), n_demos=N_DEMOS,
                                                demo_len=DEMO_LEN, seed=0))
    return {
        "converted": (h5, hdf5_to_export(h5, str(root / "converted"))),
        "written": (h5, make_synthetic_export(str(root / "written"), n_demos=N_DEMOS,
                                              demo_len=DEMO_LEN, seed=0)),
        "rich": (rich, hdf5_to_export(rich, str(root / "rich"))),
    }


def _assert_same(got, want, path="item"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


@pytest.mark.parametrize("source", ["converted", "written"])
def test_export_holds_the_hdf5_file(sources, source):
    """Every array (dtype, shape, bits), attribute and mask of the HDF5
    fixture, with 1-D arrays kept 1-D and byte-string masks as str."""
    h5, root = sources[source]
    ex = Export(root)
    with h5py.File(h5, "r") as f:
        assert json.loads(ex.data_attrs["env_args"]) == json.loads(f["data"].attrs["env_args"])
        assert ex.data_attrs["total"] == int(f["data"].attrs["total"])
        assert sorted(ex.demos) == sorted(f["data"])
        for name in f["mask"]:
            assert ex.mask(name) == [e.decode() for e in f["mask"][name][()]]
        for demo in f["data"]:
            g = f["data"][demo]
            attrs = ex.demo_attrs(demo)
            assert attrs["num_samples"] == int(g.attrs["num_samples"])
            assert type(attrs["num_samples"]) is int
            assert json.loads(attrs["ep_meta"]) == json.loads(g.attrs["ep_meta"])
            keys = []
            g.visititems(lambda n, o: keys.append(n) if isinstance(o, h5py.Dataset) else None)
            assert sorted(ex._demos[demo]["arrays"]) == sorted(keys)
            for key in keys:
                want = g[key][()]
                got = ex.load(demo, key)
                assert got.dtype == want.dtype and got.shape == want.shape, key
                np.testing.assert_array_equal(got, want)
            assert ex.shape(demo, "rewards") == (DEMO_LEN,)


def test_export_reads_rows_without_holding_files(sources):
    ex = Export(sources["converted"][1])
    fds = len(os.listdir("/proc/self/fd"))
    full = ex.load("demo_3", "obs/object")
    arr = ExportArray(ex, "demo_3", "obs/object")
    for begin, end in [(0, 1), (5, 12), (15, 40), (0, DEMO_LEN)]:
        np.testing.assert_array_equal(arr[begin:end], full[begin:end])
    np.testing.assert_array_equal(np.asarray(arr, np.float64), full.astype(np.float64))
    np.testing.assert_array_equal(ex.read("demo_3", "rewards", 2, 7), np.zeros(5, np.float32))
    assert arr.ndim == 2 and len(arr) == DEMO_LEN
    with pytest.raises(TypeError, match="contiguous"):
        arr[::2]
    ds = SequenceDataset(sources["converted"][1], OBS_KEYS, hdf5_cache_mode=None,
                         frame_stack=3, seq_length=4)
    for i in range(len(ds)):
        ds[i]
    assert len(os.listdir("/proc/self/fd")) == fds


def test_export_errors_and_cli(sources, tmp_path):
    with pytest.raises(FileNotFoundError, match="lipvq_tpu_torch.data.export"):
        Export(str(tmp_path))
    with pytest.raises(KeyError, match="no array"):
        Export(sources["converted"][1]).path("demo_0", "obs/nothing")
    out = tmp_path / "cli"
    export_mod.main([sources["converted"][0], str(out)])
    assert Export(str(out)).demos == Export(sources["converted"][1]).demos


# (id, sources, SequenceDataset kwargs)
DATASET_CASES = [
    ("flagship_all", ("converted", "written"),
     dict(frame_stack=10, seq_length=10, hdf5_cache_mode="all")),
    ("unpadded_none_minmax_train", ("converted", "written"),
     dict(frame_stack=3, seq_length=4, pad_frame_stack=False, pad_seq_length=False,
          hdf5_cache_mode=None, filter_by_attribute="train", get_pad_mask=True,
          action_config={"actions": {"normalization": "min_max"}})),
    ("lowdim_gaussian_valid_two_keys", ("converted", "written"),
     dict(frame_stack=1, seq_length=5, pad_seq_length=False, hdf5_cache_mode="low_dim",
          filter_by_attribute="valid", dataset_keys=("actions", "rewards"),
          action_keys=("actions", "rewards"),
          action_config={"actions": {"normalization": "gaussian"},
                         "rewards": {"normalization": "min_max"}})),
    ("goal_next_obs_all", ("rich",),
     dict(frame_stack=4, seq_length=2, hdf5_cache_mode="all", goal_mode="last",
          load_next_obs=True, get_pad_mask=True)),
    ("goal_next_obs_none_lang", ("rich",),
     dict(frame_stack=2, seq_length=3, pad_frame_stack=False, hdf5_cache_mode=None,
          goal_mode="last", load_next_obs=True, dataset_lang="open the drawer")),
    ("goal_lowdim_demos", ("rich",),
     dict(frame_stack=5, seq_length=1, hdf5_cache_mode="low_dim", goal_mode="last",
          demos=["demo_11", "demo_2", "demo_10"])),
]


@pytest.mark.parametrize("case,source", [(c[0], s) for c in DATASET_CASES for s in c[1]])
def test_sequence_dataset_items_equal_jax(sources, case, source):
    kwargs = dict(next(c[2] for c in DATASET_CASES if c[0] == case))
    h5, root = sources[source]
    want = JaxSequenceDataset(h5, OBS_KEYS, lang_encoder=JaxLangEncoder(), **kwargs)
    got = SequenceDataset(root, OBS_KEYS, lang_encoder=LangEncoder(), **kwargs)
    assert got.demos == want.demos and len(got) == len(want) > 0
    for i in range(len(want)):
        _assert_same(got[i], want[i], f"item {i}")
    _assert_same(got.get_action_normalization_stats(), want.get_action_normalization_stats())
    _assert_same(got.get_obs_normalization_stats(), want.get_obs_normalization_stats())
    if case == "goal_lowdim_demos":
        assert got.demos == ["demo_2", "demo_10", "demo_11"]
    want.close()  # the JAX dataset's HDF5 handle


def _meta_pair(tmp_path, weights, normalize=False):
    """(JAX MetaDataset, port MetaDataset) over two datasets of other sizes."""
    specs = [(0, 8, 20), (1, 5, 33)]
    jax_ds, port_ds = [], []
    for seed, n, length in specs:
        h5 = make_synthetic_dataset(str(tmp_path / f"m{seed}.hdf5"), n_demos=n,
                                    demo_len=length, seed=seed, lang=f"task {seed}")
        root = make_synthetic_export(str(tmp_path / f"m{seed}"), n_demos=n, demo_len=length,
                                     seed=seed, lang=f"task {seed}")
        kw = dict(frame_stack=3, seq_length=3, hdf5_cache_mode="low_dim",
                  action_config={"actions": {"normalization": "min_max"}})
        jax_ds.append(JaxSequenceDataset(h5, OBS_KEYS, **kw))
        port_ds.append(SequenceDataset(root, OBS_KEYS, **kw))
    return (JaxMetaDataset(jax_ds, ds_weights=weights, normalize_weights_by_ds_size=normalize),
            MetaDataset(port_ds, ds_weights=weights, normalize_weights_by_ds_size=normalize))


@pytest.mark.parametrize("weights,normalize,batch_size", [
    ([1.0, 1.0], False, None), ([1.0, 3.0], False, None), ([1.0, 1.0], True, None),
    ([2.0, 1.0], False, 8)], ids=["uniform", "weighted", "by_size", "task_paired"])
def test_meta_dataset_sampler_and_batches_equal_jax(tmp_path, weights, normalize, batch_size):
    want, got = _meta_pair(tmp_path, weights, normalize)
    assert len(got) == len(want)
    _assert_same(got.get_action_normalization_stats(), want.get_action_normalization_stats())
    w_s = want.get_dataset_sampler(seed=3, batch_size=batch_size)
    g_s = got.get_dataset_sampler(seed=3, batch_size=batch_size)
    assert (w_s is None) == (g_s is None) == (weights == [1.0, 1.0] and not normalize
                                               and batch_size is None)
    if w_s is not None:
        assert type(g_s).__name__ == type(w_s).__name__ and len(g_s) == len(w_s)
        for _ in range(2):
            assert list(g_s) == list(w_s)
        w_s = want.get_dataset_sampler(seed=3, batch_size=batch_size)
        g_s = got.get_dataset_sampler(seed=3, batch_size=batch_size)
    w_it = iter(JaxDataLoader(want, 8, seed=5, sampler=w_s))
    g_it = iter(DataLoader(got, 8, seed=5, sampler=g_s))
    for _ in range(3):
        _assert_same(next(g_it), next(w_it))


def test_meta_dataset_refuses_cache_all(sources):
    root = sources["converted"][1]
    ds = [SequenceDataset(root, OBS_KEYS, hdf5_cache_mode="all") for _ in range(2)]
    with pytest.raises(AssertionError, match="hdf5_cache_mode='all'"):
        MetaDataset(ds)


@pytest.mark.parametrize("all_obs_keys", [None, OBS_KEYS])
@pytest.mark.parametrize("action_keys", [("actions",), ("actions", "rewards")])
def test_dataset_metadata_equals_jax(sources, all_obs_keys, action_keys):
    h5, root = sources["converted"]
    assert file_utils.get_env_metadata_from_dataset(root) == \
        jax_file_utils.get_env_metadata_from_dataset(h5)
    got = file_utils.get_shape_metadata_from_dataset(root, all_obs_keys, action_keys)
    want = jax_file_utils.get_shape_metadata_from_dataset(h5, all_obs_keys, action_keys)
    assert got == want and list(got["all_shapes"]) == list(want["all_shapes"])


def test_hash_lang_embedding_equals_jax():
    texts = ["pick the object and place it in the sink", "", "open the drawer"]
    got, want = LangEncoder(), JaxLangEncoder()
    np.testing.assert_array_equal(got.get_lang_emb(texts), want.get_lang_emb(texts))
    np.testing.assert_array_equal(got.get_lang_emb(texts[0]), want.get_lang_emb(texts[0]))
    assert got.get_lang_emb(texts).dtype == np.float32
    assert got.backend == want.backend == "hash"


def test_lang_encoder_raises_where_jax_would_use_clip(tmp_path, monkeypatch):
    """Where the JAX package would embed with CLIP (weights cached, or a
    download allowed), the port loads its own CLIP text tower, recorded as
    "clip_flax" (JAX's name for the same function of the same weights). The
    tower runs on CUDA unless the encoder is given a device, so without a
    GPU an encoder given none raises; with ``device="cpu"`` it embeds. Where
    the weights do not load, both fall back to the hash embedding. No
    download is attempted: the loader is faked."""
    import torch

    from lipvq_tpu_torch.models import clip_text
    from lipvq_tpu_torch.models.base_nets import seeded_init

    snap = tmp_path / "models--openai--clip-vit-large-patch14" / "snapshots" / "abc"
    snap.mkdir(parents=True)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path))
    # an empty snapshot: neither package loads weights from it
    texts = ["open the drawer", "close it"]
    got, want = LangEncoder(), JaxLangEncoder()
    np.testing.assert_array_equal(got.get_lang_emb(texts), want.get_lang_emb(texts))
    assert got.backend == want.backend == "hash"

    cfg = clip_text.CLIPTextConfig(vocab_size=50, hidden_size=16, num_layers=1, num_heads=2,
                                   intermediate_size=32, max_positions=8, projection_dim=768,
                                   eos_token_id=49)
    tower = seeded_init(clip_text.CLIPTextTower(cfg), torch.Generator().manual_seed(0))
    ids = torch.tensor([[3, 4, 49, 49], [5, 49, 49, 49]])
    calls = []

    def loader(name, local_files_only=True):
        calls.append(local_files_only)
        return tower, lambda strings, padding, return_tensors: {"input_ids": ids}

    monkeypatch.setattr(clip_text, "load_pretrained_clip", loader)
    if not torch.cuda.is_available():
        # the tower runs on CUDA unless the encoder is given a device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LangEncoder().get_lang_emb(texts)
        calls.clear()
    enc = LangEncoder(device="cpu")
    emb = enc.get_lang_emb(texts)
    assert enc.backend == "clip_flax" and calls == [True]
    with torch.no_grad():
        np.testing.assert_array_equal(emb, tower(ids).numpy())

    def offline(name, local_files_only=True):
        calls.append(local_files_only)
        raise OSError("no weights")

    monkeypatch.setattr(clip_text, "load_pretrained_clip", offline)
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty"))
    monkeypatch.setenv("LIPVQ_ALLOW_DOWNLOAD", "1")
    calls.clear()
    assert LangEncoder().backend == "hash"
    assert calls == [True, False]  # the local cache first, then the allowed download


@pytest.mark.parametrize("padding,pad_same", [((0, 0), True), ((3, 0), True), ((0, 2), True),
                                              ((2, 4), False), ((1, 1), False)])
def test_pad_sequence_single_equals_jax(padding, pad_same):
    seq = np.random.default_rng(1).standard_normal((5, 3, 2)).astype(np.float32)
    _assert_same(pad_sequence_single(seq, padding, pad_same, pad_values=-1.0),
                 jax_pad_sequence_single(seq, padding, pad_same, pad_values=-1.0))


def _loader_config(data, **train):
    cfg = config_factory("icl", {"train": {"data": data, "batch_size": 4, **train}})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
    return cfg


@pytest.mark.parametrize("train", [{"hdf5_cache_mode": "device"}], ids=["device_cache"])
def test_unported_loaders_raise(sources, train):
    """The device cache, which raised here until it was ported, no longer
    raises: the dataset caches low_dim for it; without a model the train
    loader is the host ``DataLoader``, as in the JAX package, and with one
    the ``DeviceCachedLoader`` (tests/test_torch_port_device_cache.py)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DeviceCachedLoader

    cfg = _loader_config(sources["converted"][1], **train)
    train_ds, valid_ds = train_utils.load_data_for_training(cfg, obs_keys=OBS_KEYS)
    assert train_ds.hdf5_cache_mode == "low_dim"
    assert type(train_utils.make_loaders(cfg, train_ds, valid_ds)[0]) is DataLoader
    shapes = {k: list(np.asarray(train_ds[0]["obs"][k]).shape[1:]) for k in OBS_KEYS}
    small = config_factory("icl", {"algo": {
        "gmm": {"enabled": True}, "vq": {"num_codes": 8},
        "transformer": {"enabled": True, "embed_dim": 16, "num_layers": 1, "num_heads": 2,
                        "vq_vae_enabled": True, "ln_act_enabled": False}}})
    with small.unlocked():
        small.observation.modalities.obs.low_dim = list(OBS_KEYS)
    model = algo_factory("icl", small, shapes, ac_dim=12, device="cpu")
    loader = train_utils.make_loaders(cfg, train_ds, valid_ds, model=model)[0]
    assert isinstance(loader, DeviceCachedLoader) and loader._n == len(train_ds)


@pytest.mark.parametrize("workers,want", [(1, "PrefetchLoader"), (2, "MultiprocessLoader")],
                         ids=["prefetch", "multiprocess"])
def test_worker_loaders_yield_the_epochs_batches(sources, workers, want):
    """``train.num_data_workers`` 1 and 2: the loader the JAX package picks,
    an epoch of the same batches as the in-process loader's (as sets of
    index batches where workers return them in completion order)."""
    cfg = _loader_config(sources["converted"][1], num_data_workers=workers)
    train_ds, valid_ds = train_utils.load_data_for_training(cfg, obs_keys=OBS_KEYS)
    loader = train_utils.make_loaders(cfg, train_ds, valid_ds)[0]
    assert type(loader).__name__ == want
    try:
        got = [b["actions"].tobytes() for b in loader]
    finally:
        if hasattr(loader, "close"):
            loader.close()
    ref = [b["actions"].tobytes() for b in train_utils.DataLoader(
        train_ds, cfg.train.batch_size, seed=cfg.train.seed,
        sampler=loader.sampler if workers > 1 else loader.loader.sampler)]
    assert (sorted(got) == sorted(ref)) if workers > 1 else (got == ref)


def test_load_data_for_training_equals_jax(sources):
    from lipvq_tpu.config import config_factory as jax_config_factory
    from lipvq_tpu.utils import train_utils as jax_train_utils

    h5, root = sources["converted"]
    loaders = []
    for factory, tu, data in ((config_factory, train_utils, root),
                              (jax_config_factory, jax_train_utils, h5)):
        cfg = factory("icl", {"train": {
            "data": data, "batch_size": 4, "frame_stack": 3, "seq_length": 2,
            "hdf5_filter_key": "train", "hdf5_validation_filter_key": "valid",
            "action_config": {"actions": {"normalization": "min_max"}}},
            "experiment": {"validate": True}})
        with cfg.unlocked():
            cfg.observation.modalities.obs.low_dim = list(OBS_KEYS)
        train_ds, valid_ds = tu.load_data_for_training(cfg, obs_keys=OBS_KEYS)
        loaders.append(tu.make_loaders(cfg, train_ds, valid_ds))
    for got, want in zip(*loaders):
        g, w = iter(got), iter(want)
        for _ in range(2):
            _assert_same(next(g), next(w))
