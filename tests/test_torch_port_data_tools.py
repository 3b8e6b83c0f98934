"""Port parity of the dataset tools and conversion scripts: the port's tools
work over exports (``data/export.py``), the JAX package's over HDF5 files.

- ``split_train_val``, ``filter_dataset_size`` and ``get_dataset_info`` run
  on ``make_synthetic_export`` and the JAX tools on the same fixture as HDF5
  (``make_synthetic_dataset``): the masks and the info dict must be equal,
  and the info printed alike.
- Each converter and editor: the port's output export must equal
  ``hdf5_to_export`` of the JAX tool's output file, array for array (values,
  dtypes, shapes) and attribute for attribute, the masks included.
- Each tool's ``main`` takes the JAX script's flags.
"""

import contextlib
import io
import json
import sys

import h5py
import numpy as np
import pytest

from lipvq_tpu.scripts import filter_dataset_size as jax_filter
from lipvq_tpu.scripts import get_dataset_info as jax_info
from lipvq_tpu.scripts import split_train_val as jax_split
from lipvq_tpu.scripts.conversion import convert_d4rl as jax_d4rl
from lipvq_tpu.scripts.conversion import convert_r2d2 as jax_r2d2
from lipvq_tpu.scripts.conversion import convert_robosuite as jax_robosuite
from lipvq_tpu.scripts.conversion import copy_ds_key as jax_copy
from lipvq_tpu.scripts.conversion import remove_mg_env_label as jax_remove_mg
from lipvq_tpu.scripts.conversion import set_dataset_attr as jax_set_attr
from lipvq_tpu.scripts.conversion.extract_action_dict import (
    extract_action_dict as jax_extract_action_dict,
)
from lipvq_tpu.utils.test_utils import make_synthetic_dataset
from lipvq_tpu_torch.data.export import META, Export, hdf5_to_export, update_meta
from lipvq_tpu_torch.scripts import filter_dataset_size, get_dataset_info, split_train_val
from lipvq_tpu_torch.scripts.conversion import (
    convert_d4rl,
    convert_r2d2,
    convert_robosuite,
    copy_ds_key,
    remove_mg_env_label,
    set_dataset_attr,
)
from lipvq_tpu_torch.scripts.conversion.extract_action_dict import extract_action_dict
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

N_DEMOS, DEMO_LEN = 12, 15


@pytest.fixture()
def pair(tmp_path):
    """(HDF5 file, export) of the same synthetic fixture."""
    h5 = make_synthetic_dataset(str(tmp_path / "d.hdf5"), n_demos=N_DEMOS, demo_len=DEMO_LEN)
    export = make_synthetic_export(str(tmp_path / "export"), n_demos=N_DEMOS,
                                   demo_len=DEMO_LEN)
    return h5, export


def _jax_masks(h5) -> dict:
    with h5py.File(h5, "r") as f:
        return {k: [e.decode("utf-8") for e in np.asarray(v[()])] for k, v in f["mask"].items()}


def assert_exports_equal(got_root: str, want_root: str) -> None:
    """Every demo, attribute, array (value, dtype, shape) and mask equal."""
    got, want = Export(got_root), Export(want_root)
    assert got.data_attrs == want.data_attrs
    assert sorted(got.demos) == sorted(want.demos)
    for demo in want.demos:
        assert got.demo_attrs(demo) == want.demo_attrs(demo), demo
        keys = sorted(want._demos[demo]["arrays"])
        assert sorted(got._demos[demo]["arrays"]) == keys, demo
        for key in keys:
            a, b = got.load(demo, key), want.load(demo, key)
            assert a.dtype == b.dtype and a.shape == b.shape, (demo, key)
            np.testing.assert_array_equal(a, b, err_msg=f"{demo}/{key}")
    assert {k: got.mask(k) for k in got.masks} == {k: want.mask(k) for k in want.masks}


@pytest.mark.parametrize("ratio,filter_key,seed", [
    (0.1, None, 0), (0.25, None, 3), (0.5, "train", 1), (0.01, "valid", 0)])
def test_split_train_val_matches_jax(pair, ratio, filter_key, seed):
    h5, export = pair
    want = jax_split.split_train_val_from_hdf5(h5, ratio, filter_key, seed)
    got = split_train_val.split_train_val_from_export(export, ratio, filter_key, seed)
    assert got == want
    jax_masks = _jax_masks(h5)
    assert {k: Export(export).mask(k) for k in Export(export).masks} == jax_masks
    prefix = f"{filter_key}_" if filter_key else ""
    assert len(jax_masks[f"{prefix}valid"]) == want[1] >= 1


@pytest.mark.parametrize("mask", ["train", "valid", "3_demos"])
def test_tool_masks_select_the_same_items_as_jax(pair, mask):
    """The split's and the subset's masks, read by each package's
    ``SequenceDataset`` (``hdf5_filter_key``), give the same demos and
    items."""
    from lipvq_tpu.data.dataset import SequenceDataset as JaxSequenceDataset
    from lipvq_tpu_torch.data.dataset import SequenceDataset

    h5, export = pair
    jax_split.split_train_val_from_hdf5(h5, 0.25, None, 0)
    split_train_val.split_train_val_from_export(export, 0.25, None, 0)
    jax_filter.filter_dataset_size(h5, [3])
    filter_dataset_size.filter_dataset_size(export, [3])
    kwargs = dict(obs_keys=("robot0_eef_pos", "object"), frame_stack=2, seq_length=3,
                  hdf5_cache_mode="low_dim", filter_by_attribute=mask)
    want = JaxSequenceDataset(hdf5_path=h5, **kwargs)
    got = SequenceDataset(hdf5_path=export, **kwargs)
    assert got.demos == want.demos == sorted(_jax_masks(h5)[mask], key=lambda d: int(d[5:]))
    assert len(got) == len(want) == DEMO_LEN * len(want.demos)
    for i in (0, len(got) // 2, len(got) - 1):
        a, b = got[i], want[i]
        np.testing.assert_array_equal(a["actions"], b["actions"])
        for k in kwargs["obs_keys"]:
            np.testing.assert_array_equal(a["obs"][k], b["obs"][k])


def test_filter_dataset_size_matches_jax(pair):
    h5, export = pair
    jax_filter.filter_dataset_size(h5, [1, 4, N_DEMOS], seed=2)
    filter_dataset_size.filter_dataset_size(export, [1, 4, N_DEMOS], seed=2)
    e = Export(export)
    assert {k: e.mask(k) for k in e.masks} == _jax_masks(h5)
    assert e.mask("4_demos") == sorted(e.mask("4_demos"), key=lambda d: int(d[5:]))
    for tool, root in ((jax_filter.filter_dataset_size, h5),
                       (filter_dataset_size.filter_dataset_size, export)):
        with pytest.raises(AssertionError):
            tool(root, [N_DEMOS + 1])


def test_dataset_info_matches_jax(pair):
    """The same dict and the same printout, after a split and a subset whose
    masks an export keeps in the order they were written (h5py lists them by
    name)."""
    h5, export = pair
    for split, subset, root in ((jax_split.split_train_val_from_hdf5,
                                 jax_filter.filter_dataset_size, h5),
                                (split_train_val.split_train_val_from_export,
                                 filter_dataset_size.filter_dataset_size, export)):
        split(root, 0.2, "train", 0)
        subset(root, [10, 3])
    assert Export(export).masks != sorted(Export(export).masks)
    want = jax_info.dataset_info(h5)
    got = get_dataset_info.dataset_info(export)
    assert got == want
    assert json.dumps(got, indent=2) == json.dumps(want, indent=2)
    assert got["filter_keys"] == ["10_demos", "3_demos", "train", "train_train",
                                  "train_valid", "valid"]
    outs = []
    for main, root in ((jax_info.main, h5), (get_dataset_info.main, export)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if main is jax_info.main:
                argv, sys.argv = sys.argv, ["get_dataset_info", "--dataset", root]
                try:
                    main()
                finally:
                    sys.argv = argv
            else:
                main(["--dataset", root])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def _d4rl_buffer(path, next_obs: bool, n=60, seed=0):
    rng = np.random.default_rng(seed)
    terminals = np.zeros(n)
    terminals[[9, 10, 33]] = 1  # a 1-step episode at 10 is dropped
    timeouts = np.zeros(n)
    timeouts[[20, 45]] = 1
    arrays = dict(observations=rng.standard_normal((n, 11)),
                  actions=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                  rewards=rng.standard_normal((n, 1)), terminals=terminals,
                  timeouts=timeouts)
    if next_obs:
        arrays["next_observations"] = rng.standard_normal((n, 11)).astype(np.float32)
    if path.endswith(".npz"):
        np.savez(path, **arrays)
    else:
        with h5py.File(path, "w") as f:
            for k, v in arrays.items():
                f.create_dataset(k, data=v)
    return path


@pytest.mark.parametrize("suffix,next_obs", [(".npz", False), (".npz", True), (".hdf5", False)])
def test_convert_d4rl_matches_jax(tmp_path, suffix, next_obs):
    buf = _d4rl_buffer(str(tmp_path / f"buffer{suffix}"), next_obs)
    h5 = str(tmp_path / "jax.hdf5")
    want = jax_d4rl.convert_d4rl(buf, "Hopper-v4", h5)
    got = convert_d4rl.convert_d4rl(buf, "Hopper-v4", str(tmp_path / "port"))
    assert got == want == 5
    assert_exports_equal(str(tmp_path / "port"), hdf5_to_export(h5, str(tmp_path / "want")))
    e = Export(str(tmp_path / "port"))
    assert json.loads(e.data_attrs["env_args"]) == {"env_name": "Hopper-v4", "type": 2,
                                                   "env_kwargs": {}}
    assert e.data_attrs["total"] == 59
    # dones come from the terminals only: the timeout-ended demo_1 has none
    assert not e.load("demo_1", "dones").any() and e.load("demo_2", "dones")[-1] == 1


def _droid_file(path, n=30, extra=True):
    rng = np.random.default_rng(4)
    with h5py.File(path, "w") as f:
        rs = f.create_group("observation").create_group("robot_state")
        rs.create_dataset("cartesian_position", data=rng.standard_normal((n, 6)))
        rs.create_dataset("gripper_position", data=rng.random(n).astype(np.float32))
        if extra:
            rs.create_dataset("joint_positions", data=rng.standard_normal((n, 7)))
            rs.create_dataset("joint_torques", data=rng.standard_normal((n - 1, 7)))
            rs.create_dataset("mode", data=np.arange(n))
        act = f.create_group("action")
        key = "cartesian_velocity" if extra else "cartesian_position"
        act.create_dataset(key, data=rng.standard_normal((n, 6)).astype(np.float32))
        act.create_dataset("gripper_position", data=rng.random((n, 1)))
    return path


@pytest.mark.parametrize("extra,lang", [(True, "pick up the cup"), (False, "")])
def test_convert_r2d2_matches_jax(tmp_path, extra, lang):
    raw = _droid_file(str(tmp_path / "droid.h5"), extra=extra)
    h5 = str(tmp_path / "jax.hdf5")
    assert jax_r2d2.convert_r2d2(raw, h5, lang) == 1
    assert convert_r2d2.convert_r2d2(raw, str(tmp_path / "port"), lang) == 1
    assert_exports_equal(str(tmp_path / "port"), hdf5_to_export(h5, str(tmp_path / "want")))
    e = Export(str(tmp_path / "port"))
    assert e.has("demo_0", "obs/robot0_joint_positions") == extra
    assert not e.has("demo_0", "obs/robot0_joint_torques")


def _raw_robosuite(path, env_attr: bool, mask: bool):
    rng = np.random.default_rng(9)
    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        if env_attr:
            data.attrs["env"] = "OpenDrawer"
        data.attrs["date"] = "2024-01-01"
        for i, n in enumerate((10, 7, 12)):
            g = data.create_group(f"demo_{i + 1 if i else 10}")
            g.create_dataset("actions", data=rng.standard_normal((n, 12)).astype(np.float32))
            g.create_dataset("states", data=rng.standard_normal((n, 20)))
            if i == 1:
                g.attrs["num_samples"] = n
        if mask:
            f.create_dataset("mask/picked", data=np.array([b"demo_1"]))
    return path


@pytest.mark.parametrize("env_attr,mask,env_name,env_kwargs", [
    (True, False, None, None), (False, True, "CloseDrawer", {"layout_ids": [1]})])
def test_convert_robosuite_matches_jax(tmp_path, env_attr, mask, env_name, env_kwargs):
    raw = _raw_robosuite(str(tmp_path / "raw.hdf5"), env_attr, mask)
    port_out = str(tmp_path / "port")
    got = convert_robosuite.convert_robosuite(raw, port_out, env_name, env_kwargs)
    want = jax_robosuite.convert_robosuite(raw, env_name, env_kwargs)  # stamps raw in place
    assert got == want
    assert_exports_equal(port_out, hdf5_to_export(raw, str(tmp_path / "want")))
    e = Export(port_out)
    assert e.masks == (["picked"] if mask else ["all"])
    if not mask:  # sorted by name, as the JAX script sorts them
        assert e.mask("all") == ["demo_10", "demo_2", "demo_3"]


def test_copy_ds_keys_matches_jax(tmp_path):
    pairs = []
    for which in ("src", "target"):
        h5 = make_synthetic_dataset(str(tmp_path / f"{which}.hdf5"), n_demos=4, demo_len=9,
                                    seed=int(which == "target"))
        export = make_synthetic_export(str(tmp_path / which), n_demos=4, demo_len=9,
                                       seed=int(which == "target"))
        pairs.append((h5, export))
    (src_h5, src), (tgt_h5, tgt) = pairs
    jax_extract_action_dict(src_h5)
    extract_action_dict(src)
    # the target lacks demo_3, so its keys are not copied
    with h5py.File(tgt_h5, "a") as f:
        del f["data/demo_3"]
    meta_path = f"{tgt}/{META}"
    meta = json.load(open(meta_path))
    del meta["demos"]["demo_3"]
    json.dump(meta, open(meta_path, "w"))
    keys = ["action_dict", "actions", "obs/object", "no_such_key"]
    assert copy_ds_key.copy_ds_keys(src, tgt, keys) == jax_copy.copy_ds_keys(src_h5, tgt_h5,
                                                                               keys) == 9
    assert_exports_equal(tgt, hdf5_to_export(tgt_h5, str(tmp_path / "want")))
    np.testing.assert_array_equal(Export(tgt).load("demo_1", "actions"),
                                  Export(src).load("demo_1", "actions"))


@pytest.mark.parametrize("attr,value", [
    ("env_args.env_name", "MG_OpenDrawer"), ("env_args.env_kwargs", '{"seed": 3}'),
    ("total", "17"), ("note", "a plain string"), ("weights", "[1.5, 2.5]")])
def test_set_attr_and_remove_mg_label_match_jax(pair, tmp_path, attr, value):
    h5, export = pair
    jax_set_attr.set_attr(h5, attr, value)
    set_dataset_attr.set_attr(export, attr, value)
    assert_exports_equal(export, hdf5_to_export(h5, str(tmp_path / "want")))
    assert remove_mg_env_label.remove_mg_label(export) == jax_remove_mg.remove_mg_label(h5)
    assert_exports_equal(export, hdf5_to_export(h5, str(tmp_path / "want_mg")))
    if value.startswith("MG_"):
        assert json.loads(Export(export).data_attrs["env_args"])["env_name"] == "OpenDrawer"


def test_update_meta_keeps_the_other_entries(tmp_path):
    root = make_synthetic_export(str(tmp_path / "e"), n_demos=3, demo_len=4)
    update_meta(root, masks={"train": ["demo_2"], "new": ["demo_0"]},
                data_attrs={"total": 5, "note": np.int64(3)},
                demo_attrs={"demo_1": {"num_samples": np.int64(2)}})
    e = Export(root)
    assert e.masks == ["train", "valid", "new"] and e.mask("train") == ["demo_2"]
    assert e.data_attrs["total"] == 5 and e.data_attrs["note"] == 3
    assert json.loads(e.data_attrs["env_args"])["env_name"] == "SyntheticKitchen"
    assert e.demo_attrs("demo_1")["num_samples"] == 2 and "ep_meta" in e.demo_attrs("demo_1")
    with pytest.raises(KeyError):
        update_meta(root, demo_attrs={"demo_9": {}})


def test_add_absolute_actions_matches_jax(tmp_path):
    """Replay-based absolute actions over a kitchen demo the JAX collector
    wrote, where ``mujoco`` imports (as the JAX package's test)."""
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa.env_utils import create_env
    from lipvq_tpu.robocasa.sim.scripted import make_scripted_policy
    from lipvq_tpu.scripts.collect_demos import collect_demo, write_demos
    from lipvq_tpu.scripts.conversion.robosuite_add_absolute_actions import (
        add_absolute_actions as jax_add_absolute_actions,
    )
    from lipvq_tpu_torch.scripts.conversion.robosuite_add_absolute_actions import (
        add_absolute_actions,
    )

    env = create_env("CloseDrawer", seed=3)
    traj, success = collect_demo(env, None, 500, np.random.default_rng(0),
                                 policy_factory=lambda e: make_scripted_policy("CloseDrawer", e))
    assert success
    traj["ep_meta"] = env.get_ep_meta()
    h5 = str(tmp_path / "kitchen.hdf5")
    write_demos(h5, env, [traj])
    env.close()
    export = hdf5_to_export(h5, str(tmp_path / "export"))
    assert jax_add_absolute_actions(h5) == add_absolute_actions(export) == 1
    assert_exports_equal(export, hdf5_to_export(h5, str(tmp_path / "want")))
    abs_a = Export(export).load("demo_0", "actions_abs")
    rel_a = Export(export).load("demo_0", "actions")
    np.testing.assert_array_equal(abs_a[:, 6], np.clip(rel_a[:, 6], -1, 1).astype(np.float32))


def test_tool_mains_take_the_jax_flags(pair, tmp_path, capsys):
    _, export = pair
    split_train_val.main(["--dataset", export, "--ratio", "0.25", "--filter_key", "train"])
    filter_dataset_size.main(["--dataset", export, "--sizes", "2", "5"])
    set_dataset_attr.main(["--dataset", export, "--attr", "env_args.env_name",
                           "--value", "MG_Lift"])
    remove_mg_env_label.main(["--dataset", export])
    buf = _d4rl_buffer(str(tmp_path / "b.npz"), False)
    convert_d4rl.main(["--buffer", buf, "--env_name", "Hopper-v4", "--output",
                       str(tmp_path / "d4rl")])
    convert_r2d2.main(["--dataset", _droid_file(str(tmp_path / "droid.h5")), "--output",
                       str(tmp_path / "r2d2"), "--lang", "wipe"])
    convert_robosuite.main(["--dataset", _raw_robosuite(str(tmp_path / "raw.hdf5"), True, False),
                            "--output", str(tmp_path / "rs"), "--env_name", "OpenDrawer",
                            "--env_kwargs", '{"seed": 1}'])
    copy_ds_key.main(["--src", str(tmp_path / "d4rl"), "--target", export, "--keys", "obs"])
    out = capsys.readouterr().out
    for line in ("train: 8 demos, valid: 2 demos", "wrote filter keys for sizes [2, 5]",
                 "set env_args.env_name on", "env_name is now 'Lift'", "wrote 5 demos to",
                 "wrote 1 demo(s) to", "stamped env_args: {'env_name': 'OpenDrawer'",
                 "copied 5 key instances"):
        assert line in out, (line, out)
    e = Export(export)
    assert e.mask("5_demos") and json.loads(e.data_attrs["env_args"])["env_name"] == "Lift"
    assert json.loads(Export(str(tmp_path / "r2d2")).demo_attrs("demo_0")["ep_meta"]) == {
        "lang": "wipe"}
