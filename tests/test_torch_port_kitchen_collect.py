"""The kitchen side of demonstration collection against the JAX package's,
and the env factory's routing.

Collection is numpy + mujoco in both packages, so the corpora are held
array for array, bit for bit, dtypes included: the JAX package's
``collect_task`` HDF5 file (after ``hdf5_to_export``) against the port's
export, ``action_dict`` and the coverage JSON included. The corpora committed
under ``lipvq_tpu_torch/assets/kitchen/`` and ``assets/kitchen_multi/`` must
regenerate byte for byte from the commands in their READMEs (the whole
multi-stage corpus under ``-m slow``).
"""

import filecmp
import json
import os
import sys

import h5py
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

from lipvq_tpu.robocasa import env_utils as jax_env_utils  # noqa: E402
from lipvq_tpu.scripts import collect_demos as jax_collect_demos  # noqa: E402
from lipvq_tpu.scripts import collect_kitchen_suite as jax_suite  # noqa: E402
from lipvq_tpu.scripts.conversion.extract_action_dict import (  # noqa: E402
    extract_action_dict as jax_extract_action_dict,
)

from lipvq_tpu_torch.data.export import Export, ExportWriter, hdf5_to_export  # noqa: E402
from lipvq_tpu_torch.envs.env_factory import create_env, create_env_from_metadata  # noqa: E402
from lipvq_tpu_torch.robocasa import env_utils  # noqa: E402
from lipvq_tpu_torch.robocasa.env_registry import REGISTERED_KITCHEN_ENVS as REGISTRY  # noqa: E402
from lipvq_tpu_torch.scripts import collect_demos, collect_kitchen_suite  # noqa: E402
from lipvq_tpu_torch.scripts.conversion.extract_action_dict import (  # noqa: E402
    extract_action_dict,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen")
MULTI_ASSET = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen_multi")
# the commands of lipvq_tpu_torch/assets/kitchen_multi/README.md: (tasks, seed)
MULTI_COMMANDS = ((("ArrangeVegetables", "PreSoakPan", "PrepareCoffee"), 0), (("RestockPantry",), 2))


def assert_exports_equal(got_root: str, want_root: str) -> int:
    """Every attribute and array of two exports equal, dtypes included;
    returns the number of demos."""
    got, want = Export(got_root), Export(want_root)
    assert got.data_attrs == want.data_attrs
    assert sorted(got.demos) == sorted(want.demos)
    for demo in want.demos:
        assert got.demo_attrs(demo) == want.demo_attrs(demo), demo
        keys = sorted(want._demos[demo]["arrays"])
        assert sorted(got._demos[demo]["arrays"]) == keys, demo
        for key in keys:
            g, w = got.load(demo, key), want.load(demo, key)
            assert g.dtype == w.dtype and g.shape == w.shape, (demo, key)
            assert np.array_equal(g, w), (demo, key)
    return len(want.demos)


def _jax_export(tmp_path, name: str, collect) -> str:
    """Run ``collect(hdf5_path)`` and convert its file into an export."""
    h5 = str(tmp_path / f"{name}.hdf5")
    collect(h5)
    return hdf5_to_export(h5, str(tmp_path / f"{name}_export"))


@pytest.mark.parametrize("task,kwargs", [
    ("OpenDrawer", {"seed": 3, "layout_ids": 0, "style_ids": 0}),
    ("CloseDrawer", {"seed": 1, "action_noise": 0.1, "dwell_prob": 0.1}),
    ("TurnOnSinkFaucet", {"seed": 0, "with_action_dict": False}),
    ("PrepareCoffee", {"seed": 0}),  # a multi-stage activity
])
def test_collect_task_matches_jax(tmp_path, task, kwargs):
    want = _jax_export(tmp_path, "jax", lambda p: jax_suite.collect_task(
        task, p, n_demos=3, max_steps=300, **kwargs))
    stats = collect_kitchen_suite.collect_task(task, str(tmp_path / "port"), n_demos=3,
                                               max_steps=300, **kwargs)
    assert stats["path"] == str(tmp_path / "port") and stats["demos"] >= 1
    assert assert_exports_equal(stats["path"], want) == stats["demos"]
    ex = Export(stats["path"])
    assert ex.has("demo_0", "action_dict/rel_rot_6d") == kwargs.get("with_action_dict", True)
    assert ex.demo_attrs("demo_0")["model_file"].startswith("<mujoco")
    with open(tmp_path / "port.coverage.json") as f, open(tmp_path / "jax.coverage.json") as g:
        assert json.load(f) == json.load(g)


def test_committed_corpus_regenerates_byte_equal(tmp_path):
    out = tmp_path / "kitchen"
    manifest = collect_kitchen_suite.main([
        "--output_dir", str(out), "--tasks", "OpenDrawer", "--n_demos", "8",
        "--max_steps", "300", "--seed", "3", "--layout_ids", "0", "--style_ids", "0"])
    assert [(m["task"], m["demos"]) for m in manifest] == [("OpenDrawer", 8)]
    files = []
    for root, _, names in os.walk(ASSET):
        files += [os.path.relpath(os.path.join(root, n), ASSET) for n in names]
    files = sorted(f for f in files if f not in ("README.md", "manifest.json"))
    got = []
    for root, _, names in os.walk(out):
        got += [os.path.relpath(os.path.join(root, n), out) for n in names]
    assert sorted(f for f in got if f != "manifest.json") == files
    for rel in files:
        assert filecmp.cmp(os.path.join(ASSET, rel), os.path.join(out, rel), shallow=False), rel
    with open(os.path.join(ASSET, "manifest.json")) as f:
        assert [dict(m, path=None) for m in json.load(f)] == [dict(m, path=None)
                                                               for m in manifest]


def test_committed_corpus_matches_jax_collection(tmp_path):
    """The JAX package's ``collect_task`` at the README's settings writes
    the committed arrays."""
    want = _jax_export(tmp_path, "jax", lambda p: jax_suite.collect_task(
        "OpenDrawer", p, n_demos=8, max_steps=300, seed=3, layout_ids=0, style_ids=0))
    assert assert_exports_equal(os.path.join(ASSET, "OpenDrawer"), want) == 8


def _assert_multi_stage_tasks_regenerate(out, tasks_by_seed) -> None:
    """Run the README's collection commands for ``tasks_by_seed`` into
    ``out``; each task's export and coverage JSON equal the committed files
    byte for byte."""
    for tasks, seed in tasks_by_seed:
        manifest = collect_kitchen_suite.main([
            "--output_dir", str(out), "--tasks", *tasks, "--n_demos", "3", "--max_steps", "1000",
            "--seed", str(seed)])
        assert [(m["task"], m["demos"]) for m in manifest] == [(t, 3) for t in tasks]
        for task in tasks:
            names = [task + ".coverage.json"]
            for root, _, files in os.walk(os.path.join(MULTI_ASSET, task)):
                names += [os.path.relpath(os.path.join(root, n), MULTI_ASSET) for n in files]
            got = [task + ".coverage.json"]
            for root, _, files in os.walk(os.path.join(out, task)):
                got += [os.path.relpath(os.path.join(root, n), out) for n in files]
            assert sorted(got) == sorted(names), task
            for rel in names:
                assert filecmp.cmp(os.path.join(MULTI_ASSET, rel), os.path.join(out, rel),
                                   shallow=False), rel


def test_committed_multi_stage_corpus_holds_prepare_coffee(tmp_path):
    """The README's first command, cut to PrepareCoffee (each task's collector
    seeds its own env), writes the committed PrepareCoffee files."""
    _assert_multi_stage_tasks_regenerate(tmp_path / "kitchen_multi", ((("PrepareCoffee",), 0),))


@pytest.mark.slow
def test_committed_multi_stage_corpus_regenerates_byte_equal(tmp_path):
    """Every task of the committed multi-stage corpus from the README's
    commands (slow: ~4 min on a CPU, PreSoakPan's and RestockPantry's
    experts fail and retry)."""
    out = tmp_path / "kitchen_multi"
    _assert_multi_stage_tasks_regenerate(out, MULTI_COMMANDS)
    committed = sorted(n for n in os.listdir(MULTI_ASSET) if n != "README.md")
    assert sorted(n for n in os.listdir(out) if n != "manifest.json") == committed


@pytest.mark.parametrize("ac_dim,with_abs", [(12, True), (7, True), (12, False)])
def test_extract_action_dict_matches_jax(tmp_path, ac_dim, with_abs):
    rng = np.random.default_rng(ac_dim)
    demos = {f"demo_{i}": {"actions": rng.uniform(-1, 1, (5 + i, ac_dim)).astype(np.float32)}
             for i in range(3)}
    if with_abs:
        for arrays in demos.values():
            arrays["actions_abs"] = rng.uniform(-1, 1, arrays["actions"].shape)
    h5 = str(tmp_path / "d.hdf5")
    with h5py.File(h5, "w") as f:
        for name, arrays in demos.items():
            g = f.create_group(f"data/{name}")
            for k, v in arrays.items():
                g.create_dataset(k, data=v)
            g.attrs["num_samples"] = len(arrays["actions"])
        f["data"].attrs["total"] = 3
    root = hdf5_to_export(h5, str(tmp_path / "export"))
    n_jax, n_port = jax_extract_action_dict(h5), extract_action_dict(root)
    assert n_port == n_jax == 3 * (1 + with_abs)
    assert assert_exports_equal(root, hdf5_to_export(h5, str(tmp_path / "want"))) == 3


def test_extract_action_dict_skips_an_export_without_actions(tmp_path):
    writer = ExportWriter(str(tmp_path / "x"))
    writer.add_demo("demo_0", {"num_samples": 2}, {"obs/a": np.zeros((2, 3), np.float32)})
    writer.finish({"total": 2}, {})
    assert extract_action_dict(str(tmp_path / "x")) == 0
    assert Export(str(tmp_path / "x")).keys("demo_0", "action_dict") == []


def test_collect_demos_main_kitchen_matches_jax(tmp_path, monkeypatch):
    """The scripted CLI on a kitchen task takes the task's expert in both;
    ``--device spacemouse`` raises ImportError naming ``hid`` in both (it is
    not installed here)."""
    args = ["--env", "CloseDrawer", "--n_demos", "2", "--max_steps", "200", "--seed", "2"]
    h5 = str(tmp_path / "demos.hdf5")
    monkeypatch.setattr(sys, "argv", ["collect_demos"] + args + ["--output", h5])
    jax_collect_demos.main()
    out = collect_demos.main(args + ["--output", str(tmp_path / "port")])
    assert assert_exports_equal(out, hdf5_to_export(h5, str(tmp_path / "want"))) == 2
    assert Export(out).demo_attrs("demo_0")["model_file"]
    errors = []
    monkeypatch.setattr(sys, "argv", ["collect_demos", "--output", str(tmp_path / "y.hdf5"),
                                      "--device", "spacemouse"])
    for run in (jax_collect_demos.main,
                lambda: collect_demos.main(["--output", str(tmp_path / "x"), "--device",
                                            "spacemouse"])):
        with pytest.raises(ImportError, match="`hid` package") as e:
            run()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_create_env_matches_jax():
    got = create_env("TurnOffStove", seed=4, layout_ids=2, style_ids=5)
    want = jax_env_utils.create_env("TurnOffStove", seed=4, layout_ids=2, style_ids=5)
    assert got.serialize() == want.serialize()
    g, w = got.reset(), want.reset()
    assert list(g) == list(w) and all(np.array_equal(g[k], w[k]) for k in w)
    assert got.get_ep_meta()["layout_id"] == 2 and got.get_ep_meta()["style_id"] == 5
    assert env_utils.create_env is create_env


def test_run_random_rollouts_matches_jax():
    kw = dict(num_rollouts=2, num_steps=15, seed=4)
    got = env_utils.run_random_rollouts(create_env("TurnOnMicrowave", seed=1), **kw)
    want = jax_env_utils.run_random_rollouts(jax_env_utils.create_env("TurnOnMicrowave",
                                                                      seed=1), **kw)
    assert got == want and got["average_horizon"] == 15.0


@pytest.mark.parametrize("name", ["PreSoakPan", "MicrowaveThawing", "ArrangeTea"])
def test_multi_stage_task_raises_naming_its_item(name):
    """A multi-stage task raised until the multi-stage kitchen was ported;
    now ``create_env``, the factory and (for the dataset registry's five
    multi-stage tasks) the env registry build it, equal to JAX's."""
    want = jax_env_utils.create_env(name, seed=0)
    w = want.reset()
    envs = [create_env(name, seed=0),
            create_env_from_metadata({"env_name": name, "type": 1, "env_kwargs": {"seed": 0}})]
    if name in REGISTRY:
        envs.append(REGISTRY[name](seed=0))
    for env in envs:
        g = env.reset()
        assert type(env).__name__ == "EnvKitchen" and env.serialize() == want.serialize()
        assert list(g) == list(w) and all(np.array_equal(g[k], w[k]) for k in w)
        assert env.ep_lang_str == want.ep_lang_str


@pytest.mark.parametrize("name", ["Lift", "PickPlaceCan"])
def test_unknown_robosuite_name_raises_naming_item_15(name):
    with pytest.raises(NotImplementedError, match="item 15"):
        create_env_from_metadata({"env_name": name, "type": 1})


def test_env_registry_builds_single_stage_kitchens():
    env = REGISTRY["OpenDrawer"](seed=3)
    assert type(env).__name__ == "EnvKitchen" and env.reset()["robot0_eef_pos"].shape == (3,)
    assert type(REGISTRY["SyntheticKitchen"](seed=0)).__name__ == "SyntheticKitchenEnv"
