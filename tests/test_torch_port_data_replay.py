"""State replay and playback over exports against the JAX package's scripts
over the same demos as HDF5.

``scripts/dataset_states_to_obs.py`` replays every stored state of a demo
through an env made from the dataset's ``env_args`` and writes the
observations, rewards and dones it reads; the port's export must hold the
JAX script's HDF5 arrays (after ``hdf5_to_export``), bit for bit, on the
committed OpenDrawer corpus and on multi-stage PrepareCoffee demos (with a
filter key). ``playback_trajectory`` must leave both packages' envs in the
same state, by states and by actions, and a worker that meets an exception
recreates its env and carries on, as JAX's does.
"""

import json
import os
import queue
import threading

import h5py
import numpy as np
import pytest

mujoco = pytest.importorskip("mujoco")

import lipvq_tpu.envs.env_factory as jax_factory  # noqa: E402
from lipvq_tpu.scripts import collect_kitchen_suite as jax_suite  # noqa: E402
from lipvq_tpu.scripts import dataset_states_to_obs as jax_s2o  # noqa: E402
from lipvq_tpu.scripts import playback_dataset as jax_playback  # noqa: E402
from test_torch_port_kitchen_collect import assert_exports_equal  # noqa: E402

import lipvq_tpu_torch.envs.env_factory as env_factory  # noqa: E402
from lipvq_tpu_torch.data.export import Export, hdf5_to_export  # noqa: E402
from lipvq_tpu_torch.scripts import dataset_states_to_obs as s2o  # noqa: E402
from lipvq_tpu_torch.scripts import playback_dataset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPEN_DRAWER = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen", "OpenDrawer")


def export_to_hdf5(root: str, h5_path: str) -> str:
    """Write an export's attributes, arrays and masks as a robomimic HDF5
    file (the inverse of ``hdf5_to_export``)."""
    ex = Export(root)
    with h5py.File(h5_path, "w") as f:
        data = f.create_group("data")
        for k, v in ex.data_attrs.items():
            data.attrs[k] = v
        for demo in ex.demos:
            g = data.create_group(demo)
            for k, v in ex.demo_attrs(demo).items():
                g.attrs[k] = v
            for key in ex._demos[demo]["arrays"]:
                g.create_dataset(key, data=ex.load(demo, key))
        for name in ex._masks:
            f.create_dataset(f"mask/{name}", data=np.array(ex.mask(name), dtype="S"))
    return h5_path


@pytest.fixture(scope="module")
def prepare_coffee(tmp_path_factory):
    """Two PrepareCoffee demos collected by the JAX package, as HDF5 (with a
    filter key naming the second) and as an export."""
    tmp = tmp_path_factory.mktemp("coffee")
    h5 = str(tmp / "PrepareCoffee.hdf5")
    stats = jax_suite.collect_task("PrepareCoffee", h5, n_demos=2, max_steps=300, seed=0)
    assert stats["demos"] == 2
    with h5py.File(h5, "a") as f:
        f.create_dataset("mask/second", data=np.array([b"demo_1"]))
    return h5, hdf5_to_export(h5, str(tmp / "PrepareCoffee"))


@pytest.mark.parametrize("corpus", ["OpenDrawer", "PrepareCoffee"])
def test_states_to_obs_matches_jax(corpus, prepare_coffee, tmp_path):
    if corpus == "OpenDrawer":
        h5, root, filter_key = export_to_hdf5(OPEN_DRAWER, str(tmp_path / "in.hdf5")), \
            OPEN_DRAWER, None
    else:
        (h5, root), filter_key = prepare_coffee, "second"
    out_h5 = str(tmp_path / "jax_obs.hdf5")
    jax_s2o.dataset_states_to_obs_multiprocessing(h5, out_h5, num_procs=2,
                                                  filter_key=filter_key)
    want = hdf5_to_export(out_h5, str(tmp_path / "want"))

    got = str(tmp_path / "port_obs")
    s2o.dataset_states_to_obs_multiprocessing(root, got, num_procs=2, filter_key=filter_key)
    n = assert_exports_equal(got, want)
    demos = Export(root).mask(filter_key) if filter_key else Export(root).demos
    assert n == len(demos)
    ex = Export(got)
    assert ex.data_attrs["env_args"] == Export(root).data_attrs["env_args"]
    for demo in demos:
        assert sorted(ex.keys(demo, "obs")) == sorted(Export(root).keys(demo, "obs"))
        assert ex.load(demo, "dones")[-1] == 1.0 and ex.load(demo, "dones")[:-1].sum() == 0


def test_states_to_obs_main_writes_beside_the_dataset(prepare_coffee, tmp_path):
    _, root = prepare_coffee
    out = s2o.main(["--dataset", root, "--output_name", "obs", "--num_procs", "1"])
    assert out == os.path.join(os.path.dirname(root), "obs")
    assert sorted(Export(out).demos) == ["demo_0", "demo_1"]
    assert Export(out).data_attrs["total"] == 2


@pytest.mark.parametrize("use_actions", [False, True])
def test_playback_trajectory_matches_jax(use_actions, prepare_coffee):
    h5, root = prepare_coffee
    ex = Export(root)
    env_meta = json.loads(ex.data_attrs["env_args"])
    env, jenv = (env_factory.create_env_from_metadata(env_meta),
                 jax_factory.create_env_from_metadata(env_meta))
    with h5py.File(h5, "r") as f:
        want = jax_playback.playback_trajectory(jenv, f["data/demo_1"], use_actions=use_actions)
    got = playback_dataset.playback_trajectory(env, s2o.read_demo(ex, "demo_1"),
                                               use_actions=use_actions)
    assert got == want == ex.demo_attrs("demo_1")["num_samples"]
    g, w = env.get_state(), jenv.get_state()
    assert g["model"] == w["model"] and np.array_equal(g["states"], w["states"])
    obs, jobs = env.get_observation(), jenv.get_observation()
    assert all(np.array_equal(obs[k], jobs[k]) for k in jobs) and list(obs) == list(jobs)
    if not use_actions:
        assert np.array_equal(g["states"], ex.load("demo_1", "states")[-1])
    assert playback_dataset.main(["--dataset", root, "--n", "1"] +
                                 ["--use-actions"] * use_actions) == {"demo_0": ex.demo_attrs(
                                     "demo_0")["num_samples"]}
    env.close()
    jenv.close()


def test_worker_recreates_its_env_after_an_exception(prepare_coffee, monkeypatch):
    """An exception while extracting demo_0 sends (demo_0, None, None),
    recreates the env and extracts demo_1 as a fresh worker does, in both
    packages; the writer then writes demo_1 alone."""
    h5, root = prepare_coffee
    env_meta = json.loads(Export(root).data_attrs["env_args"])
    fail_states = Export(root).load("demo_0", "states")
    assert len(fail_states) != len(Export(root).load("demo_1", "states"))

    def run(module, factory_module, dataset):
        made = []
        make = factory_module.create_env_from_metadata
        extract = module.extract_trajectory

        def counting(*args, **kwargs):
            made.append(1)
            return make(*args, **kwargs)

        def failing(env, demo, *args, **kwargs):
            if len(demo["states"]) == len(fail_states):
                raise RuntimeError("injected")
            return extract(env, demo, *args, **kwargs)

        monkeypatch.setattr(factory_module, "create_env_from_metadata", counting)
        monkeypatch.setattr(module, "extract_trajectory", failing)
        work, out = queue.Queue(), queue.Queue()
        for item in ("demo_0", "demo_1", None):
            work.put(item)
        module._worker(env_meta, dataset, work, out, (), 128, 128)
        return len(made), [out.get_nowait() for _ in range(2)]

    made, results = run(s2o, env_factory, root)
    jax_made, jax_results = run(jax_s2o, jax_factory, h5)
    assert made == jax_made == 2
    assert [(r[0], r[1] is None) for r in results] == [("demo_0", True), ("demo_1", False)]
    assert [(r[0], r[1] is None) for r in jax_results] == [("demo_0", True), ("demo_1", False)]
    traj, jtraj = results[1][1], jax_results[1][1]
    assert results[1][2] == jax_results[1][2]
    for k in ("actions", "states", "rewards", "dones"):
        assert np.array_equal(traj[k], jtraj[k]) and traj[k].dtype == jtraj[k].dtype, k
    assert all(np.array_equal(traj["obs"][k], jtraj["obs"][k]) for k in jtraj["obs"])

    out, done = queue.Queue(), threading.Event()
    for r in results:
        out.put(r)
    path = os.path.join(os.path.dirname(root), "one")
    s2o._writer(path, env_meta, 2, out, done)
    assert done.is_set() and Export(path).demos == ["demo_1"]
    assert Export(path).data_attrs["total"] == 1
