"""Port parity of the synthetic closed loop: scripted demonstration
collection (``lipvq_tpu_torch/scripts/collect_demos.py``, the synthetic env
factory) against the JAX package's, and the convergence twin
(``lipvq_tpu_torch/examples/convergence_demo.py``) on the CPU.

Collection is numpy in both packages: the corpora are held array for array,
bit for bit, dtypes included (the JAX package's HDF5 file against the
port's export), with and without DART noise and dwells. The twin's short
run checks the wiring (evaluation, counts); the full run (marked slow) must
end within 0.3 of the JAX package's last success rate on the same seeds."""

import json
import sys

import h5py
import numpy as np
import pytest

from lipvq_tpu.robocasa.env_utils import create_env as jax_create_env
from lipvq_tpu.scripts import collect_demos as jax_collect
from lipvq_tpu_torch.data.export import Export
from lipvq_tpu_torch.envs.env_factory import create_env
from lipvq_tpu_torch.examples import convergence_demo
from lipvq_tpu_torch.scripts import collect_demos

# the JAX package's examples/convergence_demo.py on this CPU (JAX_PLATFORMS=cpu):
# success at epochs 0 / 4 / 8 / 12 = 0.2 / 1.0 / 1.0 / 1.0
JAX_CPU_LAST_SUCCESS = 1.0


def _hold_corpus(h5_path: str, export_root: str) -> int:
    """Every array, attribute and file attribute of the JAX file equal to
    the export's; returns the number of demos."""
    ex = Export(export_root)
    with h5py.File(h5_path, "r") as f:
        data = f["data"]
        assert json.loads(data.attrs["env_args"]) == json.loads(ex.data_attrs["env_args"])
        assert int(data.attrs["total"]) == ex.data_attrs["total"]
        assert sorted(data.keys()) == sorted(ex.demos)
        for demo in data:
            group, attrs = data[demo], ex.demo_attrs(demo)
            assert int(group.attrs["num_samples"]) == attrs["num_samples"]
            assert json.loads(group.attrs["ep_meta"]) == json.loads(attrs["ep_meta"])
            paths = []
            group.visititems(lambda name, obj: paths.append(name)
                             if isinstance(obj, h5py.Dataset) else None)
            assert sorted(paths) == sorted(ex._demos[demo]["arrays"]), demo
            for key in paths:
                want, got = group[key][()], ex.load(demo, key)
                assert got.dtype == want.dtype, (demo, key)
                np.testing.assert_array_equal(got, want, err_msg=f"{demo}/{key}")
        return len(data)


@pytest.mark.parametrize("action_noise,dwell_prob", [(0.0, 0.0), (0.3, 0.0), (0.0, 0.2),
                                                     (0.3, 0.2)])
def test_collected_corpus_matches_jax(tmp_path, action_noise, dwell_prob):
    """Five demos of at most 40 steps from seed 3 (DART noise and dwells as
    given): the same trajectories, successes and arrays."""
    runs = []
    for create, collect in ((jax_create_env, jax_collect), (create_env, collect_demos)):
        env, rng = create("SyntheticKitchen", seed=3), np.random.default_rng(3)
        trajs, success = [], []
        for _ in range(5):
            traj, ok = collect.collect_demo(env, collect.scripted_policy, 40, rng,
                                            action_noise=action_noise, dwell_prob=dwell_prob)
            trajs.append(traj)
            success.append(ok)
        runs.append((env, trajs, success))
    (jax_env, jax_trajs, jax_ok), (env, trajs, ok) = runs
    assert ok == jax_ok and any(ok)
    h5 = jax_collect.write_demos(str(tmp_path / "demos.hdf5"), jax_env, jax_trajs)
    export = collect_demos.write_demos(str(tmp_path / "export"), env, trajs)
    assert _hold_corpus(h5, export) == 5
    lengths = [len(t["actions"]) for t in trajs]
    assert lengths == [len(t["actions"]) for t in jax_trajs]
    if dwell_prob:
        # a dwell holds: the executed action is zero, the recorded label is not
        acts = np.concatenate([np.stack(t["actions"]) for t in trajs])
        pos = np.concatenate([np.stack([o["robot0_eef_pos"] for o in t["obs"]]) for t in trajs])
        assert (np.abs(np.diff(pos, axis=0)).sum(-1) == 0).any() and np.abs(acts).sum() > 0


def test_collect_main_matches_jax(tmp_path, monkeypatch):
    """The scripted CLI path: the JAX script's file equals the port's export;
    a multi-stage kitchen task builds, as JAX's does. (Teleoperation is held
    in ``test_torch_port_kitchen_tools.py``.)"""
    h5 = str(tmp_path / "demos.hdf5")
    monkeypatch.setattr(sys, "argv", ["collect_demos", "--n_demos", "4", "--max_steps", "60",
                                      "--output", h5, "--seed", "1", "--only_success"])
    jax_collect.main()
    out = collect_demos.main(["--n_demos", "4", "--max_steps", "60", "--output",
                              str(tmp_path / "export"), "--seed", "1", "--only_success"])
    assert _hold_corpus(h5, out) == 4
    env, jenv = create_env("PreSoakPan", seed=0), jax_create_env("PreSoakPan", seed=0)
    got, want = env.reset(), jenv.reset()
    assert list(got) == list(want) and all(np.array_equal(got[k], want[k]) for k in want)
    assert env.ep_lang_str == jenv.ep_lang_str


def test_twin_short_run_on_the_cpu(tmp_path):
    """One epoch of two steps and one-episode evaluations, at the twin's
    widths: finite losses, a success rate and horizon per evaluation, no K1
    launch on the CPU, one request per env step."""
    out = convergence_demo.run(device="cpu", workdir=str(tmp_path), epochs=1,
                               steps_per_epoch=2, eval_every=1, first_episodes=1, episodes=1,
                               n_demos=3, log=lambda *_: None)
    curve = out["curve"]
    assert [c["epoch"] for c in curve] == [0, 1] and out["train_steps"] == 2
    assert curve[0]["loss"] is None and np.isfinite(curve[1]["loss"])
    for c in curve:
        assert 0.0 <= c["success"] <= 1.0 and 1 <= c["horizon"] <= 120
        assert c["k1_launches"] == 0 and 1 <= c["distinct_ids"] <= 256
    assert out["requests"] == round(sum(c["horizon"] for c in curve))
    assert Export(str(tmp_path / "demos")).demos == ["demo_0", "demo_1", "demo_2"]


@pytest.mark.slow
def test_twin_converges_on_the_cpu(tmp_path):
    """The twin at the JAX script's settings ends within 0.3 of the JAX
    package's last success rate on this CPU."""
    out = convergence_demo.run(device="cpu", workdir=str(tmp_path))
    assert [c["epoch"] for c in out["curve"]] == [0, 4, 8, 12]
    assert out["curve"][-1]["success"] >= JAX_CPU_LAST_SUCCESS - 0.3
