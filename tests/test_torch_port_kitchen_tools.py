"""The port's kitchen tools against the JAX package's, on the CPU: the
teleop devices and ``collect_demos --device keyboard``, the expert tools
(``bench_expert_success``, ``diagnose_expert``, ``repin_experts``,
``bench_speed``), the USDA export, the PnP probe's classes, the seed-table
aggregator and the suite's supervisor script; and the suite twin's own
entry point end to end on the CPU, with the PnP probe on its checkpoint.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest

from lipvq_tpu.robocasa.sim import devices as jax_devices
from lipvq_tpu_torch.robocasa.sim import devices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))


def _fed(keyboard_cls):
    """A keyboard reading the raw key stream of a pipe (not a terminal:
    ``start_control`` leaves it as it is) -> (keyboard, write)."""
    r, w = os.pipe()
    stdin = os.fdopen(r, "r")
    kb = keyboard_cls(scale=0.5, stdin=stdin)

    def write(keys: str):
        os.write(w, keys.encode())
    return kb, write, (stdin, w)


def test_keyboard_matches_jax_on_a_key_stream():
    """The same key batches give the same action arrays and controls, through
    ``get_action``'s non-blocking reads of a real file descriptor. Reference
    fault (u), mirrored: ``_pending_keys`` selects on the descriptor but
    reads through the text buffer, which takes every pending byte at once,
    so the rest of a burst waits unread until more bytes arrive: "ww a"
    moves the arm by one "w", and the next call, with "w a" still pending,
    moves it not at all."""
    assert devices.KEY_BINDINGS == jax_devices.KEY_BINDINGS
    batches = ["w", "ww a", "", "b8", "rfz", " x6", "tg+-79", ".", "q"]
    runs = []
    for cls in (jax_devices.Keyboard, devices.Keyboard):
        kb, write, (stdin, w) = _fed(cls)
        try:
            kb.start_control()
            out = []
            for keys in batches:
                write(keys)
                a, ctrl = kb.get_action()
                out.append((a, dict(ctrl)))
            kb.stop_control()
        finally:
            stdin.close()
            os.close(w)
        runs.append(out)
    for (ja, jc), (pa, pc) in zip(*runs):
        assert pa.dtype == ja.dtype and np.array_equal(pa, ja) and pc == jc
    assert runs[1][-2][1] == {"done": True, "success": True}
    burst, idle = runs[1][1][0], runs[1][2][0]
    assert burst[0] == 0.5 and burst[1] == 0.0  # one "w" of "ww a" at scale 0.5
    assert not idle[:6].any()  # "w a" still pending, not read


def test_keyboard_spins_at_end_of_input_as_jax_does(monkeypatch):
    """Reference fault (v), mirrored: at the end of its input (a closed pipe,
    ``/dev/null``) the stream stays readable and ``read(1)`` returns "", so
    ``_pending_keys`` never leaves its loop. Here ``select`` stops it after
    1000 polls in both packages."""
    import select

    polls = []
    real = select.select

    def counted(*args):
        polls.append(1)
        if len(polls) % 1000 == 0:
            raise TimeoutError("still polling")
        return real(*args)

    monkeypatch.setattr(select, "select", counted)
    for cls in (jax_devices.Keyboard, devices.Keyboard):
        with open(os.devnull) as stdin:
            kb = cls(stdin=stdin)
            kb.start_control()
            with pytest.raises(TimeoutError):
                kb.get_action()
    assert len(polls) == 2000


def test_make_device_fails_as_jax_does():
    errors = []
    for module in (jax_devices, devices):
        got = []
        for name, exc in (("spacemouse", ImportError), ("joystick", ValueError)):
            with pytest.raises(exc) as e:
                module.make_device(name)
            got.append((type(e.value).__name__, str(e.value)))
        errors.append(got)
    assert errors[0] == errors[1] and "`hid` package" in errors[1][0][1]


class ScriptedDevice(devices.Device):
    """A teleop device with a fixed plan: per episode, a number of steps of
    seeded actions, then an end (``q``), a success mark (``.``) or nothing
    (the episode runs into ``--max_steps``)."""

    PLAN = (("done", 5), ("success", 4), (None, 0), ("success", 3))

    def __init__(self):
        self.rng = np.random.default_rng(7)
        self.episode = -1

    def start_control(self):
        self.episode += 1
        self.t = 0

    def stop_control(self):
        pass

    def get_action(self):
        end, steps = self.PLAN[self.episode % len(self.PLAN)]
        self.t += 1
        a = self.rng.uniform(-1, 1, 12).astype(np.float32)
        hit = end is not None and self.t >= steps
        return a, {"done": hit, "success": hit and end == "success"}


@pytest.mark.parametrize("env,extra", [
    ("SyntheticKitchen", ["--n_demos", "3"]),
    ("SyntheticKitchen", ["--n_demos", "2", "--only_success"]),
    ("OpenDrawer", ["--n_demos", "2"]),
], ids=["synthetic", "only_success", "kitchen"])
def test_keyboard_collection_matches_jax(tmp_path, monkeypatch, env, extra):
    """``collect_demos --device keyboard`` with ``make_device`` giving the
    scripted device in both packages: JAX's HDF5 file equals the port's
    export, array for array and attribute for attribute."""
    from lipvq_tpu.scripts import collect_demos as jax_collect
    from test_torch_port_closed_loop import _hold_corpus

    from lipvq_tpu_torch.scripts import collect_demos

    if env != "SyntheticKitchen":
        pytest.importorskip("mujoco")
    monkeypatch.setattr(jax_devices, "make_device", lambda name: ScriptedDevice())
    monkeypatch.setattr(devices, "make_device", lambda name: ScriptedDevice())
    argv = ["--env", env, "--max_steps", "12", "--seed", "2", "--device", "keyboard", *extra]
    h5 = str(tmp_path / "teleop.hdf5")
    monkeypatch.setattr(sys, "argv", ["collect_demos", *argv, "--output", h5])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_collect.main()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        export = collect_demos.main([*argv, "--output", str(tmp_path / "teleop")])
    assert out.getvalue().replace(export, "<out>") == buf.getvalue().replace(h5, "<out>")
    n = int(extra[1])
    assert _hold_corpus(h5, export) == n
    with h5py.File(h5) as f:
        lengths = [f[f"data/demo_{i}/actions"].shape[0] for i in range(n)]
    assert lengths == {"--only_success": [4, 3]}.get(extra[-1], [5, 4, 12][:n])


# two single-stage (task, seed) pairs, the first one failing (its diagnosis
# records transitions and the phase active at the end), and a multi-stage one
EXPERT_PAIRS = [("TurnOffStove", 3), ("CloseDrawer", 1), ("PrepareCoffee", 0)]


@pytest.mark.parametrize("task,seed", EXPERT_PAIRS)
def test_expert_tools_match_jax(task, seed):
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa import bench_expert_success as jax_bench
    from lipvq_tpu.robocasa import diagnose_expert as jax_diagnose

    from lipvq_tpu_torch.robocasa import bench_expert_success, diagnose_expert

    ok = bench_expert_success.rollout(task, seed)
    assert ok == jax_bench.rollout(task, seed)
    traced = diagnose_expert.traced_rollout(task, seed)
    assert traced == jax_diagnose.traced_rollout(task, seed)
    assert traced[0] == ok == (task != "TurnOffStove")
    if not ok:
        assert traced[1][-1]["active_at_end"] and len(traced[1]) > 1 and traced[2]


def test_bench_main_tables_match_jax(tmp_path):
    """``bench_expert_success.main`` writes the same markdown table (the
    timing lines aside)."""
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa import bench_expert_success as jax_bench

    from lipvq_tpu_torch.robocasa import bench_expert_success

    tables = []
    for module, name in ((jax_bench, "jax"), (bench_expert_success, "port")):
        out = str(tmp_path / f"{name}.md")
        with contextlib.redirect_stdout(io.StringIO()):
            assert module.main(["--seeds", "2", "--tasks", "TurnOnSinkFaucet", "--out", out]) == 0
        tables.append(open(out).read())
    assert tables[0] == tables[1]
    assert "| TurnOnSinkFaucet | 2/2 | 1.00 |" in tables[1]


@pytest.mark.parametrize("env", ["SyntheticKitchen", "OpenDrawer"])
def test_bench_env_keys_match_jax(env):
    from lipvq_tpu.robocasa.bench_speed import bench_env as jax_bench_env

    from lipvq_tpu_torch.robocasa.bench_speed import bench_env

    if env != "SyntheticKitchen":
        pytest.importorskip("mujoco")
    got, want = (f(env, n_steps=20, n_resets=2, n_envs=2) for f in (bench_env, jax_bench_env))
    assert list(got) == list(want) == ["env", "n_envs", "reset_time_s", "steps_per_sec"]
    assert (got["env"], got["n_envs"]) == (want["env"], want["n_envs"]) == (env, 2)
    assert got["steps_per_sec"] > 0 and got["reset_time_s"] >= 0


def test_repin_prints_the_jax_entry(monkeypatch):
    """``repin_experts --tasks TurnOnSinkFaucet --scan 0`` prints the same
    pins (the port's read from its expert tests' source) as JAX's."""
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa import repin_experts as jax_repin

    from lipvq_tpu_torch.robocasa import repin_experts

    monkeypatch.chdir(REPO)  # JAX's tool reads its pins from ./tests
    printed = []
    for main in (jax_repin.main, repin_experts.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--tasks", "TurnOnSinkFaucet", "--scan", "0"])
        printed.append(re.sub(r", \d+s\)", ")", buf.getvalue()))
    assert printed[0] == printed[1]
    assert "[ok] TurnOnSinkFaucet: [0] (kept [0])" in printed[1]
    assert '    "TurnOnSinkFaucet": (0,),' in printed[1]
    pins = {}
    for name in repin_experts.PIN_FILES:
        pins.update(repin_experts.read_pins(os.path.join(REPO, "tests", name)))
    from test_scripted_experts import RELIABLE

    assert pins == RELIABLE


def test_usd_export_bytes_match_jax(tmp_path):
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa.usd_export import export_episode as jax_export_episode

    from lipvq_tpu_torch.robocasa.usd_export import export_episode

    want = jax_export_episode("OpenDrawer", steps=5, output=str(tmp_path / "jax.usda"), seed=0)
    got = export_episode("OpenDrawer", steps=5, output=str(tmp_path / "port.usda"), seed=0)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.startswith(b"#usda 1.0") and b"timeSamples" in data


def _record(**over):
    rec = {"success": False, "min_obj_eef_dist": 0.05, "max_lift": 0.05, "final_xy_disp": 0.05}
    rec.update(over)
    return rec


@pytest.mark.parametrize("rec,cls", [
    (_record(success=True), "success"),
    (_record(min_obj_eef_dist=0.2), "never_approached"),
    (_record(max_lift=0.01), "reach_no_grasp"),
    (_record(final_xy_disp=0.3), "moved_not_placed"),
    (_record(), "grasp_drop"),
    (_record(min_obj_eef_dist=0.10, max_lift=0.03, final_xy_disp=0.15), "grasp_drop"),
])
def test_pnp_probe_classes_match_jax(rec, cls):
    import pnp_probe as jax_probe

    from lipvq_tpu_torch.examples import pnp_probe

    assert (pnp_probe.APPROACH_M, pnp_probe.LIFT_M, pnp_probe.CARRY_M) == (
        jax_probe.APPROACH_M, jax_probe.LIFT_M, jax_probe.CARRY_M)
    assert pnp_probe.classify(rec) == jax_probe.classify(rec) == cls


def test_aggregate_seed_tables_matches_jax():
    import aggregate_seed_tables as jax_aggregate

    from lipvq_tpu_torch.examples import aggregate_seed_tables

    paths = [os.path.join(REPO, "results", "r5", f"core8_seed{s}_success.json")
             for s in (1, 2, 3)]
    printed = []
    for main in (jax_aggregate.main, aggregate_seed_tables.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(paths)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    # the seed-1 table predates its train_seed key
    assert json.loads(printed[1].splitlines()[-1])["seeds"] == ["?", 2, 3]


SUPERVISORS = (os.path.join(REPO, "examples", "run_suite_resilient.sh"),
               os.path.join(REPO, "lipvq_tpu_torch", "examples", "run_suite_resilient.sh"))


@pytest.mark.parametrize("rc,last", [(0, "[supervisor] training complete"),
                                     (1, "[supervisor] giving up after 1 restarts")])
def test_supervisor_scripts_log_as_jax(tmp_path, rc, last):
    """Both supervisors parse (``bash -n``); with a stub ``python`` first on
    ``PATH`` (and a stub ``sleep``) that exits ``rc``, both log the same
    lines, and the port's launches the twin with ``--train_only --resume``."""
    stubs = tmp_path / "bin"
    stubs.mkdir()
    (stubs / "python").write_text(f'#!/bin/sh\necho "$@" >> "$OUT/args"\nexit {rc}\n')
    (stubs / "sleep").write_text("#!/bin/sh\nexit 0\n")
    for stub in stubs.iterdir():
        stub.chmod(0o755)
    logs = []
    for i, script in enumerate(SUPERVISORS):
        assert subprocess.run(["bash", "-n", script]).returncode == 0
        out = tmp_path / f"out{i}"
        env = {**os.environ, "PATH": f"{stubs}:{os.environ['PATH']}", "OUT": str(out),
               "MAX_RESTARTS": "1"}
        proc = subprocess.run(["bash", script], env=env, capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == (0 if rc == 0 else 1), proc.stderr
        logs.append((out / "train_supervised.log").read_text())
        args = (out / "args").read_text()
        assert "--train_only --resume" in args and f"--out {out}" in args
    assert logs[0] == logs[1]
    assert logs[1].splitlines() == ["[supervisor] launch (attempt 1)", last]
    assert "-m lipvq_tpu_torch.examples.kitchen_multitask_suite" in (
        tmp_path / "out1" / "args").read_text()


def test_suite_main_on_the_cpu_and_the_probe_on_its_checkpoint(tmp_path):
    """The suite twin end to end on the CPU (``--train_device cpu
    --eval_device cpu``) over the committed OpenDrawer export: training, a
    checkpoint, the closed-loop table; then the PnP probe (``--device cpu``)
    on that checkpoint and corpus writes its classes."""
    pytest.importorskip("mujoco")
    from lipvq_tpu_torch.examples import kitchen_multitask_suite as suite
    from lipvq_tpu_torch.examples import pnp_probe

    corpora = tmp_path / "corpora"
    corpora.mkdir()
    corpus = os.path.join(REPO, "lipvq_tpu_torch", "assets", "kitchen", "OpenDrawer")
    os.symlink(corpus, corpora / "OpenDrawer")
    out = tmp_path / "out"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        suite.main(["--tasks", "OpenDrawer", "--corpus_dir", str(corpora), "--out", str(out),
                    "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "4",
                    "--embed_dim", "32", "--num_layers", "1", "--eval_episodes", "2",
                    "--horizon", "5", "--train_device", "cpu", "--eval_device", "cpu"])
    text = buf.getvalue()
    assert "[collect]" not in text and "[train] done" in text
    assert re.search(r"\[eval\] OpenDrawer: success=0\.00 \(2 episodes, \d+s, mean horizon 5\)",
                     text), text[-2000:]
    table = json.loads(text.splitlines()[-1])
    assert table["per_task"] == {"OpenDrawer": 0.0} and table["ckpt"] == "model_epoch_1.ckpt"
    ckpt = next(out.glob("run/**/model_epoch_1.ckpt"))
    with contextlib.redirect_stdout(io.StringIO()):
        summary = pnp_probe.main(["--ckpt", str(ckpt), "--task", "OpenDrawer", "--corpus",
                                  corpus, "--episodes", "2", "--horizon", "3", "--device", "cpu",
                                  "--out", str(tmp_path / "probe.json")])
    assert summary["episodes"] == 2 and sum(summary["classes"].values()) == 2
    records = json.load(open(tmp_path / "probe.json"))["episodes"]
    assert [r["steps"] for r in records] == [3, 3]
    assert all(r["class"] == pnp_probe.classify(r) for r in records)


def _attempt(make_env, make_policy, collect, task, seed, horizon):
    """One collection attempt of ``task`` at the suite recipe's noise and
    dwells, the kitchen built at ``horizon`` (None: the kitchen's default,
    as the collectors build it), ``max_steps`` the suite's
    ``max(900, task_horizon(task))`` -> (actions [T, 12], success)."""
    from lipvq_tpu_torch.examples.kitchen_multitask_suite import task_horizon

    kwargs = {} if horizon is None else {"horizon": horizon}
    env = make_env(task, seed=seed, layout_ids=0, style_ids=0, **kwargs)
    traj, ok = collect(env, None, max(900, task_horizon(task)), np.random.default_rng(seed),
                       policy_factory=lambda e: make_policy(task, e), action_noise=0.05,
                       dwell_prob=0.06)
    env.close()
    return np.stack(traj["actions"]), ok


def test_suite_collection_cuts_expert_episodes_at_the_kitchen_horizon():
    """Fault (t), a further instance: the suite asks ``collect_task`` for
    ``max_steps = max(900, task_horizon(task))`` steps, but the kitchen is
    built at its 500-step horizon and the episode ends at ``done``. At
    CloseSingleDoor seed 18 (the recipe's noise and dwells) the expert needs
    599 steps: both packages' attempts end unsolved at step 500 with equal
    actions, and the port's with the kitchen built at 900 steps succeeds."""
    pytest.importorskip("mujoco")
    from lipvq_tpu.robocasa.env_utils import create_env as jax_create_env
    from lipvq_tpu.robocasa.sim.scripted import make_scripted_policy as jax_policy
    from lipvq_tpu.scripts.collect_demos import collect_demo as jax_collect_demo

    from lipvq_tpu_torch.envs.env_factory import create_env
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy
    from lipvq_tpu_torch.scripts.collect_demos import collect_demo

    port = (create_env, make_scripted_policy, collect_demo)
    task, seed = "CloseSingleDoor", 18
    cut, ok = _attempt(*port, task, seed, None)
    jax_cut, jax_ok = _attempt(jax_create_env, jax_policy, jax_collect_demo, task, seed, None)
    assert len(cut) == 500 and not ok and not jax_ok and np.array_equal(cut, jax_cut)
    whole, ok = _attempt(*port, task, seed, 900)
    assert len(whole) == 599 and ok and np.array_equal(whole[:500], cut)


# the suite's collection (``collect``: each task of the full set at its seed,
# layout and style, ``--n_demos 40 --action_noise 0.05 --dwell_prob 0.06``)
# with the kitchen at its 500-step horizon, and with it built at the
# ``max_steps`` the suite asks for: task -> (attempts, attempts cut unsolved
# at step 500; attempts at 900, demos longer than 500 steps)
HORIZON_CENSUS = {
    "NavigateKitchen": (40, 0, 40, 0), "OpenDrawer": (40, 0, 40, 0),
    "CloseDrawer": (52, 12, 50, 0), "OpenSingleDoor": (42, 2, 40, 3),
    "CloseSingleDoor": (44, 4, 41, 5), "TurnOnSinkFaucet": (40, 0, 40, 0),
    "TurnOffSinkFaucet": (40, 0, 40, 0), "TurnSinkSpout": (40, 0, 40, 0),
    "TurnOnMicrowave": (56, 0, 56, 0), "TurnOffMicrowave": (55, 0, 55, 0),
    "CoffeePressButton": (40, 0, 40, 0), "TurnOnStove": (41, 1, 40, 1),
    "TurnOffStove": (55, 15, 57, 7), "PnPCounterToCab": (53, 1, 55, 0),
    "PnPCabToCounter": (80, 18, 80, 0), "PnPMicrowaveToCounter": (43, 0, 43, 0),
    "PnPSinkToCounter": (66, 1, 70, 2), "CoffeeServeMug": (73, 8, 78, 1),
    "PrepareCoffee": (130, 35, 145, 0),
}


def _census(task, seed, layout, style, horizon, n_demos=40, attempts_per_demo=6):
    """``collect_task``'s attempt loop (the same draws), counting -> (attempts,
    attempts unsolved at 500 steps or more, successful demos longer than 500
    steps)."""
    from lipvq_tpu_torch.envs.env_factory import create_env
    from lipvq_tpu_torch.robocasa.sim.scripted import make_scripted_policy
    from lipvq_tpu_torch.scripts.collect_demos import collect_demo
    from lipvq_tpu_torch.examples.kitchen_multitask_suite import task_horizon

    kwargs = {} if horizon is None else {"horizon": horizon}
    env = create_env(task, seed=seed, layout_ids=layout, style_ids=style, **kwargs)
    rng = np.random.default_rng(seed)
    attempts = demos = cut = long = 0
    while demos < n_demos and attempts < n_demos * attempts_per_demo:
        attempts += 1
        traj, ok = collect_demo(env, None, max(900, task_horizon(task)), rng,
                                policy_factory=lambda e: make_scripted_policy(task, e),
                                action_noise=0.05, dwell_prob=0.06)
        env.get_ep_meta()
        n = len(traj["actions"])
        demos += int(ok)
        cut += int(n >= 500 and not ok)
        long += int(n > 500 and ok)
    env.close()
    return attempts, cut, long


@pytest.mark.slow
@pytest.mark.parametrize("task", sorted(HORIZON_CENSUS))
def test_suite_collection_horizon_census(task):
    """The census behind fault (t)'s size for the suite (minutes per task):
    ``python -m pytest -m slow tests/test_torch_port_kitchen_tools.py -k census``."""
    pytest.importorskip("mujoco")
    from lipvq_tpu_torch.examples.kitchen_multitask_suite import FULL_TASKS, task_horizon

    _, seed, layout, style = next(t for t in FULL_TASKS if t[0] == task)
    attempts, cut, _ = _census(task, seed, layout, style, None)
    attempts_900, _, long = _census(task, seed, layout, style, max(900, task_horizon(task)))
    assert (attempts, cut, attempts_900, long) == HORIZON_CENSUS[task]
