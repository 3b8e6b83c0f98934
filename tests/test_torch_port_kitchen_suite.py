"""The port's multi-task kitchen suite
(``lipvq_tpu_torch/examples/kitchen_multitask_suite.py``) against the JAX
package's (``examples/kitchen_multitask_suite.py``), run as that script runs
on the CPU:

- ``make_config`` equal key for key, across tokenizers and backbones;
- ``collect``: the port's export arrays bit-equal to JAX's HDF5 datasets at
  the recipe's noise and dwells, and a second call does not recollect;
- carried weights give the same closed loop: a tiny JAX suite model, its
  parameters carried into a port checkpoint (``utils/jax_weights.py``), both
  ``evaluate`` calls on the CPU with JAX's GMM draws replayed into the port:
  the same per-task table and mean horizon, the first 10 actions of each
  episode within ``ACTION_ATOL``;
- screening and selection over pre-written caches and real checkpoints (no
  env stepped): the same winner, ``screen_table.json`` and
  ``success_table.json``;
- ``--resume`` reads the same start epoch, with and without the ``.epoch``
  sidecar; ``--screen_only`` gives up the same way.
"""

import argparse
import contextlib
import glob
import io
import json
import os
import re
import shutil
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))

import kitchen_multitask_suite as jax_suite  # noqa: E402

from lipvq_tpu_torch.examples import kitchen_multitask_suite as suite  # noqa: E402

# the first 10 actions of each evaluation episode, port against JAX, on the
# same fp32 weights and the same GMM draws (at most 4.6e-7 apart on this
# test's CPU, actions up to 0.92 in magnitude)
ACTION_ATOL = 1e-4
TASK = "OpenDrawer"
RECIPE = ["--tasks", TASK, "--n_demos", "2", "--action_noise", "0.05", "--dwell_prob", "0.06"]
TINY = ["--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "4", "--embed_dim", "32",
        "--num_layers", "1", "--eval_device", "cpu"]


def _args(*argv) -> argparse.Namespace:
    """The suite's flags parsed by the port's parser: the JAX script has the
    same flags and defaults (the port adds ``--train_device``, which JAX's
    functions never read, and its ``--eval_device`` defaults to cuda)."""
    return suite.build_parser().parse_args(list(argv))


@pytest.mark.parametrize("backbone", ["transformer", "mamba"])
@pytest.mark.parametrize("tokenizer", ["vq", "bin", "fast", "ln_act", "raw"])
def test_make_config_matches_jax(tokenizer, backbone):
    argv = ["--tokenizer", tokenizer, "--backbone", backbone, "--out", "/suite",
            "--embed_dim", "384", "--num_layers", "6"]
    if (tokenizer, backbone) == ("vq", "transformer"):
        argv += ["--balance_tasks", "--task_weights", "OpenDrawer=2, CloseDrawer=0.5",
                 "--pair_task_batches", "--train_seed", "3", "--save_every", "5"]
    args = _args(*argv)
    paths = {"OpenDrawer": "/c/OpenDrawer", "CloseDrawer": "/c/CloseDrawer"}
    want = jax_suite.make_config(args, paths).to_dict()
    got = suite.make_config(args, paths).to_dict()
    assert got == want
    assert got["algo_name"] == ("icl" if backbone == "transformer" else "icl_mamba")
    if "--balance_tasks" in argv:
        assert got["train"]["normalize_weights_by_ds_size"] and got["train"]["group_task_batches"]
        assert [d["weight"] for d in got["train"]["data"]] == [2.0, 0.5]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """``collect`` of both packages at ``RECIPE`` -> {"jax": (args, paths),
    "port": (args, paths)}."""
    pytest.importorskip("mujoco")
    root = tmp_path_factory.mktemp("suite")
    out = {}
    for name, module in (("jax", jax_suite), ("port", suite)):
        args = _args(*RECIPE, *TINY, "--corpus_dir", str(root / name / "corpora"),
                     "--out", str(root / name / "out"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            paths = module.collect(args)
        assert re.fullmatch(rf"\[collect\] {TASK}: 2/2 demos \(\d+ attempts, \d+s\)\n",
                            buf.getvalue()), buf.getvalue()
        out[name] = (args, paths)
    return out


def test_collect_matches_jax_and_does_not_recollect(corpora, capsys):
    from test_torch_port_closed_loop import _hold_corpus

    (jargs, jpaths), (args, paths) = corpora["jax"], corpora["port"]
    assert list(jpaths) == list(paths) == [TASK]
    assert jpaths[TASK].endswith(f"{TASK}.hdf5") and paths[TASK].endswith(TASK)
    assert _hold_corpus(jpaths[TASK], paths[TASK]) == 2
    stamp = os.path.getmtime(os.path.join(paths[TASK], "meta.json"))
    assert jax_suite.collect(jargs) == jpaths and suite.collect(args) == paths
    assert capsys.readouterr().out == ""
    assert os.path.getmtime(os.path.join(paths[TASK], "meta.json")) == stamp


def test_corpus_check_names_missing_obs_keys(corpora, tmp_path):
    """A corpus without a suite obs key stops the run in both packages."""
    import h5py

    from lipvq_tpu_torch.data.export import Export

    h5 = str(tmp_path / "old.hdf5")
    shutil.copy(corpora["jax"][1][TASK], h5)
    with h5py.File(h5, "a") as f:
        for demo in f["data"]:
            del f["data"][demo]["obs"]["obj_state"]
    export = str(tmp_path / "old")
    shutil.copytree(corpora["port"][1][TASK], export)
    meta = json.load(open(os.path.join(export, "meta.json")))
    for demo in meta["demos"].values():
        demo["arrays"].pop("obs/obj_state")
    json.dump(meta, open(os.path.join(export, "meta.json"), "w"))
    assert not Export(export).has("demo_0", "obs/obj_state")
    messages = []
    for check, path in ((jax_suite._check_corpus_obs_keys, h5),
                        (suite._check_corpus_obs_keys, export)):
        with pytest.raises(SystemExit) as e:
            check(path)
        messages.append(str(e.value).replace(path, "<corpus>"))
    assert messages[0] == messages[1] and "['obj_state']" in messages[0]


@pytest.fixture(scope="module")
def checkpoints(corpora, tmp_path_factory):
    """A tiny JAX suite model (1 layer x 32, batch 4, 1 epoch x 2 steps, fp32)
    trained by the JAX package's ``scripts/train.py`` on JAX's corpus, and
    the port's checkpoint of the same weights, config and stats ->
    (JAX checkpoint, port checkpoint)."""
    import jax

    from lipvq_tpu.scripts.train import train as jax_train
    from lipvq_tpu.utils.file_utils import policy_from_checkpoint as jax_policy_from_checkpoint

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils.file_utils import save_checkpoint
    from lipvq_tpu_torch.utils.jax_weights import load_jax_params

    args, paths = corpora["jax"]
    cfg = jax_suite.make_config(args, paths)
    with cfg.unlocked():
        # fp32 Dense math: the closed loop is compared action for action
        cfg.algo.transformer.compute_dtype = "float32"
    with contextlib.redirect_stdout(io.StringIO()):
        jax_ckpt = glob.glob(os.path.join(jax_train(cfg), "model_epoch_1.ckpt"))[0]
    jmodel, jckpt = jax_policy_from_checkpoint(jax_ckpt)
    raw = json.loads(jckpt["config"])
    pcfg = config_factory(raw.pop("algo_name"), raw)
    shape_meta = json.loads(jckpt["shape_metadata"])
    algo = algo_factory("icl", pcfg, shape_meta["all_shapes"], ac_dim=shape_meta["ac_dim"],
                        device="cpu")
    extra = jax.tree.map(np.asarray, dict(jmodel.state.extra_vars or {}))
    load_jax_params(algo, jax.tree.map(np.asarray, jmodel.state.params), extra or None)
    port_ckpt = str(tmp_path_factory.mktemp("port_ckpt") / "model_epoch_1.ckpt")
    save_checkpoint(port_ckpt, algo, pcfg, env_meta=json.loads(jckpt["env_metadata"]),
                    shape_meta=shape_meta,
                    obs_normalization_stats=jckpt["obs_normalization_stats_unpacked"],
                    action_normalization_stats=jckpt["action_normalization_stats_unpacked"],
                    lang_backend=jckpt["lang_backend"])
    return jax_ckpt, port_ckpt


def test_evaluate_on_carried_weights_matches_jax(corpora, checkpoints, tmp_path, monkeypatch):
    """``evaluate`` at ``--eval_device cpu --eval_episodes 2 --horizon 20``:
    the port's closed loop on the carried weights, fed JAX's GMM draws, gives
    JAX's per-task table and mean horizon, and its first 10 actions of each
    episode within ``ACTION_ATOL``; the port's evaluation never initializes
    CUDA."""
    import jax
    import jax.numpy as jnp

    from lipvq_tpu.algo.icl import ICLTransformerGMM as JaxICL
    from lipvq_tpu.algo.rollout_policy import ICLRolloutPolicy as JaxPolicy
    from lipvq_tpu.envs import vector_env as jax_vector_env

    from lipvq_tpu_torch.algo.icl import ICLTransformerGMM
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.envs import vector_env
    from lipvq_tpu_torch.models.distributions import gmm_sample_from_draws

    shapes, keys = {}, []

    def jax_draws(key):
        ku, ke = jax.random.split(key)
        means = shapes["means"]
        return (jax.random.uniform(ku, shapes["logits"], jnp.float32),
                jax.random.normal(ke, tuple(means[:-2]) + tuple(means[-1:]), jnp.float32))

    def jax_head(self, dists, key):
        shapes["logits"], shapes["means"] = dists.logits.shape, dists.means.shape
        u, eps = jax_draws(key)
        u = jnp.maximum(u, jnp.finfo(u.dtype).tiny)
        mode = jnp.argmax(dists.logits - jnp.log(-jnp.log(u)), axis=-1)
        pick = mode[..., None, None]
        mean = jnp.take_along_axis(dists.means, pick, axis=-2)[..., 0, :]
        scale = jnp.take_along_axis(dists.scales, pick, axis=-2)[..., 0, :]
        return mean + scale * eps

    actions = {"jax": [], "port": []}
    rollouts = {"jax": [], "port": []}

    def recorded(cls, name, before=None):
        orig = cls.batched

        def batched(self, obs, context_batch):
            if before is not None:
                before(self)
            out = orig(self, obs, context_batch)
            actions[name].append(np.array(out))
            return out
        monkeypatch.setattr(cls, "batched", batched)

    def logged(module, name):
        orig = module.batched_icl_rollout

        def rollout(*a, **k):
            logs = orig(*a, **k)
            rollouts[name].append(dict(logs))
            return logs
        monkeypatch.setattr(module, "batched_icl_rollout", rollout)

    monkeypatch.setattr(JaxICL, "_action_from_head", jax_head)
    recorded(JaxPolicy, "jax", lambda self: keys.append(jax.random.split(self.policy.state.rng)[1]))
    logged(jax_vector_env, "jax")
    jargs, jpaths = corpora["jax"]
    jargs = argparse.Namespace(**{**vars(jargs), "out": str(tmp_path / "jax"),
                                  "eval_episodes": 2, "horizon": 20})
    os.makedirs(jargs.out)
    want = jax_suite.evaluate(jargs, jpaths, checkpoints[0])

    queue = [tuple(torch.from_numpy(np.array(x)) for x in jax_draws(k)) for k in keys]

    def port_head(self, dists, draws=None):
        return gmm_sample_from_draws(dists, *queue.pop(0))

    def no_cuda(*a, **k):
        raise AssertionError("the CPU evaluation initialized CUDA")

    monkeypatch.setattr(ICLTransformerGMM, "_action_from_head", port_head)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    recorded(ICLRolloutPolicy, "port")
    logged(vector_env, "port")
    args, paths = corpora["port"]
    args = argparse.Namespace(**{**vars(args), "out": str(tmp_path / "port"),
                                 "eval_episodes": 2, "horizon": 20})
    os.makedirs(args.out)
    got = suite.evaluate(args, paths, checkpoints[1])

    assert not queue and len(keys) == len(actions["port"]) == len(actions["jax"]) > 10
    assert got == want and list(got) == [TASK]
    assert rollouts["port"] == rollouts["jax"]
    assert rollouts["port"][0]["Horizon"] == 20.0
    first = np.stack(actions["port"][:10]), np.stack(actions["jax"][:10])
    assert first[0].shape == (10, 2, 12)
    np.testing.assert_allclose(*first, rtol=0, atol=ACTION_ATOL)
    for name in ("jax", "port"):
        with open(os.path.join(tmp_path, name, "success_table.json")) as f:
            assert json.load(f) == {"per_task": want}


# pre-written screen caches per checkpoint epoch: epoch 2's is partial (one
# task), so the means are taken over the common task set; the re-screens of
# the top two and the final table
SCREENS = {1: {"OpenDrawer": 0.5, "CloseDrawer": 1.0},
           2: {"OpenDrawer": 0.6},
           3: {"OpenDrawer": 0.55, "CloseDrawer": 0.1}}
RESCREENS = {2: {"OpenDrawer": 0.3}, 3: {"OpenDrawer": 0.7}}
FINAL = {"OpenDrawer": 0.45}


def _screen_run(module, corpora, name: str, ckpt: str, root, flags: list) -> tuple:
    """The suite's ``main`` with ``--skip_train`` over three copies of
    ``ckpt`` (epochs 1-3, mtimes set) and pre-written caches -> (stdout
    lines without their timings, screen_table.json, success_table.json)."""
    cargs, _ = corpora[name]
    out = root / name
    models = out / "run" / "test" / "20260101000000" / "models"
    models.mkdir(parents=True)
    base = 1_700_000_000
    for epoch in SCREENS:
        path = models / f"model_epoch_{epoch}.ckpt"
        shutil.copy(ckpt, path)
        os.utime(path, (base + 10 * epoch, base + 10 * epoch))
        tag = f"model_epoch_{epoch}_{base + 10 * epoch}"
        (out / f"screen_{tag}.json").write_text(json.dumps({"per_task": SCREENS[epoch]}))
        if epoch in RESCREENS:
            (out / f"rescreen_{tag}.json").write_text(json.dumps({"per_task": RESCREENS[epoch]}))
    (out / "success_table.json").write_text(json.dumps({"per_task": FINAL}))
    argv = [*RECIPE, "--corpus_dir", cargs.corpus_dir, "--out", str(out), "--skip_train",
            "--eval_device", "cpu", "--screen_episodes", "3", *flags]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if module is jax_suite:
            with _argv(["kitchen_multitask_suite.py", *argv]):
                module.main()
        else:
            module.main(argv)
    lines = [re.sub(r"\(\d+s\)|\d+s\)", "", line) for line in buf.getvalue().splitlines()
             if line.startswith(("[screen]", "[rescreen]", "[bias]", "[eval]", "{"))]
    tables = []
    for name_ in ("screen_table.json", "success_table.json"):
        with open(out / name_) as f:
            tables.append(json.load(f))
    return lines, *tables


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv
    sys.argv = argv
    try:
        yield
    finally:
        sys.argv = saved


@pytest.mark.parametrize("flags,winner", [
    ([], "model_epoch_2.ckpt"),
    (["--screen_topk", "2"], "model_epoch_3.ckpt"),
    (["--screen_epochs", "1,3"], "model_epoch_1.ckpt"),
], ids=["partial_cache", "topk", "screen_epochs"])
def test_screening_selects_what_jax_selects(corpora, checkpoints, tmp_path, flags, winner):
    runs = [_screen_run(module, corpora, name, ckpt, tmp_path, flags)
            for module, name, ckpt in ((jax_suite, "jax", checkpoints[0]),
                                       (suite, "port", checkpoints[1]))]
    assert runs[0] == runs[1]
    lines, screen, success = runs[1]
    assert f"[screen] best: {winner}" in "\n".join(lines)
    assert success["ckpt"] == winner and success["per_task"] == FINAL
    assert success["screen_bias"] == round(success["screen_mean_winner"] - 0.45, 3)
    assert bool(screen["rescreen"]) == ("--screen_topk" in flags)


@pytest.mark.parametrize("sidecar,ckpts,start", [
    ("4", (2, 5), 5), (None, (2, 5), 6), ("x", (3,), 4), (None, (), 1)],
    ids=["sidecar", "no_sidecar", "bad_sidecar", "nothing_saved"])
def test_resume_start_epoch_matches_jax(corpora, tmp_path, monkeypatch, sidecar, ckpts, start):
    import lipvq_tpu.scripts.train as jax_train_script

    import lipvq_tpu_torch.scripts.train as train_script

    seen = []

    def fake_train(cfg, device=None):
        seen.append((os.path.basename(cfg.experiment.ckpt_path), cfg.experiment.start_epoch))
        return None

    monkeypatch.setattr(jax_train_script, "train", fake_train)
    monkeypatch.setattr(train_script, "train", fake_train)
    printed = []
    for module, name in ((jax_suite, "jax"), (suite, "port")):
        out = tmp_path / name
        models = out / "run" / "test" / "20260101000000" / "models"
        models.mkdir(parents=True)
        (models / "latest_full.state").write_bytes(b"")
        if sidecar is not None:
            (models / "latest_full.state.epoch").write_text(sidecar)
        for e in ckpts:
            (models / f"model_epoch_{e}.ckpt").write_bytes(b"")
        argv = [*RECIPE, "--corpus_dir", corpora[name][0].corpus_dir, "--out", str(out),
                "--train_only", "--resume"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if module is jax_suite:
                with _argv(["kitchen_multitask_suite.py", *argv]):
                    module.main()
            else:
                module.main(argv)
        printed.append([re.sub(r"\S*latest_full", "latest_full", line)
                        for line in buf.getvalue().splitlines() if line.startswith("[resume]")])
    assert seen == [("latest_full.state", start)] * 2
    assert printed[0] == printed[1] == [f"[resume] latest_full.state -> start_epoch {start}"]


def test_screen_only_gives_up_as_jax_does(corpora, tmp_path, monkeypatch):
    """``--screen_only --screen_timeout 0`` with no checkpoint gives up with
    the same line; without ``--screen_epochs`` both stop with the same
    message."""
    monkeypatch.setattr(time, "sleep", lambda s: None)
    results = []
    for module, name in ((jax_suite, "jax"), (suite, "port")):
        base = [*RECIPE, "--corpus_dir", corpora[name][0].corpus_dir, "--out",
                str(tmp_path / name), "--screen_only", "--eval_device", "cpu"]
        got = []
        for extra in (["--screen_epochs", "5,7", "--screen_episodes", "2",
                       "--screen_timeout", "0"], ["--screen_episodes", "2"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                try:
                    if module is jax_suite:
                        with _argv(["kitchen_multitask_suite.py", *base, *extra]):
                            module.main()
                    else:
                        module.main(base + extra)
                except SystemExit as e:
                    got.append(f"SystemExit: {e}")
            got.append(buf.getvalue())
        results.append(got)
    assert results[0] == results[1]
    assert results[1][0] == ("[screen_only] timeout (0s) waiting for epochs ['5', '7']; "
                             "exiting\n")
    assert results[1][1] == "SystemExit: --screen_only needs --screen_epochs and --screen_episodes"


def _previous_kitchen_config(data, output_dir=None, compute_dtype="bfloat16", hold=False):
    """``chip_smoke.py::kitchen_config`` as it was written by hand before it
    was built from the suite's ``make_config``: the recipe phases 19 and 20
    trained."""
    import chip_smoke

    from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides

    d = icl_test_config_overrides()
    d["algo_name"] = "icl"
    d["train"].update({"data": data, "output_dir": output_dir, "batch_size": 64,
                       "num_epochs": 2, "seed": 1,
                       "hdf5_cache_mode": "low_dim" if hold else "device",
                       "action_config": {"actions": {"normalization": "min_max"}}})
    d["experiment"].update({
        "name": "chip_smoke_kitchen", "epoch_every_n_steps": 20, "validate": False,
        "render_video": False, "save": {"enabled": True, "every_n_epochs": 1},
        "rollout": {"enabled": True, "batched": True, "num_batch_envs": 16, "n": 16,
                    "horizon": 50, "rate": 1}})
    d["algo"]["transformer"].update({"embed_dim": 384, "num_layers": 6, "num_heads": 8,
                                     "compute_dtype": compute_dtype})
    if hold:
        d["algo"]["transformer"].update(
            {"emb_dropout": 0.0, "attn_dropout": 0.0, "block_output_dropout": 0.0})
    d["algo"]["gmm"]["min_std"] = 0.03
    d["algo"]["optim_params"] = {"policy": {"learning_rate": {
        "initial": 1e-3, "scheduler_type": "none"}}}
    d["algo"]["vq"] = {"num_codes": 512}
    d["observation"]["modalities"]["obs"]["low_dim"] = list(chip_smoke.KITCHEN_OBS_KEYS)
    return d


@pytest.mark.parametrize("call", [
    (([{"path": "/c/OpenDrawer", "weight": 1.0}], "/out"), {}),
    (("/c/OpenDrawer",), {"compute_dtype": "float32", "hold": True}),
    (([{"path": f"/c/{t}", "weight": 1.0} for t in ("ArrangeVegetables", "PrepareCoffee")],
      "/out"), {}),
    (([{"path": "/c/PrepareCoffee", "weight": 1.0}],), {"compute_dtype": "float32",
                                                       "hold": True}),
], ids=["kitchen", "kitchen_hold", "kitchen_multi", "kitchen_multi_hold"])
def test_chip_smoke_kitchen_config_keeps_the_recipe(call):
    """Phases 19 and 20 of ``chip_smoke.py`` train from the suite's
    ``make_config`` now: through the JSON file the train script reads and
    ``config_factory``, every key equals the hand-written recipe's."""
    import chip_smoke

    from lipvq_tpu_torch.config import config_factory

    args, kwargs = call
    new, old = (json.loads(json.dumps(f(*args, **kwargs)))
                for f in (chip_smoke.kitchen_config, _previous_kitchen_config))
    assert config_factory("icl", new).to_dict() == config_factory("icl", old).to_dict()
