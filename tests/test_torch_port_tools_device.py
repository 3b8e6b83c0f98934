"""The port's model-prediction plots, profiling helpers, loader bench and
simple examples against the JAX package's, on the CPU:

- ``plot_predictions`` over a ``make_synthetic_export`` (JAX over the HDF5
  fixture of the same arrays) and over the JAX fixture converted by
  ``hdf5_to_export``, on weights carried by ``utils/jax_weights.py`` (fp32),
  JAX's GMM draws replayed into the port: every ``get_action`` result
  within ``PRED_ATOL`` and the same PNG names;
- ``profile_utils``: ``timeit``'s keys and modes, ``trace``'s file,
  ``PhaseTimer.logs``;
- ``bench_loader.main`` at a tiny size: the JSON keys of JAX's;
- the six simple examples' ``main``: the same printed lines where the output
  is deterministic, finite numbers elsewhere.
"""

import contextlib
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "examples"))

# each get_action of the port against JAX's on the same fp32 weights and
# draws (GMM means are tanh-squashed, actions within [-1, 1])
PRED_ATOL = 1e-4
N_DEMOS, DEMO_LEN = 3, 14  # 10-step windows: 4 predictions per demo


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A tiny fp32 JAX flagship (2 x 64, 32 codes, ``lang_emb`` among the
    obs) saved by the JAX package, its weights carried into a port checkpoint
    of the same config and metadata; the JAX fixture's HDF5 file."""
    import jax

    import lipvq_tpu.algo  # noqa: F401
    from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
    from lipvq_tpu.config import config_factory as jax_config_factory
    from lipvq_tpu.utils import obs_utils as JaxObsUtils
    from lipvq_tpu.utils.file_utils import get_shape_metadata_from_dataset
    from lipvq_tpu.utils.file_utils import save_checkpoint as jax_save_checkpoint
    from lipvq_tpu.utils.test_utils import icl_test_config_overrides, make_synthetic_dataset

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils.file_utils import save_checkpoint
    from lipvq_tpu_torch.utils.jax_weights import load_jax_params

    root = tmp_path_factory.mktemp("carried")
    h5 = make_synthetic_dataset(str(root / "fixture.hdf5"), n_demos=N_DEMOS,
                                demo_len=DEMO_LEN)
    d = icl_test_config_overrides()
    d["train"]["data"] = h5
    d["algo"]["transformer"]["compute_dtype"] = "float32"
    jcfg = jax_config_factory("icl", d)
    JaxObsUtils.initialize_obs_utils_with_config(jcfg)
    meta = get_shape_metadata_from_dataset(h5, all_obs_keys=jcfg.all_obs_keys)
    shape_meta = {k: meta[k] for k in ("all_shapes", "all_obs_keys", "ac_dim")}
    jmodel = jax_algo_factory("icl", jcfg, meta["all_shapes"], ac_dim=meta["ac_dim"])
    jax_ckpt = str(root / "jax.ckpt")
    jax_save_checkpoint(jax_ckpt, jmodel, jcfg, shape_meta=shape_meta)

    cfg = config_factory("icl", d)
    algo = algo_factory("icl", cfg, meta["all_shapes"], ac_dim=meta["ac_dim"], device="cpu")
    extra = jax.tree.map(np.asarray, dict(jmodel.state.extra_vars or {}))
    load_jax_params(algo, jax.tree.map(np.asarray, jmodel.state.params), extra or None)
    port_ckpt = str(root / "port.ckpt")
    save_checkpoint(port_ckpt, algo, cfg, shape_meta=shape_meta)
    return {"h5": h5, "jax": jax_ckpt, "port": port_ckpt}


def _recording(monkeypatch, file_utils, log: list, before=None):
    """Wrap ``file_utils.policy_from_checkpoint`` so the policy it returns
    appends each ``get_action`` result to ``log`` (calling ``before(model)``
    first)."""
    load = file_utils.policy_from_checkpoint

    def recorded(*args, **kwargs):
        model, ckpt = load(*args, **kwargs)
        get_action = model.get_action

        def get(obs, ctx, goal=None):
            if before is not None:
                before(model)
            out = get_action(obs, ctx, goal)
            log.append(np.array(out))
            return out
        model.get_action = get
        return model, ckpt
    monkeypatch.setattr(file_utils, "policy_from_checkpoint", recorded)


@pytest.mark.parametrize("source", ["synthetic_export", "hdf5_to_export"])
def test_plot_predictions_matches_jax_on_carried_weights(carried, tmp_path, monkeypatch, source):
    import jax
    import jax.numpy as jnp

    from lipvq_tpu.algo.icl import ICLTransformerGMM as JaxICL
    from lipvq_tpu.scripts.plot_model_predictions import plot_predictions as jax_plot
    from lipvq_tpu.utils import file_utils as jax_file_utils

    from lipvq_tpu_torch.algo.icl import ICLTransformerGMM
    from lipvq_tpu_torch.data.export import hdf5_to_export
    from lipvq_tpu_torch.models.distributions import gmm_sample_from_draws
    from lipvq_tpu_torch.scripts.plot_model_predictions import plot_predictions
    from lipvq_tpu_torch.utils import file_utils
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    if source == "synthetic_export":
        export = make_synthetic_export(str(tmp_path / "export"), n_demos=N_DEMOS,
                                       demo_len=DEMO_LEN)
    else:
        export = hdf5_to_export(carried["h5"], str(tmp_path / "export"))

    shapes, keys = {}, []

    def jax_draws(key):
        k_mode, k_normal = jax.random.split(key)
        means = shapes["means"]
        return (jax.random.uniform(k_mode, shapes["logits"], jnp.float32,
                                   minval=jnp.finfo(jnp.float32).tiny, maxval=1.0),
                jax.random.normal(k_normal, tuple(means[:-2]) + tuple(means[-1:]), jnp.float32))

    def jax_head(self, dists, key):
        shapes["logits"], shapes["means"] = dists.logits.shape, dists.means.shape
        u, eps = jax_draws(key)
        mode = jnp.argmax(dists.logits - jnp.log(-jnp.log(u)), axis=-1)
        pick = mode[..., None, None]
        mean = jnp.take_along_axis(dists.means, pick, axis=-2)[..., 0, :]
        scale = jnp.take_along_axis(dists.scales, pick, axis=-2)[..., 0, :]
        return mean + scale * eps

    def port_head(self, dists, draws_=None):
        return gmm_sample_from_draws(dists, *draws.pop(0))

    monkeypatch.setattr(JaxICL, "_action_from_head", jax_head)
    monkeypatch.setattr(ICLTransformerGMM, "_action_from_head", port_head)
    preds = {"jax": [], "port": []}
    _recording(monkeypatch, jax_file_utils, preds["jax"],
               lambda model: keys.append(jax.random.split(model.state.rng)[1]))
    _recording(monkeypatch, file_utils, preds["port"])
    jax_paths = jax_plot(carried["jax"], carried["h5"], str(tmp_path / "jax_png"), n_demos=2)
    draws = [tuple(torch.from_numpy(np.array(x)) for x in jax_draws(k)) for k in keys]
    paths = plot_predictions(carried["port"], export, str(tmp_path / "png"), n_demos=2,
                             device="cpu")
    assert not draws
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jax_paths] == [
        "demo_0_predictions.png", "demo_1_predictions.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert len(preds["port"]) == len(preds["jax"]) == 2 * (DEMO_LEN - 10)
    got, want = np.stack(preds["port"]), np.stack(preds["jax"])
    assert got.shape == want.shape == (8, 1, 12)
    np.testing.assert_allclose(got, want, rtol=0, atol=PRED_ATOL)


def test_plot_without_matplotlib_draws_with_pil(carried, tmp_path, monkeypatch):
    """Where matplotlib is not installed (the card's machine) the same PNG
    files are drawn with PIL."""
    from PIL import Image

    from lipvq_tpu_torch.scripts.plot_model_predictions import plot_predictions
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=N_DEMOS, demo_len=DEMO_LEN)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    paths = plot_predictions(carried["port"], export, str(tmp_path / "png"), n_demos=3,
                             device="cpu")
    assert [os.path.basename(p) for p in paths] == [f"demo_{i}_predictions.png"
                                                    for i in range(3)]
    with Image.open(paths[0]) as img:
        assert img.size == (640, 24 + 128 * 12)


def test_plot_predictions_without_device_raises_without_gpu(carried, tmp_path, monkeypatch):
    from lipvq_tpu_torch.scripts.plot_model_predictions import plot_predictions
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=1, demo_len=12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plot_predictions(carried["port"], export, str(tmp_path / "png"))


def test_profile_utils_match_jax(tmp_path):
    from lipvq_tpu.utils import profile_utils as jax_profile

    from lipvq_tpu_torch.utils import profile_utils

    x = torch.ones(64, 64)
    calls = []

    def fn(a):
        calls.append(1)
        return {"y": a @ a, "z": [a]}

    jax_fn = lambda a: {"y": a @ a, "z": [a]}  # noqa: E731
    import jax.numpy as jnp
    for fetch, mode in ((True, "amortized"), (False, "synchronize")):
        got = profile_utils.timeit(fn, x, iters=4, warmup=1, fetch=fetch)
        want = jax_profile.timeit(jax_fn, jnp.ones((64, 64)), iters=4, warmup=1, fetch=fetch)
        assert sorted(got) == sorted(want) and got["iters"] == want["iters"] == 4
        assert got["mode"] == mode and want["mode"] == {
            "amortized": "amortized", "synchronize": "block_until_ready"}[mode]
        assert got["mean_s"] > 0 and all(math.isfinite(v) for k, v in got.items()
                                         if k.endswith("_s"))
    assert len(calls) == 2 * (1 + 4)

    with profile_utils.trace(str(tmp_path / "trace")):
        torch.mm(x, x)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "aten::mm" in f.read()

    for module in (profile_utils, jax_profile):
        timer = module.PhaseTimer()
        for name in ("data", "step", "data"):
            with timer.phase(name):
                pass
        logs = timer.logs()
        assert sorted(logs) == ["Time_data", "Time_step"]
        assert all(v >= 0 for v in logs.values())


def test_bench_loader_reports_the_jax_keys():
    """``bench_loader.main`` at a tiny size (2 batches of 2) in both packages,
    each in its own interpreter: the same JSON keys, and the port's device
    step the card's image-protocol step."""
    out = {}
    for package in ("lipvq_tpu", "lipvq_tpu_torch"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{package}.scripts.bench_loader", "--n_batches", "2",
             "--batch_size", "2"], cwd=REPO, capture_output=True, text=True, timeout=300,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        out[package] = json.loads(proc.stdout.strip().splitlines()[-1])
    jax_out, port_out = out["lipvq_tpu"], out["lipvq_tpu_torch"]
    assert list(port_out) == list(jax_out)
    assert list(port_out["keeps_device_fed"]) == list(jax_out["keeps_device_fed"])
    assert port_out["metric"] == jax_out["metric"]
    assert port_out["device_step_rate"] == round(1000 / 142.2, 2)
    assert all(port_out[k] > 0 for k in port_out["keeps_device_fed"])


def test_bench_loader_fixture_is_the_jax_fixture(tmp_path):
    """The export the port's bench builds holds the JAX bench's HDF5 arrays."""
    from lipvq_tpu.scripts.bench_loader import build_fixture as jax_build

    from lipvq_tpu_torch.data.export import Export, hdf5_to_export
    from lipvq_tpu_torch.scripts.bench_loader import build_fixture

    port = Export(build_fixture(str(tmp_path / "port"), n_demos=3, steps=5, img=8))
    jax = Export(hdf5_to_export(jax_build(str(tmp_path / "jax.hdf5"), n_demos=3, steps=5, img=8),
                                str(tmp_path / "jax")))
    assert port.demos == sorted(jax.demos) == ["demo_0", "demo_1", "demo_2"]
    for demo in port.demos:
        assert port.demo_attrs(demo) == jax.demo_attrs(demo)
        keys = ["actions", *(f"obs/{k}" for k in port.keys(demo, "obs"))]
        assert sorted(keys) == sorted(["actions", *(f"obs/{k}" for k in jax.keys(demo, "obs"))])
        for key in keys:
            a, b = port.load(demo, key), jax.load(demo, key)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _stdout(main, *args) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(*args)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("name", ["simple_config", "simple_obs_nets", "add_new_modality"])
def test_deterministic_examples_print_what_jax_prints(name):
    import importlib

    jax_example = importlib.import_module(name)
    port_example = importlib.import_module(f"lipvq_tpu_torch.examples.{name}")
    np.random.seed(0)
    want = _stdout(jax_example.main)
    np.random.seed(0)
    got = _stdout(port_example.main, *(() if name == "simple_config" else (["--device", "cpu"],)))
    assert got == want and len(want) >= 2


def test_tokenize_actions_prints_what_jax_prints():
    """The shapes and the FAST and PRISE lines equal JAX's; LipVQ's loss and
    codes (random init of each package) finite and in range."""
    import tokenize_actions as jax_example

    from lipvq_tpu_torch.examples import tokenize_actions

    want = _stdout(jax_example.main)
    got = _stdout(tokenize_actions.main, ["--device", "cpu"])
    assert len(got) == len(want) == 4
    assert got[1:] == want[1:]
    pattern = re.compile(r"LipVQ: latents \(80, 64\), loss (\S+), (\d+) codes used")
    for line in (got[0], want[0]):
        loss, codes = pattern.fullmatch(line).groups()
        assert math.isfinite(float(loss)) and 1 <= int(codes) <= 80
    assert got[2].startswith("FAST: ") and got[3].startswith("PRISE: [")


@pytest.mark.parametrize("name", ["simple_train_loop", "train_bc_rnn"])
def test_train_examples_print_finite_losses_as_jax_does(name):
    import importlib

    jax_example = importlib.import_module(name)
    port_example = importlib.import_module(f"lipvq_tpu_torch.examples.{name}")
    pattern = re.compile(r"epoch (\d): loss=(\S+)(?: vq=(\S+))?")
    lines = {}
    for label, main, args in (("jax", jax_example.main, ()),
                              ("port", port_example.main, (["--device", "cpu"],))):
        printed = _stdout(main, *args)
        lines[label] = [line for line in printed if pattern.fullmatch(line)
                        or line.startswith("rollout action:")]
    assert [pattern.sub(r"epoch \1", line) for line in lines["port"]] == [
        pattern.sub(r"epoch \1", line) for line in lines["jax"]]
    assert len(lines["port"]) == (3 if name == "simple_train_loop" else 4)
    for line in lines["port"]:
        m = pattern.fullmatch(line)
        if m:
            assert all(math.isfinite(float(v)) for v in m.groups()[1:] if v is not None)
            assert (m.group(3) is not None) == (name == "simple_train_loop")
    if name == "train_bc_rnn":
        assert lines["port"][-1] == lines["jax"][-1] == "rollout action: (1, 12)"


@pytest.mark.parametrize("name", ["simple_obs_nets", "add_new_modality", "tokenize_actions",
                                  "simple_train_loop", "train_bc_rnn"])
def test_examples_without_device_raise_without_gpu(monkeypatch, name):
    import importlib

    example = importlib.import_module(f"lipvq_tpu_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with contextlib.redirect_stdout(io.StringIO()):
            example.main([])
