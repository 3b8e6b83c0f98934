"""The port's config tools against the JAX package's, on the CPU:

- the 11 template generators of ``scripts/config_gen/`` through their
  ``main`` with the same flags, ``time.strftime`` frozen: the generated
  configs and the stamped base JSON equal key for key, the runner scripts
  equal once ``lipvq_tpu.`` reads ``lipvq_tpu_torch.``;
- ``eval_ckpt``, ``eval_icl_ckpt`` and ``eval_zr_ckpt`` over each package's
  own checkpoint of the same config: equal JSON;
- ``generate_config_templates`` into a temporary ``TEMPLATE_DIR``:
  byte-equal output, and the committed ``exps/templates/`` untouched (they
  are older than the JAX generator's defaults, so the port is held against
  JAX's fresh output, never against them);
- ``generate_paper_configs``, ``hyperparam_helper`` (its 8 configs) and
  ``setup_macros`` (its target moved into ``tmp_path``).

Each pair writes into the same relative paths, one package after the
other, so paths inside the outputs are equal too.
"""

import contextlib
import importlib
import io
import json
import os
import pathlib
import shutil
import sys
import time

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
STAMP = "20260101"

# (generator, flags beyond --name / --output_dir)
TEMPLATE_CASES = [
    ("act_gen", []),
    ("act_gen", ["--mod", "im", "--task", "OpenDrawer", "CloseDrawer", "--no_wandb"]),
    ("bc_rnn_gen", []),
    ("bc_rnn_gen", ["--debug", "--n_seeds", "3"]),
    ("bc_xfmr_gen", []),
    ("bc_xfmr_gen", ["--abs_actions", "--mod", "im"]),
    ("bc_xfmr_gen_mg_data", ["--task", "OpenDrawer"]),
    ("bc_xfmr_gen_zr_data", []),
    ("diffusion_gen", []),
    ("diffusion_gen", ["--env", "libero", "--n_seeds", "2"]),
    ("icl_mamba_gen", []),
    ("icl_mamba_gen", ["--tokenizer", "bin", "--debug"]),
    ("icl_xfmr_gen", []),
    ("icl_xfmr_gen", ["--tokenizer", "fast", "--mod", "im"]),
    ("icl_xfmr_gen", ["--tokenizer", "raw", "--task", "PnPCounterToCab", "OpenDrawer",
                      "--ds_type", "mg_im"]),
    ("icl_xfmr_gen_mg_data", ["--task", "OpenDrawer", "CloseDrawer"]),
    ("icl_xfmr_gen_zr_data", ["--n_seeds", "2"]),
    ("mcr_gen", []),
    ("mcr_gen", ["--mcr_ckpt", "snapshots/mcr.msgpack", "--debug"]),
]


def _tree(root: pathlib.Path) -> dict:
    """{relative path: text} of every file under ``root``."""
    return {str(p.relative_to(root)): p.read_text() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _run(main, argv: list, monkeypatch) -> str:
    """``main()`` with ``sys.argv`` set and ``time.strftime`` frozen; its
    stdout."""
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: STAMP)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


def _port_text(text: str) -> str:
    return text.replace("lipvq_tpu.", "lipvq_tpu_torch.")


def _assert_same_outputs(jax_files: dict, port_files: dict) -> None:
    assert sorted(port_files) == sorted(jax_files)
    for name, text in jax_files.items():
        if name.endswith(".json"):
            assert json.loads(port_files[name]) == json.loads(text), name
        else:
            assert port_files[name] == _port_text(text), name


@pytest.mark.parametrize("module,flags", TEMPLATE_CASES,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(TEMPLATE_CASES)])
def test_template_generator_matches_jax(tmp_path, monkeypatch, module, flags):
    monkeypatch.chdir(tmp_path)
    argv = ["--name", "exp", "--output_dir", "out", *flags]
    outputs = {}
    for package in ("lipvq_tpu", "lipvq_tpu_torch"):
        gen = importlib.import_module(f"{package}.scripts.config_gen.{module}")
        outputs[package] = (_run(gen.main, argv, monkeypatch), _tree(tmp_path / "out"))
        shutil.rmtree(tmp_path / "out")
    (jax_out, jax_files), (port_out, port_files) = outputs["lipvq_tpu"], outputs[
        "lipvq_tpu_torch"]
    assert f"configs/exp_{STAMP}_base.json" in jax_files and "run_exp.sh" in jax_files
    generated = [n for n in jax_files if n.startswith("configs/exp/")]
    assert generated
    _assert_same_outputs(jax_files, port_files)
    assert port_out == jax_out
    runner = port_files["run_exp.sh"].splitlines()
    assert len(runner) == 2 + len(generated)
    assert all(line.startswith("python -m lipvq_tpu_torch.scripts.train --config out/configs/")
               for line in runner[2:])


@pytest.fixture(scope="module")
def icl_checkpoints(tmp_path_factory):
    """The same tiny ICL config saved by each package's ``save_checkpoint``
    (its own random weights) -> {package: checkpoint path}."""
    import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)
    from lipvq_tpu.algo.base import algo_factory as jax_algo_factory
    from lipvq_tpu.config import config_factory as jax_config_factory
    from lipvq_tpu.utils.file_utils import save_checkpoint as jax_save_checkpoint
    from lipvq_tpu.utils.test_utils import icl_test_config_overrides

    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils.file_utils import save_checkpoint

    shapes = {"robot0_eef_pos": [3], "object": [14]}
    shape_meta = {"all_shapes": shapes, "all_obs_keys": list(shapes), "ac_dim": 12}
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for package, factory, make, save in (
            ("lipvq_tpu", jax_config_factory, lambda c: jax_algo_factory("icl", c, shapes, 12),
             jax_save_checkpoint),
            ("lipvq_tpu_torch", config_factory,
             lambda c: algo_factory("icl", c, shapes, 12, device="cpu"), save_checkpoint)):
        cfg = factory("icl", icl_test_config_overrides())
        with cfg.unlocked():
            cfg.observation.modalities.obs.low_dim = list(shapes)
        out[package] = str(root / f"{package}.ckpt")
        save(out[package], make(cfg), cfg, shape_meta=shape_meta)
    return out


@pytest.mark.parametrize("module,flags,written", [
    ("eval_ckpt", ["--n_rollouts", "7"], "configs/ev_eval.json"),
    ("eval_ckpt", ["--horizon", "123"], "configs/ev_eval.json"),
    ("eval_icl_ckpt", [], "configs/ev_eval.json"),
    ("eval_zr_ckpt", ["--task", "OpenDrawer"], "configs/ev_zr.json"),
    ("eval_zr_ckpt", ["--task", "PnPCounterToCab", "--n_rollouts", "3"], "configs/ev_zr.json"),
])
def test_eval_generator_matches_jax(tmp_path, monkeypatch, icl_checkpoints, module, flags,
                                    written):
    """Each package's generator over its own checkpoint of the same config,
    copied to the same path: equal JSON and equal printed lines (the port's
    ``run:`` line names its own train script)."""
    monkeypatch.chdir(tmp_path)
    argv = ["--ckpt", "m.ckpt", "--name", "ev", "--output_dir", "out", *flags]
    outputs = {}
    for package, ckpt in icl_checkpoints.items():
        shutil.copyfile(ckpt, tmp_path / "m.ckpt")
        gen = importlib.import_module(f"{package}.scripts.config_gen.{module}")
        outputs[package] = (_run(gen.main, argv, monkeypatch), _tree(tmp_path / "out"))
        shutil.rmtree(tmp_path / "out")
    (jax_out, jax_files), (port_out, port_files) = outputs["lipvq_tpu"], outputs[
        "lipvq_tpu_torch"]
    assert list(jax_files) == [written]
    _assert_same_outputs(jax_files, port_files)
    assert port_out == _port_text(jax_out)
    assert "run: python -m lipvq_tpu_torch.scripts.train --config out/" + written in port_out
    cfg = json.loads(port_files[written])
    assert cfg["train"]["num_epochs"] == 0 and cfg["experiment"]["rollout"]["warmstart"] == -1
    assert cfg["experiment"]["ckpt_path"] == str(tmp_path / "m.ckpt")


def test_generate_config_templates_matches_jax_and_leaves_the_committed_ones(tmp_path,
                                                                            monkeypatch):
    from lipvq_tpu.scripts import generate_config_templates as jax_gen

    from lipvq_tpu_torch.scripts import generate_config_templates as gen

    committed = _tree(REPO / "exps" / "templates")
    assert gen.TEMPLATE_DIR == jax_gen.TEMPLATE_DIR == str(REPO / "exps" / "templates")
    trees = {}
    for name, module in (("jax", jax_gen), ("port", gen)):
        monkeypatch.setattr(module, "TEMPLATE_DIR", str(tmp_path / name))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module.main()
        assert out.getvalue().count("wrote ") == 14
        trees[name] = {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()}
    assert sorted(trees["port"]) == sorted(committed) and len(committed) == 14
    assert trees["port"] == trees["jax"]
    assert _tree(REPO / "exps" / "templates") == committed


@pytest.mark.parametrize("tasks", [None, ["OpenDrawer"], ["PrepareCoffee", "OpenDrawer",
                                                          "CloseSingleDoor", "PnPCabToCounter"]],
                         ids=["default", "one", "four"])
def test_generate_paper_configs_matches_jax(tmp_path, monkeypatch, tasks):
    from lipvq_tpu.scripts.generate_paper_configs import (
        generate_paper_configs as jax_generate,
    )

    from lipvq_tpu_torch.scripts.generate_paper_configs import generate_paper_configs

    monkeypatch.chdir(tmp_path)
    jax_paths = jax_generate("paper", tasks)
    jax_files = _tree(tmp_path / "paper")
    shutil.rmtree(tmp_path / "paper")
    paths = generate_paper_configs("paper", tasks)
    assert paths == jax_paths and len(paths) == len(jax_files) - 1
    files = _tree(tmp_path / "paper")
    assert files == {k: _port_text(v) if k == "run_all.sh" else v for k, v in jax_files.items()}
    assert files["run_all.sh"].count("python -m lipvq_tpu_torch.scripts.train") == len(paths)


def test_hyperparam_helper_matches_jax(tmp_path, monkeypatch):
    from lipvq_tpu.scripts.hyperparam_helper import main as jax_main

    from lipvq_tpu_torch.scripts.hyperparam_helper import main

    base = tmp_path / "base.json"
    shutil.copyfile(REPO / "exps" / "templates" / "icl_transformer.json", base)
    argv = ["--config", str(base), "--script", str(tmp_path / "sweep" / "run.sh")]
    (tmp_path / "sweep").mkdir()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_paths = jax_main(argv)
    jax_files = _tree(tmp_path / "sweep")
    shutil.rmtree(tmp_path / "sweep")
    (tmp_path / "sweep").mkdir()
    with contextlib.redirect_stdout(out):
        paths = main(argv)
    assert paths == jax_paths and len(paths) == 8  # 2 lr x 2 gmm x 2 width
    files = _tree(tmp_path / "sweep")
    _assert_same_outputs(jax_files, files)
    assert os.access(tmp_path / "sweep" / "run.sh", os.X_OK)
    cfg = json.loads(files["configs/test_plr_0.001_gmm_t_width_256.json"])
    assert cfg["algo"]["transformer"]["embed_dim"] == 256


@pytest.mark.parametrize("train_cmd", [None, "torchrun --nproc_per_node 2 train.py"])
def test_config_generator_matches_jax(tmp_path, train_cmd):
    """``ConfigGenerator`` with zipped and crossed groups, value names and a
    wandb project: the same files; only the default train command names the
    port."""
    from lipvq_tpu.utils.hyperparam_utils import ConfigGenerator as JaxGenerator

    from lipvq_tpu_torch.utils.hyperparam_utils import ConfigGenerator

    base = tmp_path / "base.json"
    base.write_text(json.dumps({"experiment": {"name": "sweep"}, "train": {"seed": 1}}))
    files = {}
    for name, cls in (("jax", JaxGenerator), ("port", ConfigGenerator)):
        gen = cls(str(base), script_file=str(tmp_path / "run.sh"),
                  generated_config_dir=str(tmp_path / "gen"), wandb_proj_name="proj")
        gen.add_param("train/seed", "seed", 0, [1, 2])
        gen.add_param("algo/lr", "", 0, [0.1, 0.2])
        gen.add_param("algo/gmm/enabled", "gmm", 1, [True, False], ["t", "f"])
        kwargs = {} if train_cmd is None else {"train_cmd": train_cmd}
        assert len(gen.generate(**kwargs)) == 4
        files[name] = {**_tree(tmp_path / "gen"), "run.sh": (tmp_path / "run.sh").read_text()}
        shutil.rmtree(tmp_path / "gen")
    if train_cmd is None:
        _assert_same_outputs(files["jax"], files["port"])
    else:
        assert files["port"] == files["jax"]


def test_setup_macros_matches_jax(tmp_path, monkeypatch, capsys):
    """``setup_macros`` writes ``macros_private.py`` beside its package's
    ``__init__`` (moved into ``tmp_path`` here) and leaves an existing one
    alone; the port's file names the port; ``LANG_EMB_KEY`` is one value."""
    import lipvq_tpu
    import lipvq_tpu_torch
    from lipvq_tpu import macros as jax_macros
    from lipvq_tpu.scripts import setup_macros as jax_setup

    from lipvq_tpu_torch import macros
    from lipvq_tpu_torch.scripts import setup_macros
    from lipvq_tpu_torch.utils import obs_utils

    written = {}
    for package, module in ((lipvq_tpu, jax_setup), (lipvq_tpu_torch, setup_macros)):
        root = tmp_path / package.__name__
        root.mkdir()
        monkeypatch.setattr(package, "__file__", str(root / "__init__.py"))
        module.main()
        module.main()
        target = root / "macros_private.py"
        assert capsys.readouterr().out.splitlines() == [
            f"wrote {target}", f"{target} already exists; edit it directly"]
        written[package.__name__] = target.read_text()
    assert written["lipvq_tpu_torch"] == _port_text(written["lipvq_tpu"])
    assert macros.LANG_EMB_KEY == obs_utils.LANG_EMB_KEY == jax_macros.LANG_EMB_KEY
    assert all(getattr(macros, k) == getattr(jax_macros, k)
               for k in ("EXPDATA_BASE_PATH", "WANDB_ENTITY", "WANDB_API_KEY"))
    assert not (REPO / "lipvq_tpu_torch" / "macros_private.py").exists()


def test_macros_private_overrides_the_port_macros(tmp_path):
    """A ``lipvq_tpu_torch/macros_private.py`` overrides the defaults, as the
    JAX package's does (a fresh interpreter over a copy of the package)."""
    import subprocess

    pkg = tmp_path / "lipvq_tpu_torch"
    pkg.mkdir()
    shutil.copyfile(REPO / "lipvq_tpu_torch" / "macros.py", pkg / "macros.py")
    (pkg / "__init__.py").write_text("")
    (pkg / "macros_private.py").write_text('EXPDATA_BASE_PATH = "/data/exp"\n')
    proc = subprocess.run([sys.executable, "-c", "from lipvq_tpu_torch import macros; "
                           "print(macros.EXPDATA_BASE_PATH, macros.LANG_EMB_KEY)"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=60,
                          env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["/data/exp", "lang_emb"]


def test_generated_icl_config_loads_through_the_port_factory(tmp_path, monkeypatch):
    """A config the port's ``icl_xfmr_gen`` writes loads through the port's
    ``config_factory`` with the generator's settings."""
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.scripts.config_gen import icl_xfmr_gen

    monkeypatch.chdir(tmp_path)
    _run(icl_xfmr_gen.main, ["--name", "exp", "--output_dir", "out", "--tokenizer", "bin"],
         monkeypatch)
    (path,) = (tmp_path / "out" / "configs" / "exp").iterdir()
    raw = json.loads(path.read_text())
    cfg = config_factory(raw.pop("algo_name"), raw)
    tc = cfg.algo.transformer
    assert (tc.bin_enabled, tc.vq_vae_enabled, tc.fast_enabled, tc.ln_act_enabled) == (
        True, False, False, False)
    assert tc.context_length == 10 and cfg.experiment.name == "exp"
    assert np.isclose(cfg.experiment.rollout.horizon, 500)
