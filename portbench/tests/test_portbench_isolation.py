"""No run loads JAX or the JAX package, the reference imports nothing of the
program, and a run that finds no card fails without falling back to the
CPU or printing a result."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from portbench.harness import common
from portbench.tests.tiny import ROOT

HERE = ROOT / "portbench"


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["lipvq_tpu_torch", "lipvq_tpu_torch.algo", "lipvq_tpux", "numpy", "jaxtyping"]
    assert common.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "lipvq_tpu",
           "lipvq_tpu.models"]
    assert common.forbidden_modules(mods + bad) == sorted(bad)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_counts_import_nothing_of_the_program():
    for path in list((HERE / "reference").glob("*.py")) + list((HERE / "counts").glob("*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"lipvq_tpu_torch", "lipvq_tpu", "jax", "flax", "jaxlib"}, path


def test_the_harness_and_the_port_it_drives_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, 'portbench'); import run; "
        "from portbench.harness import common, driver, program, trace, weights; "
        "from portbench.harness.drivers import closed_loop, corpus, train; "
        "import portbench.faults; "
        "import portbench.control; "
        "import lipvq_tpu_torch.algo, lipvq_tpu_torch.algo.rollout_policy, "
        "lipvq_tpu_torch.envs.vector_env, lipvq_tpu_torch.envs.env_synthetic, "
        "lipvq_tpu_torch.data.loaders, lipvq_tpu_torch.utils.train_utils, "
        "lipvq_tpu_torch.parallel.corpus, lipvq_tpu_torch.ops._build; "
        "print(common.forbidden_modules())")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "lowdim.corpus",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr
