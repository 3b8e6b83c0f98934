"""The port stands alone: it imports no JAX and nothing of ``lipvq_tpu``,
and its entry points run on the card unless told otherwise."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "h5py", "lipvq_tpu")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
import lipvq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lipvq_tpu_torch.__path__, "lipvq_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("lipvq_tpu_torch.algo.icl", "lipvq_tpu_torch.ops.vq_lookup",
             "lipvq_tpu_torch.utils.train_utils", "lipvq_tpu_torch.data.loaders",
             "lipvq_tpu_torch.utils.tensor_utils"):
    assert name in names, (name, names)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), loaded)
assert not loaded, loaded
"""


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter: the test process itself has JAX loaded."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "lipvq_tpu_torch").rglob("*.py"),
                                        REPO / "chip_smoke.py"]))
def test_source_imports_nothing_of_jax(path):
    found = _IMPORT_LINE.findall((REPO / path).read_text())
    assert not found, f"{path} imports {found}"


def test_algo_factory_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_factory("icl", {"algo": {"gmm": {"enabled": True},
                                          "transformer": {"enabled": True,
                                                          "vq_vae_enabled": True}}})
    shapes = {"robot0_eef_pos": [3], "robot0_eef_quat": [4],
              "robot0_gripper_qpos": [2], "object": [14]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo_factory("icl", cfg, shapes, ac_dim=12)
