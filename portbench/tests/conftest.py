"""The tiny cells of a mix kind that the tests' tables predate: ``train_ssm``
(``harness/drivers/train_ssm.py``) takes ``train``'s tiny mix and faults,
and a configuration with a Mamba section (``icl_mamba``) is sized down in
that section, its hybrid layout kept with a period of two layers."""

from __future__ import annotations

import copy
import json

from portbench import faults
from portbench.harness import program
from portbench.tests import tiny

faults.BY_KIND.setdefault("train_ssm", faults.BY_KIND["train"])
tiny.MIXES.setdefault("train_ssm", dict(tiny.MIXES["train"], kind="train_ssm"))

_config = tiny.config
TINY_MAMBA = {"embed_dim": 32, "num_layers": 2, "num_heads": 2, "d_state": 4}
TINY_HYBRID = {"attn_layer_period": 2, "attn_layer_offset": 1, "mlp_dim": 64, "dt_rank": 0}


def config(name: str, **transformer) -> dict:
    """``tiny.config``, and for a configuration with a Mamba section that
    section at small widths."""
    raw = json.loads((tiny.ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    if "mamba" not in raw["port_config"]["algo"]:
        return _config(name, **transformer)
    pc = copy.deepcopy(raw["port_config"])
    pc["algo"]["mamba"].update(TINY_MAMBA, **transformer)
    pc["algo"]["mamba"].get("hybrid", {}).update(TINY_HYBRID)
    pc["algo"]["vq"]["num_codes"] = 32
    raw["port_config"] = pc
    return program.normalize(raw)


tiny.config = config
