"""Hyperparameter sweep engine (counterpart of
``lipvq_tpu/utils/hyperparam_utils.py``).

Capability parity with the reference ``ConfigGenerator``
(reference: robomimic/utils/hyperparam_utils.py:14-113): declare swept
keys with ``add_param(key, name, group, values)``; keys sharing a group
sweep together (zipped), distinct groups take the cartesian product;
``generate()`` writes one JSON config per combination plus a shell script
of train commands (reference generate_icl_scripts:104).
"""

from __future__ import annotations

import itertools
import json
import os
from collections import OrderedDict


class ConfigGenerator:
    def __init__(self, base_config_file: str, script_file: str | None = None,
                 generated_config_dir: str | None = None,
                 wandb_proj_name: str | None = None):
        self.base_config_file = base_config_file
        self.script_file = script_file or os.path.splitext(
            base_config_file
        )[0] + ".sh"
        self.generated_config_dir = generated_config_dir or os.path.join(
            os.path.dirname(os.path.abspath(base_config_file)), "generated"
        )
        self.wandb_proj_name = wandb_proj_name
        # group -> list of (key, name, values, value_names)
        self.parameters: OrderedDict = OrderedDict()

    def add_param(self, key: str, name: str, group: int, values: list,
                  value_names: list | None = None):
        self.parameters.setdefault(group, []).append(
            (key, name, list(values), value_names)
        )
        return self

    @staticmethod
    def _set_nested(cfg: dict, key: str, value):
        parts = key.split("/")
        node = cfg
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def _combinations(self):
        """Yield (suffix, [(key, value), ...]) per sweep combination."""
        groups = []
        for group, params in self.parameters.items():
            lens = {len(p[2]) for p in params}
            assert len(lens) == 1, (
                f"group {group}: all params must share value count"
            )
            n = lens.pop()
            entries = []
            for i in range(n):
                kvs, name_parts = [], []
                for key, name, values, value_names in params:
                    kvs.append((key, values[i]))
                    if name:
                        vn = (
                            value_names[i]
                            if value_names is not None
                            else str(values[i])
                        )
                        name_parts.append(f"{name}_{vn}")
                entries.append((kvs, name_parts))
            groups.append(entries)
        for combo in itertools.product(*groups):
            kvs = [kv for entry in combo for kv in entry[0]]
            names = [n for entry in combo for n in entry[1]]
            suffix = "_".join(names)
            yield suffix, kvs

    def generate(self, train_cmd: str = "python -m lipvq_tpu_torch.scripts.train"):
        os.makedirs(self.generated_config_dir, exist_ok=True)
        with open(self.base_config_file) as f:
            base = json.load(f)
        base_name = base.get("experiment", {}).get("name", "exp")

        lines = ["#!/bin/bash", ""]
        paths = []
        for suffix, kvs in self._combinations():
            cfg = json.loads(json.dumps(base))  # deep copy
            for key, value in kvs:
                self._set_nested(cfg, key, value)
            name = f"{base_name}_{suffix}" if suffix else base_name
            cfg.setdefault("experiment", {})["name"] = name
            if self.wandb_proj_name:
                cfg["experiment"].setdefault("logging", {})[
                    "wandb_proj_name"
                ] = self.wandb_proj_name
            path = os.path.join(self.generated_config_dir, f"{name}.json")
            with open(path, "w") as f:
                json.dump(cfg, f, indent=4)
            paths.append(path)
            lines.append(f"{train_cmd} --config {path}")
        with open(self.script_file, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.chmod(self.script_file, 0o755)
        return paths
