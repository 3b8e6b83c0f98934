"""Stamp robomimic env metadata onto a raw robosuite-collected HDF5 file,
into an export (counterpart of
``lipvq_tpu/scripts/conversion/convert_robosuite.py``, which stamps the
HDF5 file in place; reference scripts/conversion/convert_robosuite.py:1-112).

The raw file is read through ``data/export.py::hdf5_to_export`` (``h5py``
imported there); the export then gets what the JAX script writes into the
file: ``env_args`` (the name from ``--env_name``, else the raw file's
``env`` or ``env_name`` attribute; robosuite type 1), ``num_samples`` for
each demo with ``actions`` that lacks it, and where the file has no filter
mask an ``all`` mask of every demo, sorted by name.

    python -m lipvq_tpu_torch.scripts.conversion.convert_robosuite \\
        --dataset raw.hdf5 --output export_dir --env_name OpenDrawer
"""

from __future__ import annotations

import argparse
import json

from lipvq_tpu_torch.data.export import Export, hdf5_to_export, update_meta
from lipvq_tpu_torch.envs.env_base import EnvType


def convert_robosuite(dataset: str, output: str, env_name: str | None = None,
                      env_kwargs: dict | None = None) -> dict:
    export = Export(hdf5_to_export(dataset, output))
    attrs = export.data_attrs
    # raw robosuite files keep the env name in data.attrs["env"]
    name = env_name or attrs.get("env") or attrs.get("env_name")
    env_args = {"env_name": str(name), "type": EnvType.ROBOSUITE_TYPE,
                "env_kwargs": dict(env_kwargs or {})}
    # every demo gets num_samples (older collections omit it)
    demo_attrs = {d: {"num_samples": export.shape(d, "actions")[0]} for d in export.demos
                  if "num_samples" not in export.demo_attrs(d) and export.has(d, "actions")}
    masks = {} if export.masks else {"all": sorted(export.demos)}
    update_meta(output, masks=masks, data_attrs={"env_args": json.dumps(env_args)},
                demo_attrs=demo_attrs)
    return env_args


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="the raw robosuite HDF5 file")
    parser.add_argument("--output", type=str, required=True, help="the export directory to write")
    parser.add_argument("--env_name", type=str, default=None)
    parser.add_argument("--env_kwargs", type=str, default="{}", help="json dict of env kwargs")
    ns = parser.parse_args(args)
    env_args = convert_robosuite(ns.dataset, ns.output, ns.env_name, json.loads(ns.env_kwargs))
    print(f"stamped env_args: {env_args}")


if __name__ == "__main__":
    main()
