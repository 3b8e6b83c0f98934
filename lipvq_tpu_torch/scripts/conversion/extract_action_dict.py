"""Split flat action vectors into the per-component ``action_dict``, in an
export (counterpart of ``lipvq_tpu/scripts/conversion/extract_action_dict.py``,
which rewrites an HDF5 file; reference
scripts/conversion/extract_action_dict.py:12-66).

For each of ``actions`` (relative) and ``actions_abs`` (absolute) a demo
holds, it adds ``action_dict/{rel_,abs_}{pos,rot_axis_angle,rot_6d}`` and
``action_dict/gripper``, with ``base_mode`` for a mobile-base action space
and ``{rel_,abs_}{base,torso}`` for the kitchen's 12-dim one: the arrays the
JAX script writes, the same values and dtypes. The arrays land through
``data/export.py::add_arrays`` (``meta.json`` rewritten once, atomically).

    python -m lipvq_tpu_torch.scripts.conversion.extract_action_dict \\
        --dataset demos_export
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export, add_arrays
from lipvq_tpu_torch.utils.action_utils import axis_angle_to_rot_6d

SPECS = [
    {"key": "actions", "prefix": "rel_"},
    {"key": "actions_abs", "prefix": "abs_"},
]


def extract_action_dict(dataset: str) -> int:
    """Returns the number of demo / spec pairs written."""
    root = os.path.expanduser(dataset)
    export = Export(root)
    arrays: dict[str, dict[str, np.ndarray]] = {}
    n_updated = 0
    for spec in SPECS:
        key, prefix = spec["key"], spec["prefix"]
        for demo in export.demos:
            if not export.has(demo, key):
                continue
            act = np.asarray(export.load(demo, key), dtype=np.float32)
            rot = act[:, 3:6]
            out = {
                prefix + "pos": act[:, :3],
                prefix + "rot_axis_angle": rot,
                prefix + "rot_6d": axis_angle_to_rot_6d(rot).astype(np.float32),
                "gripper": act[:, 6:7],
            }
            if act.shape[1] >= 8:  # mobile-base action spaces
                out["base_mode"] = act[:, -1:]
            if act.shape[1] == 12:
                out[prefix + "base"] = act[:, 7:10]
                out[prefix + "torso"] = act[:, 10:11]
            arrays.setdefault(demo, {}).update(
                {f"action_dict/{k}": v for k, v in out.items()})
            n_updated += 1
    if arrays:
        add_arrays(root, arrays)
    return n_updated


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    ns = parser.parse_args(args)
    n = extract_action_dict(ns.dataset)
    print(f"wrote action_dict for {n} demo/spec pairs in {ns.dataset}")


if __name__ == "__main__":
    main()
