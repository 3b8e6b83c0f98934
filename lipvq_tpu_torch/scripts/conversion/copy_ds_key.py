"""Copy arrays and groups from one export into another, demo by demo
(counterpart of ``lipvq_tpu/scripts/conversion/copy_ds_key.py``, which
copies between HDF5 files; reference scripts/copy_ds_key.py:5-32): e.g.
graft ``action_dict`` or ``actions_abs`` from a processed export onto a raw
one.

A key names an array (``actions``, ``obs/object``) or a group
(``action_dict``), whose direct arrays are copied. Only demos the target
has are written; the arrays land through ``data/export.py::add_arrays``
(``meta.json`` rewritten once, atomically).

    python -m lipvq_tpu_torch.scripts.conversion.copy_ds_key \\
        --src processed_export --target raw_export --keys action_dict actions_abs
"""

from __future__ import annotations

import argparse
import os

from lipvq_tpu_torch.data.export import Export, add_arrays


def copy_ds_keys(src: str, target: str, keys) -> int:
    """Returns the number of (demo, key) pairs copied."""
    fs, ft = Export(os.path.expanduser(src)), Export(os.path.expanduser(target))
    arrays = {}
    n = 0
    for ep in fs.demos:
        if ep not in ft.demos:
            continue
        for key in keys:
            if fs.has(ep, key):
                arrays.setdefault(ep, {})[key] = fs.load(ep, key)
            elif fs.keys(ep, key):  # a group
                arrays.setdefault(ep, {}).update(
                    {f"{key}/{k}": fs.load(ep, f"{key}/{k}") for k in fs.keys(ep, key)})
            else:
                continue
            n += 1
    if arrays:
        add_arrays(ft.root, arrays)
    return n


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=str, required=True, help="the export to copy from")
    parser.add_argument("--target", type=str, required=True, help="the export to copy into")
    parser.add_argument("--keys", type=str, nargs="+", required=True)
    ns = parser.parse_args(args)
    n = copy_ds_keys(ns.src, ns.target, ns.keys)
    print(f"copied {n} key instances {ns.src} -> {ns.target}")


if __name__ == "__main__":
    main()
