"""Create train / valid filter keys in an export (counterpart of
``lipvq_tpu/scripts/split_train_val.py``, which writes them into an HDF5
file; reference scripts/split_train_val.py).

It writes the masks ``[<filter_key>_]train`` and ``[<filter_key>_]valid``,
with ``max(1, round(ratio x demos))`` demos held out, drawn by the JAX
script's ``default_rng(seed).permutation``: the same seed splits an export
and its HDF5 file alike.

    python -m lipvq_tpu_torch.scripts.split_train_val --dataset export_dir --ratio 0.1
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export, update_meta


def split_train_val_from_export(root: str, val_ratio: float = 0.1,
                                filter_key: str | None = None, seed: int = 0):
    """-> (train demos, valid demos); the masks land in ``meta.json``."""
    root = os.path.expanduser(root)
    export = Export(root)
    if filter_key is not None:
        demos = export.mask(filter_key)
    else:
        demos = sorted(export.demos, key=lambda e: int(e[5:]))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(demos))
    n_val = max(1, int(round(val_ratio * len(demos))))
    val = sorted(order[:n_val])
    train = sorted(order[n_val:])
    name_prefix = f"{filter_key}_" if filter_key else ""
    update_meta(root, masks={f"{name_prefix}train": [demos[i] for i in train],
                             f"{name_prefix}valid": [demos[i] for i in val]})
    return len(train), len(val)


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    parser.add_argument("--ratio", type=float, default=0.1)
    parser.add_argument("--filter_key", type=str, default=None)
    ns = parser.parse_args(args)
    n_train, n_val = split_train_val_from_export(ns.dataset, ns.ratio, ns.filter_key)
    print(f"train: {n_train} demos, valid: {n_val} demos")


if __name__ == "__main__":
    main()
