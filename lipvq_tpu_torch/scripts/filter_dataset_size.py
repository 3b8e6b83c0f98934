"""Create filter keys that limit the demo count, in an export (counterpart
of ``lipvq_tpu/scripts/filter_dataset_size.py``; reference
scripts/filter_dataset_size.py): the ``<n>_demos`` subsets of data-scaling
sweeps, the first n of one seeded permutation, as the JAX script draws
them.

    python -m lipvq_tpu_torch.scripts.filter_dataset_size --dataset export_dir --sizes 10 50
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export, update_meta


def filter_dataset_size(root: str, sizes: list[int], seed: int = 0):
    root = os.path.expanduser(root)
    demos = sorted(Export(root).demos, key=lambda e: int(e[5:]))
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(demos))
    masks = {}
    for n in sizes:
        assert n <= len(demos), f"{n} > {len(demos)} demos"
        masks[f"{n}_demos"] = [demos[i] for i in sorted(order[:n])]
    update_meta(root, masks=masks)


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    parser.add_argument("--sizes", type=int, nargs="+", required=True)
    ns = parser.parse_args(args)
    filter_dataset_size(ns.dataset, ns.sizes)
    print(f"wrote filter keys for sizes {ns.sizes}")


if __name__ == "__main__":
    main()
