"""Print the structure and statistics of an export (counterpart of
``lipvq_tpu/scripts/get_dataset_info.py``; reference
scripts/get_dataset_info.py).

The summary is the JAX script's dict, in its order: the obs keys and the
filter keys come sorted by name, as ``h5py`` lists a group's members (an
export keeps its masks in the order they were written).

    python -m lipvq_tpu_torch.scripts.get_dataset_info --dataset export_dir
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export


def dataset_info(root: str) -> dict:
    export = Export(os.path.expanduser(root))
    demos = sorted(export.demos, key=lambda e: int(e[5:]))
    lengths = [int(export.demo_attrs(d)["num_samples"]) for d in demos]
    first = demos[0]
    obs_keys = {k: list(export.shape(first, f"obs/{k}")[1:])
                for k in sorted(export.keys(first, "obs"))}
    env_meta = json.loads(export.data_attrs["env_args"])
    langs = set()
    for d in demos[:50]:
        ep_meta = export.demo_attrs(d).get("ep_meta")
        if ep_meta:
            langs.add(json.loads(ep_meta).get("lang"))
    return {
        "n_demos": len(demos),
        "total_samples": int(np.sum(lengths)),
        "traj_length_mean": float(np.mean(lengths)),
        "traj_length_min": int(np.min(lengths)),
        "traj_length_max": int(np.max(lengths)),
        "action_dim": int(export.shape(first, "actions")[1]),
        "obs_keys": obs_keys,
        "env_name": env_meta.get("env_name"),
        "filter_keys": sorted(export.masks),
        "languages": sorted(x for x in langs if x),
    }


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    ns = parser.parse_args(args)
    print(json.dumps(dataset_info(ns.dataset), indent=2))


if __name__ == "__main__":
    main()
