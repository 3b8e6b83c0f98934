"""Strip the MimicGen ``MG_`` prefix from an export's env name (counterpart
of ``lipvq_tpu/scripts/conversion/remove_mg_env_label.py``; reference
scripts/conversion/remove_mg_env_label.py:1-27): MimicGen writes names such
as ``MG_OpenDrawer``, the training envs are registered without the prefix.

    python -m lipvq_tpu_torch.scripts.conversion.remove_mg_env_label --dataset export_dir
"""

from __future__ import annotations

import argparse
import json
import os

from lipvq_tpu_torch.data.export import Export, update_meta


def remove_mg_label(dataset: str) -> str:
    root = os.path.expanduser(dataset)
    env_args = json.loads(Export(root).data_attrs["env_args"])
    name = env_args.get("env_name", "")
    if name.startswith("MG_"):
        env_args["env_name"] = name[3:]
        update_meta(root, data_attrs={"env_args": json.dumps(env_args)})
    return env_args["env_name"]


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    ns = parser.parse_args(args)
    name = remove_mg_label(ns.dataset)
    print(f"env_name is now {name!r}")


if __name__ == "__main__":
    main()
