"""Set or patch an attribute of an export's ``data`` group, e.g. a field of
``env_args`` (counterpart of ``lipvq_tpu/scripts/conversion/set_dataset_attr.py``;
reference scripts/conversion/set_dataset_attr.py:1-98).

``--attr env_args.<key>`` sets that key of the ``env_args`` JSON; any other
name sets the attribute itself. The value is parsed as JSON where it parses,
else kept as a string.

    python -m lipvq_tpu_torch.scripts.conversion.set_dataset_attr \\
        --dataset export_dir --attr env_args.env_name --value OpenDrawer
"""

from __future__ import annotations

import argparse
import json
import os

from lipvq_tpu_torch.data.export import Export, update_meta


def _parse(value: str):
    try:
        return json.loads(value)
    except json.JSONDecodeError:
        return value


def set_attr(dataset: str, attr: str, value: str):
    root = os.path.expanduser(dataset)
    if attr.startswith("env_args."):
        env_args = json.loads(Export(root).data_attrs.get("env_args", "{}"))
        env_args[attr.split(".", 1)[1]] = _parse(value)
        update_meta(root, data_attrs={"env_args": json.dumps(env_args)})
    else:
        update_meta(root, data_attrs={attr: _parse(value)})


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="an export directory")
    parser.add_argument("--attr", type=str, required=True)
    parser.add_argument("--value", type=str, required=True)
    ns = parser.parse_args(args)
    set_attr(ns.dataset, ns.attr, ns.value)
    print(f"set {ns.attr} on {ns.dataset}")


if __name__ == "__main__":
    main()
