"""Generate the private macros override file (counterpart of
``lipvq_tpu/scripts/setup_macros.py``): ``macros_private.py`` beside the
port's ``macros.py``, which imports it.

    python -m lipvq_tpu_torch.scripts.setup_macros
"""

from __future__ import annotations

import os


def main():
    import lipvq_tpu_torch

    target = os.path.join(
        os.path.dirname(os.path.abspath(lipvq_tpu_torch.__file__)),
        "macros_private.py",
    )
    if os.path.exists(target):
        print(f"{target} already exists; edit it directly")
        return
    with open(target, "w") as f:
        f.write(
            '"""Private machine-level macro overrides (git-ignored).\n'
            'Generated by lipvq_tpu_torch.scripts.setup_macros."""\n\n'
            "EXPDATA_BASE_PATH = None\n"
            "WANDB_ENTITY = None\n"
            "WANDB_API_KEY = None\n"
        )
    print(f"wrote {target}")


if __name__ == "__main__":
    main()
