"""Regenerate exps/templates/*.json from registered config defaults.

Counterpart of reference scripts/generate_config_templates.py. The ICL
templates carry the paper's settings on top of the defaults
(reference exps/templates/icl_transformer.json: gmm enabled, transformer
6L/512d/8h, supervise_all_steps + pred_future_acs, causal=false,
ln_act default tokenizer).

The port's twin of ``lipvq_tpu/scripts/generate_config_templates.py``,
built from the port's ``config_factory``. ``TEMPLATE_DIR`` is the repo's
``exps/templates/`` (JSON data shared with the JAX package).

The port-only rule: a template leaves out ``algo.mamba.hybrid`` (the
port's hybrid layout of the Mamba backbone) while it holds its defaults,
``MAMBA_HYBRID_DEFAULTS``, and keeps it when an overlay sets it. The
templates are shared with the JAX package, whose strict loader refuses a
key its config lacks, and at its defaults the sub-section changes nothing.
"""

from __future__ import annotations

import json
import os

import lipvq_tpu_torch.config  # noqa: F401
from lipvq_tpu_torch.config import REGISTERED_CONFIGS, config_factory
from lipvq_tpu_torch.config.algo_configs import MAMBA_HYBRID_DEFAULTS

TEMPLATE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "exps", "templates",
)

# per-algo template overlays (applied over defaults)
OVERLAYS = {
    "icl": {
        "experiment": {"validate": True, "rollout": {"horizon": 400}},
        "train": {
            "seq_length": 10, "frame_stack": 10, "batch_size": 100,
            "num_epochs": 2000, "max_grad_norm": 100.0,
            "hdf5_cache_mode": "low_dim", "hdf5_load_next_obs": False,
            "dataset_keys": ["actions"],
        },
        "algo": {
            "optim_params": {"policy": {
                "optimizer_type": "adamw",
                "learning_rate": {
                    "initial": 1e-4, "decay_factor": 1.0,
                    "epoch_schedule": [100],
                    "scheduler_type": "constant_with_warmup",
                },
                "regularization": {"L2": 0.01},
            }},
            "actor_layer_dims": [],
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True,
                "pred_future_acs": True, "causal": False,
                "num_layers": 6, "embed_dim": 512, "num_heads": 8,
            },
        },
    },
    "bc": {
        "algo": {"gmm": {"enabled": True}},
    },
    "diffusion_policy": {
        "train": {"seq_length": 16, "frame_stack": 2,
                  "hdf5_load_next_obs": False},
    },
    "act": {
        "train": {"seq_length": 10, "hdf5_load_next_obs": False},
    },
}
OVERLAYS["icl_mamba"] = json.loads(json.dumps(OVERLAYS["icl"]))
OVERLAYS["icl_mamba"]["algo"]["mamba"] = OVERLAYS["icl_mamba"]["algo"].pop(
    "transformer"
)


def _merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def _without_port_defaults(d: dict) -> dict:
    """``d`` without ``algo.mamba.hybrid`` where it holds its defaults (the
    port-only rule of the module docstring)."""
    mamba = d.get("algo", {}).get("mamba", {})
    if mamba.get("hybrid") == MAMBA_HYBRID_DEFAULTS:
        del mamba["hybrid"]
    return d


def main():
    os.makedirs(TEMPLATE_DIR, exist_ok=True)
    for algo_name in sorted(REGISTERED_CONFIGS):
        cfg = config_factory(algo_name)
        d = cfg.to_dict()
        _merge(d, OVERLAYS.get(algo_name, {}))
        _without_port_defaults(d)
        path = os.path.join(TEMPLATE_DIR, f"{algo_name}.json")
        with open(path, "w") as f:
            json.dump(d, f, indent=4)
        print(f"wrote {path}")
    # the paper's canonical template name
    icl_path = os.path.join(TEMPLATE_DIR, "icl.json")
    canonical = os.path.join(TEMPLATE_DIR, "icl_transformer.json")
    with open(icl_path) as f:
        data = f.read()
    with open(canonical, "w") as f:
        f.write(data)
    print(f"wrote {canonical}")


if __name__ == "__main__":
    main()
