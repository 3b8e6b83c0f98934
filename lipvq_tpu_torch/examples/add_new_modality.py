"""Register a custom observation modality + encoder core (the port's twin
of the JAX package's ``examples/add_new_modality.py``; counterpart of
reference examples/add_new_modality.py). The encoder runs on the card
unless ``--device cpu``.

    python -m lipvq_tpu_torch.examples.add_new_modality [--device cpu]
"""

import argparse

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.obs_nets import ObservationEncoder, obs_spec
from lipvq_tpu_torch.utils import obs_utils as ObsUtils


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu (default: CUDA)")
    device = resolve_device(parser.parse_args(argv).device)

    # 1. register key->modality mappings directly (the config path does
    # this automatically from observation.modalities)
    ObsUtils.register_obs_keys({"tactile": "low_dim", "depth_map": "rgb"})
    print("tactile modality:", ObsUtils.OBS_KEYS_TO_MODALITIES["tactile"])

    # 2. per-modality processing: rgb-like keys scale to [0, 1]
    raw = (np.random.rand(4, 16, 16, 3) * 255).astype(np.uint8)
    processed = ObsUtils.process_obs(raw, obs_key="depth_map")
    print("processed range:", processed.min(), processed.max())

    # 3. encoders pick cores per key via the encoder_cores spec
    spec = obs_spec({"tactile": (6,), "depth_map": (16, 16, 3)})
    enc = ObservationEncoder(
        spec,
        encoder_cores=(("depth_map", "VisualCore:feature_dimension=8,num_kp=4"),),
    )
    enc = seeded_init(enc, torch.Generator().manual_seed(0)).to(device)
    obs = {
        "tactile": torch.zeros((2, 6), device=device),
        "depth_map": torch.zeros((2, 16, 16, 3), device=device),
    }
    with torch.no_grad():
        out = enc(obs)
    print("encoded:", tuple(out.shape))  # 6 low-dim + 8 visual features


if __name__ == "__main__":
    main()
