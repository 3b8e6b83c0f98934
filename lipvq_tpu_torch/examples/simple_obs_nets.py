"""Build and run the observation encoder stack directly (the port's twin of
the JAX package's ``examples/simple_obs_nets.py``; counterpart of reference
examples/simple_obs_nets.py). The modules run on the card unless
``--device cpu``.

    python -m lipvq_tpu_torch.examples.simple_obs_nets [--device cpu]
"""

import argparse

import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.obs_nets import (
    ObservationDecoder,
    ObservationGroupEncoder,
    obs_spec,
    spec_flat_dim,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu (default: CUDA)")
    device = resolve_device(parser.parse_args(argv).device)

    spec = obs_spec({"robot0_eef_pos": (3,), "object": (10,)})
    enc = ObservationGroupEncoder(group_specs=(("obs", spec),)).to(device)
    obs = {
        "robot0_eef_pos": torch.ones((4, 3), device=device),
        "object": torch.zeros((4, 10), device=device),
    }
    feats = enc(obs=obs)
    print("encoded features:", tuple(feats.shape))

    dec = ObservationDecoder(spec_flat_dim(spec), spec=obs_spec({"action": (7,)}))
    dec = seeded_init(dec, torch.Generator().manual_seed(1)).to(device)
    out = dec(feats)
    print("decoded action:", tuple(out["action"].shape))


if __name__ == "__main__":
    main()
