"""Offline corpus tokenization CLI (counterpart of
``lipvq_tpu/scripts/tokenize_corpus.py``): tokenize every action row of one
or more dataset exports (``data/export.py``) through a LipVQ-VAE tokenizer
on the card and write the ids back to the exports.

    python -m lipvq_tpu_torch.scripts.tokenize_corpus --datasets out_a out_b \\
        [--ckpt tokenizer.pt] [--latent_dim 208] [--num_codes 1024] [--dry_run]

``--ckpt`` is a ``LipVQVAE`` state_dict saved with ``torch.save`` (read with
``weights_only=True``); without it the tokenizer is initialized from a
generator seeded with 0 (throughput runs). It runs on CUDA unless ``--device cpu`` is
given, and with K1 unless ``--precision fast`` opts into K1f.
"""

from __future__ import annotations

import argparse
import json

import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.parallel.corpus import tokenize_export_corpus


def main(args=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--datasets", type=str, nargs="+", required=True,
                        help="dataset export directories")
    parser.add_argument("--ckpt", type=str, default=None,
                        help="tokenizer state_dict (torch.save of LipVQVAE); seeded random "
                             "init if omitted (throughput runs)")
    parser.add_argument("--action_dim", type=int, default=12)
    parser.add_argument("--latent_dim", type=int, default=208)
    parser.add_argument("--num_codes", type=int, default=1024)
    parser.add_argument("--output_key", type=str, default="lipvq_tokens")
    parser.add_argument("--dry_run", action="store_true",
                        help="measure throughput without writing")
    parser.add_argument("--device", type=str, default=None, help="default: CUDA")
    parser.add_argument("--precision", choices=("highest", "fast"), default="highest",
                        help="the lookup: K1 (exact) or the opt-in bf16 K1f")
    ns = parser.parse_args(args)

    model = LipVQVAE(feature_dim=ns.action_dim, latent_dim=ns.latent_dim,
                     num_codes=ns.num_codes)
    if ns.ckpt:
        model.load_state_dict(torch.load(ns.ckpt, map_location="cpu", weights_only=True))
    else:
        seeded_init(model, torch.Generator().manual_seed(0))
    dev = resolve_device(ns.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})")
    stats = tokenize_export_corpus(model, ns.datasets, output_key=ns.output_key, device=dev,
                                   write=not ns.dry_run, precision=ns.precision)
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
