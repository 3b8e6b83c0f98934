"""Tokenize action chunks with each of the swappable tokenizers (the port's
twin of the JAX package's ``examples/tokenize_actions.py``: the framework's
core capability — reference README "Policy Learning" switches). LipVQ-VAE
and the bin embedding run on the card unless ``--device cpu`` (LipVQ's
lookup is one K1 launch there); FAST and PRISE run on the host, their BPE
in the port's ``native/bpe.cpp``.

    python -m lipvq_tpu_torch.examples.tokenize_actions [--device cpu]
"""

import argparse

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.tokenizers.bin_action import AdaptiveBinActionEmbedding
from lipvq_tpu_torch.models.tokenizers.fast import FastActionTokenizer
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.models.tokenizers.prise import PriseTokenizer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu (default: CUDA)")
    device = resolve_device(parser.parse_args(argv).device)

    rng = np.random.default_rng(0)
    actions = rng.standard_normal((80, 12)).astype(np.float32) * 0.5
    x = torch.from_numpy(actions).to(device)

    # LipVQ-VAE (the paper's method)
    model = seeded_init(LipVQVAE(feature_dim=12, latent_dim=64, num_codes=256),
                        torch.Generator().manual_seed(0)).to(device)
    with torch.no_grad():
        z, loss, ids = model(x)
    print(f"LipVQ: latents {tuple(z.shape)}, loss {float(loss):.4f}, "
          f"{len(torch.unique(ids))} codes used")

    # adaptive binning
    bins = seeded_init(AdaptiveBinActionEmbedding(action_dim=12, output_dim=64),
                       torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad():
        emb = bins(x)
    print(f"Bin: embeddings {tuple(emb.shape)}")

    # FAST (DCT + BPE)
    chunks = actions.reshape(8, 10, 12)
    fast = FastActionTokenizer(vocab_size=256)
    fast.fit(chunks)
    ids = fast.encode(chunks[0])
    rec = fast.decode(ids, t=10, d=12)
    print(f"FAST: {len(ids)} tokens for a 120-float chunk, "
          f"recon MSE {np.mean((rec - chunks[0])**2):.5f}")

    # PRISE (BPE over discrete ids, native C++ backend)
    corpus = [list(rng.integers(0, 32, 8)) for _ in range(100)]
    prise = PriseTokenizer("bpe", 128)
    prise.train([[int(x) for x in w] for w in corpus], min_frequency=2,
                max_token_length=8)
    seq = [int(x) for x in corpus[0]]
    print(f"PRISE: {seq} -> {prise.encode(seq)} -> {prise.decode(prise.encode(seq))}")


if __name__ == "__main__":
    main()
