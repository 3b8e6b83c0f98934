"""Offline tokenizer sweep, codebook sizes x EMA vs loss-based codebook
updates (counterpart of ``lipvq_tpu/scripts/tokenizer_sweep.py``).

Trains a LipVQ-VAE at each setting on the action rows of a dataset export
(``data/export.py``) and reports the last training loss, the reconstruction
MSE over the first 2^15 rows, codebook utilization (the share of codes the
eval rows use) and the rows per second of one tokenization of the whole
corpus. On the card, a loss-codebook step launches K1 once, an
EMA-codebook step K2 once; the eval forward and the tokenization launch K1
once each.

    python -m lipvq_tpu_torch.scripts.tokenizer_sweep --dataset export_dir \\
        [--codebook_sizes 256 1024 4096] [--steps 300] [--device cpu]

It runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.data.export import Export
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE

EVAL_ROWS = 1 << 15


def load_corpus(dataset_path: str) -> np.ndarray:
    """Every demo's actions, the demos in the order of their index."""
    export = Export(dataset_path)
    demos = sorted(export.demos, key=lambda e: int(e[5:]))
    return np.concatenate([np.asarray(export.load(d, "actions"), np.float32) for d in demos])


def train_step(model: LipVQVAE, optimizer: torch.optim.Optimizer, x: torch.Tensor):
    """One step on rows ``x``: the training forward (the EMA buffers advance
    with the EMA codebook), AdamW on the loss, then the EMA codebook written
    into the touched codes. Returns the loss, detached."""
    _, loss, _ = model(x, train=True)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    if model.ema_codebook:
        model.apply_ema_codebook()
    return loss.detach()


def run_setting(model: LipVQVAE, corpus: np.ndarray, steps: int, batch: int, seed: int,
                device) -> dict:
    """Train ``model`` for ``steps`` steps of ``batch`` rows drawn by
    ``np.random.default_rng(seed)``, then measure it (the keys of the JAX
    script's result but the setting's)."""
    dev = resolve_device(device)
    model.to(dev)
    # AdamW(1e-3, wd 1e-4) over every parameter (reference icl.py:885-889)
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4, eps=1e-8)
    rng = np.random.default_rng(seed)
    loss = None
    for _ in range(steps):
        idx = rng.integers(0, corpus.shape[0], batch)
        loss = train_step(model, optimizer, torch.from_numpy(corpus[idx]).to(dev))

    with torch.inference_mode():
        x = torch.from_numpy(corpus[:EVAL_ROWS]).to(dev)
        _, _, ids = model(x)
        mse = torch.mean((model.detokenize(ids) - x) ** 2)
        used = int(torch.unique(ids).numel())

        t0 = time.perf_counter()
        model.tokenize(torch.from_numpy(corpus).to(dev)).cpu()
        tput = corpus.shape[0] / (time.perf_counter() - t0)
    return {"final_train_loss": float(loss), "recon_mse": float(mse),
            "codebook_utilization": used / model.quantizer.codebook.shape[0],
            "tokenize_chunks_per_sec": round(tput, 1)}


def train_tokenizer(corpus: np.ndarray, num_codes: int, ema: bool, latent_dim: int,
                    steps: int, batch: int, seed: int = 0, device=None) -> dict:
    """One setting of the sweep on ``device`` (CUDA when None): a LipVQ-VAE
    initialized from ``seed``, trained and measured by ``run_setting``."""
    model = LipVQVAE(feature_dim=corpus.shape[1], latent_dim=latent_dim, num_codes=num_codes,
                     ema_codebook=ema)
    seeded_init(model, torch.Generator().manual_seed(seed))
    return {"num_codes": num_codes, "codebook_update": "ema" if ema else "loss",
            **run_setting(model, corpus, steps, batch, seed, device)}


def main(args=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True, help="dataset export directory")
    parser.add_argument("--codebook_sizes", type=int, nargs="+", default=[256, 1024, 4096])
    parser.add_argument("--latent_dim", type=int, default=64)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--device", type=str, default=None, help="default: CUDA")
    ns = parser.parse_args(args)

    dev = resolve_device(ns.device)
    corpus = load_corpus(ns.dataset)
    print(f"corpus: {corpus.shape[0]} chunks x {corpus.shape[1]} dims")
    results = []
    for n in ns.codebook_sizes:
        for ema in (False, True):
            r = train_tokenizer(corpus, n, ema, ns.latent_dim, ns.steps, ns.batch, device=dev)
            results.append(r)
            print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
