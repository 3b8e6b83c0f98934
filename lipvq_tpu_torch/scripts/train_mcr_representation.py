"""MCR representation pretraining driver (counterpart of
``lipvq_tpu/scripts/train_mcr_representation.py``; reference
algo/mcr/train_representation.py:36-240 + trainer.py:28-117).

A manifest-driven video buffer (``algo/mcr_data.py``), the 5-frame TCN loss
(similarity = -L2 distance, ``num_negatives`` shuffled in-batch negatives,
the ``aligned`` ordering metric), the optional language-alignment loss
against the ``LangEncoder``'s caption embeddings, the global-norm clip at 1
then Adam (optax's chain), an evaluation on the validation buffer and
snapshots. ``num_devices`` > 1 builds the data-parallel mesh
(``parallel/mesh.py``; the ranks must be started first) and, as in the JAX
package, nothing uses it: every rank takes the whole single-device step.

    python -m lipvq_tpu_torch.scripts.train_mcr_representation \\
        --datapath corpus_dir --steps 2000 --snapshot mcr.pt
    # hermetic smoke: the synthetic corpus into an existing directory (the
    # manifest layout) or an .hdf5 file (where h5py is installed)
    python -m lipvq_tpu_torch.scripts.train_mcr_representation \\
        --build-synthetic corpus_dir --steps 5 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import ScheduledOptimizer, resolve_device
from lipvq_tpu_torch.algo.mcr import MCREncoder, load_tree_, nest
from lipvq_tpu_torch.algo.mcr_data import MCRBuffer
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.parallel.mesh import make_mesh

EPS = 1e-8


def _sim(a, b):
    """-L2 distance (models_mcr.py:154-159); the 1e-8 inside the root keeps
    the gradient finite where two sampled frames are identical."""
    return -torch.sqrt(torch.sum((a - b) ** 2, dim=-1) + 1e-8)


class RepresentationWorkspace:
    """Reference Workspace (train_representation.py:36-240), on ``device``
    (CUDA when None). The train and the validation buffer read the same
    ``datapath``, as in the JAX package (ROADMAP queue 3)."""

    def __init__(self, datapath: str, embed_dim: int = 128, lr: float = 1e-4,
                 tcnweight: float = 1.0, langweight: float = 0.0,
                 num_negatives: int = 3, batch_size: int = 16,
                 out_hw=(112, 112), alpha: float = 0.2, seed: int = 0,
                 num_devices: int | None = None, device=None):
        self.device = resolve_device(device)
        self.train_buffer = MCRBuffer(datapath, "train", alpha=alpha, out_hw=out_hw,
                                      seed=seed)
        self.val_buffer = MCRBuffer(datapath, "val", alpha=0.0, doaug="none",
                                    out_hw=out_hw, seed=seed + 1)
        self.batch_size = batch_size
        self.tcnweight = tcnweight
        self.langweight = langweight
        self.num_negatives = num_negatives
        self.global_step = 0
        self.encoder = MCREncoder(embed_dim=embed_dim)
        seeded_init(self.encoder, torch.Generator().manual_seed(seed))
        self.encoder.to(self.device)
        # the clip guards the 1/d blowup when two sampled frames are
        # (near-)identical, which synthetic corpora hit
        self.optimizer = ScheduledOptimizer(self.encoder.parameters(), torch.optim.Adam,
                                            lambda step: lr, max_grad_norm=1.0, eps=1e-8)
        self._lang = None
        # the DP mesh (reference DataParallel); as in the JAX package it is
        # built and held, and nothing uses it (ROADMAP queue 3, fault (s))
        n_dev = num_devices or 1
        self.mesh = make_mesh(n_dev, devices=[self.device]) if n_dev > 1 else None

    # ---- loss (reference trainer.py:44-117) --------------------------
    def _loss(self, frames, shuffles, lang_emb):
        """frames [B, 5, H, W, C] -> (loss, metrics); the encoder runs in
        train mode, so its BatchNorm statistics advance."""
        b, five = frames.shape[:2]
        z = self.encoder(frames.reshape((b * five,) + frames.shape[2:]), train=True)
        z = z.reshape(b, five, -1)
        e0, eg, es0, es1, es2 = (z[:, i] for i in range(5))
        metrics = {}
        loss = torch.zeros((), device=z.device)
        if self.tcnweight > 0:
            sim_0_2 = _sim(es2, es0)
            sim_1_2 = _sim(es2, es1)
            sim_0_1 = _sim(es1, es0)
            neg0 = torch.stack([_sim(es0, es0[perm]) for perm in shuffles], -1)
            neg2 = torch.stack([_sim(es2, es2[perm]) for perm in shuffles], -1)
            smooth1 = -torch.log(EPS + torch.exp(sim_1_2) / (
                EPS + torch.exp(sim_0_2) + torch.exp(sim_1_2) + torch.exp(neg2).sum(-1)))
            smooth2 = -torch.log(EPS + torch.exp(sim_0_1) / (
                EPS + torch.exp(sim_0_1) + torch.exp(sim_0_2) + torch.exp(neg0).sum(-1)))
            tcn = ((smooth1 + smooth2) / 2.0).mean()
            metrics["tcnloss"] = tcn
            metrics["aligned"] = ((sim_0_2 < sim_1_2) & (sim_0_1 > sim_0_2)).float().mean()
            loss = loss + self.tcnweight * tcn
        if self.langweight > 0:
            # progress toward the goal should align with the caption's
            # direction; sqrt(sum + eps), not a norm: a norm's gradient is
            # NaN at zero progress
            d = lang_emb / torch.clamp_min(
                torch.linalg.vector_norm(lang_emb, dim=-1, keepdim=True), EPS)
            prog = eg - e0
            progn = prog / torch.sqrt(torch.sum(prog ** 2, dim=-1, keepdim=True) + 1e-8)
            k = min(progn.shape[-1], d.shape[-1])
            langloss = -torch.mean(torch.sum(progn[..., :k] * d[..., :k], dim=-1))
            metrics["langloss"] = langloss
            loss = loss + self.langweight * langloss
        metrics["full_loss"] = loss
        return loss, metrics

    def _update(self, frames, shuffles, lang) -> dict:
        loss, metrics = self._loss(frames, shuffles, lang)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        return metrics

    # ---- loops -------------------------------------------------------
    def _batch(self, buffer, rng):
        frames, labels = buffer.sample_batch(self.batch_size)
        shuffles = np.stack([rng.permutation(self.batch_size)
                             for _ in range(self.num_negatives)])
        if self.langweight > 0:
            if self._lang is None:
                from lipvq_tpu_torch.utils.lang_utils import LangEncoder

                self._lang = LangEncoder(device=self.device)
            lang = np.asarray(self._lang.get_lang_emb(labels), np.float32)
        else:
            lang = np.zeros((self.batch_size, 8), np.float32)
        return (torch.as_tensor(frames, device=self.device),
                torch.as_tensor(shuffles, device=self.device),
                torch.as_tensor(lang, device=self.device))

    def train(self, steps: int, eval_freq: int = 0, log_every: int = 10):
        rng = np.random.default_rng(self.global_step)
        history = []
        for _ in range(steps):
            metrics = self._update(*self._batch(self.train_buffer, rng))
            self.global_step += 1
            metrics = {k: float(v.detach()) for k, v in metrics.items()}
            history.append(metrics)
            if log_every and self.global_step % log_every == 0:
                print(f"step {self.global_step}: {metrics}")
            if eval_freq and self.global_step % eval_freq == 0:
                print(f"eval {self.global_step}: {self.evaluate()}")
        return history

    def evaluate(self, n_batches: int = 2):
        """The losses of the update on validation batches, taken in train
        mode and discarded, as the JAX package does: the parameters and the
        BatchNorm statistics stay as they were."""
        rng = np.random.default_rng(10_000 + self.global_step)
        stats = {k: b.clone() for k, b in self.encoder.named_buffers()}
        outs = []
        try:
            for _ in range(n_batches):
                with torch.no_grad():
                    _, metrics = self._loss(*self._batch(self.val_buffer, rng))
                outs.append({k: float(v) for k, v in metrics.items()})
        finally:
            with torch.no_grad():
                for k, b in self.encoder.named_buffers():
                    b.copy_(stats[k])
        return {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}

    # ---- snapshots (reference :210-228) ------------------------------
    def save_snapshot(self, path: str):
        torch.save({"params": nest(dict(self.encoder.named_parameters())),
                    "extra": {"batch_stats": nest(dict(self.encoder.named_buffers()))},
                    "global_step": torch.tensor(self.global_step)}, path)

    def load_snapshot(self, path: str):
        """The parameters, BatchNorm statistics and step of a snapshot; the
        optimizer's state stays as it is, as in the JAX package."""
        snap = torch.load(path, map_location="cpu", weights_only=True)
        load_tree_(self.encoder, snap["params"], snap["extra"]["batch_stats"])
        self.global_step = int(snap.get("global_step", 0))


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--datapath", type=str, default=None)
    parser.add_argument("--build-synthetic", type=str, default=None,
                        help="emit a synthetic corpus here (an existing directory: the "
                             "manifest layout) and train on it")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--eval_freq", type=int, default=0)
    parser.add_argument("--langweight", type=float, default=0.0)
    parser.add_argument("--snapshot", type=str, default=None)
    parser.add_argument("--load_snap", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    ns = parser.parse_args(args)

    datapath = ns.datapath
    if ns.build_synthetic:
        from lipvq_tpu_torch.algo.mcr_data import build_synthetic_corpus

        datapath = build_synthetic_corpus(ns.build_synthetic)
    ws = RepresentationWorkspace(datapath, batch_size=ns.batch_size,
                                 langweight=ns.langweight, device=ns.device)
    if ns.load_snap:
        ws.load_snapshot(ns.load_snap)
    t0 = time.time()
    hist = ws.train(ns.steps, eval_freq=ns.eval_freq)
    print(f"{ns.steps} steps in {time.time() - t0:.1f}s; final: {hist[-1]}")
    if ns.snapshot:
        ws.save_snapshot(ns.snapshot)
        print(f"snapshot: {ns.snapshot}")
    return ws


if __name__ == "__main__":
    main()
