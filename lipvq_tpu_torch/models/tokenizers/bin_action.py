"""Adaptive uniform-bin action tokenizer (counterpart of
``lipvq_tpu/models/tokenizers/bin_action.py``).

- running per-dimension min / max over training batches, frozen after
  ``num_step_stop`` updating forward calls; the buffers ``running_min``
  (+inf), ``running_max`` (-inf) and ``num_step`` (int32 0) are the flax
  ``bin_stats`` collection and travel in checkpoints;
- before the first update the bounds fall back to the batch's own;
- uniform bins per dimension, ``ceil(raw - 1)`` clamped to [0, num_bins - 1]
  (torch ``bucketize`` then the reference's clamp, an input exactly on an
  interior boundary going to the lower bin);
- one [num_bins, embedding_dim] table per dimension (one [A, NB, E]
  parameter, N(0, 1)), gathered and concatenated, then a 2-layer GELU MLP.

The update runs on the device with ``torch.where`` on the step count, so a
training step never waits on the host.
"""

from __future__ import annotations

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear, gelu_exact


class AdaptiveBinActionEmbedding(nn.Module):
    def __init__(self, action_dim: int, output_dim: int, num_bins: int = 20,
                 embedding_dim: int = 64, num_step_stop: int = 10000):
        super().__init__()
        self.action_dim, self.num_bins, self.num_step_stop = action_dim, num_bins, num_step_stop
        self.embedding_tables = nn.Parameter(torch.empty(action_dim, num_bins, embedding_dim))
        self.out1 = TorchLinear(embedding_dim * action_dim, embedding_dim * action_dim // 2)
        self.out2 = TorchLinear(embedding_dim * action_dim // 2, output_dim)
        self.register_buffer("running_min", torch.full((action_dim,), float("inf")))
        self.register_buffer("running_max", torch.full((action_dim,), float("-inf")))
        self.register_buffer("num_step", torch.zeros((), dtype=torch.int32))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.embedding_tables.normal_(0.0, 1.0, generator=generator)

    mesh = None  # set by Algo.attach_mesh

    def discretize(self, actions, lo, hi):
        """Bin indices [B, A] int64 of actions [B, A] between lo and hi [A]."""
        width = (hi - lo) / self.num_bins
        safe_width = torch.where(width > 0, width, torch.ones_like(width))
        raw = (actions - lo[None, :]) / safe_width[None, :]
        return torch.clamp(torch.ceil(raw - 1.0).long(), 0, self.num_bins - 1)

    def forward(self, actions, update_stats: bool = True):
        """actions [B, action_dim] -> embeddings [B, output_dim]; with
        ``update_stats`` the running bounds take this batch first. Under a
        data-parallel ``mesh`` the batch's bounds are the global batch's."""
        if self.mesh is not None:
            batch_min, batch_max = self.mesh.extrema(actions.detach())
        else:
            batch_min = actions.detach().amin(0)
            batch_max = actions.detach().amax(0)
        if update_stats:
            with torch.no_grad():
                enabled = self.num_step < self.num_step_stop
                self.running_min.copy_(torch.where(
                    enabled, torch.minimum(self.running_min, batch_min), self.running_min))
                self.running_max.copy_(torch.where(
                    enabled, torch.maximum(self.running_max, batch_max), self.running_max))
                self.num_step.add_(enabled.to(torch.int32))
        lo = torch.where(torch.isfinite(self.running_min), self.running_min, batch_min)
        hi = torch.where(torch.isfinite(self.running_max), self.running_max, batch_max)
        idx = self.discretize(actions, lo, hi)  # [B, A]
        dims = torch.arange(self.action_dim, device=actions.device)
        emb = self.embedding_tables[dims[None, :], idx]  # [B, A, E]
        h = gelu_exact(self.out1(emb.reshape(actions.shape[0], -1)))
        return gelu_exact(self.out2(h))
