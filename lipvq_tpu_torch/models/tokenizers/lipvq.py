"""LipVQ-VAE, the paper's action tokenizer (counterpart of
``lipvq_tpu/models/tokenizers/lipvq.py``).

- encoder: Linear(feature, 64) -> GELU -> Linear(64, hidden) -> GELU
- to_latent: Lipschitz-constrained linear (L-inf row norm bounded by
  softplus(ci)) with sigmoid output
- quantizer: plain L2 nearest-neighbour codebook lookup through
  ``vq_nearest`` (kernel K1 on the card), **no straight-through estimator**:
  z_q = codebook[ids], so gradients reach the codebook through the recon and
  codebook losses and the encoder only through the commitment loss
- decoder: Linear(latent, 64) -> GELU -> Linear(64, hidden) -> GELU ->
  Linear(hidden, feature)
- loss = recon + 0.25 * commit + 0.25 * codebook; the returned latent is
  detached, so the policy loss never trains the tokenizer.
- ``ema_codebook``: the codebook trains through EMA cluster statistics
  instead of the codebook loss (loss = recon + 0.25 * commit). In a
  training forward one call of ``vq_nearest_with_stats`` (kernel K2 on the
  card) gives the ids, counts and sums, which update the buffers
  ``ema_cluster_size`` [N] and ``ema_embed_sum`` [N, D];
  ``apply_ema_codebook`` then writes the smoothed means into the codebook
  after the optimizer step, as the JAX train step does.

The tokenizer always runs in fp32, whatever the backbone's compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import TorchLinear, gelu_exact
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest, vq_nearest_with_stats


def lipschitz_normalize(w_row_major: torch.Tensor, ci: torch.Tensor) -> torch.Tensor:
    """Scale each row of ``w`` [out, in] by min(1, softplus(ci) / sum|row|)."""
    absrowsum = w_row_major.abs().sum(dim=1, keepdim=True)
    scale = torch.clamp(F.softplus(ci)[:, None] / absrowsum, max=1.0)
    return w_row_major * scale


class LipschitzDense(nn.Module):
    """Lipschitz-normalized linear with sigmoid output. W [out, in] ~ N(0, 1),
    b zeros, ci ones (the flax params ``W``, ``b``, ``ci`` as they are)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.W = nn.Parameter(torch.empty(features, in_features))
        self.b = nn.Parameter(torch.empty(features))
        self.ci = nn.Parameter(torch.empty(features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.W.normal_(0.0, 1.0, generator=generator)
            self.b.zero_()
            self.ci.fill_(1.0)

    def forward(self, x):
        w_norm = lipschitz_normalize(self.W, self.ci)
        return torch.sigmoid(F.linear(x, w_norm, self.b))


class LFQQuantizer(nn.Module):
    """Learnable-codebook L2 nearest-neighbour quantizer; codebook [N, D]
    initialized U(+-sqrt(6 / D)) (torch kaiming_uniform_ defaults)."""

    def __init__(self, num_codes: int, code_dim: int):
        super().__init__()
        self.codebook = nn.Parameter(torch.empty(num_codes, code_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        bound = math.sqrt(6.0 / self.codebook.shape[1])
        with torch.no_grad():
            self.codebook.uniform_(-bound, bound, generator=generator)

    def forward(self, z_e):
        ids = vq_nearest(z_e, self.codebook)
        z_q = self.codebook[ids]  # differentiable wrt the codebook
        return z_q, ids

    def forward_with_stats(self, z_e):
        """As ``forward``, plus the cluster stats (counts [N], sums [N, D]) of
        the ids, from one lookup."""
        ids, counts, sums = vq_nearest_with_stats(z_e, self.codebook)
        return self.codebook[ids], ids, counts, sums

    def embed(self, ids):
        return self.codebook[ids]


class LipVQVAE(nn.Module):
    """The paper's LipVQ-VAE tokenizer (reference LLFQVAE_V4)."""

    def __init__(self, feature_dim: int, latent_dim: int, num_codes: int = 1024,
                 hidden_dim: int = 128, ema_codebook: bool = False,
                 ema_decay: float = 0.99, ema_eps: float = 1e-5):
        super().__init__()
        self.ema_codebook = ema_codebook
        self.ema_decay = ema_decay
        self.ema_eps = ema_eps
        if ema_codebook:
            self.register_buffer("ema_cluster_size", torch.zeros(num_codes))
            self.register_buffer("ema_embed_sum", torch.zeros(num_codes, latent_dim))
        self.enc1 = TorchLinear(feature_dim, 64)
        self.enc2 = TorchLinear(64, hidden_dim)
        self.to_latent = LipschitzDense(hidden_dim, latent_dim)
        self.quantizer = LFQQuantizer(num_codes, latent_dim)
        self.dec1 = TorchLinear(latent_dim, 64)
        self.dec2 = TorchLinear(64, hidden_dim)
        self.to_output = TorchLinear(hidden_dim, feature_dim)

    def encode(self, x):
        h = gelu_exact(self.enc1(x))
        h = gelu_exact(self.enc2(h))
        return self.to_latent(h)

    def decode(self, z_q):
        h = gelu_exact(self.dec1(z_q))
        h = gelu_exact(self.dec2(h))
        return self.to_output(h)

    def forward(self, x, train: bool = False):
        """x [B, feature_dim] -> (z_latent [B, latent_dim], loss, ids [B]).
        With the EMA codebook, a training forward also updates the EMA
        buffers (in place, outside autograd)."""
        x = x.float()
        z_e = self.encode(x)
        if self.ema_codebook and train:
            z_q, ids, counts, sums = self.quantizer.forward_with_stats(z_e)
            with torch.no_grad():
                d = self.ema_decay
                self.ema_cluster_size.copy_(d * self.ema_cluster_size + (1 - d) * counts)
                self.ema_embed_sum.copy_(d * self.ema_embed_sum + (1 - d) * sums)
        else:
            z_q, ids = self.quantizer(z_e)
        x_recon = self.decode(z_q)
        recon_loss = torch.mean((x_recon - x) ** 2)
        commitment_loss = torch.mean((z_q.detach() - z_e) ** 2)
        if self.ema_codebook:
            loss = recon_loss + 0.25 * commitment_loss
        else:
            codebook_loss = torch.mean((z_q - z_e.detach()) ** 2)
            loss = recon_loss + 0.25 * commitment_loss + 0.25 * codebook_loss
        return z_q.detach(), loss, ids

    @torch.no_grad()
    def apply_ema_codebook(self) -> None:
        """Write the EMA codebook into ``quantizer.codebook`` in place; codes
        never assigned keep their value."""
        self.quantizer.codebook.copy_(apply_ema_codebook(
            self.quantizer.codebook, self.ema_cluster_size, self.ema_embed_sum,
            eps=self.ema_eps))

    def tokenize(self, x):
        """Encode + quantize only: x -> token ids."""
        _, ids = self.quantizer(self.encode(x.float()))
        return ids

    def detokenize(self, ids):
        """ids -> reconstructed actions via codebook + decoder."""
        return self.decode(self.quantizer.embed(ids))


def apply_ema_codebook(codebook, ema_cluster_size, ema_embed_sum, eps: float = 1e-5):
    """New codebook from EMA stats (VQ-VAE-2 Laplace smoothing); rows of codes
    whose EMA count is 0 keep their current value."""
    num_codes = codebook.shape[0]
    n = ema_cluster_size.sum()
    smoothed = (ema_cluster_size + eps) / (n + num_codes * eps) * n
    new_codebook = ema_embed_sum / smoothed[:, None]
    touched = (ema_cluster_size > 0)[:, None]
    return torch.where(touched, new_codebook, codebook)
