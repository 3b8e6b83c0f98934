"""Sibling VQ tokenizers of the ablation (counterpart of
``lipvq_tpu/models/tokenizers/vqvae.py``).

- ``VQVAE``          plain MLP encoder / decoder, L2-argmin codebook through
                     ``ops/vq_lookup.vq_nearest`` (kernel K1 on a CUDA
                     tensor), straight-through estimator
                     (reference vq_vae/backbone.py)
- ``LFQVAE``         unit-sphere "quantizer", recon loss only
                     (reference vq_vae/backbone_lfqvae.py)
- ``SpectralLFQVAE`` LFQVAE with a spectral-norm encoder
                     (reference vq_vae/backbone_lfqvae_lipschitz.py)
- ``LSTMVQVAE``      3-layer LSTM encoder / decoder over [B, 10, D] windows
                     with soft softmax(-d2) quantization + straight-through
                     estimator (reference vq_vae/backbone_lstm.py; the batch
                     is free, seq_len fixed at 10, as in the JAX package)

Each returns ``(z_latent, loss)`` (``VQVAE`` also the ids), ``z_latent``
detached. Layer lists keep the flax names (``enc_0..2``, ``dec_0..2``,
``OptimizedLSTMCell_0..2``), so ``utils/jax_weights.py`` bridges JAX params.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import SpectralNormLinear, TorchLinear, gelu_exact
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest


def uniform_codebook_init(codebook: torch.Tensor, generator: torch.Generator) -> None:
    """torch ``embedding.weight.data.uniform_(-1/N, 1/N)`` (backbone.py:36)."""
    bound = 1.0 / codebook.shape[0]
    with torch.no_grad():
        codebook.uniform_(-bound, bound, generator=generator)


def _mlp_pair(module: nn.Module, feature_dim: int, latent_dim: int, enc_cls=TorchLinear):
    """``enc_0..2``: feature -> 64 -> 128 -> latent; ``dec_0..2``: latent ->
    128 -> 64 -> feature."""
    for i, (a, b) in enumerate(((feature_dim, 64), (64, 128), (128, latent_dim))):
        module.add_module(f"enc_{i}", enc_cls(a, b))
    for i, (a, b) in enumerate(((latent_dim, 128), (128, 64), (64, feature_dim))):
        module.add_module(f"dec_{i}", TorchLinear(a, b))


def _decode(module: nn.Module, z):
    for i in range(3):
        z = F.relu(getattr(module, f"dec_{i}")(z))  # quirk: output ReLU (backbone.py:31)
    return z


class VQVAE(nn.Module):
    """Plain VQ-VAE with the straight-through estimator (reference
    backbone.py); ``embedding`` [N, latent] ~ U(+-1/N)."""

    def __init__(self, feature_dim: int, latent_dim: int, num_embeddings: int = 128,
                 commitment_cost: float = 0.25):
        super().__init__()
        self.commitment_cost = commitment_cost
        _mlp_pair(self, feature_dim, latent_dim)
        self.embedding = nn.Parameter(torch.empty(num_embeddings, latent_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        uniform_codebook_init(self.embedding, generator)

    def encode(self, x):
        for i in range(3):
            x = F.relu(getattr(self, f"enc_{i}")(x))  # the encoder ends in ReLU too
        return x

    def decode(self, z):
        return _decode(self, z)

    def quantize(self, z_e):
        ids = vq_nearest(z_e, self.embedding)
        z_q = self.embedding[ids]
        commitment_loss = self.commitment_cost * torch.mean((z_q.detach() - z_e) ** 2)
        embedding_loss = torch.mean((z_q - z_e.detach()) ** 2)
        # straight-through estimator (backbone.py:74)
        z_q = z_e + (z_q - z_e).detach()
        return z_q, embedding_loss + commitment_loss, ids

    def forward(self, x):
        """x [B, feature_dim] -> (z_latent [B, latent], loss, ids [B])."""
        z_e = self.encode(x)
        z_q, quantization_loss, ids = self.quantize(z_e)
        recon_loss = torch.mean((self.decode(z_q) - x) ** 2)
        return z_q.detach(), recon_loss + quantization_loss, ids


def _sphere(z_e):
    """F.normalize(z, p=2, dim=-1): the norm clamped at 1e-12."""
    return z_e / torch.clamp(torch.linalg.vector_norm(z_e, dim=-1, keepdim=True), min=1e-12)


class LFQVAE(nn.Module):
    """Unit-sphere 'quantizer'; recon loss only (reference
    backbone_lfqvae.py)."""

    def __init__(self, feature_dim: int, latent_dim: int):
        super().__init__()
        _mlp_pair(self, feature_dim, latent_dim)

    def forward(self, x):
        z_e = x
        for i in range(3):
            z_e = F.relu(getattr(self, f"enc_{i}")(z_e))
        z_q = _sphere(z_e)
        return z_q.detach(), torch.mean((_decode(self, z_q) - x) ** 2)


class SpectralLFQVAE(nn.Module):
    """LFQVAE with spectral-norm encoder layers (reference
    backbone_lfqvae_lipschitz.py:14-21); ``update_stats`` advances their
    power-iteration vectors ``u``."""

    def __init__(self, feature_dim: int, latent_dim: int):
        super().__init__()
        _mlp_pair(self, feature_dim, latent_dim, enc_cls=SpectralNormLinear)

    def forward(self, x, update_stats: bool = True):
        z_e = x
        for i in range(3):
            z_e = F.relu(getattr(self, f"enc_{i}")(z_e, update_stats=update_stats))
        z_q = _sphere(z_e)
        return z_q.detach(), torch.mean((_decode(self, z_q) - x) ** 2)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell`` with its four gates packed, in the order
    i, f, g, o: ``w_ih`` [4H, in] (no bias), ``w_hh`` [4H, H], ``b_hh``
    [4H]; sigmoid gates, tanh cell input and output."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * hidden, in_features))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden))

    def init_weights(self, generator: torch.Generator) -> None:
        """U(+-1/sqrt(H)) kernels (torch ``nn.LSTM``'s), zero bias (flax's)."""
        bound = 1.0 / math.sqrt(self.w_hh.shape[1])
        with torch.no_grad():
            self.w_ih.uniform_(-bound, bound, generator=generator)
            self.w_hh.uniform_(-bound, bound, generator=generator)
            self.b_hh.zero_()

    def forward(self, xs):
        """xs [B, T, in] -> hidden states [B, T, H], from a zero carry."""
        b, t, _ = xs.shape
        hidden = self.w_hh.shape[1]
        gates_x = F.linear(xs, self.w_ih)  # every step's input part in one product
        h = c = xs.new_zeros(b, hidden)
        out = []
        for s in range(t):
            i, f, g, o = (gates_x[:, s] + F.linear(h, self.w_hh, self.b_hh)).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMStack(nn.Module):
    """Unidirectional LSTM layers over [B, T, D], batch-major (the JAX
    ``_LSTMStack``: cells ``OptimizedLSTMCell_0..``)."""

    def __init__(self, in_features: int, hidden: int, num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}", LSTMCell(in_features if i == 0 else hidden,
                                                               hidden))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"OptimizedLSTMCell_{i}")(x)
        return x


class LSTMVQVAE(nn.Module):
    """LSTM encoder / decoder with soft softmax(-d2) quantization and the
    straight-through estimator (reference backbone_lstm.py)."""

    def __init__(self, feature_dim: int, latent_dim: int, num_embeddings: int = 128,
                 commitment_cost: float = 0.25, seq_len: int = 10):
        super().__init__()
        self.feature_dim, self.seq_len = feature_dim, seq_len
        self.commitment_cost = commitment_cost
        self.enc_proj = TorchLinear(feature_dim, latent_dim)
        self.enc_lstm = LSTMStack(latent_dim, latent_dim, 3)
        self.dec_proj = TorchLinear(latent_dim, feature_dim)
        self.dec_lstm = LSTMStack(feature_dim, feature_dim, 3)
        self.embedding = nn.Parameter(torch.empty(num_embeddings, latent_dim))

    def init_weights(self, generator: torch.Generator) -> None:
        uniform_codebook_init(self.embedding, generator)

    def quantize(self, z_e):
        """z_e [B, T, L]: soft assignment over the codes
        (backbone_lstm.py:70-91), fp32."""
        e = self.embedding
        d2 = ((z_e ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1)[None, None, :]
              - 2.0 * torch.einsum("btl,nl->btn", z_e, e))
        z_q = torch.einsum("btn,nl->btl", torch.softmax(-d2, dim=-1), e)
        commitment_loss = self.commitment_cost * torch.mean((z_q.detach() - z_e) ** 2)
        embedding_loss = torch.mean((z_q - z_e.detach()) ** 2)
        z_q = z_e + (z_q - z_e).detach()
        return z_q, embedding_loss + commitment_loss

    def forward(self, x):
        """x [B * seq_len, feature_dim], windowed into seq_len steps."""
        bt = x.shape[0]
        xs = x.reshape(bt // self.seq_len, self.seq_len, self.feature_dim)
        z_e = self.enc_lstm(gelu_exact(self.enc_proj(xs)))
        z_q, quantization_loss = self.quantize(z_e)
        x_recon = self.dec_lstm(gelu_exact(self.dec_proj(z_q))).reshape(bt, self.feature_dim)
        recon_loss = torch.mean((x_recon - x) ** 2)
        return z_q.detach().reshape(bt, -1), recon_loss + quantization_loss
