"""Conditional VAE (counterpart of ``lipvq_tpu/models/vae_nets.py``): the
cVAE of BC-VAE and the KL / reparameterization helpers of ACT.

Encoder q(z | x, cond) -> (mu, logvar), reparameterized sample, decoder
p(x | z, cond), with the JAX module's priors:
- fixed N(0, I) (default), analytic KL;
- ``prior_learn``: a learned diagonal Gaussian (``prior_mu`` /
  ``prior_logvar`` parameters, or an MLP over the condition with
  ``prior_is_conditioned``), analytic KL;
- ``prior_use_gmm``: a learned GMM prior of ``prior_gmm_num_modes`` modes
  (learned weights with ``prior_gmm_learn_weights``), the sampled KL
  log q(z) - log p(z);
- ``prior_use_categorical``: ``latent_dim`` groups of
  ``prior_categorical_dim`` classes relaxed by a Gumbel-softmax at a fixed
  temperature, KL against the uniform prior.

Random draws come from an explicit ``torch.Generator``, or as ``noise``:
standard normals [B, latent] for the Gaussian forward, uniforms in [1e-10,
1) [B, latent, classes] for the Gumbel noise, and for ``sample_prior`` the
normals (fixed prior), (mode [B], normals) (learned prior) or class ids
[B, latent] (categorical). As in flax, the conditioned prior's modules
exist only where they run: not in the categorical VAE.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import MLP, TorchLinear


def kl_divergence(mu, logvar):
    """KL(q || N(0, I)) summed over the latent dim, averaged over the batch."""
    return torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))


def reparameterize(mu, logvar, eps):
    """mu + eps * exp(logvar / 2) for standard normals ``eps``."""
    return mu + eps * torch.exp(0.5 * logvar)


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device)


class VAE(nn.Module):
    """MLP cVAE over flat inputs [B, input_dim], conditioned on [B, cond_dim]
    when ``cond_dim`` > 0."""

    def __init__(self, input_dim: int, latent_dim: int, cond_dim: int = 0,
                 encoder_layer_dims: Sequence[int] = (300, 400),
                 decoder_layer_dims: Sequence[int] = (300, 400),
                 decoder_is_conditioned: bool = True, prior_learn: bool = False,
                 prior_is_conditioned: bool = False, prior_use_gmm: bool = False,
                 prior_gmm_num_modes: int = 10, prior_gmm_learn_weights: bool = False,
                 prior_use_categorical: bool = False, prior_categorical_dim: int = 10,
                 prior_categorical_gumbel_temp: float = 1.0,
                 prior_layer_dims: Sequence[int] = (300, 400)):
        super().__init__()
        self.input_dim, self.latent_dim = input_dim, latent_dim
        self.decoder_is_conditioned = decoder_is_conditioned
        self.prior_learn, self.prior_is_conditioned = prior_learn, prior_is_conditioned
        self.prior_use_gmm, self.prior_use_categorical = prior_use_gmm, prior_use_categorical
        self.categorical_dim = prior_categorical_dim
        self.gumbel_temp = prior_categorical_gumbel_temp
        self.modes = prior_gmm_num_modes if prior_use_gmm else 1
        self.learn_weights = prior_use_gmm and prior_gmm_learn_weights
        enc_dims = tuple(encoder_layer_dims)
        self.enc_mlp = MLP(input_dim + cond_dim, enc_dims, enc_dims[-1])
        if prior_use_categorical:
            self.enc_logits = TorchLinear(enc_dims[-1], latent_dim * prior_categorical_dim)
            z_dim = latent_dim * prior_categorical_dim
        else:
            self.enc_mu = TorchLinear(enc_dims[-1], latent_dim)
            self.enc_logvar = TorchLinear(enc_dims[-1], latent_dim)
            z_dim = latent_dim
        dec_dims = tuple(decoder_layer_dims)
        self.dec_mlp = MLP(z_dim + (cond_dim if decoder_is_conditioned else 0), dec_dims,
                           dec_dims[-1])
        self.dec_out = TorchLinear(dec_dims[-1], input_dim)
        if prior_learn:
            m = self.modes
            if prior_is_conditioned:
                if not prior_use_categorical:
                    prior_dims = tuple(prior_layer_dims)
                    self.prior_mlp = MLP(cond_dim, prior_dims, prior_dims[-1])
                    self.prior_mu = TorchLinear(prior_dims[-1], m * latent_dim)
                    self.prior_logvar = TorchLinear(prior_dims[-1], m * latent_dim)
                    if self.learn_weights:
                        self.prior_logits = TorchLinear(prior_dims[-1], m)
            else:
                self.prior_mu = nn.Parameter(torch.empty(m, latent_dim))
                self.prior_logvar = nn.Parameter(torch.empty(m, latent_dim))
                if self.learn_weights:
                    self.prior_logits = nn.Parameter(torch.empty(m))

    def init_weights(self, generator: torch.Generator) -> None:
        """The unconditioned prior's parameters start at zero, as flax's."""
        with torch.no_grad():
            for name in ("prior_mu", "prior_logvar", "prior_logits"):
                p = getattr(self, name, None)
                if isinstance(p, nn.Parameter):
                    p.zero_()

    def _prior_params(self, cond, batch: int):
        """-> (mu [B, M, D], logvar [B, M, D], logits [B, M])."""
        m, d = self.modes, self.latent_dim
        if self.prior_is_conditioned:
            if cond is None:
                raise ValueError("the conditioned prior needs the condition")
            h = self.prior_mlp(cond)
            mu = self.prior_mu(h).reshape(batch, m, d)
            logvar = self.prior_logvar(h).reshape(batch, m, d)
            logits = self.prior_logits(h) if self.learn_weights else None
        else:
            mu = self.prior_mu[None].expand(batch, m, d)
            logvar = self.prior_logvar[None].expand(batch, m, d)
            logits = self.prior_logits[None].expand(batch, m) if self.learn_weights else None
        if logits is None:
            logits = torch.zeros((batch, m), device=mu.device)
        return mu, logvar, logits

    def _kl(self, mu, logvar, z, cond):
        if not self.prior_learn:
            return kl_divergence(mu, logvar)
        p_mu, p_logvar, p_logits = self._prior_params(cond, mu.shape[0])
        if not self.prior_use_gmm:
            pm, pv = p_mu[:, 0], p_logvar[:, 0]
            kl = 0.5 * torch.sum(pv - logvar + (torch.exp(logvar) + (mu - pm) ** 2)
                                 / torch.exp(pv) - 1.0, dim=-1)
            return torch.mean(kl)
        log2pi = math.log(2 * math.pi)
        log_q = torch.sum(-0.5 * (((z - mu) ** 2) / torch.exp(logvar) + logvar + log2pi),
                          dim=-1)
        comp = torch.sum(-0.5 * (((z[:, None] - p_mu) ** 2) / torch.exp(p_logvar)
                                 + p_logvar + log2pi), dim=-1)  # [B, M]
        log_p = torch.logsumexp(comp + torch.log_softmax(p_logits, dim=-1), dim=-1)
        return torch.mean(log_q - log_p)

    def encode(self, x, cond=None):
        h = x if cond is None else torch.cat([x, cond], dim=-1)
        h = self.enc_mlp(h)
        return self.enc_mu(h), self.enc_logvar(h)

    def decode(self, z, cond=None):
        h = z
        if self.decoder_is_conditioned and cond is not None:
            h = torch.cat([z, cond], dim=-1)
        return self.dec_out(self.dec_mlp(h))

    def _categorical_forward(self, x, cond, u):
        h = x if cond is None else torch.cat([x, cond], dim=-1)
        logits = self.enc_logits(self.enc_mlp(h)).reshape(-1, self.latent_dim,
                                                          self.categorical_dim)
        g = -torch.log(-torch.log(u))
        z = torch.softmax((logits + g) / self.gumbel_temp, dim=-1).reshape(logits.shape[0], -1)
        probs = torch.softmax(logits, dim=-1)
        kl = torch.mean(torch.sum(probs * (torch.log(probs + 1e-10)
                                           + math.log(float(self.categorical_dim))),
                                  dim=(-2, -1)))
        recon = self.decode(z, cond)
        zeros = torch.zeros((z.shape[0], self.latent_dim), device=z.device)
        return {"reconstruction": recon, "logits": logits, "z": z, "kl_loss": kl,
                "mu": zeros, "logvar": zeros,
                "reconstruction_loss": torch.mean((recon - x) ** 2)}

    def forward(self, x, cond=None, noise=None, generator: torch.Generator | None = None):
        """x [B, input_dim] -> {reconstruction, mu, logvar, z, kl_loss,
        reconstruction_loss} (and the categorical ``logits``)."""
        if self.prior_use_categorical:
            if noise is None:
                shape = (x.shape[0], self.latent_dim, self.categorical_dim)
                noise = 1e-10 + (1.0 - 1e-10) * torch.rand(shape, generator=generator,
                                                           device=x.device)
            return self._categorical_forward(x, cond, noise)
        mu, logvar = self.encode(x, cond)
        eps = _normal(mu.shape, generator, mu.device) if noise is None else noise
        z = reparameterize(mu, logvar, eps)
        recon = self.decode(z, cond)
        return {"reconstruction": recon, "mu": mu, "logvar": logvar, "z": z,
                "kl_loss": self._kl(mu, logvar, z, cond),
                "reconstruction_loss": torch.mean((recon - x) ** 2)}

    def sample_prior(self, batch_size: int, cond=None, noise=None,
                     generator: torch.Generator | None = None, device=None):
        """Decode a draw from the prior -> [B, input_dim]."""
        device = cond.device if cond is not None else device
        if self.prior_use_categorical:
            ids = noise if noise is not None else torch.randint(
                self.categorical_dim, (batch_size, self.latent_dim), generator=generator,
                device=device)
            z = F.one_hot(ids.long(), self.categorical_dim).float().reshape(batch_size, -1)
            return self.decode(z, cond)
        if self.prior_learn:
            p_mu, p_logvar, p_logits = self._prior_params(cond, batch_size)
            if noise is None:
                mode = torch.multinomial(torch.softmax(p_logits, dim=-1), 1,
                                         generator=generator)[:, 0]
                eps = _normal((batch_size, self.latent_dim), generator, p_mu.device)
            else:
                mode, eps = noise
            idx = mode.long()[:, None, None].expand(batch_size, 1, self.latent_dim)
            z = reparameterize(p_mu.gather(1, idx)[:, 0], p_logvar.gather(1, idx)[:, 0], eps)
        else:
            z = _normal((batch_size, self.latent_dim), generator, device) if noise is None \
                else noise
        return self.decode(z, cond)
