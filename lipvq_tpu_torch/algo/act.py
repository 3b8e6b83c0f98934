"""ACT, the Action Chunking Transformer (counterpart of
``lipvq_tpu/algo/act.py``), a CVAE over action chunks:

- style encoder: pre-LN blocks over [CLS, obs token, action-chunk tokens]
  plus a learned position embedding -> the CLS token -> (mu, logvar) -> z;
- decoder: learned chunk-position queries (``query_embed``) through blocks
  of self-attention, cross-attention to the memory [obs token, z token] and
  a ReLU feed-forward -> the action chunk;
- loss: L1 reconstruction + ``kl_weight`` * KL(q || N(0, I));
- inference: z = 0 (the prior's mean); the predicted chunk is replayed
  open-loop through an action queue.

Attention is ``base_nets.MultiHeadDotProductAttention`` (flax's layout),
LayerNorm epsilon flax's 1e-6. The reparameterization draws from the
algo's generator, or takes ``train_on_batch(..., draws={"eps": ...})``.
As in the JAX package, the queue is not cleared when an episode starts
(``RolloutPolicy.start_episode`` does not call ``reset``; ROADMAP queue 3,
reference fault (a)).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.algo.base import (
    PolicyAlgo,
    ScheduledOptimizer,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.models.base_nets import (
    MultiHeadDotProductAttention,
    TorchLinear,
    seeded_init,
)
from lipvq_tpu_torch.models.obs_nets import ObservationGroupEncoder, obs_spec, spec_flat_dim
from lipvq_tpu_torch.models.transformer import LN_EPS
from lipvq_tpu_torch.models.vae_nets import kl_divergence, reparameterize


@register_algo_factory_func("act")
def algo_config_to_class(algo_config):
    return ACT, {}


class ACTNet(nn.Module):
    """The CVAE with the flax module's names: ``obs_enc``, ``obs_proj``,
    ``act_proj``, ``cls_embed``, ``enc_pos_embed``, ``enc{i}_*`` blocks,
    ``latent_mu`` / ``latent_logvar``, ``z_proj``, ``query_embed``,
    ``dec{i}_*`` blocks (``_cross`` after ``_ln_q``) and ``action_head``."""

    def __init__(self, group_specs, ac_dim: int, chunk_size: int, hidden_dim: int = 512,
                 latent_dim: int = 32, num_heads: int = 8, enc_layers: int = 4,
                 dec_layers: int = 7, ff_dim: int = 3200):
        super().__init__()
        self.latent_dim, self.enc_layers, self.dec_layers = latent_dim, enc_layers, dec_layers
        h = hidden_dim
        self.obs_enc = ObservationGroupEncoder(group_specs, feature_activation=None)
        self.obs_proj = TorchLinear(sum(spec_flat_dim(s) for _, s in group_specs), h)
        self.act_proj = TorchLinear(ac_dim, h)
        self.cls_embed = nn.Parameter(torch.empty(1, 1, h))
        self.enc_pos_embed = nn.Parameter(torch.empty(1, 2 + chunk_size, h))
        for i in range(enc_layers):
            self._add_block(f"enc{i}", h, num_heads, ff_dim, cross=False)
        self.latent_mu = TorchLinear(h, latent_dim)
        self.latent_logvar = TorchLinear(h, latent_dim)
        self.z_proj = TorchLinear(latent_dim, h)
        self.query_embed = nn.Parameter(torch.empty(1, chunk_size, h))
        for i in range(dec_layers):
            self._add_block(f"dec{i}", h, num_heads, ff_dim, cross=True)
        self.action_head = TorchLinear(h, ac_dim)

    def _add_block(self, prefix: str, h: int, heads: int, ff_dim: int, cross: bool) -> None:
        self.add_module(f"{prefix}_ln1", nn.LayerNorm(h, eps=LN_EPS))
        self.add_module(f"{prefix}_attn", MultiHeadDotProductAttention(h, heads))
        if cross:
            self.add_module(f"{prefix}_ln_q", nn.LayerNorm(h, eps=LN_EPS))
            self.add_module(f"{prefix}_cross", MultiHeadDotProductAttention(h, heads))
        self.add_module(f"{prefix}_ln2", nn.LayerNorm(h, eps=LN_EPS))
        self.add_module(f"{prefix}_ff1", TorchLinear(h, ff_dim))
        self.add_module(f"{prefix}_ff2", TorchLinear(ff_dim, h))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for p in (self.cls_embed, self.enc_pos_embed, self.query_embed):
                p.normal_(0.0, 0.02, generator=generator)

    def _block(self, x, prefix: str, memory=None):
        m = lambda name: getattr(self, f"{prefix}_{name}")  # noqa: E731
        x = x + m("attn")(m("ln1")(x))
        if memory is not None:
            x = x + m("cross")(m("ln_q")(x), memory)
        return x + m("ff2")(F.relu(m("ff1")(m("ln2")(x))))

    def forward(self, obs, actions=None, train: bool = False, eps=None,
                generator: torch.Generator | None = None):
        """obs leaves [B, ...] (one step); ``actions`` [B, chunk, A] for the
        style encoder (training), where z is reparameterized from ``eps``
        (drawn from ``generator`` when None); else z = 0. Returns (a_hat
        [B, chunk, A], mu, logvar)."""
        obs_tok = self.obs_proj(self.obs_enc(train, None, obs=obs))  # [B, H]
        b = obs_tok.shape[0]
        mu = logvar = torch.zeros((b, self.latent_dim), device=obs_tok.device)
        if actions is not None:
            seq = torch.cat([self.cls_embed.expand(b, -1, -1), obs_tok[:, None],
                             self.act_proj(actions)], dim=1)
            x = seq + self.enc_pos_embed
            for i in range(self.enc_layers):
                x = self._block(x, f"enc{i}")
            style = x[:, 0]
            mu, logvar = self.latent_mu(style), self.latent_logvar(style)
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator, device=mu.device)
            z = reparameterize(mu, logvar, eps)
        else:
            z = torch.zeros((b, self.latent_dim), device=obs_tok.device)
        memory = torch.stack([obs_tok, self.z_proj(z)], dim=1)  # [B, 2, H]
        x = self.query_embed.expand(b, -1, -1)
        for i in range(self.dec_layers):
            x = self._block(x, f"dec{i}", memory=memory)
        return self.action_head(x), mu, logvar


class ACT(PolicyAlgo):
    def _create_networks(self):
        ac = self.algo_config.act
        self.chunk_size = int(ac.get("chunk_size", 10))
        self.kl_weight = float(ac.get("kl_weight", 10.0))
        self.nets = ACTNet(
            (("obs", obs_spec(self.obs_shapes)),), self.ac_dim, self.chunk_size,
            hidden_dim=int(ac.get("hidden_dim", 512)), latent_dim=int(ac.get("latent_dim", 32)),
            num_heads=int(ac.get("num_heads", 8)), enc_layers=int(ac.get("enc_layers", 4)),
            dec_layers=int(ac.get("dec_layers", 7)), ff_dim=int(ac.get("ff_dim", 3200)))
        seed = int(self.global_config.train.seed)
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 2)
        self._action_queue: deque = deque()

    def _create_optimizers(self):
        self.policy_optimizer = optimizer_from_optim_params(
            self.nets.parameters(), self.algo_config.optim_params.policy,
            max_grad_norm=self.global_config.train.max_grad_norm)

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return {"policy": self.policy_optimizer}

    def generators(self) -> dict[str, torch.Generator]:
        return {"sample": self._generator}

    def process_batch_for_training(self, batch):
        """The first obs step and the first ``chunk_size`` actions."""
        return {"obs": {k: np.asarray(v)[:, 0] for k, v in batch["obs"].items()},
                "actions": np.asarray(batch["actions"])[:, :self.chunk_size],
                "goal_obs": batch.get("goal_obs", None)}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": {action_loss, l1_loss, kl_loss}} as device
        scalars. ``draws={"eps": [B, latent]}`` replaces the generator's
        standard normals."""
        batch = self._put_batch(batch)
        train = not validate
        with torch.set_grad_enabled(train):
            a_hat, mu, logvar = self.nets(batch["obs"], batch["actions"], train=train,
                                          eps=None if draws is None
                                          else self._put_infer(draws["eps"]),
                                          generator=self._generator)
            l1 = torch.mean((a_hat - batch["actions"]).abs())
            kl = kl_divergence(mu, logvar)
            loss = l1 + self.kl_weight * kl
        if train:
            loss.backward()
            self.policy_optimizer.step()
            self.policy_optimizer.zero_grad()
        return {"losses": {"action_loss": loss.detach(), "l1_loss": l1.detach(),
                           "kl_loss": kl.detach()}}

    def log_info(self, info) -> dict:
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]), "L1_Loss": float(losses["l1_loss"]),
                "KL_Loss": float(losses["kl_loss"])}

    def reset(self):
        self._action_queue.clear()

    def get_action(self, obs_dict, goal_dict=None):
        """Serve the queued chunk; with the queue empty, predict a chunk from
        the obs (the last step of [B, T, ...] leaves) at z = 0."""
        if not self._action_queue:
            obs = {k: (np.asarray(v)[:, -1] if np.asarray(v).ndim > 2 else v)
                   for k, v in obs_dict.items()}
            with torch.inference_mode():
                chunk = self.nets(self._put_infer(obs))[0].cpu().numpy()
            self._action_queue.extend(chunk[:, i] for i in range(chunk.shape[1]))
        return self._action_queue.popleft()
