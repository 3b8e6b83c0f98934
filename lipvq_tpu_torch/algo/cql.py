"""CQL, Conservative Q-Learning (Kumar et al. 2020; counterpart of
``lipvq_tpu/algo/cql.py``).

A SAC backbone (a tanh-Gaussian actor, twin Q, the entropy temperature
``log_alpha`` with its own Adam at 1e-3 toward a target entropy of -A) plus
the conservative penalty mean(logsumexp_a Q(s, a) - Q(s, a_data)), the
logsumexp importance-weighted over ``num_random_actions`` uniform actions
(density 0.5^A) and one policy action. The critic's target moves by polyak
on every step.

Each step draws four sets of numbers (the JAX step splits one key into
five): the next-policy normals ``next_eps`` [B, A], the uniform actions
``rand`` [num_rand, B, A] in [-1, 1), the policy normals ``pi_eps`` and the
actor loss's ``actor_eps`` [B, A]; from the algo's generator, or
``train_on_batch(..., draws=)``. ``get_action`` samples the actor (normals
``noise`` [B, A] or the generator's).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lipvq_tpu_torch.algo.base import (
    ScheduledOptimizer,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.algo.rl_common import (
    RLAlgo,
    process_rl_batch,
    set_grads,
    step_all,
    td_target,
)
from lipvq_tpu_torch.models.base_nets import MLP, TorchLinear
from lipvq_tpu_torch.models.obs_nets import ObservationGroupEncoder, obs_spec, spec_flat_dim
from lipvq_tpu_torch.models.value_nets import QEnsemble

LOG_2PI = math.log(2 * math.pi)
ALPHA_LR = 1e-3  # the JAX algo's optax.adam(1e-3) for log_alpha


@register_algo_factory_func("cql")
def algo_config_to_class(algo_config):
    return CQL, {}


class TanhGaussianActor(nn.Module):
    """``enc``, ``mlp``, then heads ``mu`` and ``log_std`` (clipped to
    [-5, 2]): a = tanh(mu + std * eps) and its log-probability with the tanh
    correction log(1 - a^2 + 1e-6)."""

    def __init__(self, group_specs, ac_dim: int, layer_dims=(300, 400)):
        super().__init__()
        layer_dims = tuple(layer_dims)
        self.enc = ObservationGroupEncoder(group_specs)
        self.mlp = MLP(sum(spec_flat_dim(s) for _, s in group_specs), layer_dims,
                       layer_dims[-1], activation="relu")
        self.mu = TorchLinear(layer_dims[-1], ac_dim)
        self.log_std = TorchLinear(layer_dims[-1], ac_dim)

    def forward(self, obs, eps, train: bool = False):
        """-> (action in [-1, 1] [B, A], log_prob [B]) for normals ``eps``."""
        h = self.mlp(self.enc(train, None, obs=obs))
        mu = self.mu(h)
        log_std = torch.clamp(self.log_std(h), -5, 2)
        std = torch.exp(log_std)
        pre_tanh = mu + std * eps
        a = torch.tanh(pre_tanh)
        lp = -0.5 * (((pre_tanh - mu) / std) ** 2 + 2 * log_std + LOG_2PI)
        lp = torch.sum(lp, dim=-1) - torch.sum(torch.log(1 - a ** 2 + 1e-6), dim=-1)
        return a, lp


class CQL(RLAlgo):
    TARGETS = ("critic",)

    def _create_networks(self):
        ac = self.algo_config
        self.group_specs = (("obs", obs_spec(self.obs_shapes)),)
        self._finish_networks({
            "actor": TanhGaussianActor(self.group_specs, self.ac_dim,
                                       layer_dims=tuple(ac.actor.layer_dims)),
            "critic": QEnsemble(self.group_specs, self.ac_dim, n=int(ac.critic.ensemble.n),
                                layer_dims=tuple(ac.critic.layer_dims)),
        })
        self.nets.register_parameter("log_alpha",
                                     nn.Parameter(torch.zeros((), device=self.device)))

    def _create_optimizers(self):
        ac = self.algo_config
        self.discount = float(ac.discount)
        self.tau = float(ac.target_tau)
        self.cql_weight = float(ac.critic.get("cql_weight", 1.0))
        self.num_rand = int(ac.critic.get("num_random_actions", 10))
        self.target_entropy = -float(self.ac_dim)
        self.optim = {name: optimizer_from_optim_params(getattr(self.nets, name).parameters(),
                                                        ac.optim_params[name])
                      for name in ("critic", "actor")}
        self.optim["log_alpha"] = ScheduledOptimizer([self.nets.log_alpha], torch.optim.Adam,
                                                     lambda step: ALPHA_LR, eps=1e-8)

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return dict(self.optim)

    def process_batch_for_training(self, batch):
        return process_rl_batch(batch, discount=self.discount)

    def _losses(self, batch, draws) -> dict:
        nets, obs = self.nets, batch["obs"]
        b = batch["actions"].shape[0]
        shape = (b, self.ac_dim)
        alpha = torch.exp(nets.log_alpha.detach())
        with torch.no_grad():
            next_a, next_lp = nets.actor(batch["next_obs"], self._draw(draws, "next_eps", shape))
            q_next = nets.target.critic(batch["next_obs"], next_a).min(dim=0).values
            target = td_target(batch["rewards"], batch["dones"], q_next - alpha * next_lp,
                               self.discount)
            rand_a = self._draw(draws, "rand", (self.num_rand, *shape), uniform=True)
            pi_a, pi_lp = nets.actor(obs, self._draw(draws, "pi_eps", shape))
        q_data = nets.critic(obs, batch["actions"])
        bellman = torch.mean((q_data - target[None]) ** 2)
        # the random actions' Q in one call over num_rand copies of the batch
        obs_rep = {k: v.repeat((self.num_rand,) + (1,) * (v.ndim - 1)) for k, v in obs.items()}
        q_rand = nets.critic(obs_rep, rand_a.reshape(-1, self.ac_dim))
        q_rand = q_rand.reshape(-1, self.num_rand, b).transpose(0, 1)  # [num_rand, n_q, B]
        q_pi = nets.critic(obs, pi_a)[None]
        log_u = -math.log(0.5 ** self.ac_dim)
        lse = torch.logsumexp(torch.cat([q_rand + log_u, q_pi - pi_lp[None, None]], dim=0),
                              dim=0)
        penalty = torch.mean(lse - q_data)
        a, lp = nets.actor(obs, self._draw(draws, "actor_eps", shape))
        actor = torch.mean(alpha * lp - nets.critic(obs, a).min(dim=0).values)
        alpha_loss = -torch.mean(torch.exp(nets.log_alpha) * (lp.detach() + self.target_entropy))
        return {"critic": bellman + self.cql_weight * penalty, "bellman": bellman,
                "penalty": penalty, "actor": actor, "log_alpha": alpha_loss}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": device scalars}; ``validate=True``
        computes the same losses without an update."""
        batch = self._put_batch(batch)
        with torch.set_grad_enabled(not validate):
            losses = self._losses(batch, draws)
        if not validate:
            for name in ("critic", "actor", "log_alpha"):
                set_grads(self.optim[name], losses[name])
            step_all([self.optim[name] for name in ("critic", "actor", "log_alpha")])
            self.update_targets(self.tau)
            self.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        return {"losses": {"critic_loss": losses["critic"], "bellman_loss": losses["bellman"],
                           "cql_penalty": losses["penalty"], "actor_loss": losses["actor"],
                           "alpha_loss": losses["log_alpha"], "action_loss": losses["actor"]}}

    def log_info(self, info):
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]),
                "Critic_Loss": float(losses["critic_loss"]),
                "CQL_Penalty": float(losses["cql_penalty"]),
                "Actor_Loss": float(losses["actor_loss"])}

    def get_action(self, obs_dict, goal_dict=None, noise=None):
        """obs leaves [B, ...] (or [B, T, ...], the last step read) -> a
        sampled action of the actor [B, A]."""
        with torch.inference_mode():
            obs = self._last_step(obs_dict)
            b = next(iter(obs.values())).shape[0]
            return self.nets.actor(obs, self._normals((b, self.ac_dim), noise))[0].cpu().numpy()
