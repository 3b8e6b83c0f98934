"""TD3-BC (Fujimoto & Gu 2021; counterpart of ``lipvq_tpu/algo/td3_bc.py``).

Twin-Q critics with target-policy smoothing (noise ``clip(noise_std * N,
+-noise_clip)`` on the target actor's action, clipped to [-1, 1]), a
deterministic actor updated every ``actor.update_freq`` steps (steps 0, 2,
4, ... at the default 2) with ``lambda * Q / |Q| - BC-MSE`` against the
critic just updated (lambda = alpha / mean |Q|, a constant of the step),
and both target networks moved by polyak on every step. The actor's Adam
advances only on its update steps; ``serialize_full`` carries the step, so
a resume keeps the phase. The smoothing noise is the algo generator's, or
``train_on_batch(..., draws={"noise": [B, A]})``.
"""

from __future__ import annotations

import torch

from lipvq_tpu_torch.algo.base import (
    ScheduledOptimizer,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.algo.rl_common import (
    RLAlgo,
    huber,
    process_rl_batch,
    set_grads,
    step_all,
    td_target,
)
from lipvq_tpu_torch.models.obs_nets import obs_spec
from lipvq_tpu_torch.models.policy_nets import ActorNetwork
from lipvq_tpu_torch.models.value_nets import QEnsemble


@register_algo_factory_func("td3_bc")
def algo_config_to_class(algo_config):
    return TD3_BC, {}


class TD3_BC(RLAlgo):
    TARGETS = ("actor", "critic")

    def _create_networks(self):
        ac = self.algo_config
        self.group_specs = (("obs", obs_spec(self.obs_shapes)),)
        bounds = ac.critic.value_bounds
        self._finish_networks({
            "actor": ActorNetwork(self.group_specs, self.ac_dim,
                                  layer_dims=tuple(ac.actor.layer_dims)),
            "critic": QEnsemble(self.group_specs, self.ac_dim, n=int(ac.critic.ensemble.n),
                                layer_dims=tuple(ac.critic.layer_dims),
                                value_bounds=tuple(bounds) if bounds else None),
        })

    def _create_optimizers(self):
        ac = self.algo_config
        self.discount = float(ac.discount)
        self.n_step = int(ac.get("n_step", 1))
        self.tau = float(ac.target_tau)
        self.alpha = float(ac.alpha)
        self.actor_update_freq = int(ac.actor.update_freq)
        self.noise_std = float(ac.actor.noise_std)
        self.noise_clip = float(ac.actor.noise_clip)
        self.use_huber = bool(ac.critic.use_huber)
        self.infinite_horizon = bool(ac.get("infinite_horizon", False))
        self.optim = {name: optimizer_from_optim_params(getattr(self.nets, name).parameters(),
                                                        ac.optim_params[name])
                      for name in ("actor", "critic")}

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return dict(self.optim)

    def process_batch_for_training(self, batch):
        return process_rl_batch(batch, n_step=self.n_step, discount=self.discount,
                                infinite_horizon=self.infinite_horizon)

    def _critic_loss(self, batch, noise):
        target = self.nets.target
        with torch.no_grad():
            next_a = target.actor(batch["next_obs"])
            noise = torch.clamp(self.noise_std * noise, -self.noise_clip, self.noise_clip)
            next_a = torch.clamp(next_a + noise, -1.0, 1.0)
            q_next = target.critic(batch["next_obs"], next_a)
            q_target = td_target(batch["rewards"], batch["dones"], q_next.min(dim=0).values,
                                 self.discount, self.n_step)
        err = self.nets.critic(batch["obs"], batch["actions"]) - q_target[None]
        return torch.mean(huber(err)) if self.use_huber else torch.mean(err ** 2)

    def _actor_loss(self, batch):
        pi = self.nets.actor(batch["obs"])
        q = self.nets.critic(batch["obs"], pi)[0]
        lam = self.alpha / (q.detach().abs().mean() + 1e-8)
        return -lam * q.mean() + torch.mean((pi - batch["actions"]) ** 2)

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": device scalars}; ``actor_loss`` is 0 on a
        step without an actor update. ``validate=True`` computes the losses
        at the current parameters only."""
        batch = self._put_batch(batch)
        noise = self._draw(draws, "noise", batch["actions"].shape)
        if validate:
            with torch.no_grad():
                c_loss = self._critic_loss(batch, noise)
                a_loss = self._actor_loss(batch)
        else:
            c_loss = self._critic_loss(batch, noise)
            set_grads(self.optim["critic"], c_loss)
            step_all([self.optim["critic"]])
            if self.step % self.actor_update_freq == 0:
                a_loss = self._actor_loss(batch)
                set_grads(self.optim["actor"], a_loss)
                step_all([self.optim["actor"]])
            else:
                a_loss = torch.zeros((), device=self.device)
            self.update_targets(self.tau)
            self.step += 1
        c_loss = c_loss.detach()
        return {"losses": {"critic_loss": c_loss, "actor_loss": a_loss.detach(),
                           "action_loss": c_loss}}

    def log_info(self, info):
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]),
                "Critic_Loss": float(losses["critic_loss"]),
                "Actor_Loss": float(losses["actor_loss"])}

    def get_action(self, obs_dict, goal_dict=None):
        """obs leaves [B, ...] (or [B, T, ...], the last step read) ->
        the actor's actions [B, A]."""
        with torch.inference_mode():
            return self.nets.actor(self._last_step(obs_dict)).cpu().numpy()
