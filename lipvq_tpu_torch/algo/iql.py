"""IQL, Implicit Q-Learning (Kostrikov et al. 2021; counterpart of
``lipvq_tpu/algo/iql.py``).

- twin Q critics on TD targets bootstrapped through V(s');
- V by expectile regression toward the target critics' min Q, weight
  ``vf_quantile`` where the target exceeds V and 1 - ``vf_quantile`` else;
- the actor (a GMM; ``actor.net.type`` "gaussian" builds one mode) by
  advantage-weighted regression, weights exp(adv / beta) with adv clipped
  above at ``adv.clip_adv_value`` and, with ``use_final_clip``, the weights
  to [-100, 100];
- the critic's target moved by polyak on every step.

All three losses are differentiated at the step's starting parameters, then
the three optimizers step. ``get_action`` samples the actor's GMM (low-noise
at eval) from the algo's generator, or from ``noise`` = (mode ids, normals).
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
    process_rl_batch,
    set_grads,
    step_all,
    td_target,
)
from lipvq_tpu_torch.models.distributions import gmm_log_prob, gmm_sample
from lipvq_tpu_torch.models.obs_nets import obs_spec
from lipvq_tpu_torch.models.policy_nets import GMMActorNetwork
from lipvq_tpu_torch.models.value_nets import QEnsemble, ValueNetwork

NETS = ("critic", "vf", "actor")  # the order the step differentiates them


@register_algo_factory_func("iql")
def algo_config_to_class(algo_config):
    return IQL, {}


class IQL(RLAlgo):
    TARGETS = ("critic",)

    def _create_networks(self):
        ac = self.algo_config
        self.group_specs = (("obs", obs_spec(self.obs_shapes)),)
        net = ac.actor.net
        self._finish_networks({
            "actor": GMMActorNetwork(
                self.group_specs, self.ac_dim, layer_dims=tuple(ac.actor.layer_dims),
                num_modes=int(net.gmm.num_modes) if str(net.type) == "gmm" else 1,
                min_std=float(net.gmm.get("min_std", 1e-4)),
                std_activation=str(net.common.std_activation),
                low_noise_eval=bool(net.common.low_noise_eval),
                use_tanh=bool(net.common.use_tanh)),
            "critic": QEnsemble(self.group_specs, self.ac_dim, n=int(ac.critic.ensemble.n),
                                layer_dims=tuple(ac.critic.layer_dims)),
            "vf": ValueNetwork(self.group_specs, layer_dims=tuple(ac.critic.layer_dims)),
        })

    def _create_optimizers(self):
        ac = self.algo_config
        self.discount = float(ac.discount)
        self.tau = float(ac.target_tau)
        self.vf_quantile = float(ac.vf_quantile)
        self.beta = float(ac.adv.beta)
        self.clip_adv_value = ac.adv.clip_adv_value
        self.use_final_clip = bool(ac.adv.use_final_clip)
        self.optim = {name: optimizer_from_optim_params(getattr(self.nets, name).parameters(),
                                                        ac.optim_params[name])
                      for name in NETS}

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return dict(self.optim)

    def process_batch_for_training(self, batch):
        return process_rl_batch(batch, discount=self.discount)

    def _losses(self, batch) -> dict:
        nets = self.nets
        with torch.no_grad():
            v_next = nets.vf(batch["next_obs"])
            target = td_target(batch["rewards"], batch["dones"], v_next, self.discount)
            q_min = nets.target.critic(batch["obs"], batch["actions"]).min(dim=0).values
            adv = q_min - nets.vf(batch["obs"])
            if self.clip_adv_value is not None:
                adv = torch.clamp(adv, max=float(self.clip_adv_value))
            weights = torch.exp(adv / self.beta)
            if self.use_final_clip:
                weights = torch.clamp(weights, -100.0, 100.0)
        q = nets.critic(batch["obs"], batch["actions"])
        critic = torch.mean((q - target[None]) ** 2)
        diff = q_min - nets.vf(batch["obs"])
        sign = (diff > 0).float()
        weight = (1 - sign) * (1 - self.vf_quantile) + sign * self.vf_quantile
        vf = torch.mean(weight * diff ** 2)
        lp = gmm_log_prob(nets.actor.forward_train(batch["obs"], train=True), batch["actions"])
        actor = torch.mean(-lp * weights)
        return {"critic": critic, "vf": vf, "actor": actor, "adv_mean": torch.mean(adv)}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": device scalars}; ``validate=True``
        computes the same losses without an update. No draw is random in
        the step (the actor has no dropout): ``draws`` is accepted for the
        common interface and unused."""
        batch = self._put_batch(batch)
        with torch.set_grad_enabled(not validate):
            losses = self._losses(batch)
        if not validate:
            for name in NETS:
                set_grads(self.optim[name], losses[name])
            step_all([self.optim[name] for name in NETS])
            self.update_targets(self.tau)
            self.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        return {"losses": {"critic_loss": losses["critic"], "vf_loss": losses["vf"],
                           "actor_loss": losses["actor"], "action_loss": losses["actor"],
                           "adv_mean": losses["adv_mean"]}}

    def log_info(self, info):
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]),
                "Critic_Loss": float(losses["critic_loss"]),
                "VF_Loss": float(losses["vf_loss"]),
                "Actor_Loss": float(losses["actor_loss"]),
                "Adv_Mean": float(losses["adv_mean"])}

    def get_action(self, obs_dict, goal_dict=None, noise=None):
        """obs leaves [B, ...] (or [B, T, ...], the last step read) -> a
        sample of the actor's GMM [B, A]."""
        with torch.inference_mode():
            dists = self.nets.actor.forward_train(self._last_step(obs_dict))
            if noise is not None:
                noise = tuple(self._put_infer(x) for x in noise)
            return gmm_sample(dists, self._generator, noise).cpu().numpy()
