"""BCQ, Batch-Constrained Q-Learning (Fujimoto et al. 2019; counterpart of
``lipvq_tpu/algo/bcq.py``).

- ``ActionVAE``: a cVAE p(a | s) over actions (``enc`` + the port's
  ``VAE`` at 300 x 400, loss reconstruction + 0.5 KL); its prior draws are
  clipped to +-0.5 and its decodes tanh-squashed;
- ``Perturbation``: xi(s, a), a bounded correction of ``perturbation_scale``
  (off in the template: its parameters then never change);
- twin Q critics on targets from ``num_action_samples`` VAE candidates per
  next obs scored by the target critics, the ensemble mixed as
  ``w * min + (1 - w) * max``, the best candidate's value;
- ``get_action``: the best of the candidates under the online critics.

Candidates are laid out interleaved (row ``i * n + j`` is obs ``i``'s
candidate ``j``: ``repeat_interleave``, as ``jnp.repeat``); the argmax takes
the first index on ties. Both targets (critic and perturbation) move by
polyak on every step. The draws: the VAE's posterior normals ``vae``
[B, latent], the next obs' prior normals ``next`` [B * n, latent] and the
perturbation loss's ``perturb`` [B, latent] (``train_on_batch(...,
draws=)``), and ``get_action``'s ``noise`` [B * n, latent]; else the
algo's generator. With the perturbation off the JAX step still advances
its Adam moments and then restores its parameters; the port does not
step that optimizer, and no output depends on the difference.
"""

from __future__ import annotations

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
from lipvq_tpu_torch.models.vae_nets import VAE

SAMPLER_KL_WEIGHT = 0.5  # the JAX step's constant (the config's kl_weight is not read)


@register_algo_factory_func("bcq")
def algo_config_to_class(algo_config):
    return BCQ, {}


class ActionVAE(nn.Module):
    """``enc`` and ``vae`` (actions given the obs features)."""

    def __init__(self, group_specs, ac_dim: int, latent_dim: int, layer_dims=(300, 400)):
        super().__init__()
        self.latent_dim = latent_dim
        self.enc = ObservationGroupEncoder(group_specs)
        self.vae = VAE(input_dim=ac_dim, latent_dim=latent_dim,
                       cond_dim=sum(spec_flat_dim(s) for _, s in group_specs),
                       encoder_layer_dims=layer_dims, decoder_layer_dims=layer_dims)

    def forward(self, obs, actions, noise):
        return self.vae(actions, cond=self.enc(False, None, obs=obs), noise=noise)

    def sample(self, obs, z, n: int = 1):
        """tanh(decode(clip(z, +-0.5), features)) for normals ``z`` [B * n,
        latent] -> [B * n, A], obs ``i``'s ``n`` candidates adjacent."""
        cond = self.enc(False, None, obs=obs).repeat_interleave(n, dim=0)
        return torch.tanh(self.vae.decode(torch.clamp(z, -0.5, 0.5), cond))


class Perturbation(nn.Module):
    """``enc``, ``mlp`` over [features, actions] and ``out``:
    clip(a + limit * tanh(out), -1, 1)."""

    def __init__(self, group_specs, ac_dim: int, limit: float = 0.05, layer_dims=(300, 400)):
        super().__init__()
        layer_dims = tuple(layer_dims)
        self.limit = limit
        self.enc = ObservationGroupEncoder(group_specs)
        self.mlp = MLP(sum(spec_flat_dim(s) for _, s in group_specs) + ac_dim, layer_dims,
                       layer_dims[-1], activation="relu")
        self.out = TorchLinear(layer_dims[-1], ac_dim)

    def forward(self, obs, actions):
        h = torch.cat([self.enc(False, None, obs=obs), actions], dim=-1)
        delta = self.limit * torch.tanh(self.out(self.mlp(h)))
        return torch.clamp(actions + delta, -1.0, 1.0)


class BCQ(RLAlgo):
    TARGETS = ("critic", "perturb")

    def _create_networks(self):
        ac = self.algo_config
        self.group_specs = (("obs", obs_spec(self.obs_shapes)),)
        self.latent_dim = int(ac.action_sampler.vae.get("latent_dim", 2 * self.ac_dim))
        self.use_perturbation = bool(ac.actor.get("enabled", False))
        self._finish_networks({
            "sampler": ActionVAE(self.group_specs, self.ac_dim, self.latent_dim),
            "perturb": Perturbation(self.group_specs, self.ac_dim,
                                    limit=float(ac.actor.get("perturbation_scale", 0.05))),
            "critic": QEnsemble(self.group_specs, self.ac_dim, n=int(ac.critic.ensemble.n),
                                layer_dims=tuple(ac.critic.layer_dims)),
        })

    def _create_optimizers(self):
        ac = self.algo_config
        self.discount = float(ac.discount)
        self.tau = float(ac.target_tau)
        self.n_samples = int(ac.critic.get("num_action_samples", 10))
        self.ensemble_weight = float(ac.critic.ensemble.get("weight", 0.75))
        params = ac.optim_params
        self.optim = {
            "sampler": optimizer_from_optim_params(self.nets.sampler.parameters(),
                                                   params.action_sampler),
            "perturb": optimizer_from_optim_params(self.nets.perturb.parameters(), params.actor),
            "critic": optimizer_from_optim_params(self.nets.critic.parameters(), params.critic),
        }

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return dict(self.optim)

    def process_batch_for_training(self, batch):
        return process_rl_batch(batch, discount=self.discount)

    def candidate_q(self, critic, perturb, obs, z):
        """The mixed ensemble Q of each obs's best candidate [B] and that
        candidate [B, A], for prior normals ``z`` [B * n, latent]."""
        b = next(iter(obs.values())).shape[0]
        n = z.shape[0] // b
        cands = self.nets.sampler.sample(obs, z, n)
        obs_rep = {k: v.repeat_interleave(n, dim=0) for k, v in obs.items()}
        if self.use_perturbation:
            cands = perturb(obs_rep, cands)
        q = critic(obs_rep, cands)
        w = self.ensemble_weight
        q_mix = (w * q.min(dim=0).values + (1 - w) * q.max(dim=0).values).reshape(b, n)
        best = torch.argmax(q_mix, dim=1)
        best_a = cands.reshape(b, n, self.ac_dim)[torch.arange(b, device=cands.device), best]
        return q_mix.max(dim=1).values, best_a

    def _losses(self, batch, draws) -> dict:
        nets, obs = self.nets, batch["obs"]
        b = batch["actions"].shape[0]
        out = nets.sampler(obs, batch["actions"],
                           noise=self._draw(draws, "vae", (b, self.latent_dim)))
        sampler = out["reconstruction_loss"] + SAMPLER_KL_WEIGHT * out["kl_loss"]
        with torch.no_grad():
            q_next, _ = self.candidate_q(
                nets.target.critic, nets.target.perturb, batch["next_obs"],
                self._draw(draws, "next", (b * self.n_samples, self.latent_dim)))
            target = td_target(batch["rewards"], batch["dones"], q_next, self.discount)
            cands = nets.sampler.sample(obs, self._draw(draws, "perturb", (b, self.latent_dim)))
        critic = torch.mean((nets.critic(obs, batch["actions"]) - target[None]) ** 2)
        with torch.set_grad_enabled(self.use_perturbation and torch.is_grad_enabled()):
            perturb = -torch.mean(nets.critic(obs, nets.perturb(obs, cands))[0])
        return {"sampler": sampler, "critic": critic, "perturb": perturb}

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": device scalars}; ``validate=True``
        computes the same losses without an update."""
        batch = self._put_batch(batch)
        with torch.set_grad_enabled(not validate):
            losses = self._losses(batch, draws)
        if not validate:
            names = ("sampler", "critic") + (("perturb",) if self.use_perturbation else ())
            for name in names:
                set_grads(self.optim[name], losses[name])
            step_all([self.optim[name] for name in names])
            self.update_targets(self.tau)
            self.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        return {"losses": {"critic_loss": losses["critic"], "sampler_loss": losses["sampler"],
                           "perturb_loss": losses["perturb"], "action_loss": losses["critic"]}}

    def log_info(self, info):
        losses = info["losses"]
        return {"Loss": float(losses["action_loss"]),
                "Critic_Loss": float(losses["critic_loss"]),
                "Action_Sampler_Loss": float(losses["sampler_loss"])}

    def _best(self, obs, noise):
        """``candidate_q`` under the online networks, for prior normals
        ``noise`` [B * n, latent] or the generator's."""
        b = next(iter(obs.values())).shape[0]
        z = self._normals((b * self.n_samples, self.latent_dim), noise)
        return self.candidate_q(self.nets.critic, self.nets.perturb, obs, z)

    def state_values(self, obs, noise=None) -> torch.Tensor:
        """The best candidate's mixed Q [B]: IRIS's value of a subgoal."""
        return self._best(obs, noise)[0]

    def get_action(self, obs_dict, goal_dict=None, noise=None):
        """obs leaves [B, ...] (or [B, T, ...], the last step read) -> the
        best of ``num_action_samples`` candidates [B, A]."""
        with torch.inference_mode():
            return self._best(self._last_step(obs_dict), noise)[1].cpu().numpy()
