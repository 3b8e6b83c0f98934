"""Subgoal prediction (counterpart of ``lipvq_tpu/algo/gl.py``).

- ``GL``: a deterministic subgoal predictor, an MLP from the obs (and
  goal) features to the observation ``subgoal_horizon`` steps ahead: the
  target is ``next_obs[:, subgoal_horizon - 1]`` of each window;
- ``GLVAE``: a cVAE over the flattened subgoal conditioned on the obs
  features, loss reconstruction + ``kl_weight`` KL, with
  ``sample_subgoals`` (prior normals decoded, obs ``i``'s ``n`` samples
  adjacent), ``encode_latent_subgoals`` (posterior means) and
  ``sample_latent_subgoals`` (prior normals);
- ``ValuePlanner``: samples subgoals from a GL-VAE and keeps, per obs, the
  one a value function scores highest (the first on ties).

As in the JAX package, GL-VAE trains on one fixed posterior noise: the JAX
step reads a key frozen when it is traced and never advances it, so every
step with the same batch size reuses the same normals (ROADMAP queue 3,
reference fault (f)). The port draws that noise once per batch size from
a generator of a fixed seed (train.seed + 2); ``train_on_batch(...,
draws={"noise": ...})`` replaces it. Sampling draws from the algo's
generator (train.seed + 1) or takes ``noise``. Subgoals are returned as
tensors on the algo's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from lipvq_tpu_torch.algo.base import (
    Algo,
    ScheduledOptimizer,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.models.base_nets import MLP, seeded_init
from lipvq_tpu_torch.models.obs_nets import (
    ObservationDecoder,
    ObservationGroupEncoder,
    obs_spec,
    spec_flat_dim,
)
from lipvq_tpu_torch.models.vae_nets import VAE


@register_algo_factory_func("gl")
def algo_config_to_class(algo_config):
    if algo_config.vae.enabled:
        return GLVAE, {}
    return GL, {}


def _groups(obs, goal) -> dict:
    return {"obs": obs} if goal is None else {"obs": obs, "goal": goal}


class GoalNet(nn.Module):
    """``enc``, ``mlp`` and ``decoder`` (one head per subgoal key)."""

    def __init__(self, group_specs, subgoal_spec, layer_dims=(300, 400)):
        super().__init__()
        layer_dims = tuple(layer_dims)
        self.enc = ObservationGroupEncoder(group_specs)
        self.mlp = MLP(sum(spec_flat_dim(s) for _, s in group_specs), layer_dims,
                       layer_dims[-1], activation="relu")
        self.decoder = ObservationDecoder(layer_dims[-1], subgoal_spec)

    def forward(self, obs, goal=None):
        return self.decoder(self.mlp(self.enc(False, None, **_groups(obs, goal))))


class GoalVAENet(nn.Module):
    """``enc`` (the condition) and ``vae`` over the flattened subgoal."""

    def __init__(self, group_specs, subgoal_spec, latent_dim: int, encoder_layer_dims,
                 decoder_layer_dims, **prior):
        super().__init__()
        self.subgoal_spec = subgoal_spec
        self.enc = ObservationGroupEncoder(group_specs)
        self.vae = VAE(input_dim=spec_flat_dim(subgoal_spec), latent_dim=latent_dim,
                       cond_dim=sum(spec_flat_dim(s) for _, s in group_specs),
                       encoder_layer_dims=tuple(encoder_layer_dims),
                       decoder_layer_dims=tuple(decoder_layer_dims), **prior)

    def _flatten(self, subgoals):
        return torch.cat([subgoals[k].reshape(subgoals[k].shape[0], -1)
                          for k, _ in self.subgoal_spec], dim=-1)

    def _unflatten(self, flat) -> dict:
        out, i = {}, 0
        for k, shape in self.subgoal_spec:
            n = math.prod(shape)
            out[k] = flat[:, i:i + n].reshape((-1,) + tuple(shape))
            i += n
        return out

    def forward(self, obs, subgoals, noise, goal=None):
        cond = self.enc(False, None, **_groups(obs, goal))
        return self.vae(self._flatten(subgoals), cond=cond, noise=noise)

    def encode(self, obs, subgoals, goal=None):
        """The posterior mean [B, latent]."""
        cond = self.enc(False, None, **_groups(obs, goal))
        return self.vae.encode(self._flatten(subgoals), cond)[0]

    def sample(self, obs, z, goal=None) -> dict:
        """Decode normals ``z`` [B * n, latent] under each obs's condition,
        repeated ``n`` times in place."""
        cond = self.enc(False, None, **_groups(obs, goal))
        cond = cond.repeat_interleave(z.shape[0] // cond.shape[0], dim=0)
        return self._unflatten(self.vae.decode(z, cond))


class GL(Algo):
    """Deterministic subgoal prediction."""

    def _create_networks(self):
        self.subgoal_horizon = int(self.algo_config.subgoal_horizon)
        self.subgoal_shapes = dict(self.obs_shapes)
        group_specs = [("obs", obs_spec(self.obs_shapes))]
        if self.goal_shapes:
            group_specs.append(("goal", obs_spec(self.goal_shapes)))
        self.group_specs = tuple(group_specs)
        self.nets = self._build_net()
        seed = int(self.global_config.train.seed)
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 1)

    def _build_net(self) -> nn.Module:
        return GoalNet(self.group_specs, obs_spec(self.subgoal_shapes),
                       layer_dims=tuple(self.algo_config.get("ae", {}).get(
                           "planner_layer_dims", (300, 400))))

    def _create_optimizers(self):
        self.goal_optimizer = optimizer_from_optim_params(
            self.nets.parameters(), self.algo_config.optim_params.goal_network)

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return {"goal_network": self.goal_optimizer}

    def generators(self) -> dict[str, torch.Generator]:
        return {"sample": self._generator}

    def process_batch_for_training(self, batch):
        """Obs at t = 0; the subgoal ``next_obs[:, subgoal_horizon - 1]``."""
        h = self.subgoal_horizon
        if "next_obs" not in batch:
            raise KeyError("GL needs next_obs: set train.hdf5_load_next_obs=true")
        subgoals = {k: np.asarray(v)[:, h - 1] for k, v in batch["next_obs"].items()}
        return {"obs": {k: np.asarray(v)[:, 0] for k, v in batch["obs"].items()},
                "subgoals": subgoals, "target_subgoals": subgoals,
                "goal_obs": batch.get("goal_obs", None)}

    def _loss(self, batch, draws):
        pred = self.nets(batch["obs"], goal=batch["goal_obs"])
        return sum(torch.mean((pred[k] - batch["target_subgoals"][k]) ** 2) for k in pred)

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One step -> {"losses": device scalars}; ``validate=True``
        computes the loss only."""
        batch = self._put_batch(batch)
        with torch.set_grad_enabled(not validate):
            loss = self._loss(batch, draws)
        if not validate:
            loss.backward()
            self.goal_optimizer.step()
            self.goal_optimizer.zero_grad()
        loss = loss.detach()
        return {"losses": {"action_loss": loss, "goal_loss": loss}}

    def log_info(self, info):
        return {"Loss": float(info["losses"]["goal_loss"])}

    def get_subgoal_predictions(self, obs_dict, goal_dict=None) -> dict:
        with torch.inference_mode():
            return self.nets(self._put_infer(obs_dict),
                             goal=self._put_infer(goal_dict) if goal_dict else None)

    def get_action(self, obs_dict, goal_dict=None):
        raise NotImplementedError("GL is a planner, not a policy")


class GLVAE(GL):
    """cVAE subgoal prediction."""

    def _build_net(self):
        vc = self.algo_config.vae
        self._fixed_noise = {}
        return GoalVAENet(self.group_specs, obs_spec(self.subgoal_shapes), int(vc.latent_dim),
                          vc.encoder_layer_dims, vc.decoder_layer_dims,
                          prior_learn=bool(vc.prior.learn),
                          prior_is_conditioned=False,  # unconditioned, as in the JAX package
                          prior_use_gmm=bool(vc.prior.use_gmm),
                          prior_gmm_num_modes=int(vc.prior.gmm_num_modes),
                          prior_gmm_learn_weights=bool(vc.prior.gmm_learn_weights))

    @property
    def latent_dim(self) -> int:
        return int(self.algo_config.vae.latent_dim)

    def posterior_noise(self, batch_size: int) -> torch.Tensor:
        """The one posterior noise every train step of ``batch_size`` uses
        (reference fault (f))."""
        noise = self._fixed_noise.get(batch_size)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(
                int(self.global_config.train.seed) + 2)
            noise = self._fixed_noise[batch_size] = torch.randn(
                (batch_size, self.latent_dim), generator=gen, device=self.device)
        return noise

    def _loss(self, batch, draws):
        b = next(iter(batch["obs"].values())).shape[0]
        noise = self.posterior_noise(b) if draws is None else self._put_infer(draws["noise"])
        out = self.nets(batch["obs"], batch["target_subgoals"], noise, goal=batch["goal_obs"])
        return out["reconstruction_loss"] + float(self.algo_config.vae.kl_weight) * out["kl_loss"]

    def _normals(self, shape, noise) -> torch.Tensor:
        if noise is not None:
            return self._put_infer(noise)
        return torch.randn(shape, generator=self._generator, device=self.device)

    def sample_subgoals(self, obs_dict, goal_dict=None, num_samples: int = 1,
                        noise=None) -> dict:
        """Subgoal leaves [B * num_samples, ...], decoded from prior normals
        ``noise`` [B * num_samples, latent] or the generator's."""
        with torch.inference_mode():
            obs = self._put_infer(obs_dict)
            b = next(iter(obs.values())).shape[0]
            z = self._normals((b * num_samples, self.latent_dim), noise)
            return self.nets.sample(obs, z, goal=self._put_infer(goal_dict) if goal_dict else None)

    def encode_latent_subgoals(self, obs_dict, subgoals) -> torch.Tensor:
        """Posterior means q(z | subgoal, obs features) [B, latent]: the
        latent targets of HBC's actor in latent-subgoal mode."""
        with torch.no_grad():
            return self.nets.encode(self._put_infer(obs_dict), self._put_infer(subgoals))

    def sample_latent_subgoals(self, obs_dict, num_samples: int = 1, noise=None) -> torch.Tensor:
        """Prior normals [B * num_samples, latent] as latent subgoals."""
        b = next(iter(obs_dict.values())).shape[0]
        return self._normals((b * num_samples, self.latent_dim), noise)

    def get_subgoal_predictions(self, obs_dict, goal_dict=None) -> dict:
        return self.sample_subgoals(obs_dict, goal_dict, num_samples=1)


class ValuePlanner:
    """Sample ``num_samples`` subgoals per obs from a GL-VAE and keep the
    one ``value_fn`` (subgoal leaves [B * n, ...], noise -> [B * n]) scores
    highest."""

    def __init__(self, planner: GLVAE, value_fn, num_samples: int = 10):
        self.planner = planner
        self.value_fn = value_fn
        self.num_samples = num_samples

    def get_subgoal_predictions(self, obs_dict, goal_dict=None, noise=None) -> dict:
        """``noise``: {"subgoals": the planner's prior normals, "value": the
        value function's}, or None for the generators'."""
        n = self.num_samples
        noise = noise or {}
        samples = self.planner.sample_subgoals(obs_dict, goal_dict, num_samples=n,
                                               noise=noise.get("subgoals"))
        with torch.inference_mode():
            values = self.value_fn(samples, noise.get("value"))
            b = values.shape[0] // n
            best = values.reshape(b, n).argmax(dim=1)
            rows = torch.arange(b, device=best.device)
            return {k: v.reshape((b, n) + v.shape[1:])[rows, best] for k, v in samples.items()}
