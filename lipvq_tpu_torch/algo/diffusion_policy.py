"""Diffusion Policy (UNet-1D, DDPM / DDIM) with an EMA of the weights
(counterpart of ``lipvq_tpu/algo/diffusion_policy.py``).

- the obs of ``To`` steps, encoded per step (low-dim keys flattened, as the
  JAX package builds it: no encoder cores), flattened into the global
  condition;
- train: x_t = add_noise(actions, eps, t) over the ``Tp``-step action
  window, the UNet predicts eps, MSE; one policy optimizer (Adam with L2,
  the cosine schedule over max(epochs * epoch_every_n_steps, 1000) steps);
- EMA: after each optimizer step every parameter moves as
  ``ema = decay * ema + (1 - decay) * param`` with diffusers' power decay
  ``clip(1 - (1 + step)^-power, 0, 0.9999)`` (step counted from 1), one
  fused ``_foreach_lerp_`` over the tensors;
- inference: DDPM (or DDIM) from the EMA net (the trained net with
  ``ema.enabled`` off) over the prediction horizon; an action queue serves
  ``Ta`` actions from step ``To - 1``. As in the JAX package, the queue is
  not cleared at an episode's start (ROADMAP queue 3, reference fault (a)).
- ``serialize`` carries the EMA net's state under ``ema.``; a full train
  state adds the optimizer (its step count is the EMA's) and the
  generator.

Noise and timesteps come from the algo's generator, or from ``draws`` (the
tests replay the JAX package's). ``algo.unet.diffusion_step_embed_dim`` and
``algo.unet.n_groups`` are not read, as in the JAX package (256 and 8;
ROADMAP queue 3, reference fault (b)).
"""

from __future__ import annotations

import copy
from collections import deque

import numpy as np
import torch
from torch import nn

from lipvq_tpu_torch.algo.base import (
    PolicyAlgo,
    ScheduledOptimizer,
    optimizer_from_optim_params,
    register_algo_factory_func,
)
from lipvq_tpu_torch.models.base_nets import seeded_init
from lipvq_tpu_torch.models.diffusion_nets import ConditionalUnet1D
from lipvq_tpu_torch.models.obs_nets import (
    ObservationGroupEncoder,
    flatten_time,
    obs_spec,
    spec_flat_dim,
)
from lipvq_tpu_torch.ops.diffusion_schedulers import (
    add_noise,
    ddim_sample,
    ddpm_sample,
    make_scheduler,
)

EMA_KEY = "ema."  # prefix of the EMA net's entries in a ``serialize`` payload


@register_algo_factory_func("diffusion_policy")
def algo_config_to_class(algo_config):
    if not algo_config.unet.enabled:
        raise ValueError("diffusion_policy needs algo.unet.enabled")
    return DiffusionPolicyUNet, {}


class DiffusionNet(nn.Module):
    """The obs encoder (``encoder``) and the ``unet`` in one module, as the
    JAX ``NetModule``."""

    def __init__(self, group_specs, ac_dim: int, To: int, down_dims=(256, 512, 1024),
                 kernel_size: int = 5):
        super().__init__()
        self.encoder = ObservationGroupEncoder(group_specs, feature_activation=None)
        obs_dim = sum(spec_flat_dim(s) for _, s in group_specs)
        self.unet = ConditionalUnet1D(input_dim=ac_dim, global_cond_dim=obs_dim * To,
                                      down_dims=tuple(down_dims), kernel_size=kernel_size)

    def encode_obs(self, obs, train: bool = False):
        """obs leaves [B, To, ...] -> the global condition [B, To * D]."""
        b, t = next(iter(obs.values())).shape[:2]
        return self.encoder(train, None, obs=flatten_time(obs, b, t)).reshape(b, -1)

    def forward(self, obs, noisy_actions, timesteps, train: bool = False):
        return self.unet(noisy_actions, timesteps, self.encode_obs(obs, train))


class DiffusionPolicyUNet(PolicyAlgo):
    def _create_networks(self):
        hc = self.algo_config.horizon
        self.To = int(hc.observation_horizon)
        self.Ta = int(hc.action_horizon)
        self.Tp = int(hc.prediction_horizon)
        self.use_ddim = bool(self.algo_config.ddim.enabled)
        sc = self.algo_config.ddim if self.use_ddim else self.algo_config.ddpm
        self.scheduler = make_scheduler(
            num_train_timesteps=int(sc.num_train_timesteps),
            beta_schedule=str(sc.beta_schedule), clip_sample=bool(sc.clip_sample),
            prediction_type=str(sc.prediction_type), device=self.device)
        self.num_inference_timesteps = int(sc.num_inference_timesteps)
        unet = self.algo_config.unet
        self.nets = DiffusionNet(
            (("obs", obs_spec(self.obs_shapes)),), self.ac_dim, self.To,
            down_dims=tuple(unet.down_dims) if "down_dims" in unet else (256, 512, 1024),
            kernel_size=int(unet.get("kernel_size", 5)))
        seed = int(self.global_config.train.seed)
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self.ema_nets = copy.deepcopy(self.nets).requires_grad_(False)
        self.ema_enabled = bool(self.algo_config.ema.enabled)
        self.ema_power = float(self.algo_config.ema.power)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + 3)
        self._action_queue: deque = deque()

    def _create_optimizers(self):
        num_training_steps = int(self.global_config.train.num_epochs) * int(
            self.global_config.experiment.epoch_every_n_steps or 100)
        self.policy_optimizer = optimizer_from_optim_params(
            self.nets.parameters(), self.algo_config.optim_params.policy,
            max_grad_norm=self.global_config.train.max_grad_norm,
            num_training_steps=max(num_training_steps, 1000))

    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        return {"policy": self.policy_optimizer}

    def generators(self) -> dict[str, torch.Generator]:
        return {"sample": self._generator}

    def process_batch_for_training(self, batch):
        """The first ``To`` obs steps and the ``Tp``-step action window."""
        out = {"obs": {k: np.asarray(v)[:, :self.To] for k, v in batch["obs"].items()},
               "actions": np.asarray(batch["actions"])[:, :self.Tp],
               "goal_obs": batch.get("goal_obs", None)}
        if out["actions"].shape[1] != self.Tp:
            raise ValueError(f"need seq_length >= prediction_horizon {self.Tp}")
        return out

    def ema_decay(self, step: int) -> float:
        """clip(1 - (1 + step)^-power, 0, 0.9999) in float32, as the JAX step."""
        decay = np.float32(1.0) - np.float32(1.0 + step) ** np.float32(-self.ema_power)
        return float(np.clip(decay, np.float32(0.0), np.float32(0.9999)))

    def train_on_batch(self, batch, epoch, validate: bool = False, draws=None):
        """One epsilon-MSE step, then the EMA -> {"losses": {action_loss}}.
        ``draws={"noise": [B, Tp, A], "timesteps": [B]}`` replaces the
        generator's draws."""
        batch = self._put_batch(batch)
        actions = batch["actions"]
        if draws is None:
            noise = torch.randn(actions.shape, generator=self._generator, device=self.device)
            timesteps = torch.randint(self.scheduler.num_train_timesteps, (actions.shape[0],),
                                      generator=self._generator, device=self.device)
        else:
            noise = self._put_infer(draws["noise"])
            timesteps = torch.as_tensor(draws["timesteps"], device=self.device).long()
        train = not validate
        with torch.set_grad_enabled(train):
            noisy = add_noise(self.scheduler, actions, noise, timesteps)
            pred = self.nets(batch["obs"], noisy, timesteps, train=train)
            loss = torch.mean((pred - noise) ** 2)
        if train:
            loss.backward()
            self.policy_optimizer.step()
            self.policy_optimizer.zero_grad()
            decay = self.ema_decay(self.policy_optimizer.steps)
            with torch.no_grad():
                torch._foreach_lerp_(list(self.ema_nets.parameters()),
                                     list(self.nets.parameters()), 1.0 - decay)
        return {"losses": {"action_loss": loss.detach()}}

    # -- inference -----------------------------------------------------------
    def sample(self, obs, noise=None) -> torch.Tensor:
        """An action trajectory [B, Tp, A] for obs leaves [B, To, ...] (device
        tensors) from the EMA net (the trained one with the EMA off), drawn
        from the generator or from ``noise`` (``ddpm_sample``'s / ``ddim_sample``'s)."""
        net = self.ema_nets if self.ema_enabled else self.nets
        with torch.inference_mode():
            cond = net.encode_obs(obs)
            shape = (cond.shape[0], self.Tp, self.ac_dim)

            def model(x, t):
                return net.unet(x, t, cond)

            sampler = ddim_sample if self.use_ddim else ddpm_sample
            return sampler(self.scheduler, model, shape, self._generator,
                           num_inference_timesteps=self.num_inference_timesteps,
                           device=self.device, noise=noise)

    def reset(self):
        self._action_queue.clear()

    def get_action(self, obs_dict, goal_dict=None, noise=None):
        """Serve the queued actions; with the queue empty, sample a trajectory
        from the last ``To`` obs steps and queue its ``Ta`` actions from step
        ``To - 1``. ``noise`` is the sampler's, for a new trajectory."""
        if not self._action_queue:
            obs = self._put_infer({k: v[:, -self.To:] for k, v in obs_dict.items()})
            traj = self.sample(obs, noise=noise).cpu().numpy()
            self._action_queue.extend(traj[:, i] for i in range(self.To - 1,
                                                                self.To - 1 + self.Ta))
        return self._action_queue.popleft()

    # -- checkpointing: the EMA net rides along --------------------------------
    def serialize(self) -> dict[str, torch.Tensor]:
        payload = super().serialize()
        payload.update({EMA_KEY + k: v.detach().to("cpu", copy=True)
                        for k, v in self.ema_nets.state_dict().items()})
        return payload

    def deserialize(self, payload) -> None:
        payload = dict(payload)
        ema = {k[len(EMA_KEY):]: payload.pop(k) for k in list(payload) if k.startswith(EMA_KEY)}
        super().deserialize(payload)
        self.ema_nets.load_state_dict(ema, strict=True)
