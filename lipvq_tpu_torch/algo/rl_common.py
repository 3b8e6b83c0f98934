"""Shared machinery of the offline-RL family (counterpart of
``lipvq_tpu/algo/rl_common.py``): BCQ, CQL, IQL and TD3-BC.

- ``process_rl_batch``: one transition per sequence window (obs at t = 0,
  ``next_obs`` at ``n_step - 1``, the discounted reward sum, the
  ``infinite_horizon`` bonus), on the host in numpy as in the JAX package;
- ``td_target``, ``huber`` and ``polyak_`` (in place, ``(1 - tau) * t +
  tau * o`` as the JAX package writes it: ``torch.lerp`` rounds otherwise);
- ``RLAlgo``: the JAX ``RLState`` as the algo's own state. ``self.nets``
  holds the online networks by name (and CQL's ``log_alpha``) and, under
  ``target``, frozen copies of the networks the algorithm tracks, whose
  tensors are buffers: no optimizer sees them and ``serialize`` carries
  them, as the JAX ``serialize`` carries ``target_params``. ``self.step``
  counts train steps; ``serialize_full`` carries it, so a resume keeps
  TD3-BC's actor-update phase.

Every loss's gradients are taken with respect to its own network only
(``set_grads``) and all are taken before any optimizer steps, as the JAX
step differentiates each loss at the step's starting parameters.
"""

from __future__ import annotations

import copy
from collections.abc import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from lipvq_tpu_torch.algo.base import PolicyAlgo, ScheduledOptimizer
from lipvq_tpu_torch.models.base_nets import seeded_init


def polyak_(targets: Sequence[torch.Tensor], online: Sequence[torch.Tensor], tau: float) -> None:
    """t <- (1 - tau) * t + tau * o for each pair, in place, each product
    rounded as the expression is written. (XLA fuses the JAX package's
    jitted form into one multiply-add, which rounds (1 - tau) * t only in
    the sum: the two differ by up to an ulp of t per update.)"""
    with torch.no_grad():
        torch._foreach_mul_(list(targets), 1.0 - tau)
        torch._foreach_add_(list(targets), torch._foreach_mul(list(online), tau))


def process_rl_batch(batch, n_step: int = 1, discount: float = 0.99,
                     infinite_horizon: bool = False) -> dict:
    """Single-transition batch from sequence windows (reference
    bcq.py/td3_bc.py process_batch_for_training)."""
    out = {"obs": {k: np.asarray(v)[:, 0] for k, v in batch["obs"].items()}}
    if "next_obs" not in batch:
        raise KeyError("offline RL needs next_obs: set train.hdf5_load_next_obs=true")
    out["next_obs"] = {k: np.asarray(v)[:, n_step - 1] for k, v in batch["next_obs"].items()}
    out["actions"] = np.asarray(batch["actions"])[:, 0]
    rewards = np.asarray(batch["rewards"])[:, :n_step].astype(np.float32)
    discounts = discount ** np.arange(n_step, dtype=np.float32)
    out["rewards"] = (rewards * discounts[None]).sum(axis=1)
    dones = np.asarray(batch["dones"])[:, n_step - 1].astype(np.float32)
    out["dones"] = dones
    if infinite_horizon:
        out["rewards"] = out["rewards"] + dones * (
            discount ** n_step / (1.0 - discount)) * rewards[:, -1]
    out["goal_obs"] = batch.get("goal_obs", None)
    return out


def td_target(rewards, dones, next_value, discount: float, n_step: int = 1):
    return rewards + (1.0 - dones) * (discount ** n_step) * next_value


def huber(x, delta: float = 1.0):
    absx = x.abs()
    return torch.where(absx <= delta, 0.5 * x ** 2, delta * (absx - 0.5 * delta))


def frozen_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` whose parameters are buffers of the same
    names: a target network, outside every optimizer, inside the
    state_dict."""
    out = copy.deepcopy(module)
    for m in out.modules():
        for name, p in list(m._parameters.items()):
            del m._parameters[name]
            m.register_buffer(name, None if p is None else p.detach().clone())
    return out


def set_grads(optimizer: ScheduledOptimizer, loss: torch.Tensor) -> None:
    """The gradients of ``loss`` with respect to ``optimizer``'s parameters
    only, into their ``.grad`` (a parameter the loss does not reach gets
    zeros at the step, as in optax)."""
    grads = torch.autograd.grad(loss, optimizer.params, allow_unused=True)
    for p, g in zip(optimizer.params, grads):
        p.grad = g


def step_all(optimizers: Sequence[ScheduledOptimizer]) -> None:
    for o in optimizers:
        o.step()
        o.zero_grad()


class RLAlgo(PolicyAlgo):
    """Base of the offline-RL algorithms. A subclass builds its online
    networks, hands them to ``_finish_networks`` and names in ``TARGETS``
    those that have target copies."""

    TARGETS: tuple[str, ...] = ()

    def _finish_networks(self, online: Mapping[str, nn.Module]) -> None:
        """Initialize each online net on the CPU from its own seed (train.seed,
        + 1, ... in order, as the JAX algo's init keys), copy the targets,
        move everything to the device; the sampling generator takes the
        next seed."""
        seed = int(self.global_config.train.seed)
        for i, net in enumerate(online.values()):
            seeded_init(net, torch.Generator().manual_seed(seed + i))
        nets = nn.ModuleDict(online)
        nets["target"] = nn.ModuleDict({k: frozen_copy(online[k]) for k in self.TARGETS})
        self.nets = nets.to(self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed + len(online))
        self.step = 0

    def generators(self) -> dict[str, torch.Generator]:
        return {"sample": self._generator}

    def update_targets(self, tau: float) -> None:
        """Polyak-average every target network toward its online network."""
        targets, online = [], []
        for name in self.TARGETS:
            net, target = getattr(self.nets, name), self.nets.target[name]
            for key, p in net.named_parameters():
                targets.append(target.get_buffer(key))
                online.append(p)
        polyak_(targets, online, tau)

    def _normals(self, shape, noise=None, uniform: bool = False) -> torch.Tensor:
        """``noise`` on the device, or standard normals (uniforms in [-1, 1)
        with ``uniform``) of ``shape`` from the algo's generator."""
        if noise is not None:
            return self._put_infer(noise)
        if uniform:
            return torch.rand(shape, generator=self._generator, device=self.device) * 2 - 1
        return torch.randn(shape, generator=self._generator, device=self.device)

    def _draw(self, draws, key: str, shape, uniform: bool = False) -> torch.Tensor:
        """A train step's draw ``key``: ``draws[key]``, or the generator's."""
        return self._normals(shape, None if draws is None else draws[key], uniform)

    def _last_step(self, obs_dict) -> dict:
        """Single-step policies read [B, ...] obs: a time axis, if given,
        is cut to its last step."""
        obs = self._put_infer(obs_dict)
        return {k: v[:, -1] if v.ndim > 1 + len(self.obs_shapes[k]) else v
                for k, v in obs.items()}

    def serialize_full(self) -> dict:
        return {**super().serialize_full(), "step": self.step}

    def deserialize_full(self, payload: Mapping) -> None:
        super().deserialize_full(payload)
        self.step = int(payload["step"])
