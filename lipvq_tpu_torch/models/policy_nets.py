"""Policy actor heads (counterpart of ``lipvq_tpu/models/policy_nets.py``).

- the ICL actors: the ICL MIMO composite (GPT or Mamba backbone) with GMM
  output heads mean/scale [num_modes, ac_dim] and logits [num_modes],
  tanh-squashed means and low-noise eval (``ICLGMMActorNetwork``), or one
  tanh-squashed ``action`` head (``ICLActorNetwork``);
- the BC family's actors: ``ActorNetwork`` (MLP, tanh output),
  ``GMMActorNetwork`` (MLP + GMM heads), ``TransformerGMMActorNetwork``
  (``MIMOTransformer`` + GMM heads) and ``RNNGMMActorNetwork`` (LSTM + GMM
  heads). Their observation encoders take the algo's encoder cores.

The LSTM is the port's packed ``LSTMCell`` (flax ``OptimizedLSTMCell``): its
gates are fp32 GEMMs (cuBLAS, TF32 off), not cuDNN's RNN.
"""

from __future__ import annotations

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import MLP, TorchLinear
from lipvq_tpu_torch.models.distributions import GMMParams, make_gmm
from lipvq_tpu_torch.models.obs_nets import (
    ICLMIMOTransformer,
    MIMOTransformer,
    ObservationGroupEncoder,
    ObsSpec,
    flatten_time,
    obs_spec,
    spec_encoded_dim,
)
from lipvq_tpu_torch.models.tokenizers.vqvae import LSTMStack


def gmm_output_spec(num_modes: int, ac_dim: int) -> ObsSpec:
    return obs_spec({"mean": (num_modes, ac_dim), "scale": (num_modes, ac_dim),
                     "logits": (num_modes,)})


class ICLGMMActorNetwork(nn.Module):
    """ICL policy with a GMM head over a transformer backbone. Keyword
    arguments besides the GMM ones go to ``ICLMIMOTransformer``."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, *, num_modes: int = 5,
                 min_std: float = 1e-4, std_activation: str = "softplus",
                 low_noise_eval: bool = True, use_tanh: bool = False, **net_kwargs):
        super().__init__()
        self.min_std = min_std
        self.std_activation = std_activation
        self.low_noise_eval = low_noise_eval
        self.use_tanh = use_tanh
        self.net = ICLMIMOTransformer(
            group_specs=group_specs, output_spec=gmm_output_spec(num_modes, ac_dim),
            **net_kwargs)

    def forward_train(self, obs, context_obs, actions, goal=None, train: bool = False,
                      low_noise_eval: bool | None = None,
                      generator: torch.Generator | None = None,
                      ) -> tuple[GMMParams, torch.Tensor]:
        """(GMMParams over [B, T], vq_aux_loss). ``train`` turns on dropout
        (masks from ``generator``) and the EMA codebook statistics. With
        low-noise eval, outside training, every sigma is 1e-4."""
        outputs, aux = self.net(obs, context_obs, actions, goal=goal, train=train,
                                generator=generator)
        if low_noise_eval is None:
            low_noise_eval = self.low_noise_eval
        low_noise_eval = bool(low_noise_eval) and not train
        dists = make_gmm(outputs["mean"], outputs["scale"], outputs["logits"],
                         min_std=self.min_std, std_activation=self.std_activation,
                         use_tanh_mean=not self.use_tanh, low_noise=bool(low_noise_eval))
        return dists, aux


class ICLActorNetwork(nn.Module):
    """Deterministic ICL policy: the same composite with one ``action``
    head [ac_dim], tanh-squashed (the JAX package's intended semantics of
    the reference's ``ICLTransformerActorNetwork``). Keyword arguments go to
    ``ICLMIMOTransformer``."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, **net_kwargs):
        super().__init__()
        self.net = ICLMIMOTransformer(group_specs=group_specs,
                                      output_spec=obs_spec({"action": (ac_dim,)}),
                                      **net_kwargs)

    def forward_train(self, obs, context_obs, actions, goal=None, train: bool = False,
                      low_noise_eval: bool | None = None,
                      generator: torch.Generator | None = None):
        """(tanh-squashed actions [B, T, ac_dim], vq_aux_loss);
        ``low_noise_eval`` has no effect on a deterministic head."""
        outputs, aux = self.net(obs, context_obs, actions, goal=goal, train=train,
                                generator=generator)
        return torch.tanh(outputs["action"]), aux


def _encoded_dim(group_specs: ObsSpec, encoder_cores: ObsSpec) -> int:
    return sum(spec_encoded_dim(spec, encoder_cores) for _, spec in group_specs)


def _groups(obs, goal) -> dict:
    groups = {"obs": obs}
    if goal is not None:
        groups["goal"] = goal
    return groups


class _MLPTrunk(nn.Module):
    """``enc`` (the obs group encoder) and ``mlp``: ``layer_dims`` hidden
    layers with ReLU and an output layer of ``layer_dims[-1]`` (256 without
    hidden layers), no activation after it, as the JAX actors build it."""

    def __init__(self, group_specs: ObsSpec, layer_dims, encoder_cores: ObsSpec):
        super().__init__()
        layer_dims = tuple(layer_dims)
        self.width = layer_dims[-1] if layer_dims else 256
        self.enc = ObservationGroupEncoder(group_specs, encoder_cores=encoder_cores)
        self.mlp = MLP(_encoded_dim(group_specs, encoder_cores), layer_dims, self.width,
                       activation="relu")

    def trunk(self, obs, goal, train, generator):
        return self.mlp(self.enc(train, generator, **_groups(obs, goal)))


class ActorNetwork(_MLPTrunk):
    """Deterministic MLP actor with a tanh output ``out``."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, layer_dims=(1024, 1024),
                 encoder_cores: ObsSpec = ()):
        super().__init__(group_specs, layer_dims, encoder_cores)
        self.out = TorchLinear(self.width, ac_dim)

    def forward(self, obs, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        return torch.tanh(self.out(self.trunk(obs, goal, train, generator)))


class _GMMHeads(nn.Module):
    """Heads ``mean``, ``scale`` [num_modes * ac_dim] and ``logits``
    [num_modes] over a trunk's features, assembled by ``make_gmm``."""

    def _add_heads(self, width: int, ac_dim: int, num_modes: int, min_std: float,
                   std_activation: str, low_noise_eval: bool, use_tanh: bool) -> None:
        self.ac_dim, self.num_modes = ac_dim, num_modes
        self.min_std, self.std_activation = min_std, std_activation
        self.low_noise_eval, self.use_tanh = low_noise_eval, use_tanh
        self.mean = TorchLinear(width, num_modes * ac_dim)
        self.scale = TorchLinear(width, num_modes * ac_dim)
        self.logits = TorchLinear(width, num_modes)

    def _gmm(self, h, low_noise: bool) -> GMMParams:
        lead = h.shape[:-1]
        return make_gmm(
            self.mean(h).reshape(*lead, self.num_modes, self.ac_dim),
            self.scale(h).reshape(*lead, self.num_modes, self.ac_dim), self.logits(h),
            min_std=self.min_std, std_activation=self.std_activation,
            use_tanh_mean=not self.use_tanh, low_noise=low_noise)


class GMMActorNetwork(_MLPTrunk, _GMMHeads):
    """MLP GMM actor of BC-GMM and BC-Gaussian (a 1-mode GMM)."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, layer_dims=(1024, 1024),
                 num_modes: int = 5, min_std: float = 1e-4, std_activation: str = "softplus",
                 low_noise_eval: bool = True, use_tanh: bool = False,
                 encoder_cores: ObsSpec = ()):
        super().__init__(group_specs, layer_dims, encoder_cores)
        self._add_heads(self.width, ac_dim, num_modes, min_std, std_activation,
                        low_noise_eval, use_tanh)

    def forward_train(self, obs, goal=None, train: bool = False,
                      generator: torch.Generator | None = None) -> GMMParams:
        """GMMParams over [B]; sigma 1e-4 outside training with low-noise eval."""
        h = self.trunk(obs, goal, train, generator)
        return self._gmm(h, self.low_noise_eval and not train)


class TransformerGMMActorNetwork(nn.Module):
    """Non-ICL transformer GMM policy over obs sequences: ``net`` is a
    ``MIMOTransformer`` whose decoder heads are the GMM's (``head_mean``,
    ``head_scale``, ``head_logits``). As in the JAX package it runs in fp32
    and without rematerialization whatever the config says (ROADMAP queue 3,
    fault (e))."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, *, num_modes: int = 5,
                 min_std: float = 1e-4, std_activation: str = "softplus",
                 low_noise_eval: bool = True, use_tanh: bool = False, **net_kwargs):
        super().__init__()
        self.min_std, self.std_activation = min_std, std_activation
        self.low_noise_eval, self.use_tanh = low_noise_eval, use_tanh
        self.net = MIMOTransformer(group_specs=group_specs,
                                   output_spec=gmm_output_spec(num_modes, ac_dim), **net_kwargs)

    def forward_train(self, obs, goal=None, train: bool = False,
                      low_noise_eval: bool | None = None,
                      generator: torch.Generator | None = None) -> GMMParams:
        """GMMParams over [B, T]."""
        out = self.net(obs, goal=goal, train=train, generator=generator)
        if low_noise_eval is None:
            low_noise_eval = self.low_noise_eval
        return make_gmm(out["mean"], out["scale"], out["logits"], min_std=self.min_std,
                        std_activation=self.std_activation, use_tanh_mean=not self.use_tanh,
                        low_noise=bool(low_noise_eval) and not train)


class RNNGMMActorNetwork(_GMMHeads):
    """RNN GMM policy: ``enc`` per timestep, ``rnn`` (``num_layers`` LSTM
    layers from a zero carry: the port's ``LSTMStack``, flax's
    ``OptimizedLSTMCell_{i}``), GMM heads at every timestep."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, hidden_dim: int = 400,
                 num_layers: int = 2, num_modes: int = 5, min_std: float = 1e-4,
                 std_activation: str = "softplus", low_noise_eval: bool = True,
                 use_tanh: bool = False, encoder_cores: ObsSpec = ()):
        super().__init__()
        self.enc = ObservationGroupEncoder(group_specs, encoder_cores=encoder_cores)
        self.rnn = LSTMStack(_encoded_dim(group_specs, encoder_cores), hidden_dim, num_layers)
        self._add_heads(hidden_dim, ac_dim, num_modes, min_std, std_activation,
                        low_noise_eval, use_tanh)

    def forward_train(self, obs, goal=None, train: bool = False,
                      low_noise_eval: bool | None = None,
                      generator: torch.Generator | None = None) -> GMMParams:
        """obs (and goal) leaves [B, T, ...] -> GMMParams over [B, T]."""
        b, t = next(iter(obs.values())).shape[:2]
        h = self.enc(train, generator, **_groups(
            flatten_time(obs, b, t), None if goal is None else flatten_time(goal, b, t)))
        h = self.rnn(h.reshape(b, t, -1))
        if low_noise_eval is None:
            low_noise_eval = self.low_noise_eval
        return self._gmm(h, bool(low_noise_eval) and not train)
