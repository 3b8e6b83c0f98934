"""ICL actors (counterparts of ``ICLGMMActorNetwork`` and
``ICLActorNetwork`` in ``lipvq_tpu/models/policy_nets.py``): the ICL MIMO
composite (GPT or Mamba backbone) with GMM output heads mean/scale
[num_modes, ac_dim] and logits [num_modes], tanh-squashed means and
low-noise eval; or with one tanh-squashed ``action`` head."""

from __future__ import annotations

import torch
from torch import nn

from lipvq_tpu_torch.models.distributions import GMMParams, make_gmm
from lipvq_tpu_torch.models.obs_nets import ICLMIMOTransformer, ObsSpec, obs_spec


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
