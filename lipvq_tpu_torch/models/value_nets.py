"""Value networks (counterpart of ``lipvq_tpu/models/value_nets.py``).

- ``ValueNetwork``: V(s), the obs encoder ``enc``, an MLP ``mlp`` and the
  output ``out``, with optional value bounds lo + (hi - lo) * sigmoid(v);
- ``ActionValueNetwork``: Q(s, a), the action concatenated to the obs
  features before the MLP;
- ``DistributionalActionValueNetwork``: per-atom logits over fixed value
  atoms, the scalar value their probability-weighted sum (no algorithm
  builds it, as in the JAX package);
- ``QEnsemble``: ``n`` independent Q networks ``q0 .. q{n-1}``, stacked
  [n, B].

The module names are flax's, so the weight bridge maps the JAX trees key
for key.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from lipvq_tpu_torch.models.base_nets import MLP, TorchLinear
from lipvq_tpu_torch.models.obs_nets import ObservationGroupEncoder, ObsSpec, spec_encoded_dim


class _Head(nn.Module):
    """``enc`` over the obs (and goal) groups, the actions concatenated when
    given, ``mlp`` (``layer_dims`` hidden layers with ReLU, then a linear
    layer of ``layer_dims[-1]``) and ``out`` of ``out_dim``."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, layer_dims: Sequence[int],
                 out_dim: int, encoder_cores: ObsSpec):
        super().__init__()
        layer_dims = tuple(layer_dims)
        self.enc = ObservationGroupEncoder(group_specs, encoder_cores=encoder_cores)
        in_dim = sum(spec_encoded_dim(spec, encoder_cores) for _, spec in group_specs) + ac_dim
        self.mlp = MLP(in_dim, layer_dims, layer_dims[-1], activation="relu")
        self.out = TorchLinear(layer_dims[-1], out_dim)

    def _out(self, obs, actions, goal, train: bool, generator):
        groups = {"obs": obs}
        if goal is not None:
            groups["goal"] = goal
        h = self.enc(train, generator, **groups)
        if actions is not None:
            h = torch.cat([h, actions], dim=-1)
        return self.out(self.mlp(h))


def _bounded(v, value_bounds):
    if value_bounds is None:
        return v
    lo, hi = value_bounds
    return lo + (hi - lo) * torch.sigmoid(v)


class ValueNetwork(_Head):
    """V(s) -> [B]."""

    def __init__(self, group_specs: ObsSpec, layer_dims: Sequence[int] = (300, 400),
                 value_bounds: tuple | None = None, encoder_cores: ObsSpec = ()):
        super().__init__(group_specs, 0, layer_dims, 1, encoder_cores)
        self.value_bounds = value_bounds

    def forward(self, obs, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        return _bounded(self._out(obs, None, goal, train, generator)[..., 0], self.value_bounds)


class ActionValueNetwork(_Head):
    """Q(s, a) -> [B]."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, layer_dims: Sequence[int] = (300, 400),
                 value_bounds: tuple | None = None, encoder_cores: ObsSpec = ()):
        super().__init__(group_specs, ac_dim, layer_dims, 1, encoder_cores)
        self.value_bounds = value_bounds

    def forward(self, obs, actions, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        return _bounded(self._out(obs, actions, goal, train, generator)[..., 0],
                        self.value_bounds)


class DistributionalActionValueNetwork(_Head):
    """Categorical (C51-style) Q(s, a) over ``num_atoms`` atoms spaced
    evenly over ``value_bounds``: the logits [B, num_atoms] with
    ``return_logits``, else the expected value [B]."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, num_atoms: int = 51,
                 value_bounds: tuple = (-1.0, 200.0), layer_dims: Sequence[int] = (300, 400),
                 encoder_cores: ObsSpec = ()):
        super().__init__(group_specs, ac_dim, layer_dims, num_atoms, encoder_cores)
        self.num_atoms, self.value_bounds = num_atoms, tuple(value_bounds)

    @property
    def atoms(self) -> torch.Tensor:
        return torch.linspace(self.value_bounds[0], self.value_bounds[1], self.num_atoms)

    def forward(self, obs, actions, goal=None, train: bool = False, return_logits: bool = False,
                generator: torch.Generator | None = None):
        logits = self._out(obs, actions, goal, train, generator)
        if return_logits:
            return logits
        probs = torch.softmax(logits, dim=-1)
        return torch.sum(probs * self.atoms.to(logits.device)[None], dim=-1)


class QEnsemble(nn.Module):
    """``n`` independent ``ActionValueNetwork``s ``q0 .. q{n-1}`` -> [n, B]."""

    def __init__(self, group_specs: ObsSpec, ac_dim: int, n: int = 2,
                 layer_dims: Sequence[int] = (300, 400), value_bounds: tuple | None = None,
                 encoder_cores: ObsSpec = ()):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"q{i}", ActionValueNetwork(group_specs, ac_dim, layer_dims,
                                                        value_bounds, encoder_cores))

    def forward(self, obs, actions, goal=None, train: bool = False,
                generator: torch.Generator | None = None):
        return torch.stack([getattr(self, f"q{i}")(obs, actions, goal, train, generator)
                            for i in range(self.n)], dim=0)
