"""Algorithm registry + base class (counterpart of ``lipvq_tpu/algo/base.py``).

- ``register_algo_factory_func`` / ``algo_factory`` (reference algo.py:34-89)
- ``Algo``: obs-key partitioning and device placement. The port's
  algorithms hold their networks as one ``nn.Module`` (``self.nets``) on
  ``self.device``. Optimizers and the train step belong to training and are
  not ported yet.

Entry points run on the card: with no ``device`` given, ``algo_factory``
takes CUDA and raises where there is none. Pass ``device="cpu"`` to run on
the CPU.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping

import torch

ALGO_REGISTRY: dict[str, Callable] = {}


def register_algo_factory_func(algo_name: str):
    """Decorator registering ``algo_config -> (algo_cls, kwargs)`` resolvers."""

    def decorator(fn):
        ALGO_REGISTRY[algo_name] = fn
        return fn

    return decorator


def resolve_device(device=None) -> torch.device:
    """The given device, or CUDA when none is given. Never drops to the CPU
    quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run lipvq_tpu_torch on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def algo_factory(algo_name: str, config, obs_key_shapes: dict, ac_dim: int,
                 device=None):
    """Instantiate an algorithm on ``device`` (CUDA when None)."""
    if algo_name not in ALGO_REGISTRY:
        raise KeyError(
            f"Unknown algo {algo_name!r}; registered: {sorted(ALGO_REGISTRY)}"
        )
    algo_cls, algo_kwargs = ALGO_REGISTRY[algo_name](config.algo)
    return algo_cls(
        algo_config=config.algo,
        obs_config=config.observation,
        global_config=config,
        obs_key_shapes=obs_key_shapes,
        ac_dim=ac_dim,
        device=device,
        **algo_kwargs,
    )


class Algo:
    """Base algorithm lifecycle (reference algo.py:92-350)."""

    def __init__(self, algo_config, obs_config, global_config,
                 obs_key_shapes: dict, ac_dim: int, device=None):
        self.algo_config = algo_config
        self.obs_config = obs_config
        self.global_config = global_config
        self.obs_key_shapes = obs_key_shapes
        self.ac_dim = ac_dim
        self.device = resolve_device(device)
        self.nets: torch.nn.Module | None = None
        self._create_shapes(obs_config.modalities, obs_key_shapes)
        self._create_networks()

    def _create_shapes(self, obs_keys, obs_key_shapes):
        """Partition obs keys into obs/goal/subgoal shape dicts
        (reference algo.py:139-174)."""
        self.obs_shapes = {}
        self.goal_shapes = {}
        self.subgoal_shapes = {}
        for k, shape in obs_key_shapes.items():
            obs_group = obs_keys.get("obs", {})
            goal_group = obs_keys.get("goal", {})
            if any(k in v for v in obs_group.values()):
                self.obs_shapes[k] = shape
            if any(k in v for v in goal_group.values()):
                self.goal_shapes[k] = shape

    def _put_infer(self, tree):
        """Host arrays (or tensors) -> float32 tensors on ``self.device``;
        tensors already there are not copied."""
        if isinstance(tree, Mapping):
            return {k: self._put_infer(v) for k, v in tree.items()}
        return torch.as_tensor(tree, dtype=torch.float32, device=self.device)

    # -- to implement ------------------------------------------------------
    def _create_networks(self):
        raise NotImplementedError

    def process_batch_for_training(self, batch):
        return batch

    def get_action(self, obs_dict, goal_dict=None):
        raise NotImplementedError


class PolicyAlgo(Algo):
    """Marker base for policy algorithms (reference algo.py:353)."""
