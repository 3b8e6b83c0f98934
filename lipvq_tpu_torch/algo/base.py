"""Algorithm registry + base class (counterpart of ``lipvq_tpu/algo/base.py``).

- ``register_algo_factory_func`` / ``algo_factory`` (reference algo.py:34-89)
- ``Algo``: obs-key partitioning, device placement and checkpointing. The
  port's algorithms hold their networks as one ``nn.Module`` (``self.nets``)
  on ``self.device``; ``serialize`` is its state_dict, ``serialize_full``
  adds the optimizers and random generators (reference algo.py:267-301).
- ``lr_schedule_from_config`` / ``optimizer_from_optim_params``: the optax
  chain clip-by-global-norm -> (L2) -> Adam/AdamW(schedule) of the JAX
  package as a ``ScheduledOptimizer`` (reference torch_utils.py:90-196).

Entry points run on the card: with no ``device`` given, ``algo_factory``
takes CUDA and raises where there is none. Pass ``device="cpu"`` to run on
the CPU.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping, Sequence

import numpy as np
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


def frames_to_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 camera frames -> float32 in [0, 1]: x / 255, one correctly
    rounded division on any device, bit-equal to ``process_frame`` on the
    host. The divisor is a tensor on the frames' device: with a CPU scalar,
    a CUDA division multiplies by the reciprocal instead."""
    x = frames.to(torch.float32)
    return x / torch.full((), 255.0, device=x.device)


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


def lr_schedule_from_config(optim_params, num_training_steps: int | None = None
                            ) -> Callable[[int], float]:
    """The learning rate at each update count 0, 1, ... (the optax
    schedules of the JAX package). As there, ``multistep`` milestones are
    step counts, not epochs (reference icl.py:204-227 steps the scheduler
    once per gradient step)."""
    lr_cfg = optim_params["learning_rate"]
    lr = float(lr_cfg["initial"])
    sched_type = lr_cfg.get("scheduler_type", "constant_with_warmup")
    warmup = int(lr_cfg.get("num_warmup_steps", 10000))
    decay_factor = float(lr_cfg.get("decay_factor", 0.1))

    def linear(init: float, end: float, steps: int) -> Callable[[int], float]:
        if steps <= 0:
            return lambda step: init
        return lambda step: (init - end) * (1 - min(max(step, 0), steps) / steps) + end

    if sched_type in (None, "none", "constant"):
        return lambda step: lr
    if sched_type == "constant_with_warmup":
        ramp = linear(0.0, lr, warmup)
        return lambda step: ramp(step) if step < warmup else lr
    if sched_type == "linear":
        return linear(lr, lr * decay_factor, warmup)
    if sched_type == "multistep":
        milestones = sorted({int(m) for m in lr_cfg["epoch_schedule"]})
        if not milestones:
            raise ValueError("the multistep schedule needs epoch_schedule milestones")
        return lambda step: lr * decay_factor ** sum(step >= m for m in milestones)
    if sched_type == "cosine":
        if num_training_steps is None:
            raise ValueError("the cosine schedule needs num_training_steps")
        ramp = linear(0.0, lr, warmup)
        decay_steps = num_training_steps - warmup
        if decay_steps <= 0:
            raise ValueError("the cosine schedule needs num_training_steps > "
                             "num_warmup_steps")

        def cosine(step: int) -> float:
            if step < warmup:
                return ramp(step)
            count = min(step - warmup, decay_steps)
            return lr * 0.5 * (1 + math.cos(math.pi * count / decay_steps))

        return cosine
    raise ValueError(f"Invalid LR scheduler type: {sched_type}")


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), on
    the device: no host sync."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global norm reaches
    ``max_norm``, every grad is scaled by max_norm / norm."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(list(grads), scale)


class ScheduledOptimizer:
    """A torch optimizer over ``params`` with an optional global-norm clip
    run first and a learning rate set from ``schedule`` at each step, as
    the optax chain of the JAX package applies them. With a ``mesh``
    (``Algo.attach_mesh``) the gradients are averaged over the ranks, in one
    flat buffer, before anything reads them: the clip sees the global
    gradient, as under GSPMD."""

    def __init__(self, params, optimizer_cls, schedule: Callable[[int], float],
                 max_grad_norm: float | None = None, **optimizer_kwargs):
        self.params = list(params)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.optimizer = optimizer_cls(self.params, lr=schedule(0), **optimizer_kwargs)
        self.steps = 0
        self.mesh = None
        self._reduced = False

    def grads(self) -> list[torch.Tensor]:
        """Every param's grad; a param that got none gets zeros, so that
        decay and the moments apply to it as they do in optax. Under a mesh
        the first call of a step averages them over the ranks."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None and not self._reduced:
            self.mesh.mean_(grads)
            self._reduced = True
        return grads

    def step(self) -> None:
        """Clip (if set), update with the current learning rate, then
        advance the schedule."""
        grads = self.grads()
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, float(self.max_grad_norm))
        self.optimizer.step()
        self.steps += 1
        self._reduced = False
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.steps)

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        self._reduced = False

    def to(self, device: torch.device) -> None:
        """Move the moments to ``device``; the step counts stay on the CPU,
        where torch's Adam keeps them."""
        for state in self.optimizer.state.values():
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and k != "step":
                    state[k] = v.to(device)

    def state_dict(self) -> dict:
        """The torch optimizer's state and the schedule's step counter."""
        return {"steps": self.steps, "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        """The torch state carries each group's current lr as well."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.steps = int(state["steps"])


def optimizer_from_optim_params(params, optim_params, max_grad_norm: float | None = None,
                                num_training_steps: int | None = None) -> ScheduledOptimizer:
    """Adam with L2 added into the gradient (torch ``Adam(weight_decay=)``,
    optax ``add_decayed_weights`` before ``adam``) or decoupled AdamW, with
    the schedule and an optional global-norm clip (reference
    torch_utils.py:90-120 + backprop_for_loss:196)."""
    schedule = lr_schedule_from_config(optim_params, num_training_steps)
    wd = float(optim_params["regularization"]["L2"])
    opt_type = optim_params.get("optimizer_type", "adam")
    if opt_type == "adam":
        cls = torch.optim.Adam
    elif opt_type == "adamw":
        cls = torch.optim.AdamW
    else:
        raise ValueError(opt_type)
    return ScheduledOptimizer(params, cls, schedule, max_grad_norm=max_grad_norm,
                              weight_decay=wd, eps=1e-8)


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
        self._create_optimizers()

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

    # composite algos (HBC, IRIS, the GL wrappers) hold sub-algos here
    SUB_ALGOS = ("planner", "actor", "value_bcq", "_raw_planner")

    def sub_algos(self) -> list[Algo]:
        return [sub for sub in (getattr(self, a, None) for a in self.SUB_ALGOS)
                if isinstance(sub, Algo)]

    def set_inference_device(self, device) -> None:
        """Move the algo to ``device``, the CPU included: this is an explicit
        request (``lipvq_tpu/algo/base.py:206-221``, which the kitchen suite
        calls to serve from the host). Its modules, tensors, optimizer
        moments and ``_put_infer``'s target move; a generator on another
        device is replaced by one there, seeded from its next draw (the two
        devices' streams differ). Reaches the sub-algos."""
        device = torch.device(device)
        for sub in self.sub_algos():
            sub.set_inference_device(device)
        for name, value in list(vars(self).items()):
            if isinstance(value, torch.nn.Module):
                value.to(device)
            elif isinstance(value, torch.Tensor):
                setattr(self, name, value.to(device))
            elif isinstance(value, torch.Generator) and value.device.type != device.type:
                seed = int(torch.randint(2**62, (), generator=value, device=value.device))
                setattr(self, name, torch.Generator(device=device).manual_seed(seed))
        for o in self.optimizers().values():
            o.to(device)
        self.device = device

    def _put_infer(self, tree):
        """Host arrays (or tensors) -> float32 tensors on ``self.device``;
        tensors already there are not copied. uint8 leaves are camera frames
        (``process_obs_for_device`` keeps them so): they are copied as uint8
        and divided by 255 on the device (``frames_to_float``)."""
        if isinstance(tree, Mapping):
            return {k: self._put_infer(v) for k, v in tree.items()}
        if (tree.dtype == torch.uint8 if isinstance(tree, torch.Tensor)
                else np.asarray(tree).dtype == np.uint8):
            return frames_to_float(torch.as_tensor(tree, device=self.device))
        return torch.as_tensor(tree, dtype=torch.float32, device=self.device)

    # -- data-parallel execution -------------------------------------------
    mesh = None  # parallel.mesh.Mesh when attached; None = one device

    def attach_mesh(self, mesh) -> None:
        """Data-parallel training over ``mesh`` (``parallel/mesh.py``): the
        replicas are made equal by a broadcast from rank 0; every training
        batch is cut to this rank's rows (``_put_batch``); the optimizers
        average their gradients over the ranks; the EMA codebook sums its
        cluster statistics and the BatchNorm layers their batch statistics
        over the ranks; random draws take this rank's rows of the global
        draw; ``train_on_batch`` returns metrics averaged over the ranks.
        Reaches the sub-algos, as in the JAX package."""
        from lipvq_tpu_torch.parallel import mesh as mesh_lib

        self.mesh = mesh
        for sub in self.sub_algos():
            sub.attach_mesh(mesh)
        modules = [v for v in vars(self).values() if isinstance(v, torch.nn.Module)]
        mesh_lib.replicate(mesh, [t for m in modules for t in m.state_dict().values()])
        for m in modules:
            for child in m.modules():
                if hasattr(child, "mesh"):
                    child.mesh = mesh
        for o in self.optimizers().values():
            o.mesh = mesh
        step = type(self).train_on_batch

        def train_on_batch(batch, epoch, validate: bool = False, **kw):
            with mesh_lib.row_shard_scope():
                return mesh.mean_tree(step(self, batch, epoch, validate=validate, **kw))

        self.train_on_batch = train_on_batch

    def _shard_rows(self, rows: int) -> tuple[int, torch.Tensor]:
        """(units, this rank's units) of a batch of ``rows``: the units whose
        draws are per row, here the rows themselves, a contiguous block."""
        from lipvq_tpu_torch.parallel.mesh import shard_rows

        return rows, shard_rows(self.mesh, rows)

    def _batch_rows(self, rows: int) -> torch.Tensor:
        """This rank's rows of a batch of ``rows``."""
        return self._shard_rows(rows)[1]

    def _put_batch(self, batch):
        """Host batch -> float32 tensors on ``self.device`` (None stays).
        Under a mesh, this rank's rows only; every leading dim must divide
        by the data axis, as in the JAX package."""
        if self.mesh is not None:
            from lipvq_tpu_torch.parallel import mesh as mesh_lib

            n = self.mesh.shape["data"]
            lead = set()

            def walk(tree):
                if isinstance(tree, Mapping):
                    for v in tree.values():
                        walk(v)
                elif tree is not None and getattr(tree, "ndim", 0) > 0:
                    lead.add(tree.shape[0])

            walk(batch)
            bad = [b for b in lead if b % n != 0]
            if bad:
                raise ValueError(
                    f"batch leading dim(s) {sorted(bad)} not divisible by "
                    f"data-parallel mesh size {n}; adjust train.batch_size")
            batch = mesh_lib.shard_batch(self.mesh, batch, self._batch_rows)
            self._shard = self._shard_rows(max(lead))
            mesh_lib.set_row_shard(*self._shard)
        return {k: None if v is None else self._put_infer(v) for k, v in batch.items()}

    # -- to implement ------------------------------------------------------
    def _create_networks(self):
        raise NotImplementedError

    def _create_optimizers(self):
        pass

    def process_batch_for_training(self, batch):
        return batch

    def get_action(self, obs_dict, goal_dict=None):
        raise NotImplementedError

    def train_on_batch(self, batch, epoch, validate: bool = False):
        raise NotImplementedError

    def log_info(self, info) -> dict:
        return {"Loss": float(info["losses"]["action_loss"])}

    # -- checkpointing -----------------------------------------------------
    def optimizers(self) -> dict[str, ScheduledOptimizer]:
        """The optimizers a full train state carries, by name."""
        return {}

    def generators(self) -> dict[str, torch.Generator]:
        """The random generators a full train state carries, by name."""
        return {}

    def serialize(self) -> dict[str, torch.Tensor]:
        """The nets' state_dict (parameters and buffers, such as the EMA
        codebook's), copied to the CPU (reference algo.py:323)."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.nets.state_dict().items()}

    def deserialize(self, payload: Mapping[str, torch.Tensor]) -> None:
        """Load a ``serialize`` payload onto the nets' device; every key must
        match."""
        self.nets.load_state_dict(payload, strict=True)

    def serialize_full(self) -> dict:
        """The whole train state: ``serialize``, each optimizer's state and
        schedule step, and each generator's state, so a resumed run takes the
        next step as the run it came from would have."""
        return {"model": self.serialize(),
                "optimizers": {k: o.state_dict() for k, o in self.optimizers().items()},
                "generators": {k: g.get_state() for k, g in self.generators().items()}}

    def deserialize_full(self, payload: Mapping) -> None:
        optimizers, generators = self.optimizers(), self.generators()
        if set(payload["optimizers"]) != set(optimizers) or set(
                payload["generators"]) != set(generators):
            raise KeyError(f"the train state holds optimizers {sorted(payload['optimizers'])} "
                           f"and generators {sorted(payload['generators'])}; this algo has "
                           f"{sorted(optimizers)} and {sorted(generators)}")
        self.deserialize(payload["model"])
        for k, o in optimizers.items():
            o.load_state_dict(payload["optimizers"][k])
        for k, g in generators.items():
            g.set_state(payload["generators"][k])

    # the train step takes ``train`` explicitly, as the JAX one does, so the
    # mode switches of the training loop have nothing to do
    def set_train(self):
        pass

    def set_eval(self):
        pass

    def on_epoch_end(self, epoch):
        pass


class PolicyAlgo(Algo):
    """Marker base for policy algorithms (reference algo.py:353)."""
