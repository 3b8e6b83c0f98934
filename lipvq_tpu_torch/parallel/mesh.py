"""Data-parallel process groups (counterpart of ``lipvq_tpu/parallel/mesh.py``).

The JAX package shards every batch over a ``jax.sharding.Mesh`` with a
``data`` and a ``model`` axis and lets GSPMD insert the collectives. Here a
``Mesh`` is a ``torch.distributed`` process group, one rank per device
(NCCL on CUDA, gloo on the CPU), and the collectives GSPMD would insert are
written out where they belong:

- ``shard_batch``: each rank takes its rows of the global batch (ranks of one
  model group take the same rows; ``model_axis`` is 1 in every caller);
- ``replicate``: every tensor of a tree broadcast from rank 0;
- ``Mesh.mean_``: the gradient all-reduce, one flat buffer per call;
- ``Mesh.sum_``: the EMA codebook's cluster statistics; ``Mesh.extrema``:
  the bin tokenizer's batch bounds;
- ``all_reduce_sum``: a differentiable sum across ranks, for the BatchNorm
  statistics of a training forward;
- ``draw_rows``: a random draw as the whole batch would have drawn it, this
  rank's rows taken, so dropout masks and crops do not depend on the layout.

``make_mesh`` joins the group that is initialized, or (one device) starts a
group of one through a ``FileStore`` in a temporary directory: there is no
network. ``scripts/train.py`` spawns the ranks of a larger group.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_group(rank: int, world: int, store_path: str, device: torch.device) -> None:
    """Join rank ``rank`` of ``world`` through the ``FileStore`` at
    ``store_path`` (a file all ranks can reach), on ``device``'s backend."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


class Mesh:
    """The initialized process group as a (data, model) grid of ranks."""

    def __init__(self, model_axis: int = 1):
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        if self.world % model_axis:
            raise ValueError(f"{self.world} ranks do not split into model groups of {model_axis}")
        self.model_axis = model_axis
        self.shape = {"data": self.world // model_axis, "model": model_axis}
        self.backend = dist.get_backend()

    @property
    def data_index(self) -> int:
        """This rank's shard: ranks of one model group share it."""
        return self.rank // self.model_axis

    def mean_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Average ``tensors`` over the ranks in place, in one flat buffer."""
        self._reduce_(tensors, mean=True)

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Sum ``tensors`` over the ranks in place, in one flat buffer."""
        self._reduce_(tensors, mean=False)

    def _reduce_(self, tensors, mean: bool) -> None:
        tensors = list(tensors)
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        if mean:
            flat /= self.world
        with torch.no_grad():
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))

    def extrema(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(min, max) over the ranks of ``x``'s leading axis, in one
        all-reduce; a rank with no rows gives +inf / -inf."""
        inf = torch.full(x.shape[1:], float("inf"), dtype=x.dtype, device=x.device)
        lo, hi = (x.amin(0), x.amax(0)) if x.shape[0] else (inf, -inf)
        both = torch.stack([lo, -hi])
        dist.all_reduce(both, op=dist.ReduceOp.MIN)
        return both[0], -both[1]

    def mean_tree(self, tree):
        """A copy of ``tree`` with every floating tensor averaged over the
        ranks (the logged metrics)."""
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            if isinstance(node, torch.Tensor) and node.is_floating_point():
                leaves.append(node.detach().clone())
                return leaves[-1]
            return node

        out = walk(tree)
        self.mean_(leaves)
        return out


def make_mesh(n_devices: int | None = None, model_axis: int = 1, devices=None) -> Mesh:
    """The mesh of the initialized process group; with none initialized and
    one device, a group of one on ``devices[0]`` (CUDA when None, raising
    without a card). A larger mesh needs its ranks started first
    (``init_group``), one process per device."""
    if not dist.is_initialized():
        if (n_devices or 1) != 1:
            raise ValueError(f"a mesh of {n_devices} devices needs {n_devices} ranks: start "
                             f"them (scripts/train.py spawns them) and call init_group in each")
        from lipvq_tpu_torch.algo.base import resolve_device

        device = resolve_device(devices[0] if devices else None)
        store = os.path.join(tempfile.mkdtemp(prefix="lipvq_mesh_"), "store")
        init_group(0, 1, store, device)
    mesh = Mesh(model_axis)
    if n_devices is not None and n_devices != mesh.world:
        raise ValueError(f"asked for a mesh of {n_devices} devices in a group of {mesh.world}")
    return mesh


def shard_rows(mesh: Mesh, rows: int) -> torch.Tensor:
    """This rank's rows of a batch of ``rows`` (a multiple of the data axis):
    a contiguous block, as a leading-axis sharding lays them out."""
    n = rows // mesh.shape["data"]
    return torch.arange(mesh.data_index * n, (mesh.data_index + 1) * n)


def batch_sharding(mesh: Mesh) -> Callable[[int], torch.Tensor]:
    """The leading-axis sharding of batches: rows -> this rank's rows."""
    return lambda rows: shard_rows(mesh, rows)


def shard_batch(mesh: Mesh, batch, sharding: Callable[[int], torch.Tensor] | None = None):
    """Every array or tensor leaf of ``batch`` at this rank's rows of its
    leading axis (``sharding``: rows -> this rank's rows; by default
    ``batch_sharding``); None and scalars stay."""
    sharding = sharding or batch_sharding(mesh)

    def take(leaf):
        if isinstance(leaf, Mapping):
            return {k: take(v) for k, v in leaf.items()}
        if leaf is None or getattr(leaf, "ndim", 0) == 0:
            return leaf
        idx = sharding(leaf.shape[0])
        if isinstance(leaf, torch.Tensor):
            return leaf[idx.to(leaf.device)]
        return np.asarray(leaf)[idx.numpy()]

    return take(batch)


def replicated(mesh: Mesh) -> int:
    """The rank every replica is copied from."""
    return 0


def replicate(mesh: Mesh, tensors) -> None:
    """Broadcast every tensor of ``tensors`` from rank 0, in place."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=replicated(mesh))


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; the gradient of each rank's input is the sum of the
    ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return _AllReduceSum.apply(x)


# the active row shard of a training forward: (global rows, this rank's rows)
_ROWS: list[tuple[int, torch.Tensor]] = []


def set_row_shard(total: int, rows: torch.Tensor) -> None:
    """Declare this rank's rows (of ``total``) for the draws of the step
    under way (``row_shard_scope``)."""
    if _ROWS:
        _ROWS[-1] = (total, rows)


@contextlib.contextmanager
def row_shard_scope():
    """Draws inside take this rank's rows of the global draw once
    ``set_row_shard`` has named them."""
    _ROWS.append((0, torch.empty(0, dtype=torch.long)))
    try:
        yield
    finally:
        _ROWS.pop()


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)``, or, under an active row shard, the draw the whole
    batch would have made, this rank's rows taken: a leading axis of k
    times this rank's rows is drawn at k times the global rows (k = 1 for
    a rank with none), row ``i * k + j`` of the draw belonging to row i."""
    shape = tuple(shape)
    if not _ROWS or _ROWS[-1][0] == 0:
        return draw(shape)
    total, rows = _ROWS[-1]
    local = len(rows)
    k = shape[0] // local if local else 1
    if shape[0] != k * local and local:
        return draw(shape)  # not a per-row draw
    u = draw((total * k,) + shape[1:])
    idx = (rows[:, None] * k + torch.arange(k)).reshape(-1)
    return u[idx.to(u.device)]
