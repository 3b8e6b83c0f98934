"""MCR — pretrained-representation conditioned BC (counterpart of
``lipvq_tpu/algo/mcr.py``; reference algo/mcr_main.py + algo/mcr/).

- ``MCREncoder``: the port's ``ResNet18Conv`` -> ``SpatialMeanPool`` ->
  ``TorchLinear(512, embed_dim)``; frames NHWC in [0, 1] at the API, a
  contiguous NCHW copy inside (as ``VisualCore`` hands its trunk).
- ``MCRPretrainer``: InfoNCE of each anchor against its positive among the
  batch's positives and far frames (temperature 0.1) plus ``bc_weight`` x
  the MSE of a 256-wide action head, one Adam over encoder and head; flax's
  train-mode BatchNorm statistics advance with each step.
- ``MCRTransformerGMM``: ``BCTransformerGMM`` whose visual cores' trunks
  (every module named ``backbone``) take the parameters of a pretrained
  trunk (``algo.mcr.pretrained_ckpt``) after construction, before the
  optimizer exists. As in the JAX package, only parameters are copied: the
  trunk's BatchNorm statistics stay as initialised.

Checkpoints are ``torch.save`` trees with the JAX package's layout, read
with ``weights_only=True``. A parameter tree nests by module path with the
port's leaf names (``{"backbone": {"stem_conv": {"weight": ...}}}``): the
workspace's snapshot (``scripts/train_mcr_representation.py``) is
``{"params": encoder tree, "extra": {"batch_stats": ...}, "global_step"}``,
the pretrainer's file ``{"params": {"encoder": ..., "head": ...},
"extra_vars": {"batch_stats": ...}}``. The graft reads ``params["backbone"]``,
so a pretrainer file grafts nothing and says nothing, as in the JAX package
(ROADMAP queue 3). ``algo.mcr.freeze_backbone`` is read by neither package.
``utils/jax_weights.py::mcr_checkpoint_from_msgpack`` converts a JAX file.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.algo.base import register_algo_factory_func, resolve_device
from lipvq_tpu_torch.algo.bc import BCTransformerGMM
from lipvq_tpu_torch.models.base_nets import TorchLinear, seeded_init
from lipvq_tpu_torch.models.obs_core import ResNet18Conv, ResNetConv, SpatialMeanPool


@register_algo_factory_func("mcr")
def algo_config_to_class(algo_config):
    return MCRTransformerGMM, {}


def nest(flat: Mapping[str, torch.Tensor]) -> dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}, tensors copied to the CPU."""
    out: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value.detach().to("cpu", copy=True)
    return out


def flatten(tree: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """The inverse of ``nest``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_tree_(module: nn.Module, params: Mapping, buffers: Mapping | None = None) -> None:
    """Copy a nested parameter tree (and buffer tree) into ``module``; the
    names must match its parameters (buffers) exactly."""
    state = flatten(params)
    own = dict(module.named_parameters())
    if buffers is not None:
        state.update(flatten(buffers))
        own.update(module.named_buffers())
    if set(state) != set(own):
        raise KeyError(f"the tree lacks {sorted(set(own) - set(state))} and has "
                       f"{sorted(set(state) - set(own))} beyond the module's")
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(state[k])


class MCREncoder(nn.Module):
    """ResNet18 trunk (``backbone``) + mean pool (``pool``) + projection
    (``proj``): frames [B, H, W, C] in [0, 1] -> [B, embed_dim]."""

    def __init__(self, embed_dim: int = 128, in_channels: int = 3):
        super().__init__()
        self.backbone = ResNet18Conv(in_channels)
        self.pool = SpatialMeanPool()
        self.proj = TorchLinear(self.backbone.out_channels, embed_dim)

    def forward(self, imgs, train: bool = False):
        h = self.backbone(imgs.permute(0, 3, 1, 2).contiguous(), train)
        return self.proj(self.pool(h, train))


class _Head(nn.Module):
    """The pretrainer's action head: ``h1`` (256) -> ReLU -> ``out``."""

    def __init__(self, embed_dim: int, action_dim: int):
        super().__init__()
        self.h1 = TorchLinear(embed_dim, 256)
        self.out = TorchLinear(256, action_dim)

    def forward(self, z):
        return self.out(F.relu(self.h1(z)))


class MCRPretrainer:
    """Time-contrastive + BC-alignment representation pretraining.

    Batch contract: frames [B, 3, H, W, C] (anchor, positive = a temporally
    close frame, negative = a far frame) and the anchor's action [B, A].
    Loss = InfoNCE(anchor, positive against the batch's other positives and
    the far frames) + bc_weight * MSE(head(anchor), action). The encoder and
    head are ``nets.encoder`` and ``nets.head`` on ``device`` (CUDA when
    None), initialized from ``seed`` on the CPU."""

    def __init__(self, embed_dim: int = 128, action_dim: int = 12,
                 lr: float = 1e-4, temperature: float = 0.1,
                 bc_weight: float = 1.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.temperature = temperature
        self.bc_weight = bc_weight
        self.action_dim = action_dim
        self.nets = nn.ModuleDict({"encoder": MCREncoder(embed_dim),
                                   "head": _Head(embed_dim, action_dim)})
        seeded_init(self.nets, torch.Generator().manual_seed(seed))
        self.nets.to(self.device)
        self.optimizer = torch.optim.Adam(self.nets.parameters(), lr=lr, eps=1e-8)

    def _loss(self, frames, actions):
        b = frames.shape[0]
        z = self.nets.encoder(frames.reshape((b * 3,) + frames.shape[2:]), train=True)
        z = z.reshape(b, 3, -1)
        z = z / torch.clamp_min(torch.linalg.vector_norm(z, dim=-1, keepdim=True), 1e-8)
        anchor, pos = z[:, 0], z[:, 1]
        cands = torch.cat([pos, z[:, 2]], dim=0)  # [2B, D]
        logits = anchor @ cands.T / self.temperature  # [B, 2B]
        labels = torch.arange(b, device=frames.device)
        nce = -torch.mean(torch.log_softmax(logits, dim=-1)[labels, labels])
        bc = torch.mean((self.nets.head(anchor) - actions) ** 2)
        return nce + self.bc_weight * bc, {"nce_loss": nce, "bc_loss": bc}

    def train_step(self, frames: np.ndarray, actions: np.ndarray) -> dict:
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        loss, metrics = self._loss(frames, actions)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return {k: float(v.detach()) for k, v in {"loss": loss, **metrics}.items()}

    def save(self, path: str):
        """The JAX layout: the trunk sits under ``params/encoder/backbone``."""
        enc, head = self.nets.encoder, self.nets.head
        torch.save({"params": {"encoder": nest(dict(enc.named_parameters())),
                               "head": nest(dict(head.named_parameters()))},
                    "extra_vars": {"batch_stats": nest(dict(enc.named_buffers()))}}, path)

    def load(self, path: str):
        blob = torch.load(path, map_location="cpu", weights_only=True)
        load_tree_(self.nets.encoder, blob["params"]["encoder"],
                   blob["extra_vars"]["batch_stats"])
        load_tree_(self.nets.head, blob["params"]["head"])


class MCRTransformerGMM(BCTransformerGMM):
    """Transformer GMM BC with an MCR-pretrained visual trunk (reference
    MCR_Transformer_GMM): with ``algo.mcr.pretrained_ckpt`` set, every
    visual core's trunk takes the checkpoint's ``params["backbone"]``."""

    def _create_networks(self):
        super()._create_networks()
        ckpt = self.algo_config.get("mcr", {}).get("pretrained_ckpt", None)
        if ckpt:
            snap = torch.load(ckpt, map_location="cpu", weights_only=True)
            backbone = snap["params"].get("backbone")
            if backbone is not None:
                self._graft_backbone(backbone)

    def _graft_backbone(self, backbone_params: Mapping) -> list[str]:
        """Copy the trunk's parameters into every module named ``backbone``
        (the outermost one of a path); returns their names."""
        grafted = []
        for name, module in self.nets.named_modules():
            if name.split(".")[-1] != "backbone" or any(
                    name.startswith(g + ".") for g in grafted):
                continue
            if not isinstance(module, ResNetConv):
                raise TypeError(f"{name} is a {type(module).__name__}, not a ResNet trunk")
            load_tree_(module, backbone_params)
            grafted.append(name)
        return grafted
