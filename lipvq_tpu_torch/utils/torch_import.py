"""Import the reference PyTorch checkpoints into the port's modules
(counterpart of ``lipvq_tpu/utils/torch_import.py``).

Each function maps a reference ``state_dict`` ({key: numpy array}: use
``{k: v.numpy() for k, v in torch.load(...).items()}``) straight onto a
``state_dict`` of the port's module, as fp32 tensors:

- ``LLFQVAE_V4`` (reference vq_vae/backbone_lfqvae_v5.py: encoder.{0,2},
  to_latent.{W,b,ci}, quantizer.codebook, decoder.{0,2}, to_output) ->
  ``LipVQVAE``
- ``VQVAE`` (vq_vae/backbone.py: encoder.{0,2,4}, decoder.{0,2,4},
  embedding.weight) -> ``VQVAE``; ``LFQVAE`` (vq_vae/backbone_lfqvae.py) ->
  ``LFQVAE``
- ``AdaptiveBinActionEmbedding`` (bin_action/backbone.py) -> its parameters
  and its bin statistics (``running_min``, ``running_max``, ``num_step`` 0)
- the low-dim ICL GMM policy (policy_nets.py:2375 over
  ICL_MIMO_Transformer) -> ``ICLGMMActorNetwork.net``
- a torchvision-layout ResNet-18 trunk -> ``ResNet18Conv``'s parameters and
  BatchNorm buffers
- ``GPT_Backbone`` (transformers.py) -> ``GPTBackbone``

The port keeps torch's layouts (a Linear's weight [out, in], a Conv2d's
[out, in, kh, kw]), so every tensor is copied as it is and only renamed.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr), dtype=np.float32))


def _lin(sd, src: str, dst: str) -> dict[str, torch.Tensor]:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]), f"{dst}.bias": _t(sd[f"{src}.bias"])}


def _renamed(sd, pairs) -> dict[str, torch.Tensor]:
    out = {}
    for src, dst in pairs:
        out.update(_lin(sd, src, dst))
    return out


def import_lipvq_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """LLFQVAE_V4 state_dict -> ``LipVQVAE`` state_dict."""
    out = _renamed(sd, (("encoder.0", "enc1"), ("encoder.2", "enc2"), ("decoder.0", "dec1"),
                        ("decoder.2", "dec2"), ("to_output", "to_output")))
    for leaf in ("W", "b", "ci"):
        out[f"to_latent.{leaf}"] = _t(sd[f"to_latent.{leaf}"])
    out["quantizer.codebook"] = _t(sd["quantizer.codebook"])
    return out


_VAE_LAYERS = tuple((f"{part}coder.{2 * i}", f"{part}c_{i}")
                    for part in ("en", "de") for i in range(3))


def import_vqvae_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """VQVAE state_dict -> ``VQVAE`` state_dict."""
    return {**_renamed(sd, _VAE_LAYERS), "embedding": _t(sd["embedding.weight"])}


def import_lfqvae_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """LFQVAE state_dict -> ``LFQVAE`` state_dict."""
    return _renamed(sd, _VAE_LAYERS)


def import_bin_state_dict(sd: dict, action_dim: int):
    """AdaptiveBinActionEmbedding state_dict -> (parameters, bin statistics)
    of ``AdaptiveBinActionEmbedding``."""
    tables = np.stack([np.asarray(sd[f"embedding_layers.{i}.weight"])
                       for i in range(action_dim)], axis=0)
    params = {"embedding_tables": _t(tables),
              **_renamed(sd, (("output_layer.0", "out1"), ("output_layer.2", "out2")))}
    stats = {"running_min": _t(sd["running_min"]), "running_max": _t(sd["running_max"]),
             "num_step": torch.tensor(0, dtype=torch.int32)}
    return params, stats


def _ln(sd, src: str, dst: str) -> dict[str, torch.Tensor]:
    return {f"{dst}.weight": _t(sd[f"{src}.weight"]), f"{dst}.bias": _t(sd[f"{src}.bias"])}


def import_gpt_backbone_state_dict(sd: dict, num_layers: int,
                                   prefix: str = "nets.transformer.") -> dict[str, torch.Tensor]:
    """GPT_Backbone state_dict (nets.transformer.{i}.nets.{attention.nets.
    {qkv,output},ln1,ln2,mlp.{0,2}} + nets.output_ln) -> ``GPTBackbone``
    state_dict."""
    out = {}
    for i in range(num_layers):
        b, o = f"{prefix}{i}.nets.", f"block_{i}."
        out[f"{o}attention.qkv.weight"] = _t(sd[f"{b}attention.nets.qkv.weight"])
        out.update(_lin(sd, f"{b}attention.nets.output", f"{o}attention.output"))
        out.update(_ln(sd, f"{b}ln1", f"{o}ln1"))
        out.update(_ln(sd, f"{b}ln2", f"{o}ln2"))
        out.update(_lin(sd, f"{b}mlp.0", f"{o}mlp_fc"))
        out.update(_lin(sd, f"{b}mlp.2", f"{o}mlp_proj"))
    out.update(_ln(sd, "nets.output_ln", "output_ln"))
    return out


def _sub(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def import_icl_policy_state_dict(sd: dict, num_layers: int) -> dict[str, torch.Tensor]:
    """Reference ICLTransformerGMMActorNetwork state_dict (low-dim + LipVQ;
    nets.encoder.action_network.*, nets.embed_encoder, params.embed_timestep,
    nets.embed_ln, nets.transformer.*, nets.decoder.nets.{mean,scale,logits})
    -> the state_dict of ``ICLGMMActorNetwork.net`` (the algo's
    ``nets.net``). ``embed_timestep`` comes along where the reference holds
    it."""
    out = {f"encoder.action_network.{k}": v for k, v in import_lipvq_state_dict(
        _sub(sd, "nets.encoder.action_network.")).items()}
    out.update(_lin(sd, "nets.embed_encoder", "embed_encoder"))
    out.update(_ln(sd, "nets.embed_ln", "embed_ln"))
    out.update({f"transformer.{k}": v for k, v in import_gpt_backbone_state_dict(
        _sub(sd, "nets.transformer."), num_layers).items()})
    for head in ("mean", "scale", "logits"):
        out.update(_lin(sd, f"nets.decoder.nets.{head}", f"decoder.head_{head}"))
    if "params.embed_timestep" in sd:
        out["embed_timestep"] = _t(sd["params.embed_timestep"])
    return out


def _bn(sd, src: str, dst: str):
    params = _ln(sd, src, dst)
    stats = {f"{dst}.mean": _t(sd[f"{src}.running_mean"]),
             f"{dst}.var": _t(sd[f"{src}.running_var"])}
    return params, stats


def import_resnet18_state_dict(sd: dict, prefix: str = ""):
    """torchvision-layout ResNet-18 state_dict (conv1, bn1,
    layer{1..4}.{0,1}.conv{1,2}/bn{1,2}, .downsample.{0,1} on stage-entry
    blocks; fc.* ignored) -> (parameters, BatchNorm buffers) of
    ``ResNet18Conv``. ``prefix`` is stripped first (R3M's
    ``module.convnet.``, MVP's ``backbone.``)."""
    if prefix:
        sd = _sub(sd, prefix)
    params = {"stem_conv.weight": _t(sd["conv1.weight"])}
    p, stats = _bn(sd, "bn1", "stem_bn")
    params.update(p)
    for stage in range(1, 5):
        for block in range(2):
            src, dst = f"layer{stage}.{block}", f"layer{stage}_{block}"
            pairs = [("conv1", "bn1", "conv1", "bn1"), ("conv2", "bn2", "conv2", "bn2")]
            if f"{src}.downsample.0.weight" in sd:
                pairs.append(("downsample.0", "downsample.1", "downsample_conv", "downsample_bn"))
            for conv, bn, dconv, dbn in pairs:
                params[f"{dst}.{dconv}.weight"] = _t(sd[f"{src}.{conv}.weight"])
                p, s = _bn(sd, f"{src}.{bn}", f"{dst}.{dbn}")
                params.update(p)
                stats.update(s)
    return params, stats
