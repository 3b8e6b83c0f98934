"""Convert a reference PyTorch checkpoint into the port's format (counterpart
of ``lipvq_tpu/scripts/import_torch_ckpt.py``).

Reference ``torch.save`` payloads ({model: state_dict, config, ...},
train_utils.py:1216-1234) convert into the port's state_dicts: the LipVQ-VAE
tokenizer alone (``LipVQVAE``) or the full low-dim ICL GMM policy
(``ICLGMMActorNetwork.net``). The output is ``torch.save`` of
``{"params": state_dict}`` (plus ``"batch_stats"`` for a ResNet-18 trunk),
readable with ``weights_only=True``.

    python -m lipvq_tpu_torch.scripts.import_torch_ckpt --torch_ckpt model.pth \
        --output params.pt [--component lipvq|icl_policy]

As in the JAX package, ``--component`` offers only ``lipvq`` and
``icl_policy``; ``convert`` also takes ``resnet18`` (torchvision, R3M and
MVP trunks), which ``save_converted`` writes for
``PretrainedReprConv.load_pretrained``.
"""

from __future__ import annotations

import argparse

import torch


def load_torch_state_dict(path: str, model_key: str = "model") -> dict:
    """The reference payload's state_dict as numpy arrays. The payload holds
    its config and other Python objects beside the tensors, so it is read
    with ``weights_only=False``: load only files you trust."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd = payload[model_key] if isinstance(payload, dict) and model_key in payload else payload
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() for k, v in sd.items()}


def convert(sd: dict, component: str, num_layers: int = 6) -> dict:
    """The port's state_dict of ``component``; for ``resnet18``
    ``{"params": ..., "batch_stats": ...}``."""
    from lipvq_tpu_torch.utils import torch_import as TI

    if component == "lipvq":
        # bare LLFQVAE_V4 keys or the nested policy path
        prefix = "nets.policy.nets.encoder.action_network."
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        return TI.import_lipvq_state_dict(sd)
    if component == "icl_policy":
        prefix = "nets.policy."
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
        return TI.import_icl_policy_state_dict(sd, num_layers=num_layers)
    if component == "resnet18":
        # torchvision / R3M ("module.convnet.") / MVP trunk layouts
        for prefix in ("module.convnet.", "convnet.", "backbone.", ""):
            if any(k.startswith(prefix + "conv1.") for k in sd):
                params, stats = TI.import_resnet18_state_dict(sd, prefix)
                return {"params": params, "batch_stats": stats}
        raise ValueError("no torchvision-layout resnet18 keys found")
    raise ValueError(component)


def save_converted(converted: dict, path: str) -> int:
    """``torch.save`` a ``convert`` result as ``{"params": ...}`` (a
    resnet18 result as it is); returns the number of parameters."""
    if "params" not in converted:
        converted = {"params": converted}
    torch.save(converted, path)
    return sum(v.numel() for v in converted["params"].values())


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--torch_ckpt", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--component", type=str, default="lipvq",
                        choices=["lipvq", "icl_policy"])
    parser.add_argument("--num_layers", type=int, default=6)
    ns = parser.parse_args(args)

    sd = load_torch_state_dict(ns.torch_ckpt)
    n = save_converted(convert(sd, ns.component, num_layers=ns.num_layers), ns.output)
    print(f"wrote {ns.output} ({n} parameters)")
    return ns.output


if __name__ == "__main__":
    main()
