"""Export a trained ICL policy's served forward as a self-contained program
(counterpart of ``lipvq_tpu/scripts/export_policy.py``).

``torch.export`` traces the counterpart of the JAX ``serve_fn``,
``_get_action_impl``, at a fixed batch and ``torch.export.save`` writes it
with the parameters inside. Reloading needs ``torch`` and the registration
of the lookup ops (``import lipvq_tpu_torch.ops.vq_lookup``), not the
network's Python code: the nearest-code lookup stays one node of the graph,
``lipvq_tpu_torch::vq_nearest`` (kernel K1 on the card, its plain version on
the CPU).

A ``torch.Generator`` cannot be an input of an exported program, so the
program takes the sampler's draws instead of the JAX key: the Gumbel
uniforms ``u`` and the standard normals ``eps`` that ``gmm_sample`` would
draw. ``load_and_run`` draws them from the algo's sample generator, so the
reloaded program gives ``get_action``'s actions at the same generator state.
FAST's host features stay outside, as JAX does not export FAST either.

    python -m lipvq_tpu_torch.scripts.export_policy --ckpt model.ckpt \
        --output policy.pt2 [--batch 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from lipvq_tpu_torch.models.distributions import GMMParams

LOOKUP_OP = "lipvq_tpu_torch.vq_nearest.default"  # K1's node in the graph


class ServedPolicy(torch.nn.Module):
    """``model._get_action_impl`` on given draws, as a module whose state is
    the algo's nets."""

    def __init__(self, model):
        super().__init__()
        self.nets = model.nets
        self._impl = model._get_action_impl

    def forward(self, obs, ctx_obs, ctx_act, u, eps):
        return self._impl(obs, ctx_obs, ctx_act, None, draws=(u, eps))


def serving_inputs(model, batch: int) -> tuple[dict, dict, torch.Tensor]:
    """(obs, context obs, context actions) of zeros at ``batch``, as the
    JAX export traces with; no two are one tensor (export would trace them
    as one input)."""
    t = getattr(model, "context_length", 10)
    obs, ctx_obs = ({k: torch.zeros((batch, t) + tuple(s), device=model.device)
                     for k, s in model.obs_shapes.items()} for _ in range(2))
    return obs, ctx_obs, torch.zeros((batch, t, model.ac_dim), device=model.device)


def draw_like(model, u_like: torch.Tensor, eps_like: torch.Tensor):
    """Draws of ``u_like``'s and ``eps_like``'s shapes and dtypes from the
    algo's sample generator, in ``gmm_draws``' order."""
    g = model._generator
    return (torch.rand(u_like.shape, generator=g, device=model.device, dtype=u_like.dtype),
            torch.randn(eps_like.shape, generator=g, device=model.device,
                        dtype=eps_like.dtype))


def export_model(model, batch: int = 1) -> torch.export.ExportedProgram:
    """The exported served forward of ``model`` at ``batch``."""
    obs, ctx_obs, ctx_act = serving_inputs(model, batch)
    with torch.no_grad():
        dists, _ = model.nets.forward_train(obs, ctx_obs, ctx_act, low_noise_eval=True)
    if isinstance(dists, GMMParams):
        u = torch.zeros_like(dists.logits, dtype=torch.float32)
        eps = torch.zeros(dists.means.shape[:-2] + dists.means.shape[-1:],
                          dtype=dists.means.dtype, device=model.device)
    else:  # the deterministic head draws nothing
        u = eps = torch.zeros((batch, 0), device=model.device)
    program = torch.export.export(ServedPolicy(model), (obs, ctx_obs, ctx_act, u, eps),
                                  strict=False)
    if not any(str(n.target) == LOOKUP_OP for n in program.graph.nodes) and getattr(
            model, "vq_vae_enabled", False):
        raise RuntimeError(f"the exported graph holds no {LOOKUP_OP} node")
    return program


def export_policy(ckpt_path: str, output_path: str, batch: int = 1, device=None) -> str:
    """Export the checkpoint's policy (on ``device``, CUDA when None) at
    ``batch`` to ``output_path``."""
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint

    model, _ = policy_from_checkpoint(ckpt_path, device=device)
    torch.export.save(export_model(model, batch), output_path)
    print(f"exported {os.path.getsize(output_path)} bytes to {output_path}")
    return output_path


def user_inputs(program: torch.export.ExportedProgram) -> list:
    """The fake tensors of the program's user inputs, in order (the leaves
    of obs, ctx_obs, ctx_act, u, eps)."""
    names = set(program.graph_signature.user_inputs)
    return [n.meta["val"] for n in program.graph.nodes
            if n.op == "placeholder" and n.name in names]


def load_and_run(path: str, model, obs=None, ctx_obs=None, ctx_act=None):
    """Reload an exported policy and run it (the round trip): on zeros at
    the program's batch unless inputs are given, with draws from the algo's
    sample generator."""
    program = torch.export.load(path)
    *_, u_like, eps_like = user_inputs(program)
    if obs is None:
        obs, ctx_obs, ctx_act = serving_inputs(model, u_like.shape[0])
    with torch.no_grad():
        return program.module()(obs, ctx_obs, ctx_act, *draw_like(model, u_like, eps_like))


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA; 'cpu' to export for the CPU)")
    ns = parser.parse_args(args)
    return export_policy(ns.ckpt, ns.output, batch=ns.batch, device=ns.device)


if __name__ == "__main__":
    main()
