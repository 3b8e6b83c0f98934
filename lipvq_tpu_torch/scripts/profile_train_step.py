"""Train-step profile: step time, FLOPs, bytes, MFU (counterpart of
``lipvq_tpu/scripts/profile_train_step.py``).

- ``--mode lowdim``: the low-dim template (GPT 6L / 512d / 8h over 3 x 10
  tokens, LipVQ 1024 codes), over a sweep of batch sizes;
- ``--mode image``: the image protocol (two 128 x 128 cameras through FiLM
  ResNet-18 cores with a 116 x 116 crop, 10 frames);
- ``--trace DIR``: a ``torch.profiler`` chrome trace of 5 steps at the
  first batch size;
- ``--ema_codebook``: the EMA codebook (kernel K2 in place of K1); the
  models are otherwise the JAX script's, key for key.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
train step (forward, backward and optimizer update): the products of
matmuls, convolutions and attention, plus the registered lookup ops
(``lipvq_tpu_torch::vq_nearest``: 2 B N D; ``vq_nearest_with_stats``: 2 B N D
+ B D). Elementwise work is not counted, whereas XLA's ``cost_analysis``,
which the JAX script reads, counts it: the two estimators differ, so this
MFU does not compare with the JAX package's. Bytes are each aten op's input
and output bytes summed over the step (views excluded), the counterpart of
XLA's ``bytes accessed``. Peaks are the H100 SXM data sheet's: 989.4 TFLOP/s
bf16 dense, 66.9 TFLOP/s fp32, 3.35 TB/s HBM3. The step time is the best of
``reps`` runs of ``iters`` steps after a warm-up step, each run bracketed by
``torch.cuda.synchronize``.

    python -m lipvq_tpu_torch.scripts.profile_train_step --mode lowdim
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

H100_BF16_DENSE_PEAK = 989.4e12  # H100 SXM, bf16 tensor cores, dense
H100_FP32_PEAK = 66.9e12  # H100 SXM, fp32 (non-tensor)
H100_HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
REPS = 3  # timed runs of ``iters`` steps; the best counts


def _icl_config(batch_size, compute_dtype, activation_dtype, remat, extra=None,
                ema_codebook=False):
    from lipvq_tpu_torch.config import config_factory

    cfg = {
        "train": {"batch_size": batch_size, "max_grad_norm": 100.0},
        "algo": {
            "gmm": {"enabled": True},
            "transformer": {
                "enabled": True, "supervise_all_steps": True,
                "pred_future_acs": True, "causal": False,
                "embed_dim": 512, "num_layers": 6, "num_heads": 8,
                "vq_vae_enabled": True, "ln_act_enabled": False,
                "compute_dtype": compute_dtype,
                "activation_dtype": activation_dtype,
                "remat": remat,
            },
            "vq": {"num_codes": 1024},
        },
    }
    if ema_codebook:
        cfg["algo"]["vq"]["ema_codebook"] = True
    cfg.update(extra or {})
    return config_factory("icl", cfg)


def make_lowdim_model(batch_size, compute_dtype="float32", activation_dtype="float32",
                      remat=False, device=None, ema_codebook=False):
    """The low-dim template's ICL GMM policy (JAX's configuration key for
    key) on ``device`` (CUDA when None)."""
    from lipvq_tpu_torch.algo import algo_factory

    obs_key_shapes = {
        "robot0_eef_pos": [3],
        "robot0_eef_quat": [4],
        "robot0_gripper_qpos": [2],
        "object": [14],
        "lang_emb": [768],
    }
    cfg = _icl_config(batch_size, compute_dtype, activation_dtype, remat,
                      ema_codebook=ema_codebook)
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(obs_key_shapes)
    model = algo_factory("icl", cfg, obs_key_shapes, ac_dim=12, device=device)
    return model, obs_key_shapes


def make_image_model(batch_size=16, img=128, compute_dtype="float32",
                     activation_dtype="float32", remat=False, device=None,
                     ema_codebook=False):
    """The image protocol's ICL GMM policy (JAX's configuration key for
    key) on ``device`` (CUDA when None)."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.utils import obs_utils as ObsUtils

    obs_key_shapes = {
        "robot0_eef_pos": [3],
        "robot0_eef_quat": [4],
        "robot0_gripper_qpos": [2],
        "lang_emb": [768],
        "robot0_agentview_left_image": [img, img, 3],
        "robot0_eye_in_hand_image": [img, img, 3],
    }
    cfg = _icl_config(batch_size, compute_dtype, activation_dtype, remat, extra={
        "train": {"batch_size": batch_size},
        "observation": {
            "modalities": {"obs": {
                "low_dim": ["robot0_eef_pos", "robot0_eef_quat",
                            "robot0_gripper_qpos", "lang_emb"],
                "rgb": ["robot0_agentview_left_image", "robot0_eye_in_hand_image"],
            }},
            "encoder": {"rgb": {
                "core_class": "VisualCoreLanguageConditioned",
                "core_kwargs": {"feature_dimension": 64, "pool_kwargs": {"num_kp": 32}},
                "obs_randomizer_class": "CropRandomizer",
                "obs_randomizer_kwargs": {"crop_height": 116, "crop_width": 116,
                                          "num_crops": 1},
            }},
        },
    }, ema_codebook=ema_codebook)
    ObsUtils.initialize_obs_utils_with_config(cfg)
    model = algo_factory("icl", cfg, obs_key_shapes, ac_dim=12, device=device)
    return model, obs_key_shapes


def device_batch(model, obs_key_shapes, batch_size):
    """A processed batch on the model's device: seeded normals (images:
    uniforms in [0, 1]) of the context window, actions * 0.3."""
    rng = np.random.default_rng(0)
    t = model.context_length
    obs = {}
    for k, s in obs_key_shapes.items():
        if len(s) == 3:  # a processed float frame, HWC
            obs[k] = rng.random((batch_size, t, *s), dtype=np.float32)
        else:
            obs[k] = rng.standard_normal((batch_size, t, *s)).astype(np.float32)
    actions = (rng.standard_normal((batch_size, t, 12)) * 0.3).astype(np.float32)
    batch = {"obs": obs, "actions": actions, "goal_obs": None}
    return model._put_batch(batch)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(model, batch, iters=30, reps=REPS) -> float:
    """Seconds per step: the best of ``reps`` runs of ``iters`` steps after a
    warm-up step, each run bracketed by a device synchronize."""
    model.train_on_batch(batch, epoch=1)
    _sync(model.device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            model.train_on_batch(batch, epoch=1)
        _sync(model.device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


class ByteCounter(TorchDispatchMode):
    """Sums every aten op's input and output tensor bytes (views, which move
    nothing, excluded): XLA's ``bytes accessed`` of the step."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def step_flops(model, batch) -> tuple[float, float]:
    """(FLOPs, bytes) of one train step (forward, backward and update). The
    step is taken: the model advances by one step."""
    flops, counter = FlopCounterMode(display=False), ByteCounter()
    with flops, counter:
        model.train_on_batch(batch, epoch=1)
    _sync(model.device)
    return float(flops.get_total_flops()), float(counter.bytes)


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them; the CPU's
    name otherwise."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def launch_counts() -> tuple[int, int, int]:
    """K1, K1f and K2 launches so far."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_with_stats_cuda

    return (vq_nearest_cuda.launches, vq_nearest_cuda.fast_launches,
            vq_nearest_with_stats_cuda.launches)


def profile_row(model, batch, args, b: int, device_label: str) -> dict:
    flops, nbytes = step_flops(model, batch)
    before = launch_counts()
    dt = measure(model, batch, iters=args.iters)
    steps = 1 + REPS * args.iters  # measure's warm-up step and timed runs
    launches = [(a - z) / steps for a, z in zip(launch_counts(), before)]
    tflops = flops / dt / 1e12
    return {
        "mode": args.mode,
        "dtype": args.dtype,
        "activations": args.activations,
        "remat": bool(args.remat),
        "ema_codebook": bool(args.ema_codebook),
        "batch": b,
        "step_ms": dt * 1e3,
        "samples_per_s": b / dt,
        "step_gflops": flops / 1e9,
        "achieved_tflops": tflops,
        "mfu_vs_h100_bf16_dense_peak": 100 * tflops * 1e12 / H100_BF16_DENSE_PEAK,
        "mfu_vs_h100_fp32_peak": 100 * tflops * 1e12 / H100_FP32_PEAK,
        # the HBM floor: when hbm_floor_ms ~= step_ms the step is bandwidth
        # bound and faster arithmetic cannot help
        "step_gbytes": nbytes / 1e9,
        "hbm_floor_ms": nbytes / H100_HBM_BYTES_PER_S * 1e3,
        "hbm_bw_util": 100 * nbytes / H100_HBM_BYTES_PER_S / dt,
        "launches_per_step": {"k1": launches[0], "k1f": launches[1], "k2": launches[2]},
        "device": device_label,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lowdim", "image"), default="lowdim")
    ap.add_argument("--batches", type=int, nargs="*", default=None)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="backbone compute dtype (the shipped template uses bfloat16)")
    ap.add_argument("--activations", choices=("float32", "bfloat16"), default="float32",
                    help="backbone residual-stream dtype")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the transformer blocks' activations in the backward")
    ap.add_argument("--trace", type=str, default=None)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--ema_codebook", action="store_true",
                    help="train the codebook by EMA statistics (kernel K2)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: CUDA; 'cpu' to profile on the CPU)")
    args = ap.parse_args(argv)

    from lipvq_tpu_torch.algo import resolve_device

    device = resolve_device(args.device)
    label = device_name(device)
    rows = []
    batches = args.batches or ([100, 200, 400, 800, 1600] if args.mode == "lowdim"
                               else [16, 32, 64])
    for b in batches:
        make = make_lowdim_model if args.mode == "lowdim" else make_image_model
        model, shapes = make(b, compute_dtype=args.dtype, activation_dtype=args.activations,
                             remat=args.remat, device=device, ema_codebook=args.ema_codebook)
        batch = device_batch(model, shapes, b)
        row = profile_row(model, batch, args, b, label)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.trace and b == batches[0]:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == "cuda" else [])
            with profile(activities=activities) as prof:
                for _ in range(5):
                    model.train_on_batch(batch, epoch=1)
                _sync(device)
            os.makedirs(args.trace, exist_ok=True)
            path = os.path.join(args.trace, f"train_step_{args.mode}_{b}.json")
            prof.export_chrome_trace(path)
            print(f"trace written to {path}", file=sys.stderr)
        del model, batch
    print(json.dumps({"profile": rows}))
    return rows


if __name__ == "__main__":
    main()
