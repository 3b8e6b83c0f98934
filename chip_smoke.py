#!/usr/bin/env python3
"""Run the PyTorch port's served path on one NVIDIA GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and nvcc, and
builds every kernel from the sources in the checkout. Phases:

1. Set-up: torch version, the card's name and power limit, the kernel build.
2. Kernels: each kernel against its plain version on the card (TF32 off):
   exact ids on the fixtures of tests/test_vq_lookup.py; at the served
   request's shape and the corpus shape, ids may differ only where the two
   chosen codes' fp64 distances differ by <= 1e-5 * max(1, d). Times per
   call are CUDA-event medians; device times come from torch.profiler.
3. Slice: the flagship ICLTransformerGMM at full width (6 layers x 512 x 8
   heads, 30 tokens, 1024 x 791 codebook, bf16 compute) behind
   ICLRolloutPolicy answers 5 requests for 16 envs and 3 single-env
   requests; every request must launch K1 once. The same weights in fp32 on
   the card and on the CPU must agree.
4. Output: a ``kernels`` JSON line, the card line, and last the result line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

OBS_SHAPES = {
    "robot0_eef_pos": [3],
    "robot0_eef_quat": [4],
    "robot0_gripper_qpos": [2],
    "object": [14],
    "lang_emb": [768],
}
AC_DIM = 12
N_ENVS = 16
SLICE_SHAPE = (160, 1024, 791)  # 16 envs x 10 context steps, codes, latent
CORPUS_SHAPE = (1 << 20, 1024, 208)  # bench.py's corpus tokenization shape


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(fn, reps: int) -> tuple[float | None, dict]:
    """Device time per call of ``fn`` under torch.profiler (CUDA activity
    only): (busy ms, {kernel name: ms}), busy being the union of the
    kernels' and copies' intervals. (None, {}) where the profiler recorded
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None, {}
    busy, (start, end) = 0.0, spans[0][:2]
    by_name: dict[str, float] = {}
    for s, e, name in spans:
        name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = name.split("(")[0].split("<")[0]
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3 / reps
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    busy += end - start
    return busy / 1e3 / reps, by_name


def vq_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """Least time (ms) for the lookup: fp32 operations 2*B*N*D for the dot
    products + 2*N*D for ||c||^2, against z and c read once and the ids
    written once."""
    ops_ms = (2 * b * n * d + 2 * n * d) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 4 * (b * d + n * d + b) / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def check_ids(z, c, got, want) -> tuple[int, float]:
    """Ids may differ only where the chosen codes' fp64 distances differ by
    <= 1e-5 * max(1, d). Returns (differing rows, largest distance gap)."""
    bad = (got != want).nonzero().flatten()
    if bad.numel() == 0:
        return 0, 0.0
    zb = z[bad].double()
    d_got = ((zb - c[got[bad].long()].double()) ** 2).sum(1)
    d_want = ((zb - c[want[bad].long()].double()) ** 2).sum(1)
    gap = (d_got - d_want).abs()
    allowed = 1e-5 * torch.clamp(torch.minimum(d_got, d_want), min=1.0)
    if (gap > allowed).any():
        raise AssertionError(f"K1 ids differ beyond the tie tolerance on "
                             f"{int((gap > allowed).sum())} rows")
    return bad.numel(), float(gap.max())


def kernel_phase(card: str) -> dict:
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_nearest_cuda,
        vq_nearest_reference,
    )

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    dev = torch.device("cuda")

    # fixtures of tests/test_vq_lookup.py: ids exactly equal
    fixtures = []
    for b, n, d in [(80, 128, 12), (300, 1024, 208), (512, 256, 64)]:
        rng = np.random.default_rng(0)
        z = rng.standard_normal((b, d), dtype=np.float32)
        fixtures.append((f"gauss{b}x{n}x{d}", z, rng.standard_normal((n, d), dtype=np.float32)))
    rng = np.random.default_rng(0)
    z = torch.sigmoid(torch.from_numpy(10.0 * rng.standard_normal((400, 32)).astype(np.float32)))
    c = torch.sigmoid(torch.from_numpy(10.0 * rng.standard_normal((256, 32)).astype(np.float32)))
    fixtures.append(("sigmoid400x256x32", z.numpy(), c.numpy()))
    fixtures.append(("ties", np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32),
                     np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32)))
    for name, z, c in fixtures:
        zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
        got = vq_nearest_cuda(zt, ct)
        want = vq_nearest_reference(zt, ct)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1 ids differ from the plain version on {name}")
        if name == "ties" and got.tolist() != [1, 3]:
            raise AssertionError(f"K1 tie rule: got {got.tolist()}, want [1, 3]")
    print(f"K1 fixtures: ids exactly equal to the plain version on {len(fixtures)} fixtures")

    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for label, (b, n, d), reps, plain_reps in (("slice", SLICE_SHAPE, 50, 10),
                                               ("corpus", CORPUS_SHAPE, 10, 3)):
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        got = vq_nearest_cuda(z, c)
        want = vq_nearest_reference(z, c)
        mismatches, max_gap = check_ids(z, c, got, want)
        ms = cuda_ms(lambda: vq_nearest_cuda(z, c), reps)
        plain_ms = cuda_ms(lambda: vq_nearest_reference(z, c), plain_reps)
        library_ms = cuda_ms(
            lambda: torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1), reps)
        device_ms, kernels = profile_device(lambda: vq_nearest_cuda(z, c), reps)
        bound_ms, bound_by = vq_bound(b, n, d)
        results[label] = {"shape": [b, n, d], "mismatches": mismatches,
                          "max_abs_err": max_gap, "ms": ms, "device_ms": device_ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 {label} {b}x{n}x{d}: {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); K1 {ms:.4f} ms per call "
              f"(device busy {device_ms} ms: {kernels}), plain {plain_ms:.4f} ms, "
              f"addmm+argmin {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]")
        del z, c, got, want
    torch.cuda.empty_cache()
    return results


def icl_config(compute_dtype: str = "bfloat16"):
    """The paper's template widths with the flagship switches."""
    from lipvq_tpu_torch.config import config_factory

    cfg = config_factory("icl", {
        "algo": {
            "gmm": {"enabled": True, "num_modes": 5},
            "transformer": {
                "enabled": True, "context_length": 10, "embed_dim": 512,
                "num_layers": 6, "num_heads": 8, "causal": False,
                "supervise_all_steps": True, "pred_future_acs": True,
                "vq_vae_enabled": True, "ln_act_enabled": False,
                "compute_dtype": compute_dtype,
            },
            "vq": {"num_codes": 1024, "hidden_dim": 128},
        },
    })
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = list(OBS_SHAPES)
    return cfg


def random_obs(rng, lead) -> dict:
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32)
            for k, s in OBS_SHAPES.items()}


def slice_phase(card: str) -> dict:
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda

    algo = algo_factory("icl", icl_config(), OBS_SHAPES, ac_dim=AC_DIM)  # CUDA by default
    algo32 = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM)
    algo_cpu = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM,
                            device="cpu")
    net = algo.nets.net
    assert algo.device.type == "cuda"
    assert net.encoder.action_network.quantizer.codebook.shape == (1024, 791)
    assert net.transformer.block_0.mlp_fc.compute_dtype == torch.bfloat16
    assert net.transformer.num_layers == 6 and net.embed_dim == 512

    rng = np.random.default_rng(0)
    t = algo.context_length
    context = {"obs": random_obs(rng, (1, t)),
               "actions": rng.uniform(-1, 1, (1, t, AC_DIM)).astype(np.float32)}
    # the codebook of a random init sends every latent to one code: set it to
    # the latents of seeded actions, with the context's own latents among them
    tok_cpu = algo_cpu.nets.net.encoder.action_network
    with torch.no_grad():
        codebook = tok_cpu.encode(torch.from_numpy(
            rng.uniform(-1, 1, (1024, AC_DIM)).astype(np.float32)))
        codebook[torch.from_numpy(rng.permutation(1024)[:t])] = tok_cpu.encode(
            torch.from_numpy(context["actions"][0]))
        for a in (algo, algo32, algo_cpu):
            a.nets.net.encoder.action_network.quantizer.codebook.copy_(codebook)

    batched_obs = [random_obs(rng, (N_ENVS, t)) for _ in range(5)]
    single_obs = [random_obs(rng, (t,)) for _ in range(3)]
    policy = ICLRolloutPolicy(algo)

    # the main path: 5 batched + 3 single-env requests, counted
    vq_nearest_cuda.launches = 0
    batched = [policy.batched(o, context) for o in batched_obs]
    single = [policy(o, context) for o in single_obs]
    launches = vq_nearest_cuda.launches
    requests = len(batched) + len(single)
    if launches != requests:
        raise AssertionError(f"K1 launched {launches} times for {requests} requests")
    for a in batched:
        assert a.shape == (N_ENVS, AC_DIM) and np.isfinite(a).all(), a.shape
    for a in single:
        assert a.shape == (AC_DIM,) and np.isfinite(a).all(), a.shape
    print(f"slice: {requests} requests served, K1 launched {launches} times")

    # the last batched request again, in bf16 and fp32 on the card and fp32
    # on the CPU
    ctx = {"obs": {k: np.repeat(v, N_ENVS, 0) for k, v in context["obs"].items()},
           "actions": np.repeat(context["actions"], N_ENVS, 0)}
    outs = {}
    with torch.inference_mode():
        for name, a in (("bf16", algo), ("fp32", algo32), ("cpu", algo_cpu)):
            obs, ctx_obs, ctx_act = (a._put_infer(x) for x in (batched_obs[-1], ctx["obs"],
                                                               ctx["actions"]))
            d, _ = a.nets.forward_train(obs, ctx_obs, ctx_act, low_noise_eval=False)
            ids = a.nets.net.encoder.action_network.tokenize(ctx_act.reshape(-1, AC_DIM))
            outs[name] = ([x.float().cpu().numpy() for x in d], ids.cpu().numpy())
    # low-noise eval samples one of its row's mode means (sigma 1e-4)
    gap = np.abs(batched[-1][:, None, :] - outs["bf16"][0][0][:, 0]).max(-1).min(-1).max()
    assert gap <= 1e-3, f"a served action lies {gap} from every mode mean"
    for field, got, want in zip(("means", "scales", "logits"), outs["fp32"][0], outs["cpu"][0]):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4, err_msg=field)
    np.testing.assert_array_equal(outs["fp32"][1], outs["cpu"][1])
    distinct = len(np.unique(outs["cpu"][1]))
    assert distinct >= 8, f"only {distinct} distinct context codes"
    bf16_err = float(np.abs(outs["bf16"][0][0] - outs["cpu"][0][0]).max())
    print(f"slice: fp32 card == CPU within rtol 1e-3 / atol 1e-4; VQ ids equal "
          f"({distinct} distinct codes); bf16 card means within {bf16_err:.3g} of fp32 CPU")

    def host_ms(fn, reps=20):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()  # returns numpy: the device work is done
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    batched_ms = host_ms(lambda: policy.batched(batched_obs[0], context))
    single_ms = host_ms(lambda: policy(single_obs[0], context))
    busy_ms, kernels = profile_device(lambda: policy.batched(batched_obs[0], context), 10)
    idle = None if busy_ms is None else 1.0 - busy_ms / batched_ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"slice latency: {batched_ms:.3f} ms per {N_ENVS}-env request, "
          f"{single_ms:.3f} ms per single-env request (median of 20); device "
          f"busy {busy_ms} ms per {N_ENVS}-env request, idle share {idle}; "
          f"{len(kernels)} distinct device ops, top {top} [{card}]")
    return {"launches": launches, "batched_request_ms": batched_ms,
            "single_request_ms": single_ms, "device_busy_ms": busy_ms,
            "idle_share": idle}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from lipvq_tpu_torch.ops import _build

    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"card: {card}")
    t0 = time.perf_counter()
    logs = _build.build(["vq_nearest"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    k1 = kernel_phase(card)
    served = slice_phase(card)

    main_shape = k1["slice"]
    print(json.dumps({"kernels": [{
        "name": "vq_nearest (K1)",
        "route": "cuda",
        "implementation": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_nearest.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:68",
        "launches": served["launches"],
        "fixtures_exact": True,
        **{k: main_shape[k] for k in ("shape", "mismatches", "max_abs_err", "ms", "device_ms",
                                      "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "corpus": k1["corpus"],
        "card": card,
    }], "slice": served}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
