#!/usr/bin/env python3
"""Run the PyTorch port's served and training paths on one NVIDIA GPU and
hold its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and nvcc, and
builds every kernel from the sources in the checkout (one nvcc per source,
all started together). Phases:

1. Set-up: torch version, the card's name and power limit, the kernel build.
2. Kernels: each kernel against its plain version on the card (TF32 off).
   K1: exact ids on the fixtures of tests/test_vq_lookup.py; at the served
   request's, the train step's and the corpus shape, ids may differ only
   where the two chosen codes' fp64 distances differ by <= 1e-5 * max(1, d).
   K2: on its fixtures ids and counts exactly equal, sums within rtol 1e-5 /
   atol 1e-5; at the train step's and the corpus shape ids within K1's tie
   tolerance, counts exactly equal to the plain stats of K2's own ids, sums
   within 1e-5 + 1e-5 |s| + 4 n u S (n the code's count, u = 2^-24, S the
   sum of the rows' magnitudes: the recursive-summation bound of both
   sides). A skewed K2 case at the corpus shape puts every row on one code
   (code 0 is the mean of z, the others lie far away): counts exact, the
   sums within the same bound and equal, bit for bit, to a sequential
   ascending fp32 sum (numpy's cumsum), two calls bit-identical. Times per
   call are CUDA-event medians; device times come from torch.profiler, per
   kernel and, for K2, per stage (cn, lookup, sort, sums); K1's wrapper
   host time is the median time from entry to return on an idle card.
3. Serve: the flagship ICLTransformerGMM at full width (6 layers x 512 x 8
   heads, 30 tokens, 1024 x 791 codebook, bf16 compute) behind
   ICLRolloutPolicy answers 5 requests for 16 envs and 3 single-env
   requests; every request must launch K1 once. The same weights in fp32 on
   the card and on the CPU must agree.
4. Train: the same model with the template's training settings (batch 100 =
   50 context + 50 query demos, dropout 0.1, AdamW lr 1e-4, L2 0.01, clip
   100) takes 20 steps of run_epoch over a DataLoader of seeded in-memory
   sequence items, once with the loss-based codebook (one K1 launch per
   step, no K2) and once with the EMA codebook (one K2 launch per step, no
   K1). One fp32 EMA-codebook step without dropout on the card and on the
   CPU from the same weights must agree: equal context ids, losses to rtol
   1e-4, every gradient to rtol 1e-3 + 1e-4 of its tensor's largest |g|,
   every parameter to the AdamW step of its own device's gradient (atol
   1e-3 lr + rtol 1e-6), the EMA buffers and the rows the EMA wrote to
   rtol 1e-5 / atol 1e-7 (``train_parity`` says why the parameters are
   held to their own gradient's step).
5. Output: a ``kernels`` JSON line, the card line, and last the result line
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
TRAIN_SHAPE = (500, 1024, 791)  # 50 context demos x 10 steps, codes, latent
CORPUS_SHAPE = (1 << 20, 1024, 208)  # bench.py's corpus tokenization shape
BATCH = 100  # exps/templates/icl.json: train.batch_size
SEQ_STEPS = 19  # frame_stack - 1 + seq_length of the template
TRAIN_STEPS = 20
FP32_U = 2.0 ** -24


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


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn``, which must return only once
    its device work is done, after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def wrapper_host_ms(fn, reps: int = 50) -> float:
    """Median host time of one call of ``fn`` from entry to return, the
    card idle before each call: what the Python wrapper costs the caller."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# K2's kernels by stage, matched on the profiler's kernel names
K2_STAGES = {"cn": ("code_norms",), "lookup": ("nearest_tile", "reduce_splits"),
             "sort": ("hist_kernel", "colscan", "codescan", "scatter"),
             "sums": ("short_sums", "long_sums")}


def stage_ms(kernels: dict) -> dict:
    return {stage: sum(ms for name, ms in kernels.items() if any(k in name for k in keys))
            for stage, keys in K2_STAGES.items()}


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


def stats_bound(b: int, n: int, d: int) -> tuple[float, str]:
    """Least time (ms) for the lookup + stats: the lookup's operations plus
    B*D adds, against z and c read once and ids, counts and sums written
    once."""
    ops_ms = (2 * b * n * d + 2 * n * d + b * d) / PEAK_FP32_FLOPS * 1e3
    bytes_ms = 4 * (b * d + n * d + b + n + n * d) / PEAK_BYTES_PER_S * 1e3
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
        raise AssertionError(f"ids differ beyond the tie tolerance on "
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
                                               ("train", TRAIN_SHAPE, 50, 10),
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
        wrapper_ms = wrapper_host_ms(lambda: vq_nearest_cuda(z, c), reps)
        bound_ms, bound_by = vq_bound(b, n, d)
        results[label] = {"shape": [b, n, d], "mismatches": mismatches,
                          "max_abs_err": max_gap, "ms": ms, "device_ms": device_ms,
                          "wrapper_host_ms": wrapper_ms, "kernel_ms": kernels,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"K1 {label} {b}x{n}x{d}: {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); K1 {ms:.4f} ms per call "
              f"(wrapper host {wrapper_ms:.4f} ms; device busy {device_ms} ms: {kernels}), "
              f"plain {plain_ms:.4f} ms, "
              f"addmm+argmin {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{card}]")
        del z, c, got, want
    torch.cuda.empty_cache()
    return results


def stats_phase(card: str) -> dict:
    """K2 against its plain version on the fixtures, then at the train
    step's and the corpus shape with times."""
    from lipvq_tpu_torch.ops.vq_lookup import (
        vq_cluster_stats,
        vq_nearest_with_stats_cuda,
        vq_nearest_with_stats_reference,
    )

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 must stay off"
    dev = torch.device("cuda")
    fixtures = []
    for b, n, d in [(300, 64, 16), (1, 1, 1), (70, 65, 791)]:
        rng = np.random.default_rng(0)
        z = rng.standard_normal((b, d), dtype=np.float32)
        fixtures.append((f"gauss{b}x{n}x{d}", z, rng.standard_normal((n, d), dtype=np.float32)))
    fixtures.append(("ties", np.asarray([[1, 0], [0, 1], [1, 0]], np.float32),
                     np.asarray([[5, 5], [1, 0], [1, 0], [0, 1], [0, 1]], np.float32)))
    for name, z, c in fixtures:
        zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(c).to(dev)
        ids, counts, sums = vq_nearest_with_stats_cuda(zt, ct)
        want_ids, want_counts, want_sums = vq_nearest_with_stats_reference(zt, ct)
        torch.cuda.synchronize()
        if not (torch.equal(ids, want_ids) and torch.equal(counts, want_counts)):
            raise AssertionError(f"K2 ids or counts differ from the plain version on {name}")
        torch.testing.assert_close(sums, want_sums, rtol=1e-5, atol=1e-5)
        if name == "ties" and (ids.tolist() != [1, 3, 1]
                               or counts.tolist() != [0, 2, 0, 1, 0]):
            raise AssertionError(f"K2 tie rule: got {ids.tolist()}, {counts.tolist()}")
    print(f"K2 fixtures: ids and counts exactly equal to the plain version, sums "
          f"within rtol 1e-5 / atol 1e-5 on {len(fixtures)} fixtures")

    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for label, (b, n, d), reps, plain_reps in (("train", TRAIN_SHAPE, 50, 10),
                                               ("corpus", CORPUS_SHAPE, 10, 3)):
        z = torch.randn(b, d, generator=gen, device=dev)
        c = torch.randn(n, d, generator=gen, device=dev)
        ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
        again = vq_nearest_with_stats_cuda(z, c)
        if not all(torch.equal(x, y) for x, y in zip((ids, counts, sums), again)):
            raise AssertionError(f"K2 is not deterministic at {label}")
        mismatches, max_gap = check_ids(z, c, ids, vq_nearest_with_stats_reference(z, c)[0])
        want_counts, want_sums = vq_cluster_stats(z, ids, n)
        _, abs_sums = vq_cluster_stats(z.abs(), ids, n)
        if not torch.equal(counts, want_counts):
            raise AssertionError(f"K2 counts differ from the plain stats at {label}")
        err = (sums - want_sums).abs()
        allowed = 1e-5 + 1e-5 * want_sums.abs() + 4 * FP32_U * counts[:, None] * abs_sums
        if (err > allowed).any():
            raise AssertionError(f"K2 sums exceed the summation bound on "
                                 f"{int((err > allowed).sum())} entries at {label}")
        max_err = float(err.max())

        def library():
            lib_ids = torch.addmm((c * c).sum(1), z, c.T, alpha=-2.0).argmin(1)
            torch.bincount(lib_ids, minlength=n)
            torch.zeros(n, d, device=dev).index_add_(0, lib_ids, z)

        ms = cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), reps)
        plain_ms = cuda_ms(lambda: vq_nearest_with_stats_reference(z, c), plain_reps)
        library_ms = cuda_ms(library, reps)
        device_ms, kernels = profile_device(lambda: vq_nearest_with_stats_cuda(z, c), reps)
        bound_ms, bound_by = stats_bound(b, n, d)
        results[label] = {"shape": [b, n, d], "mismatches": mismatches, "max_id_gap": max_gap,
                          "max_abs_err": max_err, "ms": ms, "device_ms": device_ms,
                          "stage_ms": stage_ms(kernels), "kernel_ms": kernels,
                          "plain_ms": plain_ms,
                          "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "codes_used": int((counts > 0).sum())}
        print(f"K2 {label} {b}x{n}x{d}: {mismatches} rows differ within the tie "
              f"tolerance (max fp64 gap {max_gap:.3g}); counts equal; sums max abs err "
              f"{max_err:.3g} ({int((counts > 0).sum())} codes used); K2 {ms:.4f} ms per "
              f"call (device busy {device_ms} ms, by stage {stage_ms(kernels)}: {kernels}), "
              f"plain {plain_ms:.4f} ms, addmm+argmin+bincount+index_add_ "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
        del z, c, ids, counts, sums, again, want_counts, want_sums, abs_sums, err, allowed
    torch.cuda.empty_cache()
    results["skewed"] = skewed_stats(card, gen)
    return results


def skewed_stats(card: str, gen) -> dict:
    """K2 at the corpus shape with every row on code 0, as at random init."""
    from lipvq_tpu_torch.ops.vq_lookup import vq_cluster_stats, vq_nearest_with_stats_cuda

    b, n, d = CORPUS_SHAPE
    dev = torch.device("cuda")
    z = torch.randn(b, d, generator=gen, device=dev)
    c = 100.0 + torch.randn(n, d, generator=gen, device=dev)
    c[0] = z.mean(0)
    ids, counts, sums = vq_nearest_with_stats_cuda(z, c)
    again = vq_nearest_with_stats_cuda(z, c)
    if not all(torch.equal(x, y) for x, y in zip((ids, counts, sums), again)):
        raise AssertionError("K2 is not deterministic in the skewed case")
    if int(ids.abs().sum()) != 0 or float(counts[0]) != b or float(counts.sum()) != b:
        raise AssertionError(f"skewed K2: {int((ids != 0).sum())} rows off code 0, "
                             f"counts[0] = {float(counts[0])}")
    want_counts, want_sums = vq_cluster_stats(z, ids, n)
    _, abs_sums = vq_cluster_stats(z.abs(), ids, n)
    if not torch.equal(counts, want_counts):
        raise AssertionError("skewed K2 counts differ from the plain stats")
    err = (sums - want_sums).abs()
    allowed = 1e-5 + 1e-5 * want_sums.abs() + 4 * FP32_U * counts[:, None] * abs_sums
    if (err > allowed).any():
        raise AssertionError(f"skewed K2 sums exceed the summation bound on "
                             f"{int((err > allowed).sum())} entries")
    sequential = torch.from_numpy(np.cumsum(z.cpu().numpy(), axis=0, dtype=np.float32)[-1])
    if not (torch.equal(sums[0].cpu(), sequential) and int(sums[1:].abs().sum()) == 0):
        raise AssertionError("skewed K2 sums are not the sequential ascending fp32 sum")
    ms = cuda_ms(lambda: vq_nearest_with_stats_cuda(z, c), 5)
    device_ms, kernels = profile_device(lambda: vq_nearest_with_stats_cuda(z, c), 5)
    stages = stage_ms(kernels)
    print(f"K2 skewed {b}x{n}x{d} (all rows on code 0): counts exact, sums bit-equal to a "
          f"sequential fp32 sum (plain one-hot product within {float(err.max()):.3g}), two "
          f"calls bit-identical; K2 {ms:.4f} ms per call (device busy {device_ms} ms, by "
          f"stage {stages}: {kernels}) [{card}]")
    return {"shape": [b, n, d], "max_abs_err": float(err.max()), "ms": ms,
            "device_ms": device_ms, "stage_ms": stages, "kernel_ms": kernels}


def icl_config(compute_dtype: str = "bfloat16", train: dict | None = None):
    """The paper's template widths with the flagship switches. ``train``
    ({"ema": bool, "dropout": float, "warmup": int}) adds the training
    settings of exps/templates/icl.json: batch 100, AdamW lr 1e-4 with L2
    0.01 and a constant_with_warmup schedule, clip 100."""
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
        if train is not None:
            cfg.train.batch_size = BATCH
            cfg.train.max_grad_norm = 100.0
            policy = cfg.algo.optim_params.policy
            policy.optimizer_type = "adamw"
            policy.regularization.L2 = 0.01
            policy.learning_rate.initial = 1e-4
            policy.learning_rate.scheduler_type = "constant_with_warmup"
            policy.learning_rate.num_warmup_steps = train["warmup"]
            cfg.algo.vq.ema_codebook = train["ema"]
            for key in ("emb_dropout", "attn_dropout", "block_output_dropout"):
                setattr(cfg.algo.transformer, key, train["dropout"])
    return cfg


def set_codebook(tok, algos, rng, extra_actions=None) -> None:
    """Set every algo's codebook to the latents of seeded actions under the
    fp32 CPU tokenizer ``tok`` (the codebook of a random init sends every
    latent to one code); the latents of ``extra_actions`` [k, A] take k
    random slots."""
    with torch.no_grad():
        codebook = tok.encode(torch.from_numpy(
            rng.uniform(-1, 1, (1024, AC_DIM)).astype(np.float32)))
        if extra_actions is not None:
            slots = torch.from_numpy(rng.permutation(1024)[:len(extra_actions)])
            codebook[slots] = tok.encode(torch.from_numpy(extra_actions))
        for a in algos:
            a.nets.net.encoder.action_network.quantizer.codebook.copy_(codebook)


def random_obs(rng, lead) -> dict:
    return {k: rng.standard_normal((*lead, *s), dtype=np.float32)
            for k, s in OBS_SHAPES.items()}


def slice_phase(card: str) -> dict:
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_with_stats_cuda

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
    # the context's own latents are among the codes
    set_codebook(algo_cpu.nets.net.encoder.action_network, (algo, algo32, algo_cpu), rng,
                 context["actions"][0])

    batched_obs = [random_obs(rng, (N_ENVS, t)) for _ in range(5)]
    single_obs = [random_obs(rng, (t,)) for _ in range(3)]
    policy = ICLRolloutPolicy(algo)

    # the main path: 5 batched + 3 single-env requests, counted
    vq_nearest_cuda.launches = vq_nearest_with_stats_cuda.launches = 0
    batched = [policy.batched(o, context) for o in batched_obs]
    single = [policy(o, context) for o in single_obs]
    launches = vq_nearest_cuda.launches
    k2_launches = vq_nearest_with_stats_cuda.launches
    requests = len(batched) + len(single)
    if launches != requests or k2_launches != 0:
        raise AssertionError(f"K1 launched {launches} and K2 {k2_launches} times for "
                             f"{requests} requests")
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

    batched_ms = host_ms(lambda: policy.batched(batched_obs[0], context))
    single_ms = host_ms(lambda: policy(single_obs[0], context))
    busy_ms, kernels = profile_device(lambda: policy.batched(batched_obs[0], context), 10)
    idle = None if busy_ms is None else 1.0 - busy_ms / batched_ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"slice latency: {batched_ms:.3f} ms per {N_ENVS}-env request, "
          f"{single_ms:.3f} ms per single-env request (median of 20); device "
          f"busy {busy_ms} ms per {N_ENVS}-env request, idle share {idle}; "
          f"{len(kernels)} distinct device ops, top {top} [{card}]")
    return {"launches": launches, "k2_launches": k2_launches,
            "batched_request_ms": batched_ms,
            "single_request_ms": single_ms, "device_busy_ms": busy_ms,
            "idle_share": idle}


class SequenceItems:
    """In-memory training items shaped like SequenceDataset's: obs leaves
    [19, ...] and actions [19, 12], made in bulk from a seed."""

    def __init__(self, n: int, seed: int):
        rng = np.random.default_rng(seed)
        obs = random_obs(rng, (n, SEQ_STEPS))
        actions = rng.uniform(-1, 1, (n, SEQ_STEPS, AC_DIM)).astype(np.float32)
        self.items = [{"obs": {k: v[i] for k, v in obs.items()}, "actions": actions[i]}
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def train_phase(card: str) -> dict:
    """20 run_epoch steps with the loss-based and with the EMA codebook,
    launches counted; step time, device busy time and top device ops."""
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader
    from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_cuda, vq_nearest_with_stats_cuda
    from lipvq_tpu_torch.utils.train_utils import run_epoch

    items = SequenceItems(2 * BATCH, seed=3)
    tok_cpu = algo_factory("icl", icl_config("float32"), OBS_SHAPES, ac_dim=AC_DIM,
                           device="cpu").nets.net.encoder.action_network
    results = {}
    for label, ema in (("train", False), ("train_ema", True)):
        algo = algo_factory("icl", icl_config(train={"ema": ema, "dropout": 0.1, "warmup": 10}),
                            OBS_SHAPES, ac_dim=AC_DIM)
        tok = algo.nets.net.encoder.action_network
        assert algo.device.type == "cuda" and tok.quantizer.codebook.shape == (1024, 791)
        set_codebook(tok_cpu, (algo,), np.random.default_rng(4))
        loader = DataLoader(items, BATCH, seed=5)

        # the main path: 20 train steps, counted
        vq_nearest_cuda.launches = vq_nearest_with_stats_cuda.launches = 0
        log = run_epoch(algo, loader, epoch=1, num_steps=TRAIN_STEPS)
        k1, k2 = vq_nearest_cuda.launches, vq_nearest_with_stats_cuda.launches
        if (k1, k2) != ((0, TRAIN_STEPS) if ema else (TRAIN_STEPS, 0)):
            raise AssertionError(f"{label}: K1 launched {k1} and K2 {k2} times in "
                                 f"{TRAIN_STEPS} steps")
        if not all(np.isfinite(v) for v in log.values()):
            raise AssertionError(f"{label}: non-finite step log {log}")
        lr = algo.policy_optimizer.optimizer.param_groups[0]["lr"]
        assert lr > 0, "the policy's learning rate is still 0"
        used = int((tok.ema_cluster_size > 0).sum()) if ema else None
        if ema and not (used > 0 and bool(tok.ema_embed_sum.abs().sum() > 0)):
            raise AssertionError("the EMA buffers are still zero")

        batch = algo.process_batch_for_training(next(iter(loader)))

        def step():
            algo.train_on_batch(batch, 1)
            torch.cuda.synchronize()

        step_ms = host_ms(step, reps=10)
        busy_ms, kernels = profile_device(lambda: algo.train_on_batch(batch, 1), 5)
        idle = None if busy_ms is None else 1.0 - busy_ms / step_ms
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        print(f"{label}: {TRAIN_STEPS} steps of batch {BATCH}, K1 launched {k1} and K2 "
              f"{k2} times; Loss {log['Loss']:.4f}, VQ_Loss {log['VQ_Loss']:.4f}, "
              f"grad norm {log['Policy_Grad_Norms']:.4f}, policy lr {lr:.3g}"
              + (f", {used} codes with EMA mass" if ema else "") + "; "
              f"Time_* minutes { {k: v for k, v in log.items() if k.startswith('Time_')} }")
        print(f"{label} step: {step_ms:.3f} ms median of 10; device busy {busy_ms} ms "
              f"per step, idle share {idle}; {len(kernels)} distinct device ops, top "
              f"{top} [{card}]")
        results[label] = {"k1_launches": k1, "k2_launches": k2, "log": log,
                          "step_ms": step_ms, "device_busy_ms": busy_ms, "idle_share": idle,
                          "top_ops_ms": dict(top), "ema_codes_used": used}
        del algo, tok, batch
        torch.cuda.empty_cache()
    results["parity"] = train_parity(items)
    return results


def train_parity(items) -> dict:
    """One fp32 step without dropout, EMA codebook on, from the same weights
    on the card and on the CPU (warmup 0, so both optimizers move).

    Adam's first step moves an element by lr * g / (|g| + 1e-8): where |g| is
    near that eps, the last digits of g, which differ between the two
    devices' reduction orders, decide much of the step, so the parameters of
    the two devices are not compared directly. The check holds instead
    (1) the losses to rtol 1e-4; (2) each gradient the optimizers receive,
    card against CPU, to rtol 1e-3 + atol 1e-4 * the tensor's largest |g|;
    (3) on each device, every parameter to the first AdamW step of its own
    gradient, p0 (1 - lr wd) - lr g / (|g| + eps), to atol 1e-3 lr + rtol
    1e-6, except the codebook rows the EMA wrote; (4) the EMA buffers and
    those rows, card against CPU, to rtol 1e-5 / atol 1e-7.
    """
    from lipvq_tpu_torch.algo import algo_factory
    from lipvq_tpu_torch.data.loaders import DataLoader

    def make(device=None):
        return algo_factory("icl", icl_config("float32", {"ema": True, "dropout": 0.0,
                                                          "warmup": 0}),
                            OBS_SHAPES, ac_dim=AC_DIM, device=device)

    def capture_grads(algo) -> dict:
        """The grads each optimizer step receives, by parameter name."""
        names = {id(p): n for n, p in algo.nets.named_parameters()}
        grads = {}

        def hook(opt, args, kwargs):
            for group in opt.param_groups:
                for p in group["params"]:
                    grads[names[id(p)]] = p.grad.detach().cpu().clone()

        for o in (algo.policy_optimizer, algo.vq_optimizer):
            o.optimizer.register_step_pre_hook(hook)
        return grads

    card, cpu = make(), make("cpu")
    batch = card.process_batch_for_training(next(iter(DataLoader(items, BATCH, seed=7))))
    ctx_act = batch["actions"][:BATCH // 2].reshape(-1, AC_DIM)
    # At the init's Lipschitz bound (softplus(1) per latent unit) every
    # latent lies within ~1e-3 of sigmoid(0) = 0.5 in squared distance, so
    # fp32 rounding of ||c||^2 - 2 z.c (||z||^2 ~ 198) decides the nearest
    # code. A bound of ~30 spreads the latents. The latents of the context
    # actions moved by N(0, 0.02) are codes as well: each context latent
    # then lies ~0.002 from its code and >= 0.16 further from any other
    # code, far above that rounding, and the commitment loss still sends a
    # gradient into the encoder (from exact codes it would be 0).
    tok = cpu.nets.net.encoder.action_network
    with torch.no_grad():
        for a in (card, cpu):
            a.nets.net.encoder.action_network.to_latent.ci.fill_(30.0)
    rng = np.random.default_rng(6)
    near = ctx_act + rng.normal(0.0, 0.02, ctx_act.shape).astype(np.float32)
    set_codebook(tok, (card, cpu), rng, near)
    card_ids = card.nets.net.encoder.action_network.tokenize(
        torch.from_numpy(ctx_act).cuda()).cpu()
    cpu_ids = cpu.nets.net.encoder.action_network.tokenize(torch.from_numpy(ctx_act))
    if not torch.equal(card_ids, cpu_ids):
        raise AssertionError(f"{int((card_ids != cpu_ids).sum())} context tokens differ "
                             f"between the card and the CPU")
    start = {n: p.detach().cpu().clone() for n, p in cpu.nets.named_parameters()}
    grads = {"card": capture_grads(card), "cpu": capture_grads(cpu)}
    got = card.train_on_batch(batch, 1)["losses"]
    want = cpu.train_on_batch(batch, 1)["losses"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)

    hyper = {}
    for o in (cpu.policy_optimizer, cpu.vq_optimizer):
        g = o.optimizer.param_groups[0]
        for p in o.params:
            hyper[id(p)] = (g["lr"], g["weight_decay"], g["eps"])
    touched = cpu.nets.net.encoder.action_network.ema_cluster_size > 0
    codebook = "net.encoder.action_network.quantizer.codebook"
    worst = {"grad_err_over_max": 0.0, "step_err_in_lr": 0.0, "card_vs_cpu_in_lr": 0.0,
             "buffers_and_ema_rows": 0.0}
    for (name, p), (_, q) in zip(card.nets.named_parameters(), cpu.nets.named_parameters()):
        g_card, g_cpu = grads["card"][name], grads["cpu"][name]
        scale = float(g_cpu.abs().max())
        np.testing.assert_allclose(g_card.numpy(), g_cpu.numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=f"grad of {name}")
        worst["grad_err_over_max"] = max(worst["grad_err_over_max"],
                                         float((g_card - g_cpu).abs().max()) / max(scale, 1e-30))
        lr, wd, eps = hyper[id(q)]
        keep = ~touched[:, None].expand_as(q) if name == codebook else torch.ones_like(
            q, dtype=torch.bool)
        for after, g in ((p.detach().cpu(), g_card), (q.detach(), g_cpu)):
            adam = start[name] * (1 - lr * wd) - lr * g / (g.abs() + eps)
            np.testing.assert_allclose(after[keep].numpy(), adam[keep].numpy(), rtol=1e-6,
                                       atol=1e-3 * lr, err_msg=f"AdamW step of {name}")
            worst["step_err_in_lr"] = max(worst["step_err_in_lr"],
                                          float((after - adam)[keep].abs().max()) / lr)
        worst["card_vs_cpu_in_lr"] = max(worst["card_vs_cpu_in_lr"],
                                         float((p.detach().cpu() - q.detach()).abs().max()) / lr)
    written = [(codebook + " (EMA rows)", card.nets.get_parameter(codebook)[touched.cuda()],
                cpu.nets.get_parameter(codebook)[touched])]
    written += [(name, b, c) for (name, b), (_, c) in zip(card.nets.named_buffers(),
                                                          cpu.nets.named_buffers())]
    for name, b, c in written:
        np.testing.assert_allclose(b.detach().cpu().numpy(), c.detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        worst["buffers_and_ema_rows"] = max(worst["buffers_and_ema_rows"],
                                            float((b.detach().cpu() - c.detach()).abs().max()))
    assert int(touched.sum()) > 0
    print(f"train parity: one fp32 step on the card == the CPU step; losses within rtol "
          f"1e-4 ({ {k: float(v) for k, v in got.items()} }); context ids equal; "
          f"{int(touched.sum())} codebook rows written by the EMA; worst {worst} (gradient "
          f"error over the tensor's max |g|; error against the AdamW step of each device's "
          f"own gradient, and card against CPU, in units of lr)")
    return {"losses": {k: float(v) for k, v in got.items()}, "worst": worst}


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
    logs = _build.build(["vq_nearest", "vq_stats"])
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name, (_, log) in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    k1 = kernel_phase(card)
    k2 = stats_phase(card)
    served = slice_phase(card)
    trained = train_phase(card)

    keys = ("shape", "mismatches", "max_abs_err", "ms", "device_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    k1_paths = {"serve": served["launches"], "train": trained["train"]["k1_launches"],
                "train_ema": trained["train_ema"]["k1_launches"]}
    k2_paths = {"serve": served["k2_launches"], "train": trained["train"]["k2_launches"],
                "train_ema": trained["train_ema"]["k2_launches"]}
    print(json.dumps({"kernels": [{
        "name": "vq_nearest (K1)",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_nearest.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:68",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "fixtures_exact": True,
        **{k: k1["slice"][k] for k in keys},
        "wrapper_host_ms": k1["slice"]["wrapper_host_ms"],
        "train_shape": k1["train"],
        "corpus": k1["corpus"],
        "card": card,
    }, {
        "name": "vq_nearest_with_stats (K2)",
        "route": "cuda",
        "source": "lipvq_tpu_torch/ops/csrc/vq_stats.cu",
        "replaces": "lipvq_tpu/ops/vq_lookup.py:95",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "fixtures_exact": True,
        **{k: k2["train"][k] for k in keys},
        "stage_ms": k2["train"]["stage_ms"],
        "corpus": k2["corpus"],
        "skewed": k2["skewed"],
        "card": card,
    }], "serve": served, "train": trained}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
