"""Host dataloader throughput at the image protocol (counterpart of
``lipvq_tpu/scripts/bench_loader.py``).

The reference trains the image modality with 5 torch DataLoader worker
processes (config_gen_utils.py:232-238, train.py:213). This bench builds a
synthetic image-protocol export (2 camera streams, 128x128x3 uint8,
10-frame windows, batch 16: the JAX bench's HDF5 fixture, same keys,
shapes, lengths and seed, written with ``ExportWriter``), measures
batches/s for the single-thread ``DataLoader``, the thread
``PrefetchLoader``, and the ``MultiprocessLoader`` at several worker
counts, and reports each against the device step rate: by default the
image protocol's train step on one NVIDIA H100 80GB HBM3 at its 700 W
power limit, 142.2 ms (``chip_smoke.py``'s visual phase; ``PERF.md`` §5).

    python -m lipvq_tpu_torch.scripts.bench_loader [--device_step_ms 142.2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

# the image protocol's train step (loss codebook, batch 16, three 128 x 128
# cameras) on one NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py's visual
# phase (PERF.md §5)
DEVICE_STEP_MS = 142.2
CAMERAS = ("robot0_agentview_left_image", "robot0_eye_in_hand_image")


def build_fixture(path, n_demos=12, steps=40, img=128):
    """The JAX bench's fixture as an export at ``path``: the same seed and
    the same RNG calls in the same order, so the same arrays."""
    from lipvq_tpu_torch.data.export import ExportWriter

    rng = np.random.default_rng(0)
    writer = ExportWriter(path)
    env_args = {"env_name": "SyntheticImage", "type": 1, "env_kwargs": {}}
    for d in range(n_demos):
        arrays = {f"obs/{cam}": rng.integers(0, 255, (steps, img, img, 3), dtype=np.uint8)
                  for cam in CAMERAS}
        arrays["obs/robot0_eef_pos"] = rng.standard_normal((steps, 3)).astype(np.float32)
        arrays["actions"] = rng.standard_normal((steps, 12)).astype(np.float32)
        writer.add_demo(f"demo_{d}", {"num_samples": steps,
                                      "ep_meta": json.dumps({"lang": "synthetic image demo"})},
                        arrays)
    return writer.finish({"env_args": json.dumps(env_args)}, {})


def make_dataset(path):
    from lipvq_tpu_torch.data.dataset import SequenceDataset
    from lipvq_tpu_torch.utils import obs_utils as ObsUtils

    ObsUtils.register_obs_keys(
        {"robot0_agentview_left_image": "rgb",
         "robot0_eye_in_hand_image": "rgb",
         "robot0_eef_pos": "low_dim"}
    )
    return SequenceDataset(
        hdf5_path=path,
        obs_keys=(*CAMERAS, "robot0_eef_pos"),
        dataset_keys=("actions",),
        frame_stack=1,
        seq_length=10,
        pad_frame_stack=True,
        pad_seq_length=True,
        hdf5_cache_mode=None,
        hdf5_use_swmr=True,
    )


def time_loader(loader, n_batches=30, warmup=3):
    it = iter(loader)
    for _ in range(warmup):
        next(it)
    t0 = time.time()
    got = 0
    while got < n_batches:
        try:
            next(it)
        except StopIteration:
            it = iter(loader)
            continue
        got += 1
    dt = time.time() - t0
    if hasattr(loader, "close"):
        # finish the epoch before the workers stop: a spawned worker stopped
        # while it still collates a batch can abort as it exits, and torch's
        # child-signal handler then raises in this process
        for _ in it:
            pass
        loader.close()
    return n_batches / dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device_step_ms", type=float, default=DEVICE_STEP_MS,
                    help="image-protocol device step time to keep fed (default: the train "
                         "step on one NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 5)")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--n_batches", type=int, default=30)
    args = ap.parse_args(argv)

    from lipvq_tpu_torch.data.loaders import (
        DataLoader,
        MultiprocessLoader,
        PrefetchLoader,
    )

    with tempfile.TemporaryDirectory() as td:
        path = build_fixture(os.path.join(td, "img"))
        ds = make_dataset(path)
        need = 1000.0 / args.device_step_ms
        results = {}

        base = DataLoader(ds, batch_size=args.batch_size, shuffle=True)
        results["single_thread"] = time_loader(base, args.n_batches)
        results["prefetch_thread"] = time_loader(
            PrefetchLoader(
                DataLoader(ds, batch_size=args.batch_size, shuffle=True)
            ),
            args.n_batches,
        )
        for w in (2, 4):
            mp = MultiprocessLoader(
                ds, batch_size=args.batch_size, shuffle=True, num_workers=w
            )
            results[f"multiprocess_{w}w"] = time_loader(mp, args.n_batches)

        out = {
            "metric": "image_protocol_loader_batches_per_sec",
            "device_step_rate": round(need, 2),
            **{k: round(v, 2) for k, v in results.items()},
            "keeps_device_fed": {
                k: bool(v >= need) for k, v in results.items()
            },
        }
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
