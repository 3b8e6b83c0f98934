"""Offline corpus tokenization (counterpart of ``lipvq_tpu/parallel/corpus.py``).

The demonstrations' action rows of each dataset export (``data/export.py``)
are concatenated in demo order, encoded and quantized by ``LipVQVAE`` on
one card (the JAX package shards them over a mesh; the port's one-card
path has no mesh), and the ids are written back per demo as
``data/<demo>/tokens/<output_key>.npy``, where ``Export.has``/``load`` see
them.

The lookup is K1 (``precision="highest"``, ids equal to the exact lookup,
as the JAX CLI uses); ``precision="fast"`` opts into K1f, one bf16 pass on
the tensor cores, whose ids may differ on near-ties.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lipvq_tpu_torch.algo.base import resolve_device
from lipvq_tpu_torch.data.export import Export, add_arrays
from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
from lipvq_tpu_torch.ops.vq_lookup import vq_nearest_fast
from lipvq_tpu_torch.utils.profile_utils import span


def tokenize_array(model: LipVQVAE, actions: np.ndarray, device=None, chunk: int = 1 << 16,
                   precision: str = "highest") -> np.ndarray:
    """actions [N, A] -> token ids [N] int32, on ``device`` (CUDA when None;
    the model is moved there). The rows go up in one copy and through
    ``LipVQVAE.tokenize`` in chunks of at most ``chunk`` rows, which bounds
    the encoder's activations: one lookup per chunk, ceil(N / chunk) in all.
    The ids come back in one copy."""
    if precision not in ("highest", "fast"):
        raise ValueError(f"precision is 'highest' or 'fast', got {precision!r}")
    dev = resolve_device(device)
    model.to(dev)
    with span("corpus.upload"):
        x = torch.as_tensor(np.ascontiguousarray(actions, dtype=np.float32), device=dev)
    with torch.inference_mode():
        ids = []
        for xc in x.split(chunk):
            with span("corpus.chunk"):
                if precision == "fast":
                    ids.append(vq_nearest_fast(model.encode(xc), model.quantizer.codebook))
                else:
                    ids.append(model.tokenize(xc))
        out = torch.cat(ids) if ids else torch.empty(0, dtype=torch.int32, device=dev)
        with span("corpus.fetch"):
            return out.cpu().numpy()


def tokenize_export_corpus(model: LipVQVAE, export_dirs: list[str],
                           output_key: str = "lipvq_tokens", action_key: str = "actions",
                           device=None, write: bool = True, precision: str = "highest") -> dict:
    """Tokenize every demo's actions of one or more exports (counterpart of
    ``tokenize_hdf5_corpus``). Returns {files, demos, chunks, seconds,
    chunks_per_sec}: ``chunks`` counts action rows, ``seconds`` the
    tokenization of each file's concatenated rows, copies to and from the
    card included, from an idle card to the ids on the host. With ``write``
    the ids are stored per demo at ``tokens/<output_key>``."""
    dev = resolve_device(device)
    stats = {"files": 0, "demos": 0, "chunks": 0, "seconds": 0.0}
    for root in export_dirs:
        export = Export(root)
        demos = sorted(export.demos, key=lambda e: int(e[5:]))
        arrays = [np.asarray(export.load(d, action_key), np.float32) for d in demos]
        corpus = np.concatenate(arrays, axis=0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ids = tokenize_array(model, corpus, device=dev, precision=precision)
        dt = time.perf_counter() - t0
        if write:
            bounds = np.cumsum([0] + [len(a) for a in arrays])
            add_arrays(root, {d: {f"tokens/{output_key}": ids[lo:hi]}
                              for d, lo, hi in zip(demos, bounds[:-1], bounds[1:])})
        stats["files"] += 1
        stats["demos"] += len(demos)
        stats["chunks"] += corpus.shape[0]
        stats["seconds"] += dt
    stats["chunks_per_sec"] = stats["chunks"] / max(stats["seconds"], 1e-9)
    return stats
