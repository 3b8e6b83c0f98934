"""Nearest-code lookup of the LipVQ-VAE quantizer and its cluster statistics:
plain PyTorch + kernels K1 and K2.

Counterpart of ``lipvq_tpu/ops/vq_lookup.py``. For z [B, D] and a codebook
[N, D] every lookup here returns int32 ids [B] with

    ids[b] = argmin_n ||z[b] - c[n]||^2      (lowest index wins ties)

- ``vq_nearest_reference``: the exact difference form, chunked over rows so
  the [rows, N, D] temporary stays bounded. The plain version of K1: the CPU
  path runs it and ``chip_smoke.py`` holds K1 against it on the card.
- ``vq_distances_reference``: the full [B, N] expand-form distance matrix.
- ``vq_nearest_expand``: ``||c||^2 - 2 z.c`` with ``||z||^2`` dropped, in
  fp32 (TF32 must stay off for exact ids).
- ``vq_nearest_cuda``: kernel K1 (``csrc/vq_nearest.cu``); it launches on
  CUDA tensors and raises on anything else.
- ``vq_nearest``: the dispatcher the quantizer calls: K1 on a CUDA tensor,
  the plain reference on a CPU tensor.
- ``vq_cluster_stats``: the one-hot counts [N] and sums [N, D] of given ids.
- ``vq_nearest_with_stats_reference``: the plain version of K2, the
  reference ids plus their cluster stats.
- ``vq_nearest_with_stats_cuda``: kernel K2 (``csrc/vq_stats.cu``): K1's
  lookup and the stats in one call, deterministic.
- ``vq_nearest_with_stats``: the dispatcher the EMA codebook's training
  forward calls: K2 on a CUDA tensor, the plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from lipvq_tpu_torch.ops import _build

# bound on the elements of the [rows, N, D] temporary of the difference form
_REFERENCE_CHUNK_ELEMS = 1 << 24


def vq_nearest_reference(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Exact-form nearest code ids. z_e [B, D], codebook [N, D] -> [B] int32."""
    z = z_e.float()
    c = codebook.float()
    rows = max(1, _REFERENCE_CHUNK_ELEMS // max(1, c.shape[0] * c.shape[1]))
    ids = [
        torch.argmin(((zc[:, None, :] - c[None, :, :]) ** 2).sum(-1), dim=-1)
        for zc in z.split(rows)
    ]
    return torch.cat(ids).to(torch.int32)


def vq_distances_reference(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Full [B, N] squared-distance matrix (expand form, fp32)."""
    z = z_e.float()
    c = codebook.float()
    zn = (z * z).sum(-1, keepdim=True)
    cn = (c * c).sum(-1)[None, :]
    return zn + cn - 2.0 * (z @ c.T)


def vq_nearest_expand(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Expand-form lookup in plain fp32 PyTorch; ``||z||^2`` dropped, first
    minimum wins (counterpart of ``vq_nearest_xla_expand``)."""
    z = z_e.float()
    c = codebook.float()
    cn = (c * c).sum(-1)
    return torch.argmin(cn[None, :] - 2.0 * (z @ c.T), dim=-1).to(torch.int32)


def _bind(name: str, entry: str, n_ptrs: int) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``entry`` declared: ``n_ptrs``
    pointers, the five ints (B, N, D, codes per split, splits), the stream."""
    lib = _build.load(name)
    if not getattr(lib, "_bound", False):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        lib.vq_nearest_block_rows.restype = ctypes.c_int
        lib.vq_nearest_block_codes.restype = ctypes.c_int
        lib._bound = True
    return lib


def _check_inputs(kernel: str, z_e: torch.Tensor, codebook: torch.Tensor) -> None:
    if not (z_e.is_cuda and codebook.is_cuda and z_e.device == codebook.device):
        raise ValueError(f"{kernel} needs both tensors on one CUDA device, got "
                         f"{z_e.device} and {codebook.device}")
    if z_e.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise ValueError(f"{kernel} takes float32, got {z_e.dtype} and {codebook.dtype}")
    if z_e.dim() != 2 or codebook.dim() != 2 or z_e.shape[1] != codebook.shape[1]:
        raise ValueError(f"{kernel} takes z [B, D] and codebook [N, D], got "
                         f"{tuple(z_e.shape)} and {tuple(codebook.shape)}")
    if not (z_e.is_contiguous() and codebook.is_contiguous()):
        raise ValueError(f"{kernel} takes contiguous tensors")
    b, d = z_e.shape
    n = codebook.shape[0]
    if b == 0 or n == 0 or d == 0:
        raise ValueError(f"{kernel} takes non-empty inputs, got B={b}, N={n}, D={d}")
    if max(b, n, d) >= 2**31:
        raise ValueError(f"{kernel} takes B, N and D below 2**31")


def _lookup_args(lib: ctypes.CDLL, z_e: torch.Tensor, codebook: torch.Tensor):
    """Outputs and scratch of the shared lookup: (ids, the temporaries to
    hold until the launch is enqueued, the pointer args through the split
    scratch, the int args). The codes are split over grid rows until the
    card has ~2 CTAs per SM."""
    b, d = z_e.shape
    n = codebook.shape[0]
    dev = z_e.device
    block_rows = lib.vq_nearest_block_rows()
    block_codes = lib.vq_nearest_block_codes()
    row_tiles = -(-b // block_rows)
    code_tiles = -(-n // block_codes)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = min(code_tiles, max(1, -(-2 * sms // row_tiles)))
    tiles_per_split = -(-code_tiles // splits)
    splits = -(-code_tiles // tiles_per_split)

    cn = (codebook * codebook).sum(dim=1)
    ids = torch.empty(b, dtype=torch.int32, device=dev)
    keep = [cn, ids]
    scratch = [None, None]
    if splits > 1:
        keep += [torch.empty((splits, b), dtype=torch.float32, device=dev),
                 torch.empty((splits, b), dtype=torch.int32, device=dev)]
        scratch = [keep[2].data_ptr(), keep[3].data_ptr()]
    ptrs = [z_e.data_ptr(), codebook.data_ptr(), cn.data_ptr(), ids.data_ptr(), *scratch]
    return ids, keep, ptrs, [b, n, d, tiles_per_split * block_codes, splits]


def _launch(kernel: str, lib: ctypes.CDLL, entry: str, dev: torch.device, ptrs, ints) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.vq_error_string(err).decode()} ({err})")


def vq_nearest_cuda(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on the card. z_e [B, D], codebook [N, D]: fp32, contiguous,
    on one CUDA device -> ids [B] int32. Raises on anything else.

    ``vq_nearest_cuda.launches`` counts the calls that launched the kernel.
    """
    _check_inputs("K1", z_e, codebook)
    lib = _bind("vq_nearest", "vq_nearest_launch", 6)
    ids, _keep, ptrs, ints = _lookup_args(lib, z_e, codebook)
    _launch("K1", lib, "vq_nearest_launch", z_e.device, ptrs, ints)
    vq_nearest_cuda.launches += 1
    return ids


vq_nearest_cuda.launches = 0


def vq_nearest(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Dispatching lookup: K1 on a CUDA tensor, the plain reference on a CPU
    tensor. Inputs are detached (the ids are not differentiable), as the JAX
    dispatcher stop-gradients them."""
    z_e = z_e.detach()
    codebook = codebook.detach()
    if z_e.is_cuda:
        return vq_nearest_cuda(z_e.float().contiguous(), codebook.float().contiguous())
    return vq_nearest_reference(z_e, codebook)


def vq_cluster_stats(z_e: torch.Tensor, ids: torch.Tensor, num_codes: int):
    """One-hot cluster stats of ``ids``: counts [N] fp32 and sums [N, D] =
    one_hot^T z in fp32, accumulated over row chunks so the one-hot
    temporary stays bounded."""
    z = z_e.float()
    rows = max(1, _REFERENCE_CHUNK_ELEMS // max(1, num_codes))
    counts = torch.zeros(num_codes, dtype=torch.float32, device=z.device)
    sums = torch.zeros((num_codes, z.shape[1]), dtype=torch.float32, device=z.device)
    for zc, ic in zip(z.split(rows), ids.split(rows)):
        one_hot = torch.nn.functional.one_hot(ic.long(), num_codes).float()
        counts += one_hot.sum(0)
        sums += one_hot.T @ zc
    return counts, sums


def vq_nearest_with_stats_reference(z_e: torch.Tensor, codebook: torch.Tensor):
    """Plain version of K2: (ids [B] int32, counts [N] fp32, sums [N, D] fp32)
    from ``vq_nearest_reference`` and ``vq_cluster_stats``."""
    ids = vq_nearest_reference(z_e, codebook)
    return (ids, *vq_cluster_stats(z_e, ids, codebook.shape[0]))


def vq_nearest_with_stats_cuda(z_e: torch.Tensor, codebook: torch.Tensor):
    """Kernel K2 on the card. z_e [B, D], codebook [N, D]: fp32, contiguous,
    on one CUDA device -> (ids [B] int32, counts [N] fp32, sums [N, D] fp32).
    Raises on anything else. The stats are deterministic: each sum adds its
    rows in ascending order.

    ``vq_nearest_with_stats_cuda.launches`` counts the calls that launched
    the kernel.
    """
    _check_inputs("K2", z_e, codebook)
    lib = _bind("vq_stats", "vq_stats_launch", 8)
    ids, _keep, ptrs, ints = _lookup_args(lib, z_e, codebook)
    n, d = codebook.shape
    counts = torch.empty(n, dtype=torch.float32, device=z_e.device)
    sums = torch.empty((n, d), dtype=torch.float32, device=z_e.device)
    ptrs = [*ptrs, counts.data_ptr(), sums.data_ptr()]
    _launch("K2", lib, "vq_stats_launch", z_e.device, ptrs, ints)
    vq_nearest_with_stats_cuda.launches += 1
    return ids, counts, sums


vq_nearest_with_stats_cuda.launches = 0


def vq_nearest_with_stats(z_e: torch.Tensor, codebook: torch.Tensor):
    """Dispatching lookup + cluster stats: K2 on a CUDA tensor, the plain
    version on a CPU tensor. Inputs are detached (neither ids nor stats are
    differentiated)."""
    z_e = z_e.detach()
    codebook = codebook.detach()
    if z_e.is_cuda:
        return vq_nearest_with_stats_cuda(z_e.float().contiguous(),
                                          codebook.float().contiguous())
    return vq_nearest_with_stats_reference(z_e, codebook)
