"""Nearest-code lookup of the LipVQ-VAE quantizer and its cluster statistics:
plain PyTorch + kernels K1, K1f and K2.

Counterpart of ``lipvq_tpu/ops/vq_lookup.py``. For z [B, D] and a codebook
[N, D] every lookup here returns int32 ids [B] with

    ids[b] = argmin_n ||z[b] - c[n]||^2      (lowest index wins ties)

- ``vq_nearest_reference``: the exact difference form, chunked over rows so
  the [rows, N, D] temporary stays bounded. The plain version of K1: the CPU
  path runs it and ``chip_smoke.py`` holds K1 against it on the card.
- ``vq_distances_reference``: the full [B, N] expand-form distance matrix.
- ``vq_nearest_expand``: ``||c||^2 - 2 z.c`` with ``||z||^2`` dropped, in
  fp32 (TF32 must stay off for exact ids).
- ``vq_nearest_cuda``: kernel K1 (``csrc/vq_nearest.cu``), or with
  ``precision="fast"`` kernel K1f (``csrc/vq_nearest_fast.cu``: one bf16
  pass on the tensor cores, wgmma fed by a TMA ring, fp32 accumulation); it
  launches on CUDA tensors and raises on anything else. ``plan_lookup`` (K1)
  and ``plan_fast`` (K1f) pick the tile configuration and code splits; the
  plan and the scratch size are cached per device and shape, and all
  scratch is one ``torch.empty`` of the size the library states (K1f's
  holds the bf16 copy of the codebook).
- ``vq_nearest``: the dispatcher the quantizer calls: K1 on a CUDA tensor,
  the plain reference on a CPU tensor. It has no precision argument, as in
  the JAX package: the fast lookup is never chosen silently.
- ``vq_nearest_fast_reference``: the plain version of K1f,
  ``argmin(cn - 2 bf16(z) . bf16(c))`` in fp32 with ``cn`` from the fp32
  codebook (the Pallas wrapper's ``cn``); TF32 must stay off.
- ``vq_nearest_fast``: the opt-in fast lookup: K1f on a CUDA tensor, its
  plain version on a CPU tensor.
- ``tie_gap``: the near-tie rule by which K1f is held against its plain
  version (their ids cannot be bit-equal), and K1 against the exact
  difference form where the expand form's cancellation decides.
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
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

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


def vq_nearest_fast_reference(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain version of K1f: ``argmin_n(cn[n] - 2 bf16(z) . bf16(c[n]))`` in
    fp32, ``cn`` from the fp32 codebook, the operands rounded to bf16 (to
    nearest even) and their products summed in fp32; first minimum wins.
    Chunked over rows so the [rows, N] scores stay bounded."""
    z = z_e.float()
    c = codebook.float()
    cn = (c * c).sum(-1)
    cb = c.bfloat16().float()
    rows = max(1, _REFERENCE_CHUNK_ELEMS // max(1, c.shape[0]))
    ids = [torch.argmin(cn[None, :] - 2.0 * (zc.bfloat16().float() @ cb.T), dim=-1)
           for zc in z.split(rows)]
    return torch.cat(ids).to(torch.int32)


def tie_gap(z_e: torch.Tensor, codebook: torch.Tensor, ids_a: torch.Tensor,
            ids_b: torch.Tensor, bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """How far apart two fp32 evaluations of the expand form ``cn - 2 z . c``
    (operands rounded to bf16 first with ``bf16``: K1f and its plain
    version) may pick codes: for each row where ``ids_a`` and ``ids_b``
    differ, (the fp64 distance gap of the two picks over the operands, its
    allowance); a gap within its allowance is a near-tie either evaluation
    may resolve either way. Each evaluation's error on code n is at most
    (D + 1) 2^-23 (2 S[n] + cn[n]), S[n] = sum_k |z_k c_nk| (D products
    summed with a per-add error of 2^-23, which covers truncating tensor-core
    adds, and the same for cn), so the allowance is that bound summed over
    the two picks. Both are empty where the ids agree."""
    bad = (ids_a != ids_b).nonzero().flatten()
    z = z_e[bad].bfloat16().double() if bf16 else z_e[bad].double()
    dists, allowed = [], 0.0
    for ids in (ids_a[bad].long(), ids_b[bad].long()):
        c = codebook[ids]
        prod = z * (c.bfloat16().double() if bf16 else c.double())
        cn = (c.double() ** 2).sum(1)
        dists.append(cn - 2.0 * prod.sum(1))
        allowed = allowed + (z_e.shape[1] + 1) * 2.0 ** -23 * (2.0 * prod.abs().sum(1) + cn)
    return (dists[0] - dists[1]).abs(), allowed + torch.zeros_like(dists[0])


def vq_nearest_expand(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Expand-form lookup in plain fp32 PyTorch; ``||z||^2`` dropped, first
    minimum wins (counterpart of ``vq_nearest_xla_expand``)."""
    z = z_e.float()
    c = codebook.float()
    cn = (c * c).sum(-1)
    return torch.argmin(cn[None, :] - 2.0 * (z @ c.T), dim=-1).to(torch.int32)


# tile shapes (rows, codes) of the lookup's configurations, as in
# csrc/vq_nearest_tile.cuh; _bind checks them against the library
LARGE, MEDIUM, SMALL = 0, 1, 2
TILE_SHAPES = {LARGE: (128, 256), MEDIUM: (32, 64), SMALL: (32, 32)}


class LookupPlan(NamedTuple):
    """Grid of the lookup: configuration, row tiles, code splits and the
    codes of each split (a multiple of the configuration's tile)."""

    config: int
    row_tiles: int
    splits: int
    codes_per_split: int

    @property
    def ctas(self) -> int:
        return self.row_tiles * self.splits


def _split_codes(config: int, shape: tuple[int, int], b: int, n: int, sms: int) -> LookupPlan:
    """The plan of a (rows, codes) tile shape: the codes are split into
    contiguous ranges, each a whole number of tiles, until the grid has
    about two CTAs per SM."""
    rows, codes = shape
    row_tiles, code_tiles = -(-b // rows), -(-n // codes)
    splits = min(code_tiles, max(1, -(-2 * sms // row_tiles)))
    tiles_per_split = -(-code_tiles // splits)
    splits = -(-code_tiles // tiles_per_split)
    return LookupPlan(config, row_tiles, splits, tiles_per_split * codes)


def plan_lookup(b: int, n: int, sms: int) -> LookupPlan:
    """K1's launch plan for B rows, N codes on a card with ``sms`` SMs:
    LARGE when its row tiles alone give every SM two CTAs (the corpus); else
    MEDIUM when its row and code tiles give every SM a CTA (train batches),
    else SMALL (served requests)."""
    def tiles(config):
        rows, codes = TILE_SHAPES[config]
        return -(-b // rows), -(-n // codes)

    if tiles(LARGE)[0] >= 2 * sms:
        config = LARGE
    elif tiles(MEDIUM)[0] * tiles(MEDIUM)[1] >= sms:
        config = MEDIUM
    else:
        config = SMALL
    return _split_codes(config, TILE_SHAPES[config], b, n, sms)


# K1f's configurations: tile shapes (rows, codes) and the largest D of each,
# as in csrc/vq_nearest_fast.cu; _bind checks them against the library
FAST_WIDE, FAST_NARROW = 0, 1
FAST_TILES = {FAST_WIDE: (256, 128), FAST_NARROW: (64, 16)}
FAST_WIDE_MAX_D = 320
FAST_MAX_D = 1728


def plan_fast(b: int, n: int, d: int, sms: int) -> LookupPlan:
    """K1f's launch plan for B rows, N codes of width D: WIDE (256 rows x
    128 codes, D <= ``FAST_WIDE_MAX_D``) where its tiles alone give every SM
    a CTA (the corpus), else NARROW (64 x 16, any D up to ``FAST_MAX_D``),
    whose fine code splits give small batches a CTA per SM; codes split as
    K1's, to about two CTAs per SM."""
    rows, codes = FAST_TILES[FAST_WIDE]
    wide = d <= FAST_WIDE_MAX_D and -(-b // rows) * -(-n // codes) >= sms
    config = FAST_WIDE if wide else FAST_NARROW
    return _split_codes(config, FAST_TILES[config], b, n, sms)


_POINTERS = {"vq_nearest": 4, "vq_nearest_fast": 4, "vq_stats": 6}  # pointer args
_LIBS: dict[str, ctypes.CDLL] = {}
_SMS: dict[int, int] = {}
_PLANS: dict[tuple, tuple[LookupPlan, int, int]] = {}


def _bind(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with its entry point
    ``<name>_launch`` declared: the pointers, six ints (B, N, D, config,
    codes per split, splits), the stream."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = ([ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fast = name == "vq_nearest_fast"
        for scratch, ints in ((getattr(lib, f"{name}_scratch_elems"), 4 if fast else 3),
                              (lib.vq_lookup_scratch_elems, 3)):
            scratch.argtypes = [ctypes.c_int] * ints
            scratch.restype = ctypes.c_size_t
        lib.vq_error_string.argtypes = [ctypes.c_int]
        lib.vq_error_string.restype = ctypes.c_char_p
        for config, shape in TILE_SHAPES.items():
            got = (lib.vq_tile_rows(config), lib.vq_tile_codes(config))
            if got != shape:
                raise RuntimeError(f"{name}: tile shape of config {config} is {got} in the "
                                   f"library, {shape} in vq_lookup.py")
        if fast:
            for config, shape in FAST_TILES.items():
                got = (lib.vq_fast_tile_rows(config), lib.vq_fast_tile_codes(config),
                       lib.vq_fast_max_d(config))
                want = (*shape, FAST_WIDE_MAX_D if config == FAST_WIDE else FAST_MAX_D)
                if got != want:
                    raise RuntimeError(f"{name}: tile shape and largest D of config {config} "
                                       f"are {got} in the library, {want} in vq_lookup.py")
        _LIBS[name] = lib
    return lib


def _plan(lib: ctypes.CDLL, name: str, dev: torch.device, b: int, n: int, d: int):
    """(plan, scratch elements of ``name``, of which the lookup's come
    first) at this shape, cached per device and shape, with the device's SM
    count cached once."""
    fast = name == "vq_nearest_fast"
    key = (name, dev.index, b, n, d if fast else None)
    hit = _PLANS.get(key)
    if hit is None:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        if fast:
            plan = plan_fast(b, n, d, sms)
            scratch = lib.vq_nearest_fast_scratch_elems(b, n, d, plan.splits)
        else:
            plan = plan_lookup(b, n, sms)
            scratch = getattr(lib, f"{name}_scratch_elems")(b, n, plan.splits)
        hit = _PLANS[key] = (plan, scratch, lib.vq_lookup_scratch_elems(b, n, plan.splits))
    return hit


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


def _ids_and_scratch(b: int, scratch_elems: int, dev: torch.device):
    """One int32 allocation: ids [B] first, then the scratch (16-byte
    aligned); returns (buffer, ids, the scratch's address)."""
    head = -(-b // 4) * 4
    buf = torch.empty(head + scratch_elems, dtype=torch.int32, device=dev)
    return buf, buf[:b], buf.data_ptr() + 4 * head


def _launch(kernel: str, lib: ctypes.CDLL, name: str, dev: torch.device, ptrs, ints) -> None:
    """Call ``<name>_launch`` on the current stream of ``dev``; raise on a
    non-zero cudaError_t."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = getattr(lib, f"{name}_launch")
    if dev.index == torch.cuda.current_device():
        err = fn(*ptrs, *ints, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: "
                           f"{lib.vq_error_string(err).decode()} ({err})")


def vq_nearest_cuda(z_e: torch.Tensor, codebook: torch.Tensor,
                    precision: str = "highest") -> torch.Tensor:
    """Kernel K1 on the card, or with ``precision="fast"`` kernel K1f (the
    counterpart of ``vq_nearest_pallas(precision=...)``). z_e [B, D],
    codebook [N, D]: fp32, contiguous, on one CUDA device -> ids [B] int32.
    Raises on anything else, and for K1f on D > ``FAST_MAX_D``.

    ``vq_nearest_cuda.launches`` counts the calls that launched K1,
    ``vq_nearest_cuda.fast_launches`` those that launched K1f.
    """
    if precision not in ("highest", "fast"):
        raise ValueError(f"precision is 'highest' or 'fast', got {precision!r}")
    fast = precision == "fast"
    kernel, name = ("K1f", "vq_nearest_fast") if fast else ("K1", "vq_nearest")
    _check_inputs(kernel, z_e, codebook)
    (b, d), n, dev = z_e.shape, codebook.shape[0], z_e.device
    if fast and d > FAST_MAX_D:
        raise ValueError(f"K1f takes D <= {FAST_MAX_D} (its z tile lives in shared "
                         f"memory), got D={d}")
    lib = _bind(name)
    plan, scratch_elems, _ = _plan(lib, name, dev, b, n, d)
    _, ids, scratch = _ids_and_scratch(b, scratch_elems, dev)
    _launch(kernel, lib, name, dev,
            [z_e.data_ptr(), codebook.data_ptr(), ids.data_ptr(), scratch],
            [b, n, d, plan.config, plan.codes_per_split, plan.splits])
    if fast:
        vq_nearest_cuda.fast_launches += 1
    else:
        vq_nearest_cuda.launches += 1
    return ids


vq_nearest_cuda.launches = 0
vq_nearest_cuda.fast_launches = 0


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


def _vq_stats_launch(z_e: torch.Tensor, codebook: torch.Tensor):
    """Launch K2 and count it: (ids, counts, sums, order), ``order`` [B]
    int32 being the rows sorted stably by id (a view into the scratch)."""
    _check_inputs("K2", z_e, codebook)
    lib = _bind("vq_stats")
    (b, d), n, dev = z_e.shape, codebook.shape[0], z_e.device
    plan, scratch_elems, lookup_elems = _plan(lib, "vq_stats", dev, b, n, d)
    buf, ids, scratch = _ids_and_scratch(b, scratch_elems, dev)
    counts = torch.empty(n, dtype=torch.float32, device=dev)
    sums = torch.empty((n, d), dtype=torch.float32, device=dev)
    _launch("K2", lib, "vq_stats", dev,
            [z_e.data_ptr(), codebook.data_ptr(), ids.data_ptr(), counts.data_ptr(),
             sums.data_ptr(), scratch],
            [b, n, d, plan.config, plan.codes_per_split, plan.splits])
    vq_nearest_with_stats_cuda.launches += 1
    start = len(buf) - scratch_elems + lookup_elems  # the sort's scratch starts with it
    order = buf[start:start + b]
    return ids, counts, sums, order


def vq_nearest_with_stats_cuda(z_e: torch.Tensor, codebook: torch.Tensor):
    """Kernel K2 on the card. z_e [B, D], codebook [N, D]: fp32, contiguous,
    on one CUDA device -> (ids [B] int32, counts [N] fp32, sums [N, D] fp32).
    Raises on anything else. The stats are deterministic: each sum adds its
    rows in ascending order.

    ``vq_nearest_with_stats_cuda.launches`` counts the calls that launched
    the kernel.
    """
    return _vq_stats_launch(z_e, codebook)[:3]


vq_nearest_with_stats_cuda.launches = 0


# The three kernels as torch.library ops under the lipvq_tpu_torch namespace:
# the CUDA implementation is the ctypes launch above, on the current stream
# and counted; the CPU implementation is the plain version; the fake one
# gives shapes and dtypes, so torch.export and FlopCounterMode see each op
# as one node. None has a gradient.
def _ids_like(z_e: torch.Tensor) -> torch.Tensor:
    return z_e.new_empty(z_e.shape[0], dtype=torch.int32)


@torch.library.custom_op("lipvq_tpu_torch::vq_nearest", mutates_args=(), device_types="cuda")
def vq_nearest_op(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """K1 (``vq_nearest_cuda``) on CUDA tensors, ``vq_nearest_reference``
    on CPU tensors."""
    return vq_nearest_cuda(z_e, codebook)


@torch.library.custom_op("lipvq_tpu_torch::vq_nearest_fast", mutates_args=(),
                         device_types="cuda")
def vq_nearest_fast_op(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """K1f on CUDA tensors, ``vq_nearest_fast_reference`` on CPU tensors."""
    return vq_nearest_cuda(z_e, codebook, precision="fast")


@torch.library.custom_op("lipvq_tpu_torch::vq_nearest_with_stats", mutates_args=(),
                         device_types="cuda")
def vq_nearest_with_stats_op(z_e: torch.Tensor, codebook: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors, ``vq_nearest_with_stats_reference`` on CPU
    tensors: (ids, counts, sums)."""
    return vq_nearest_with_stats_cuda(z_e, codebook)


vq_nearest_op.register_kernel("cpu")(vq_nearest_reference)
vq_nearest_fast_op.register_kernel("cpu")(vq_nearest_fast_reference)
vq_nearest_with_stats_op.register_kernel("cpu")(vq_nearest_with_stats_reference)
vq_nearest_op.register_fake(lambda z_e, codebook: _ids_like(z_e))
vq_nearest_fast_op.register_fake(lambda z_e, codebook: _ids_like(z_e))
vq_nearest_with_stats_op.register_fake(lambda z_e, codebook: (
    _ids_like(z_e), codebook.new_empty(codebook.shape[0]), codebook.new_empty(codebook.shape)))


def lookup_flops(z_shape, codebook_shape, *args, **kwargs) -> int:
    """K1's and K1f's products: 2 B N D."""
    return 2 * z_shape[0] * codebook_shape[0] * codebook_shape[1]


def stats_flops(z_shape, codebook_shape, *args, **kwargs) -> int:
    """K2: the lookup's 2 B N D, plus B D adds for the sums."""
    return lookup_flops(z_shape, codebook_shape) + z_shape[0] * z_shape[1]


register_flop_formula(torch.ops.lipvq_tpu_torch.vq_nearest)(lookup_flops)
register_flop_formula(torch.ops.lipvq_tpu_torch.vq_nearest_fast)(lookup_flops)
register_flop_formula(torch.ops.lipvq_tpu_torch.vq_nearest_with_stats)(stats_flops)


def vq_nearest(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Dispatching lookup through ``lipvq_tpu_torch::vq_nearest``: K1 on a
    CUDA tensor, the plain reference on a CPU tensor. Inputs are detached
    (the ids are not differentiable), as the JAX dispatcher stop-gradients
    them. No rows (a data-parallel rank that holds none) give no ids and
    launch nothing."""
    if z_e.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=z_e.device)
    return vq_nearest_op(z_e.detach().float().contiguous(),
                         codebook.detach().float().contiguous())


def vq_nearest_fast(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The opt-in fast lookup through ``lipvq_tpu_torch::vq_nearest_fast``:
    K1f on a CUDA tensor, its plain version on a CPU tensor. Inputs are
    detached, as in ``vq_nearest``."""
    return vq_nearest_fast_op(z_e.detach().float().contiguous(),
                              codebook.detach().float().contiguous())


def vq_nearest_with_stats(z_e: torch.Tensor, codebook: torch.Tensor):
    """Dispatching lookup + cluster stats through
    ``lipvq_tpu_torch::vq_nearest_with_stats``: K2 on a CUDA tensor, the
    plain version on a CPU tensor. Inputs are detached (neither ids nor
    stats are differentiated). No rows give zero stats and launch
    nothing."""
    if z_e.shape[0] == 0:
        n, d = codebook.shape
        return (torch.zeros(0, dtype=torch.int32, device=z_e.device),
                torch.zeros(n, device=z_e.device), torch.zeros((n, d), device=z_e.device))
    return vq_nearest_with_stats_op(z_e.detach().float().contiguous(),
                                    codebook.detach().float().contiguous())
