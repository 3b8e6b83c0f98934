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
  and ``plan_fast`` (K1f) pick the tile configuration and code splits (for
  K1 at the corpus's row counts and D <= ``TC_MAX_D`` the tensor-core path,
  whose ids equal the SIMT tiles' bit for bit); the
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
- ``vq_nearest_certified``: the plain version of K1's tensor-core path
  (``csrc/vq_nearest_tc.cuh``): split-precision scores (``tc_split``), the
  bound ``tc_bound``, the per-row certificate over the kernel's lists, and
  K1's own fp32 chain (``k1_chain_distances``) for the rows it cannot settle.
- ``vq_cluster_stats``: the one-hot counts [N] and sums [N, D] of given ids.
- ``vq_nearest_with_stats_reference``: the plain version of K2, the
  reference ids plus their cluster stats.
- ``vq_nearest_with_stats_cuda``: kernel K2 (``csrc/vq_stats.cu``): K1's
  lookup and the stats in one call, deterministic.
- ``vq_nearest_with_stats``: the dispatcher the EMA codebook's training
  forward calls: K2 on a CUDA tensor, the plain version on a CPU tensor.
- Counters, registered with ``utils/profile_utils`` at import: the
  wrappers' launch attributes (``k1_launches``, ``k1f_launches``,
  ``k1_tc_launches``, ``k2_launches``) and the rows K1's tensor-core path
  re-scored exactly (``k1_rescored_rows``, ``k1_rescored_every_code_rows``),
  counted on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.flop_counter import register_flop_formula

from lipvq_tpu_torch.ops import _build
from lipvq_tpu_torch.utils import profile_utils

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


# K1's tensor-core path (csrc/vq_nearest_tc.cuh), in plain PyTorch: the
# lists each row keeps (TC_LISTS of TC_KT entries: code n goes to list
# n % 8 // 2, its thread of the wgmma layout), and the rounding unit
TC_KT, TC_LISTS = 4, 4
_U = 2.0 ** -24


def tc_split(x: torch.Tensor, mu: torch.Tensor):
    """The kernel's split of ``x - mu`` (fp32): (centred, hi, lo, resid)
    with centred = hi + lo + resid exactly, hi and lo bf16 values (round to
    nearest even of what is left), all fp32."""
    centred = x.float() - mu.float()
    hi = centred.bfloat16().float()
    lo = (centred - hi).bfloat16().float()
    return centred, hi, lo, centred - hi - lo


def tc_norms(x: torch.Tensor, mu: torch.Tensor, rows: bool) -> torch.Tensor:
    """The fp64 norms of the kernel's bound: for rows [len(x), 5] ||z||,
    ||w z|| (w_k = D - k), ||zb||, ||zl||, ||rz||; for codes [len(x), 4]
    ||c||, ||cb||, ||cl||, ||rc||."""
    centred, _, lo, resid = tc_split(x, mu)
    out = [x.double(), centred.double(), lo.double(), resid.double()]
    if rows:
        w = torch.arange(x.shape[1], 0, -1, dtype=torch.float64, device=x.device)
        out.insert(1, out[0] * w)
    return torch.stack([t.norm(dim=1) for t in out], 1)


def tc_bound(row_norms: torch.Tensor, code_norms: torch.Tensor, d: int) -> torch.Tensor:
    """E [B, N] in fp64: how far K1's fp32 distance and the split-precision
    score can part, less a constant of the row (``vq_nearest_tc.cuh`` derives
    it): K1's own chain u (2 (||w z|| + ||z||) ||c|| + (ceil(D / 32) + 6)
    ||c||^2), the split's dropped terms, the tensor cores' fp32 sums (2^-16
    of the magnitudes a k16 step), the centring's and the scores' roundings."""
    r = row_norms.double()[:, :, None]
    c = code_norms.double().T[None]
    z_, wz, zb, zl, zr = r[:, 0], r[:, 1], r[:, 2], r[:, 3], r[:, 4]
    c_, cb, cl, cr = c[:, 0], c[:, 1], c[:, 2], c[:, 3]
    e1 = _U * (2.0 * (wz + z_) * c_ + ((d + 31) // 32 + 6) * c_ * c_)
    sq = (zb + 2.0 * zl + zr) * (cb + 2.0 * cl + cr)
    steps = 3 * ((d + 15) // 16)
    e2 = (2.0 * (zl * cl + (zb + zr) * cr + zr * cb) + 2.0 * steps * 2.0 ** -16 * sq
          + 2.0 * _U * (zb + cb) ** 2 + 2.0 * _U * (cb * cb + sq))
    return 1.01 * (e1 + e2) + d * 2.0 ** -80


def _fma_chain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sum_k x_k y_k over the last axis as one fp32 chain in ascending k,
    each step's product and add rounded once (fp64, then fp32: the double
    rounding can differ from a fused add in the last bit about once in 2^29
    steps)."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    x64, y64 = x.double(), y.double()
    for k in range(x.shape[-1]):
        acc = (x64[..., k] * y64[..., k] + acc.double()).float()
    return acc


def k1_code_norms(codebook: torch.Tensor) -> torch.Tensor:
    """cn [N] as K1's code_norms_kernel: 32 lane chains over columns lane,
    lane + 32, ..., then a butterfly of fp32 adds."""
    c = codebook.float()
    n, d = c.shape
    lanes = torch.zeros((n, 32), dtype=torch.float32, device=c.device)
    for lane in range(min(32, d)):
        cols = c[:, lane::32]
        lanes[:, lane] = _fma_chain(cols, cols)
    off = 16
    while off:
        lanes = lanes + lanes[:, torch.arange(32, device=c.device) ^ off]
        off //= 2
    return lanes[:, 0]


def k1_chain_distances(z_e: torch.Tensor, codebook: torch.Tensor, codes: torch.Tensor,
                       cn: torch.Tensor | None = None) -> torch.Tensor:
    """K1's fp32 distances cn[n] - 2 dot(z[b], c[n]) for codes [B, K] of
    each row (each dot one FMA chain in ascending d): [B, K] fp32."""
    cn = k1_code_norms(codebook) if cn is None else cn
    c = codebook.float()[codes.long()]
    dots = _fma_chain(z_e.float()[:, None, :].expand_as(c), c)
    return cn[codes.long()] - 2.0 * dots


def _lowest_of_least(d: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per row the code with the smallest d, the lowest among equals."""
    best = d.min(1, keepdim=True).values
    masked = torch.where(d == best, codes.long(), torch.iinfo(torch.int64).max)
    return masked.min(1).values


def tc_scores(z_e: torch.Tensor, codebook: torch.Tensor):
    """The split-precision scores a [B, N] fp32 (each product sum taken
    exactly, then rounded once: one evaluation the tensor cores' bound
    covers) and mu."""
    c = codebook.float()
    mu = c.mean(0)
    _, zh, zl, _ = tc_split(z_e, mu)
    cb, ch, cl, _ = tc_split(c, mu)
    acc = (zh.double() @ ch.double().T + zl.double() @ ch.double().T
           + zh.double() @ cl.double().T).float()
    cb2 = (cb.double() ** 2).sum(1).float()
    return cb2[None] - 2.0 * acc, mu


def vq_nearest_certified(z_e: torch.Tensor, codebook: torch.Tensor, counts: bool = False):
    """Plain version of K1's tensor-core path: split-precision scores, each
    row's lists (the TC_KT least scores of each of the TC_LISTS lists, and
    the least of the rest; the kernel sorts them as packed keys, a bucket of
    2^-15 of a score wide at 1024 codes, and widens each interval by its
    bucket), the certificate, and K1's fp32 chain over the candidates, or
    over every code where the codes outside the lists are not excluded. Ids
    [B] int32, with ``counts`` also (rows re-scored, of them over every
    code)."""
    z = z_e.float()
    c = codebook.float()
    b, d = z.shape
    n = c.shape[0]
    scores, mu = tc_scores(z, c)
    rn = tc_norms(z, mu, rows=True)
    cnorms = tc_norms(c, mu, rows=False)
    cls = torch.arange(n, device=z.device) % 8 // 2
    vals, codes, rests = [], [], []
    for g in range(TC_LISTS):
        cols = (cls == g).nonzero().flatten()
        if cols.numel() == 0:
            continue
        a, order = scores[:, cols].sort(dim=1, stable=True)
        k = min(TC_KT, cols.numel())
        vals.append(a[:, :k])
        codes.append(cols[order[:, :k]])
        rests.append(a[:, k] if cols.numel() > k else torch.full((b,), float("inf")))
    a = torch.cat(vals, 1).double()
    listed = torch.cat(codes, 1)
    rest = torch.stack(rests, 1).min(1).values.double()
    e_all = tc_bound(rn, cnorms, d)
    e = e_all.gather(1, listed)
    e_max = tc_bound(rn, cnorms.max(0, keepdim=True).values, d)[:, 0]
    top = (a + e).min(1).values
    finite = (rn < 2.0 ** 40).all(1) & bool((cnorms < 2.0 ** 40).all())
    every = ~(finite & (rest - e_max > top))
    cand = ~(a - e > top[:, None])
    ids = torch.empty(b, dtype=torch.int64, device=z.device)
    single = ~every & (cand.sum(1) == 1)
    ids[single] = listed[single][cand[single]]
    cn = k1_code_norms(c)
    several = (~every & ~single).nonzero().flatten()
    if several.numel():
        sub = listed[several]
        dist = k1_chain_distances(z[several], c, sub, cn)
        dist = torch.where(cand[several], dist, torch.tensor(float("inf")))
        ids[several] = _lowest_of_least(dist, sub)
    rows = every.nonzero().flatten()
    if rows.numel():
        allc = torch.arange(n, device=z.device).expand(rows.numel(), n)
        ids[rows] = _lowest_of_least(k1_chain_distances(z[rows], c, allc, cn), allc)
    ids = ids.to(torch.int32)
    if counts:
        return ids, (int(several.numel() + rows.numel()), int(rows.numel()))
    return ids


def vq_nearest_expand(z_e: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Expand-form lookup in plain fp32 PyTorch; ``||z||^2`` dropped, first
    minimum wins (counterpart of ``vq_nearest_xla_expand``)."""
    z = z_e.float()
    c = codebook.float()
    cn = (c * c).sum(-1)
    return torch.argmin(cn[None, :] - 2.0 * (z @ c.T), dim=-1).to(torch.int32)


# tile shapes (rows, codes) of the lookup's configurations, as in
# csrc/vq_nearest_tile.cuh; _declare checks them against the library
LARGE, MEDIUM, SMALL = 0, 1, 2
TILE_SHAPES = {LARGE: (128, 256), MEDIUM: (32, 64), SMALL: (32, 32)}
# K1's tensor-core path (csrc/vq_nearest_tc.cuh): its tile, largest D and N
TC = 3
TC_TILE = (128, 128)
TC_MAX_D = 256
TC_MAX_N = 16384


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


def plan_lookup(b: int, n: int, sms: int, d: int | None = None) -> LookupPlan:
    """The lookup's launch plan for B rows, N codes on a card with ``sms``
    SMs: LARGE when its row tiles alone give every SM two CTAs (the corpus);
    else MEDIUM when its row and code tiles give every SM a CTA (train
    batches), else SMALL (served requests). K1 passes its width ``d``: where
    LARGE would run, d <= ``TC_MAX_D`` and N <= ``TC_MAX_N`` it takes the
    tensor-core path (one code split), whose ids are LARGE's bit for bit. K2
    passes none."""
    def tiles(config):
        rows, codes = TILE_SHAPES[config]
        return -(-b // rows), -(-n // codes)

    if tiles(LARGE)[0] >= 2 * sms:
        if d is not None and d <= TC_MAX_D and n <= TC_MAX_N:
            return _split_codes(TC, TC_TILE, b, n, sms)
        config = LARGE
    elif tiles(MEDIUM)[0] * tiles(MEDIUM)[1] >= sms:
        config = MEDIUM
    else:
        config = SMALL
    return _split_codes(config, TILE_SHAPES[config], b, n, sms)


# K1f's configurations: tile shapes (rows, codes) and the largest D of each,
# as in csrc/vq_nearest_fast.cu; _declare checks them against the library
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


_POINTERS = {"vq_nearest": 5, "vq_nearest_fast": 4, "vq_stats": 6}  # pointer args
_SMS: dict[int, int] = {}
_PLANS: dict[tuple, tuple[LookupPlan, int, int]] = {}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """``_build.load``'s declaration of ``csrc/<name>.cu``: its entry point
    ``<name>_launch`` takes the pointers, six ints (B, N, D, config, codes
    per split, splits), the stream; the tile shapes must be this module's."""
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * _POINTERS[name] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    own = {"vq_nearest": 5, "vq_nearest_fast": 4}.get(name, 3)
    for scratch, ints in ((getattr(lib, f"{name}_scratch_elems"), own),
                          (lib.vq_lookup_scratch_elems, 3)):
        scratch.argtypes = [ctypes.c_int] * ints
        scratch.restype = ctypes.c_size_t
    for config, shape in TILE_SHAPES.items():
        got = (lib.vq_tile_rows(config), lib.vq_tile_codes(config))
        if got != shape:
            raise RuntimeError(f"{name}: tile shape of config {config} is {got} in the "
                               f"library, {shape} in vq_lookup.py")
    if name == "vq_nearest":
        got = (lib.vq_tc_tile_rows(), lib.vq_tc_tile_codes(), lib.vq_tc_max_d(),
               lib.vq_tc_max_n())
        if got != (*TC_TILE, TC_MAX_D, TC_MAX_N):
            raise RuntimeError(f"{name}: the tensor-core tile and largest D and N are "
                               f"{got} in the library, {(*TC_TILE, TC_MAX_D, TC_MAX_N)} "
                               f"in vq_lookup.py")
    if name == "vq_nearest_fast":
        for config, shape in FAST_TILES.items():
            got = (lib.vq_fast_tile_rows(config), lib.vq_fast_tile_codes(config),
                   lib.vq_fast_max_d(config))
            want = (*shape, FAST_WIDE_MAX_D if config == FAST_WIDE else FAST_MAX_D)
            if got != want:
                raise RuntimeError(f"{name}: tile shape and largest D of config {config} "
                                   f"are {got} in the library, {want} in vq_lookup.py")


def _plan(lib: ctypes.CDLL, name: str, dev: torch.device, b: int, n: int, d: int):
    """(plan, scratch elements of ``name``, of which the lookup's come
    first) at this shape, cached per device and shape, with the device's SM
    count cached once."""
    fast = name == "vq_nearest_fast"
    key = (name, dev.index, b, n, d if name != "vq_stats" else None)
    hit = _PLANS.get(key)
    if hit is None:
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
        if fast:
            plan = plan_fast(b, n, d, sms)
            scratch = lib.vq_nearest_fast_scratch_elems(b, n, d, plan.splits)
        elif name == "vq_nearest":
            plan = plan_lookup(b, n, sms, d)
            scratch = lib.vq_nearest_scratch_elems(b, n, d, plan.config, plan.splits)
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
    lib = _build.load(name, _declare)
    plan, scratch_elems, _ = _plan(lib, name, dev, b, n, d)
    tc = not fast and plan.config == TC
    if tc:
        # the ids alone outlive the call: the scratch goes back to the cache
        # once the launch is enqueued (stream-ordered, so no later kernel
        # on this stream can see it reused early)
        ids = torch.empty(b, dtype=torch.int32, device=dev)
        buf = torch.empty(scratch_elems, dtype=torch.int32, device=dev)
        scratch = buf.data_ptr()
    else:
        buf, ids, scratch = _ids_and_scratch(b, scratch_elems, dev)
    ptrs = [z_e.data_ptr(), codebook.data_ptr(), ids.data_ptr(), scratch]
    if not fast:
        ptrs.append(_rescore_counts(dev).data_ptr() if tc else None)
    _build.launch(lib, f"{name}_launch", dev, *ptrs,
                  b, n, d, plan.config, plan.codes_per_split, plan.splits)
    if fast:
        vq_nearest_cuda.fast_launches += 1
    else:
        vq_nearest_cuda.launches += 1
        vq_nearest_cuda.tc_launches += tc
    return ids


vq_nearest_cuda.launches = 0
vq_nearest_cuda.fast_launches = 0
vq_nearest_cuda.tc_launches = 0

# per device: [rows re-scored exactly, of them over every code] by K1's
# tensor-core path, int64, added to by its certify kernel
_RESCORED: dict[int, torch.Tensor] = {}


def _rescore_counts(dev: torch.device) -> torch.Tensor:
    counts = _RESCORED.get(dev.index)
    if counts is None:
        counts = _RESCORED[dev.index] = torch.zeros(2, dtype=torch.int64, device=dev)
    return counts


def rescored_rows() -> dict[int, torch.Tensor]:
    """{device index: [2] int64 on that device}: the rows K1's tensor-core
    path re-scored exactly since the process started, and of them those
    re-scored over every code. Reading them waits for the card."""
    return dict(_RESCORED)


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
    lib = _build.load("vq_stats", _declare)
    (b, d), n, dev = z_e.shape, codebook.shape[0], z_e.device
    plan, scratch_elems, lookup_elems = _plan(lib, "vq_stats", dev, b, n, d)
    buf, ids, scratch = _ids_and_scratch(b, scratch_elems, dev)
    counts = torch.empty(n, dtype=torch.float32, device=dev)
    sums = torch.empty((n, d), dtype=torch.float32, device=dev)
    _build.launch(lib, "vq_stats_launch", dev, z_e.data_ptr(), codebook.data_ptr(),
                  ids.data_ptr(), counts.data_ptr(), sums.data_ptr(), scratch,
                  b, n, d, plan.config, plan.codes_per_split, plan.splits)
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
profile_utils.register({
    "k1_launches": lambda: vq_nearest_cuda.launches,
    "k1f_launches": lambda: vq_nearest_cuda.fast_launches,
    "k2_launches": lambda: vq_nearest_with_stats_cuda.launches,
    "k1_tc_launches": lambda: vq_nearest_cuda.tc_launches,
    "k1_rescored_rows": lambda: {i: t[0] for i, t in _RESCORED.items()},
    "k1_rescored_every_code_rows": lambda: {i: t[1] for i, t in _RESCORED.items()},
})


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
