// K1's tensor-core path: the nearest-code lookup of vq_nearest_tile.cuh with
// its products on wgmma in split precision, a certificate per row, and K1's
// own fp32 chain for what the certificate cannot settle. The ids are those
// of the SIMT tile kernel, bit for bit, on every row.
//
// What the ids must equal. K1 computes d[n] = cn[n] - 2 * dot(z, c[n]) with
// each dot one chain of fp32 FMAs over d ascending and cn[n] from
// code_norms_kernel's chain, and takes the lowest index among the smallest
// d. So its ids are a function of (z, c) alone, whatever the tile.
//
// The approximate scores. With mu the codebook's column means (any vector
// would do; the mean makes the operands small), zb = fl(z - mu) and cb =
// fl(c - mu) are split into bf16 pieces, zb = zh + zl + rz, cb = ch + cl + rc
// (each piece the round-to-nearest of what is left, rz and rc exact in fp32),
// and one wgmma accumulation in fp32 sums zh.ch + zl.ch + zh.cl over the
// depth. The score is a[n] = cb2[n] - 2 acc[n], cb2[n] = ||cb[n]||^2 rounded
// once from fp64.
//
// The bound. For every code, |d[n] - a[n] - s| <= E[n] with s a constant of
// the row (||zb||^2 - ||z||^2). With u = 2^-24, m = ceil(D / 32), the row
// norms Z = ||z||, WZ = ||w z|| (w_k = D - k: K1's chain adds term k into D -
// k partial sums), Zb = ||zb||, Zl = ||zl||, Zr = ||rz|| and the code's C,
// Cb, Cl, Cr likewise (rows summed in fp32, codes in fp64, all rounded up):
//   K1's own error: every FMA rounds its partial sum once, so the dot is off
//     by at most u sum_k |partial_k| <= u WZ C; cn's 32 lane chains and
//     5-level tree by (m + 5) u C^2; the final subtraction by u (C^2 + 2 Z C).
//     E1 = u (2 (WZ + Z) C + (m + 6) C^2).
//   The split's dropped terms: zl.cl + (zh + zl).rc + rz.cb, at most
//     Zl Cl + (Zb + Zr) Cr + Zr Cb (Cauchy-Schwarz), twice for -2 acc.
//   The tensor cores' fp32 sums: each k16 step adds 16 exact products into
//     the accumulator; aligning them to the largest and truncating to fp32
//     loses at most 18 * 2^-23 of their magnitudes. The bound takes 2^-16 a
//     step (7x that), over 3 ceil(D / 16) steps, against the magnitudes'
//     sum sq = (Zb + 2 Zl + Zr) (Cb + 2 Cl + Cr).
//   Centring: fl(z - mu) and fl(c - mu) move ||z - c||^2 by at most
//     2u (Zb + Cb)^2; cb2's and the score's roundings add 2u (Cb^2 + sq).
//   E = 1.01 (E1 + E2) + D 2^-80 (products that underflow), evaluated in
//     fp32 (its dozen roundings lie far inside the 1 %).
// On the lowdim corpus cell's latents (sigmoid outputs within ~0.17 of their
// mean) E is ~8e-4, nearly all K1's own E1, against a median gap of 1.5e-3
// between the two nearest codes. So a top-2 certificate settles under half
// the rows; the kernel keeps short lists instead.
//
// The certificate. For each row, each of the 4 threads that share it in the
// wgmma layout keeps the KT = 4 least scores of its codes, each packed with
// its code in one sortable key (the score's low fraction bits give way to the
// code: the key bounds its score within a bucket of 2^-15 of it at N = 1024),
// and the least key it dropped (rest). reduce_splits_kernel_certify merges
// the 16 entries and 4 rests. With U = min over the entries of a[n] + E[n],
// every code n with a[n] - E[n] > U has d[n] > d[m] for the m that attains
// U, so K1's winner lies among the entries with a[n] - E[n] <= U (the
// candidates), provided every code outside the lists lies above U too: rest
// - E_max > U, E_max the bound at the codebook's largest norms. Intervals
// are rounded outwards.
//   - One candidate: it is K1's id (certified; no fp32 work).
//   - Several: each (row, code) is listed, nearest_tile_kernel_candidates
//     runs K1's exact chain on it (same FMAs, same cn, same expression) and
//     folds (distance, code) into the row's packed 64-bit minimum, so the
//     lowest index among the smallest distances wins.
//   - Outside codes not excluded (rest too close, exact ties beyond the
//     lists, or norms that are not finite or pass 2^40): the row goes on a
//     device list and K1's MEDIUM tile (vq_nearest_tile.cuh) re-scores it
//     over every code, from persistent CTAs that read the count.
// No step waits for the host: the counts stay on the card.
//
// Kernels (each name carries one the roofline reader times):
// code_norms_kernel_center (mu; clears the counts and maxima),
// code_norms_kernel_tc (cn by K1's chain, the split codebook [N][2 Dp] bf16
// for TMA, the code norms and their maxima), nearest_tile_kernel_tc (the
// wgmma pass and the lists), reduce_splits_kernel_certify (the certificate),
// nearest_tile_kernel_candidates, nearest_tile_kernel_rescore (the listed
// rows over every code, in 64-code splits) and reduce_splits_kernel_rescore
// (both kinds of re-scored rows' ids).
//
// nearest_tile_kernel_tc follows K1f's WIDE design (vq_nearest_fast.cu): one
// producer thread streams 64-column boxes of the split codebook by TMA into a
// ring of STAGES buffers; two consumer warpgroups (64 rows each) run
// m64n128k16 wgmma against their rows' zh and zl tiles, which they stage
// once per CTA, rounded and swizzled, while summing the row norms (one warp
// a row). A ch box feeds two wgmma (zh and zl), a cl box one. The z tiles
// take 4 BM Dp bytes, so D <= MAX_D (256). Measured on an H100 at a 2^16-row
// chunk of the corpus latents (PERF.md): the wgmma pass ~0.11 ms of the
// kernel's 0.23, the fold of the lists ~0.08, the staging ~0.05. Tried and
// slower there: two warpgroups taking turns on separate code tiles (each
// then has half the ring), folding tile t - 1 in slices between tile t's
// wgmma (from a second accumulator or a copy: twice as slow), a window
// filter in place of the sorted lists (divergent), 64-row CTAs two to an SM
// (twice the codebook traffic).

#pragma once


#include "sm90_ptx.cuh"
#include "vq_nearest_tile.cuh"

namespace vqtc {

using namespace sm90;

constexpr int BM = 128;                   // rows of a CTA: two warpgroups x m64
constexpr int BN = 128;                   // codes of a tile: the wgmma N
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 32;   // + one producer warp
constexpr int STAGES = 6;                 // ring buffers, one 64-column box each
constexpr int BOX_COLS = 64;              // bf16 columns of a 128-byte swizzled row
constexpr int STAGE_BYTES = BN * 128;
constexpr int KT = 4;                     // list entries a thread keeps per row
constexpr int LISTS = 4;                  // threads sharing a row in the wgmma layout
constexpr int ENTRIES = LISTS * KT;
constexpr int ROW_NORMS = 5, CODE_NORMS = 4;
constexpr int SMEM_LIMIT = 232448;        // dynamic shared memory of one CTA
constexpr int FULL_SPLIT_CODES = 64;      // the every-code re-scoring's code split
using Full = vq::Medium;                  // and its tile

__host__ __device__ constexpr int padded_d(int d) { return (d + BOX_COLS - 1) / BOX_COLS * BOX_COLS; }
__host__ __device__ constexpr int k_depth(int d) { return (d + 15) / 16 * 16; }
constexpr size_t smem_bytes(int d) {  // z tiles, ring, barriers
  return 4ull * BM * padded_d(d) + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
}
constexpr int MAX_D =
    (SMEM_LIMIT - STAGES * STAGE_BYTES - 2 * STAGES * 8) / (4 * BM) / BOX_COLS * BOX_COLS;
static_assert(MAX_D == 256, "the wrapper's TC_MAX_D");
static_assert(ENTRIES <= 32, "a row's candidates are one 32-bit mask");
static_assert(FULL_SPLIT_CODES % Full::BN == 0, "whole tiles a split");

// The path's scratch, carved from one 16-byte-aligned block (4-byte elements).
struct Scratch {
  float* cn;             // [N] K1's code norms
  float* part_d;         // [full_splits][B] the every-code re-scoring's partials
  int* part_i;
  float* mu;             // [D]
  float* code_norms;     // [CODE_NORMS + 1][n4]: C, Cb, Cl, Cr, cb2
  unsigned* ctl;         // [8]: maxima of C, Cb, Cl, Cr (float bits), listed rows,
                         // candidate items
  float* row_norms;      // [ROW_NORMS][B]: Z, WZ, Zb, Zl, Zr
  unsigned* list_key;    // [ENTRIES][B] packed (score, code) keys
  unsigned* rest;        // [LISTS][B] the least key each list dropped
  int* rows;             // [B] the rows re-scored over every code
  int* item_row;         // [ENTRIES][B] the candidates to re-score: row
  int* item_code;        //   and code
  unsigned long long* key;  // [B] a row's least (distance, code), packed
  __nv_bfloat16* cb;     // [N][2 Dp]: ch, then cl, zero past D; 128-byte aligned
  size_t n4;
};

inline int full_splits(int N) { return (N + FULL_SPLIT_CODES - 1) / FULL_SPLIT_CODES; }

inline Scratch carve(void* base, int B, int N, int D) {
  using vq::align4;
  Scratch s;
  float* p = static_cast<float*>(base);
  const size_t b4 = align4(B), parts = align4(static_cast<size_t>(full_splits(N)) * B);
  s.n4 = align4(N);
  s.cn = p;                                   p += s.n4;
  s.part_d = p;                               p += parts;
  s.part_i = reinterpret_cast<int*>(p);       p += parts;
  s.mu = p;                                   p += align4(D);
  s.code_norms = p;                           p += (CODE_NORMS + 1) * s.n4;
  s.ctl = reinterpret_cast<unsigned*>(p);     p += 8;
  s.row_norms = p;                            p += ROW_NORMS * b4;
  s.list_key = reinterpret_cast<unsigned*>(p);  p += static_cast<size_t>(ENTRIES) * b4;
  s.rest = reinterpret_cast<unsigned*>(p);      p += static_cast<size_t>(LISTS) * b4;
  s.rows = reinterpret_cast<int*>(p);         p += b4;
  s.item_row = reinterpret_cast<int*>(p);     p += static_cast<size_t>(ENTRIES) * b4;
  s.item_code = reinterpret_cast<int*>(p);    p += static_cast<size_t>(ENTRIES) * b4;
  s.key = reinterpret_cast<unsigned long long*>(p);  p += 2 * b4;
  const uintptr_t cb = (reinterpret_cast<uintptr_t>(p) + 127) & ~static_cast<uintptr_t>(127);
  s.cb = reinterpret_cast<__nv_bfloat16*>(cb);
  return s;
}

inline size_t scratch_elems(int B, int N, int D) {
  Scratch s = carve(nullptr, B, N, D);
  return reinterpret_cast<uintptr_t>(s.cb) / 4 + static_cast<size_t>(N) * padded_d(D) + 32;
}

// A norm from its fp32 sum of squares, rounded up: 2^-10 covers the sum's
// rounding (at most ceil(D / 8) + 5 adds), D 2^-149 squares that underflow.
__device__ __forceinline__ float norm_up(float sum_sq, int D) {
  return __fsqrt_ru(__fmaf_ru(sum_sq, 1.0f + 0x1p-10f, D * 0x1p-149f));
}

// The codebook's norms are summed in fp64 (once per lookup, one warp a code)
// and stored as fp32 rounded up.
__device__ __forceinline__ float norm_up(double sum_sq) {
  return __double2float_ru(sqrt(sum_sq) * (1.0 + 0x1p-40));
}

template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Split {
  float centred, lo, resid;
  __nv_bfloat16 h, l;
};

__device__ __forceinline__ Split split(float x, float m) {
  Split s;
  s.centred = x - m;
  s.h = __float2bfloat16_rn(s.centred);
  const float r1 = s.centred - __bfloat162float(s.h);  // exact
  s.l = __float2bfloat16_rn(r1);
  s.lo = __bfloat162float(s.l);
  s.resid = r1 - s.lo;                                 // exact
  return s;
}

// mu[d] = column means of c (a fixed order: 32 warps, then one warp over
// their sums), and the counter and maxima cleared. ceil(D / 32) blocks of
// 1024 threads.
__global__ void __launch_bounds__(1024)
code_norms_kernel_center(const float* __restrict__ c, int N, int D, float* __restrict__ mu,
                         unsigned* __restrict__ ctl) {
  __shared__ float red[32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < D)
    for (int n = warp; n < N; n += 32) s += c[static_cast<size_t>(n) * D + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = 0.f;
    for (int w = 0; w < 32; ++w) t += red[w][lane];
    mu[col] = t / static_cast<float>(N);
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) ctl[threadIdx.x] = 0u;
}

// One warp a code: cn by code_norms_kernel's chain (bit for bit), the split
// of c - mu into the bf16 copy, the code's norms and their maxima.
__global__ void code_norms_kernel_tc(const float* __restrict__ c, int N, int D,
                                     const float* __restrict__ mu, float* __restrict__ cn,
                                     float* __restrict__ code_norms, size_t n4,
                                     unsigned* __restrict__ ctl, __nv_bfloat16* __restrict__ cb) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const int dp = padded_d(D);
  const float* row = c + static_cast<size_t>(n) * D;
  __nv_bfloat16* hi = cb + static_cast<size_t>(n) * 2 * dp;
  __nv_bfloat16* lo = hi + dp;
  float s = 0.f;
  double sc = 0.0, sb = 0.0, sl = 0.0, sr = 0.0;
  for (int k = lane; k < dp; k += 32) {
    const float x = k < D ? row[k] : 0.f;
    if (k < D) s = fmaf(x, x, s);
    const Split p = split(x, k < D ? mu[k] : 0.f);
    hi[k] = p.h;
    lo[k] = p.l;
    sc += static_cast<double>(x) * x;
    sb += static_cast<double>(p.centred) * p.centred;
    sl += static_cast<double>(p.lo) * p.lo;
    sr += static_cast<double>(p.resid) * p.resid;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  sc = warp_sum(sc);
  sb = warp_sum(sb);
  sl = warp_sum(sl);
  sr = warp_sum(sr);
  if (lane == 0) {
    cn[n] = s;
    const float v[CODE_NORMS] = {norm_up(sc), norm_up(sb), norm_up(sl), norm_up(sr)};
#pragma unroll
    for (int i = 0; i < CODE_NORMS; ++i) {
      code_norms[i * n4 + n] = v[i];
      atomicMax(ctl + i, __float_as_uint(v[i]));  // non-negative floats order as their bits
    }
    code_norms[CODE_NORMS * n4 + n] = static_cast<float>(sb);
  }
}

// E for a row's norms against a code's (see the top of this file), in fp32:
// its dozen roundings are far inside the 1 % added.
__device__ __forceinline__ float bound(const float (&r)[ROW_NORMS], float C, float Cb, float Cl,
                                       float Cr, int D) {
  const float u = 0x1p-24f;
  const float m = (D + 31) / 32;
  const float Z = r[0], WZ = r[1], Zb = r[2], Zl = r[3], Zr = r[4];
  const float e1 = u * (2.f * (WZ + Z) * C + (m + 6.f) * C * C);
  const float sq = (Zb + 2.f * Zl + Zr) * (Cb + 2.f * Cl + Cr);
  const float steps = 3 * ((D + 15) / 16);
  const float e2 = 2.f * (Zl * Cl + (Zb + Zr) * Cr + Zr * Cb) + 2.f * steps * 0x1p-16f * sq +
                   2.f * u * (Zb + Cb) * (Zb + Cb) + 2.f * u * (Cb * Cb + sq);
  return 1.01f * (e1 + e2) + D * 0x1p-80f;
}

// The CTA's rows of z, centred and split, into the zh and zl tiles (K1f's
// swizzled layout: 16-byte chunk q of row r at (q / 8 * BM + r) * 128 +
// ((q % 8) ^ (r % 8)) * 16), zero past D and past B; one warp a row, lane q
// its chunk q (D <= 256: one chunk a lane), eight rows' loads in flight; the
// row norms summed in fp32 and written for rows below B.
__device__ __forceinline__ void stage_rows(const float* __restrict__ z,
                                           const float* __restrict__ mu, int B, int D,
                                           int row0, uint8_t* zh, uint8_t* zl,
                                           float* __restrict__ row_norms) {
  constexpr int WARPS = CONSUMERS / 32, UNROLL = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = lane * 8;
  const bool active = col < k_depth(D);
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0 && col + 8 <= D;
  float m[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m[e] = col + e < D ? __ldg(mu + col + e) : 0.f;
  for (int r0 = warp; r0 < BM; r0 += WARPS * UNROLL) {
    float v[UNROLL][8];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int gr = row0 + r0 + u * WARPS;
      const bool ok = active && gr < B;
      const float* src = z + static_cast<size_t>(ok ? gr : 0) * D + col;
      if (ok && vec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
        v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
        v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = ok && col + e < D ? __ldg(src + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * WARPS;
      float s[ROW_NORMS] = {0.f, 0.f, 0.f, 0.f, 0.f};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const Split a = split(v[u][e], m[e]), b = split(v[u][e + 1], m[e + 1]);
        __nv_bfloat162 hh, ll;
        hh.x = a.h; hh.y = b.h;
        ll.x = a.l; ll.y = b.l;
        h[e / 2] = *reinterpret_cast<const uint32_t*>(&hh);
        l[e / 2] = *reinterpret_cast<const uint32_t*>(&ll);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const Split& q = i ? b : a;
          const float x = v[u][e + i], w = static_cast<float>(D - col - e - i) * x;
          s[0] = fmaf(x, x, s[0]);
          s[1] = fmaf(w, w, s[1]);
          s[2] = fmaf(q.centred, q.centred, s[2]);
          s[3] = fmaf(q.lo, q.lo, s[3]);
          s[4] = fmaf(q.resid, q.resid, s[4]);
        }
      }
      if (active) {
        const size_t at = (static_cast<size_t>(lane / 8) * BM + r) * 128 + (((lane & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(zh + at) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(zl + at) = make_uint4(l[0], l[1], l[2], l[3]);
      }
#pragma unroll
      for (int i = 0; i < ROW_NORMS; ++i) s[i] = warp_sum(s[i]);
      const int gr = row0 + r;
      if (lane < ROW_NORMS && gr < B) {
        float mine = s[0];
#pragma unroll
        for (int i = 1; i < ROW_NORMS; ++i) mine = lane == i ? s[i] : mine;
        row_norms[static_cast<size_t>(lane) * B + gr] = norm_up(mine, D);
      }
    }
  }
}

// A score and its code in one unsigned key whose order is the scores': the
// float's bits made monotone, the low bits (idx_mask) replaced by the code's
// place among the thread's codes (tile, j, e; its lane's share of the tile
// is implied). 5 bits for j and e and enough for the tiles: 8 bits at N =
// 1024, so a key keeps 15 of the score's 23 fraction bits. A key stands for
// its whole bucket of scores: certify bounds the score by the bucket's ends.
constexpr int MAX_N = 128 * BN;  // 7 tile bits at most: 16384 codes

__host__ __device__ inline unsigned idx_mask(int N) {
  int tile_bits = 0;
  while ((1 << tile_bits) * BN < N) ++tile_bits;
  return (1u << (5 + tile_bits)) - 1;
}

__device__ __forceinline__ unsigned monotone(float a) {
  const unsigned u = __float_as_uint(a);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float unmonotone(unsigned o) {
  return __uint_as_float(o ^ ((o >> 31) ? 0x80000000u : 0xffffffffu));
}

// The code of list `list`'s key: its tile, j and e, and the list's lane.
__device__ __forceinline__ int entry_code(unsigned key, int list, unsigned mask) {
  const unsigned idx = key & mask;
  return static_cast<int>(idx >> 5) * BN + 8 * static_cast<int>(idx >> 1 & 15) + 2 * list +
         static_cast<int>(idx & 1);
}

// Insert key k into a sorted list of KT; what falls out (or k itself)
// lowers rest.
__device__ __forceinline__ void keep(unsigned k, unsigned (&v)[KT], unsigned& rest) {
#pragma unroll
  for (int s = 0; s < KT; ++s) {
    const unsigned lo = min(k, v[s]);
    k = max(k, v[s]);
    v[s] = lo;
  }
  rest = min(rest, k);
}

__global__ void __launch_bounds__(THREADS, 1)
nearest_tile_kernel_tc(const __grid_constant__ CUtensorMap hmap,
                       const __grid_constant__ CUtensorMap lmap, const float* __restrict__ z,
                       const float* __restrict__ mu, const float* __restrict__ cb2, int B,
                       int N, int D, float* __restrict__ row_norms,
                       unsigned* __restrict__ list_key, unsigned* __restrict__ rest_out) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  uint8_t* smem = tc_smem;
  const int kblocks = (k_depth(D) + BOX_COLS - 1) / BOX_COLS;
  const int ksteps = k_depth(D) / 16;
  const size_t tile_bytes = static_cast<size_t>(padded_d(D) / BOX_COLS) * BM * 128;
  uint8_t* zh = smem;
  uint8_t* zl = smem + tile_bytes;
  uint8_t* ring = zl + tile_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  const uint32_t ring_u32 = smem_u32(ring), zh_u32 = smem_u32(zh), zl_u32 = smem_u32(zl);
  const uint32_t full_u32 = smem_u32(bars), empty_u32 = full_u32 + STAGES * 8;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int tiles = (N + BN - 1) / BN;
  const unsigned mask = idx_mask(N);

  if (tid == 0) {
    if (zh_u32 & 1023) __trap();  // the swizzle atoms need a 1024-byte aligned base
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_u32 + 8 * s, 1);
      mbar_init(empty_u32 + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: per code tile and 64-column block, the ch box then the cl box
    if (tid == CONSUMERS) {
      int stage = 0, phase = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int kb = 0; kb < kblocks; ++kb) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            mbar_wait(empty_u32 + 8 * stage, phase ^ 1);
            mbar_expect_tx(full_u32 + 8 * stage, STAGE_BYTES);
            tma_load_2d(ring_u32 + stage * STAGE_BYTES, half ? &lmap : &hmap,
                        full_u32 + 8 * stage, kb * BOX_COLS, t * BN);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  stage_rows(z, mu, B, D, row0, zh, zl, row_norms);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");  // consumers only

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  float acc[BN / 2];
  unsigned best[2][KT], rest[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rest[h] = ~0u;
#pragma unroll
    for (int k = 0; k < KT; ++k) best[h][k] = ~0u;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  const uint32_t a_h = zh_u32 + wg * 64 * 128, a_l = zl_u32 + wg * 64 * 128;
  int stage = 0, phase = 0, held = -1;
  for (int t = 0; t < tiles; ++t) {
    for (int kb = 0; kb < kblocks; ++kb) {
      const int steps = min(4, ksteps - 4 * kb);
      const uint32_t a_off = kb * BM * 128;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // a ch box feeds zh.ch and zl.ch, a cl box zh.cl
        mbar_wait(full_u32 + 8 * stage, phase);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks < steps) {
            const uint64_t b = smem_desc(ring_u32 + stage * STAGE_BYTES + 32 * ks);
            wgmma<BN>(acc, smem_desc(a_h + a_off + 32 * ks), b, (half | kb | ks) != 0);
            if (half == 0) wgmma<BN>(acc, smem_desc(a_l + a_off + 32 * ks), b, 1);
          }
        }
        wgmma_commit();
        // the previous box's group is done: its buffer goes back
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(empty_u32 + 8 * held);
        held = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
    if (lane == 0) mbar_arrive(empty_u32 + 8 * held);
    held = -1;

    // fold the tile: acc[4j + 2h + e] is row 16 warp + lane / 4 + 8h of the
    // warpgroup's rows, code 8j + 2 (lane % 4) + e of the tile; a code past
    // N keys as ~0 (empty)
    const int nb = t * BN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nb + 8 * j + e;
        const bool real = n < N;
        const float cnn = real ? __ldg(cb2 + n) : 0.f;
        const unsigned idx = static_cast<unsigned>(t << 5 | j << 1 | e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned k =
              real ? (monotone(fmaf(-2.f, acc[4 * j + 2 * h + e], cnn)) & ~mask) | idx : ~0u;
          keep(k, best[h], rest[h]);
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = row0 + wg * 64 + warp * 16 + lane / 4 + 8 * h;
    if (gr < B) {
      const int list = lane & 3;
#pragma unroll
      for (int k = 0; k < KT; ++k) list_key[static_cast<size_t>(list * KT + k) * B + gr] = best[h][k];
      rest_out[static_cast<size_t>(list) * B + gr] = rest[h];
    }
  }
}

// K1's distance of one code, bit for bit: the same FMAs in the same order as
// the tile kernel's chain, then the same cn - 2 * dot; z and c read in
// blocks whose loads are in flight together.
__device__ __forceinline__ float k1_distance(const float* __restrict__ zr,
                                             const float* __restrict__ cr, float cnn, int D,
                                             bool vec) {
  constexpr int BLOCK = 13;  // float4 a block: D = 208 in 4
  float acc = 0.f;
  int k = 0;
  if (vec) {
    for (; k + 4 * BLOCK <= D; k += 4 * BLOCK) {
      float4 a[BLOCK], b[BLOCK];
#pragma unroll
      for (int i = 0; i < BLOCK; ++i) {
        a[i] = __ldg(reinterpret_cast<const float4*>(zr + k) + i);
        b[i] = __ldg(reinterpret_cast<const float4*>(cr + k) + i);
      }
#pragma unroll
      for (int i = 0; i < BLOCK; ++i) {
        acc = fmaf(a[i].x, b[i].x, acc);
        acc = fmaf(a[i].y, b[i].y, acc);
        acc = fmaf(a[i].z, b[i].z, acc);
        acc = fmaf(a[i].w, b[i].w, acc);
      }
    }
  }
  for (; k < D; ++k) acc = fmaf(__ldg(zr + k), __ldg(cr + k), acc);
  return cnn - 2.f * acc;
}

// (distance, code) packed so that the unsigned order is K1's: the smaller
// distance, then the lower code (distances here are never NaN or -0).
__device__ __forceinline__ unsigned long long pack(float d, int n) {
  const unsigned u = __float_as_uint(d);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<unsigned>(n);
}

// One thread a row: merge the lists and certify. A row with one candidate
// gets its id; one with several lists each (row, code) for
// nearest_tile_kernel_candidates and starts its key at the top; one whose
// outside codes are not excluded is listed for the every-code re-scoring.
// counters[0] += rows re-scored (either way), counters[1] += rows re-scored
// over every code.
__global__ void __launch_bounds__(256)
reduce_splits_kernel_certify(const float* __restrict__ code_norms, size_t n4,
                             unsigned* __restrict__ ctl, const float* __restrict__ row_norms,
                             const unsigned* __restrict__ list_key,
                             const unsigned* __restrict__ rest_in, int B, int N, int D,
                             int* __restrict__ ids, int* __restrict__ rows,
                             int* __restrict__ item_row, int* __restrict__ item_code,
                             unsigned long long* __restrict__ key,
                             unsigned long long* __restrict__ counters) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned mask = idx_mask(N);
  bool every = false;
  unsigned cand = 0;
  if (r < B) {
    float rn[ROW_NORMS];
    bool finite = true;
#pragma unroll
    for (int i = 0; i < ROW_NORMS; ++i) {
      rn[i] = row_norms[static_cast<size_t>(i) * B + r];
      finite = finite && rn[i] < 0x1p40f;  // false for inf and NaN
    }
    float cmax[CODE_NORMS];
#pragma unroll
    for (int i = 0; i < CODE_NORMS; ++i) {
      cmax[i] = __uint_as_float(ctl[i]);
      finite = finite && cmax[i] < 0x1p40f;
    }
    const float e_max = bound(rn, cmax[0], cmax[1], cmax[2], cmax[3], D);
    // the entries' score intervals [a - E, a + E], rounded outwards; U the
    // least upper end
    float lo[ENTRIES];
    int code[ENTRIES];
    float top = CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < ENTRIES; ++k) {
      const unsigned key = list_key[static_cast<size_t>(k) * B + r];
      lo[k] = CUDART_INF_F;
      code[k] = entry_code(key, k / KT, mask);
      if (key != ~0u) {
        const int n = code[k];
        const float e = bound(rn, code_norms[n], code_norms[n4 + n], code_norms[2 * n4 + n],
                              code_norms[3 * n4 + n], D);
        lo[k] = __fsub_rd(unmonotone(key & ~mask), e);
        top = fminf(top, __fadd_ru(unmonotone(key | mask), e));
      }
    }
    unsigned rest_key = ~0u;
#pragma unroll
    for (int k = 0; k < LISTS; ++k) rest_key = min(rest_key, rest_in[static_cast<size_t>(k) * B + r]);
    const float rest = rest_key == ~0u ? CUDART_INF_F : unmonotone(rest_key & ~mask);
    every = !(finite && __fsub_rd(rest, e_max) > top);
#pragma unroll
    for (int k = 0; k < ENTRIES; ++k) cand |= (lo[k] <= top ? 1u : 0u) << k;
    if (every) {
      cand = 0;
      rows[atomicAdd(ctl + 4, 1u)] = r;
    } else if (__popc(cand) == 1) {
#pragma unroll
      for (int k = 0; k < ENTRIES; ++k)
        if (cand >> k & 1u) ids[r] = code[k];
      cand = 0;
    }
    key[r] = cand ? ~0ull : 0ull;
  }
  // the warp's candidates take one run of the item list
  const int mine = __popc(cand);
  int before = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, before, off);
    if (lane >= off) before += v;
  }
  const int total = __shfl_sync(0xffffffffu, before, 31);
  before -= mine;
  int base = 0;
  if (lane == 0 && total > 0) base = static_cast<int>(atomicAdd(ctl + 5, static_cast<unsigned>(total)));
  base = __shfl_sync(0xffffffffu, base, 0) + before;
  while (cand) {
    const int k = __ffs(cand) - 1;
    cand &= cand - 1;
    item_row[base] = r;
    item_code[base] = entry_code(list_key[static_cast<size_t>(k) * B + r], k / KT, mask);
    ++base;
  }
  const unsigned n_rescored = __popc(__ballot_sync(0xffffffffu, mine > 0 || every));
  const unsigned n_every = __popc(__ballot_sync(0xffffffffu, every));
  if (lane == 0 && n_rescored > 0) {
    atomicAdd(counters, static_cast<unsigned long long>(n_rescored));
    if (n_every > 0) atomicAdd(counters + 1, static_cast<unsigned long long>(n_every));
  }
}

// One thread a listed (row, code): K1's distance, folded into the row's key.
__global__ void __launch_bounds__(256)
nearest_tile_kernel_candidates(const float* __restrict__ z, const float* __restrict__ c,
                               const float* __restrict__ cn, const unsigned* __restrict__ count,
                               const int* __restrict__ item_row,
                               const int* __restrict__ item_code, int D,
                               unsigned long long* __restrict__ key) {
  const int items = static_cast<int>(*count);
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < items; i += gridDim.x * blockDim.x) {
    const int r = item_row[i], n = item_code[i];
    const float d = k1_distance(z + static_cast<size_t>(r) * D, c + static_cast<size_t>(n) * D,
                                cn[n], D, vec);
    atomicMin(key + r, pack(d, n));
  }
}

// The listed rows over every code: K1's MEDIUM tile through the row list,
// persistent CTAs walking (row tile, code split) items up to the count.
__global__ void __launch_bounds__(Full::THREADS, Full::MIN_BLOCKS)
nearest_tile_kernel_rescore(const float* __restrict__ z, const float* __restrict__ c,
                            const float* __restrict__ cn, const unsigned* __restrict__ count,
                            const int* __restrict__ rows, int B, int N, int D, int splits,
                            float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float tile_smem[];
  const int listed = static_cast<int>(*count);
  const int items = (listed + Full::BM - 1) / Full::BM * splits;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    __syncthreads();  // the previous item's buffers are free
    vq::tile_lookup<Full, true>(z, c, cn, listed, N, D, FULL_SPLIT_CODES, item / splits,
                                item % splits, false, rows, B, nullptr, part_d, part_i, tile_smem);
  }
}

// Thread i: the i-th listed row's ids from its code splits (K1's tie rule,
// in split order), and row i's id from its key where it had candidates.
__global__ void reduce_splits_kernel_rescore(const float* __restrict__ part_d,
                                             const int* __restrict__ part_i,
                                             const unsigned* __restrict__ count,
                                             const int* __restrict__ rows,
                                             const unsigned long long* __restrict__ key, int B,
                                             int splits, int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const unsigned long long k = key[i];
  if (k != 0ull) ids[i] = k == ~0ull ? 0 : static_cast<int>(k & 0xffffffffu);
  if (i >= static_cast<int>(*count)) return;
  float d = part_d[i];
  int idx = part_i[i];
  for (int s = 1; s < splits; ++s) {
    const float od = part_d[static_cast<size_t>(s) * B + i];
    const int oi = part_i[static_cast<size_t>(s) * B + i];
    if (vq::better(od, oi, d, idx)) {
      d = od;
      idx = oi;
    }
  }
  ids[rows[i]] = idx == INT_MAX ? 0 : idx;
}

inline cudaError_t encode(CUtensorMap* map, const __nv_bfloat16* base, int N, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSymbolNotFound;
  // columns past Dk are zero-filled by the TMA unit and not read
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(max(k_depth(D), BOX_COLS)),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(padded_d(D)) * 2 * 2};
  const cuuint32_t box[2] = {BOX_COLS, BN};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(base), dims,
            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Enqueue the path on `s`: z [B, D], c [N, D] fp32, ids [B] int32, contiguous
// on the current device, D <= MAX_D; scratch of scratch_elems(B, N, D)
// 4-byte elements, 16-byte aligned; counters [2] int64 on the device, added
// to. Returns the first cudaError_t.
inline cudaError_t launch(const float* z, const float* c, int* ids, void* scratch,
                          unsigned long long* counters, int B, int N, int D, cudaStream_t s) {
  if (D < 1 || D > MAX_D || N > MAX_N || counters == nullptr) return cudaErrorInvalidValue;
  const Scratch w = carve(scratch, B, N, D);
  CUtensorMap hmap, lmap;
  cudaError_t err = encode(&hmap, w.cb, N, D);
  if (err == cudaSuccess) err = encode(&lmap, w.cb + padded_d(D), N, D);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const size_t smem = smem_bytes(D);
  if ((err = cudaFuncSetAttribute(nearest_tile_kernel_tc,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess ||
      (err = cudaFuncSetAttribute(nearest_tile_kernel_rescore,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(Full::SMEM))) != cudaSuccess)
    return err;

  code_norms_kernel_center<<<(D + 31) / 32, 1024, 0, s>>>(c, N, D, w.mu, w.ctl);
  code_norms_kernel_tc<<<(N + 7) / 8, 256, 0, s>>>(c, N, D, w.mu, w.cn, w.code_norms, w.n4,
                                                   w.ctl, w.cb);
  nearest_tile_kernel_tc<<<(B + BM - 1) / BM, THREADS, smem, s>>>(
      hmap, lmap, z, w.mu, w.code_norms + CODE_NORMS * w.n4, B, N, D, w.row_norms, w.list_key,
      w.rest);
  reduce_splits_kernel_certify<<<(B + 255) / 256, 256, 0, s>>>(
      w.code_norms, w.n4, w.ctl, w.row_norms, w.list_key, w.rest, B, N, D, ids, w.rows,
      w.item_row, w.item_code, w.key, counters);
  nearest_tile_kernel_candidates<<<8 * sms, 256, 0, s>>>(z, c, w.cn, w.ctl + 5, w.item_row,
                                                          w.item_code, D, w.key);
  const int splits = full_splits(N);
  nearest_tile_kernel_rescore<<<2 * sms, Full::THREADS, Full::SMEM, s>>>(
      z, c, w.cn, w.ctl + 4, w.rows, B, N, D, splits, w.part_d, w.part_i);
  reduce_splits_kernel_rescore<<<(B + 255) / 256, 256, 0, s>>>(
      w.part_d, w.part_i, w.ctl + 4, w.rows, w.key, B, splits, ids);
  return cudaGetLastError();
}

}  // namespace vqtc
