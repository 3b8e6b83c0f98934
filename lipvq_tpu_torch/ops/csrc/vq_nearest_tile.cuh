// The nearest-code lookup shared by K1 (vq_nearest.cu) and K2 (vq_stats.cu).
//
// Replaces the lookup of the Pallas kernels of lipvq_tpu/ops/vq_lookup.py
// (_make_vq_kernel, launched by vq_nearest_pallas, and the lookup half of
// _vq_stats_kernel). For every row b of z [B, D] it computes
//
//     ids[b] = argmin_n ( cn[n] - 2 * dot(z[b], c[n]) ),   cn[n] = ||c[n]||^2
//
// with ||z||^2 dropped (constant per row) and the lowest index winning ties,
// as torch.argmin and the Pallas kernels do.
//
// Numerics. Every dot product is one chain of fp32 FMAs over d ascending,
// starting from 0, then cn - 2 * dot: no TF32, no bf16, no split over D.
// The ids are therefore a function of (z, c) alone, whatever the tile. K1's
// tensor-core path (vq_nearest_tc.cuh) returns these same ids: it scores
// every code in split precision on wgmma, certifies each row's winner
// against a proven bound that covers this chain's own fp32 error, and runs
// this chain (tile_lookup below, or its per-code form) wherever the bound
// cannot decide. Each thread keeps
// a strict-< running minimum over its codes in ascending order; threads,
// warps and code splits then reduce (dist, idx) lexicographically, so the
// result is the lowest index among the smallest distances. cn[n] is one
// warp's sum of fmaf(c, c) over lane-strided columns folded by a fixed
// shuffle tree: deterministic, computed on the stream before the tile kernel.
//
// Bound. 2*B*N*D fp32 operations against (B + N)*D*4 bytes: at every shape
// the port uses (served 160 x 1024 x 791, train 500 x 1024 x 791, corpus
// 2^20 x 1024 x 208) the fp32 SIMT rate of the card bounds it, not memory.
// What keeps a SIMT kernel from that rate: the shared-memory pipe (a warp's
// 16-byte shared load holds it 4 cycles), the issue slots of everything
// that is not an FMA, and at small B the latency that few warps expose.
//
// Design. A CTA owns BM rows of z and walks its range of codes in tiles of
// BN, streaming BK columns of both operands at a time through a ring of
// STAGES shared-memory buffers filled by cp.async, so the copies of the next
// slices run under the FMAs of this one; the (code tile, column slice) steps
// form one flat pipeline, so it does not drain between code tiles. The
// buffers are k-major ([BK][BM + 4]) so that each thread reads its operand
// fragments as float4: with 8 x 16 outputs per thread that is 6 shared loads
// of 16 bytes per 128 FMAs. A warp is 4 x 8 threads; each thread's rows are
// runs of 4 at lanes 0..3 x 4 plus multiples of 16, its codes runs of 4 at
// 0..7 x 4 plus multiples of 32, so a warp's fragment loads are broadcasts
// of 64 or 128 contiguous bytes: no bank conflicts. The +4 padding keeps
// float4 alignment and makes the k-strided cp.async writes at most 2-way
// conflicted.
//
// The copies are 4 bytes each. A 16-byte copy moves 4 columns of one row,
// which in a k-major buffer land 4 strides apart, so 16-byte copies would
// need a row-major buffer and scalar fragment loads; at D = 791 a row's
// stride (3164 bytes) is not a multiple of 16 either. Out-of-range elements
// are zero-filled by the copy (src-size 0): an FMA with 0 leaves a sum
// unchanged, so any B, N, D >= 1 works without padding in memory.
//
// Three configurations, picked by the wrapper (plan_lookup in vq_lookup.py),
// chosen from the timings of ops/tile_variants.py on the H100:
//   LARGE (config 0): 128 x 256 tile, 8 x 16 per thread, 256 threads, BK
//     16, 3 stages (77 KB), ~235 registers, one CTA per SM. For B whose row
//     tiles alone give every SM two CTAs (the corpus: 8192 CTAs). With 8 x 8
//     per thread (4 shared loads per 64 FMAs) the shared-memory pipe is as
//     busy as the FMA units at full rate; 8 x 16 (6 per 128) measured 5 %
//     faster than 8 x 8 with two CTAs per SM. Doubling the FMAs per shared
//     load took only 1.6x as long, so what remains is shared loads that
//     overlap the FMAs poorly at 8 warps per SM, not device memory. So z
//     is not kept resident in shared memory across the 4 code tiles: a
//     128-row tile at D = 208 (106 KB) would fit beside the codebook ring,
//     but it saves only global loads, and those come from L2 (132 tiles x
//     106 KB in flight fit in 50 MB) at 64 FMAs per byte.
//   MEDIUM (config 1): 32 x 64 tile, 4 x 4 per thread, 128 threads, BK 64,
//     4 stages (107 KB). For train batches (500 rows: 16 row tiles x 16 code
//     splits = 256 CTAs). Few rows mean few outputs, so these shapes are
//     latency bound: long column slices (BK 64) cut the barriers per FMA,
//     and the two row warps of a CTA share one staged codebook tile.
//   SMALL (config 2): 32 x 32 tile, 64 threads, otherwise as MEDIUM, for B
//     where MEDIUM's grid would leave SMs without a CTA (the served 160 rows:
//     5 row tiles x 32 code splits = 160 CTAs on 132 SMs).
// With splits > 1 each CTA writes its rows' partial (dist, idx) to scratch
// and a second kernel reduces the splits per row in split order. Where LARGE
// would run and D <= 256, K1 takes the tensor-core path instead; K2 keeps
// the tiles here.
//
// Each .cu that includes this header builds into its own shared library, so
// the extern "C" helpers at the end exist once per library.

#pragma once

#include <climits>
#include <cstddef>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vq {

__device__ __forceinline__ bool better(float d, int i, float best_d, int best_i) {
  return d < best_d || (d == best_d && i < best_i);
}

// 4-byte global -> shared copy; pred false zero-fills and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline size_t align4(size_t x) { return (x + 3) & ~static_cast<size_t>(3); }

template <int WARPS_M_, int WARPS_N_, int TM_, int TN_, int STAGES_, int BK_ = 16,
          int MIN_BLOCKS_ = 1>
struct TileCfg {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int TM = TM_, TN = TN_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int LANES_M = 4, LANES_N = 8;  // a warp is 4 x 8 threads
  static constexpr int WM = TM * LANES_M, WN = TN * LANES_N;
  static constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int BK = BK_;
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr int STAGE_FLOATS = BK * (LDA + LDB);
  static constexpr size_t SMEM =
      sizeof(float) * STAGES * STAGE_FLOATS + WARPS_N * BM * (sizeof(float) + sizeof(int));
  static_assert(THREADS % BK == 0 && TM % 4 == 0 && TN % 4 == 0, "tile shape");
};

using Large = TileCfg<4, 2, 8, 16, 3>;       // 128 x 256, 256 threads
using Medium = TileCfg<2, 2, 4, 4, 4, 64>;    // 32 x 64, 128 threads
using Small = TileCfg<2, 1, 4, 4, 4, 64>;     // 32 x 32, 64 threads

__global__ void code_norms_kernel(const float* __restrict__ c, int N, int D,
                                  float* __restrict__ cn) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const float* row = c + static_cast<size_t>(n) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(row[d], row[d], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) cn[n] = s;
}

// One CTA's tile: rows row_tile * BM .. + BM of z (through `rows`, a list of
// row indices, with GATHER) against code split `split`. With `direct` the ids
// go to ids[row]; else the partial (dist, idx) go to part_d / part_i at
// [split * part_stride + row], the row's index in the tile walk.
template <class C, bool GATHER>
__device__ __forceinline__ void tile_lookup(const float* __restrict__ z,
                                            const float* __restrict__ c,
                                            const float* __restrict__ cn, int B, int N,
                                            int D, int codes_per_split, int row_tile,
                                            int split, bool direct,
                                            const int* __restrict__ rows, int part_stride,
                                            int* __restrict__ ids, float* __restrict__ part_d,
                                            int* __restrict__ part_i, float* smem) {
  float* red_d = smem + C::STAGES * C::STAGE_FLOATS;
  int* red_i = reinterpret_cast<int*>(red_d + C::WARPS_N * C::BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int lm = lane / C::LANES_N, ln = lane % C::LANES_N;
  const int row0 = row_tile * C::BM;
  const int code_begin = split * codes_per_split;
  const int code_end = min(N, code_begin + codes_per_split);
  const int ktiles = (D + C::BK - 1) / C::BK;
  const int steps = (code_end - code_begin + C::BN - 1) / C::BN * ktiles;

  // this thread's copies: column k of rows ck, ck + THREADS / BK, ...
  const int ck = tid % C::BK;
  const int cr = tid / C::BK;
  auto load = [&](int step, int slot) {
    const int n0 = code_begin + step / ktiles * C::BN;
    const int gk = step % ktiles * C::BK + ck;
    float* as = smem + slot * C::STAGE_FLOATS;
    float* bs = as + C::BK * C::LDA;
#pragma unroll
    for (int r = cr; r < C::BM; r += C::THREADS / C::BK) {
      const bool ok = gk < D && row0 + r < B;
      const size_t zr = GATHER ? (ok ? rows[row0 + r] : 0) : row0 + r;
      cp_async4(as + ck * C::LDA + r, ok ? z + zr * D + gk : z, ok);
    }
#pragma unroll
    for (int r = cr; r < C::BN; r += C::THREADS / C::BK) {
      const bool ok = gk < D && n0 + r < code_end;
      cp_async4(bs + ck * C::LDB + r, ok ? c + static_cast<size_t>(n0 + r) * D + gk : c, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }

  float acc[C::TM][C::TN];
  float best_d[C::TM];
  int best_i[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    best_d[i] = CUDART_INF_F;
    best_i[i] = INT_MAX;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.f;
  }

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // slice `step` has landed; slot (step - 1) % STAGES is free
    const int next = step + C::STAGES - 1;
    if (next < steps) load(next, next % C::STAGES);
    cp_async_commit();

    const float* as = smem + (step % C::STAGES) * C::STAGE_FLOATS;
    const float* bs = as + C::BK * C::LDA;
#pragma unroll
    for (int k = 0; k < C::BK; ++k) {
      float a[C::TM], b[C::TN];
#pragma unroll
      for (int h = 0; h < C::TM / 4; ++h)
        *reinterpret_cast<float4*>(&a[4 * h]) = *reinterpret_cast<const float4*>(
            &as[k * C::LDA + wm * C::WM + h * 4 * C::LANES_M + lm * 4]);
#pragma unroll
      for (int h = 0; h < C::TN / 4; ++h)
        *reinterpret_cast<float4*>(&b[4 * h]) = *reinterpret_cast<const float4*>(
            &bs[k * C::LDB + wn * C::WN + h * 4 * C::LANES_N + ln * 4]);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (step % ktiles == ktiles - 1) {
      // the code tile is complete: fold its distances, codes ascending
      const int n0 = code_begin + step / ktiles * C::BN + wn * C::WN + ln * 4;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int n = n0 + j / 4 * 4 * C::LANES_N + j % 4;
        // branch-free: a code past the split gets +inf, which never wins
        const float cnn = n < code_end ? __ldg(cn + n) : CUDART_INF_F;
#pragma unroll
        for (int i = 0; i < C::TM; ++i) {
          const float d = cnn - 2.f * acc[i][j];
          const bool take = d < best_d[i];
          best_d[i] = take ? d : best_d[i];
          best_i[i] = take ? n : best_i[i];
          acc[i][j] = 0.f;
        }
      }
    }
  }

  // the 8 threads of a row run differ only in the low 3 bits of the lane
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    float d = best_d[i];
    int idx = best_i[i];
#pragma unroll
    for (int off = 1; off < C::LANES_N; off <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (better(od, oi, d, idx)) {
        d = od;
        idx = oi;
      }
    }
    if (ln == 0) {
      const int r = wm * C::WM + i / 4 * 4 * C::LANES_M + lm * 4 + i % 4;
      red_d[wn * C::BM + r] = d;
      red_i[wn * C::BM + r] = idx;
    }
  }
  __syncthreads();
  for (int r = tid; r < C::BM; r += C::THREADS) {
    float d = red_d[r];
    int idx = red_i[r];
#pragma unroll
    for (int w = 1; w < C::WARPS_N; ++w) {
      if (better(red_d[w * C::BM + r], red_i[w * C::BM + r], d, idx)) {
        d = red_d[w * C::BM + r];
        idx = red_i[w * C::BM + r];
      }
    }
    const int gr = row0 + r;
    if (gr < B) {
      if (direct) {
        ids[gr] = idx == INT_MAX ? 0 : idx;  // no finite distance: argmin's 0
      } else {
        part_d[static_cast<size_t>(split) * part_stride + gr] = d;
        part_i[static_cast<size_t>(split) * part_stride + gr] = idx;
      }
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
nearest_tile_kernel(const float* __restrict__ z, const float* __restrict__ c,
                    const float* __restrict__ cn, int B, int N, int D,
                    int codes_per_split, int* __restrict__ ids,
                    float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  tile_lookup<C, false>(z, c, cn, B, N, D, codes_per_split, blockIdx.x, blockIdx.y,
                        gridDim.y == 1, nullptr, B, ids, part_d, part_i, smem);
}

__global__ void reduce_splits_kernel(const float* __restrict__ part_d,
                                     const int* __restrict__ part_i, int B,
                                     int splits, int* __restrict__ ids) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float d = part_d[r];
  int idx = part_i[r];
  for (int s = 1; s < splits; ++s) {
    const float od = part_d[static_cast<size_t>(s) * B + r];
    const int oi = part_i[static_cast<size_t>(s) * B + r];
    if (better(od, oi, d, idx)) {
      d = od;
      idx = oi;
    }
  }
  ids[r] = idx == INT_MAX ? 0 : idx;
}

// The lookup's scratch, in 4-byte elements: cn [N], then with splits > 1
// part_d [splits, B] fp32 and part_i [splits, B] int32, each 16-byte aligned.
inline size_t lookup_scratch_elems(int B, int N, int splits) {
  const size_t parts = splits > 1 ? align4(static_cast<size_t>(splits) * B) : 0;
  return align4(N) + 2 * parts;
}

template <class C>
cudaError_t launch_tile(const float* z, const float* c, const float* cn, int* ids,
                        float* part_d, int* part_i, int B, int N, int D,
                        int codes_per_split, int splits, cudaStream_t s) {
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearest_tile_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(C::SMEM));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + C::BM - 1) / C::BM, splits);
  nearest_tile_kernel<C><<<grid, C::THREADS, C::SMEM, s>>>(z, c, cn, B, N, D,
                                                           codes_per_split, ids,
                                                           part_d, part_i);
  return cudaGetLastError();
}

// Enqueue the lookup on `s`: z [B, D], c [N, D] fp32 and ids [B] int32, all
// contiguous on the current device; scratch holds lookup_scratch_elems(B,
// N, splits) 4-byte elements. config 0 is LARGE, 1 MEDIUM, 2 SMALL; codes_per_split
// is a multiple of that configuration's BN. Returns the first cudaError_t.
inline cudaError_t launch_nearest(const float* z, const float* c, int* ids, void* scratch,
                                  int B, int N, int D, int config, int codes_per_split,
                                  int splits, cudaStream_t s) {
  if (config < 0 || config > 2) return cudaErrorInvalidValue;
  float* cn = static_cast<float*>(scratch);
  float* part_d = cn + align4(N);
  int* part_i = reinterpret_cast<int*>(part_d + align4(static_cast<size_t>(splits) * B));
  code_norms_kernel<<<(N + 7) / 8, 256, 0, s>>>(c, N, D, cn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (config == 0)
    err = launch_tile<Large>(z, c, cn, ids, part_d, part_i, B, N, D, codes_per_split, splits, s);
  else if (config == 1)
    err = launch_tile<Medium>(z, c, cn, ids, part_d, part_i, B, N, D, codes_per_split, splits, s);
  else
    err = launch_tile<Small>(z, c, cn, ids, part_d, part_i, B, N, D, codes_per_split, splits, s);
  if (err != cudaSuccess || splits == 1) return err;
  reduce_splits_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_d, part_i, B, splits, ids);
  return cudaGetLastError();
}

}  // namespace vq

extern "C" {

// Tile shape of a configuration, which the wrapper's plan must agree with.
int vq_tile_rows(int config) {
  return config == 0 ? vq::Large::BM : config == 1 ? vq::Medium::BM : vq::Small::BM;
}
int vq_tile_codes(int config) {
  return config == 0 ? vq::Large::BN : config == 1 ? vq::Medium::BN : vq::Small::BN;
}

// 4-byte elements of the lookup's scratch (the first part of every entry
// point's scratch).
size_t vq_lookup_scratch_elems(int B, int N, int splits) {
  return vq::lookup_scratch_elems(B, N, splits);
}

// A returned cudaError_t's text, under the one name every library exports.
const char* lipvq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
