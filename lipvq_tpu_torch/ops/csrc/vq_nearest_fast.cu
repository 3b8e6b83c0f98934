// K1f: the nearest-code lookup of K1 in one bf16 pass on the tensor cores.
//
// Replaces the "fast" instantiation of the Pallas kernel
// lipvq_tpu/ops/vq_lookup.py::_make_vq_kernel (vq_nearest_pallas with
// precision="fast": Precision.DEFAULT, one bf16 MXU pass with fp32
// accumulation). For every row b of z [B, D] it computes
//
//     ids[b] = argmin_n ( cn[n] - 2 * dot(bf16(z[b]), bf16(c[n])) )
//
// with cn[n] = ||c[n]||^2 in fp32 from the fp32 codebook (the same chain as
// K1's code_norms_kernel, as the Pallas wrapper takes cn from the fp32
// codebook), z and c rounded to bf16 (round to nearest even), the products
// summed by wgmma with fp32 accumulation, and the lowest index winning ties.
//
// Numerics. The ids are not bit-equal to an fp32 evaluation of the same
// formula: the tensor cores add the products in their own order and
// rounding. Each running minimum is a strict < over ascending codes and every
// merge (the 4 threads of a row, code splits) is lexicographic on (dist,
// idx), so exact ties still go to the lowest index. chip_smoke.py holds the
// kernel against vq_nearest_fast_reference by ops/vq_lookup.py::tie_gap.
//
// Bound. 2*B*N*D bf16 tensor-core operations against (B + N)*D*4 bytes of
// fp32 inputs: at the corpus shape (2^20 x 1024 x 208) the operations bound
// it (0.45 ms at the dense bf16 peak against 0.26 ms to read z once); at the
// served and train shapes (160 / 500 x 1024 x 791) reading the 3.2 MB
// codebook does (~1 us): there the three launches and the staging of z set
// the time.
//
// Design.
// - prep_codebook_kernel (one warp per code) converts the codebook once per
//   call: cn [N] in fp32 and a bf16 copy [N, Dp] in the scratch, Dp = D
//   rounded up to the 128-byte swizzle width (64 bf16), zero past D. Its rows
//   are 16-byte aligned, so TMA loads them (the fp32 rows at D = 791 are
//   not). The tensor map's inner extent is Dk = D rounded up to 16, the
//   k-loop's depth: a box reaching past Dk is zero-filled by the TMA unit and
//   reads nothing, so padding to Dp costs shared memory, not L2 traffic or
//   tensor-core work.
// - nearest_fast_kernel: a CTA owns BM rows and a range of codes. Its
//   consumer warpgroups first stage the rows of z once, rounded to bf16, in
//   shared memory in the 128-byte-swizzled K-major layout wgmma reads
//   ([Dp / 64][BM][64], zero past B), so z is read from device memory once per
//   code split. One producer thread then streams (code tile x 64 columns)
//   boxes of the bf16 codebook with cp.async.bulk.tensor into a ring of
//   STAGES buffers, each guarded by a full and an empty mbarrier. Each
//   consumer warpgroup runs wgmma.mma_async m64nBNk16 on its m64 row tiles
//   (A: the z tile, B: the ring buffer, both by shared-memory descriptor),
//   keeps one k-block's group in flight (wgmma.wait_group 1) and releases a
//   buffer as soon as the group that read it has completed, so the producer
//   refills the ring during the epilogue. The epilogue folds each
//   accumulator fragment into per-thread running minima (cn - 2 acc, strict <
//   over ascending codes); nothing of the [B, N] scores leaves the registers.
//   The two consumer warpgroups of WIDE own different rows and share every
//   ring buffer, so they run in step.
// - Two configurations, picked by plan_fast in ops/vq_lookup.py:
//   WIDE (config 0): 2 consumer warpgroups x 2 m64 tiles = 256 rows, 128
//     codes a tile (m64n128k16), 4 stages of 16 KB. The codebook is re-read
//     from L2 once per row tile, so rows are what cut that traffic: 256-row
//     tiles read 1024 x 208 x 2 bytes 4096 times (1.7 GB) at the corpus
//     shape. The z tile (256 x Dp bf16) bounds D at WIDE_MAX_D = 320. For
//     grids of at least one CTA per SM.
//   NARROW (config 1): 1 consumer warpgroup, 64 rows, 16 codes a tile
//     (m64n16k16), 4 stages of 2 KB: for small B (the served 160 and train
//     500 rows: 3 x 64 and 8 x 32 code splits, 192 and 256 CTAs on 132 SMs)
//     and for D up to MAX_D = 1728 (the z tile takes 221 KB there). Finer
//     code splits fill the card; the price is z staging: each of a row
//     tile's splits reads its 64 rows again (64 x 791 x 4 = 202 KB from L2 at
//     D = 791, against 16 x 791 x 2 = 25 KB of codebook per code tile). At
//     D = 791 a CTA takes 112 KB of shared memory, so two share an SM.
// - With splits > 1 each CTA writes its rows' partial (dist, idx) and K1's
//   reduce_splits_kernel merges the splits per row in split order.
// Where WIDE's time goes at the corpus shape (timed once with parts edited
// out of this source; PERF.md has the numbers): the codebook stream from
// L2, the wgmma, the z staging and the fold overlap little, the stream alone
// taking about a quarter of the kernel. Each of these measured slower there
// on an H100 (the code is not kept): ping-pong
// warpgroups (each buffer is then read half a tile apart, which halves the
// ring's reach, and two tiles of ring do not fit beside the z tile);
// persistent CTAs that prefetch the next row tile's z into L2; a producer
// warpgroup giving its registers to the consumers (setmaxnreg); 128-row
// tiles two to an SM (twice the L2 traffic); whole k-blocks past Dk (no
// predicated k-steps, 23 % more products); a cluster of two CTAs that
// multicast each box (half the L2 reads): the buffers' round trip between
// the two CTAs then held the stream back, by more than it saved.
// The fp32 z is staged by the consumers with plain loads (float4 where D % 4
// == 0): TMA needs 16-byte-aligned rows, which fp32 z [B, 791] does not have.
// The tensor map comes from cuTensorMapEncodeTiled, reached through the
// runtime's cudaGetDriverEntryPoint so the library needs no -lcuda, and is
// passed as a __grid_constant__ parameter.

#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "sm90_ptx.cuh"
#include "vq_nearest_tile.cuh"

namespace vqf {

using namespace sm90;

constexpr int STAGES = 4;               // ring buffers
constexpr int SWIZZLE_COLS = 64;         // bf16 columns of a 128-byte swizzled row
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of one CTA

__host__ __device__ constexpr int padded_d(int d) {  // Dp
  return (d + SWIZZLE_COLS - 1) / SWIZZLE_COLS * SWIZZLE_COLS;
}
__host__ __device__ constexpr int k_depth(int d) { return (d + 15) / 16 * 16; }  // Dk

template <int WGS_, int MT_, int BN_, int MIN_BLOCKS_>
struct FastCfg {
  static constexpr int WGS = WGS_;             // consumer warpgroups
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // CTAs an SM must hold
  static constexpr int MT = MT_;               // m64 row tiles of each
  static constexpr int BN = BN_;               // codes of a tile: the wgmma N
  static constexpr int BM = 64 * MT * WGS;     // rows of a CTA
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int STAGE_BYTES = BN * 128;
  static constexpr int ACC = BN / 2;           // accumulators a thread, per m64 tile
  static constexpr size_t smem(int d) {
    return static_cast<size_t>(BM) * padded_d(d) * 2 + STAGES * STAGE_BYTES +
           2 * STAGES * sizeof(uint64_t);
  }
  // the largest D whose z tile fits beside the ring
  static constexpr int MAX_D =
      (SMEM_LIMIT - STAGES * STAGE_BYTES - 2 * STAGES * 8) / (2 * BM) / SWIZZLE_COLS *
      SWIZZLE_COLS;
  static_assert(STAGE_BYTES % 1024 == 0 && BM % 8 == 0, "1024-byte swizzle atoms");
};

using Wide = FastCfg<2, 2, 128, 1>;   // config 0: 256 x 128
using Narrow = FastCfg<1, 1, 16, 2>;  // config 1: 64 x 16, two CTAs an SM at D = 791
constexpr int WIDE_MAX_D = Wide::MAX_D;    // 320
constexpr int MAX_D = Narrow::MAX_D;       // 1728
static_assert(WIDE_MAX_D == 320 && MAX_D == 1728, "the wrapper's constants");

// --- kernels -----------------------------------------------------------------

// cn [N] (K1's chain: lane-strided fmaf, then a fixed shuffle tree) and the
// bf16 copy [N, Dp] of the codebook, zero past D; one warp per code.
__global__ void prep_codebook_kernel(const float* __restrict__ c, int N, int D, int dp,
                                     float* __restrict__ cn, __nv_bfloat16* __restrict__ cb) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  const float* row = c + static_cast<size_t>(n) * D;
  __nv_bfloat16* out = cb + static_cast<size_t>(n) * dp;
  float s = 0.f;
  for (int k = lane; k < dp; k += 32) {
    const float v = k < D ? row[k] : 0.f;
    if (k < D) s = fmaf(v, v, s);
    out[k] = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) cn[n] = s;
}

// The CTA's rows of z, rounded to bf16, into the swizzled tile: 16-byte
// chunk c of row r of k-block kb lands at kb * BM * 128 + r * 128 +
// ((c ^ (r % 8)) * 16), as a TMA load with SWIZZLE_128B would place it.
// Columns D .. Dk - 1 and rows past B are zero; four chunks' loads are in
// flight a thread.
template <class C>
__device__ __forceinline__ void stage_z(const float* __restrict__ z, int B, int D, int row0,
                                        uint8_t* zs) {
  const int cpr = k_depth(D) / 8;  // chunks a row
  const int total = C::BM * cpr;
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(z) & 15) == 0;
  for (int q0 = threadIdx.x; q0 < total; q0 += 4 * C::CONSUMERS) {
    float v[4][8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * C::CONSUMERS;
      const int r = q / cpr, col = q % cpr * 8, gr = row0 + r;
      const bool row_ok = q < total && gr < B;
      const float* src = z + static_cast<size_t>(row_ok ? gr : 0) * D + col;
      if (vec && row_ok && col + 8 <= D) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(src));
        const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
        v[u][0] = a.x; v[u][1] = a.y; v[u][2] = a.z; v[u][3] = a.w;
        v[u][4] = b.x; v[u][5] = b.y; v[u][6] = b.z; v[u][7] = b.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[u][e] = row_ok && col + e < D ? __ldg(src + e) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = q0 + u * C::CONSUMERS;
      if (q < total) {
        const int r = q / cpr, chunk = q % cpr;
        const int kb = chunk / 8, c = chunk % 8;
        uint4 w;
        w.x = pack_bf16(v[u][0], v[u][1]);
        w.y = pack_bf16(v[u][2], v[u][3]);
        w.z = pack_bf16(v[u][4], v[u][5]);
        w.w = pack_bf16(v[u][6], v[u][7]);
        *reinterpret_cast<uint4*>(zs + (static_cast<size_t>(kb) * C::BM + r) * 128 +
                                  ((c ^ (r & 7)) << 4)) = w;
      }
    }
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
nearest_fast_kernel(const __grid_constant__ CUtensorMap cmap, const float* __restrict__ z,
                    const float* __restrict__ cn, int B, int N, int D, int codes_per_split,
                    int* __restrict__ ids, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int kblocks = (k_depth(D) + SWIZZLE_COLS - 1) / SWIZZLE_COLS;
  const int ksteps = k_depth(D) / 16;
  uint8_t* zs = smem;  // [Dp / 64][BM][128 bytes]
  uint8_t* ring = smem + static_cast<size_t>(padded_d(D) / SWIZZLE_COLS) * C::BM * 128;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  const uint32_t ring_u32 = smem_u32(ring), zs_u32 = smem_u32(zs);
  const uint32_t full_u32 = smem_u32(bars), empty_u32 = full_u32 + STAGES * 8;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * C::BM;
  const int code_begin = blockIdx.y * codes_per_split;
  const int code_end = min(N, code_begin + codes_per_split);
  const int tiles = (code_end - code_begin + C::BN - 1) / C::BN;

  if (tid == 0) {
    if (zs_u32 & 1023) __trap();  // the swizzle atoms need a 1024-byte aligned base
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_u32 + 8 * s, 1);                       // the producer's expect_tx
      mbar_init(empty_u32 + 8 * s, C::CONSUMERS / 32);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // producer: one thread walks (code tile, k-block) in the consumers' order
    if (tid == C::CONSUMERS) {
      int stage = 0, phase = 0;
      for (int t = 0; t < tiles; ++t) {
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(empty_u32 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full_u32 + 8 * stage, C::STAGE_BYTES);
          tma_load_2d(ring_u32 + stage * C::STAGE_BYTES, &cmap, full_u32 + 8 * stage,
                      kb * SWIZZLE_COLS, code_begin + t * C::BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: stage z once, then make it visible to the tensor cores
  stage_z<C>(z, B, D, row0, zs);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");  // consumers only

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid & 31;
  float acc[C::MT][C::ACC];
  float best_d[C::MT][2];
  int best_i[C::MT][2];
#pragma unroll
  for (int m = 0; m < C::MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_d[m][h] = CUDART_INF_F;
      best_i[m][h] = INT_MAX;
    }
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[m][i] = 0.f;
  }

  int stage = 0, phase = 0, held = -1;
  for (int t = 0; t < tiles; ++t) {
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(full_u32 + 8 * stage, phase);
#pragma unroll
      for (int m = 0; m < C::MT; ++m)
#pragma unroll
        for (int i = 0; i < C::ACC; ++i) fence_operand(acc[m][i]);
      wgmma_fence();
      const int steps = min(4, ksteps - 4 * kb);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks < steps) {
          const uint64_t b = smem_desc(ring_u32 + stage * C::STAGE_BYTES + 32 * ks);
#pragma unroll
          for (int m = 0; m < C::MT; ++m) {
            const uint64_t a = smem_desc(
                zs_u32 + (kb * C::BM + (wg * C::MT + m) * 64) * 128 + 32 * ks);
            wgmma<C::BN>(acc[m], a, b, (kb | ks) != 0);
          }
        }
      }
      wgmma_commit();
      // the previous k-block's group is done: its buffer goes back
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) mbar_arrive(empty_u32 + 8 * held);
      held = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < C::MT; ++m)
#pragma unroll
      for (int i = 0; i < C::ACC; ++i) fence_operand(acc[m][i]);
    if (lane == 0) mbar_arrive(empty_u32 + 8 * held);
    held = -1;

    // fold the tile: acc[m][4j + 2h + e] is row 16 warp + lane / 4 + 8h of
    // m64 tile m, code 8j + 2 (lane % 4) + e of the tile; codes ascending
    const int nb = code_begin + t * C::BN + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < C::BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nb + 8 * j + e;
        // branch-free: a code past the split gets +inf, which never wins
        const float cnn = n < code_end ? __ldg(cn + n) : CUDART_INF_F;
#pragma unroll
        for (int m = 0; m < C::MT; ++m) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = fmaf(-2.f, acc[m][4 * j + 2 * h + e], cnn);
            const bool take = d < best_d[m][h];
            best_d[m][h] = take ? d : best_d[m][h];
            best_i[m][h] = take ? n : best_i[m][h];
          }
        }
      }
    }
  }

  // the 4 threads of a row differ only in the low 2 bits of the lane
#pragma unroll
  for (int m = 0; m < C::MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d = best_d[m][h];
      int idx = best_i[m][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (vq::better(od, oi, d, idx)) {
          d = od;
          idx = oi;
        }
      }
      const int gr = row0 + (wg * C::MT + m) * 64 + warp * 16 + lane / 4 + 8 * h;
      if ((lane & 3) == 0 && gr < B) {
        if (gridDim.y == 1) {
          ids[gr] = idx == INT_MAX ? 0 : idx;  // no finite distance: argmin's 0
        } else {
          part_d[static_cast<size_t>(blockIdx.y) * B + gr] = d;
          part_i[static_cast<size_t>(blockIdx.y) * B + gr] = idx;
        }
      }
    }
  }
}

// --- host --------------------------------------------------------------------

// The codebook copy's scratch: the lookup's (cn, split partials), 32 spare
// elements to align the copy to 128 bytes, then N * Dp bf16.
inline size_t scratch_elems(int B, int N, int D, int splits) {
  return vq::lookup_scratch_elems(B, N, splits) + 32 + static_cast<size_t>(N) * padded_d(D) / 2;
}

template <class C>
cudaError_t launch_cfg(const float* z, const __nv_bfloat16* cb, const float* cn, int* ids,
                       float* part_d, int* part_i, int B, int N, int D, int codes_per_split,
                       int splits, cudaStream_t s) {
  if (D > C::MAX_D || codes_per_split % C::BN != 0) return cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap map;
  // columns past Dk are zero-filled by the TMA unit and not read (at least one
  // box wide: the copy holds zeros up to Dp >= 64)
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(max(k_depth(D), SWIZZLE_COLS)),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(padded_d(D)) * 2};
  const cuuint32_t box[2] = {SWIZZLE_COLS, C::BN};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<__nv_bfloat16*>(cb), dims,
             strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const size_t smem = C::smem(D);
  cudaError_t err = cudaFuncSetAttribute(nearest_fast_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((B + C::BM - 1) / C::BM, splits);
  nearest_fast_kernel<C><<<grid, C::THREADS, smem, s>>>(map, z, cn, B, N, D, codes_per_split,
                                                        ids, part_d, part_i);
  return cudaGetLastError();
}

// Enqueue K1f on `s`: z [B, D], c [N, D] fp32 and ids [B] int32, contiguous
// on the current device; scratch of scratch_elems(B, N, D, splits) 4-byte
// elements, 16-byte aligned. config 0 is WIDE, 1 NARROW; codes_per_split is
// a multiple of that configuration's BN. Returns the first cudaError_t.
inline cudaError_t launch_fast(const float* z, const float* c, int* ids, void* scratch, int B,
                               int N, int D, int config, int codes_per_split, int splits,
                               cudaStream_t s) {
  if (D < 1 || splits < 1 || config < 0 || config > 1) return cudaErrorInvalidValue;
  float* cn = static_cast<float*>(scratch);
  float* part_d = cn + vq::align4(N);
  int* part_i = reinterpret_cast<int*>(part_d + vq::align4(static_cast<size_t>(splits) * B));
  const uintptr_t copy =
      (reinterpret_cast<uintptr_t>(cn + vq::lookup_scratch_elems(B, N, splits)) + 127) &
      ~static_cast<uintptr_t>(127);
  __nv_bfloat16* cb = reinterpret_cast<__nv_bfloat16*>(copy);
  prep_codebook_kernel<<<(N + 7) / 8, 256, 0, s>>>(c, N, D, padded_d(D), cn, cb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = config == 0
            ? launch_cfg<Wide>(z, cb, cn, ids, part_d, part_i, B, N, D, codes_per_split, splits, s)
            : launch_cfg<Narrow>(z, cb, cn, ids, part_d, part_i, B, N, D, codes_per_split,
                                 splits, s);
  if (err != cudaSuccess || splits == 1) return err;
  vq::reduce_splits_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_d, part_i, B, splits, ids);
  return cudaGetLastError();
}

}  // namespace vqf

extern "C" {

// The tile shape of each configuration and the largest D of each, which the
// wrapper's plan must agree with.
int vq_fast_tile_rows(int config) { return config == 0 ? vqf::Wide::BM : vqf::Narrow::BM; }
int vq_fast_tile_codes(int config) { return config == 0 ? vqf::Wide::BN : vqf::Narrow::BN; }
int vq_fast_max_d(int config) { return config == 0 ? vqf::WIDE_MAX_D : vqf::MAX_D; }

// 4-byte elements of scratch that vq_nearest_fast_launch needs.
size_t vq_nearest_fast_scratch_elems(int B, int N, int D, int splits) {
  return vqf::scratch_elems(B, N, D, splits);
}

// z [B, D], c [N, D] fp32, ids [B] int32 and scratch, all contiguous on the
// current device; config 0 (WIDE, D <= 320) or 1 (NARROW, D <= 1728).
// Enqueues everything on `stream`, allocates nothing, and returns the first
// cudaError_t (0 on success).
int vq_nearest_fast_launch(const float* z, const float* c, int* ids, void* scratch, int B, int N,
                           int D, int config, int codes_per_split, int splits, void* stream) {
  return static_cast<int>(vqf::launch_fast(z, c, ids, scratch, B, N, D, config, codes_per_split,
                                           splits, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
