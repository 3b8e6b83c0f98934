// K1f: the nearest-code lookup of K1 in one bf16 pass on the tensor cores.
//
// Replaces the "fast" instantiation of the Pallas kernel
// lipvq_tpu/ops/vq_lookup.py::_make_vq_kernel (vq_nearest_pallas with
// precision="fast": Precision.DEFAULT, one bf16 MXU pass with fp32
// accumulation). For every row b of z [B, D] it computes
//
//     ids[b] = argmin_n ( cn[n] - 2 * dot(bf16(z[b]), bf16(c[n])) )
//
// with cn[n] = ||c[n]||^2 in fp32 from the fp32 codebook (K1's
// code_norms_kernel, as the Pallas wrapper takes cn from the fp32 codebook),
// z and c rounded to bf16 (round to nearest even) as they are staged into
// shared memory, the products summed by mma.sync with fp32 accumulation, and
// the lowest index winning ties.
//
// Numerics. The ids are not bit-equal to an fp32 evaluation of the same
// formula: the tensor cores add the products in their own order and
// rounding. Each running minimum is a strict < over ascending codes and every
// merge (threads, warps, code splits) is lexicographic on (dist, idx), so
// exact ties still go to the lowest index. chip_smoke.py holds the kernel
// against vq_nearest_fast_reference by a near-tie rule stated there.
//
// Bound. 2*B*N*D bf16 tensor-core operations against (B + N)*D*4 bytes of
// fp32 inputs: at the corpus shape (2^20 x 1024 x 208) the operations bound
// it (0.45 ms at the dense bf16 peak against 0.26 ms of reads); at the served
// and train shapes (160 / 500 x 1024 x 791) reading the 3.2 MB codebook does.
//
// Design (simple first; wgmma, TMA and a deeper ring are later work). A CTA
// of 4 warps owns 64 rows of z and a contiguous range of codes. It stages its
// rows once, rounded to bf16, in shared memory ([64][Dp + 8], Dp = D rounded
// up to 32, zero-filled past D and B: a zero adds exactly 0), so z is read
// from device memory once per code split. It then walks its codes in tiles of
// 128 and each tile's columns in slices of 32: the next slice is read from
// global memory into registers (4-byte loads, as D = 791 rows are not 16-byte
// aligned) while the tensor cores work on this one, then rounded to bf16 and
// stored into the other of two shared buffers, one barrier per slice. The
// warps are 2 x 2, each computing 32 rows x 64 codes as 2 x 8 tiles of
// mma.m16n8k16 (64 fp32 accumulators a thread). The +8 padding of each
// shared row makes the 32-bit fragment loads free of bank conflicts. When a
// code tile is complete, each thread folds its 16 codes of each of its 4 rows
// into running minima; at the end the 4 threads of a row, then the 2 code
// warps, then (with splits > 1, in reduce_splits_kernel) the code splits are
// merged. The shared z tile limits D to MAX_D (the wrapper checks it).

#include <cuda_bf16.h>

#include "vq_nearest_tile.cuh"

namespace vqf {

constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;       // 128
constexpr int WM = 32, WN = 64;                       // a warp's rows x codes
constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;   // 64 x 128
constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles a warp: 2 x 8
constexpr int BK = 32;                                // columns of a staged slice
constexpr int LDC = BK + 8;                           // bf16 stride of a staged code
constexpr int C_ROWS = THREADS / BK;                  // code rows one pass loads
constexpr int C_PER_THREAD = BN / C_ROWS;             // fp32 values in flight: 32
constexpr int MAX_D = 1632;                           // shared z tile fits 227 KB

__host__ __device__ constexpr int padded_d(int d) { return (d + BK - 1) / BK * BK; }
__host__ __device__ constexpr int ldz(int d) { return padded_d(d) + 8; }

inline size_t smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * (static_cast<size_t>(BM) * ldz(d) + 2 * BN * LDC) +
         WARPS_N * BM * (sizeof(float) + sizeof(int));
}

__device__ __forceinline__ unsigned ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a * b for one m16n8k16 tile: a row-major 16x16, b 16x8 given as its
// transpose (codes x columns, row-major), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
nearest_fast_kernel(const float* __restrict__ z, const float* __restrict__ c,
                    const float* __restrict__ cn, int B, int N, int D, int codes_per_split,
                    int* __restrict__ ids, float* __restrict__ part_d,
                    int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = padded_d(D), lz = ldz(D);
  __nv_bfloat16* zs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* cs = zs + BM * lz;  // two buffers of [BN][LDC]
  float* red_d = reinterpret_cast<float*>(cs + 2 * BN * LDC);
  int* red_i = reinterpret_cast<int*>(red_d + WARPS_N * BM);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, tg = lane & 3;  // the fragment's row group and pair
  const int row0 = blockIdx.x * BM;
  const int code_begin = blockIdx.y * codes_per_split;
  const int code_end = min(N, code_begin + codes_per_split);
  const int ksteps = dp / BK;
  const int steps = (code_end - code_begin + BN - 1) / BN * ksteps;

  // this CTA's rows of z, rounded to bf16, zero past B and D
  for (int r = 0; r < BM; ++r) {
    const int gr = row0 + r;
    for (int k = tid; k < dp; k += THREADS) {
      const float v = gr < B && k < D ? __ldg(z + static_cast<size_t>(gr) * D + k) : 0.f;
      zs[r * lz + k] = __float2bfloat16_rn(v);
    }
  }

  // this thread's share of a code slice: column ck of codes cr + j * C_ROWS
  const int ck = tid % BK, cr = tid / BK;
  float creg[C_PER_THREAD];
  auto load_c = [&](int step) {
    const int n0 = code_begin + step / ksteps * BN + cr;
    const int gk = step % ksteps * BK + ck;
#pragma unroll
    for (int j = 0; j < C_PER_THREAD; ++j) {
      const int n = n0 + j * C_ROWS;
      creg[j] = n < code_end && gk < D ? __ldg(c + static_cast<size_t>(n) * D + gk) : 0.f;
    }
  };
  auto store_c = [&](int buf) {
    __nv_bfloat16* dst = cs + buf * BN * LDC + cr * LDC + ck;
#pragma unroll
    for (int j = 0; j < C_PER_THREAD; ++j)
      dst[j * C_ROWS * LDC] = __float2bfloat16_rn(creg[j]);
  };

  float acc[MT][NT][4];
  float best_d[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_d[i][h] = CUDART_INF_F;
      best_i[i][h] = INT_MAX;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  if (steps > 0) {
    load_c(0);
    store_c(0);
  }
  __syncthreads();  // the z tile and the first slice are in place

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load_c(step + 1);  // in flight under the mma below
    const __nv_bfloat16* cb = cs + (step & 1) * BN * LDC;
    const int kz = step % ksteps * BK;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = zs + (wm * WM + i * 16 + g) * lz + kz + kk + 2 * tg;
        a[i][0] = ld_pair(p);
        a[i][1] = ld_pair(p + 8 * lz);
        a[i][2] = ld_pair(p + 8);
        a[i][3] = ld_pair(p + 8 * lz + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = cb + (wn * WN + j * 8 + g) * LDC + kk + 2 * tg;
        const unsigned b0 = ld_pair(p), b1 = ld_pair(p + 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b0, b1);
      }
    }
    // the other buffer was last read in the previous step, before its barrier
    if (step + 1 < steps) store_c((step + 1) & 1);

    if (step % ksteps == ksteps - 1) {
      // the code tile is complete: acc[i][j][2h + e] is row i*16 + g + 8h,
      // code j*8 + 2tg + e of this warp's tile; fold codes ascending
      const int nb = code_begin + step / ksteps * BN + wn * WN + 2 * tg;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nb + j * 8 + e;
          // branch-free: a code past the split gets +inf, which never wins
          const float cnn = n < code_end ? __ldg(cn + n) : CUDART_INF_F;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float d = cnn - 2.f * acc[i][j][2 * h + e];
              const bool take = d < best_d[i][h];
              best_d[i][h] = take ? d : best_d[i][h];
              best_i[i][h] = take ? n : best_i[i][h];
              acc[i][j][2 * h + e] = 0.f;
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // the 4 threads of a row group differ only in the low 2 bits of the lane
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d = best_d[i][h];
      int idx = best_i[i][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, d, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (vq::better(od, oi, d, idx)) {
          d = od;
          idx = oi;
        }
      }
      if (tg == 0) {
        const int r = wm * WM + i * 16 + g + 8 * h;
        red_d[wn * BM + r] = d;
        red_i[wn * BM + r] = idx;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS) {
    float d = red_d[r];
    int idx = red_i[r];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w) {
      if (vq::better(red_d[w * BM + r], red_i[w * BM + r], d, idx)) {
        d = red_d[w * BM + r];
        idx = red_i[w * BM + r];
      }
    }
    const int gr = row0 + r;
    if (gr < B) {
      if (gridDim.y == 1) {
        ids[gr] = idx == INT_MAX ? 0 : idx;  // no finite distance: argmin's 0
      } else {
        part_d[static_cast<size_t>(blockIdx.y) * B + gr] = d;
        part_i[static_cast<size_t>(blockIdx.y) * B + gr] = idx;
      }
    }
  }
}

// Enqueue K1f on `s`: z [B, D], c [N, D] fp32 and ids [B] int32, contiguous
// on the current device; scratch as K1's (vq::lookup_scratch_elems).
// codes_per_split is a multiple of BN. Returns the first cudaError_t.
inline cudaError_t launch_fast(const float* z, const float* c, int* ids, void* scratch, int B,
                               int N, int D, int codes_per_split, int splits, cudaStream_t s) {
  if (D < 1 || D > MAX_D || codes_per_split % BN != 0 || splits < 1)
    return cudaErrorInvalidValue;
  float* cn = static_cast<float*>(scratch);
  float* part_d = cn + vq::align4(N);
  int* part_i = reinterpret_cast<int*>(part_d + vq::align4(static_cast<size_t>(splits) * B));
  vq::code_norms_kernel<<<(N + 7) / 8, 256, 0, s>>>(c, N, D, cn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nearest_fast_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((B + BM - 1) / BM, splits);
  nearest_fast_kernel<<<grid, THREADS, smem, s>>>(z, c, cn, B, N, D, codes_per_split, ids,
                                                  part_d, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  vq::reduce_splits_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_d, part_i, B, splits, ids);
  return cudaGetLastError();
}

}  // namespace vqf

extern "C" {

// The tile shape and the largest D, which the wrapper's plan must agree with.
int vq_fast_tile_rows() { return vqf::BM; }
int vq_fast_tile_codes() { return vqf::BN; }
int vq_fast_max_d() { return vqf::MAX_D; }

// 4-byte elements of scratch that vq_nearest_fast_launch needs.
size_t vq_nearest_fast_scratch_elems(int B, int N, int splits) {
  return vq::lookup_scratch_elems(B, N, splits);
}

// z [B, D], c [N, D] fp32, ids [B] int32 and scratch, all contiguous on the
// current device; K1f has one configuration, so config must be 0. Enqueues
// everything on `stream`, allocates nothing, and returns the first
// cudaError_t (0 on success).
int vq_nearest_fast_launch(const float* z, const float* c, int* ids, void* scratch, int B, int N,
                           int D, int config, int codes_per_split, int splits, void* stream) {
  if (config != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(vqf::launch_fast(z, c, ids, scratch, B, N, D, codes_per_split, splits,
                                           static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
