// The nearest-code lookup shared by K1 (vq_nearest.cu) and K2 (vq_stats.cu).
//
// For every row b of z [B, D] it computes
//
//     ids[b] = argmin_n ( cn[n] - 2 * dot(z[b], c[n]) ),   cn[n] = ||c[n]||^2
//
// with ||z||^2 dropped (constant per row) and the lowest index winning ties,
// as torch.argmin and the Pallas kernels of lipvq_tpu/ops/vq_lookup.py do.
//
// Numerics. Every dot product is one chain of fp32 FMAs over d ascending:
// no TF32, no bf16, no split-K. A single bf16 pass flips argmins on
// near-ties, and the ids must equal the plain fp32 version's.
//
// Bound. The work is 2*B*N*D fp32 operations against (B + N)*D*4 bytes read,
// so at every shape the port uses (the served request's 160 x 1024 x 791,
// the train step's 500 x 1024 x 791, the corpus's 2^20 x 1024 x 208) the
// card's fp32 SIMT rate bounds it, not its memory: the codebook (3.2 MB at
// D = 791) stays in L2 and each CTA reuses a staged tile of z and of the
// codebook 64 times from shared memory.
//
// Design. A CTA owns BM = 64 rows of z and walks a range of codes in tiles of
// BN = 64, staging BK = 32 columns of both operands in shared memory at a
// time (padded by one column against bank conflicts). Each of its 256
// threads accumulates a 4 x 4 block of dot products (rows ty + 16 i, codes
// tx + 16 j), then folds the 16 distances into a running (dist, idx) per row
// with a strict < over ascending codes. The 16 threads that share a row
// reduce their pairs with warp shuffles, comparing (dist, idx)
// lexicographically. Loads are scalar and masked, so any D (791 is not a
// multiple of 4), any N and any B >= 1 work without padding in memory.
//
// A small B leaves most SMs idle (160 rows are 3 row tiles), so the wrapper
// may split the codes into `splits` contiguous ranges, one per grid row.
// Each CTA then writes its rows' partial (dist, idx) to scratch, and a second
// kernel reduces the splits per row in the same lexicographic order.
//
// Each .cu that includes this header builds into its own shared library, so
// the extern "C" helpers at the end exist once per library.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace vq {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int TX = BN / TN;  // 16 threads across the codes of a tile
constexpr int TY = BM / TM;  // 16 threads across the rows of a tile
constexpr int THREADS = TX * TY;

__device__ __forceinline__ bool better(float d, int i, float best_d, int best_i) {
  return d < best_d || (d == best_d && i < best_i);
}

__global__ void __launch_bounds__(THREADS)
nearest_tile_kernel(const float* __restrict__ z, const float* __restrict__ c,
                    const float* __restrict__ cn, int B, int N, int D,
                    int codes_per_split, int* __restrict__ ids,
                    float* __restrict__ part_d, int* __restrict__ part_i) {
  __shared__ float zs[BK][BM + 1];
  __shared__ float cs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int code_begin = blockIdx.y * codes_per_split;
  const int code_end = min(N, code_begin + codes_per_split);

  float best_d[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_d[i] = CUDART_INF_F;
    best_i[i] = INT_MAX;
  }

  for (int n0 = code_begin; n0 < code_end; n0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      // consecutive threads read consecutive columns of one row: coalesced
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gr = row0 + r, gk = k0 + k;
        zs[k][r] = (gr < B && gk < D) ? z[(size_t)gr * D + gk] : 0.f;
      }
      for (int e = tid; e < BN * BK; e += THREADS) {
        const int r = e / BK, k = e % BK;
        const int gn = n0 + r, gk = k0 + k;
        cs[k][r] = (gn < code_end && gk < D) ? c[(size_t)gn * D + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = zs[k][ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = cs[k][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // codes tx + 16 j ascend with j, and tiles ascend with n0
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TX * j;
      if (n < code_end) {
        const float cnn = cn[n];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float d = cnn - 2.f * acc[i][j];
          if (d < best_d[i]) {
            best_d[i] = d;
            best_i[i] = n;
          }
        }
      }
    }
  }

  // the 16 threads of a row are lanes that differ only in their low 4 bits
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float d = best_d[i];
    int idx = best_i[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
      if (better(od, oi, d, idx)) {
        d = od;
        idx = oi;
      }
    }
    const int r = row0 + ty + TY * i;
    if (tx == 0 && r < B) {
      if (gridDim.y == 1) {
        ids[r] = idx == INT_MAX ? 0 : idx;  // no finite distance: argmin's 0
      } else {
        part_d[(size_t)blockIdx.y * B + r] = d;
        part_i[(size_t)blockIdx.y * B + r] = idx;
      }
    }
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ part_d,
                                     const int* __restrict__ part_i, int B,
                                     int splits, int* __restrict__ ids) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B) return;
  float d = part_d[r];
  int idx = part_i[r];
  for (int s = 1; s < splits; ++s) {
    const float od = part_d[(size_t)s * B + r];
    const int oi = part_i[(size_t)s * B + r];
    if (better(od, oi, d, idx)) {
      d = od;
      idx = oi;
    }
  }
  ids[r] = idx == INT_MAX ? 0 : idx;
}

// Enqueue the lookup on `s`: z [B, D], c [N, D], cn [N] fp32 and ids [B]
// int32, all contiguous on the current device. codes_per_split is a multiple
// of BN; with splits > 1, part_d [splits, B] fp32 and part_i [splits, B]
// int32 are scratch. Returns the cudaError_t of the launches.
inline cudaError_t launch_nearest(const float* z, const float* c, const float* cn,
                                  int* ids, float* part_d, int* part_i, int B,
                                  int N, int D, int codes_per_split, int splits,
                                  cudaStream_t s) {
  const dim3 grid((B + BM - 1) / BM, splits);
  nearest_tile_kernel<<<grid, THREADS, 0, s>>>(z, c, cn, B, N, D, codes_per_split,
                                               ids, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  reduce_splits_kernel<<<(B + 255) / 256, 256, 0, s>>>(part_d, part_i, B, splits,
                                                       ids);
  return cudaGetLastError();
}

}  // namespace vq

extern "C" {

// Tile sizes the wrapper needs to size the grid and the split scratch.
int vq_nearest_block_rows() { return vq::BM; }
int vq_nearest_block_codes() { return vq::BN; }

const char* vq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
