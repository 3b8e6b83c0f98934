// K2: nearest-code lookup + the one-hot cluster statistics of the EMA
// codebook, in one call.
//
// Replaces the Pallas kernel lipvq_tpu/ops/vq_lookup.py::_vq_stats_kernel
// (launched by vq_nearest_with_stats_pallas). For z [B, D] and a codebook
// c [N, D] it returns
//
//     ids[b]    = K1's lookup (vq_nearest_tile.cuh, the same tie rule)
//     counts[n] = #{b : ids[b] = n}                 (fp32, exact integers)
//     sums[n]   = sum over b with ids[b] = n of z[b], in ascending b
//
// Bound. The lookup's 2*B*N*D fp32 operations dominate (the stats add only
// B*D adds and write N*(D + 1) floats), so the fp32 SIMT rate bounds K2 as
// it bounds K1.
//
// Design. Phase 1 is K1's lookup, enqueued by the same launcher. Phase 2 is
// deterministic and uses no atomics: a CTA owns STATS_CODES codes x
// STATS_COLS columns and is the only writer of that block of sums and (for
// the first column block) of those counts. It walks the ids in ascending row
// order, STATS_COLS rows at a time: each thread tests one id, a stable
// ballot + prefix compaction lists the tile's matching rows in row order,
// then every thread adds z[row, its column] of each listed row into its own
// column of a shared-memory accumulator. Each sum is therefore one fp32 chain
// over ascending rows, the order of a sequential one_hot^T z, and two runs
// give bit-identical stats. The Pallas kernel carried the stats across its
// sequential grid; here the blocks own disjoint outputs instead, and no
// padded rows exist to subtract (nothing is padded in memory).

#include "vq_nearest_tile.cuh"

namespace {

constexpr int STATS_CODES = 16;   // codes per CTA
constexpr int STATS_COLS = 128;   // columns per CTA = threads = rows per tile
constexpr int STATS_WARPS = STATS_COLS / 32;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(STATS_COLS)
cluster_stats_kernel(const float* __restrict__ z, const int* __restrict__ ids,
                     int B, int N, int D, float* __restrict__ counts,
                     float* __restrict__ sums) {
  __shared__ float acc[STATS_CODES][STATS_COLS];
  __shared__ int rows[STATS_COLS];
  __shared__ int codes[STATS_COLS];
  __shared__ int warp_hits[STATS_WARPS];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int code0 = blockIdx.x * STATS_CODES;
  const int col = blockIdx.y * STATS_COLS + t;
  const bool col_ok = col < D;

#pragma unroll
  for (int k = 0; k < STATS_CODES; ++k) acc[k][t] = 0.f;
  int count = 0;  // rows of code code0 + t, kept by threads t < STATS_CODES

  for (int r0 = 0; r0 < B; r0 += STATS_COLS) {
    const int r = r0 + t;
    const int k = r < B ? ids[r] - code0 : -1;
    const bool hit = k >= 0 && k < STATS_CODES;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int offset = 0, m = 0;
#pragma unroll
    for (int w = 0; w < STATS_WARPS; ++w) {
      offset += w < warp ? warp_hits[w] : 0;
      m += warp_hits[w];
    }
    if (hit) {
      const int slot = offset + __popc(mask & ((1u << lane) - 1u));
      rows[slot] = r;
      codes[slot] = k;
    }
    __syncthreads();

    // each thread adds into its own column only: no races, rows in order
    int j = 0;
    for (; j + UNROLL <= m; j += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = col_ok ? z[(size_t)rows[j + u] * D + col] : 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        acc[codes[j + u]][t] += v[u];
        count += codes[j + u] == t;
      }
    }
    for (; j < m; ++j) {
      acc[codes[j]][t] += col_ok ? z[(size_t)rows[j] * D + col] : 0.f;
      count += codes[j] == t;
    }
    __syncthreads();  // rows, codes and warp_hits are refilled next tile
  }

  if (col_ok) {
#pragma unroll
    for (int k = 0; k < STATS_CODES; ++k)
      if (code0 + k < N) sums[(size_t)(code0 + k) * D + col] = acc[k][t];
  }
  if (blockIdx.y == 0 && t < STATS_CODES && code0 + t < N)
    counts[code0 + t] = static_cast<float>(count);
}

}  // namespace

extern "C" {

// z [B, D], c [N, D], cn [N] fp32; ids [B] int32; counts [N] and sums [N, D]
// fp32, all contiguous on the current device. codes_per_split, splits,
// part_d and part_i are the lookup's, as in vq_nearest_launch. Every element
// of counts and sums is written. Returns the cudaError_t of the launches.
int vq_stats_launch(const float* z, const float* c, const float* cn, int* ids,
                    float* part_d, int* part_i, float* counts, float* sums, int B,
                    int N, int D, int codes_per_split, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vq::launch_nearest(z, c, cn, ids, part_d, part_i, B, N, D,
                                       codes_per_split, splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + STATS_CODES - 1) / STATS_CODES,
                  (D + STATS_COLS - 1) / STATS_COLS);
  cluster_stats_kernel<<<grid, STATS_COLS, 0, s>>>(z, ids, B, N, D, counts, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
