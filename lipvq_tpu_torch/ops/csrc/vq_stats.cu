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
// Bound. The lookup's 2*B*N*D fp32 operations dominate; the stats need one
// read of z (B*D*4 bytes: 872 MB, 0.26 ms at 3.35 TB/s at the corpus shape
// 2^20 x 1024 x 208) and B*D adds. What bounds a deterministic stats pass
// is the order: each sum must be one fp32 chain over its rows in ascending
// order, so a code that owns all B rows is B dependent adds per column
// (~4 cycles each: about 2.1 ms at B = 2^20 and 1980 MHz, whatever the
// design).
//
// Design: a deterministic counting sort of the rows by code, then per-code
// sums. No float atomics; integer atomics only in the histogram.
//   1. hist: each tile of STATS_TILE_ROWS rows counts its ids in a shared
//      histogram (warp-aggregated with __match_any_sync) and writes its
//      counts to tile_counts [N, T] (code-major, T tiles). The histogram
//      holds HIST_CODES ints, so codes go in ranges [lo, lo + HIST_CODES),
//      one hist launch per range, each counting only the ids in its range;
//      every launch reads the B ids again (4 MB at B = 2^20), and N is
//      bounded only by the scratch (tile_counts is N x T ints: 134 MB at
//      N = 65536, B = 2^20).
//   2. colscan: one warp per code turns its row of tile_counts into
//      exclusive offsets over tiles and writes the code's total.
//   3. codescan: one CTA scans the totals over codes into code_start [N + 1],
//      writes counts = float(total), and lists the codes with more than
//      LONG_BUCKET rows.
//   4. scatter: one warp per tile walks its rows in ascending order; each
//      row's rank among the earlier rows of its code is the code's running
//      base in shared memory plus its rank in the warp (__match_any_sync and
//      the lane-mask prefix), so order [B] ends up equal to
//      torch.argsort(ids, stable=True). Over the same code ranges as hist:
//      a row's slot depends only on its own code's offsets, so the ranges
//      place disjoint rows and their order does not matter.
//   5. sums: one warp per (code, 32 columns) walks order[code_start[n] :
//      code_start[n + 1]] with a lane per column, 32 rows' loads issued
//      before their adds, each column one fp32 register from 0.f: the chain
//      of a sequential ascending sum, bit for bit. The next 32 row indices
//      are read before this batch's loads. Buckets of up to LONG_BUCKET rows
//      only.
//   6. long sums: a code with more rows (at random init every latent maps to
//      one code, so the EMA path's first steps put all B rows there) gets a
//      CTA per 32 columns whose 8 loader warps keep up to LONG_STAGES x 256
//      rows of loads in flight through a cp.async ring (each stage's row
//      indices read one stage earlier) while one more warp adds them in
//      order. At D = 208 that is only 7 busy CTAs, and the dependent adds
//      bound them (see Bound); splitting a code's rows into separately summed
//      chunks would change the order, and so the bits.
// The Pallas kernel carried the stats across its sequential grid; nothing
// is padded in memory here, so there are no pad rows to subtract.

#include "vq_nearest_tile.cuh"

namespace {

constexpr int STATS_TILE_ROWS = 2048;  // rows per histogram / scatter tile
constexpr int LONG_BUCKET = 1024;      // longer buckets go to long_sums_kernel
constexpr int HIST_CODES = 49152;      // codes of one shared histogram range
constexpr int SUM_COLS = 32;           // columns per warp in the sums
constexpr int LONG_LOADERS = 8;        // loader warps; one more warp adds
constexpr int LONG_THREADS = 32 * (LONG_LOADERS + 1);
constexpr int LONG_ROWS = 256;         // rows per stage of the long ring
constexpr int LONG_LD = LONG_ROWS + 4; // a column's stride in the ring
constexpr int LONG_STAGES = 4;
constexpr int LONG_GRID = 128;         // CTAs per column block of the long sums
constexpr size_t LONG_SMEM = sizeof(float) * LONG_STAGES * SUM_COLS * LONG_LD;

struct StatsScratch {
  int* tile_counts;  // [N, T]
  int* totals;       // [N]
  int* code_start;   // [N + 1]
  int* long_list;    // [1 + N]: count, then codes
  int* order;        // [B]
};

int tiles_of(int B) { return (B + STATS_TILE_ROWS - 1) / STATS_TILE_ROWS; }

// order comes first, so that a test can find it at a fixed offset
StatsScratch stats_scratch(void* base, int B, int N) {
  int* p = static_cast<int*>(base);
  StatsScratch s;
  s.order = p;
  p += vq::align4(B);
  s.tile_counts = p;
  p += vq::align4(static_cast<size_t>(N) * tiles_of(B));
  s.totals = p;
  p += vq::align4(N);
  s.code_start = p;
  p += vq::align4(static_cast<size_t>(N) + 1);
  s.long_list = p;
  return s;
}

size_t stats_scratch_elems(int B, int N) {
  return vq::align4(B) + vq::align4(static_cast<size_t>(N) * tiles_of(B)) + vq::align4(N) +
         2 * vq::align4(static_cast<size_t>(N) + 1);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// The id of row r relative to the code range [lo, lo + cnt), or -1 for a
// row outside the tile or the range.
__device__ __forceinline__ int id_in_range(const int* __restrict__ ids, int r, int r1, int lo,
                                           int cnt) {
  const int id = r < r1 ? ids[r] - lo : -1;
  return static_cast<unsigned>(id) < static_cast<unsigned>(cnt) ? id : -1;
}

__global__ void hist_kernel(const int* __restrict__ ids, int B, int lo, int cnt, int T,
                            int* __restrict__ tile_counts) {
  extern __shared__ int hist[];  // [cnt]: codes lo .. lo + cnt - 1
  const int t = blockIdx.x;
  const int r0 = t * STATS_TILE_ROWS, r1 = min(B, r0 + STATS_TILE_ROWS);
  for (int n = threadIdx.x; n < cnt; n += blockDim.x) hist[n] = 0;
  __syncthreads();
  for (int base = r0; base < r1; base += blockDim.x) {
    const int id = id_in_range(ids, base + threadIdx.x, r1, lo, cnt);
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    if (id >= 0 && (peers & lanemask_lt()) == 0) atomicAdd(&hist[id], __popc(peers));
  }
  __syncthreads();
  for (int n = threadIdx.x; n < cnt; n += blockDim.x)
    tile_counts[static_cast<size_t>(lo + n) * T + t] = hist[n];
}

__global__ void colscan_kernel(int* __restrict__ tile_counts, int N, int T,
                               int* __restrict__ totals) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;
  int* a = tile_counts + static_cast<size_t>(n) * T;
  int carry = 0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    const int t = t0 + lane;
    const int v = t < T ? a[t] : 0;
    int incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (t < T) a[t] = carry + incl - v;
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) totals[n] = carry;
}

// Exclusive scan of v over a CTA of 1024 threads; *total gets the sum.
__device__ int block_exclusive_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = ws[lane];
    int winc = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, off);
      if (lane >= off) winc += y;
    }
    ws[lane] = winc - w;
    if (lane == 31) ws[32] = winc;
  }
  __syncthreads();
  const int out = ws[warp] + incl - v;
  *total = ws[32];
  __syncthreads();  // ws is reused by the next scan
  return out;
}

__global__ void __launch_bounds__(1024)
codescan_kernel(const int* __restrict__ totals, int N, int* __restrict__ code_start,
                float* __restrict__ counts, int* __restrict__ long_list) {
  __shared__ int ws[33];
  const int chunk = (N + 1023) / 1024;
  const int n0 = min(N, static_cast<int>(threadIdx.x) * chunk), n1 = min(N, n0 + chunk);
  int sum = 0, longs = 0;
  for (int n = n0; n < n1; ++n) {
    sum += totals[n];
    longs += totals[n] > LONG_BUCKET;
  }
  int total, total_longs;
  int run = block_exclusive_scan(sum, ws, &total);
  int k = block_exclusive_scan(longs, ws, &total_longs);
  for (int n = n0; n < n1; ++n) {
    const int m = totals[n];
    code_start[n] = run;
    counts[n] = static_cast<float>(m);
    run += m;
    if (m > LONG_BUCKET) long_list[1 + k++] = n;
  }
  if (threadIdx.x == 0) {
    code_start[N] = total;
    long_list[0] = total_longs;
  }
}

__global__ void scatter_kernel(const int* __restrict__ ids, int B, int lo, int cnt, int T,
                               const int* __restrict__ tile_counts,
                               const int* __restrict__ code_start, int* __restrict__ order) {
  extern __shared__ int next_slot[];  // per code of the range: this tile's next free slot
  const int t = blockIdx.x, lane = threadIdx.x;
  for (int n = lane; n < cnt; n += 32)
    next_slot[n] = code_start[lo + n] + tile_counts[static_cast<size_t>(lo + n) * T + t];
  __syncwarp();
  const int r0 = t * STATS_TILE_ROWS, r1 = min(B, r0 + STATS_TILE_ROWS);
  int next_id = id_in_range(ids, r0 + lane, r1, lo, cnt);
  for (int base = r0; base < r1; base += 32) {
    const int id = next_id;
    next_id = id_in_range(ids, base + 32 + lane, r1, lo, cnt);
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int slot = id >= 0 ? next_slot[id] : 0;
    __syncwarp();
    if (id >= 0) {
      order[slot + __popc(peers & lanemask_lt())] = base + lane;
      if ((peers & lanemask_lt()) == 0) next_slot[id] = slot + __popc(peers);
    }
    __syncwarp();
  }
}

__global__ void short_sums_kernel(const float* __restrict__ z, const int* __restrict__ order,
                                  const int* __restrict__ code_start, int N, int D,
                                  int col_blocks, float* __restrict__ sums) {
  const int lane = threadIdx.x & 31;
  const long long g = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (g >= static_cast<long long>(N) * col_blocks) return;
  const int n = static_cast<int>(g / col_blocks);
  const int col = static_cast<int>(g % col_blocks) * SUM_COLS + lane;
  const int start = code_start[n], end = code_start[n + 1];
  if (end - start > LONG_BUCKET) return;  // long_sums_kernel's
  float acc = 0.f;
  int next = start + lane < end ? order[start + lane] : 0;
  for (int j0 = start; j0 < end; j0 += 32) {
    const int m = min(32, end - j0);
    const int mine = next;
    next = j0 + 32 + lane < end ? order[j0 + 32 + lane] : 0;  // the next 32 rows
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const int row = __shfl_sync(0xffffffffu, mine, u);
      v[u] = u < m && col < D ? z[static_cast<size_t>(row) * D + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 32; ++u)
      if (u < m) acc += v[u];
  }
  if (col < D) sums[static_cast<size_t>(n) * D + col] = acc;
}

// Warp 0 adds; warps 1..LONG_LOADERS each copy LONG_ROWS / LONG_LOADERS rows
// of every stage, with the row indices of a stage read one iteration before
// its copies start. The ring is column-major ([col][row], padded), so the
// adding lane reads 4 rows of its column per 16-byte load.
__global__ void __launch_bounds__(LONG_THREADS)
long_sums_kernel(const float* __restrict__ z, const int* __restrict__ order,
                 const int* __restrict__ code_start, const int* __restrict__ long_list,
                 int D, float* __restrict__ sums) {
  extern __shared__ __align__(16) float ring[];  // [LONG_STAGES][SUM_COLS][LONG_LD]
  constexpr int WARP_ROWS = LONG_ROWS / LONG_LOADERS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool loader = warp > 0;
  const int lw = warp - 1;
  const int col = blockIdx.y * SUM_COLS + lane;
  const int num_long = long_list[0];
  for (int k = blockIdx.x; k < num_long; k += gridDim.x) {
    const int n = long_list[1 + k];
    const int start = code_start[n], end = code_start[n + 1];
    const int stages = (end - start + LONG_ROWS - 1) / LONG_ROWS;
    auto rows_of = [&](int s) {
      const int j = start + s * LONG_ROWS + lw * WARP_ROWS + lane;
      return lane < WARP_ROWS && j < end ? order[j] : 0;
    };
    auto copy = [&](int s, int rows) {
      const int j0 = start + s * LONG_ROWS + lw * WARP_ROWS;
      float* dst = ring + ((s % LONG_STAGES) * SUM_COLS + lane) * LONG_LD + lw * WARP_ROWS;
#pragma unroll
      for (int i = 0; i < WARP_ROWS; ++i) {
        const int row = __shfl_sync(0xffffffffu, rows, i);
        const bool ok = j0 + i < end && col < D;
        vq::cp_async4(dst + i, ok ? z + static_cast<size_t>(row) * D + col : z, ok);
      }
    };
    int next = loader ? rows_of(0) : 0;
#pragma unroll
    for (int s = 0; s < LONG_STAGES - 1; ++s) {
      if (loader) {
        const int rows = next;
        next = rows_of(s + 1);
        if (s < stages) copy(s, rows);
      }
      vq::cp_async_commit();
    }
    float acc = 0.f;
    for (int s = 0; s < stages; ++s) {
      vq::cp_async_wait<LONG_STAGES - 2>();
      __syncthreads();  // stage s has landed; warp 0 is done with stage s - 1
      if (loader) {
        const int t = s + LONG_STAGES - 1;
        const int rows = next;
        next = rows_of(t + 1);
        if (t < stages) copy(t, rows);
      } else {
        const float* src = ring + ((s % LONG_STAGES) * SUM_COLS + lane) * LONG_LD;
        const int m = min(LONG_ROWS, end - start - s * LONG_ROWS);
        if (m == LONG_ROWS) {
#pragma unroll
          for (int r = 0; r < LONG_ROWS; r += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + r);
            acc += v.x;
            acc += v.y;
            acc += v.z;
            acc += v.w;
          }
        } else {
          for (int r = 0; r < m; ++r) acc += src[r];
        }
      }
      vq::cp_async_commit();
    }
    if (!loader && col < D) sums[static_cast<size_t>(n) * D + col] = acc;
    vq::cp_async_wait<0>();
    __syncthreads();  // the ring is refilled for the next code
  }
}

cudaError_t smem_attr(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// 4-byte elements of scratch that vq_stats_launch needs: the lookup's,
// then the sort's, whose first B are the row order.
size_t vq_stats_scratch_elems(int B, int N, int splits) {
  return vq::lookup_scratch_elems(B, N, splits) + stats_scratch_elems(B, N);
}

// z [B, D], c [N, D] fp32; ids [B] int32; counts [N] and sums [N, D] fp32;
// scratch of vq_stats_scratch_elems 4-byte elements; all contiguous on the
// current device. config, codes_per_split and splits are the lookup's, as in
// vq_nearest_launch. Enqueues everything on `stream`, allocates nothing,
// writes every element of counts and sums, and returns the first
// cudaError_t.
int vq_stats_launch(const float* z, const float* c, int* ids, float* counts, float* sums,
                    void* scratch, int B, int N, int D, int config, int codes_per_split,
                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = vq::launch_nearest(z, c, ids, scratch, B, N, D, config, codes_per_split,
                                       splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  StatsScratch st = stats_scratch(
      static_cast<int*>(scratch) + vq::lookup_scratch_elems(B, N, splits), B, N);
  const int T = tiles_of(B);
  const size_t hist_smem = sizeof(int) * min(N, HIST_CODES);
  if ((err = smem_attr(reinterpret_cast<const void*>(hist_kernel), hist_smem)) != cudaSuccess ||
      (err = smem_attr(reinterpret_cast<const void*>(scatter_kernel), hist_smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  for (int lo = 0; lo < N; lo += HIST_CODES) {
    const int cnt = min(HIST_CODES, N - lo);
    hist_kernel<<<T, 256, sizeof(int) * cnt, s>>>(ids, B, lo, cnt, T, st.tile_counts);
  }
  colscan_kernel<<<(N + 7) / 8, 256, 0, s>>>(st.tile_counts, N, T, st.totals);
  codescan_kernel<<<1, 1024, 0, s>>>(st.totals, N, st.code_start, counts, st.long_list);
  for (int lo = 0; lo < N; lo += HIST_CODES) {
    const int cnt = min(HIST_CODES, N - lo);
    scatter_kernel<<<T, 32, sizeof(int) * cnt, s>>>(ids, B, lo, cnt, T, st.tile_counts,
                                                    st.code_start, st.order);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int col_blocks = (D + SUM_COLS - 1) / SUM_COLS;
  const long long warps = static_cast<long long>(N) * col_blocks;
  short_sums_kernel<<<static_cast<unsigned>((warps + 7) / 8), 256, 0, s>>>(
      z, st.order, st.code_start, N, D, col_blocks, sums);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int max_long = B / (LONG_BUCKET + 1);  // codes that can hold more rows
  if (max_long > 0) {
    if ((err = smem_attr(reinterpret_cast<const void*>(long_sums_kernel), LONG_SMEM)) !=
        cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid(min(max_long, LONG_GRID), col_blocks);
    long_sums_kernel<<<grid, LONG_THREADS, LONG_SMEM, s>>>(z, st.order, st.code_start,
                                                          st.long_list, D, sums);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
