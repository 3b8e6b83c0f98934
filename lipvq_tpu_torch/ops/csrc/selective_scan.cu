// The selective scan of the Mamba mixer, forward and backward, the state
// kept on chip.
//
// Replaces the sequential loop of lipvq_tpu_torch/models/mamba.py (the JAX
// package's lipvq_tpu/models/mamba.py::selective_scan, an associative_scan
// left to XLA; there is no Pallas kernel of it). For x, dt [B, T, D],
// A [D, N], Bm, Cm [B, T, N] and Dv [D], all fp32, per channel d and state n
//
//     h[t] = exp(dt[t] A[n]) h[t-1] + dt[t] Bm[t, n] x[t]      (h[-1] = 0)
//     y[t] = sum_n Cm[t, n] h[t] + Dv x[t]
//
// Bound. Per element (b, t, d, n) a forward is an exponential and two
// multiply-adds; a backward recomputes the state twice and adds about a
// dozen products. The bytes are x, dt, dy, y, dx and ddt once per
// (b, t, d) and Bm, Cm, dBm, dCm once per (b, t, n). The plain loop writes
// exp(dt A) and dt Bm x as [B, T, D, N] fp32 tensors and autograd keeps
// every step's state: N times the bytes of x for each. At the ICL backbone's
// 192 x 30 x 5120 x 16 that is 1.9 GB per tensor per layer; here nothing of
// size [B, T, D, N] leaves the SM, so a layer's forward and backward move
// about 0.7 GB (0.21 ms at 3.35 TB/s). What bounds the kernels is the
// exponentials: 472 M per pass over the state at that shape, 0.12 ms each
// on the SFUs (exp2f of dt A log2(e), one MUFU.EX2 each), one pass in the
// forward and three in the backward.
//
// Design. A thread per channel holds its N states in registers (NS = N
// rounded up to a power of two, 4 to 32), so the sums over the states stay
// in the thread; a block takes THR channels of BATCH_GROUP sequences (the
// forward one sequence) and stages each sequence's Bm and Cm in shared
// memory, CHUNK steps at a time.
//   fwd: walks t; x and dt of the block's channels are staged too.
//   bwd: for each chunk of up to CHUNK steps (the last first), the state
//        before it is recomputed from t = 0; a first pass writes the state
//        at the start of each SEG-step segment to shared memory, a second
//        walks the segments from the last, recomputes each one's states in
//        registers and walks it backwards with the adjoint
//        dh[t] = Cm[t] dy[t] + exp(dt[t+1] A) dh[t+1]. dx and ddt are the
//        thread's own sums over its states. dBm and dCm sum over the
//        channels: over the warp by a reduce-scatter butterfly (each lane
//        ends with one state's sum), over the block's warps in shared
//        memory, in a fixed order, written as one partial per block; dA and
//        dDv sum over the block's sequences.
//   reduce: sums each partial over its blocks in order. No atomics: the
//        result is the same on every run.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int FWD_THREADS = 128;
constexpr int RED_THREADS = 256;
constexpr int CHUNK = 32;       // steps staged in shared memory at a time
constexpr int SEG = 4;          // steps whose states the backward keeps in registers
constexpr int NSEG = CHUNK / SEG;
constexpr int BATCH_GROUP = 8;  // sequences per block in the backward
constexpr int MAX_STATE = 32;
constexpr int MAX_GRID_Y = 65535;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// states per thread: N rounded up to a power of two, at least 4 (fewer
// states leave registers idle rather than add a kernel to the build)
int states_of(int n) {
  int g = 4;
  while (g < n) g <<= 1;
  return g;
}

// channels per backward block: the block's segment states fill the same
// shared memory whatever NS
__host__ __device__ constexpr int bwd_threads(int ns) { return ns <= 8 ? 256 : 2048 / ns; }

int groups_of(int batch) { return (batch + BATCH_GROUP - 1) / BATCH_GROUP; }

template <int NS>
__global__ void __launch_bounds__(FWD_THREADS)
selective_scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          float* __restrict__ y, int batch, int T, int D, int N) {
  // a chunk of steps of the block's x and dt, and of the sequence's Bm and Cm
  __shared__ float sx[2][CHUNK][FWD_THREADS];
  __shared__ float bc[2][CHUNK][NS];
  const int ch = blockIdx.x * FWD_THREADS + threadIdx.x;
  const bool live = ch < D;
  float a2[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) a2[n] = live && n < N ? A[(size_t)ch * N + n] * LOG2E : 0.f;
  const float dd = live ? Dv[ch] : 0.f;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
#pragma unroll
    for (int n = 0; n < NS; ++n) h[n] = 0.f;
    for (int t0 = 0; t0 < T; t0 += CHUNK) {
      const int len = min(CHUNK, T - t0);
      __syncthreads();
      for (int k = threadIdx.x; k < len * NS; k += FWD_THREADS) {
        const int i = k / NS, n = k % NS;
        const size_t s = ((size_t)b * T + t0 + i) * N + n;
        bc[0][i][n] = n < N ? Bm[s] : 0.f;
        bc[1][i][n] = n < N ? Cm[s] : 0.f;
      }
      for (int i = 0; i < len; ++i) {
        const size_t e = ((size_t)b * T + t0 + i) * D + ch;
        sx[0][i][threadIdx.x] = live ? x[e] : 0.f;
        sx[1][i][threadIdx.x] = live ? dt[e] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      for (int i = 0; i < len; ++i) {
        const float xv = sx[0][i][threadIdx.x], dtv = sx[1][i][threadIdx.x], u = dtv * xv;
        float p = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          h[n] = exp2f(dtv * a2[n]) * h[n] + u * bc[0][i][n];
          p += bc[1][i][n] * h[n];
        }
        y[((size_t)b * T + t0 + i) * D + ch] = p + dd * xv;
      }
    }
  }
}

// v[0..CNT) over the 32 lanes of a warp, halved CNT times: at each level the
// lanes with bit OFF set keep the upper half and add their partner's, so the
// lane ends with v[0] the sum of one index, (lane >> (5 - log2 NS)) & (NS - 1),
// over the lanes that agree with it on the bits used; the rest of the
// butterfly adds those.
template <int CNT, int OFF, int NS>
__device__ __forceinline__ void halve(float (&v)[NS], int lane) {
  if constexpr (CNT > 1) {
    const bool upper = lane & OFF;
#pragma unroll
    for (int k = 0; k < CNT / 2; ++k) {
      const float send = upper ? v[k] : v[k + CNT / 2];
      const float keep = upper ? v[k + CNT / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    halve<CNT / 2, OFF / 2, NS>(v, lane);
  }
}

template <int NS>
__device__ __forceinline__ float reduce_scatter(float (&v)[NS], int lane) {
  halve<NS, 16, NS>(v, lane);
#pragma unroll
  for (int off = 16 / NS; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

template <int NS>
__global__ void __launch_bounds__(bwd_threads(NS))
selective_scan_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          const float* __restrict__ dy, float* __restrict__ dx,
                          float* __restrict__ ddt, float* __restrict__ part_b,
                          float* __restrict__ part_c, float* __restrict__ part_a,
                          float* __restrict__ part_d, int batch, int T, int D, int N) {
  constexpr int THR = bwd_threads(NS);
  constexpr int WB = THR / 32;
  constexpr int SHIFT = NS == 4 ? 3 : NS == 8 ? 2 : NS == 16 ? 1 : 0;
  // ck[s][n][thread]: the state at the start of segment s; bc[k][i][n]:
  // the sequence's Bm (k = 0) and Cm (k = 1); red[k][w][i][n]: warp w's sums
  // over its channels of dBm and dCm (each (w, i, n) written once a chunk)
  extern __shared__ float smem[];
  float* ck = smem;
  float* bc = ck + NSEG * NS * THR;
  float* red = bc + 2 * CHUNK * NS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch = blockIdx.x * THR + threadIdx.x;
  const bool live = ch < D;
  float a2[NS], da[NS], carry[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = live && n < N ? A[(size_t)ch * N + n] * LOG2E : 0.f;
    da[n] = 0.f;
  }
  const float dd = live ? Dv[ch] : 0.f;
  float dsum = 0.f;
  const int b0 = blockIdx.y * BATCH_GROUP;
  const int b1 = min(b0 + BATCH_GROUP, batch);
  const int chunks = (T + CHUNK - 1) / CHUNK;

  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int n = 0; n < NS; ++n) carry[n] = 0.f;  // exp(dt[t+1] A) dh[t+1] past the chunk
    for (int c = chunks - 1; c >= 0; --c) {
      const int t0 = c * CHUNK;
      const int len = min(CHUNK, T - t0);
      __syncthreads();  // the last chunk's partial sums are read
      for (int k = threadIdx.x; k < CHUNK * NS; k += THR) {
        const int i = k / NS, n = k % NS;
        const size_t s = ((size_t)b * T + t0 + i) * N + n;
        const bool in = i < len && n < N;
        bc[k] = in ? Bm[s] : 0.f;
        bc[CHUNK * NS + k] = in ? Cm[s] : 0.f;
      }
      __syncthreads();
      // the state before the chunk, recomputed from t = 0
      float h[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) h[n] = 0.f;
      for (int t = 0; t < t0; ++t) {
        const size_t e = ((size_t)b * T + t) * D + ch;
        const float dtv = live ? dt[e] : 0.f, u = live ? dtv * x[e] : 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float bv = n < N ? Bm[((size_t)b * T + t) * N + n] : 0.f;
          h[n] = exp2f(dtv * a2[n]) * h[n] + u * bv;
        }
      }
      // pass 1: the state at the start of each segment
      const int nseg = (len + SEG - 1) / SEG;
      for (int s = 0; s < nseg; ++s) {
#pragma unroll
        for (int n = 0; n < NS; ++n) ck[(s * NS + n) * THR + threadIdx.x] = h[n];
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const int i = s * SEG + k;
          if (i < len) {
            const size_t e = ((size_t)b * T + t0 + i) * D + ch;
            const float dtv = live ? dt[e] : 0.f, u = live ? dtv * x[e] : 0.f;
#pragma unroll
            for (int n = 0; n < NS; ++n) h[n] = exp2f(dtv * a2[n]) * h[n] + u * bc[i * NS + n];
          }
        }
      }
      // pass 2: the segments from the last, each walked backwards
      for (int s = nseg - 1; s >= 0; --s) {
        float hs[SEG][NS], xs[SEG], dts[SEG], dys[SEG];
#pragma unroll
        for (int n = 0; n < NS; ++n) h[n] = ck[(s * NS + n) * THR + threadIdx.x];
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const int i = s * SEG + k;
          xs[k] = dts[k] = dys[k] = 0.f;
          if (i < len && live) {
            const size_t e = ((size_t)b * T + t0 + i) * D + ch;
            xs[k] = x[e];
            dts[k] = dt[e];
            dys[k] = dy[e];
          }
        }
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const float u = dts[k] * xs[k];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float prev = k > 0 ? hs[k > 0 ? k - 1 : 0][n] : h[n];
            hs[k][n] = exp2f(dts[k] * a2[n]) * prev + u * bc[min(s * SEG + k, CHUNK - 1) * NS + n];
          }
        }
#pragma unroll
        for (int k = SEG - 1; k >= 0; --k) {
          const int i = s * SEG + k;
          if (i < len) {  // the same for every thread: the butterflies see the whole warp
            const float xv = xs[k], dtv = dts[k], dyv = dys[k], u = dtv * xv;
            float gb[NS], gc[NS], s_a = 0.f, s_b = 0.f;
#pragma unroll
            for (int n = 0; n < NS; ++n) {
              const float bv = bc[i * NS + n], cv = bc[CHUNK * NS + i * NS + n];
              const float hp = k > 0 ? hs[k > 0 ? k - 1 : 0][n] : h[n];
              const float eA = exp2f(dtv * a2[n]);
              const float dh = carry[n] + cv * dyv;
              const float he = hp * eA;
              gc[n] = dyv * hs[k][n];
              gb[n] = dh * u;
              s_a += dh * he * a2[n];
              s_b += dh * bv;
              da[n] += dh * he * dtv;
              carry[n] = eA * dh;
            }
            if (live) {
              const size_t e = ((size_t)b * T + t0 + i) * D + ch;
              ddt[e] = s_a * LN2 + s_b * xv;
              dx[e] = s_b * dtv + dd * dyv;
              dsum += dyv * xv;
            }
            const float sb = reduce_scatter<NS>(gb, lane);
            const float sc = reduce_scatter<NS>(gc, lane);
            if ((lane & ((1 << SHIFT) - 1)) == 0) {
              const int n = (lane >> SHIFT) & (NS - 1);
              red[(warp * CHUNK + i) * NS + n] = sb;
              red[((WB + warp) * CHUNK + i) * NS + n] = sc;
            }
          }
        }
      }
      __syncthreads();
      // the block's partial sums over its channels, its warps in order
      for (int k = threadIdx.x; k < len * N; k += THR) {
        const int i = k / N, n = k % N;
        float sb = 0.f, sc = 0.f;
        for (int w = 0; w < WB; ++w) {
          sb += red[(w * CHUNK + i) * NS + n];
          sc += red[((WB + w) * CHUNK + i) * NS + n];
        }
        const size_t o = (((size_t)b * gridDim.x + blockIdx.x) * T + t0 + i) * N + n;
        part_b[o] = sb;
        part_c[o] = sc;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
      if (n < N) part_a[((size_t)blockIdx.y * D + ch) * N + n] = da[n];
    part_d[(size_t)blockIdx.y * D + ch] = dsum;
  }
}

// out[o, i] = sum over k in order of part[o, k, i]; part [outer, K, inner]
__global__ void selective_scan_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ out, int outer, int K,
                                             int inner) {
  const size_t total = (size_t)outer * inner;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t o = idx / inner, i = idx % inner;
    const float* p = part + o * (size_t)K * inner + i;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += p[(size_t)k * inner];
    out[idx] = s;
  }
}

cudaError_t reduce(const float* part, float* out, int outer, int K, int inner,
                   cudaStream_t s) {
  const size_t blocks = ((size_t)outer * inner + RED_THREADS - 1) / RED_THREADS;
  selective_scan_reduce_kernel<<<(int)(blocks < 65536 ? blocks : 65536), RED_THREADS, 0, s>>>(
      part, out, outer, K, inner);
  return cudaGetLastError();
}

template <int NS>
cudaError_t launch_fwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dv, float* y, int batch, int T, int D,
                       int N, cudaStream_t s) {
  const dim3 grid((D + FWD_THREADS - 1) / FWD_THREADS, batch < MAX_GRID_Y ? batch : MAX_GRID_Y);
  selective_scan_fwd_kernel<NS><<<grid, FWD_THREADS, 0, s>>>(x, dt, A, Bm, Cm, Dv, y, batch, T,
                                                             D, N);
  return cudaGetLastError();
}

int bwd_blocks(int d, int ns) { return (d + bwd_threads(ns) - 1) / bwd_threads(ns); }

size_t bwd_smem_bytes(int ns) {
  const int thr = bwd_threads(ns);
  return sizeof(float) * ((size_t)NSEG * ns * thr + 2 * CHUNK * ns + 2 * (thr / 32) * CHUNK * ns);
}

template <int NS>
cudaError_t launch_bwd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dv, const float* dy, float* dx,
                       float* ddt, float* dA, float* dB, float* dC, float* dD, float* scratch,
                       int batch, int T, int D, int N, cudaStream_t s) {
  const int nblk = bwd_blocks(D, NS), ngrp = groups_of(batch);
  float* part_b = scratch;
  float* part_c = part_b + (size_t)batch * nblk * T * N;
  float* part_a = part_c + (size_t)batch * nblk * T * N;
  float* part_d = part_a + (size_t)ngrp * D * N;
  const size_t smem = bwd_smem_bytes(NS);
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<NS><<<dim3(nblk, ngrp), bwd_threads(NS), smem, s>>>(
      x, dt, A, Bm, Cm, Dv, dy, dx, ddt, part_b, part_c, part_a, part_d, batch, T, D, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce(part_b, dB, batch, nblk, T * N, s)) != cudaSuccess) return err;
  if ((err = reduce(part_c, dC, batch, nblk, T * N, s)) != cudaSuccess) return err;
  if ((err = reduce(part_a, dA, 1, ngrp, D * N, s)) != cudaSuccess) return err;
  return reduce(part_d, dD, 1, ngrp, D, s);
}

}  // namespace

extern "C" {

// A returned cudaError_t's text, under the one name every library exports.
const char* lipvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int selective_scan_max_state() { return MAX_STATE; }

int selective_scan_max_batch() { return MAX_GRID_Y * BATCH_GROUP; }

// 4-byte elements of scratch that selective_scan_bwd_launch needs.
size_t selective_scan_bwd_scratch_elems(int batch, int T, int D, int N) {
  const size_t ngrp = groups_of(batch);
  return 2 * (size_t)batch * bwd_blocks(D, states_of(N)) * T * N + ngrp * D * N + ngrp * D;
}

// x, dt [B, T, D]; A [D, N]; Bm, Cm [B, T, N]; Dv [D] -> y [B, T, D]; fp32,
// contiguous, on the current device, 1 <= N <= 32. Enqueues on `stream`,
// allocates nothing and returns the first cudaError_t.
int selective_scan_fwd_launch(const float* x, const float* dt, const float* A, const float* Bm,
                              const float* Cm, const float* Dv, float* y, int batch, int T,
                              int D, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (states_of(N)) {
    case 4: return launch_fwd<4>(x, dt, A, Bm, Cm, Dv, y, batch, T, D, N, s);
    case 8: return launch_fwd<8>(x, dt, A, Bm, Cm, Dv, y, batch, T, D, N, s);
    case 16: return launch_fwd<16>(x, dt, A, Bm, Cm, Dv, y, batch, T, D, N, s);
    case 32: return launch_fwd<32>(x, dt, A, Bm, Cm, Dv, y, batch, T, D, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradients of the forward's inputs from dy [B, T, D]: dx, ddt [B, T, D],
// dA [D, N], dB, dC [B, T, N], dD [D]; every element written. scratch holds
// selective_scan_bwd_scratch_elems 4-byte elements; batch at most
// selective_scan_max_batch(). Otherwise as selective_scan_fwd_launch.
int selective_scan_bwd_launch(const float* x, const float* dt, const float* A, const float* Bm,
                              const float* Cm, const float* Dv, const float* dy, float* dx,
                              float* ddt, float* dA, float* dB, float* dC, float* dD,
                              void* scratch, int batch, int T, int D, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
#define SCAN_BWD(NS)                                                                       \
  launch_bwd<NS>(x, dt, A, Bm, Cm, Dv, dy, dx, ddt, dA, dB, dC, dD, sc, batch, T, D, N, s)
  switch (states_of(N)) {
    case 4: return SCAN_BWD(4);
    case 8: return SCAN_BWD(8);
    case 16: return SCAN_BWD(16);
    case 32: return SCAN_BWD(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_BWD
}

}  // extern "C"
