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
//
// Gated. The Mamba mixer's call takes the chain at the scan's two ends
// (mamba_ssm's delta_softplus and z): dt comes as dt_proj's output and the
// forward applies softplus in fp32 where it reads it, and keeps the fp32
// steps for the backward (the accurate expf and log1pf cost as much as a
// channel's 16 states in these instruction-bound kernels; the backward would
// need them in each of its passes); the forward writes out = y * silu(z),
// z the gate half of in_proj's output (rows ldz elements apart), in place
// of y; the backward takes out's gradient, recomputes y with the states,
// and writes the gate's gradient dz and dt_proj output's gradient (ddt
// times softplus'). dt, z, out and their gradients are of one element
// type, fp32 or bf16 (rounded to nearest even); everything else, the state
// and every formula stay fp32 (csrc/ssm_mixer.cuh). The plain scan is the
// same template with fp32 elements and no gate.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ssm_mixer.cuh"

namespace {

using namespace ssm_mixer;

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

// One step of a state, exp(dt A) h + (dt x) B, and one term of y, C h + p,
// each with one fixed rounding (explicit fused multiply-adds), so that the
// backward's recomputed states and y equal the forward's bit for bit.
__device__ __forceinline__ float next_state(float h, float dt_a2, float u, float b) {
  return __fmaf_rn(exp2f(dt_a2), h, __fmul_rn(u, b));
}
__device__ __forceinline__ float add_term(float p, float c, float h) { return __fmaf_rn(c, h, p); }

// the step's dt from its stored value: softplus of dt_proj's output when gated
template <bool GATED, typename E>
__device__ __forceinline__ float step_of(E v) {
  if constexpr (GATED) return softplus(to_float(v));
  else return to_float(v);
}

// the backward's step at element e: the forward's fp32 steps when gated
template <bool GATED, typename E>
__device__ __forceinline__ float step_at(const E* dt, const float* steps, size_t e) {
  if constexpr (GATED) return steps[e];
  else return to_float(dt[e]);
}

template <int NS, typename E, bool GATED>
__global__ void __launch_bounds__(FWD_THREADS)
selective_scan_fwd_kernel(const float* __restrict__ x, const E* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          const E* __restrict__ z, E* __restrict__ y,
                          float* __restrict__ steps, int batch, int T, int D, int N, int ldz) {
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
        const float st = live ? step_of<GATED>(dt[e]) : 0.f;
        sx[1][i][threadIdx.x] = st;
        if constexpr (GATED)
          if (live && steps != nullptr) steps[e] = st;
      }
      __syncthreads();
      if (!live) continue;
      for (int i = 0; i < len; ++i) {
        const float xv = sx[0][i][threadIdx.x], dtv = sx[1][i][threadIdx.x], u = dtv * xv;
        float p = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          h[n] = next_state(h[n], dtv * a2[n], u, bc[0][i][n]);
          p = add_term(p, bc[1][i][n], h[n]);
        }
        const float yv = __fmaf_rn(dd, xv, p);
        if constexpr (GATED)
          y[((size_t)b * T + t0 + i) * D + ch] =
              from_float<E>(yv * silu(to_float(z[((size_t)b * T + t0 + i) * ldz + ch])));
        else
          y[((size_t)b * T + t0 + i) * D + ch] = yv;
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

template <int NS, typename E, bool GATED>
__global__ void __launch_bounds__(bwd_threads(NS))
selective_scan_bwd_kernel(const float* __restrict__ x, const E* __restrict__ dt,
                          const float* __restrict__ A, const float* __restrict__ Bm,
                          const float* __restrict__ Cm, const float* __restrict__ Dv,
                          const E* __restrict__ z, const float* __restrict__ steps,
                          const E* __restrict__ dy, float* __restrict__ dx,
                          E* __restrict__ ddt, E* __restrict__ dz,
                          float* __restrict__ part_b, float* __restrict__ part_c,
                          float* __restrict__ part_a, float* __restrict__ part_d, int batch,
                          int T, int D, int N, int ldz) {
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
        const float dtv = live ? step_at<GATED>(dt, steps, e) : 0.f, u = live ? dtv * x[e] : 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float bv = n < N ? Bm[((size_t)b * T + t) * N + n] : 0.f;
          h[n] = next_state(h[n], dtv * a2[n], u, bv);
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
            const float dtv = live ? step_at<GATED>(dt, steps, e) : 0.f;
            const float u = live ? dtv * x[e] : 0.f;
#pragma unroll
            for (int n = 0; n < NS; ++n) h[n] = next_state(h[n], dtv * a2[n], u, bc[i * NS + n]);
          }
        }
      }
      // pass 2: the segments from the last, each walked backwards
      for (int s = nseg - 1; s >= 0; --s) {
        // dys: y's gradient, or when gated out's; dtr, zs: dt's stored value, the gate
        float hs[SEG][NS], xs[SEG], dts[SEG], dys[SEG], dtr[SEG], zs[SEG];
#pragma unroll
        for (int n = 0; n < NS; ++n) h[n] = ck[(s * NS + n) * THR + threadIdx.x];
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const int i = s * SEG + k;
          xs[k] = dts[k] = dys[k] = dtr[k] = zs[k] = 0.f;
          if (i < len && live) {
            const size_t e = ((size_t)b * T + t0 + i) * D + ch;
            xs[k] = x[e];
            dtr[k] = to_float(dt[e]);
            dts[k] = step_at<GATED>(dt, steps, e);
            dys[k] = to_float(dy[e]);
            if constexpr (GATED) zs[k] = to_float(z[((size_t)b * T + t0 + i) * ldz + ch]);
          }
        }
#pragma unroll
        for (int k = 0; k < SEG; ++k) {
          const float u = dts[k] * xs[k];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            const float prev = k > 0 ? hs[k > 0 ? k - 1 : 0][n] : h[n];
            const float bv = bc[min(s * SEG + k, CHUNK - 1) * NS + n];
            hs[k][n] = next_state(prev, dts[k] * a2[n], u, bv);
          }
        }
#pragma unroll
        for (int k = SEG - 1; k >= 0; --k) {
          const int i = s * SEG + k;
          if (i < len) {  // the same for every thread: the butterflies see the whole warp
            const float xv = xs[k], dtv = dts[k], u = dtv * xv;
            float dyv = dys[k], dzv = 0.f;
            if constexpr (GATED) {  // y as the forward sums it, then the gate's product
              float p = 0.f;
#pragma unroll
              for (int n = 0; n < NS; ++n) p = add_term(p, bc[CHUNK * NS + i * NS + n], hs[k][n]);
              dzv = silu_grad(zs[k], dyv * __fmaf_rn(dd, xv, p));
              dyv = dyv * silu(zs[k]);
            }
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
              if constexpr (GATED) {
                ddt[e] = from_float<E>(softplus_grad(dtr[k], s_a * LN2 + s_b * xv));
                dz[e] = from_float<E>(dzv);
              } else {
                ddt[e] = s_a * LN2 + s_b * xv;
              }
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

template <int NS, typename E, bool GATED>
cudaError_t launch_fwd(const float* x, const void* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dv, const void* z, void* y, float* steps,
                       int batch, int T, int D, int N, int ldz, cudaStream_t s) {
  const dim3 grid((D + FWD_THREADS - 1) / FWD_THREADS, batch < MAX_GRID_Y ? batch : MAX_GRID_Y);
  selective_scan_fwd_kernel<NS, E, GATED><<<grid, FWD_THREADS, 0, s>>>(
      x, static_cast<const E*>(dt), A, Bm, Cm, Dv, static_cast<const E*>(z), static_cast<E*>(y),
      steps, batch, T, D, N, ldz);
  return cudaGetLastError();
}

int bwd_blocks(int d, int ns) { return (d + bwd_threads(ns) - 1) / bwd_threads(ns); }

size_t bwd_smem_bytes(int ns) {
  const int thr = bwd_threads(ns);
  return sizeof(float) * ((size_t)NSEG * ns * thr + 2 * CHUNK * ns + 2 * (thr / 32) * CHUNK * ns);
}

template <int NS, typename E, bool GATED>
cudaError_t launch_bwd(const float* x, const void* dt, const float* A, const float* Bm,
                       const float* Cm, const float* Dv, const void* z, const float* steps,
                       const void* dy, float* dx, void* ddt, void* dz, float* dA, float* dB,
                       float* dC, float* dD, float* scratch, int batch, int T, int D, int N,
                       int ldz, cudaStream_t s) {
  const int nblk = bwd_blocks(D, NS), ngrp = groups_of(batch);
  float* part_b = scratch;
  float* part_c = part_b + (size_t)batch * nblk * T * N;
  float* part_a = part_c + (size_t)batch * nblk * T * N;
  float* part_d = part_a + (size_t)ngrp * D * N;
  const size_t smem = bwd_smem_bytes(NS);
  cudaError_t err = cudaFuncSetAttribute(selective_scan_bwd_kernel<NS, E, GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  selective_scan_bwd_kernel<NS, E, GATED><<<dim3(nblk, ngrp), bwd_threads(NS), smem, s>>>(
      x, static_cast<const E*>(dt), A, Bm, Cm, Dv, static_cast<const E*>(z), steps,
      static_cast<const E*>(dy), dx, static_cast<E*>(ddt), static_cast<E*>(dz), part_b, part_c,
      part_a, part_d, batch, T, D, N, ldz);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = reduce(part_b, dB, batch, nblk, T * N, s)) != cudaSuccess) return err;
  if ((err = reduce(part_c, dC, batch, nblk, T * N, s)) != cudaSuccess) return err;
  if ((err = reduce(part_a, dA, 1, ngrp, D * N, s)) != cudaSuccess) return err;
  return reduce(part_d, dD, 1, ngrp, D, s);
}

template <typename E, bool GATED>
int fwd(const float* x, const void* dt, const float* A, const float* Bm, const float* Cm,
        const float* Dv, const void* z, void* y, float* steps, int batch, int T, int D, int N,
        int ldz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCAN_FWD(NS) \
  launch_fwd<NS, E, GATED>(x, dt, A, Bm, Cm, Dv, z, y, steps, batch, T, D, N, ldz, s)
  switch (states_of(N)) {
    case 4: return SCAN_FWD(4);
    case 8: return SCAN_FWD(8);
    case 16: return SCAN_FWD(16);
    case 32: return SCAN_FWD(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_FWD
}

template <typename E, bool GATED>
int bwd(const float* x, const void* dt, const float* A, const float* Bm, const float* Cm,
        const float* Dv, const void* z, const float* steps, const void* dy, float* dx,
        void* ddt, void* dz, float* dA, float* dB, float* dC, float* dD, void* scratch,
        int batch, int T, int D, int N, int ldz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
#define SCAN_BWD(NS)                                                                     \
  launch_bwd<NS, E, GATED>(x, dt, A, Bm, Cm, Dv, z, steps, dy, dx, ddt, dz, dA, dB, dC, dD, \
                           sc, batch, T, D, N, ldz, s)
  switch (states_of(N)) {
    case 4: return SCAN_BWD(4);
    case 8: return SCAN_BWD(8);
    case 16: return SCAN_BWD(16);
    case 32: return SCAN_BWD(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SCAN_BWD
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
  return fwd<float, false>(x, dt, A, Bm, Cm, Dv, nullptr, y, nullptr, batch, T, D, N, 0, stream);
}

// The mixer's call: dt [B, T, D] dt_proj's output (softplus applied here),
// z [B, T, D] the gate with rows ldz elements apart (ldz >= D), out
// [B, T, D] = y * silu(z); dt, z and out of type `dtype` (ssm_mixer::Dtype);
// steps [B, T, D] fp32, softplus(dt), for the backward, or null where no
// backward follows (then nothing is written there). Otherwise as
// selective_scan_fwd_launch.
int selective_scan_gated_fwd_launch(const float* x, const void* dt, const float* A,
                                    const float* Bm, const float* Cm, const float* Dv,
                                    const void* z, void* out, float* steps, int batch, int T,
                                    int D, int N, int ldz, int dtype, void* stream) {
  if (dtype == F32)
    return fwd<float, true>(x, dt, A, Bm, Cm, Dv, z, out, steps, batch, T, D, N, ldz, stream);
  if (dtype == BF16)
    return fwd<__nv_bfloat16, true>(x, dt, A, Bm, Cm, Dv, z, out, steps, batch, T, D, N, ldz,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The gradients of the forward's inputs from dy [B, T, D]: dx, ddt [B, T, D],
// dA [D, N], dB, dC [B, T, N], dD [D]; every element written. scratch holds
// selective_scan_bwd_scratch_elems 4-byte elements; batch at most
// selective_scan_max_batch(). Otherwise as selective_scan_fwd_launch.
int selective_scan_bwd_launch(const float* x, const float* dt, const float* A, const float* Bm,
                              const float* Cm, const float* Dv, const float* dy, float* dx,
                              float* ddt, float* dA, float* dB, float* dC, float* dD,
                              void* scratch, int batch, int T, int D, int N, void* stream) {
  return bwd<float, false>(x, dt, A, Bm, Cm, Dv, nullptr, nullptr, dy, dx, ddt, nullptr, dA, dB,
                           dC, dD, scratch, batch, T, D, N, 0, stream);
}

// The gradients of the gated call's inputs from dout [B, T, D], with the
// forward's steps: dx [B, T, D] fp32, ddt and dz [B, T, D] (contiguous) of
// type `dtype`, dA, dB, dC, dD fp32. Otherwise as selective_scan_bwd_launch
// and selective_scan_gated_fwd_launch.
int selective_scan_gated_bwd_launch(const float* x, const void* dt, const float* A,
                                    const float* Bm, const float* Cm, const float* Dv,
                                    const void* z, const float* steps, const void* dout,
                                    float* dx, void* ddt, void* dz, float* dA, float* dB,
                                    float* dC, float* dD, void* scratch, int batch, int T,
                                    int D, int N, int ldz, int dtype, void* stream) {
  if (dtype == F32)
    return bwd<float, true>(x, dt, A, Bm, Cm, Dv, z, steps, dout, dx, ddt, dz, dA, dB, dC, dD,
                            scratch, batch, T, D, N, ldz, stream);
  if (dtype == BF16)
    return bwd<__nv_bfloat16, true>(x, dt, A, Bm, Cm, Dv, z, steps, dout, dx, ddt, dz, dA, dB,
                                    dC, dD, scratch, batch, T, D, N, ldz, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
