// The Mamba mixer's depthwise causal convolution with its bias and SiLU,
// forward and backward, one pass over the tensors each way.
//
// Replaces a chain of PyTorch kernels in lipvq_tpu_torch/models/mamba.py
// (the JAX package's lipvq_tpu/models/mamba.py writes the same stencil and
// leaves it to XLA; there is no Pallas kernel of it). For the x half of the
// in_proj output x [B, T, D] (rows ldx elements apart, fp32 or bf16), taps
// w [K, D] and bias [D], fp32, per channel d
//
//     pre[t] = sum_k w[k] x[t - K + 1 + k] + bias      (x[t] = 0 for t < 0)
//     xs[t]  = silu(pre[t])
//
// written as fp32 xs [B, T, D] for the scan and, where asked, as xs_op, the
// same values rounded to the input's type (x_proj's operand). The backward
// takes the gradients of both outputs (fp32, and xs_op's in the input's
// type), adds them in fp32, recomputes pre, and writes the input's gradient
// in the input's type, dw [K, D] and dbias [D].
//
// Bound. Bytes: the forward reads x and writes xs and xs_op once, the
// backward reads x, both gradients and writes dx once (at the Jamba cell's
// 192 x 30 x 5120 in bf16, 0.24 and 0.30 GB, 0.07 and 0.09 ms at 3.35 TB/s).
// The composed path (pad, K shifted products, their sums, SiLU, the casts,
// and autograd's slices and reductions) moves about 3 GB forward and 5 GB
// backward.
//
// Design. A thread owns one channel of one sequence for a chunk of TCHUNK
// steps and walks it, the last K inputs in registers; neighbouring threads
// take neighbouring channels, so each step's loads are coalesced, and U
// steps are loaded before they are used. The sums are each product and sum
// rounded in the order of the composed path (0 + w[0] x + ... + w[K-1] x,
// then + bias), so pre and xs equal its values, and the input's gradient
// adds the taps' terms as autograd does (the last tap's first). The
// backward walks K - 1 steps past its chunk for the gradients that reach
// back into it; each thread sums dw and dbias over its steps and SEQ_GROUP
// sequences in order, one partial per block row, and a second kernel sums
// the partials in order. No atomics: the result is the same on every run.

#include <cuda_runtime.h>

#include <cstddef>

#include "ssm_mixer.cuh"

namespace {

using namespace ssm_mixer;

constexpr int THREADS = 128;
constexpr int RED_THREADS = 256;
constexpr int TCHUNK = 64;    // steps a thread walks
constexpr int U = 4;          // steps loaded ahead of their use
constexpr int SEQ_GROUP = 4;  // sequences a backward thread walks
constexpr int MAX_WIDTH = 4;
constexpr int MAX_GRID = 65535;

int chunks_of(int T) { return (T + TCHUNK - 1) / TCHUNK; }
int bwd_rows(int batch) {
  const int groups = (batch + SEQ_GROUP - 1) / SEQ_GROUP;
  return groups < MAX_GRID ? groups : MAX_GRID;
}

// pre at the window's last step: win[k] = x[t - K + 1 + k]
template <int K>
__device__ __forceinline__ float conv_at(const float (&win)[K], const float (&w)[K], float bias) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], win[k]));
  return __fadd_rn(acc, bias);
}

template <int K>
__device__ __forceinline__ void shift(float (&v)[K]) {
#pragma unroll
  for (int k = 0; k + 1 < K; ++k) v[k] = v[k + 1];
}

template <typename E, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv1d_fwd_kernel(const E* __restrict__ x, int ldx, const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ xs,
                         E* __restrict__ xs_op, int batch, int T, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= D) return;
  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = w[(size_t)k * D + c];
  const float bc = bias[c];
  const int t0 = blockIdx.z * TCHUNK;
  const int t1 = min(t0 + TCHUNK, T);
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const E* xb = x + (size_t)b * T * ldx + c;
    float win[K];
#pragma unroll
    for (int k = 0; k + 1 < K; ++k) {
      const int t = t0 - (K - 1) + k;
      win[k] = t >= 0 ? to_float(xb[(size_t)t * ldx]) : 0.f;
    }
    for (int tb = t0; tb < t1; tb += U) {
      float nx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) nx[u] = tb + u < t1 ? to_float(xb[(size_t)(tb + u) * ldx]) : 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (tb + u < t1) {
          win[K - 1] = nx[u];
          const float s = silu(conv_at<K>(win, wk, bc));
          const size_t o = ((size_t)b * T + tb + u) * D + c;
          xs[o] = s;
          if (xs_op != nullptr) xs_op[o] = from_float<E>(s);
          shift<K>(win);
        }
      }
    }
  }
}

template <typename E, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv1d_bwd_kernel(const E* __restrict__ x, int ldx, const float* __restrict__ w,
                         const float* __restrict__ bias, const float* __restrict__ dxs,
                         const E* __restrict__ dxs_op, E* __restrict__ dx,
                         float* __restrict__ part, int batch, int T, int D) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= D) return;
  float wk[K], dw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wk[k] = w[(size_t)k * D + c];
    dw[k] = 0.f;
  }
  const float bc = bias[c];
  float db = 0.f;
  const int t0 = blockIdx.z * TCHUNK;
  const int t1 = min(t0 + TCHUNK, T);
  const int tend = min(t1 + K - 1, T);  // the steps whose gradients reach the chunk
  for (int g = blockIdx.y; g * SEQ_GROUP < batch; g += gridDim.y) {
    for (int b = g * SEQ_GROUP; b < min(g * SEQ_GROUP + SEQ_GROUP, batch); ++b) {
      const E* xb = x + (size_t)b * T * ldx + c;
      float win[K], gw[K];  // x[t - K + 1 .. t]; the pre-activation's gradient there
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int t = t0 - (K - 1) + k;
        win[k] = k + 1 < K && t >= 0 ? to_float(xb[(size_t)t * ldx]) : 0.f;
        gw[k] = 0.f;
      }
      for (int tb = t0; tb < t1 + K - 1; tb += U) {
        float nx[U], ng[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          nx[u] = ng[u] = 0.f;
          if (tb + u < tend) {
            const size_t o = ((size_t)b * T + tb + u) * D + c;
            nx[u] = to_float(xb[(size_t)(tb + u) * ldx]);
            ng[u] = dxs[o];
            if (dxs_op != nullptr) ng[u] = ng[u] + to_float(dxs_op[o]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = tb + u;
          if (t < t1 + K - 1) {
            float gp = 0.f;  // zero past the sequence's end
            if (t < tend) {
              win[K - 1] = nx[u];
              gp = silu_grad(conv_at<K>(win, wk, bc), ng[u]);
              if (t < t1) {
                db += gp;
#pragma unroll
                for (int k = 0; k < K; ++k) dw[k] += gp * win[k];
              }
              shift<K>(win);
            }
            shift<K>(gw);
            gw[K - 1] = gp;
            const int j = t - (K - 1);  // gw[m] = gp[j + m]
            if (j >= t0) {  // the taps' terms rounded and added as autograd adds them
              float s = 0.f;
#pragma unroll
              for (int m = 0; m < K; ++m) s = __fadd_rn(s, __fmul_rn(gw[m], wk[K - 1 - m]));
              dx[((size_t)b * T + j) * D + c] = from_float<E>(s);
            }
          }
        }
      }
    }
  }
  float* p = part + (size_t)(blockIdx.z * gridDim.y + blockIdx.y) * (K + 1) * D + c;
#pragma unroll
  for (int k = 0; k < K; ++k) p[(size_t)k * D] = dw[k];
  p[(size_t)K * D] = db;
}

// out[i] = sum over k in order of part[k, i]; part [n, inner]
__global__ void causal_conv1d_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, int n, int inner) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < inner; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n; ++k) s += part[(size_t)k * inner + i];
    out[i] = s;
  }
}

dim3 grid_of(int D, int rows, int T) {
  return dim3((D + THREADS - 1) / THREADS, rows, chunks_of(T));
}

template <typename E, int K>
cudaError_t launch_fwd(const void* x, int ldx, const float* w, const float* bias, float* xs,
                       void* xs_op, int batch, int T, int D, cudaStream_t s) {
  causal_conv1d_fwd_kernel<E, K><<<grid_of(D, batch < MAX_GRID ? batch : MAX_GRID, T), THREADS,
                                   0, s>>>(static_cast<const E*>(x), ldx, w, bias, xs,
                                           static_cast<E*>(xs_op), batch, T, D);
  return cudaGetLastError();
}

template <typename E, int K>
cudaError_t launch_bwd(const void* x, int ldx, const float* w, const float* bias,
                       const float* dxs, const void* dxs_op, void* dx, float* dw, float* part,
                       int batch, int T, int D, cudaStream_t s) {
  const dim3 grid = grid_of(D, bwd_rows(batch), T);
  causal_conv1d_bwd_kernel<E, K><<<grid, THREADS, 0, s>>>(
      static_cast<const E*>(x), ldx, w, bias, dxs, static_cast<const E*>(dxs_op),
      static_cast<E*>(dx), part, batch, T, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int inner = (K + 1) * D;
  const int blocks = (inner + RED_THREADS - 1) / RED_THREADS;
  causal_conv1d_reduce_kernel<<<blocks, RED_THREADS, 0, s>>>(part, dw, grid.y * grid.z, inner);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A returned cudaError_t's text, under the one name every library exports.
const char* lipvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int causal_conv1d_max_width() { return MAX_WIDTH; }

// 4-byte elements of scratch that causal_conv1d_bwd_launch needs.
size_t causal_conv1d_bwd_scratch_elems(int batch, int T, int D, int K) {
  return (size_t)bwd_rows(batch) * chunks_of(T) * (K + 1) * D;
}

// x [B, T, D] with rows ldx elements apart (ldx >= D), of type `dtype`
// (ssm_mixer::Dtype); w [K, D], bias [D] fp32 -> xs [B, T, D] fp32 and,
// unless xs_op is null, xs_op [B, T, D] of x's type. 1 <= K <= MAX_WIDTH;
// contiguous outputs on the current device. Enqueues on `stream`, allocates
// nothing and returns the first cudaError_t.
int causal_conv1d_fwd_launch(const void* x, int ldx, const float* w, const float* bias,
                             float* xs, void* xs_op, int batch, int T, int D, int K, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_FWD(E, K) launch_fwd<E, K>(x, ldx, w, bias, xs, xs_op, batch, T, D, s)
#define CONV_FWD_K(E)                                          \
  switch (K) {                                                 \
    case 1: return CONV_FWD(E, 1);                             \
    case 2: return CONV_FWD(E, 2);                             \
    case 3: return CONV_FWD(E, 3);                             \
    case 4: return CONV_FWD(E, 4);                             \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }
  if (dtype == F32) CONV_FWD_K(float)
  if (dtype == BF16) CONV_FWD_K(__nv_bfloat16)
  return static_cast<int>(cudaErrorInvalidValue);
#undef CONV_FWD_K
#undef CONV_FWD
}

// The gradients from dxs [B, T, D] fp32 and, unless null, dxs_op [B, T, D]
// of x's type: dx [B, T, D] (contiguous) of x's type, and dw [K + 1, D]
// fp32, the taps' gradient then the bias's. scratch holds
// causal_conv1d_bwd_scratch_elems 4-byte elements. Otherwise as
// causal_conv1d_fwd_launch.
int causal_conv1d_bwd_launch(const void* x, int ldx, const float* w, const float* bias,
                             const float* dxs, const void* dxs_op, void* dx, float* dw,
                             float* scratch, int batch, int T, int D, int K, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CONV_BWD(E, K) \
  launch_bwd<E, K>(x, ldx, w, bias, dxs, dxs_op, dx, dw, scratch, batch, T, D, s)
#define CONV_BWD_K(E)                                          \
  switch (K) {                                                 \
    case 1: return CONV_BWD(E, 1);                             \
    case 2: return CONV_BWD(E, 2);                             \
    case 3: return CONV_BWD(E, 3);                             \
    case 4: return CONV_BWD(E, 4);                             \
    default: return static_cast<int>(cudaErrorInvalidValue);   \
  }
  if (dtype == F32) CONV_BWD_K(float)
  if (dtype == BF16) CONV_BWD_K(__nv_bfloat16)
  return static_cast<int>(cudaErrorInvalidValue);
#undef CONV_BWD_K
#undef CONV_BWD
}

}  // extern "C"
