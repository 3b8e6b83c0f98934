// The optimizer step of Adam and AdamW over many fp32 tensors in two passes.
//
// Replaces the foreach chain of a train step's optimizer block: the logged
// global norm (one read of the grads), the clip's norm (one more), the clip's
// scale (a read and a write) and torch's foreach Adam/AdamW (about eight
// passes moving some twenty tensors' worth of bytes, and a temporary the size
// of the model for sqrt(v)). The step needs one read of the grads for the
// norms and one pass that reads p, g, m, v and writes p, m, v: 32 bytes a
// parameter, 4 more for the norms.
//
// Kernels.
//   sq_norms_kernel: one read of every grad; each chunk of NORM_CHUNK
//       elements of one tensor writes its sum of squares to partials[chunk]
//       (each thread sums its float4s in order, the block in a fixed tree).
//   sq_norms_finalize: one block; per group (an optimizer) the sum of its
//       chunks' partials in a fixed order, then out[g] = that sum,
//       out[G] = sqrt of the groups' total and of the sums carried in from
//       earlier passes (the logged norm), and
//       out[G + 1 + g] = the group's clip scale, max_norm * (1 / norm) where
//       the norm reaches max_norm, else 1 (torch.where(norm < max_norm, 1,
//       max_norm / norm), as clip_by_global_norm_ computes it). Deterministic.
//   clip_adamw_kernel: per element, in torch's order and roundings
//       (_multi_tensor_adam on its non-capturable path, each foreach op's
//       expression with the product-add contracted where the compiler
//       contracts it):
//           g  = g * scale                      (scale 1 without a clip)
//           p  = p * (1 - lr wd)                (AdamW: the decoupled decay)
//           g  = g + wd p                       (Adam: L2 into the gradient)
//           m  = lerp(m, g, 1 - beta1)
//           v  = v * beta2 + (1 - beta2) g g
//           p  = p + (-lr / bc1) * (m / (sqrt(v) / sqrt(bc2) + eps))
//       lr, wd, betas, eps and the bias corrections bc1 = 1 - beta1^step,
//       bc2 = 1 - beta2^step come from the host in double and are rounded to
//       fp32 as torch rounds its scalars. Nothing is allocated.
//
// Launches. The tensors go by value in the kernel's argument block (under
// the 4 KB that every CUDA version takes): up to NORM_TENSORS grads a
// launch for the norms, ADAM_TENSORS parameters and HYPERS sets of
// hyper-parameters a launch for the update; more take further launches of
// the same pass. A launch's blocks walk its chunks (a tensor's chunks are
// consecutive; a block keeps the tensor it found and moves forward), with
// 128-bit loads where all of a tensor's pointers are 16-byte aligned and
// element loads for the rest and the tails. Loads and stores are streaming
// (evict-first): every byte is touched once.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int FINAL_THREADS = 1024;
constexpr int NORM_TENSORS = 160;
constexpr int ADAM_TENSORS = 80;
constexpr int HYPERS = 4;
constexpr int GROUPS = 8;
constexpr int NORM_CHUNK = 16384;  // elements of one tensor a block sums at a time
constexpr int ADAM_CHUNK = 8192;   // elements of one tensor a block updates at a time
constexpr int MAX_DEVICES = 64;

constexpr int DECAY = 1;  // AdamW: p *= 1 - lr wd
constexpr int L2 = 2;     // Adam with weight decay: g += wd p

struct NormArgs {
  uint64_t g[NORM_TENSORS];
  int64_t n[NORM_TENSORS];
  int32_t chunk0[NORM_TENSORS + 1];  // each tensor's first chunk; [count]: the launch's chunks
  int32_t count;
  int32_t base;  // the launch's first chunk among all the pass's partials
  float* partials;
};

struct FinalArgs {
  int32_t groups;
  int32_t carried;
  int32_t lo[GROUPS + 1];  // group g's partials are [lo[g], lo[g + 1])
  float max_norm[GROUPS];  // < 0: no clip
  uint64_t carry[GROUPS];  // sums of squares of earlier passes, added to the total
  const float* partials;
  float* out;
};

struct Hyper {
  float decay, l2, w1, b2, omb2, neg_step, bc2s, eps;
  int32_t scale;  // index into the scales, -1: no clip
  int32_t flags;  // DECAY, L2
};

struct AdamArgs {
  uint64_t p[ADAM_TENSORS], g[ADAM_TENSORS], m[ADAM_TENSORS], v[ADAM_TENSORS];
  int64_t n[ADAM_TENSORS];
  int32_t chunk0[ADAM_TENSORS + 1];
  uint8_t hyper[ADAM_TENSORS];
  Hyper h[HYPERS];
  const float* scales;
  int32_t count;
};

static_assert(sizeof(NormArgs) <= 4096 && sizeof(AdamArgs) <= 4096 && sizeof(FinalArgs) <= 4096,
              "a kernel's arguments take at most 4 KB");

// The block's sum of s, valid in thread 0: each warp by a butterfly, the
// warps' sums by warp 0, in a fixed order.
__device__ __forceinline__ float block_sum(float s, float* smem) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = s;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  __syncthreads();  // smem is free again
  return t;
}

__device__ __forceinline__ float sq4(float4 x, float s) {
  s = __fmaf_rn(x.x, x.x, s);
  s = __fmaf_rn(x.y, x.y, s);
  s = __fmaf_rn(x.z, x.z, s);
  return __fmaf_rn(x.w, x.w, s);
}

__global__ void __launch_bounds__(THREADS) sq_norms_kernel(const __grid_constant__ NormArgs a) {
  __shared__ float smem[32];
  const int total = a.chunk0[a.count];
  int t = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    while (a.chunk0[t + 1] <= c) ++t;
    const int64_t lo = static_cast<int64_t>(c - a.chunk0[t]) * NORM_CHUNK;
    const int64_t rem = a.n[t] - lo;
    const int len = rem < NORM_CHUNK ? static_cast<int>(rem) : NORM_CHUNK;
    const float* g = reinterpret_cast<const float*>(a.g[t]) + lo;
    float s = 0.f;
    int done = 0;
    if ((a.g[t] & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int nv = len >> 2;
#pragma unroll 4
      for (int i = threadIdx.x; i < nv; i += THREADS) s = sq4(__ldcs(g4 + i), s);
      done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += THREADS) {
      const float x = __ldcs(g + i);
      s = __fmaf_rn(x, x, s);
    }
    s = block_sum(s, smem);
    if (threadIdx.x == 0) a.partials[a.base + c] = s;
  }
}

__global__ void __launch_bounds__(FINAL_THREADS)
    sq_norms_finalize(const __grid_constant__ FinalArgs a) {
  __shared__ float smem[32];
  __shared__ float sums[GROUPS];
  for (int k = 0; k < a.groups; ++k) {
    float s = 0.f;
    for (int i = a.lo[k] + threadIdx.x; i < a.lo[k + 1]; i += FINAL_THREADS) s += a.partials[i];
    s = block_sum(s, smem);
    if (threadIdx.x == 0) sums[k] = s;
  }
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int k = 0; k < a.groups; ++k) {
      a.out[k] = sums[k];
      total += sums[k];
    }
    for (int k = 0; k < a.carried; ++k) total += *reinterpret_cast<const float*>(a.carry[k]);
    a.out[a.groups] = __fsqrt_rn(total);
    for (int k = 0; k < a.groups; ++k) {
      const float norm = __fsqrt_rn(sums[k]), mx = a.max_norm[k];
      a.out[a.groups + 1 + k] = mx >= 0.f && !(norm < mx) ? __fmul_rn(__frcp_rn(norm), mx) : 1.f;
    }
  }
}

// One element's step; every rounding spelled out (no contraction beyond
// what is written).
__device__ __forceinline__ void adam_one(float& p, float g, float& m, float& v, const Hyper& h,
                                         float scale) {
  g = __fmul_rn(g, scale);
  if (h.flags & DECAY) p = __fmul_rn(p, h.decay);
  if (h.flags & L2) g = __fmaf_rn(h.l2, p, g);
  const float d = __fsub_rn(g, m);  // at::native::lerp: weights below 0.5 from m, else from g
  m = fabsf(h.w1) < 0.5f ? __fmaf_rn(h.w1, d, m) : __fmaf_rn(-d, __fsub_rn(1.f, h.w1), g);
  v = __fmaf_rn(h.omb2, __fmul_rn(g, g), __fmul_rn(v, h.b2));
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), h.bc2s), h.eps);
  p = __fmaf_rn(h.neg_step, __fdiv_rn(m, denom), p);
}

__global__ void __launch_bounds__(THREADS) clip_adamw_kernel(const __grid_constant__ AdamArgs a) {
  const int total = a.chunk0[a.count];
  int t = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    while (a.chunk0[t + 1] <= c) ++t;
    const Hyper h = a.h[a.hyper[t]];
    const float scale = h.scale >= 0 ? a.scales[h.scale] : 1.f;
    const int64_t lo = static_cast<int64_t>(c - a.chunk0[t]) * ADAM_CHUNK;
    const int64_t rem = a.n[t] - lo;
    const int len = rem < ADAM_CHUNK ? static_cast<int>(rem) : ADAM_CHUNK;
    float* p = reinterpret_cast<float*>(a.p[t]) + lo;
    const float* g = reinterpret_cast<const float*>(a.g[t]) + lo;
    float* m = reinterpret_cast<float*>(a.m[t]) + lo;
    float* v = reinterpret_cast<float*>(a.v[t]) + lo;
    int done = 0;
    if (((a.p[t] | a.g[t] | a.m[t] | a.v[t]) & 15) == 0) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      const int nv = len >> 2;
#pragma unroll 2
      for (int i = threadIdx.x; i < nv; i += THREADS) {
        float4 P = __ldcs(p4 + i), M = __ldcs(m4 + i), V = __ldcs(v4 + i);
        const float4 G = __ldcs(g4 + i);
        adam_one(P.x, G.x, M.x, V.x, h, scale);
        adam_one(P.y, G.y, M.y, V.y, h, scale);
        adam_one(P.z, G.z, M.z, V.z, h, scale);
        adam_one(P.w, G.w, M.w, V.w, h, scale);
        __stcs(p4 + i, P);
        __stcs(m4 + i, M);
        __stcs(v4 + i, V);
      }
      done = nv << 2;
    }
    for (int i = done + threadIdx.x; i < len; i += THREADS) {
      float P = __ldcs(p + i), M = __ldcs(m + i), V = __ldcs(v + i);
      adam_one(P, __ldcs(g + i), M, V, h, scale);
      __stcs(p + i, P);
      __stcs(m + i, M);
      __stcs(v + i, V);
    }
  }
}

// Blocks a launch of ``kernel`` keeps resident on the current device: its
// multiprocessors times the blocks each holds, found once per device.
template <typename K>
int resident_blocks(K kernel, int threads, int* cache, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0)) !=
        cudaSuccess)
      return err;
    cache[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = cache[dev];
  return cudaSuccess;
}

int norm_grid[MAX_DEVICES];
int adam_grid[MAX_DEVICES];

int64_t chunks_of(int64_t n, int chunk) { return (n + chunk - 1) / chunk; }

}  // namespace

extern "C" {

// A returned cudaError_t's text, under the one name every library exports.
const char* lipvq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// [NORM_TENSORS, ADAM_TENSORS, HYPERS, GROUPS, NORM_CHUNK, ADAM_CHUNK]
void fused_adamw_limits(int* out) {
  const int v[] = {NORM_TENSORS, ADAM_TENSORS, HYPERS, GROUPS, NORM_CHUNK, ADAM_CHUNK};
  memcpy(out, v, sizeof v);
}

// The partials the norm pass of tensors of n[0..count) writes: one a chunk.
int64_t fused_sq_norms_partials(int count, const int64_t* n) {
  int64_t total = 0;
  for (int i = 0; i < count; ++i) total += chunks_of(n[i], NORM_CHUNK);
  return total;
}

// The norm pass over grads g[0..count) (fp32, n[i] elements each), which
// group end[k] - end[k - 1] of them to each of ``groups`` groups, and the
// finalize into out[2 groups + 1] (layout above), the device floats
// carry[0..carried) added to the total. ``partials`` holds
// fused_sq_norms_partials(count, n) floats. *launches: the kernels launched.
int fused_sq_norms(int count, const uint64_t* g, const int64_t* n, int groups, const int32_t* end,
                   const float* max_norm, int carried, const uint64_t* carry, float* partials,
                   float* out, int* launches, void* stream) {
  *launches = 0;
  if (groups < 0 || groups > GROUPS || carried < 0 || carried > GROUPS ||
      groups + carried < 1 || fused_sq_norms_partials(count, n) > INT_MAX)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  int err = resident_blocks(sq_norms_kernel, THREADS, norm_grid, &grid);
  if (err != cudaSuccess) return err;
  NormArgs a;
  FinalArgs f;
  memset(&a, 0, sizeof a);
  memset(&f, 0, sizeof f);
  a.partials = partials;
  int chunks = 0, base = 0;
  auto flush = [&]() -> int {
    if (chunks > 0) {
      a.chunk0[a.count] = chunks;
      a.base = base;
      sq_norms_kernel<<<chunks < grid ? chunks : grid, THREADS, 0, s>>>(a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      ++*launches;
    }
    base += chunks;
    chunks = 0;
    a.count = 0;
    return cudaSuccess;
  };
  int k = 0;
  for (int i = 0; i < count; ++i) {
    while (k < groups && i >= end[k]) f.lo[++k] = base + chunks;
    if (n[i] == 0) continue;
    if (a.count == NORM_TENSORS && (err = flush()) != cudaSuccess) return err;
    a.g[a.count] = g[i];
    a.n[a.count] = n[i];
    a.chunk0[a.count++] = chunks;
    chunks += static_cast<int>(chunks_of(n[i], NORM_CHUNK));
  }
  while (k < groups) f.lo[++k] = base + chunks;
  if ((err = flush()) != cudaSuccess) return err;
  f.groups = groups;
  for (int j = 0; j < groups; ++j) f.max_norm[j] = max_norm[j];
  f.carried = carried;
  for (int j = 0; j < carried; ++j) f.carry[j] = carry[j];
  f.partials = partials;
  f.out = out;
  sq_norms_finalize<<<1, FINAL_THREADS, 0, s>>>(f);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launches;
  return e;
}

// The update pass over tensors [0..count) (p, g, m, v fp32 of n[i]
// elements), tensor i under hyper-parameter set hyper_of[i] of ``hypers``:
// floats hf[8 j ..] = decay, l2, 1 - beta1, beta2, 1 - beta2, -lr / bc1,
// sqrt(bc2), eps and ints hi[2 j ..] = scale index (-1: none), flags.
// ``scales`` is the device array the scale indices point into.
// *launches: the kernels launched.
int fused_clip_adamw(int count, const uint64_t* p, const uint64_t* g, const uint64_t* m,
                     const uint64_t* v, const int64_t* n, const int32_t* hyper_of, int hypers,
                     const float* hf, const int32_t* hi, const float* scales, int* launches,
                     void* stream) {
  *launches = 0;
  auto s = static_cast<cudaStream_t>(stream);
  int grid = 0;
  int err = resident_blocks(clip_adamw_kernel, THREADS, adam_grid, &grid);
  if (err != cudaSuccess) return err;
  AdamArgs a;
  memset(&a, 0, sizeof a);
  a.scales = scales;
  std::vector<int> local(hypers, -1);  // a set's index in the current launch
  int used = 0;
  int64_t chunks = 0;
  auto flush = [&]() -> int {
    if (chunks > 0) {
      a.chunk0[a.count] = static_cast<int32_t>(chunks);
      clip_adamw_kernel<<<chunks < grid ? static_cast<int>(chunks) : grid, THREADS, 0, s>>>(a);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      ++*launches;
    }
    chunks = 0;
    a.count = 0;
    used = 0;
    for (int& l : local) l = -1;
    return cudaSuccess;
  };
  for (int i = 0; i < count; ++i) {
    if (n[i] == 0) continue;
    const int j = hyper_of[i];
    if (j < 0 || j >= hypers) return cudaErrorInvalidValue;
    const int64_t c = chunks_of(n[i], ADAM_CHUNK);
    if (c > INT_MAX) return cudaErrorInvalidValue;
    if (a.count == ADAM_TENSORS || chunks + c > INT_MAX || (local[j] < 0 && used == HYPERS)) {
      if ((err = flush()) != cudaSuccess) return err;
    }
    if (local[j] < 0) {
      Hyper& h = a.h[used];
      const float* x = hf + 8 * j;
      h = Hyper{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], hi[2 * j], hi[2 * j + 1]};
      if (h.scale >= 0 && scales == nullptr) return cudaErrorInvalidValue;
      local[j] = used++;
    }
    a.p[a.count] = p[i];
    a.g[a.count] = g[i];
    a.m[a.count] = m[i];
    a.v[a.count] = v[i];
    a.n[a.count] = n[i];
    a.hyper[a.count] = static_cast<uint8_t>(local[j]);
    a.chunk0[a.count++] = static_cast<int32_t>(chunks);
    chunks += c;
  }
  return flush();
}

}  // extern "C"
