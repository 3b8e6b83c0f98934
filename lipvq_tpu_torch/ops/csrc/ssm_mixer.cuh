// The Mamba mixer's elementwise formulas as torch's CUDA kernels compute
// them in fp32 (SiLU, softplus at beta 1 and threshold 20, and their
// backwards), and the element types the mixer's fused kernels read and
// write: fp32, or bf16 rounded to nearest even as a cast rounds it. Shared
// by csrc/causal_conv1d.cu and csrc/selective_scan.cu.

#pragma once

#include <cuda_bf16.h>

namespace ssm_mixer {

// the element types by the code the C entry points take
enum Dtype : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch's silu: x / (1 + exp(-x))
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

// torch's silu_backward: g s (1 + x (1 - s)), s = 1 / (1 + exp(-x))
__device__ __forceinline__ float silu_grad(float x, float g) {
  const float s = 1.f / (1.f + expf(-x));
  return g * s * (1.f + x * (1.f - s));
}

// torch's softplus: x > 20 ? x : log1p(exp(x))
__device__ __forceinline__ float softplus(float x) { return x > 20.f ? x : log1pf(expf(x)); }

// torch's softplus_backward: x > 20 ? g : g e / (e + 1), e = exp(x)
__device__ __forceinline__ float softplus_grad(float x, float g) {
  const float e = expf(x);
  return x > 20.f ? g : g * e / (e + 1.f);
}

}  // namespace ssm_mixer
