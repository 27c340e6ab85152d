// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel library exposes plain C entry points that take raw device
// pointers and the CUDA stream as void*, launch on that stream, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define LLT2I_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 bf16 values moved as one 16-byte vector
union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  Vec8 v;
  v.u = raw;
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(v.h[j]);
}

__device__ __forceinline__ uint4 pack8(const float* in) {
  Vec8 v;
#pragma unroll
  for (int j = 0; j < 8; ++j) v.h[j] = __float2bfloat16(in[j]);
  return v.u;
}

// GELU with the exact erf, in f32 (jax.nn.gelu(approximate=False))
__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}
