// K3: row LayerNorm + affine over (rows, C), bf16 in and out, f32 stats.
//
// Replaces the TPU kernel `_ln_kernel` (l.309) of
// layoutllm_t2i_tpu/ops/pallas/norms.py, launched by `_ln_pallas`
// (l.322/333) under `layer_norm_fused` (l.358).
//
// What bounds it on the H100: bytes (one read and one write per element,
// ~10 flops each).
//
// The simple design: one warp per row. The row (C <= 2048) is held in
// registers as 16-byte vectors, so the mean and the centred variance are
// two passes over registers, not over memory, matching the reference's
// mean / mean((x - mean)^2) order. Every LayerNorm site of the port runs
// here, C = 320 included: the TPU's c % 128 gate measured XLA fusion, not
// a property of the function.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

template <int VPL>  // 16-byte vectors per lane
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
          const bf16* __restrict__ beta, bf16* __restrict__ y, int rows,
          int C, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nv = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * C);
  float v[VPL * 8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + i * 32;
    if (vi < nv) {
      unpack8(xr[vi], v + i * 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[i * 8 + j];
    }
  }
  const float mean = warp_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = v[i * 8 + j] - mean;
        v[i * 8 + j] = d;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(ss) / C + eps);
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);
  uint4* yr = reinterpret_cast<uint4*>(y + (long long)row * C);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + i * 32;
    if (vi < nv) {
      float g[8], b[8], o[8];
      unpack8(gr[vi], g);
      unpack8(br[vi], b);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = v[i * 8 + j] * rstd * g[j] + b[j];
      yr[vi] = pack8(o);
    }
  }
}

template <int VPL>
int launch(const void* x, const void* g, const void* b, void* y, int rows,
           int C, float eps, cudaStream_t s) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_kernel<VPL><<<blocks, kRowsPerBlock * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), rows, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, C) bf16 contiguous; gamma, beta: (C,) bf16.
// C % 8 == 0 and C <= 2048.
LLT2I_API int llt2i_layer_norm(const void* x, const void* gamma,
                               const void* beta, void* y, int rows, int C,
                               float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || C > 2048) return (int)cudaErrorInvalidValue;
  switch ((C / 8 + 31) / 32) {
    case 1: return launch<1>(x, gamma, beta, y, rows, C, eps, s);
    case 2: return launch<2>(x, gamma, beta, y, rows, C, eps, s);
    case 3: return launch<3>(x, gamma, beta, y, rows, C, eps, s);
    case 4: return launch<4>(x, gamma, beta, y, rows, C, eps, s);
    case 5: return launch<5>(x, gamma, beta, y, rows, C, eps, s);
    case 6: return launch<6>(x, gamma, beta, y, rows, C, eps, s);
    case 7: return launch<7>(x, gamma, beta, y, rows, C, eps, s);
    default: return launch<8>(x, gamma, beta, y, rows, C, eps, s);
  }
}
