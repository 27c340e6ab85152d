// K3: row LayerNorm + affine over (rows, C), f32 statistics; bf16 or f32
// in and out (x, gamma, beta and y share one type).
//
// Replaces the TPU kernel `_ln_kernel` (l.309) of
// layoutllm_t2i_tpu/ops/pallas/norms.py, launched by `_ln_pallas`
// (l.322/333) under `layer_norm_fused` (l.358). That kernel takes any float
// type and any C: bf16 at the UNet's and the pipeline's CLIP sites, f32 in
// the reward's CLIP towers (text C 768, vision C 1024 at 257 rows an
// image), and C 2560 in the middle block of a channel_mult (1, 2, 4, 8)
// UNet.
//
// What bounds it on the H100: bytes (one read and one write per element,
// ~10 flops each).
//
// Two simple designs, both matching the reference's mean /
// mean((x - mean)^2) order over 16-byte vectors (8 bf16 or 4 f32 values):
// - C <= 2048 (`llt2i_layer_norm`, `llt2i_layer_norm_f32`): one warp per
//   row. The row is held in registers, so the mean and the centred
//   variance are two passes over registers, not over memory. Rows past the
//   last full block of 8 are masked (the vision tower's 257·B rows). Every
//   LayerNorm site of SD-1.4's geometry runs here, C = 320 included: the
//   TPU's c % 128 gate measured XLA fusion, not a property of the function.
// - any C (`llt2i_layer_norm_wide`, `_wide_f32`; the wrapper sends C > 2048
//   here): one block of 256 threads per row. Each pass reads the row from
//   global memory (a 2560-wide bf16 row is 5 KB, which the second and third
//   reads find in L2), a thread summing its vectors in order; the block's
//   sum is each warp's butterfly sum, then the 8 warps' sums in order
//   through shared memory.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;

// one 16-byte vector of T: its width, the most vectors a lane holds of a
// row (C <= 2048), and its conversions to and from f32
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int kN = 8;
  static constexpr int kMaxVpl = 2048 / kN / 32;
  static __device__ __forceinline__ void load(const uint4& raw, float* out) {
    unpack8(raw, out);
  }
  static __device__ __forceinline__ uint4 store(const float* in) {
    return pack8(in);
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static constexpr int kMaxVpl = 2048 / kN / 32;
  static __device__ __forceinline__ void load(const uint4& raw, float* out) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 store(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};

template <typename T, int VPL>  // 16-byte vectors per lane
__global__ void __launch_bounds__(kRowsPerBlock * 32)
ln_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
          const T* __restrict__ beta, T* __restrict__ y, int rows, int C,
          float eps) {
  constexpr int E = Vec<T>::kN;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int nv = C / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * C);
  float v[VPL * E];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int vi = lane + i * 32;
    if (vi < nv) {
      Vec<T>::load(xr[vi], v + i * E);
#pragma unroll
      for (int j = 0; j < E; ++j) s += v[i * E + j];
    }
  }
  const float mean = warp_sum(s) / C;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = v[i * E + j] - mean;
        v[i * E + j] = d;
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
      float g[E], b[E], o[E];
      Vec<T>::load(gr[vi], g);
      Vec<T>::load(br[vi], b);
#pragma unroll
      for (int j = 0; j < E; ++j) o[j] = v[i * E + j] * rstd * g[j] + b[j];
      yr[vi] = Vec<T>::store(o);
    }
  }
}

template <typename T, int VPL>
int launch(const void* x, const void* g, const void* b, void* y, int rows,
           int C, float eps, cudaStream_t s) {
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_kernel<T, VPL><<<blocks, kRowsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), rows, C, eps);
  return (int)cudaGetLastError();
}

// the instantiation whose VPL covers a row's vpl vectors: the least V >= 1
// with V >= vpl, up to kMaxVpl (C = 2048)
template <typename T, int V = 1>
int launch_vpl(int vpl, const void* x, const void* g, const void* b, void* y,
               int rows, int C, float eps, cudaStream_t s) {
  if constexpr (V < Vec<T>::kMaxVpl) {
    if (vpl > V) return launch_vpl<T, V + 1>(vpl, x, g, b, y, rows, C, eps, s);
  }
  return launch<T, V>(x, g, b, y, rows, C, eps, s);
}

template <typename T>
int dispatch(const void* x, const void* g, const void* b, void* y, int rows,
             int C, float eps, cudaStream_t s) {
  constexpr int E = Vec<T>::kN;
  if (C % E || C <= 0 || C > 2048) return (int)cudaErrorInvalidValue;
  return launch_vpl<T>((C / E + 31) / 32, x, g, b, y, rows, C, eps, s);
}

// ---------------------------------------------------------------------------
// any C: one block a row

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;

// the block's sum of v, the same value in every thread: each warp's
// butterfly sum, then the warps' sums in warp order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWideWarps; ++w) t += red[w];
  __syncthreads();  // red is written again by the next sum
  return t;
}

// thread t takes the row's 16-byte vectors t, t + 256, t + 512, ...
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
ln_wide_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ y, int C,
               float eps) {
  constexpr int E = Vec<T>::kN;
  __shared__ float red[kWideWarps];
  const int nv = C / E;
  const long long off = (long long)blockIdx.x * C;
  const uint4* xr = reinterpret_cast<const uint4*>(x + off);
  float f[E];
  float s = 0.f;
  for (int vi = threadIdx.x; vi < nv; vi += kWideThreads) {
    Vec<T>::load(xr[vi], f);
#pragma unroll
    for (int j = 0; j < E; ++j) s += f[j];
  }
  const float mean = block_sum(s, red) / C;
  float ss = 0.f;
  for (int vi = threadIdx.x; vi < nv; vi += kWideThreads) {
    Vec<T>::load(xr[vi], f);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float d = f[j] - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(block_sum(ss, red) / C + eps);
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);
  uint4* yr = reinterpret_cast<uint4*>(y + off);
  for (int vi = threadIdx.x; vi < nv; vi += kWideThreads) {
    float g[E], b[E], o[E];
    Vec<T>::load(xr[vi], f);
    Vec<T>::load(gr[vi], g);
    Vec<T>::load(br[vi], b);
#pragma unroll
    for (int j = 0; j < E; ++j) o[j] = (f[j] - mean) * rstd * g[j] + b[j];
    yr[vi] = Vec<T>::store(o);
  }
}

template <typename T>
int dispatch_wide(const void* x, const void* g, const void* b, void* y,
                  int rows, int C, float eps, cudaStream_t s) {
  if (C % Vec<T>::kN || C <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  ln_wide_kernel<T><<<rows, kWideThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, C) bf16 contiguous; gamma, beta: (C,) bf16.
// C % 8 == 0 and C <= 2048.
LLT2I_API int llt2i_layer_norm(const void* x, const void* gamma,
                               const void* beta, void* y, int rows, int C,
                               float eps, void* stream) {
  return dispatch<bf16>(x, gamma, beta, y, rows, C, eps,
                        static_cast<cudaStream_t>(stream));
}

// x, y: (rows, C) f32 contiguous; gamma, beta: (C,) f32.
// C % 4 == 0 and C <= 2048.
LLT2I_API int llt2i_layer_norm_f32(const void* x, const void* gamma,
                                   const void* beta, void* y, int rows, int C,
                                   float eps, void* stream) {
  return dispatch<float>(x, gamma, beta, y, rows, C, eps,
                         static_cast<cudaStream_t>(stream));
}

// x, y: (rows, C) bf16 contiguous; gamma, beta: (C,) bf16. Any C % 8 == 0
// (the wrapper's route past 2048).
LLT2I_API int llt2i_layer_norm_wide(const void* x, const void* gamma,
                                    const void* beta, void* y, int rows,
                                    int C, float eps, void* stream) {
  return dispatch_wide<bf16>(x, gamma, beta, y, rows, C, eps,
                             static_cast<cudaStream_t>(stream));
}

// x, y: (rows, C) f32 contiguous; gamma, beta: (C,) f32. Any C % 4 == 0.
LLT2I_API int llt2i_layer_norm_wide_f32(const void* x, const void* gamma,
                                        const void* beta, void* y, int rows,
                                        int C, float eps, void* stream) {
  return dispatch_wide<float>(x, gamma, beta, y, rows, C, eps,
                              static_cast<cudaStream_t>(stream));
}
