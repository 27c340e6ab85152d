// K4: out = x + s * (GEGLU(LN(x) Wa + ba, LN(x) Wg + bg) W2 + b2), bf16 in
// and out, f32 statistics and accumulators, exact-erf GELU, LN eps 1e-5.
//
// Replaces the TPU kernel `_ffn_ln_kernel` (l.70) of
// layoutllm_t2i_tpu/ops/pallas/ffn.py, launched by `_ffn_ln_call`
// (l.170/182) under `ffn_ln_geglu_fused` (l.274, s = 1) and
// `ffn_ln_geglu_scaled` (l.302, s = fuser_scale * tanh(alpha_dense)).
//
// What bounds it on the H100: operations. The three products do
// 2*M*K*(2*4K) + 2*M*4K*K = 24*M*K^2 flops against ~4*M*K bytes of x and
// out plus the weights (M = 16384, K = 320: ~1500 flop/byte).
//
// The TPU kernel keeps a (bm, K) f32 accumulator resident across the inner
// dimension; at K = 1280 that alone exceeds the 227 KB of shared memory a
// Hopper block may use. So the function is split in two kernels, both K4:
//   (a) ffn_up: per 64x64 tile of the (M, 4K) GEGLU product, LayerNorm
//       statistics of the 64 rows are computed first; every staged A tile is
//       normalised, affine'd and rounded to bf16 on its way into shared
//       memory (as `_ffn_ln_kernel` rounds its LN'd row, ffn.py:89); both
//       up-projections run on the tensor cores with f32 accumulation; the
//       epilogue adds the biases, applies a * gelu_erf(g) in f32 and writes
//       h as bf16 (M, 4K).
//   (b) ffn_down: a tiled GEMM h W2^T whose epilogue computes
//       ((acc + b2) * s).to(bf16) + x, the rounding order of ffn.py:107-108.
// s is read from device memory (a 0-d f32 tensor) when given, so a traced
// gate never forces a host sync. Tiles are 64x64x32 on four warps, WMMA
// 16x16x16 bf16 fragments, one shared-memory stage: simple, not fast.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 64, BKT = 32;
constexpr int LDS = BKT + 8;  // padded shared row (elements), multiple of 8
constexpr int kThreads = 128;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Stage rows [r0, r0+64) x cols [k0, k0+32) of a row-major (rows, ld) bf16
// matrix into shared memory, zero outside (rows, cols).
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long ld, int r0, int rows,
                                           int k0, int cols) {
  for (int i = threadIdx.x; i < 64 * (BKT / 8); i += kThreads) {
    const int r = i / (BKT / 8), c = (i % (BKT / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && k0 + c < cols)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + k0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
ffn_up_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
              const bf16* __restrict__ lnb, const bf16* __restrict__ w1,
              const bf16* __restrict__ b1, bf16* __restrict__ hout, int M,
              int K, int inner, float eps) {
  __shared__ __align__(128) bf16 sA[BM * LDS];
  __shared__ __align__(128) bf16 sWa[BN * LDS];
  __shared__ __align__(128) bf16 sWg[BN * LDS];
  __shared__ __align__(128) float sStage[4][2][256];
  __shared__ float sMean[BM], sRstd[BM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // LayerNorm statistics of this block's rows: centred two-pass per row
  const int nv = K / 8;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (m0 + r >= M) break;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K);
    float f[8], s = 0.f;
    for (int vi = lane; vi < nv; vi += 32) {
      unpack8(xr[vi], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) s += f[j];
    }
    const float mean = warp_sum(s) / K;
    float ss = 0.f;
    for (int vi = lane; vi < nv; vi += 32) {
      unpack8(xr[vi], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += (f[j] - mean) * (f[j] - mean);
    }
    const float rstd = rsqrtf(warp_sum(ss) / K + eps);
    if (lane == 0) {
      sMean[r] = mean;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();

  FragC acc_a[4], acc_g[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::fill_fragment(acc_a[f], 0.f);
    wmma::fill_fragment(acc_g[f], 0.f);
  }
  FragA fa;
  FragB fb;
  for (int k0 = 0; k0 < K; k0 += BKT) {
    // A tile: LN(x) rounded to bf16
    for (int i = threadIdx.x; i < BM * (BKT / 8); i += kThreads) {
      const int r = i / (BKT / 8), c = (i % (BKT / 8)) * 8;
      float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (m0 + r < M && k0 + c < K) {
        float xv[8], g[8], b[8];
        unpack8(*reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + k0 + c), xv);
        unpack8(*reinterpret_cast<const uint4*>(lnw + k0 + c), g);
        unpack8(*reinterpret_cast<const uint4*>(lnb + k0 + c), b);
        const float mean = sMean[r], rstd = sRstd[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = (xv[j] - mean) * rstd * g[j] + b[j];
      }
      *reinterpret_cast<uint4*>(sA + r * LDS + c) = pack8(o);
    }
    stage_tile(sWa, w1, K, j0, inner, k0, K);
    stage_tile(sWg, w1 + (long long)inner * K, K, j0, inner, k0, K);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      wmma::load_matrix_sync(fa, sA + warp * 16 * LDS + kk * 16, LDS);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::load_matrix_sync(fb, sWa + f * 16 * LDS + kk * 16, LDS);
        wmma::mma_sync(acc_a[f], fa, fb, acc_a[f]);
        wmma::load_matrix_sync(fb, sWg + f * 16 * LDS + kk * 16, LDS);
        wmma::mma_sync(acc_g[f], fa, fb, acc_g[f]);
      }
    }
    __syncthreads();
  }

  float* stA = sStage[warp][0];
  float* stG = sStage[warp][1];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::store_matrix_sync(stA, acc_a[f], 16, wmma::mem_row_major);
    wmma::store_matrix_sync(stG, acc_g[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gm = m0 + warp * 16 + e / 16;
      const int gn = j0 + f * 16 + (e % 16);
      if (gm < M && gn < inner) {
        const float a = stA[e] + __bfloat162float(b1[gn]);
        const float g = stG[e] + __bfloat162float(b1[inner + gn]);
        const float gelu = 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
        hout[(long long)gm * inner + gn] = __float2bfloat16(a * gelu);
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, const bf16* __restrict__ x,
                bf16* __restrict__ out, const float* __restrict__ s_ptr,
                float s_val, int M, int K, int inner) {
  __shared__ __align__(128) bf16 sA[BM * LDS];
  __shared__ __align__(128) bf16 sB[BN * LDS];
  __shared__ __align__(128) float sStage[4][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float s = s_ptr ? *s_ptr : s_val;

  FragC acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
  FragA fa;
  FragB fb;
  for (int k0 = 0; k0 < inner; k0 += BKT) {
    stage_tile(sA, h, inner, m0, M, k0, inner);
    stage_tile(sB, w2, inner, n0, K, k0, inner);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      wmma::load_matrix_sync(fa, sA + warp * 16 * LDS + kk * 16, LDS);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::load_matrix_sync(fb, sB + f * 16 * LDS + kk * 16, LDS);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }

  float* st = sStage[warp];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int gm = m0 + warp * 16 + e / 16;
      const int gn = n0 + f * 16 + (e % 16);
      if (gm < M && gn < K) {
        const long long idx = (long long)gm * K + gn;
        const float y = (st[e] + __bfloat162float(b2[gn])) * s;
        const float yb = __bfloat162float(__float2bfloat16(y));
        out[idx] = __float2bfloat16(yb + __bfloat162float(x[idx]));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// x, out: (M, K) bf16; lnw, lnb: (K,); w1: (2*inner, K) = [Wa; Wg] in the
// torch (out, in) layout; b1: (2*inner,); w2: (K, inner); b2: (K,);
// hbuf: (M, inner) bf16 scratch. s_ptr: device f32 scalar or null (then
// s_val). K % 8 == 0, inner % 8 == 0.
LLT2I_API int llt2i_ffn_ln_geglu(const void* x, const void* lnw,
                                 const void* lnb, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* hbuf, void* out,
                                 const void* s_ptr, float s_val, int M, int K,
                                 int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || inner % 8) return (int)cudaErrorInvalidValue;
  const int mb = (M + BM - 1) / BM;
  ffn_up_kernel<<<dim3((inner + BN - 1) / BN, mb), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<const bf16*>(lnb), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(hbuf), M, K, inner,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_down_kernel<<<dim3((K + BN - 1) / BN, mb), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), static_cast<const float*>(s_ptr), s_val, M, K,
      inner);
  return (int)cudaGetLastError();
}
