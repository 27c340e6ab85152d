// Tile bodies of the first WMMA design, now K7's alone (ffn.cu: the int8
// LN + GEGLU FF). K4, K6, K8a and K8b run on gemm_tiles.cuh's wgmma
// mainloop instead.
//
// Every product here is A W^T with both operands row-major over the
// contraction: activations (M, K) and int8 weights in the torch (out, in)
// layout. Output tiles are 64x64, the contraction steps 32 deep, four warps
// each own 16 rows and hold four WMMA 16x16x16 bf16 fragments with f32
// accumulators, one shared-memory stage: simple, not fast.
//
// Two bodies:
//   geglu_up_tile  h = (LN(x) Qa^T * sa + ba) * gelu_erf(LN(x) Qg^T * sg +
//                  bg), rounded to bf16; Q = [Qa; Qg] is (2*inner, K). The
//                  A tile is LayerNorm(x) rounded to bf16 on its way into
//                  shared memory (statistics of the block's 64 rows first).
//   down_tile      out = bf16((h Q2^T * s2 + b2) * s) + x, the
//                  scaled-residual epilogue.
// An int8 tile is converted to bf16 on its way into shared memory (every
// int8 value is exact in bf16) and its per-output-channel f32 scales
// multiply the f32 sums in the epilogue, as the TPU kernel applies them
// after the dot (layoutllm_t2i_tpu/ops/pallas/ffn.py:356-366).
#pragma once

#include <mma.h>

#include "common.cuh"

namespace ffn_tiles {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BKT = 32;
constexpr int LDS = BKT + 8;  // padded shared row (elements), multiple of 8
constexpr int kThreads = 128;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Stage rows [r0, r0+64) x cols [k0, k0+32) of a row-major (rows, ld) bf16
// matrix into shared memory, zero outside (rows, cols). cols % 8 == 0.
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

// The same for an int8 matrix, 16 values (one 16-byte load) a step, each
// converted to bf16 exactly. cols % 16 == 0 and a 16-byte aligned base.
__device__ __forceinline__ void stage_tile(bf16* dst, const int8_t* src,
                                           long long ld, int r0, int rows,
                                           int k0, int cols) {
  for (int i = threadIdx.x; i < 64 * (BKT / 16); i += kThreads) {
    const int r = i / (BKT / 16), c = (i % (BKT / 16)) * 16;
    union {
      uint4 u;
      int8_t q[16];
    } raw;
    raw.u = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows && k0 + c < cols)
      raw.u = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + k0 + c);
    Vec8 lo, hi;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      lo.h[j] = __float2bfloat16(static_cast<float>(raw.q[j]));
      hi.h[j] = __float2bfloat16(static_cast<float>(raw.q[8 + j]));
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = lo.u;
    *reinterpret_cast<uint4*>(dst + r * LDS + c + 8) = hi.u;
  }
}

// One 64x64 tile of h = (LN(x) Qa^T * sa + ba) * gelu_erf(LN(x) Qg^T * sg
// + bg), stored bf16 (M, inner). x: (M, K) bf16; lnw, lnb: (K,) bf16; w1:
// (2*inner, K) int8 = [Qa; Qg]; ws1: (2*inner,) f32; b1: (2*inner,) bf16.
// Block (x, y) computes columns [64x, 64x+64) of rows [64y, 64y+64).
__device__ __forceinline__ void geglu_up_tile(
    const bf16* __restrict__ x, const bf16* __restrict__ lnw,
    const bf16* __restrict__ lnb, const int8_t* __restrict__ w1,
    const float* __restrict__ ws1, const bf16* __restrict__ b1,
    bf16* __restrict__ hout, int M, int K, int inner, float eps) {
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
        const float a = stA[e] * ws1[gn] + __bfloat162float(b1[gn]);
        const float g =
            stG[e] * ws1[inner + gn] + __bfloat162float(b1[inner + gn]);
        hout[(long long)gm * inner + gn] = __float2bfloat16(a * gelu_erf(g));
      }
    }
    __syncwarp();
  }
}

// One 64x64 tile of out (M, N) = bf16((A W^T * ws + b) * s) + r, the
// residual added to the rounded FF output in bf16 (ffn.py:366-367), from A
// (M, Kd) bf16 and W (N, Kd) int8; ws: (N,) f32; b: (N,) bf16; r: (M, N)
// bf16. s is read from s_ptr (a device f32 scalar) when given, so a traced
// gate never syncs to the host, else s_val.
__device__ __forceinline__ void down_tile(
    const bf16* __restrict__ a, const int8_t* __restrict__ w,
    const float* __restrict__ ws, const bf16* __restrict__ b,
    const bf16* __restrict__ r, bf16* __restrict__ out,
    const float* __restrict__ s_ptr, float s_val, int M, int N, int Kd) {
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
  for (int k0 = 0; k0 < Kd; k0 += BKT) {
    stage_tile(sA, a, Kd, m0, M, k0, Kd);
    stage_tile(sB, w, Kd, n0, N, k0, Kd);
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
      if (gm < M && gn < N) {
        const long long idx = (long long)gm * N + gn;
        const float y = st[e] * ws[gn] + __bfloat162float(b[gn]);
        const float yb = __bfloat162float(__float2bfloat16(y * s));
        out[idx] = __float2bfloat16(yb + __bfloat162float(r[idx]));
      }
    }
    __syncwarp();
  }
}

}  // namespace ffn_tiles
