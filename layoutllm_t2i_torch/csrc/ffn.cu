// The GEGLU feed-forward kernels: bf16 activations, f32 statistics and
// accumulators, exact-erf GELU, LN eps as given (1e-5 at every site).
//
//   K4  out = x + s * (GEGLU(LN(x) Wa + ba, LN(x) Wg + bg) W2 + b2).
//       Replaces `_ffn_ln_kernel` (l.70) of layoutllm_t2i_tpu/ops/pallas/
//       ffn.py, launched by `_ffn_ln_call` (l.182) under `ffn_ln_geglu_fused`
//       (l.274, s = 1) and `ffn_ln_geglu_scaled` (l.302, s = fuser_scale *
//       tanh(alpha_dense)).
//   K6  out = bf16(GEGLU(x Wa + ba, x Wg + bg) W2 + b2) + r, no LN, the
//       residual r passed in. Replaces `_ffn_kernel` (l.38), launched by
//       `_ffn_call` (l.140) under `ffn_geglu_fused` (l.230): the norm3 sites
//       when LLT2I_FFN_LN=0 splits the LN out.
//   K7  K4 with int8 weights: a = (LN(x) Qa) * sa + ba, g likewise,
//       y = (h Q2) * s2 + b2, out = bf16(y * s) + x, with f32 per-output-
//       channel scales applied after each dot. Replaces `_ffn_ln_q_kernel`
//       (l.334), launched by `_ffn_ln_q_call` (l.383) under
//       `ffn_ln_geglu_scaled_q` (l.423): every LN+FF site of an int8 UNet
//       under LLT2I_FFN_INT8=1.
//
// What bounds them on the H100: operations. The three products do
// 2*M*K*(2*4K) + 2*M*4K*K = 24*M*K^2 flops against ~4*M*K bytes of x and
// out plus the weights (M = 16384, K = 320: ~1500 flop/byte); K7's int8
// weights halve the weight bytes, which matter only at small M. The
// tensor cores take bf16 products (int8 activations would change the
// function), so K7 turns its weight tiles into bf16 in shared memory.
//
// The TPU kernels keep a (bm, K) f32 accumulator resident across the inner
// dimension; at K = 1280 that alone exceeds the 227 KB of shared memory a
// Hopper block may use. So each function is split in two GEMMs with the
// GEGLU product h (M, 4K) written once in bf16 between them.
//
// K4, K6 and K7 run on gemm_tiles.cuh's mainloop (TMA ring, wgmma, f32
// accumulators in registers). K4 takes three launches on the caller's
// stream:
//   (0) ffn_norm_rows_kernel: bf16(LN(x)) of every row, once, into scratch
//       (one warp a row, centred two-pass f32 statistics), the rounding
//       point of `_ffn_ln_kernel` (ffn.py:89). It moves 4*M*K bytes, a few
//       microseconds, where normalising each A tile in the up kernel would
//       redo a row's LN in every one of its inner/128 column blocks.
//   (1) ffn_up_wgmma_kernel: A = LN(x) and two B operands, the Wa and Wg
//       rows of the same h columns, each with its own f32 accumulator; the
//       Geglu epilogue computes (a + ba) * gelu_erf(g + bg) in f32 and
//       rounds once to bf16 h. Tiles 128 x 128 of h.
//   (2) ffn_down_wgmma_kernel: h W2^T, K8a's GEMM, whose ScaledResidual
//       epilogue computes bf16((acc + b2) * s) + x, the rounding order of
//       ffn.py:107-108. Tiles 128 x 160 (or 80 where that fills the card
//       better: M = 1024, K = 1280 would fill 64 SMs).
// K6 is K4 without the pre-pass, in two launches: ffn_res_up_wgmma_kernel,
// (1) on x, then ffn_res_down_wgmma_kernel, (2) with s = 1 and r in place
// of x: bf16(bf16(acc + b2) + r), the rounding order of ffn.py:64-67.
// K7 is K4 on int8 weights, in K4's three launches under names of its own:
// ffn_q_norm_rows_kernel, (0); ffn_q_up_wgmma_kernel, (1) with Qa and Qg
// as int8 B operands (Cfg::kQ: converted to bf16 in shared memory by the
// producer warpgroup) and sa, sg on the f32 sums before the biases; and
// ffn_q_down_wgmma_kernel, (2) on Q2 with s2 on the sums: bf16(bf16((acc *
// s2 + b2) * s) + x), the rounding order of ffn.py:366-367.
//
// K4 also has an f32 form (llt2i_ffn_ln_geglu_f32), for f32 activations and
// weights, as `_ffn_ln_kernel` takes them: LN(x) and h stay f32, as the
// kernel keeps them in x's type (scratch (M, inner + K) f32), and every
// product is 3xTF32 on mma.sync (csrc/f32_tiles.cuh), f32 accuracy on the
// tensor cores. The same three launches: ffn_norm_rows_f32_kernel, then
// ffn_up_f32_kernel and ffn_down_f32_kernel on one simple tile GEMM (128 x
// 64 tiles, 32-deep k steps in a two-stage cp.async ring, eight warps of
// 32 x 32), with the GEGLU and scaled-residual epilogues in f32. Bound:
// operations at the TF32 rate, three products each.
#include "f32_tiles.cuh"
#include "gemm_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// K4

constexpr int kNormRows = 8;  // rows (warps) a block of the LN pre-pass

// xn = bf16(LayerNorm(x) * lnw + lnb), one warp a row: the mean, then the
// centred variance, in f32 over 16-byte vectors (K % 8 == 0)
__device__ __forceinline__ void norm_rows(const bf16* __restrict__ x,
                                          const bf16* __restrict__ lnw,
                                          const bf16* __restrict__ lnb,
                                          bf16* __restrict__ xn, int M, int K,
                                          float eps) {
  const int row = blockIdx.x * kNormRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nv = K / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * K);
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
  uint4* yr = reinterpret_cast<uint4*>(xn + (long long)row * K);
  for (int vi = lane; vi < nv; vi += 32) {
    float g[8], b[8], o[8];
    unpack8(xr[vi], f);
    unpack8(reinterpret_cast<const uint4*>(lnw)[vi], g);
    unpack8(reinterpret_cast<const uint4*>(lnb)[vi], b);
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = (f[j] - mean) * rstd * g[j] + b[j];
    yr[vi] = pack8(o);
  }
}

// K4's and K7's LN pre-pass, under a name each
__global__ void __launch_bounds__(kNormRows * 32)
ffn_norm_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                     const bf16* __restrict__ lnb, bf16* __restrict__ xn,
                     int M, int K, float eps) {
  norm_rows(x, lnw, lnb, xn, M, K, eps);
}

__global__ void __launch_bounds__(kNormRows * 32)
ffn_q_norm_rows_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ lnw,
                       const bf16* __restrict__ lnb, bf16* __restrict__ xn,
                       int M, int K, float eps) {
  norm_rows(x, lnw, lnb, xn, M, K, eps);
}

// bf16(LN(x)) of every row into xn on `st`
template <auto kNorm>
int launch_norm(const void* x, const void* lnw, const void* lnb, bf16* xn,
                int M, int K, float eps, cudaStream_t st) {
  kNorm<<<(M + kNormRows - 1) / kNormRows, kNormRows * 32, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<const bf16*>(lnb), xn, M, K, eps);
  return (int)cudaGetLastError();
}

// up tiles 128 x (2 x 128): at every main-path shape faster than 2 x 64,
// which left fewer SMs idle in the last wave but ran m64n64 products; down
// tiles 128 x 160, or 80 where that fills the card better
using UpCfg = gemm_tiles::Cfg<128, 2>;
using DownWide = gemm_tiles::Cfg<160, 1>;
using DownNarrow = gemm_tiles::Cfg<80, 1>;
// K7's: the same tiles on int8 B operands (3 stages up, 4 and 6 down)
using QUpCfg = gemm_tiles::Cfg<128, 2, true>;
using QDownWide = gemm_tiles::Cfg<160, 1, true>;
using QDownNarrow = gemm_tiles::Cfg<80, 1, true>;

// The up and down GEMMs of K4, K6 and K7 run the same tiles under names of
// their own, so that a profile and the HGMMA check tell them apart.

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_up_wgmma_kernel(const __grid_constant__ CUtensorMap txn,
                    const __grid_constant__ CUtensorMap twa,
                    const __grid_constant__ CUtensorMap twg,
                    const bf16* __restrict__ b1, bf16* __restrict__ h, int M,
                    int K, int inner) {
  gemm_tiles::gemm_tile<C>(&txn, &twa, &twg, K,
                           gemm_tiles::Geglu{b1, h, M, inner});
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_res_up_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap twa,
                        const __grid_constant__ CUtensorMap twg,
                        const bf16* __restrict__ b1, bf16* __restrict__ h,
                        int M, int K, int inner) {
  gemm_tiles::gemm_tile<C>(&tx, &twa, &twg, K,
                           gemm_tiles::Geglu{b1, h, M, inner});
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                      const __grid_constant__ CUtensorMap tw2,
                      const bf16* __restrict__ b2, const bf16* __restrict__ x,
                      bf16* __restrict__ out, const float* __restrict__ s_ptr,
                      float s_val, int M, int K, int inner) {
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  gemm_tiles::gemm_tile<C>(&th, &tw2, nullptr, inner,
                           gemm_tiles::ScaledResidual{b2, x, out, s, M, K});
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_res_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                          const __grid_constant__ CUtensorMap tw2,
                          const bf16* __restrict__ b2,
                          const bf16* __restrict__ r, bf16* __restrict__ out,
                          const float* __restrict__ s_ptr, float s_val, int M,
                          int K, int inner) {
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  gemm_tiles::gemm_tile<C>(&th, &tw2, nullptr, inner,
                           gemm_tiles::ScaledResidual{b2, r, out, s, M, K});
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_q_up_wgmma_kernel(const __grid_constant__ CUtensorMap txn,
                      const __grid_constant__ CUtensorMap tqa,
                      const __grid_constant__ CUtensorMap tqg,
                      const float* __restrict__ s1,
                      const bf16* __restrict__ b1, bf16* __restrict__ h,
                      int M, int K, int inner) {
  gemm_tiles::gemm_tile<C>(&txn, &tqa, &tqg, K,
                           gemm_tiles::Geglu{b1, h, M, inner, s1});
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
ffn_q_down_wgmma_kernel(const __grid_constant__ CUtensorMap th,
                        const __grid_constant__ CUtensorMap tq2,
                        const float* __restrict__ s2,
                        const bf16* __restrict__ b2,
                        const bf16* __restrict__ x, bf16* __restrict__ out,
                        const float* __restrict__ s_ptr, float s_val, int M,
                        int K, int inner) {
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  gemm_tiles::gemm_tile<C>(&th, &tq2, nullptr, inner,
                           gemm_tiles::ScaledResidual{b2, x, out, s, M, K, s2});
}

// The down GEMM h W2^T with the residual r, by kWide on 160-wide tiles or
// kNarrow on 80-wide ones (ffn_down_wgmma_kernel or
// ffn_res_down_wgmma_kernel of DownWide and DownNarrow)
template <auto kWide, auto kNarrow>
int launch_down(const void* h, const void* w2, const void* b2, const void* r,
                void* out, const void* s_ptr, float s_val, int M, int K,
                int inner, cudaStream_t st) {
  const bool narrow =
      gemm_tiles::pick_narrow(M, K, DownWide::kBN, DownNarrow::kBN);
  CUtensorMap th, tw2;
  int err = tensor_map_2d(&th, h, M, inner, gemm_tiles::kBM);
  if (err == 0)
    err = tensor_map_2d(&tw2, w2, K, inner,
                        narrow ? DownNarrow::kBN : DownWide::kBN);
  if (err != 0) return err;
  const bf16* b = static_cast<const bf16*>(b2);
  const bf16* res = static_cast<const bf16*>(r);
  bf16* o = static_cast<bf16*>(out);
  const float* sp = static_cast<const float*>(s_ptr);
  return narrow ? gemm_tiles::launch<DownNarrow, kNarrow>(
                      M, K, st, th, tw2, b, res, o, sp, s_val, M, K, inner)
                : gemm_tiles::launch<DownWide, kWide>(
                      M, K, st, th, tw2, b, res, o, sp, s_val, M, K, inner);
}

// K7's up GEMM: xn (M, K) bf16 against q1 = [Qa; Qg] (2 * inner, K) int8,
// one uint8 tensor map on each half (zero fill ends each at inner rows)
int launch_q_up(const bf16* xn, const void* q1, const void* s1,
                const void* b1, void* h, int M, int K, int inner,
                cudaStream_t st) {
  using C = QUpCfg;
  const int8_t* qa = static_cast<const int8_t*>(q1);
  CUtensorMap tx, tqa, tqg;
  int err = tensor_map_2d(&tx, xn, M, K, gemm_tiles::kBM);
  if (err == 0) err = tensor_map_2d(&tqa, qa, inner, K, C::kBN, true);
  if (err == 0)
    err = tensor_map_2d(&tqg, qa + (long long)inner * K, inner, K, C::kBN,
                        true);
  if (err != 0) return err;
  return gemm_tiles::launch<C, ffn_q_up_wgmma_kernel<C>>(
      M, inner, st, tx, tqa, tqg, static_cast<const float*>(s1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(h), M, K, inner);
}

// K7's down GEMM: h (M, inner) against q2 (K, inner) int8 on 160- or
// 80-wide tiles, as K4's
int launch_q_down(const bf16* h, const void* q2, const void* s2,
                  const void* b2, const void* x, void* out, const void* s_ptr,
                  float s_val, int M, int K, int inner, cudaStream_t st) {
  const bool narrow =
      gemm_tiles::pick_narrow(M, K, QDownWide::kBN, QDownNarrow::kBN);
  CUtensorMap th, tq2;
  int err = tensor_map_2d(&th, h, M, inner, gemm_tiles::kBM);
  if (err == 0)
    err = tensor_map_2d(&tq2, q2, K, inner,
                        narrow ? QDownNarrow::kBN : QDownWide::kBN, true);
  if (err != 0) return err;
  const float* sc = static_cast<const float*>(s2);
  const bf16* b = static_cast<const bf16*>(b2);
  const bf16* res = static_cast<const bf16*>(x);
  bf16* o = static_cast<bf16*>(out);
  const float* sp = static_cast<const float*>(s_ptr);
  return narrow ? gemm_tiles::launch<QDownNarrow,
                                     ffn_q_down_wgmma_kernel<QDownNarrow>>(
                      M, K, st, th, tq2, sc, b, res, o, sp, s_val, M, K, inner)
                : gemm_tiles::launch<QDownWide,
                                     ffn_q_down_wgmma_kernel<QDownWide>>(
                      M, K, st, th, tq2, sc, b, res, o, sp, s_val, M, K, inner);
}

// ---------------------------------------------------------------------------
// K4 in f32

// xn = LayerNorm(x) * lnw + lnb in f32, one warp a row: the mean, then the
// centred variance, over 16-byte vectors (K % 4 == 0)
__global__ void __launch_bounds__(kNormRows * 32)
ffn_norm_rows_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ lnw,
                         const float* __restrict__ lnb, float* __restrict__ xn,
                         int M, int K, float eps) {
  const int row = blockIdx.x * kNormRows + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nv = K / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (long long)row * K);
  float s = 0.f;
  for (int vi = lane; vi < nv; vi += 32) {
    const float4 f = xr[vi];
    s += (f.x + f.y) + (f.z + f.w);
  }
  const float mean = warp_sum(s) / K;
  float ss = 0.f;
  for (int vi = lane; vi < nv; vi += 32) {
    const float4 f = xr[vi];
    const float a = f.x - mean, b = f.y - mean, c = f.z - mean, d = f.w - mean;
    ss += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(ss) / K + eps);
  const float4* gr = reinterpret_cast<const float4*>(lnw);
  const float4* br = reinterpret_cast<const float4*>(lnb);
  float4* yr = reinterpret_cast<float4*>(xn + (long long)row * K);
  for (int vi = lane; vi < nv; vi += 32) {
    const float4 f = xr[vi], g = gr[vi], b = br[vi];
    yr[vi] = make_float4((f.x - mean) * rstd * g.x + b.x,
                         (f.y - mean) * rstd * g.y + b.y,
                         (f.z - mean) * rstd * g.z + b.z,
                         (f.w - mean) * rstd * g.w + b.w);
  }
}

constexpr int kF32BM = 128, kF32BN = 64, kF32BK = 32, kF32Ld = kF32BK + 4;
constexpr int kF32Threads = 256;

// shared memory of the f32 GEMM with kNB B operands: two stages of an A
// tile and kNB B tiles
template <int kNB>
constexpr size_t f32_gemm_smem() {
  return 4ull * kF32Ld * 2 * (kF32BM + kNB * kF32BN);
}

// The (kF32BM x kF32BN) tile at (m0, n0) of A B_i^T for i < kNB: A (M x Kd,
// row stride lda), B_i (N x Kd, row stride ldb), both row-major, each
// product into its own accumulators. Eight warps as 4 (rows) x 2 (columns),
// a warp 32 x 32: acc[i][m16 tile][n8 tile][4]. Rows past M or N and
// columns past Kd (Kd % 4 == 0) load as zeros.
template <int kNB>
__device__ __forceinline__ void gemm_f32(float (&acc)[kNB][2][4][4],
                                         const float* A, long long lda, int M,
                                         const float* const (&B)[kNB],
                                         long long ldb, int N, int Kd, int m0,
                                         int n0, float* smem) {
  using namespace f32_tiles;
  constexpr int kStage = kF32Ld * (kF32BM + kNB * kF32BN);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);
  const int tiles = (Kd + kF32BK - 1) / kF32BK;
  auto load = [&](int kt) {
    float* st = smem + (kt & 1) * kStage;
    const int k0 = kt * kF32BK;
    load_tile<kF32BM, kF32BK, kF32Threads>(st, kF32Ld, A + (long long)m0 * lda + k0,
                                           lda, 0, M - m0, Kd - k0);
#pragma unroll
    for (int i = 0; i < kNB; ++i)
      load_tile<kF32BN, kF32BK, kF32Threads>(
          st + (kF32BM + i * kF32BN) * kF32Ld, kF32Ld,
          B[i] + (long long)n0 * ldb + k0, ldb, 0, N - n0, Kd - k0);
  };
#pragma unroll
  for (int i = 0; i < kNB; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][mi][nt][c] = 0.f;
  load(0);
  cp_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {  // the next stage; its last readers were synced
      load(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sA = smem + (kt & 1) * kStage;
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {
      float a[2][4];
      frag_a(a[0], sA, kF32Ld, wm, 8 * kk, lane);
      frag_a(a[1], sA, kF32Ld, wm + 16, 8 * kk, lane);
      const SplitA a0(a[0]), a1(a[1]);
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        const float* sB = sA + (kF32BM + i * kF32BN) * kF32Ld;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float bb[2];
          frag_b_nk(bb, sB, kF32Ld, wn + 8 * nt, 8 * kk, lane);
          mma3(acc[i][0][nt], a0, bb);
          mma3(acc[i][1][nt], a1, bb);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
}

// h = (xn Wa^T + ba) * gelu(xn Wg^T + bg), f32, tiles of h (M, inner)
__global__ void __launch_bounds__(kF32Threads, 2)
ffn_up_f32_kernel(const float* __restrict__ xn, const float* __restrict__ w1,
                  const float* __restrict__ b1, float* __restrict__ h, int M,
                  int K, int inner) {
  extern __shared__ __align__(16) float smem_f[];
  const int m0 = blockIdx.y * kF32BM, n0 = blockIdx.x * kF32BN;
  const float* const B[2] = {w1, w1 + (long long)inner * K};
  float acc[2][2][4][4];
  gemm_f32<2>(acc, xn, K, M, B, K, inner, K, m0, n0, smem_f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 32 * (warp >> 1) + 16 * mi + (lane >> 2) + 8 * r;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + 32 * (warp & 1) + 8 * nt + 2 * (lane & 3);
        if (col >= inner) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[0][mi][nt][2 * r + e] + b1[col + e];
          const float g = acc[1][mi][nt][2 * r + e] + b1[inner + col + e];
          o[e] = a * gelu_erf(g);
        }
        *reinterpret_cast<float2*>(h + (long long)row * inner + col) =
            make_float2(o[0], o[1]);
      }
    }
}

// out = x + s * (h W2^T + b2), f32, tiles of out (M, K)
__global__ void __launch_bounds__(kF32Threads, 2)
ffn_down_f32_kernel(const float* __restrict__ h, const float* __restrict__ w2,
                    const float* __restrict__ b2, const float* __restrict__ x,
                    float* __restrict__ out, const float* __restrict__ s_ptr,
                    float s_val, int M, int K, int inner) {
  extern __shared__ __align__(16) float smem_f[];
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  const int m0 = blockIdx.y * kF32BM, n0 = blockIdx.x * kF32BN;
  const float* const B[1] = {w2};
  float acc[1][2][4][4];
  gemm_f32<1>(acc, h, inner, M, B, inner, K, inner, m0, n0, smem_f);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 32 * (warp >> 1) + 16 * mi + (lane >> 2) + 8 * r;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + 32 * (warp & 1) + 8 * nt + 2 * (lane & 3);
        if (col >= K) continue;
        const long long i = (long long)row * K + col;
        const float2 xr = *reinterpret_cast<const float2*>(x + i);
        *reinterpret_cast<float2*>(out + i) = make_float2(
            xr.x + (acc[0][mi][nt][2 * r] + b2[col]) * s,
            xr.y + (acc[0][mi][nt][2 * r + 1] + b2[col + 1]) * s);
      }
    }
}

}  // namespace

// K4. x, out: (M, K) bf16; lnw, lnb: (K,); w1: (2*inner, K) = [Wa; Wg] in
// the torch (out, in) layout; b1: (2*inner,); w2: (K, inner); b2: (K,);
// hbuf: (M, inner + K) bf16 scratch, h (M, inner) then bf16(LN(x)) (M, K).
// s_ptr: device f32 scalar or null (then s_val). K % 8 == 0, inner % 8 ==
// 0; x, lnw, lnb, w1, w2 and hbuf 16-byte aligned (TMA, 16-byte loads),
// b1, b2 and out 4-byte aligned.
LLT2I_API int llt2i_ffn_ln_geglu(const void* x, const void* lnw,
                                 const void* lnb, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* hbuf, void* out,
                                 const void* s_ptr, float s_val, int M, int K,
                                 int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || inner % 8) return (int)cudaErrorInvalidValue;
  bf16* h = static_cast<bf16*>(hbuf);
  bf16* xn = h + (long long)M * inner;
  int err = launch_norm<ffn_norm_rows_kernel>(x, lnw, lnb, xn, M, K, eps, st);
  if (err != 0) return err;
  err = gemm_tiles::launch_geglu<UpCfg, ffn_up_wgmma_kernel<UpCfg>>(
      xn, w1, b1, h, M, K, inner, st);
  if (err != 0) return err;
  return launch_down<ffn_down_wgmma_kernel<DownWide>,
                     ffn_down_wgmma_kernel<DownNarrow>>(
      h, w2, b2, x, out, s_ptr, s_val, M, K, inner, st);
}

// K6. x, r, out: (M, K) bf16; w1, b1, w2, b2 as K4; hbuf (M, inner) bf16
// scratch. K % 8 == 0, inner % 8 == 0; x, w1, w2 and hbuf 16-byte aligned
// (TMA), b1, b2, r and out 4-byte aligned.
LLT2I_API int llt2i_ffn_geglu(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* r,
                              void* hbuf, void* out, int M, int K, int inner,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || inner % 8) return (int)cudaErrorInvalidValue;
  const int err =
      gemm_tiles::launch_geglu<UpCfg, ffn_res_up_wgmma_kernel<UpCfg>>(
          x, w1, b1, hbuf, M, K, inner, st);
  if (err != 0) return err;
  return launch_down<ffn_res_down_wgmma_kernel<DownWide>,
                     ffn_res_down_wgmma_kernel<DownNarrow>>(
      hbuf, w2, b2, r, out, nullptr, 1.f, M, K, inner, st);
}

// K7. x, out, lnw, lnb, b1, b2 as K4; q1: (2*inner, K) int8 = [Qa; Qg];
// s1: (2*inner,) f32; q2: (K, inner) int8; s2: (K,) f32; hbuf: (M, inner +
// K) bf16 scratch, h then bf16(LN(x)), as K4's. K % 16 == 0 and inner % 16
// == 0 (TMA: 16-byte int8 rows); x, lnw, lnb, q1, q2 and hbuf 16-byte
// aligned, s1 and s2 8-byte, b1, b2 and out 4-byte.
LLT2I_API int llt2i_ffn_ln_geglu_q(const void* x, const void* lnw,
                                   const void* lnb, const void* q1,
                                   const void* s1, const void* b1,
                                   const void* q2, const void* s2,
                                   const void* b2, void* hbuf, void* out,
                                   const void* s_ptr, float s_val, int M,
                                   int K, int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16 || inner % 16) return (int)cudaErrorInvalidValue;
  bf16* h = static_cast<bf16*>(hbuf);
  bf16* xn = h + (long long)M * inner;
  int err =
      launch_norm<ffn_q_norm_rows_kernel>(x, lnw, lnb, xn, M, K, eps, st);
  if (err == 0) err = launch_q_up(xn, q1, s1, b1, h, M, K, inner, st);
  if (err != 0) return err;
  return launch_q_down(h, q2, s2, b2, x, out, s_ptr, s_val, M, K, inner, st);
}

// K4 in f32. x, out, lnw, lnb, w1, b1, w2, b2 as K4's, all f32; hbuf: (M,
// inner + K) f32 scratch, h (M, inner) then LN(x) (M, K). K % 8 == 0 and
// inner % 8 == 0; x, lnw, lnb, w1, w2 and hbuf 16-byte aligned, b1, b2 and
// out 8-byte aligned.
LLT2I_API int llt2i_ffn_ln_geglu_f32(const void* x, const void* lnw,
                                     const void* lnb, const void* w1,
                                     const void* b1, const void* w2,
                                     const void* b2, void* hbuf, void* out,
                                     const void* s_ptr, float s_val, int M,
                                     int K, int inner, float eps,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || inner % 8) return (int)cudaErrorInvalidValue;
  float* h = static_cast<float*>(hbuf);
  float* xn = h + (long long)M * inner;
  ffn_norm_rows_f32_kernel<<<(M + kNormRows - 1) / kNormRows, kNormRows * 32,
                             0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), xn, M, K, eps);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  static unsigned long long up_set = 0, down_set = 0;
  err = allow_smem(ffn_up_f32_kernel, f32_gemm_smem<2>(), up_set);
  if (err == 0)
    err = allow_smem(ffn_down_f32_kernel, f32_gemm_smem<1>(), down_set);
  if (err != 0) return err;
  const int mt = (M + kF32BM - 1) / kF32BM;
  ffn_up_f32_kernel<<<dim3((inner + kF32BN - 1) / kF32BN, mt), kF32Threads,
                      f32_gemm_smem<2>(), st>>>(
      xn, static_cast<const float*>(w1), static_cast<const float*>(b1), h, M,
      K, inner);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  ffn_down_f32_kernel<<<dim3((K + kF32BN - 1) / kF32BN, mt), kF32Threads,
                        f32_gemm_smem<1>(), st>>>(
      h, static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const float*>(s_ptr), s_val, M, K, inner);
  return (int)cudaGetLastError();
}
