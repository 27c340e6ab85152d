// The blocked GEMMs of the opt-in Pallas matmul route (LLT2I_PALLAS_MATMUL=1):
//
//   K8a  out = bf16(x W^T + b + r), bias and residual added to the f32 sum,
//        either optional. Replaces `_mm_kernel` (l.56) of
//        layoutllm_t2i_tpu/ops/pallas/matmul.py, launched by `_mm_call`
//        (l.131) under `linear_fused` (l.214): the FF down-projection of a
//        site that took K8b.
//   K8b  out = bf16((x Wa^T + ba) * gelu_erf(x Wg^T + bg)), W = [Wa; Wg] in
//        one (2N, K) matrix, bias optional. Replaces `_geglu_kernel` (l.78),
//        launched by `_geglu_call` (l.169) under `geglu_fused` (l.241): the
//        FF up-projection where `geglu_ff` sees M >= 1024 rows.
//
// What bounds them on the H100: operations (K8a 2*M*K*N, K8b 4*M*K*N flops;
// at M = 16384, K = 320, N = 1280 about 300 flop per byte moved). K8a's
// bytes come closest at M = 1024, K = 5120, N = 1280: 13.4 GFLOP against
// 26.2 MB, 13.6 us of operations against 7.8 us of bytes. There the grid
// is the limit: only 64 of the 132 SMs would hold a 128 x 160 tile, so the
// launch takes tiles 80 wide (gemm_tiles.cuh pick_narrow), 128 of them.
//
// Both run on gemm_tiles.cuh's mainloop: TMA ring, wgmma with the f32
// accumulators in registers, the epilogue applied to them. The TPU kernels
// carry f32 (bm, bn) accumulators across a sequential K grid axis; here
// each block's loop over K takes that axis's place. K8a adds the bias and
// the residual. K8b is K4's and K6's up kernel on x: Wa and Wg as two B
// operands with an accumulator each, the shared Geglu epilogue, tiles
// 128 x 128 of the output.
//
// Both have f32 forms (llt2i_linear_f32, llt2i_geglu_f32), for f32 x and
// weights, as the Pallas kernels take them, with the same epilogues in f32.
// Both run on tf32_gemm.cuh's mainloop: 3xTF32 on wgmma fed by TMA. K8a/f32
// (linear_f32_wgmma_kernel: acc + b, then + r) takes 128 x 160 tiles, which
// fill 128 of the 132 SMs at its widest shape (M = 2048, N = 1280).
// K8b/f32 (geglu_f32_wgmma_kernel) is K4/f32's up GEMM on x: 128 x 64
// tiles of the output, Wa's and Wg's 64 rows of one tile from two tensor
// maps in one 128-row B tile, tf32_gemm.cuh's GegluF32 epilogue with the
// bias optional. Bound: operations at the TF32 rate.
#include "gemm_tiles.cuh"
#include "tf32_gemm.cuh"

namespace {

// K8a's epilogue: bf16(acc + b + r), b and r optional, in f32 as
// matmul.py:70-75 adds them
struct BiasResidual {
  const bf16* b;  // (N,) or null
  const bf16* r;  // (M, N) or null
  bf16* out;      // (M, N)
  int M, N;

  template <int NB, int W>
  __device__ __forceinline__ void operator()(const float (&acc)[NB][W],
                                             int row0, int n0,
                                             int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long long at = (long long)row * N;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= N) continue;
        float y0 = acc[0][4 * j + 2 * h], y1 = acc[0][4 * j + 2 * h + 1];
        if (b != nullptr) {
          const float2 v = gemm_tiles::load_pair(b + col);
          y0 += v.x;
          y1 += v.y;
        }
        if (r != nullptr) {
          const float2 v = gemm_tiles::load_pair(r + at + col);
          y0 += v.x;
          y1 += v.y;
        }
        gemm_tiles::store_pair(out + at + col, y0, y1);
      }
    }
  }
};

// K8a tiles: 128 x 160, or 128 x 80 where that fills the card better
using LinearWide = gemm_tiles::Cfg<160, 1>;
using LinearNarrow = gemm_tiles::Cfg<80, 1>;

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const bf16* __restrict__ b, const bf16* __restrict__ r,
                    bf16* __restrict__ out, int M, int N, int K) {
  gemm_tiles::gemm_tile<C>(&tx, &tw, nullptr, K, BiasResidual{b, r, out, M, N});
}

template <class C>
int launch_linear(const void* x, const void* w, const void* b, const void* r,
                  void* out, int M, int K, int N, cudaStream_t st) {
  CUtensorMap tx, tw;
  int err = tensor_map_2d(&tx, x, M, K, gemm_tiles::kBM);
  if (err == 0) err = tensor_map_2d(&tw, w, N, K, C::kBN);
  if (err != 0) return err;
  return gemm_tiles::launch<C, linear_wgmma_kernel<C>>(
      M, N, st, tx, tw, static_cast<const bf16*>(b),
      static_cast<const bf16*>(r), static_cast<bf16*>(out), M, N, K);
}

// K8b tiles: 128 x (2 x 128), K4's up tiles (K8b's shapes are theirs)
using GegluCfg = gemm_tiles::Cfg<128, 2>;

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
geglu_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap twa,
                   const __grid_constant__ CUtensorMap twg,
                   const bf16* __restrict__ b, bf16* __restrict__ out, int M,
                   int K, int N) {
  gemm_tiles::gemm_tile<C>(&tx, &twa, &twg, K, gemm_tiles::Geglu{b, out, M, N});
}

// K8a/f32's epilogue: out = acc + b, then + r, in f32 as matmul.py:70-75
// adds them; b and r optional
struct BiasResidualF32 {
  const float* b;  // (N,) or null
  const float* r;  // (M, N) or null
  float* out;      // (M, N)
  int M, N;

  template <int W>
  __device__ __forceinline__ void operator()(const float (&acc)[W], int row0,
                                             int n0, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long long at = (long long)row * N;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= N) continue;  // N % 4 == 0: col + 1 < N too
        float y0 = acc[4 * j + 2 * h], y1 = acc[4 * j + 2 * h + 1];
        if (b != nullptr) {
          y0 += b[col];
          y1 += b[col + 1];
        }
        if (r != nullptr) {
          const float2 v = *reinterpret_cast<const float2*>(r + at + col);
          y0 += v.x;
          y1 += v.y;
        }
        *reinterpret_cast<float2*>(out + at + col) = make_float2(y0, y1);
      }
    }
  }
};

// K8a/f32 tiles: 128 x 160 (160 divides the output widths 320, 640, 1280)
using LinearF32Cfg = tf32_gemm::Cfg<160>;

// K8a in f32: out = x W^T (+ b) (+ r) on the TF32 wgmma mainloop
__global__ void __launch_bounds__(LinearF32Cfg::kThreads, 1)
linear_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tw,
                        const float* __restrict__ b, const float* __restrict__ r,
                        float* __restrict__ out, int M, int N, int K) {
  tf32_gemm::gemm_tile<LinearF32Cfg>(&tx, &tw, K,
                                     BiasResidualF32{b, r, out, M, N});
}

// K8b/f32 tiles: K4/f32's up tiles, 128 rows x (64 Wa + 64 Wg) B rows
using GegluF32Cfg = tf32_gemm::Cfg<128>;

// K8b in f32: out = (x Wa^T + ba) * gelu_erf(x Wg^T + bg), b optional, 128
// x 64 tiles of out (M, N); twa and twg map Wa's and Wg's N rows
__global__ void __launch_bounds__(GegluF32Cfg::kThreads, 1)
geglu_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap twa,
                       const __grid_constant__ CUtensorMap twg,
                       const float* __restrict__ b, float* __restrict__ out,
                       int M, int K, int N) {
  tf32_gemm::gemm_tile_pair<GegluF32Cfg>(&tx, &twa, &twg, K,
                                         tf32_gemm::GegluF32{b, out, M, N});
}

}  // namespace

// K8a. x: (M, K) bf16; w: (N, K) bf16 (torch layout); b: (N,) bf16 or null;
// r: (M, N) bf16 or null; out: (M, N) bf16. K % 8 == 0 and N % 8 == 0; x
// and w 16-byte aligned (TMA), b, r and out 4-byte aligned.
LLT2I_API int llt2i_linear(const void* x, const void* w, const void* b,
                           const void* r, void* out, int M, int K, int N,
                           void* stream) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return gemm_tiles::pick_narrow(M, N, LinearWide::kBN, LinearNarrow::kBN)
             ? launch_linear<LinearNarrow>(x, w, b, r, out, M, K, N, st)
             : launch_linear<LinearWide>(x, w, b, r, out, M, K, N, st);
}

// K8b. x: (M, K) bf16; w: (2N, K) = [Wa; Wg] bf16; b: (2N,) bf16 or null;
// out: (M, N) bf16. K % 8 == 0 and N % 8 == 0; x and w 16-byte aligned
// (TMA), b and out 4-byte aligned.
LLT2I_API int llt2i_geglu(const void* x, const void* w, const void* b,
                          void* out, int M, int K, int N, void* stream) {
  if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
  return gemm_tiles::launch_geglu<GegluCfg, geglu_wgmma_kernel<GegluCfg>>(
      x, w, b, out, M, K, N, static_cast<cudaStream_t>(stream));
}

// K8a in f32. x: (M, K) f32; w: (N, K) f32; b: (N,) f32 or null; r: (M, N)
// f32 or null; out: (M, N) f32. K % 4 == 0 and N % 4 == 0; x and w 16-byte
// aligned (TMA), b 4-byte, r and out 8-byte.
LLT2I_API int llt2i_linear_f32(const void* x, const void* w, const void* b,
                               const void* r, void* out, int M, int K, int N,
                               void* stream) {
  if (K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int err = tensor_map_2d_f32(&tx, x, M, K, tf32_gemm::kBM);
  if (err == 0) err = tensor_map_2d_f32(&tw, w, N, K, LinearF32Cfg::kBN);
  if (err != 0) return err;
  return tf32_gemm::launch<LinearF32Cfg, linear_f32_wgmma_kernel>(
      M, N, static_cast<cudaStream_t>(stream), tx, tw,
      static_cast<const float*>(b), static_cast<const float*>(r),
      static_cast<float*>(out), M, N, K);
}

// K8b in f32. x: (M, K) f32; w: (2N, K) = [Wa; Wg] f32; b: (2N,) f32 or
// null; out: (M, N) f32. K % 4 == 0 and N % 4 == 0; x and w 16-byte aligned
// (TMA), b 4-byte, out 8-byte.
LLT2I_API int llt2i_geglu_f32(const void* x, const void* w, const void* b,
                              void* out, int M, int K, int N, void* stream) {
  if (K % 4 || N % 4) return (int)cudaErrorInvalidValue;
  const float* wa = static_cast<const float*>(w);
  CUtensorMap tx, twa, twg;
  int err = tensor_map_2d_f32(&tx, x, M, K, tf32_gemm::kBM);
  if (err == 0) err = tensor_map_2d_f32(&twa, wa, N, K, GegluF32Cfg::kBN / 2);
  if (err == 0)
    err = tensor_map_2d_f32(&twg, wa + (long long)N * K, N, K,
                            GegluF32Cfg::kBN / 2);
  if (err != 0) return err;
  // the grid: 2 N B rows in tiles of 128, 64 output columns each
  return tf32_gemm::launch<GegluF32Cfg, geglu_f32_wgmma_kernel>(
      M, 2 * N, static_cast<cudaStream_t>(stream), tx, twa, twg,
      static_cast<const float*>(b), static_cast<float*>(out), M, K, N);
}
