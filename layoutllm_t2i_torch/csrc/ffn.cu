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
// weights halve the weight bytes, which matter only at small M.
//
// The TPU kernels keep a (bm, K) f32 accumulator resident across the inner
// dimension; at K = 1280 that alone exceeds the 227 KB of shared memory a
// Hopper block may use. So each function is split in two kernels:
//   (a) an up kernel (geglu_up_tile): per 64x64 tile of the (M, 4K) GEGLU
//       product, both up-projections on the tensor cores with f32
//       accumulation (K4/K7: LN statistics of the 64 rows first, each A tile
//       normalised and rounded to bf16 on its way into shared memory, as
//       `_ffn_ln_kernel` rounds its LN'd row, ffn.py:89; K7: int8 weight
//       tiles converted to bf16 in shared memory); the epilogue applies the
//       scales and biases, a * gelu_erf(g) in f32, and writes h as bf16;
//   (b) a down kernel (down_tile): the GEMM h W2^T whose epilogue computes
//       bf16((acc * s2 + b2) * s) + residual, the rounding order of
//       ffn.py:107-108 (K4), :66-67 (K6, s = 1) and :366-367 (K7).
// Simple, not fast: see ffn_tiles.cuh.
#include "ffn_tiles.cuh"

using namespace ffn_tiles;

namespace {

__global__ void __launch_bounds__(kThreads)
ffn_up_kernel(const bf16* x, const bf16* lnw, const bf16* lnb, const bf16* w1,
              const bf16* b1, bf16* hout, int M, int K, int inner, float eps) {
  geglu_up_tile<true, bf16>(x, lnw, lnb, w1, nullptr, b1, hout, M, K, inner, eps);
}

__global__ void __launch_bounds__(kThreads)
ffn_down_kernel(const bf16* h, const bf16* w2, const bf16* b2, const bf16* x,
                bf16* out, const float* s_ptr, float s_val, int M, int K,
                int inner) {
  down_tile<Epilogue::kScaledResidual, bf16>(h, w2, nullptr, b2, x, out, s_ptr,
                                              s_val, M, K, inner);
}

__global__ void __launch_bounds__(kThreads)
ffn_res_up_kernel(const bf16* x, const bf16* w1, const bf16* b1, bf16* hout,
                  int M, int K, int inner) {
  geglu_up_tile<false, bf16>(x, nullptr, nullptr, w1, nullptr, b1, hout, M, K,
                             inner, 0.f);
}

__global__ void __launch_bounds__(kThreads)
ffn_res_down_kernel(const bf16* h, const bf16* w2, const bf16* b2,
                    const bf16* r, bf16* out, int M, int K, int inner) {
  down_tile<Epilogue::kScaledResidual, bf16>(h, w2, nullptr, b2, r, out,
                                              nullptr, 1.f, M, K, inner);
}

__global__ void __launch_bounds__(kThreads)
ffn_q_up_kernel(const bf16* x, const bf16* lnw, const bf16* lnb,
                const int8_t* q1, const float* s1, const bf16* b1, bf16* hout,
                int M, int K, int inner, float eps) {
  geglu_up_tile<true, int8_t>(x, lnw, lnb, q1, s1, b1, hout, M, K, inner, eps);
}

__global__ void __launch_bounds__(kThreads)
ffn_q_down_kernel(const bf16* h, const int8_t* q2, const float* s2,
                  const bf16* b2, const bf16* x, bf16* out, const float* s_ptr,
                  float s_val, int M, int K, int inner) {
  down_tile<Epilogue::kScaledResidual, int8_t>(h, q2, s2, b2, x, out, s_ptr,
                                                s_val, M, K, inner);
}

inline dim3 up_grid(int M, int inner) {
  return dim3((inner + BN - 1) / BN, (M + BM - 1) / BM);
}

inline dim3 down_grid(int M, int K) {
  return dim3((K + BN - 1) / BN, (M + BM - 1) / BM);
}

}  // namespace

// K4. x, out: (M, K) bf16; lnw, lnb: (K,); w1: (2*inner, K) = [Wa; Wg] in
// the torch (out, in) layout; b1: (2*inner,); w2: (K, inner); b2: (K,);
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
  ffn_up_kernel<<<up_grid(M, inner), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<const bf16*>(lnb), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(hbuf), M, K, inner,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_down_kernel<<<down_grid(M, K), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
      static_cast<bf16*>(out), static_cast<const float*>(s_ptr), s_val, M, K,
      inner);
  return (int)cudaGetLastError();
}

// K6. x, r, out: (M, K) bf16; w1, b1, w2, b2 as K4; hbuf (M, inner) bf16
// scratch. K % 8 == 0, inner % 8 == 0.
LLT2I_API int llt2i_ffn_geglu(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* r,
                              void* hbuf, void* out, int M, int K, int inner,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 8 || inner % 8) return (int)cudaErrorInvalidValue;
  ffn_res_up_kernel<<<up_grid(M, inner), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(b1), static_cast<bf16*>(hbuf), M, K, inner);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_res_down_kernel<<<down_grid(M, K), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(r),
      static_cast<bf16*>(out), M, K, inner);
  return (int)cudaGetLastError();
}

// K7. x, out, lnw, lnb, b1, b2 as K4; q1: (2*inner, K) int8 = [Qa; Qg];
// s1: (2*inner,) f32; q2: (K, inner) int8; s2: (K,) f32; hbuf (M, inner)
// bf16 scratch. K % 16 == 0 and inner % 16 == 0 (16-byte int8 loads).
LLT2I_API int llt2i_ffn_ln_geglu_q(const void* x, const void* lnw,
                                   const void* lnb, const void* q1,
                                   const void* s1, const void* b1,
                                   const void* q2, const void* s2,
                                   const void* b2, void* hbuf, void* out,
                                   const void* s_ptr, float s_val, int M,
                                   int K, int inner, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 16 || inner % 16) return (int)cudaErrorInvalidValue;
  ffn_q_up_kernel<<<up_grid(M, inner), kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lnw),
      static_cast<const bf16*>(lnb), static_cast<const int8_t*>(q1),
      static_cast<const float*>(s1), static_cast<const bf16*>(b1),
      static_cast<bf16*>(hbuf), M, K, inner, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ffn_q_down_kernel<<<down_grid(M, K), kThreads, 0, st>>>(
      static_cast<const bf16*>(hbuf), static_cast<const int8_t*>(q2),
      static_cast<const float*>(s2), static_cast<const bf16*>(b2),
      static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const float*>(s_ptr), s_val, M, K, inner);
  return (int)cudaGetLastError();
}
