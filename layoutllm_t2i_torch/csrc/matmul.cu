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
// at M = 16384, K = 320, N = 1280 about 300 flop per byte moved).
//
// The TPU kernels carry an f32 (bm, bn) accumulator across a sequential K
// grid axis; here each 64x64 output tile is one block that loops over K
// itself (ffn_tiles.cuh: WMMA bf16 fragments, f32 accumulators in
// registers), and the epilogue of the last K step runs in the same block.
// K8b is K6's up kernel and K8a K6's down kernel with the bias-and-residual
// epilogue in f32. Simple, not fast.
#include "ffn_tiles.cuh"

using namespace ffn_tiles;

namespace {

__global__ void __launch_bounds__(kThreads)
linear_fused_kernel(const bf16* x, const bf16* w, const bf16* b,
                    const bf16* r, bf16* out, int M, int K, int N) {
  down_tile<Epilogue::kBiasResidual, bf16>(x, w, nullptr, b, r, out, nullptr,
                                            1.f, M, N, K);
}

__global__ void __launch_bounds__(kThreads)
geglu_fused_kernel(const bf16* x, const bf16* w, const bf16* b, bf16* out,
                   int M, int K, int N) {
  geglu_up_tile<false, bf16>(x, nullptr, nullptr, w, nullptr, b, out, M, K, N,
                             0.f);
}

}  // namespace

// K8a. x: (M, K) bf16; w: (N, K) bf16 (torch layout); b: (N,) bf16 or null;
// r: (M, N) bf16 or null; out: (M, N) bf16. K % 8 == 0.
LLT2I_API int llt2i_linear(const void* x, const void* w, const void* b,
                           const void* r, void* out, int M, int K, int N,
                           void* stream) {
  if (K % 8) return (int)cudaErrorInvalidValue;
  linear_fused_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), kThreads,
                        0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<const bf16*>(r),
      static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// K8b. x: (M, K) bf16; w: (2N, K) = [Wa; Wg] bf16; b: (2N,) bf16 or null;
// out: (M, N) bf16. K % 8 == 0.
LLT2I_API int llt2i_geglu(const void* x, const void* w, const void* b,
                          void* out, int M, int K, int N, void* stream) {
  if (K % 8) return (int)cudaErrorInvalidValue;
  geglu_fused_kernel<<<dim3((N + BN - 1) / BN, (M + BM - 1) / BM), kThreads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b), static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}
