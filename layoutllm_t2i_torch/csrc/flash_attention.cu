// K1: non-causal flash-attention forward for Hopper (bf16 in, f32 softmax).
//
// Replaces the TPU kernels of layoutllm_t2i_tpu/ops/pallas/flash_attention.py
// reached from `_flash_bh` (l.244): `_attn_kernel_wholerow` (l.165),
// `_flash_kernel_fullkv` (l.117), `_flash_kernel` (l.76) and
// `_attn_kernel_wholerow_hb` (l.195). Those four are TPU VMEM-tiling variants
// of one function, out = softmax(q k^T * scale) v per (batch, head); here one
// kernel covers them all.
//
// What bounds it on the H100: operations. At the UNet's 64^2 sites
// (N = M = 4096 or 4126, d = 40) every q row meets every k row, so the work
// is 4*N*M*d flops against ~8*N*d bytes (q, k, v read once, o written once):
// ~N/2 = 2048 flop/byte, far above the card's ~295 flop/byte balance point,
// so the tensor cores are the limit.
//
// The simple design: one block owns BQ = 16*warps query rows of one
// (batch, head) and streams K/V through shared memory in BK-row tiles,
// keeping the online-softmax running max, denominator and the f32 output
// accumulator in shared memory. Each warp owns 16 query rows end to end, so
// only K/V tile loads need a block barrier. Products run on the tensor cores
// through WMMA 16x16x16 bf16 fragments with f32 accumulation:
//   * the head dim is zero-padded to DP = round_up(d, 16) inside shared
//     memory only (d = 40 -> 48), never in HBM;
//   * ragged q tails (rows >= N) are zero-filled and never written back;
//     ragged KV tails (rows >= M, e.g. M = 4126) are masked to -1e30 before
//     the softmax and zero-filled in the V tile;
//   * d = 512 (the VAE's single-head mid attention) gets its own
//     instantiation with BQ = BK = 32 so that the 32x512 f32 accumulator and
//     the Q/K/V tiles fit the 227 KB of shared memory a block may use.
// The softmax denominator is a plain f32 row sum (no ones-column trick; that
// existed for the TPU's matrix unit). Operands are read from the packed
// (B, N, H*d) projection layout through strides, so no transposed copy of
// q/k/v or of the output is made.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

template <int DP, int BQ, int BK>
struct FlashCfg {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kSmemBytes =
      (size_t)(BQ * DP + 2 * BK * DP + BQ * BK) * sizeof(bf16) +
      (size_t)(BQ * BK + BQ * DP + 2 * BQ) * sizeof(float);
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(FlashCfg<DP, BQ, BK>::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int N, int M, int D, long long q_bs, long long q_rs,
                 long long k_bs, long long k_rs, long long v_bs,
                 long long v_rs, long long o_bs, long long o_rs, float scale) {
  constexpr int NT = FlashCfg<DP, BQ, BK>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // BQ x DP
  bf16* sK = sQ + BQ * DP;                   // BK x DP
  bf16* sV = sK + BK * DP;                   // BK x DP
  bf16* sP = sV + BK * DP;                   // BQ x BK, exp'd scores
  float* sS = reinterpret_cast<float*>(sP + BQ * BK);  // BQ x BK scores
  float* sO = sS + BQ * BK;                  // BQ x DP accumulator
  float* sM = sO + BQ * DP;                  // BQ running max
  float* sL = sM + BQ;                       // BQ running denominator

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * v_bs + (long long)h * D;
  bf16* ob = o + b * o_bs + (long long)h * D;
  const int vpr = D / 8;  // 16-byte vectors per row

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < (BQ + 2 * BK) * DP; i += NT) sQ[i] = zero;
  for (int i = tid; i < BQ * DP; i += NT) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += NT) {
    sM[i] = -1e30f;
    sL[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < BQ * vpr; i += NT) {
    const int r = i / vpr, c = (i % vpr) * 8;
    if (q0 + r < N)
      *reinterpret_cast<uint4*>(sQ + r * DP + c) =
          *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_rs + c);
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fkt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * vpr; i += NT) {
      const int r = i / vpr, c = (i % vpr) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (k0 + r < M) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_rs + c);
      }
      *reinterpret_cast<uint4*>(sK + r * DP + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * DP + c) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(fa, sQ + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fkt, sK + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(fc, fa, fkt, fc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * BK + n * 16, fc, BK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, one row at a time across the warp
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      float* srow = sS + r * BK;
      float mx = -1e30f;
      for (int j = lane; j < BK; j += 32) {
        const float s = (k0 + j < M) ? srow[j] * scale : -1e30f;
        srow[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = __expf(srow[j] - m_new);
        sP[r * BK + j] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      const float alpha = __expf(m_old - m_new);
      for (int c = lane; c < DP; c += 32) sO[r * DP + c] *= alpha;
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int n = 0; n < DP / 16; ++n) {
      float* optr = sO + warp * 16 * DP + n * 16;
      wmma::load_matrix_sync(fc, optr, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(fa, sP + warp * 16 * BK + kk * 16, BK);
        wmma::load_matrix_sync(fv, sV + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(fc, fa, fv, fc);
      }
      wmma::store_matrix_sync(optr, fc, DP, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (q0 + r >= N) break;  // rows are ascending: the rest are tail too
    const float inv = 1.f / sL[r];
    bf16* orow = ob + (q0 + r) * o_rs;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(sO[r * DP + c] * inv);
  }
}

template <int DP, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int N, int M, int D, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs,
           long long o_bs, long long o_rs, float scale, cudaStream_t stream) {
  using Cfg = FlashCfg<DP, BQ, BK>;
  auto kern = flash_fwd_kernel<DP, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Cfg::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kern<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), H, N, M, D, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, N, H*D) rows of stride q_rs, batch stride q_bs (elements); k, v:
// (B, M, H*D) likewise; o: (B, N, H*D). D % 8 == 0; 16-byte aligned rows.
// Only head dims that pad to 48, 80 or 512 are instantiated; any other
// returns cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int N, int M, int D,
                              long long q_bs, long long q_rs, long long k_bs,
                              long long k_rs, long long v_bs, long long v_rs,
                              long long o_bs, long long o_rs, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
#define LLT2I_FLASH_CASE(DPV, BQV, BKV)                                     \
  case DPV:                                                                 \
    return launch<DPV, BQV, BKV>(q, k, v, o, B, H, N, M, D, q_bs, q_rs,     \
                                 k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, \
                                 s);
  switch (dp) {
    LLT2I_FLASH_CASE(48, 64, 64)    // d = 40: the 64^2 sites
    LLT2I_FLASH_CASE(80, 64, 64)    // d = 80: the 32^2 sites
    LLT2I_FLASH_CASE(512, 32, 32)   // d = 512: the VAE's mid attention
    default:                        // no site routes another head dim here
      return (int)cudaErrorInvalidValue;
  }
#undef LLT2I_FLASH_CASE
}
