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
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int N, int M, int D,
                 long long q_bs, long long q_rs,
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
    // the backward's softmax statistic, in the same scaled units as sM
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * N + q0 + r] = sM[r] + logf(sL[r]);
  }
}

template <int DP, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int N, int M, int D, long long q_bs, long long q_rs,
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
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, N, M, D,
      q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5: the backward, recomputed from the forward's lse (no N x M matrix is
// ever stored). delta = rowsum(dO * O) is one plain reduction in the wrapper,
// as the JAX package takes it in XLA outside its kernels.
//
// Replaces `_bwd_dq_kernel` (l.435) and `_bwd_dkv_kernel` (l.472) of
// layoutllm_t2i_tpu/ops/pallas/flash_attention.py. On the TPU both carry an
// f32 scratch accumulator across a sequential grid axis; here a loop inside
// the block takes that axis's place and the accumulators are WMMA fragments
// held in registers for the whole loop. Like the forward, operations bound
// them at the 64^2 sites: 10*N*M*d flops (S, dP, dQ in K5a; S, dP, dV, dK
// in K5b; S and dP are recomputed by both) against ~12*N*d bytes.
//
// The simple design again: one shared-memory stage, WMMA 16x16x16 with f32
// accumulation, each warp owning 16 rows of the block end to end, so only
// tile loads need a block barrier. The head dim is zero-padded to DP in
// shared memory only. Ragged tails: KV rows >= M load as zeros and their
// probabilities are masked to 0 (the JAX kernel's `col < kv_len`); q rows
// >= N load as zero q and dO, and their probabilities are masked to 0 as
// well, so they add nothing to dK/dV and nothing is padded in HBM; rows
// past N (K5a) or M (K5b) are never written. P and dS are rounded to bf16
// before their products, the TPU kernels' rounding points.

template <int DP, int BQ, int BK>
struct BwdDqCfg {
  static constexpr int kWarps = BQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kSmemBytes =
      (size_t)(2 * BQ * DP + 2 * BK * DP + BQ * BK) * sizeof(bf16) +
      (size_t)(2 * BQ * BK + 2 * BQ) * sizeof(float);
};

template <int DP, int BQ, int BK>
struct BwdDkvCfg {
  static constexpr int kWarps = BK / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr size_t kSmemBytes =
      (size_t)(2 * BK * DP + 2 * BQ * DP + 2 * BK * BQ) * sizeof(bf16) +
      (size_t)(2 * BK * BQ + 2 * BQ) * sizeof(float);
};

// rows [r0, r0 + rows) of a (rows, D) operand into a (rows, DP) tile; rows
// at or past `limit` stay as they are (zero-filled by the caller)
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long rs, int r0, int rows,
                                          int limit, int D, int tid, int nt) {
  const int vpr = D / 8;
  for (int i = tid; i < rows * vpr; i += nt) {
    const int r = i / vpr, c = (i % vpr) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * DP + c) = val;
  }
}

// write a warp's 16 x DP f32 accumulator (times `mul`) as bf16 rows
// [row0, row0 + 16) of a contiguous (rows, H*D) output, through `stage`
// (16 x 16 floats of the warp's own shared memory)
template <int DP>
__device__ __forceinline__ void store_acc(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[DP / 16],
    float* stage, bf16* out, long long rs, int row0, int limit, int D,
    float mul, int lane) {
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
    wmma::store_matrix_sync(stage, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int rr = i / 16, c = n * 16 + i % 16;
      if (row0 + rr < limit && c < D)
        out[(long long)(row0 + rr) * rs + c] = __float2bfloat16(stage[i] * mul);
    }
    __syncwarp();
  }
}

// K5a: one block per (q tile, batch*head) streams K/V tiles and accumulates
// dQ = scale * sum_k [P o (dO V^T - delta)] K.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BwdDqCfg<DP, BQ, BK>::kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int N, int M, int D, long long q_bs, long long q_rs,
                    long long k_bs, long long k_rs, long long v_bs,
                    long long v_rs, float scale) {
  constexpr int NT = BwdDqCfg<DP, BQ, BK>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // BQ x DP
  bf16* sDO = sQ + BQ * DP;                  // BQ x DP
  bf16* sK = sDO + BQ * DP;                  // BK x DP
  bf16* sV = sK + BK * DP;                   // BK x DP
  bf16* sDS = sV + BK * DP;                  // BQ x BK, bf16 dS
  float* sS = reinterpret_cast<float*>(sDS + BQ * BK);  // BQ x BK scores
  float* sDP = sS + BQ * BK;                 // BQ x BK, dO V^T
  float* sLse = sDP + BQ * BK;               // BQ
  float* sDelta = sLse + BQ;                 // BQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long long hd = (long long)H * D;  // row stride of dO and dQ
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * v_bs + (long long)h * D;
  const bf16* dob = dout + b * N * hd + (long long)h * D;

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < (2 * BQ + 2 * BK) * DP; i += NT) sQ[i] = zero;
  __syncthreads();
  load_rows<DP>(sQ, qb, q_rs, q0, BQ, N, D, tid, NT);
  load_rows<DP>(sDO, dob, hd, q0, BQ, N, D, tid, NT);
  for (int i = tid; i < BQ; i += NT) {
    const bool in = q0 + i < N;
    sLse[i] = in ? lse[(long long)bh * N + q0 + i] : 0.f;
    sDelta[i] = in ? delta[(long long)bh * N + q0 + i] : 0.f;
  }

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<DP>(sK, kb, k_rs, k0, BK, M, D, tid, NT);
    load_rows<DP>(sV, vb, v_rs, k0, BK, M, D, tid, NT);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(fa, sQ + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fbt, sK + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(fc, fa, fbt, fc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * BK + n * 16, fc, BK,
                              wmma::mem_row_major);
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(fa, sDO + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fbt, sV + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(fc, fa, fbt, fc);
      }
      wmma::store_matrix_sync(sDP + warp * 16 * BK + n * 16, fc, BK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P o (dP - delta), P = exp(S * scale - lse), masked past M
    for (int i = lane; i < 16 * BK; i += 32) {
      const int r = warp * 16 + i / BK, j = i % BK;
      const float p = (k0 + j < M)
                          ? __expf(sS[r * BK + j] * scale - sLse[r]) : 0.f;
      sDS[r * BK + j] = __float2bfloat16(p * (sDP[r * BK + j] - sDelta[r]));
    }
    __syncwarp();

    // dQ += dS K
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::load_matrix_sync(fa, sDS + warp * 16 * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, sK + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  __syncwarp();
  bf16* dqb = dq + b * N * hd + (long long)h * D;
  store_acc<DP>(acc, sS + warp * 16 * BK, dqb, hd, q0 + warp * 16, N, D,
                scale, lane);
}

// K5b: one block per (k tile, batch*head) streams q/dO tiles and
// accumulates dV = P^T dO and dK = scale * [P o (dP - delta)]^T Q. The
// scores are computed transposed (S^T = K Q^T), so each warp's 16 k rows
// are the rows of its products.
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(BwdDkvCfg<DP, BQ, BK>::kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int N, int M, int D,
                     long long q_bs, long long q_rs, long long k_bs,
                     long long k_rs, long long v_bs, long long v_rs,
                     float scale) {
  constexpr int NT = BwdDkvCfg<DP, BQ, BK>::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);  // BK x DP
  bf16* sV = sK + BK * DP;                   // BK x DP
  bf16* sQ = sV + BK * DP;                   // BQ x DP
  bf16* sDO = sQ + BQ * DP;                  // BQ x DP
  bf16* sP = sDO + BQ * DP;                  // BK x BQ, bf16 P^T
  bf16* sDS = sP + BK * BQ;                  // BK x BQ, bf16 dS^T
  float* sS = reinterpret_cast<float*>(sDS + BK * BQ);  // BK x BQ, S^T
  float* sDP = sS + BK * BQ;                 // BK x BQ, dP^T
  float* sLse = sDP + BK * BQ;               // BQ
  float* sDelta = sLse + BQ;                 // BQ

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const long long hd = (long long)H * D;
  const bf16* qb = q + b * q_bs + (long long)h * D;
  const bf16* kb = k + b * k_bs + (long long)h * D;
  const bf16* vb = v + b * v_bs + (long long)h * D;
  const bf16* dob = dout + b * N * hd + (long long)h * D;

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < (2 * BK + 2 * BQ) * DP; i += NT) sK[i] = zero;
  __syncthreads();
  load_rows<DP>(sK, kb, k_rs, k0, BK, M, D, tid, NT);
  load_rows<DP>(sV, vb, v_rs, k0, BK, M, D, tid, NT);

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fbt;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[DP / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_v[DP / 16];
#pragma unroll
  for (int n = 0; n < DP / 16; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();  // every warp is done with the previous q/dO tile
    load_rows<DP>(sQ, qb, q_rs, q0, BQ, N, D, tid, NT);
    load_rows<DP>(sDO, dob, hd, q0, BQ, N, D, tid, NT);
    for (int i = tid; i < BQ; i += NT) {
      const bool in = q0 + i < N;
      sLse[i] = in ? lse[(long long)bh * N + q0 + i] : 0.f;
      sDelta[i] = in ? delta[(long long)bh * N + q0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 k rows
    for (int n = 0; n < BQ / 16; ++n) {
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(fa, sK + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fbt, sQ + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(fc, fa, fbt, fc);
      }
      wmma::store_matrix_sync(sS + warp * 16 * BQ + n * 16, fc, BQ,
                              wmma::mem_row_major);
      wmma::fill_fragment(fc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::load_matrix_sync(fa, sV + warp * 16 * DP + kk * 16, DP);
        wmma::load_matrix_sync(fbt, sDO + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(fc, fa, fbt, fc);
      }
      wmma::store_matrix_sync(sDP + warp * 16 * BQ + n * 16, fc, BQ,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // P^T and dS^T; q columns past N are masked to 0
    for (int i = lane; i < 16 * BQ; i += 32) {
      const int r = warp * 16 + i / BQ, j = i % BQ;
      const float p = (q0 + j < N)
                          ? __expf(sS[r * BQ + j] * scale - sLse[j]) : 0.f;
      sP[r * BQ + j] = __float2bfloat16(p);
      sDS[r * BQ + j] = __float2bfloat16(p * (sDP[r * BQ + j] - sDelta[j]));
    }
    __syncwarp();

    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wmma::load_matrix_sync(fa, sP + warp * 16 * BQ + kk * 16, BQ);
        wmma::load_matrix_sync(fb, sDO + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(acc_v[n], fa, fb, acc_v[n]);
        wmma::load_matrix_sync(fa, sDS + warp * 16 * BQ + kk * 16, BQ);
        wmma::load_matrix_sync(fb, sQ + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(acc_k[n], fa, fb, acc_k[n]);
      }
    }
  }

  __syncwarp();
  float* stage = sS + warp * 16 * BQ;
  const int row0 = k0 + warp * 16;
  store_acc<DP>(acc_v, stage, dv + b * M * hd + (long long)h * D, hd, row0,
                M, D, 1.f, lane);
  store_acc<DP>(acc_k, stage, dk + b * M * hd + (long long)h * D, hd, row0,
                M, D, scale, lane);
}

template <typename Kern>
int prepare(Kern kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, int BQ, int BK>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int N, int M, int D, long long q_bs,
               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
               long long v_rs, float scale, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  if (dq != nullptr) {
    using Cfg = BwdDqCfg<DP, BQ, BK>;
    auto kern = flash_bwd_dq_kernel<DP, BQ, BK>;
    int err = prepare(kern, Cfg::kSmemBytes);
    if (err != 0) return err;
    dim3 grid((N + BQ - 1) / BQ, B * H);
    kern<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dq), H, N, M, D,
        q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale);
  } else {
    using Cfg = BwdDkvCfg<DP, BQ, BK>;
    auto kern = flash_bwd_dkv_kernel<DP, BQ, BK>;
    int err = prepare(kern, Cfg::kSmemBytes);
    if (err != 0) return err;
    dim3 grid((M + BK - 1) / BK, B * H);
    kern<<<grid, Cfg::kThreads, Cfg::kSmemBytes, stream>>>(
        qp, kp, vp, dop, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, N, M, D, q_bs, q_rs, k_bs, k_rs, v_bs,
        v_rs, scale);
  }
  return (int)cudaGetLastError();
}

int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int N, int M, int D, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
    case 48:  // d = 40: the 64^2 sites
      return launch_bwd<48, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                    H, N, M, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    case 80:  // d = 80: the 32^2 sites
      return launch_bwd<80, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                    H, N, M, D, q_bs, q_rs, k_bs, k_rs, v_bs,
                                    v_rs, scale, s);
    default:  // the training path routes no other head dim here
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K5a. q, k, v as for llt2i_flash_fwd; dout and dq contiguous (B, N, H*D);
// lse and delta contiguous f32 (B, H, N). Only d = 40 and 80 are
// instantiated; any other returns cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, void* dq, int B, int H,
                                 int N, int M, int D, long long q_bs,
                                 long long q_rs, long long k_bs,
                                 long long k_rs, long long v_bs,
                                 long long v_rs, float scale, void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return flash_bwd(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, N,
                   M, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, stream);
}

// K5b. As K5a; dk and dv contiguous (B, M, H*D).
LLT2I_API int llt2i_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, void* dk, void* dv,
                                  int B, int H, int N, int M, int D,
                                  long long q_bs, long long q_rs,
                                  long long k_bs, long long k_rs,
                                  long long v_bs, long long v_rs, float scale,
                                  void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return flash_bwd(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, N, M, D,
                   q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, stream);
}

// q: (B, N, H*D) rows of stride q_rs, batch stride q_bs (elements); k, v:
// (B, M, H*D) likewise; o: (B, N, H*D). D % 8 == 0; 16-byte aligned rows.
// lse: null, or a contiguous f32 (B, H, N) buffer that receives the row
// log-sum-exp of the scaled scores (the backward's saved statistic).
// Only head dims that pad to 48, 80 or 512 are instantiated; any other
// returns cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int N,
                              int M, int D,
                              long long q_bs, long long q_rs, long long k_bs,
                              long long k_rs, long long v_bs, long long v_rs,
                              long long o_bs, long long o_rs, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dp = (D + 15) / 16 * 16;
#define LLT2I_FLASH_CASE(DPV, BQV, BKV)                                     \
  case DPV:                                                                 \
    return launch<DPV, BQV, BKV>(q, k, v, o, lse, B, H, N, M, D, q_bs,      \
                                 q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs,  \
                                 scale, s);
  switch (dp) {
    LLT2I_FLASH_CASE(48, 64, 64)    // d = 40: the 64^2 sites
    LLT2I_FLASH_CASE(80, 64, 64)    // d = 80: the 32^2 sites
    LLT2I_FLASH_CASE(512, 32, 32)   // d = 512: the VAE's mid attention
    default:                        // no site routes another head dim here
      return (int)cudaErrorInvalidValue;
  }
#undef LLT2I_FLASH_CASE
}
