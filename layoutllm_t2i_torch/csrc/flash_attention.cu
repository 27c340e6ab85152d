// K1: non-causal flash-attention forward for Hopper (bf16 in, f32 softmax).
//
// Replaces the TPU kernels of layoutllm_t2i_tpu/ops/pallas/flash_attention.py
// reached from `_flash_bh` (l.244): `_attn_kernel_wholerow` (l.165),
// `_flash_kernel_fullkv` (l.117), `_flash_kernel` (l.76) and
// `_attn_kernel_wholerow_hb` (l.195). Those four are TPU VMEM-tiling variants
// of one function, out = softmax(q k^T * scale) v per (batch, head), with
// the row log-sum-exp (natural log, f32) when asked; here one kernel with
// one instantiation per head dim covers them all.
//
// What bounds it on the H100. At d = 80 and 512, operations: every q row
// meets every k row, 4*N*M*d flops against ~8*N*d bytes, thousands of flops
// a byte. At d = 40 (the UNet's 64^2 sites), the exponentials: one per
// score, B*H*N*M of them on 16 SFU lanes a clock per SM, about 0.13 ms at
// the generation's shape against 0.087 ms of tensor-core work. So the
// design keeps the tensor cores fed and spends as few instructions per
// score as it can besides the exp.
//
// Design: one block per (BQ query rows, batch, head), nine warps.
//  * Warp 8 is the producer: one thread loads the Q tile once and then
//    K and V tiles into a ring of kStages shared-memory stages with TMA.
//    Each stage has a "full" mbarrier (TMA transaction bytes) and an
//    "empty" one (one arrival per consumer warp); the producer refills a
//    stage as soon as all eight consumer warps release it, so every load
//    the ring has room for is in flight while the consumers compute.
//  * Operands are read from the packed (B, N, H*d) projection layout
//    through 4-d tensor maps (d, H, rows, B) with the caller's strides,
//    built on the host per launch (cuTensorMapEncodeTiled, looked up with
//    cudaGetDriverEntryPoint). Boxes are 64 columns (128 bytes)
//    wide in the 128-byte swizzle that wgmma reads without bank conflicts.
//    Columns past d (d = 40: 40..63, d = 80: 80..127) and rows past N or M
//    lie outside the map, so TMA writes zeros there: no other head's
//    columns and nothing past a row is ever read, and the zero columns of
//    Q and K make the padded depth (48 at d = 40) add nothing to S.
//  * Warps 0-7 are two consumer warpgroups. S = Q K^T: wgmma.mma_async
//    m64nBKk16, Q and K from shared memory (K-major), S in registers.
//  * The online softmax runs in registers: each accumulator row lies in
//    one quad of lanes, so row max and row sum need two xor-shuffles. The
//    max is taken over the raw scores (scale > 0) and p = exp2(s*c - m*c),
//    c = scale*log2(e): one FMA and one ex2 a score. Columns past M (the
//    ragged KV tail: a zero-filled K row would score 0, not -inf) are set
//    to -inf before the max. Row sums stay per thread until the end.
//  * O += P V: P is rounded to bf16 in registers -- a 16-column slice of
//    the S fragment is already wgmma's register-A fragment -- and V comes
//    from shared memory, MN-major (the descriptor reads it transposed).
//    O stays in registers for the whole K/V loop and is rescaled there.
//    Neither S, P nor O is ever stored to shared memory.
//  * d = 40 and 80: BQ = 128, each consumer warpgroup owns 64 rows (one
//    whose rows all lie past N leaves at once); K/V tiles of 64 rows in 4
//    stages at d = 40 (the fastest of the tilings tried on the card), 128
//    rows in 2 stages at d = 80; grid B*H*ceil(N/128) (1,024 blocks at the
//    generation's d = 40 shape). d = 512 (the VAE's single head): a 64 x
//    512 f32 accumulator does not fit one warpgroup's registers, so both
//    warpgroups take the same 64 rows, each owns 256 output columns and
//    computes the 64 x 32 S tile itself. S is computed twice, nothing is
//    exchanged between the warpgroups, and the grid keeps B*N/64 blocks
//    (128 at the decode's B = 2). 32 K/V rows a stage, so two stages
//    (64 KB each) fit beside Q (64 KB).
//  * Epilogue: O / l in bf16 straight from registers to global memory; q
//    rows >= N and columns >= d are never written. lse = m*scale + ln(l).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// kDepth: wgmma depth (d padded to 16); kChunks: 64-column chunks per row
// in shared memory; kBQ: q rows a block loads; kBK: K/V rows a stage;
// kON: output columns a consumer warpgroup owns; kSplitCols: both
// warpgroups share the rows and split the columns (else they split the
// rows, 64 each, and own all kON columns).
template <int kDepth_, int kChunks_, int kBQ_, int kBK_, int kStages_,
          int kON_, bool kSplitCols_>
struct FwdCfg {
  static constexpr int kDepth = kDepth_, kChunks = kChunks_, kBQ = kBQ_,
                       kBK = kBK_, kStages = kStages_, kON = kON_;
  static constexpr bool kSplitCols = kSplitCols_;
  static constexpr int kThreads = 9 * 32;  // two consumer warpgroups + producer
  static constexpr uint32_t kQBytes = kChunks * kBQ * 128;
  static constexpr uint32_t kKVBytes = kChunks * kBK * 128;  // one K or V stage
  // 1024 bytes of slack to align the swizzled tiles, then the mbarriers
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
  static_assert(kBQ == (kSplitCols ? 64 : 128), "64 rows a warpgroup");
  static_assert(kDepth % 16 == 0 && kDepth <= 64 * kChunks, "depth");
  static_assert(kON % 8 == 0 && kON <= 256 && kBK % 16 == 0, "wgmma shape");
};

using Fwd40 = FwdCfg<48, 1, 128, 64, 4, 48, false>;    // 64^2 sites
using Fwd80 = FwdCfg<80, 2, 128, 128, 2, 80, false>;   // 32^2 sites
using Fwd512 = FwdCfg<512, 8, 64, 32, 2, 256, true>;   // the VAE's head

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 bf16* __restrict__ o, float* __restrict__ lse, int H, int N,
                 int M, int D, long long o_bs, long long o_rs, float scale,
                 float c) {
  constexpr int S = C::kStages, BK = C::kBK, ON = C::kON;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::kQBytes;             // stage s at + s * kKVBytes
  const uint32_t sV = sK + S * C::kKVBytes;
  const uint32_t full = sV + S * C::kKVBytes;      // mbarrier of stage s at + 8s
  const uint32_t empty = full + 8 * S;
  const uint32_t qbar = empty + 8 * S;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * C::kBQ;
  const int tiles = (M + BK - 1) / BK;
  // a consumer warpgroup whose 64 rows all lie past N has nothing to do
  // (the second one of a ragged last q tile): it leaves at once, and the
  // stages wait for the other one's four warps alone
  const int busy_groups = (C::kSplitCols || q0 + 64 < N) ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * busy_groups);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int ch = 0; ch < C::kChunks; ++ch)
        tma_load_4d(sQ + ch * C::kBQ * 128, &tq, qbar, ch * 64, h, q0, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8 * s, ((t / S) - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * C::kKVBytes);
        const uint32_t ks = sK + s * C::kKVBytes, vs = sV + s * C::kKVBytes;
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_4d(ks + ch * BK * 128, &tk, full + 8 * s, ch * 64, h,
                      t * BK, b);
          tma_load_4d(vs + ch * BK * 128, &tv, full + 8 * s, ch * 64, h,
                      t * BK, b);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g, its warp wq owns rows 16 wq .. 16 wq + 15
  const int g = warp >> 2;
  const int wq = warp & 3;
  if (g >= busy_groups) return;
  const int row_off = C::kSplitCols ? 0 : 64 * g;
  const int col_off = C::kSplitCols ? ON * g : 0;
  const uint32_t sQg = sQ + row_off * 128;
  float acc[ON / 2];
#pragma unroll
  for (int i = 0; i < ON / 2; ++i) acc[i] = 0.f;
  // running max of the raw scores and per-thread partial row sums, for
  // this thread's rows r and r + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % S;
    mbar_wait(full + 8 * s, (t / S) & 1);
    __syncwarp();  // converged again for the warpgroup-wide wgmma
    const uint32_t ks = sK + s * C::kKVBytes, vs = sV + s * C::kKVBytes;

    // S = Q K^T
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kDepth / 16; ++kk) {
      const uint32_t a = sQg + (kk / 4) * C::kBQ * 128 + (kk % 4) * 32;
      const uint32_t bk = ks + (kk / 4) * BK * 128 + (kk % 4) * 32;
      wgmma_ss(sc, sw128_desc(a, 16), sw128_desc(bk, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // the ragged KV tail scores -inf
    const int k0 = t * BK;
    if (k0 + BK > M) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        if (col >= M) sc[i] = -INFINITY;
      }
    }

    // online softmax: row max over the quad, p = exp2(s c - m c)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_run[r] - mx[r]) * c);
      m_run[r] = mx[r];
      mc[r] = mx[r] * c;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], c, -mc[r]));
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int i = 0; i < ON / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P as bf16 register fragments
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t bv = vs + (col_off / 64) * BK * 128 + kk * 16 * 128;
      wgmma_rs(acc, pa[kk], sw128_desc(bv, BK * 128));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
  }

  // epilogue: O / l, lse = m scale + ln l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const long long hd = (long long)h * D + col_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row_off + 16 * wq + (lane >> 2) + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = o + b * o_bs + row * o_rs + hd;
#pragma unroll
    for (int j = 0; j < ON / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col_off + col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    }
    if (lse != nullptr && (lane & 3) == 0 && (!C::kSplitCols || g == 0))
      lse[(long long)bh * N + row] = m_run[r] * scale + logf(l_run[r]);
  }
}

// A (d, H, rows, B) map of a packed (B, rows, H*d) bf16 operand with row
// stride rs and batch stride bs (elements); boxes of 64 columns of one head
// by box_rows rows, 128-byte swizzle, zeros outside.
int tensor_map(CUtensorMap* map, const void* base, int D, int H, int rows,
               int B, long long rs, long long bs, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)rs * 2,
                                 (cuuint64_t)bs * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(base), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int N, int M, int D, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs,
           long long o_bs, long long o_rs, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, D, H, N, B, q_rs, q_bs, C::kBQ);
  if (err == 0) err = tensor_map(&tk, k, D, H, M, B, k_rs, k_bs, C::kBK);
  if (err == 0) err = tensor_map(&tv, v, D, H, M, B, v_rs, v_bs, C::kBK);
  if (err != 0) return err;
  static unsigned long long smem_set = 0;
  auto kern = flash_fwd_kernel<C>;
  err = allow_smem(kern, C::kSmemBytes, smem_set);
  if (err != 0) return err;
  dim3 grid((N + C::kBQ - 1) / C::kBQ, B * H);
  kern<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, H, N, M, D, o_bs, o_rs, scale,
      scale * 1.4426950408889634f);
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
// the block takes that axis's place and the accumulators stay in registers
// for the whole loop. Two kernels, as the JAX package splits them: K5a
// writes dQ, K5b dK and dV, each output row by one block, so no atomics and
// the result is bitwise repeatable.
//
// What bounds them on the H100: operations, 6*N*M*d flops in K5a (S, dP,
// dQ) and 8*N*M*d in K5b (S, dP, dV, dK) against ~12*N*d bytes; at d = 40
// as much again in exponentials (one a score in each kernel, B*H*N*M on 16
// SFU lanes a clock per SM). So the design is K1's: the tensor cores fed by
// a TMA ring, and as few instructions per score as possible besides the exp.
//
// Design: one block per (64 resident rows a consumer warpgroup, batch,
// head): two or three consumer warpgroups and a producer warpgroup.
//  * The last warpgroup is the producer: it hands its registers back
//    (setmaxnreg) and one thread loads the resident operands once and the
//    streamed tiles into a ring of kStages stages with TMA (mbarriers
//    "full" and "empty" as in K1), from 4-d tensor maps (d, H, rows, B)
//    with the caller's strides. Columns past d and rows past N or M come
//    in as zeros; no other head's columns and nothing past a row is read.
//  * The consumer warpgroups own 64 resident rows each, with 160 registers
//    a thread (three of them) or 232 (two). Both products of the scores
//    are SS wgmma with K-major operands; the score fragments stay in
//    registers, each
//    16-column slice of them is the register A fragment of the next wgmma
//    (RS, B MN-major), so S, P, dP and dS never touch shared memory.
//  * P = exp2(S c - lse log2 e), c = scale log2(e): one FMA and one ex2 a
//    score, on the natural-log lse that K1 writes. dS = P (dP - delta). P
//    and dS are rounded to bf16 before their products, the TPU kernels'
//    rounding points.
//  * Within a warpgroup a tile runs in order: the two score products, the
//    exponentials, the output products, then the stage is released; the
//    consumer warpgroups overlap one another. (Leaving the output products
//    in flight across the next tile's score products made ptxas serialise
//    every wgmma (C7515) and was slower on the card.)
//  * K5a: a block keeps Q and dO resident (192 q rows) and streams K/V
//    tiles; each thread holds the lse and delta of the two rows its
//    fragment owns. S = Q K^T, dP = dO V^T, dQ += dS K. K rows past M
//    load as zeros and would score 0, so P is masked to 0 past M.
//  * K5b: a block keeps K and V resident (192 k rows at d = 40, 128 at
//    d = 80) and streams Q/dO tiles. It computes S^T = K Q^T and
//    dP^T = V dO^T, so P^T and dS^T
//    come out in the A layout of dV += P^T dO and dK += dS^T Q. The q rows
//    lie along the fragment's columns, so the producer warp writes each
//    stage's lse (times log2 e) and delta to shared memory beside the tile
//    and each thread reads the columns it owns. P^T is masked to 0 past N.
//  * Epilogue: bf16 straight from registers; only rows < N (K5a) or < M
//    (K5b) and columns < d are written (d = 40's 48-column tile would
//    otherwise overwrite the next head's first 8 columns).

// kDepth: wgmma depth of the scores (d padded to 16), also the width of the
// dQ, dK and dV accumulators; kChunks: 64-column chunks per row in shared
// memory; kGroups: consumer warpgroups, each owning 64 of the block's kBR
// resident rows; kBS: rows of a streamed stage; kStages: the ring's depth;
// kRowStats: each stage carries its rows' lse and delta (K5b only).
template <int kDepth_, int kChunks_, int kGroups_, int kBS_, int kStages_,
          bool kRowStats>
struct BwdCfg {
  static constexpr int kDepth = kDepth_, kChunks = kChunks_,
                       kGroups = kGroups_, kBR = 64 * kGroups, kBS = kBS_,
                       kStages = kStages_;
  static constexpr int kThreads = 128 * (kGroups + 1);  // + the producer's
  // the producer warpgroup's registers go to the consumers: 232 each with
  // two consumer warpgroups, 160 with three
  static constexpr int kProducerRegs = kGroups == 2 ? 40 : 24;
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / (128 * kGroups) / 8 * 8;
  static constexpr uint32_t kResBytes = kChunks * kBR * 128;   // one resident operand
  static constexpr uint32_t kTileBytes = kChunks * kBS * 128;  // one streamed operand
  static constexpr uint32_t kStatBytes = kRowStats ? 2 * kBS * 4 : 0;  // lse log2 e, delta
  // 1024 bytes of slack to align the swizzled tiles, then the mbarriers
  static constexpr size_t kSmemBytes = 1024 + 2 * kResBytes +
                                       kStages * (2 * kTileBytes + kStatBytes) +
                                       8 * (2 * kStages + 1);
  static_assert(kDepth % 16 == 0 && kDepth <= 64 * kChunks, "depth");
  static_assert(kBS % 16 == 0 && kBS <= 128, "stage rows");
  static_assert(kBR <= 256 && kConsumerRegs <= 256, "TMA box, registers");
};

// K5a (Dq) and K5b (Dkv) at the 64^2 sites (d = 40) and the 32^2 sites.
// Three consumer warpgroups were faster than two on the card (and 64-row
// stages than 128 with two); K5b at d = 80 keeps two, for the 232
// registers its two 64 x 80 accumulators and four score fragments need.
using Dq40 = BwdCfg<48, 1, 3, 64, 4, false>;
using Dkv40 = BwdCfg<48, 1, 3, 64, 4, true>;
using Dq80 = BwdCfg<80, 2, 3, 64, 3, false>;
using Dkv80 = BwdCfg<80, 2, 2, 64, 3, true>;

constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout of both kernels: two resident operands, two streamed
// ones in kStages stages, K5b's per-stage row statistics (none in K5a), the
// mbarriers
template <class C>
struct BwdSmem {
  uint32_t res0, res1, tile0, tile1, full, empty, rbar;
  float* stats;
  __device__ explicit BwdSmem(unsigned char* raw) {
    const uint32_t base = smem_u32(raw);
    res0 = (base + 1023u) & ~1023u;
    res1 = res0 + C::kResBytes;
    tile0 = res1 + C::kResBytes;  // stage s at + s * kTileBytes
    tile1 = tile0 + C::kStages * C::kTileBytes;
    const uint32_t st = tile1 + C::kStages * C::kTileBytes;
    stats = reinterpret_cast<float*>(raw + (st - base));
    full = st + C::kStages * C::kStatBytes;  // mbarrier of stage s at + 8s
    empty = full + 8 * C::kStages;
    rbar = empty + 8 * C::kStages;
  }
};

// S (+)= A B^T over the padded depth: A the 64 rows of this warpgroup at
// `a` in a resident operand of kBR rows, B a stage of kBS rows at `b`
template <class C, int N>
__device__ __forceinline__ void scores(float (&s)[N], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < C::kDepth / 16; ++kk)
    wgmma_ss(s, sw128_desc(a + (kk / 4) * C::kBR * 128 + (kk % 4) * 32, 16),
             sw128_desc(b + (kk / 4) * C::kBS * 128 + (kk % 4) * 32, 16),
             kk > 0);
}

// D += A B: A in registers (16 columns of k a slice), B the kBS-row stage
// at `b` read MN-major
template <class C, int N, int K>
__device__ __forceinline__ void product(float (&d)[N], const uint32_t (&a)[K][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    wgmma_rs(d, a[kk], sw128_desc(b + kk * 16 * 128, C::kBS * 128));
}

// the register A fragments of a score fragment, two bf16 a register
template <int N, int K>
__device__ __forceinline__ void to_bf16(uint32_t (&a)[K][4], const float (&s)[N]) {
  static_assert(N == 8 * K, "one A slice per 16 columns");
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
}

// this thread's rows row0 and row0 + 8 of a warpgroup's 64 x kDepth
// accumulator (times mul) as bf16 into a contiguous (rows, H*D) output:
// only rows < limit and columns < D
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N], bf16* out,
                                           long long hd, int row0, int limit,
                                           int D, float mul, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    bf16* orow = out + row * hd;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
}

// K5a's dS = P o (dP - delta) in place of S, P = exp2(S c - lse log2 e):
// the thread's rows r (i / 2 even) and r + 8 carry l2 and dl; with kMask,
// P = 0 in the columns at or past `lim`
template <bool kMask, int N>
__device__ __forceinline__ void ds_rows(float (&sc)[N], const float (&dp)[N],
                                        const float (&l2)[2],
                                        const float (&dl)[2], float c, int lim,
                                        int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], c, -l2[r]));
    if (kMask && 8 * (i / 4) + 2 * (lane & 3) + (i & 1) >= lim) p = 0.f;
    sc[i] = p * (dp[i] - dl[r]);
  }
}

// K5b's P^T in place of S^T and dS^T in place of dP^T: the thread's q
// columns 8 j + 2 (lane % 4) + {0, 1} read their lse log2 e and delta from
// the stage's statistics `st` (2N of each); with kMask, P^T = 0 in the
// columns at or past `lim`
template <bool kMask, int N>
__device__ __forceinline__ void p_ds_cols(float (&sc)[N], float (&dp)[N],
                                          const float* st, float c, int lim,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(st + col);
    const float2 dl = *reinterpret_cast<const float2*>(st + 2 * N + col);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = 4 * j + v;
      const bool odd = v & 1;
      float p = ex2(fmaf(sc[i], c, -(odd ? l2.y : l2.x)));
      if (kMask && col + odd >= lim) p = 0.f;
      sc[i] = p;
      dp[i] = p * (dp[i] - (odd ? dl.y : dl.x));
    }
  }
}

// K5a: dQ = scale * sum over K/V tiles of [P o (dO V^T - delta)] K
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    int H, int N, int M, int D, float scale, float c) {
  constexpr int S = C::kStages, BK = C::kBS, BQ = C::kBR;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<C> sm(smem_raw);
  const uint32_t sQ = sm.res0, sDO = sm.res1, sK = sm.tile0, sV = sm.tile1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (M + BK - 1) / BK;
  // the last consumer warpgroups of a ragged last q tile may own no row
  const int busy_groups = min(C::kGroups, (N - q0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(sm.full + 8 * s, 1);
      mbar_init(sm.empty + 8 * s, 4 * busy_groups);  // one arrival a consumer warp
    }
    mbar_init(sm.rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 4 * C::kGroups && lane == 0) {
      mbar_expect_tx(sm.rbar, 2 * C::kResBytes);
      for (int ch = 0; ch < C::kChunks; ++ch) {
        tma_load_4d(sQ + ch * BQ * 128, &tq, sm.rbar, ch * 64, h, q0, b);
        tma_load_4d(sDO + ch * BQ * 128, &tdo, sm.rbar, ch * 64, h, q0, b);
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(sm.empty + 8 * s, ((t / S) - 1) & 1);
        mbar_expect_tx(sm.full + 8 * s, 2 * C::kTileBytes);
        const uint32_t ks = sK + s * C::kTileBytes, vs = sV + s * C::kTileBytes;
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_4d(ks + ch * BK * 128, &tk, sm.full + 8 * s, ch * 64, h,
                      t * BK, b);
          tma_load_4d(vs + ch * BK * 128, &tv, sm.full + 8 * s, ch * 64, h,
                      t * BK, b);
        }
      }
    }
  } else {  // the consumers: warpgroup g, its warp wq owns rows 16 wq .. + 15
    setmaxnreg_inc<C::kConsumerRegs>();
    const int g = warp >> 2;
    const int wq = warp & 3;
    if (g >= busy_groups) return;
    const uint32_t sQg = sQ + 64 * g * 128, sDOg = sDO + 64 * g * 128;
    // this thread's rows: row0 and row0 + 8; their lse (times log2 e) and
    // delta, zero past N (those rows are zero in Q and dO, never written)
    const int row0 = q0 + 64 * g + 16 * wq + (lane >> 2);
    float l2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row0 + 8 * r < N;
      const long long i = (long long)bh * N + row0 + 8 * r;
      l2[r] = in ? lse[i] * kLog2e : 0.f;
      dl[r] = in ? delta[i] : 0.f;
    }
    float acc[C::kDepth / 2];
#pragma unroll
    for (int i = 0; i < C::kDepth / 2; ++i) acc[i] = 0.f;
    mbar_wait(sm.rbar, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      mbar_wait(sm.full + 8 * s, (t / S) & 1);
      __syncwarp();  // converged again for the warpgroup-wide wgmma
      const uint32_t ks = sK + s * C::kTileBytes, vs = sV + s * C::kTileBytes;

      // S = Q K^T, dP = dO V^T
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
      scores<C>(sc, sQg, ks);
      scores<C>(dp, sDOg, vs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp2(S c - lse log2 e), 0 past M; dS = P (dP - delta)
      const int k0 = t * BK;
      if (k0 + BK > M)
        ds_rows<true>(sc, dp, l2, dl, c, M - k0, lane);
      else
        ds_rows<false>(sc, dp, l2, dl, c, BK, lane);

      // dQ += dS K
      uint32_t dsa[BK / 16][4];
      to_bf16(dsa, sc);
      wgmma_fence();
      product<C>(acc, dsa, ks);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * s);
    }

    const long long hd = (long long)H * D;  // row stride of dQ
    store_rows(acc, dq + (long long)b * N * hd + (long long)h * D, hd, row0,
               N, D, scale, lane);
  }
}

// K5b: dV = sum over q/dO tiles of P^T dO and dK = scale * sum of
// [P o (dO V^T - delta)]^T Q, from S^T = K Q^T and dP^T = V dO^T
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int N, int M, int D,
                     float scale, float c) {
  constexpr int S = C::kStages, BQ = C::kBS, BK = C::kBR;
  extern __shared__ unsigned char smem_raw[];
  const BwdSmem<C> sm(smem_raw);
  const uint32_t sK = sm.res0, sV = sm.res1, sQ = sm.tile0, sDO = sm.tile1;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tiles = (N + BQ - 1) / BQ;
  const int busy_groups = min(C::kGroups, (M - k0 + 63) / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer warp's 32 lanes arrive, each after its statistics
      mbar_init(sm.full + 8 * s, 32);
      mbar_init(sm.empty + 8 * s, 4 * busy_groups);
    }
    mbar_init(sm.rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::kGroups) {  // the producer warpgroup: its first warp
    setmaxnreg_dec<C::kProducerRegs>();  // loads, the rest leave
    if (warp == 4 * C::kGroups) {
      if (lane == 0) {
        mbar_expect_tx(sm.rbar, 2 * C::kResBytes);
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_4d(sK + ch * BK * 128, &tk, sm.rbar, ch * 64, h, k0, b);
          tma_load_4d(sV + ch * BK * 128, &tv, sm.rbar, ch * 64, h, k0, b);
        }
      }
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(sm.empty + 8 * s, ((t / S) - 1) & 1);
        // the stage's lse (times log2 e) and delta, zero past N
        float* st = sm.stats + s * 2 * BQ;
        for (int i = lane; i < BQ; i += 32) {
          const int q = t * BQ + i;
          const bool in = q < N;
          st[i] = in ? lse[(long long)bh * N + q] * kLog2e : 0.f;
          st[BQ + i] = in ? delta[(long long)bh * N + q] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(sm.full + 8 * s, 2 * C::kTileBytes);
          const uint32_t qs = sQ + s * C::kTileBytes, ds = sDO + s * C::kTileBytes;
          for (int ch = 0; ch < C::kChunks; ++ch) {
            tma_load_4d(qs + ch * BQ * 128, &tq, sm.full + 8 * s, ch * 64, h,
                        t * BQ, b);
            tma_load_4d(ds + ch * BQ * 128, &tdo, sm.full + 8 * s, ch * 64, h,
                        t * BQ, b);
          }
        } else {
          mbar_arrive(sm.full + 8 * s);
        }
      }
    }
  } else {  // the consumers: warpgroup g, its warp wk owns k rows 16 wk .. + 15
    setmaxnreg_inc<C::kConsumerRegs>();
    const int g = warp >> 2;
    const int wk = warp & 3;
    if (g >= busy_groups) return;
    const uint32_t sKg = sK + 64 * g * 128, sVg = sV + 64 * g * 128;
    float acc_k[C::kDepth / 2], acc_v[C::kDepth / 2];
#pragma unroll
    for (int i = 0; i < C::kDepth / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    mbar_wait(sm.rbar, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      mbar_wait(sm.full + 8 * s, (t / S) & 1);
      __syncwarp();
      const uint32_t qs = sQ + s * C::kTileBytes, ds = sDO + s * C::kTileBytes;

      // S^T = K Q^T, dP^T = V dO^T
      float sc[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      scores<C>(sc, sKg, qs);
      scores<C>(dp, sVg, ds);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T = exp2(S^T c - lse log2 e), 0 past N; dS^T = P^T (dP^T - delta)
      const float* st = sm.stats + s * 2 * BQ;
      const int q0 = t * BQ;
      if (q0 + BQ > N)
        p_ds_cols<true>(sc, dp, st, c, N - q0, lane);
      else
        p_ds_cols<false>(sc, dp, st, c, BQ, lane);

      // dV += P^T dO, dK += dS^T Q
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      to_bf16(pa, sc);
      to_bf16(dsa, dp);
      wgmma_fence();
      product<C>(acc_v, pa, ds);
      product<C>(acc_k, dsa, qs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_k);
      fence_regs(acc_v);
      fence_regs(pa);
      fence_regs(dsa);
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * s);
    }

    const long long hd = (long long)H * D;  // row stride of dK and dV
    const long long off = (long long)b * M * hd + (long long)h * D;
    const int row0 = k0 + 64 * g + 16 * wk + (lane >> 2);
    store_rows(acc_v, dv + off, hd, row0, M, D, 1.f, lane);
    store_rows(acc_k, dk + off, hd, row0, M, D, scale, lane);
  }
}

// K5a (kDq) or K5b: four tensor maps per launch; Q/dO boxes of the
// resident (K5a) or streamed (K5b) rows, K/V boxes the other way round
template <class C, bool kDq>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int B, int H, int N, int M, int D, long long q_bs,
               long long q_rs, long long k_bs, long long k_rs, long long v_bs,
               long long v_rs, float scale, cudaStream_t stream) {
  const int q_box = kDq ? C::kBR : C::kBS;
  const int kv_box = kDq ? C::kBS : C::kBR;
  const long long hd = (long long)H * D;  // dO is contiguous
  CUtensorMap tq, tk, tv, tdo;
  int err = tensor_map(&tq, q, D, H, N, B, q_rs, q_bs, q_box);
  if (err == 0) err = tensor_map(&tk, k, D, H, M, B, k_rs, k_bs, kv_box);
  if (err == 0) err = tensor_map(&tv, v, D, H, M, B, v_rs, v_bs, kv_box);
  if (err == 0) err = tensor_map(&tdo, dout, D, H, N, B, hd, N * hd, q_box);
  if (err != 0) return err;
  static unsigned long long smem_set = 0;
  const float c = scale * kLog2e;
  if constexpr (kDq) {
    auto kern = flash_bwd_dq_kernel<C>;
    err = allow_smem(kern, C::kSmemBytes, smem_set);
    if (err != 0) return err;
    dim3 grid((N + C::kBR - 1) / C::kBR, B * H);
    kern<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), H, N, M, D, scale,
        c);
  } else {
    auto kern = flash_bwd_dkv_kernel<C>;
    err = allow_smem(kern, C::kSmemBytes, smem_set);
    if (err != 0) return err;
    dim3 grid((M + C::kBR - 1) / C::kBR, B * H);
    kern<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, N, M, D, scale, c);
  }
  return (int)cudaGetLastError();
}

// K5a when dq is given, else K5b
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int N, int M, int D, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale, void* stream) {
  // d = 40 (the 64^2 sites) and 80 (the 32^2 sites); the training path
  // routes no other head dim here
  const int padded = (D + 15) / 16 * 16;
  if (padded != 48 && padded != 80) return (int)cudaErrorInvalidValue;
  auto launch = dq != nullptr
                    ? (padded == 48 ? launch_bwd<Dq40, true> : launch_bwd<Dq80, true>)
                    : (padded == 48 ? launch_bwd<Dkv40, false>
                                    : launch_bwd<Dkv80, false>);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, q_bs,
                q_rs, k_bs, k_rs, v_bs, v_rs, scale, s);
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
// scale > 0. Only head dims that pad to 48, 80 or 512 are instantiated;
// any other, or scale <= 0, returns cudaErrorInvalidValue without
// launching.
LLT2I_API int llt2i_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int N,
                              int M, int D,
                              long long q_bs, long long q_rs, long long k_bs,
                              long long k_rs, long long v_bs, long long v_rs,
                              long long o_bs, long long o_rs, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;  // max over raw scores
  switch ((D + 15) / 16 * 16) {
    case 48:  // d = 40: the 64^2 sites
      return launch<Fwd40>(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs, k_bs,
                           k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
    case 80:  // d = 80: the 32^2 sites
      return launch<Fwd80>(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs, k_bs,
                           k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
    case 512:  // d = 512: the VAE's mid attention
      return launch<Fwd512>(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs, k_bs,
                            k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
    default:  // no site routes another head dim here
      return (int)cudaErrorInvalidValue;
  }
}
