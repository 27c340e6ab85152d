// K1: non-causal flash-attention forward for Hopper (bf16 in, f32 softmax;
// the f32 forms of K1, K5a and K5b follow the bf16 kernels, below).
//
// Replaces the TPU kernels of layoutllm_t2i_tpu/ops/pallas/flash_attention.py
// reached from `_flash_bh` (l.244): `_attn_kernel_wholerow` (l.165),
// `_flash_kernel_fullkv` (l.117), `_flash_kernel` (l.76) and
// `_attn_kernel_wholerow_hb` (l.195). Those four are TPU VMEM-tiling variants
// of one function, out = softmax(q k^T * scale) v per (batch, head), with
// the row log-sum-exp (natural log, f32) when asked; here one kernel with
// one instantiation per head dim covers them all.
//
// What bounds it on the H100. At d >= 64, operations: every q row meets
// every k row, 4*N*M*d flops against ~8*N*d bytes, thousands of flops a
// byte. At d = 40 (the UNet's 64^2 sites), the exponentials: one per
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
//    Q and K make the padded depth (48 at d = 40) add nothing to S. So one
//    instantiation takes every d up to its width: the entry point picks the
//    smallest of 48, 64, 80, 128, 160 and 512 that holds d (d % 8 == 0,
//    the map's head stride; the wrapper pads any other d in a copy).
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
//  * d <= 160: BQ = 128, each consumer warpgroup owns 64 rows (one whose
//    rows all lie past N leaves at once); K/V tiles of 64 rows in 4 stages
//    at d = 40 (the fastest of the tilings tried on the card) and 64, 128
//    rows in 2 stages at d = 80, 64 rows in 4 stages at d = 128 and in 3 at
//    d = 160 (Q 48 KB, a K/V stage 48 KB; O's 64 x 160 f32 accumulator is
//    80 registers a thread beside S's 32); grid B*H*ceil(N/128) (1,024
//    blocks at the generation's d = 40 shape). d = 512 (the VAE's single
//    head, and any d past 160 padded to it): a 64 x
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
#include "f32_tiles.cuh"
#include "hopper.cuh"
#include "tf32_gemm.cuh"

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
using Fwd64 = FwdCfg<64, 1, 128, 64, 4, 64, false>;    // num_heads 5, 64^2
using Fwd80 = FwdCfg<80, 2, 128, 128, 2, 80, false>;   // 32^2 sites
using Fwd128 = FwdCfg<128, 2, 128, 64, 4, 128, false>; // num_heads 5, 32^2
using Fwd160 = FwdCfg<160, 3, 128, 64, 3, 160, false>; // 24^2 sites (768^2)
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
// by box_rows rows, 128-byte swizzle, zeros outside. With f32, of an f32
// operand, boxes of 32 columns (the same 128 bytes).
int tensor_map(CUtensorMap* map, const void* base, int D, int H, int rows,
               int B, long long rs, long long bs, int box_rows,
               bool f32 = false) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t item = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * item, (cuuint64_t)rs * item,
                                 (cuuint64_t)bs * item};
  const cuuint32_t box[4] = {f32 ? 32u : 64u, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map,
                      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
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
//    otherwise overwrite the next head's first 8 columns). As in K1, one
//    instantiation takes every d up to its width (48, 64, 80, 128, 160,
//    256, 320): the maps zero-fill Q, K, V and dO past d.
//  * Widths 256 and 320 (num_heads 5's 24^2 sites at 768^2, num_heads 2's
//    32^2 sites at 512^2): two consumer warpgroups on 128 resident rows,
//    as at d = 160, with 32-row stages at 256 and 16-row ones at 320
//    (225 KB and 221 KB of shared memory). A 64 x d accumulator is d / 2
//    registers; K5b's two of them (256 or 320 at these widths) do not fit
//    the 232 that two warpgroups get, so K5b runs as two launches over
//    the stream, a dV pass (S^T alone, then P^T dO; K its one resident
//    operand, V not loaded) and a dK pass (S^T and dP^T, then dS^T Q),
//    each holding one accumulator: the f32 forms' split at 128 and 160. wgmma's N stops at 256, so at d = 320 each
//    output product is two, columns 0-255 and 256-319 (whole 64-column
//    chunks of the MN-major B), into the two parts of one accumulator.

// kDepth: wgmma depth of the scores (d padded to 16), also the width of the
// dQ, dK and dV accumulators; kChunks: 64-column chunks per row in shared
// memory; kGroups: consumer warpgroups, each owning 64 of the block's kBR
// resident rows; kBS: rows of a streamed stage; kStages: the ring's depth;
// kRowStats: each stage carries its rows' lse and delta (K5b only); kPass
// (K5b): 0 dK and dV, 1 dV alone, 2 dK alone.
template <int kDepth_, int kChunks_, int kGroups_, int kBS_, int kStages_,
          bool kRowStats, int kPass_ = 0>
struct BwdCfg {
  static constexpr int kDepth = kDepth_, kChunks = kChunks_,
                       kGroups = kGroups_, kBR = 64 * kGroups, kBS = kBS_,
                       kStages = kStages_, kPass = kPass_;
  static constexpr int kThreads = 128 * (kGroups + 1);  // + the producer's
  // the producer warpgroup's registers go to the consumers: 232 each with
  // two consumer warpgroups, 160 with three
  static constexpr int kProducerRegs = kGroups == 2 ? 40 : 24;
  static constexpr int kConsumerRegs =
      (65536 - 128 * kProducerRegs) / (128 * kGroups) / 8 * 8;
  static constexpr uint32_t kResBytes = kChunks * kBR * 128;   // one resident operand
  // K5b's dV pass reads K alone (no dP^T = V dO^T): one resident operand
  static constexpr int kResident = kPass == 1 ? 1 : 2;
  static constexpr uint32_t kTileBytes = kChunks * kBS * 128;  // one streamed operand
  static constexpr uint32_t kStatBytes = kRowStats ? 2 * kBS * 4 : 0;  // lse log2 e, delta
  // 1024 bytes of slack to align the swizzled tiles, then the mbarriers
  static constexpr size_t kSmemBytes = 1024 + kResident * kResBytes +
                                       kStages * (2 * kTileBytes + kStatBytes) +
                                       8 * (2 * kStages + 1);
  static_assert(kDepth % 16 == 0 && kDepth <= 64 * kChunks, "depth");
  static_assert(kBS % 16 == 0 && kBS <= 128, "stage rows");
  static_assert(kBR <= 256 && kConsumerRegs <= 256, "TMA box, registers");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
  static_assert(kDepth <= 256 || kDepth % 64 == 0, "output parts of whole chunks");
  static_assert(kRowStats || kPass == 0, "K5a runs in one pass");
};

// K5a (Dq) and K5b (Dkv) at the 64^2 sites (d = 40) and the 32^2 sites.
// Three consumer warpgroups were faster than two on the card (and 64-row
// stages than 128 with two); K5b at d = 80 keeps two, for the 232
// registers its two 64 x 80 accumulators and four score fragments need.
// Past d = 80 (num_heads 5's 64 and 128, SD-1.4 at 768^2's 160) two
// consumer warpgroups, and K5b's stages shrink as its two 64 x d
// accumulators grow: 32 q rows at d = 128 (128 + 48 registers), 16 at
// d = 160 (160 + 24), within the 232 that two warpgroups get.
using Dq40 = BwdCfg<48, 1, 3, 64, 4, false>;
using Dkv40 = BwdCfg<48, 1, 3, 64, 4, true>;
using Dq64 = BwdCfg<64, 1, 3, 64, 4, false>;
using Dkv64 = BwdCfg<64, 1, 2, 64, 4, true>;
using Dq80 = BwdCfg<80, 2, 3, 64, 3, false>;
using Dkv80 = BwdCfg<80, 2, 2, 64, 3, true>;
using Dq128 = BwdCfg<128, 2, 2, 64, 3, false>;
using Dkv128 = BwdCfg<128, 2, 2, 32, 4, true>;
using Dq160 = BwdCfg<160, 3, 2, 64, 2, false>;
using Dkv160 = BwdCfg<160, 3, 2, 16, 4, true>;
using Dq256 = BwdCfg<256, 4, 2, 32, 3, false>;       // 225 KB
using Dv256 = BwdCfg<256, 4, 2, 32, 3, true, 1>;     // 162 KB (no V)
using Dk256 = BwdCfg<256, 4, 2, 32, 3, true, 2>;     // 226 KB
using Dq320 = BwdCfg<320, 5, 2, 16, 3, false>;       // 221 KB
using Dv320 = BwdCfg<320, 5, 2, 16, 3, true, 1>;     // 141 KB (no V)
using Dk320 = BwdCfg<320, 5, 2, 16, 3, true, 2>;     // 221 KB

constexpr float kLog2e = 1.4426950408889634f;

// shared-memory layout of both kernels: two resident operands (one in K5b's
// dV pass), two streamed
// ones in kStages stages, K5b's per-stage row statistics (none in K5a), the
// mbarriers
template <class C>
struct BwdSmem {
  uint32_t res0, res1, tile0, tile1, full, empty, rbar;
  float* stats;
  __device__ explicit BwdSmem(unsigned char* raw) {
    const uint32_t base = smem_u32(raw);
    res0 = (base + 1023u) & ~1023u;
    res1 = res0 + C::kResBytes;  // none in K5b's dV pass
    tile0 = res0 + C::kResident * C::kResBytes;  // stage s at + s * kTileBytes
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

// product over a 64 x kDepth accumulator: one wgmma per k slice up to
// 256 columns; past that (d = 320) the first 256 columns (chunks 0-3 of B)
// and the rest (chunk 4 on) as two, into the two parts of `d`
template <class C, int N, int K>
__device__ __forceinline__ void product_cols(float (&d)[N],
                                             const uint32_t (&a)[K][4],
                                             uint32_t b) {
  if constexpr (N <= 128) {
    product<C>(d, a, b);
  } else {
    product<C>(*reinterpret_cast<float(*)[128]>(&d[0]), a, b);
    product<C>(*reinterpret_cast<float(*)[N - 128]>(&d[128]), a,
               b + 4 * C::kBS * 128);
  }
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

// K5b's P^T in place of S^T and (kDs) dS^T in place of dP^T: the thread's
// q columns 8 j + 2 (lane % 4) + {0, 1} read their lse log2 e and delta
// from the stage's statistics `st` (2N of each); with kMask, P^T = 0 in the
// columns at or past `lim`
template <bool kMask, int N, bool kDs = true>
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
      if (kDs) dp[i] = p * (dp[i] - (odd ? dl.y : dl.x));
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
      product_cols<C>(acc, dsa, ks);
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
// [P o (dO V^T - delta)]^T Q, from S^T = K Q^T and dP^T = V dO^T; with
// C::kPass 1 dV alone (no dP^T), with 2 dK alone
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
  constexpr bool kDoV = C::kPass != 2, kDoK = C::kPass != 1;
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
        mbar_expect_tx(sm.rbar, C::kResident * C::kResBytes);
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_4d(sK + ch * BK * 128, &tk, sm.rbar, ch * 64, h, k0, b);
          if constexpr (kDoK)
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
    // the accumulators of the outputs this pass writes (4 placeholder
    // registers, never read, for the other one)
    constexpr int NK = kDoK ? C::kDepth / 2 : 4, NV = kDoV ? C::kDepth / 2 : 4;
    float acc_k[NK], acc_v[NV];
#pragma unroll
    for (int i = 0; i < NK; ++i) acc_k[i] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc_v[i] = 0.f;
    mbar_wait(sm.rbar, 0);

    for (int t = 0; t < tiles; ++t) {
      const int s = t % S;
      mbar_wait(sm.full + 8 * s, (t / S) & 1);
      __syncwarp();
      const uint32_t qs = sQ + s * C::kTileBytes, ds = sDO + s * C::kTileBytes;

      // S^T = K Q^T, and for dK dP^T = V dO^T
      float sc[BQ / 2], dp[BQ / 2];
      wgmma_fence();
      scores<C>(sc, sKg, qs);
      if constexpr (kDoK) scores<C>(dp, sVg, ds);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if constexpr (kDoK) fence_regs(dp);

      // P^T = exp2(S^T c - lse log2 e), 0 past N; dS^T = P^T (dP^T - delta)
      const float* st = sm.stats + s * 2 * BQ;
      const int q0 = t * BQ;
      if (q0 + BQ > N)
        p_ds_cols<true, BQ / 2, kDoK>(sc, dp, st, c, N - q0, lane);
      else
        p_ds_cols<false, BQ / 2, kDoK>(sc, dp, st, c, BQ, lane);

      // dV += P^T dO, dK += dS^T Q
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
      if constexpr (kDoV) to_bf16(pa, sc);
      if constexpr (kDoK) to_bf16(dsa, dp);
      wgmma_fence();
      if constexpr (kDoV) product_cols<C>(acc_v, pa, ds);
      if constexpr (kDoK) product_cols<C>(acc_k, dsa, qs);
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (kDoK) {
        fence_regs(acc_k);
        fence_regs(dsa);
      }
      if constexpr (kDoV) {
        fence_regs(acc_v);
        fence_regs(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty + 8 * s);
    }

    const long long hd = (long long)H * D;  // row stride of dK and dV
    const long long off = (long long)b * M * hd + (long long)h * D;
    const int row0 = k0 + 64 * g + 16 * wk + (lane >> 2);
    if constexpr (kDoV) store_rows(acc_v, dv + off, hd, row0, M, D, 1.f, lane);
    if constexpr (kDoK) store_rows(acc_k, dk + off, hd, row0, M, D, scale, lane);
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

// K5a when dq is given, else K5b (past 160 its dV pass, then its dK pass)
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, void* dk,
              void* dv, int B, int H, int N, int M, int D, long long q_bs,
              long long q_rs, long long k_bs, long long k_rs, long long v_bs,
              long long v_rs, float scale, void* stream) {
  // the smallest width that holds d: 48, 64, 80, 128, 160, 256 or 320
  using Launch = decltype(&launch_bwd<Dq40, true>);
  Launch launch = nullptr, second = nullptr;
  const bool a = dq != nullptr;
  if (D <= 48) launch = a ? launch_bwd<Dq40, true> : launch_bwd<Dkv40, false>;
  else if (D <= 64) launch = a ? launch_bwd<Dq64, true> : launch_bwd<Dkv64, false>;
  else if (D <= 80) launch = a ? launch_bwd<Dq80, true> : launch_bwd<Dkv80, false>;
  else if (D <= 128) launch = a ? launch_bwd<Dq128, true> : launch_bwd<Dkv128, false>;
  else if (D <= 160) launch = a ? launch_bwd<Dq160, true> : launch_bwd<Dkv160, false>;
  else if (D <= 256) {
    launch = a ? launch_bwd<Dq256, true> : launch_bwd<Dv256, false>;
    if (!a) second = launch_bwd<Dk256, false>;
  } else if (D <= 320) {
    launch = a ? launch_bwd<Dq320, true> : launch_bwd<Dv320, false>;
    if (!a) second = launch_bwd<Dk320, false>;
  }
  if (launch == nullptr || D % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, q_bs,
                   q_rs, k_bs, k_rs, v_bs, v_rs, scale, s);
  if (err == 0 && second != nullptr)
    err = second(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, q_bs,
                 q_rs, k_bs, k_rs, v_bs, v_rs, scale, s);
  return err;
}

}  // namespace

// ---------------------------------------------------------------------------
// The f32 forms of K1, K5a and K5b: the same functions on f32 operands, as
// the Pallas kernels take them (the JAX trainer's default precision). P and
// dS stay f32 (`_flash_kernel` keeps P in the operands' type, and the plain
// backward rounds them to it), and every product is 3xTF32 (csrc/
// f32_tiles.cuh): f32 accuracy on the tensor cores.
//
// What bounds them: operations, as the bf16 forms, at the TF32 rate (495
// TFLOP/s dense) times three. All of them run on TF32 wgmma fed by TMA:
// K1/f32 at widths up to 160 flash_fwd_f32_ss_kernel (Q and K by descriptor,
// K and V split and V transposed once a call by a pre-pass), at d = 512
// flash_fwd_f32_wgmma_kernel (Q as register A), K5a/f32 and K5b/f32
// flash_bwd_dq_f32_ss_kernel and flash_bwd_dkv_f32_ss_kernel (the scores
// by descriptor, P and dS as register A against operands transposed and
// split once a call by the same pre-pass, flash_split_f32_kernel), and at
// widths 256 and 320 flash_bwd_dq_f32_stream_kernel and
// flash_bwd_dkv_f32_stream_kernel (the same, the scores' depth streamed),
// all below.

namespace {

// ---------------------------------------------------------------------------
// K1/f32 at d = 512, the VAE's single head (N = M = 4096 at 512^2): 4 N M d
// flops against ~16 N d bytes, so operations bound it, three TF32 products
// for each f32 one. The 64 x 512 f32 Q tile that wgmma's 64 rows need
// takes 128 KB of shared memory by itself, which shapes the design:
//  * one block per (64 q rows, batch, head), two warpgroups (eight warps).
//    Key tiles are 32 keys. S (64 x 32) is computed once, warpgroup g over
//    half of d (its chunks 8 g .. 8 g + 7 of 32 values); O (64 x 512) is
//    split by columns, warpgroup g owns 256 g .. 256 g + 255 and its warp
//    w rows 16 w .. 16 w + 15 (128 registers a thread). So each warpgroup
//    reads only its own Q half, K chunks and V chunks: its first thread
//    loads them with TMA from 4-d tensor maps (32 rows x 32 values a chunk,
//    128-byte swizzle, zeros past N or M), Q once, then a tile's 8 K
//    chunks and 8 V chunks in turn through one ring of 8 stages, refilling
//    a stage once the warpgroup's four warps have released it: the V
//    chunks arrive during S and the next tile's K chunks during P V.
//  * The warpgroup splits each K chunk once as it lands, hi in place and lo
//    into one of two lo tiles of its own (tf32_gemm.cuh split_tile), fences
//    the async proxy and meets at a named barrier; then wgmma m64n32k8 with
//    Q as register A
//    (split in registers as it is read, one thread a value: Q's hi and lo
//    tiles would take 256 KB) against K's hi and lo tiles, each chunk's 12
//    products into a fresh accumulator added in round-to-nearest f32
//    (tf32_gemm.cuh). The two partial S go through shared memory (thread i
//    of one warpgroup holds the same elements as thread i of the other), so
//    both warpgroups hold S = S_0 + S_1, bit for bit the same, and run the
//    same online softmax on it.
//  * P V runs on wgmma too, V chunk by V chunk (m64n32k8, 12 products into
//    a fresh accumulator added in RN to O's 32 columns). wgmma takes a
//    .tf32 B K-major only, and V is stored d-contiguous, so the warpgroup
//    transposes each V chunk as it splits it: every thread reads its 8
//    values (a lane a key, 16 bytes a read), the warpgroup meets, and each
//    writes hi in place and lo into a 4 KB buffer of its own (a half of
//    the partial-S buffer, which is idle while P V runs; two, used in
//    turns), 32 keys a 128-byte row. P is the register A operand: S's
//    fragment, split once a tile, is the A fragment at a permuted k (key 2 t
//    at k = t, 2 t + 1 at t + 4, f32_tiles.cuh c_as_a), so the transposed
//    rows hold their keys in that order. A whole transposed tile (hi and
//    lo, 128 KB) would not fit beside Q; a chunk at a time does. Two
//    chunks' products are in flight, into two fresh accumulators in turns.
//    (P V on mma.sync, V read MN-major, was 3 % slower on the H100.)
//  * Each chunk's split (K) or transposition (V) runs while the tensor
//    cores run the previous chunk's products.
//  * What bounds it, measured on the H100 at B 8 (7.3 ms): without its TMA
//    loads it takes 6.3 ms, the loads alone 2.8 ms. So the products'
//    latency and the meetings bound it, not bytes: 32-key tiles give
//    wgmma N = 32, chains of 12 dependent products a chunk and 16 chunks
//    a tile, each with a named barrier, at about a quarter of the TF32
//    rate. Wider products need key tiles that Q's 128 KB leaves no room
//    for.
//  * Registers: O's 128, the partial S and its fresh accumulator and the
//    split Q fragments take ~210 a thread. ptxas allocates one count for
//    the kernel, bounded by the register file of an SM's four
//    sub-partitions (16,384 each) across the warps each holds: 255 at
//    eight warps, 168 at nine to twelve (setmaxnreg moves registers at run
//    time only). Hence no warp is set aside to load.
struct Fwd512W {
  static constexpr int kD = 512, kBQ = 64, kBK = 32, kChunks = kD / 32;
  static constexpr int kStages = 8;     // a warpgroup's ring of K and V chunks
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr uint32_t kQChunk = kBQ * 128;          // 64 rows x 32 values
  static constexpr uint32_t kQBytes = kChunks * kQChunk;  // 128 KB
  static constexpr uint32_t kKV = kBK * 128;              // a K or V chunk
  // a warpgroup's ring and its two K lo tiles
  static constexpr uint32_t kGroupBytes = (kStages + 2) * kKV;
  static constexpr uint32_t kXBytes = 2 * 16 * 128 * 4;   // both partial S
  // a warpgroup's: Q's, and each stage's "full" and "empty"
  static constexpr int kBars = 1 + 2 * kStages;
  // 1024 bytes of slack to align the swizzled tiles, then Q, both
  // warpgroups' rings and K lo tiles, the partial S and the mbarriers
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kGroupBytes + kXBytes + 2 * 8 * kBars;
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

// The transposed row position of key r (of a 32-key chunk) where P's
// register A fragment expects it: in each 8-key block, key 2 t at k = t and
// key 2 t + 1 at k = t + 4 (c_as_a's permuted k)
__device__ __forceinline__ int p_key_slot(int r) {
  return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1);
}

// O's 32 columns of V chunk I (n8 tiles 4 I .. 4 I + 3) += a fresh m64n32
// accumulator. The P V loop is not unrolled (unrolled, ptxas failed on the
// kernel), so each chunk's tiles are named by a switch on its index: a
// register array indexed at run time would live in local memory.
template <int I>
__device__ __forceinline__ void add_chunk(float (&acc)[32][4],
                                          const float (&part)[16]) {
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[4 * I + nb][v] += part[4 * nb + v];
}

__global__ void __launch_bounds__(Fwd512W::kThreads, 1)
flash_fwd_f32_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, float* __restrict__ lse,
                           int H, int N, int M, int D, long long o_bs,
                           long long o_rs, float scale, float c) {
  using C = Fwd512W;
  using namespace f32_tiles;
  constexpr int R = C::kStages, BK = C::kBK;
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp >> 2;             // this warpgroup
  const int wq = warp & 3;             // its warp: q rows 16 wq .. 16 wq + 15
  const int tid = threadIdx.x & 127;   // and thread
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQ = (base + 1023u) & ~1023u;  // d chunk ch at + ch kQChunk
  // this warpgroup's ring (stage j at sR + j kKV) and two K lo tiles; then
  // the partial S of both (two V lo tiles of each warpgroup during P V);
  // then its mbarriers
  const uint32_t sR = sQ + C::kQBytes + g * C::kGroupBytes;
  const uint32_t sKlo = sR + R * C::kKV;
  const uint32_t sX = sQ + C::kQBytes + 2 * C::kGroupBytes;
  const uint32_t sVlo = sX + g * 2 * C::kKV;
  const uint32_t qbar = sX + C::kXBytes + g * 8 * C::kBars;
  const uint32_t full = qbar + 8, empty = full + 8 * R;
  auto at = [&](uint32_t a) { return smem_raw + (a - base); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * C::kBQ;
  const int tiles = (M + BK - 1) / BK;
  // this warpgroup's chunk sequence: 16 a key tile, m = 16 t + i its K
  // chunk i (i < 8), m = 16 t + 8 + i its V chunk i; K or V chunk i holds
  // keys 32 t .. 32 t + 31 and d values 32 (8 g + i) .. + 31
  const int chunks = 16 * tiles;
  auto load = [&](int m) {
    const int j = m % R, i = m % 16;
    mbar_expect_tx(full + 8 * j, C::kKV);
    tma_load_4d(sR + j * C::kKV, i < 8 ? &tk : &tv, full + 8 * j,
                32 * (8 * g + i % 8), h, BK * (m / 16), b);
  };
  // chunk m's products are done: its stage goes back to the ring
  auto release = [&](int m) {
    const int j = m % R;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * j);
    if (tid == 0 && m + R < chunks) {
      mbar_wait(empty + 8 * j, (m / R) & 1);
      load(m + R);
    }
    __syncwarp();
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int j = 0; j < R; ++j) {
      mbar_init(full + 8 * j, 1);
      mbar_init(empty + 8 * j, 4);  // the warpgroup's four warps
    }
    mbar_init_fence();
    mbar_expect_tx(qbar, C::kQBytes / 2);
    for (int ch = 8 * g; ch < 8 * g + 8; ++ch)
      tma_load_4d(sQ + ch * C::kQChunk, &tq, qbar, 32 * ch, h, q0, b);
    for (int m = 0; m < R && m < chunks; ++m) load(m);
  }
  __syncthreads();

  const int r0 = 16 * wq + (lane >> 2);  // this thread's rows r0 and r0 + 8
  float* xs = reinterpret_cast<float*>(at(sX));  // [warpgroup][16][128]
  float acc[32][4];  // O, n8 tile n: columns 256 g + 8 n + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int n = 0; n < 32; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  // running max of the raw scores and per-thread partial row sums of rows
  // r0 and r0 + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);

  // split K chunk m (its i = m % 16) once: hi in place, lo into K lo tile
  // i % 2, each thread a quarter-row, fenced for wgmma (the warpgroup meets
  // before its products)
  auto split_k = [&](int m) {
    const int j = m % R;
    mbar_wait(full + 8 * j, (m / R) & 1);
    float4* khi = reinterpret_cast<float4*>(at(sR + j * C::kKV));
    float4* klo = reinterpret_cast<float4*>(at(sKlo + (m & 1) * C::kKV));
    tf32_gemm::split_tile<128>(khi, klo, C::kKV / 16, tid);
    fence_proxy_async();
  };
  // V chunk m transposed into the rows of wgmma's K-major B: this thread's
  // key (its lane) and 8 values (columns 8 wq .. 8 wq + 7) read, the
  // warpgroup met (every raw value read), then hi written in place and lo
  // into V lo tile m % 2, fenced for wgmma
  auto transpose_v = [&](int m) {
    const int j = m % R;
    mbar_wait(full + 8 * j, (m / R) & 1);
    unsigned char* vc = at(sR + j * C::kKV);
    unsigned char* vlo = at(sVlo + (m & 1) * C::kKV);
    float4 x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      x[e] = *reinterpret_cast<const float4*>(vc + sw128_f32(lane, 8 * wq + 4 * e));
    named_bar_sync(3 + g, 128);
    const int slot = p_key_slot(lane);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v[4] = {x[e].x, x[e].y, x[e].z, x[e].w};
      uint32_t hi[4], lo[4];
      split(v, hi, lo);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t at_n = sw128_f32(8 * wq + 4 * e + u, slot);
        *reinterpret_cast<uint32_t*>(vc + at_n) = hi[u];
        *reinterpret_cast<uint32_t*>(vlo + at_n) = lo[u];
      }
    }
    fence_proxy_async();
  };

  for (int t = 0; t < tiles; ++t) {
    // this warpgroup's partial S over its half of d: 8 chunks, each into a
    // fresh accumulator (the first product's scale-d zeroes it)
    float sp[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sp[j] = 0.f;
    split_k(16 * t);
    named_bar_sync(3 + g, 128);
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      const int n = 16 * t + i;
      const uint32_t kh = sR + (n % R) * C::kKV, kl = sKlo + (n & 1) * C::kKV;
      uint32_t qh[4][4], ql[4][4];
      const unsigned char* qc = at(sQ + (8 * g + i) * C::kQChunk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tf32_gemm::a_frag_split(qh[kk], ql[kk], qc, r0, kk, lane);
      __syncwarp();  // converged again for the warpgroup-wide wgmma
      float part[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_tf32(part, ql[kk], sw128_desc(kh + 32 * kk, 16), kk > 0);
        wgmma_rs_tf32(part, qh[kk], sw128_desc(kl + 32 * kk, 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tf32(part, qh[kk], sw128_desc(kh + 32 * kk, 16), 1);
      wgmma_commit();
      if (i + 1 < 8) split_k(n + 1);  // while the tensor cores run
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(qh);
      fence_regs(ql);
      release(n);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) sp[jj] += part[jj];
      if (i + 1 < 8) named_bar_sync(3 + g, 128);  // chunk n + 1 split
    }

    // S = S_0 + S_1: thread tid of each warpgroup holds the same elements;
    // the second barrier keeps the partials until both have read them
    float sc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) xs[(16 * g + j) * 128 + tid] = sp[j];
    named_bar_sync(1, 256);
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = sp[j] + xs[(16 * (1 - g) + j) * 128 + tid];
    named_bar_sync(2, 256);

    // the ragged KV tail scores -inf
    const int k0 = BK * t;
    if (k0 + BK > M) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = k0 + 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
        if (col >= M) sc[i] = -INFINITY;
      }
    }

    // online softmax: row max over the quad, p = exp2(s c - m c)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], c, -mc[r]));
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] *= alpha[i >> 1];

    // O += P V: key block kk of P is the C fragment sc[4 kk .. 4 kk + 3],
    // split once, as wgmma's register A; the warpgroup's 8 V chunks (its
    // columns) in order, each transposed while the previous one's products
    // run, into a fresh accumulator added to O's 32 columns in RN
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float f[4] = {sc[4 * kk], sc[4 * kk + 1], sc[4 * kk + 2],
                          sc[4 * kk + 3]};
      const SplitA a = c_as_a(f);
#pragma unroll
      for (int e = 0; e < 4; ++e) ph[kk][e] = a.hi[e], pl[kk][e] = a.lo[e];
    }
    // two fresh accumulators in turns: chunk i's products are issued
    // before chunk i - 1's are waited for and added, and chunk i + 1 is
    // transposed while chunk i's run
    auto issue = [&](float (&part)[16], int n) {
      const uint32_t vh = sR + (n % R) * C::kKV;
      const uint32_t vl = sVlo + (n & 1) * C::kKV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_tf32(part, pl[kk], sw128_desc(vh + 32 * kk, 16), kk > 0);
        wgmma_rs_tf32(part, ph[kk], sw128_desc(vl + 32 * kk, 16), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tf32(part, ph[kk], sw128_desc(vh + 32 * kk, 16), 1);
      wgmma_commit();
    };
    // chunk n's products done: added to O's columns, its V stage released
    auto retire = [&](float (&part)[16], int n) {
      fence_regs(part);
      switch (n % 8) {  // O's columns of the chunk, named at compile time
        case 0: add_chunk<0>(acc, part); break;
        case 1: add_chunk<1>(acc, part); break;
        case 2: add_chunk<2>(acc, part); break;
        case 3: add_chunk<3>(acc, part); break;
        case 4: add_chunk<4>(acc, part); break;
        case 5: add_chunk<5>(acc, part); break;
        case 6: add_chunk<6>(acc, part); break;
        default: add_chunk<7>(acc, part); break;
      }
      release(n);
    };
    float pa0[16], pa1[16];
    transpose_v(16 * t + 8);
    named_bar_sync(3 + g, 128);
#pragma unroll 1
    for (int i = 0; i < 8; i += 2) {
      const int n = 16 * t + 8 + i;
      issue(pa0, n);
      if (i > 0) {
        wgmma_wait<1>();
        retire(pa1, n - 1);
      }
      transpose_v(n + 1);  // its lo buffer was chunk n - 1's, now done
      named_bar_sync(3 + g, 128);
      issue(pa1, n + 1);
      wgmma_wait<1>();
      retire(pa0, n);
      if (i + 2 < 8) {
        transpose_v(n + 2);
        named_bar_sync(3 + g, 128);
      }
    }
    wgmma_wait_all();
    retire(pa1, 16 * t + 15);
    fence_regs(ph);
    fence_regs(pl);
  }

  // epilogue: O / l, lse = m scale + ln l (both warpgroups hold the same m
  // and l; the first writes the lse)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l_run[r];
    float* orow = o + b * o_bs + row * o_rs + (long long)h * D + 256 * g;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      if (256 * g + 8 * n + 2 * (lane & 3) < D)  // no column past d
        *reinterpret_cast<float2*>(orow + 8 * n + 2 * (lane & 3)) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0 && g == 0)
      lse[(long long)bh * N + row] = m_run[r] * scale + logf(l_run[r]);
  }
}

// d <= 512: the maps hold d columns, so TMA zero-fills the rest of the
// 512-column tiles (d 512, the VAE's head, and any d past 160)
int launch_fwd_f32_512(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int N, int M, int D,
                       long long q_bs, long long q_rs, long long k_bs,
                       long long k_rs, long long v_bs, long long v_rs,
                       long long o_bs, long long o_rs, float scale,
                       cudaStream_t stream) {
  using C = Fwd512W;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, D, H, N, B, q_rs, q_bs, C::kBQ, true);
  if (err == 0) err = tensor_map(&tk, k, D, H, M, B, k_rs, k_bs, C::kBK, true);
  if (err == 0) err = tensor_map(&tv, v, D, H, M, B, v_rs, v_bs, C::kBK, true);
  if (err != 0) return err;
  static unsigned long long smem_set = 0;
  err = allow_smem(flash_fwd_f32_wgmma_kernel, C::kSmemBytes, smem_set);
  if (err != 0) return err;
  dim3 grid((N + C::kBQ - 1) / C::kBQ, B * H);
  flash_fwd_f32_wgmma_kernel<<<grid, C::kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<float*>(o), lse, H, N, M, D, o_bs, o_rs, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K1/f32 at d = 40 and 80 (and, below, 64, 128, 160), the UNet's heads
// (N = M = 4096 or 4126 at the 64^2 sites, 1024 or 1054 at the 32^2 ones;
// M = 77 at the text sites):
// 4 N M d flops against ~16 N d bytes, so operations bound it, three TF32
// products for each f32 one, as at d = 512. At these widths a 128-row Q
// tile split into hi and lo takes 64 KB (d = 40) or 96 KB (d = 80), so Q
// is read by descriptor from shared memory and the registers go to the
// score tile and O. The design:
//  * A pre-pass (flash_split_f32_kernel) writes K and V once a call,
//    split into hi and lo, into a workspace the wrapper allocates: K's as
//    (B H, M, d) matrices, V's transposed, (B H, d, Mp) with Mp = M rounded
//    up to 8 and each 8-key block's keys at the permuted k of P's register
//    A fragment (p_key_slot), zeros at the slots of keys past M. wgmma takes
//    .tf32 operands K-major only and V is stored d-contiguous; transposed
//    and split once a call, no K/V tile is split or transposed again by the
//    N / 128 q blocks that read it, and the main loop has no block-wide
//    meeting. It moves 6 B H M d f32 values (K and V read, four written).
//  * One block per (128 q rows, batch, head): two consumer warpgroups of 64
//    rows and a producer warp. The grid's first dimension is the (batch,
//    head) pair, so the blocks of a ragged last q tile (N = 4126, 1054) come
//    last: at N = 1054 (d = 80) its 32 blocks of 30 rows run in a third
//    round of one warpgroup each, after the 256 full blocks, instead of
//    spreading a third round of full blocks over the card.
//  * The producer's first thread loads Q once (4-d map of the packed
//    operand, 32 values x 128 rows a chunk, zeros past d and N), then each
//    stage's K hi and lo chunks (32 values x kBK keys) and V's transposed hi
//    and lo chunks (32 key slots x d rows) with TMA from 3-d maps of the
//    workspace (zeros past d, M and Mp), into a ring of kStages stages with
//    "full" and "empty" mbarriers (one arrival a consumer warp).
//  * Each warpgroup splits its own 64 Q rows once (hi in place, lo into the
//    Q lo tile), fences the async proxy and meets at a named barrier. S = Q
//    K^T: wgmma m64nkBNk8 with A and B by descriptor, the d / 8 k steps'
//    lo*hi and hi*lo products, then hi*hi, chained into one fresh
//    accumulator (at most 30 products). The k loop stops at d: no product
//    over the zero columns of the last 32-value chunk.
//  * The online softmax runs in registers as in the bf16 kernel (the
//    ragged KV tail scores -inf before the max). P stays f32: each 8-key
//    block of S's fragment is wgmma's register A at the permuted k
//    (f32_tiles.cuh c_as_a), split once into hi and lo. O += P V: the
//    tile's kBK / 8 k steps' three products into a fresh m64n(d)
//    accumulator, added to the rescaled O in round-to-nearest f32 (the
//    tensor cores truncate where they add into their accumulator).
//  * Registers: S (kBK / 2), P's hi and lo (kBK each), O and its fresh
//    accumulator (d / 2 each): ~140 a thread, within the 168 that ptxas
//    allows a kernel of nine warps.
//  * Shared memory: d = 40, 64-key stages (K hi, K lo 16 KB each, V^T hi,
//    V^T lo 10 KB each) in three stages beside Q's 64 KB; d = 80, 32-key
//    stages of 44 KB in two beside Q's 96 KB; d = 64, 32-key stages of
//    32 KB in four beside Q's 64 KB.
//  * d = 128 and 160 (num_heads 5's 32^2 sites, SD-1.4's 24^2 sites at
//    768^2): 128 Q rows split would take 128 or 160 KB, so a block holds
//    64 (one consumer warpgroup and the producer warp: five warps, which
//    ptxas allows 255 registers, where O and its fresh accumulator take
//    d each); 32-key stages of 64 KB in two beside Q's 64 KB at d = 128,
//    of 80 KB in one beside Q's 80 KB at d = 160 (the producer refills
//    the stage once the P V products of the tile are done).
//  * Any d up to the width (40, 64, 80, 128, 160; d % 4 == 0): Q's map
//    holds d columns, the pre-pass writes zeros past d into the workspace's
//    width-wide rows and transposed rows, and only columns < d are stored.

// kD: the width (40, 64, 80, 128 or 160); kBK: keys a stage (a multiple of
// 32, one transposed V chunk); kStages: the ring's depth; kGroups: consumer
// warpgroups, 64 q rows each
template <int kD_, int kBK_, int kStages_, int kGroups_ = 2>
struct FwdF32W {
  static constexpr int kD = kD_, kBK = kBK_, kStages = kStages_,
                       kGroups = kGroups_;
  static constexpr int kChunks = (kD + 31) / 32;  // 32-value chunks of Q, K
  static constexpr int kSteps = kD / 8;           // S's k steps
  static constexpr int kBQ = 64 * kGroups;        // 64 rows a warpgroup
  static constexpr int kProducer = 4 * kGroups;   // the producer warp
  static constexpr int kThreads = 32 * (kProducer + 1);
  static constexpr uint32_t kQChunk = kBQ * 128;
  static constexpr uint32_t kQBytes = kChunks * kQChunk;   // Q hi; Q lo the same
  static constexpr uint32_t kKChunk = kBK * 128;
  static constexpr uint32_t kKBytes = kChunks * kKChunk;   // a stage's K hi or lo
  static constexpr uint32_t kVChunk = kD * 128;            // 32 key slots x d rows
  static constexpr uint32_t kVBytes = kBK / 32 * kVChunk;  // its V^T hi or lo
  static constexpr uint32_t kStageBytes = 2 * kKBytes + 2 * kVBytes;
  // 1024 bytes of slack to align the swizzled tiles, then Q hi and lo, the
  // ring and the mbarriers
  static constexpr size_t kSmemBytes =
      1024 + 2 * kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
  static_assert(kD % 8 == 0 && kBK % 32 == 0 && kVChunk % 1024 == 0, "tiles");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

using Fwd40W = FwdF32W<40, 64, 3>;         // 64^2 sites: 221 KB
using Fwd64W = FwdF32W<64, 32, 4>;         // num_heads 5, 64^2: 193 KB
using Fwd80W = FwdF32W<80, 32, 2>;         // 32^2 sites: 185 KB
using Fwd128W = FwdF32W<128, 32, 2, 1>;    // num_heads 5, 32^2: 193 KB
using Fwd160W = FwdF32W<160, 32, 1, 1>;    // 24^2 sites at 768^2: 161 KB

// The width of K1/f32's and K5's f32 kernels for head dim D: the smallest
// of 40, 64, 80, 128 and 160 that holds it; 0 past 160 (K1 then runs
// Fwd512W, K5 has none)
int f32_width(int D) {
  return D <= 40 ? 40 : D <= 64 ? 64 : D <= 80 ? 80 : D <= 128 ? 128
       : D <= 160 ? 160 : 0;
}

// The width of K5a/f32's and K5b/f32's kernels for head dim D: f32_width's,
// then the d-streamed kernels' (bwd_f32_stream); 0 past 320
int bwd_f32_width(int D) {
  const int w = f32_width(D);
  return w ? w : D <= 256 ? 256 : D <= 320 ? 320 : 0;
}

// The workspace of K1/f32 at widths up to 160, in floats: K hi, K lo (B H
// M W each), then V^T hi, V^T lo (B H W Mp each), W the width
long long fwd_f32_ws_floats(int B, int H, int M, int W) {
  const long long mp = (M + 7) / 8 * 8;
  return 2ll * B * H * W * (M + mp);
}

// One operand of the pre-pass: a packed (B, n, H d) f32 operand with row
// stride rs and batch stride bs (values), written split into hi and lo,
// as rows (hi (B H, n, d), lo right after it) and/or transposed ((B H, d,
// np) with np = n rounded up to 8, each 8-row block's rows at the key
// slots of a register A fragment (p_key_slot), zeros at the slots of rows
// at or past n; lo right after hi). A null destination is not written.
struct SplitJob {
  const float* src;
  long long bs, rs;
  float* rows;
  float* t;
  int n;
};

template <int kJobs>
struct SplitJobs {
  SplitJob job[kJobs];
};

// The f32 forms' pre-pass, shared by K1/f32 (kJobs 2: K as rows, V
// transposed) and K5a/K5b f32 (kJobs 4: Q, dO, K and V as rows, Q, dO and
// K transposed as the call needs them): rows m0 .. m0 + 31 (m0 = 32
// blockIdx.x) of one (batch, head) (blockIdx.y) of operand blockIdx.z,
// split row by row, and transposed through shared memory. The operands
// hold D columns a head (D % 4 == 0); the workspace rows are kD wide, zero
// past D, and the transposed operands have kD rows, zero past D.
template <int kD, int kJobs>
__global__ void __launch_bounds__(256)
flash_split_f32_kernel(const __grid_constant__ SplitJobs<kJobs> jobs, int H,
                       int D) {
  const SplitJob& job = jobs.job[blockIdx.z];
  const int n = job.n, np = (n + 7) / 8 * 8;
  const int m0 = 32 * blockIdx.x;
  if (m0 >= np) return;
  const int BH = gridDim.y, bh = blockIdx.y, b = bh / H, h = bh % H;
  __shared__ float vt[kD][33];
  constexpr int kVec = kD / 4;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < 32 * kVec; i += blockDim.x) {
    const int r = i / kVec, c = 4 * (i % kVec), m = m0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < n) {
      if (c < D)
        x = *reinterpret_cast<const float4*>(job.src + b * job.bs +
                                             m * job.rs + (long long)h * D + c);
      if (job.rows != nullptr) {
        const float xv[4] = {x.x, x.y, x.z, x.w};
        uint32_t hi[4], lo[4];
        f32_tiles::split(xv, hi, lo);
        float* at = job.rows + ((long long)bh * n + m) * kD + c;
        *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at + (long long)BH * n * kD) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    const int p = p_key_slot(r);
    vt[c][p] = x.x;
    vt[c + 1][p] = x.y;
    vt[c + 2][p] = x.z;
    vt[c + 3][p] = x.w;
  }
  if (job.t == nullptr) return;
  __syncthreads();
  for (int i = threadIdx.x; i < 32 * kD; i += blockDim.x) {
    const int c = i / 32, p = i % 32;
    if (m0 + p >= np) continue;
    const float x[1] = {vt[c][p]};
    uint32_t hi[1], lo[1];
    f32_tiles::split(x, hi, lo);
    float* at = job.t + ((long long)bh * kD + c) * np + m0 + p;
    at[0] = __uint_as_float(hi[0]);
    at[(long long)BH * kD * np] = __uint_as_float(lo[0]);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_fwd_f32_ss_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tkh,
                        const __grid_constant__ CUtensorMap tkl,
                        const __grid_constant__ CUtensorMap tvh,
                        const __grid_constant__ CUtensorMap tvl,
                        float* __restrict__ o, float* __restrict__ lse, int H,
                        int N, int M, int Dt, long long o_bs, long long o_rs,
                        float scale, float c) {
  constexpr int S = C::kStages, BK = C::kBK, D = C::kD;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sQh = (base + 1023u) & ~1023u;  // chunk ch at + ch kQChunk
  const uint32_t sQl = sQh + C::kQBytes;
  // stage s at + s kStageBytes: K hi, K lo, V^T hi, V^T lo
  const uint32_t ring = sQl + C::kQBytes;
  const uint32_t full = ring + S * C::kStageBytes;  // stage s's at + 8 s
  const uint32_t empty = full + 8 * S;
  const uint32_t qbar = empty + 8 * S;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * C::kBQ;
  const int tiles = (M + BK - 1) / BK;
  // a consumer warpgroup whose 64 rows all lie past N leaves at once
  const int busy_groups = C::kGroups > 1 && q0 + 64 < N ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * busy_groups);  // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == C::kProducer) {  // the producer
    if (lane == 0) {
      mbar_expect_tx(qbar, C::kQBytes);
      for (int ch = 0; ch < C::kChunks; ++ch)
        tma_load_4d(sQh + ch * C::kQChunk, &tq, qbar, 32 * ch, h, q0, b);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8 * s, ((t / S) - 1) & 1);
        const uint32_t st = ring + s * C::kStageBytes, bar = full + 8 * s;
        mbar_expect_tx(bar, C::kStageBytes);
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load_3d(st + ch * C::kKChunk, &tkh, bar, 32 * ch, BK * t, bh);
          tma_load_3d(st + C::kKBytes + ch * C::kKChunk, &tkl, bar, 32 * ch,
                      BK * t, bh);
        }
        for (int j = 0; j < BK / 32; ++j) {
          const uint32_t vs = st + 2 * C::kKBytes + j * C::kVChunk;
          tma_load_3d(vs, &tvh, bar, BK * t + 32 * j, 0, bh);
          tma_load_3d(vs + C::kVBytes, &tvl, bar, BK * t + 32 * j, 0, bh);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g owns q rows 64 g .. 64 g + 63, its warp wq
  // rows 16 wq .. 16 wq + 15
  const int g = warp >> 2;
  const int wq = warp & 3;
  if (g >= busy_groups) return;
  const int tid = threadIdx.x & 127;
  const uint32_t qh = sQh + g * 64 * 128, ql = sQl + g * 64 * 128;
  mbar_wait(qbar, 0);
  // this warpgroup's Q rows split once: hi in place, lo into Q's lo tile
  for (int ch = 0; ch < C::kChunks; ++ch)
    tf32_gemm::split_tile<128>(
        reinterpret_cast<float4*>(smem_raw + (qh + ch * C::kQChunk - base)),
        reinterpret_cast<float4*>(smem_raw + (ql + ch * C::kQChunk - base)),
        64 * 128 / 16, tid);
  fence_proxy_async();
  named_bar_sync(1 + g, 128);

  float acc[D / 2];  // O: n8 tile j, columns 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max of the raw scores and per-thread partial row sums of the
  // thread's rows r and r + 8
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int t = 0; t < tiles; ++t) {
    const int s = t % S;
    mbar_wait(full + 8 * s, (t / S) & 1);
    __syncwarp();  // converged again for the warpgroup-wide wgmma
    const uint32_t kh = ring + s * C::kStageBytes, kl = kh + C::kKBytes;
    const uint32_t vh = kl + C::kKBytes, vl = vh + C::kVBytes;

    // S = Q K^T: every k step's lo*hi and hi*lo, then hi*hi, chained into
    // one fresh accumulator (the first product's scale-d zeroes it)
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t a = (kk / 4) * C::kQChunk + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * C::kKChunk + (kk % 4) * 32;
      wgmma_ss_tf32(sc, sw128_desc(ql + a, 16), sw128_desc(kh + bo, 16), kk > 0);
      wgmma_ss_tf32(sc, sw128_desc(qh + a, 16), sw128_desc(kl + bo, 16), 1);
    }
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk) {
      const uint32_t a = (kk / 4) * C::kQChunk + (kk % 4) * 32;
      const uint32_t bo = (kk / 4) * C::kKChunk + (kk % 4) * 32;
      wgmma_ss_tf32(sc, sw128_desc(qh + a, 16), sw128_desc(kh + bo, 16), 1);
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

    // O += P V: key block j of P is the C fragment sc[4 j .. 4 j + 3] as
    // wgmma's register A at the permuted k, split once; V^T's hi and lo
    // chunks hold the keys at those slots. The tile's products into a
    // fresh accumulator, added to the rescaled O in round-to-nearest
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float f[4] = {sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]};
      const f32_tiles::SplitA a = f32_tiles::c_as_a(f);
#pragma unroll
      for (int e = 0; e < 4; ++e) ph[j][e] = a.hi[e], pl[j][e] = a.lo[e];
    }
    float part[D / 2];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t vo = (j / 4) * C::kVChunk + (j % 4) * 32;
      wgmma_rs_tf32(part, pl[j], sw128_desc(vh + vo, 16), j > 0);
      wgmma_rs_tf32(part, ph[j], sw128_desc(vl + vo, 16), 1);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const uint32_t vo = (j / 4) * C::kVChunk + (j % 4) * 32;
      wgmma_rs_tf32(part, ph[j], sw128_desc(vh + vo, 16), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(ph);
    fence_regs(pl);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = acc[i] * alpha[(i >> 1) & 1] + part[i];
  }

  // epilogue: O / l, lse = m scale + ln l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * g + 16 * wq + (lane >> 2) + 8 * r;
    if (row >= N) continue;
    const float inv = 1.f / l_run[r];
    float* orow = o + b * o_bs + row * o_rs + (long long)h * Dt;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + 2 * (lane & 3) < Dt)  // no column past d
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(long long)bh * N + row] = m_run[r] * scale + logf(l_run[r]);
  }
}

// The pre-pass into `ws` (fwd_f32_ws_floats at the width), then the main
// kernel; Dt is the head dim (<= the width)
template <class C>
int launch_fwd_f32(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int N, int M, int Dt,
                   long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs,
                   long long o_bs, long long o_rs, float scale, float* ws,
                   cudaStream_t stream) {
  constexpr int D = C::kD;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int BH = B * H, Mp = (M + 7) / 8 * 8;
  float* khi = ws;
  float* klo = khi + (long long)BH * M * D;
  float* vhi = klo + (long long)BH * M * D;
  float* vlo = vhi + (long long)BH * D * Mp;
  CUtensorMap tq, tkh, tkl, tvh, tvl;
  int err = tensor_map(&tq, q, Dt, H, N, B, q_rs, q_bs, C::kBQ, true);
  if (err == 0) err = tensor_map_3d_f32(&tkh, khi, D, M, BH, D, C::kBK);
  if (err == 0) err = tensor_map_3d_f32(&tkl, klo, D, M, BH, D, C::kBK);
  if (err == 0) err = tensor_map_3d_f32(&tvh, vhi, Mp, D, BH, Mp, D);
  if (err == 0) err = tensor_map_3d_f32(&tvl, vlo, Mp, D, BH, Mp, D);
  if (err != 0) return err;
  static unsigned long long smem_set = 0;
  auto kern = flash_fwd_f32_ss_kernel<C>;
  err = allow_smem(kern, C::kSmemBytes, smem_set);
  if (err != 0) return err;
  const SplitJobs<2> jobs = {{{static_cast<const float*>(k), k_bs, k_rs, khi,
                               nullptr, M},
                              {static_cast<const float*>(v), v_bs, v_rs,
                               nullptr, vhi, M}}};
  flash_split_f32_kernel<D, 2><<<dim3((Mp + 31) / 32, BH, 2), 256, 0, stream>>>(
      jobs, H, Dt);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  kern<<<dim3(BH, (N + C::kBQ - 1) / C::kBQ), C::kThreads, C::kSmemBytes,
         stream>>>(tq, tkh, tkl, tvh, tvl, static_cast<float*>(o), lse, H, N,
                   M, Dt, o_bs, o_rs, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5a and K5b in f32, on TF32 wgmma fed by TMA: dQ = scale sum over K/V
// tiles of [P o (dO V^T - delta)] K (K5a), and dV = sum over q tiles of P^T
// dO, dK = scale sum of [P o (dO V^T - delta)]^T Q (K5b), P = exp2(S c -
// lse log2 e), every product 3xTF32 (hi*hi + hi*lo + lo*hi), P and dS f32.
// What bounds them: operations, 6 N M d (K5a) and 8 N M d (K5b) f32 flops,
// three TF32 products each, and one exponential a score in each kernel.
//  * wgmma takes .tf32 operands K-major only. The score products are so as
//    stored (S = Q K^T, dP = dO V^T; S^T = K Q^T, dP^T = V dO^T: both
//    operands d-contiguous). The output products need their B transposed:
//    dQ += dS K takes K^T, dV += P^T dO takes dO^T and dK += dS^T Q takes
//    Q^T, keys (K5a) or q rows (K5b) along the contraction. So the pre-pass
//    (flash_split_f32_kernel, K1/f32's, on four operands) writes once a
//    call, into a workspace the wrapper allocates: Q, dO, K and V split
//    into hi and lo as (B H, rows, d) matrices, and K^T (K5a), Q^T and dO^T
//    (K5b) split and transposed, (B H, d, rows rounded up to 8), each 8-row
//    block at the key slots of P's register A fragment (p_key_slot), zeros
//    past the last row. When the autograd backward runs both kernels, the
//    first call's pre-pass writes what both read.
//  * P and dS (K5a), P^T and dS^T (K5b) are wgmma's register A: each 8-key
//    block of the score fragment is the A fragment at the permuted k
//    (f32_tiles.cuh c_as_a), split once in registers. Neither S nor P
//    touches shared memory.
//  * Shared memory sets the tiles. Every row operand is stored in 16-value
//    chunks in the 64-byte swizzle (sw64_desc): a row takes 192 bytes at
//    d = 40 and 320 at d = 80 (the 128-byte swizzle's 32-value chunks
//    would take 256 and 384, with 24 and 16 zero columns), and a
//    transposed operand 64 bytes (16 slots) a d row. A block is two
//    consumer warpgroups and a producer warp (9 warps: ptxas then allows
//    168 registers). At d = 40 the block keeps 128 rows resident (Q and dO
//    for K5a, K and V for K5b; hi and lo, 96 KB), 64 a warpgroup, and
//    every stage of the stream goes to both warpgroups: K5a two 48-row
//    stages of K, V (hi, lo) and K^T (hi, lo), 51 KB each; K5b two 32-row
//    stages of Q, dO, Q^T and dO^T (hi, lo), 44 KB each. At d = 80, 128
//    resident rows take 160 KB, which leaves no room for two stages, so
//    both warpgroups share 64 resident rows (80 KB) and take the stream's
//    stages in turns (K5a two 32-row stages of 60 KB, K5b three 16-row
//    ones of 40 KB); their two partial sums meet in shared memory at the
//    end, added in round-to-nearest f32, warpgroup 0's first.
//  * Tried on the H100 and not kept (PERF.md §6): at d = 40 the split
//    design and 16-row stages (1.35-1.6x slower), 32-row K5a stages (14 %
//    slower than 48), warp 0 loading in place of a producer warp (eight
//    warps, 255 registers: K5b 37 % slower), A's hi of the scores read
//    once into registers (K5a 8 % faster at 32-row stages, but it and
//    48-row stages need more than 168 registers together), three
//    consumer warpgroups (192 resident rows, K5a's stages 32 rows: no
//    faster than two with 48-row stages); at d = 80, K5a's 16-row stages
//    (four; 17 % slower than two of 32) and 128 resident rows with two
//    16-row stages (as fast).
//  * The grid is (q or k row blocks, B H): the blocks of one (batch, head)
//    run together and share its stream in L2.
//  * The producer's first lane loads the resident operands once and the
//    stages into the ring (mbarriers "full" and "empty", one arrival a
//    consuming warp) with TMA from 3-d maps of the workspace: rows past N
//    or M and slots past the padded length come in as zeros. K5b's
//    producer warp writes each stage's lse log2 e and delta (zero past N)
//    beside it; its 32 lanes arrive on "full".
//  * A stage: S and dP, each the d / 8 k steps' lo*hi and hi*lo, then
//    hi*hi, chained into a fresh accumulator (wgmma m64nkBSk8, both
//    operands by descriptor); P and dS in registers (P masked to 0 past M
//    in K5a, past N in K5b); then each output product, the stage's
//    kBS / 8 k steps' three products into a fresh accumulator (m64n(d)k8,
//    A the split score fragment, B the transposed tile), added to the
//    running f32 sum in round-to-nearest. The tensor cores truncate where
//    they add into their accumulator, so no chain runs over M or N.
//  * Registers: the running sums (d / 2 a thread each), a fresh one, the
//    score fragments and their split, within the 168 of nine warps.

//  * d = 64 (num_heads 5's 64^2 sites): as d = 80, both warpgroups on 64
//    resident rows. d = 128 and 160 (num_heads 5's 32^2 sites, SD-1.4's
//    24^2 sites at 768^2): 64 resident rows take 128 or 160 KB hi and lo,
//    and the running sums d / 2 registers each beside a fresh accumulator
//    of d / 2, more than the 168 of nine warps: one consumer warpgroup and
//    the producer warp (five warps, 255 registers), 16-row stages. K5b
//    there runs as two launches over the stream, dV (P^T against dO^T:
//    its stage holds Q's rows and dO^T, its residents K alone), then dK
//    (dS^T against Q^T: Q's and dO's rows and Q^T, residents K and V): a
//    stage of both, eight operands of 16 rows, would not fit beside the
//    resident K and V at d = 160, nor would both sums and a fresh one in
//    255 registers. The scores are computed once in the first launch and
//    twice in the second.
//  * Any d up to the width (40, 64, 80, 128, 160; d % 4 == 0): the pre-pass
//    writes zeros past d into the workspace's width-wide rows and
//    transposed rows, and only columns < d are stored.

// kD: the width (40, 64, 80, 128 or 160); kBS: rows of a streamed stage (16
// to 64); kStages: the ring's depth; kSplit: both warpgroups share 64
// resident rows and take the stages in turns (else 64 resident rows a
// warpgroup, and every stage goes to each); kDkv: K5b (else K5a); kGroups:
// consumer warpgroups (1 or 2); kPass (K5b): 0 dK and dV, 1 dV alone, 2
// dK alone
template <int kD_, int kBS_, int kStages_, bool kSplit_, bool kDkv_,
          int kGroups_ = 2, int kPass_ = 0>
struct BwdF32W {
  static constexpr int kD = kD_, kBS = kBS_, kStages = kStages_,
                       kGroups = kGroups_, kPass = kPass_;
  static constexpr bool kSplit = kSplit_, kDkv = kDkv_;
  static constexpr int kChunks = (kD + 15) / 16;  // 16-value chunks a row
  static constexpr int kSteps = kD / 8;           // the scores' k steps
  static constexpr int kRes = kSplit ? 64 : 64 * kGroups;  // resident rows
  static constexpr int kProducer = 4 * kGroups;   // the producer warp
  static constexpr int kThreads = 32 * (kProducer + 1);
  // K5b's dV pass reads one resident operand (K) and one row operand (Q)
  // of the stream, hi and lo each; the others two (K5a: Q and dO resident,
  // K and V streamed; K5b: K and V, Q and dO)
  static constexpr bool kDvOnly = kDkv && kPass == 1;
  static constexpr int kNRes = kDvOnly ? 2 : 4;   // resident hi/lo tiles
  static constexpr int kNRows = kDvOnly ? 2 : 4;  // a stage's row tiles
  static constexpr uint32_t kResChunk = kRes * 64;
  static constexpr uint32_t kResBytes = kChunks * kResChunk;  // one resident tile
  static constexpr uint32_t kRowChunk = kBS * 64;
  static constexpr uint32_t kRowBytes = kChunks * kRowChunk;  // one row tile
  static constexpr uint32_t kTChunk = kD * 64;                // 16 slots x d rows
  static constexpr uint32_t kTBytes = kBS / 16 * kTChunk;     // a transposed tile
  // transposed tiles a stage (K5a K^T; K5b Q^T then dO^T, one of them
  // alone in a pass) and the first one's index in the workspace's
  static constexpr int kNT = kDkv && kPass == 0 ? 4 : 2;
  static constexpr int kT0 = kDvOnly ? 2 : 0;
  static constexpr uint32_t kStageBytes = kNRows * kRowBytes + kNT * kTBytes;
  static constexpr uint32_t kStatBytes = kDkv ? 2 * kBS * 4 : 0;
  // 1024 bytes of slack to align the swizzled tiles, then the resident
  // operands (K5a: Q hi, Q lo, dO hi, dO lo; K5b: K and V), the ring (a
  // stage: K5a K and V, K5b Q and dO, hi and lo, then the transposed
  // tiles), the stages' statistics (K5b), the mbarriers
  static constexpr size_t kSmemBytes = 1024 + kNRes * kResBytes +
                                       kStages * (kStageBytes + kStatBytes) +
                                       8 * (2 * kStages + 1);
  static constexpr int kOutCols = kD;   // an output product's columns
  static constexpr int kTBoxRows = kD;  // rows of a transposed tile's box
  static constexpr bool kStream = false;
  static_assert(kD % 8 == 0 && kBS % 16 == 0 && kBS <= 64, "tiles");
  static_assert(!kSplit || kGroups == 2, "kSplit shares 64 rows between two");
  static_assert(kStageBytes % 512 == 0 && kTChunk % 512 == 0, "swizzle atoms");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
  static_assert(!kSplit || kStages * kStageBytes >=
                               (kDkv ? 2u : 1u) * 128 * (kD / 2) * 4,
                "the partial sums fit the ring");
};

using DqF40 = BwdF32W<40, 48, 2, false, false>;   // 199 KB
using DqF64 = BwdF32W<64, 32, 3, true, false>;    // 209 KB
using DqF80 = BwdF32W<80, 32, 2, true, false>;    // 201 KB
using DqF128 = BwdF32W<128, 16, 2, false, false, 1>;   // 225 KB
using DqF160 = BwdF32W<160, 16, 1, false, false, 1>;   // 221 KB
using DkvF40 = BwdF32W<40, 32, 2, false, true>;   // 186 KB
using DkvF64 = BwdF32W<64, 16, 4, true, true>;    // 194 KB
using DkvF80 = BwdF32W<80, 16, 3, true, true>;    // 201 KB
using DvF128 = BwdF32W<128, 16, 4, false, true, 1, 1>;   // 194 KB
using DkF128 = BwdF32W<128, 16, 2, false, true, 1, 2>;   // 225 KB
using DvF160 = BwdF32W<160, 16, 3, false, true, 1, 1>;   // 201 KB
using DkF160 = BwdF32W<160, 16, 1, false, true, 1, 2>;   // 221 KB

template <class C>
struct BwdF32Smem {
  uint32_t base, res, ring, full, empty, rbar;
  float* stats;
  float* scratch;  // the ring, as f32 values (kSplit's partial sums)
  __device__ explicit BwdF32Smem(unsigned char* raw) {
    base = smem_u32(raw);
    res = (base + 1023u) & ~1023u;  // resident tile i at + i kResBytes
    ring = res + C::kNRes * C::kResBytes;  // stage s at + s kStageBytes
    scratch = reinterpret_cast<float*>(raw + (ring - base));
    const uint32_t st = ring + C::kStages * C::kStageBytes;
    stats = reinterpret_cast<float*>(raw + (st - base));  // stage s at + 2 s kBS
    full = st + C::kStages * C::kStatBytes;  // stage s's mbarrier at + 8 s
    empty = full + 8 * C::kStages;
    rbar = empty + 8 * C::kStages;
  }
};

// The resident operands (rows r0.. of tres' matrices op B H + bh, op <
// kNRes) into shared memory, once; the loading lane
template <class C>
__device__ __forceinline__ void bwd_f32_load_resident(const BwdF32Smem<C>& sm,
                                                      const CUtensorMap* tres,
                                                      int bh, int BH, int r0) {
  mbar_expect_tx(sm.rbar, C::kNRes * C::kResBytes);
  for (int op = 0; op < C::kNRes; ++op)
    for (int ch = 0; ch < C::kChunks; ++ch)
      tma_load_3d(sm.res + op * C::kResBytes + ch * C::kResChunk, tres,
                  sm.rbar, 16 * ch, r0, op * BH + bh);
}

// Stage t % kStages, once its last readers left: rows BS t.. of trows'
// matrices op B H + bh (op < kNRows) and the kNT transposed tiles (slots
// BS t.. of tt's matrices (kT0 + op) B H + bh); a warp calls it, lane 0
// loads. In K5b the
// warp's lanes first write the stage's lse log2 e and delta (of rows < n,
// else zero) and arrive on "full" with lane 0's transaction bytes.
template <class C>
__device__ __forceinline__ void bwd_f32_load_stage(
    const BwdF32Smem<C>& sm, const CUtensorMap* trows, const CUtensorMap* tt,
    int t, int bh, int BH, const float* lse_bh, const float* delta_bh, int n,
    int lane) {
  constexpr int S = C::kStages, BS = C::kBS;
  const int s = t % S;
  if (t >= S) mbar_wait(sm.empty + 8 * s, ((t / S) - 1) & 1);
  const uint32_t bar = sm.full + 8 * s;
  if constexpr (C::kDkv) {
    float* st = sm.stats + s * 2 * BS;
    for (int i = lane; i < BS; i += 32) {
      const int row = BS * t + i;
      const bool in = row < n;
      st[i] = in ? lse_bh[row] * kLog2e : 0.f;
      st[BS + i] = in ? delta_bh[row] : 0.f;
    }
  }
  if (lane == 0) {
    mbar_expect_tx(bar, C::kStageBytes);
    const uint32_t st = sm.ring + s * C::kStageBytes;
    for (int op = 0; op < C::kNRows; ++op)
      for (int ch = 0; ch < C::kChunks; ++ch)
        tma_load_3d(st + op * C::kRowBytes + ch * C::kRowChunk, trows, bar,
                    16 * ch, BS * t, op * BH + bh);
    for (int op = 0; op < C::kNT; ++op)
      for (int j = 0; j < BS / 16; ++j)
        tma_load_3d(st + C::kNRows * C::kRowBytes + op * C::kTBytes +
                        j * C::kTChunk,
                    tt, bar, BS * t + 16 * j, 0, (C::kT0 + op) * BH + bh);
  } else if (C::kDkv) {
    mbar_arrive(bar);
  }
}

// (The descriptors are made from one base each by adding the offset to
// the address field: the tiles lie inside the 256 KB window, so no carry
// leaves it. The callers pass bases through `opaque` each iteration, so
// ptxas does not keep every loop-invariant descriptor of the resident
// operands in registers across the loop.)

// S (64 x kBS) = A B^T in 3xTF32, chained into a fresh accumulator (or,
// not `fresh`, added to the chain in s): A this warpgroup's 64 rows of a
// resident operand (hi at `a`, lo one operand on), B a stage's row operand
// (hi at `b`, lo one operand on), both by descriptor; every k step's lo*hi
// and hi*lo, then hi*hi
template <class C, int N>
__device__ __forceinline__ void scores_f32(float (&s)[N], uint32_t a, uint32_t b,
                                           bool fresh = true) {
  static_assert(N == C::kBS / 2, "a kBS-wide score fragment");
  const uint64_t ah = sw64_desc(a), al = sw64_desc(a + C::kResBytes);
  const uint64_t bh = sw64_desc(b), bl = sw64_desc(b + C::kRowBytes);
#pragma unroll
  for (int kk = 0; kk < C::kSteps; ++kk) {
    const uint32_t ao = ((kk / 2) * C::kResChunk + (kk % 2) * 32) >> 4;
    const uint32_t bo = ((kk / 2) * C::kRowChunk + (kk % 2) * 32) >> 4;
    wgmma_ss_tf32(s, al + ao, bh + bo, kk > 0 || !fresh);
    wgmma_ss_tf32(s, ah + ao, bl + bo, 1);
  }
#pragma unroll
  for (int kk = 0; kk < C::kSteps; ++kk) {
    const uint32_t ao = ((kk / 2) * C::kResChunk + (kk % 2) * 32) >> 4;
    const uint32_t bo = ((kk / 2) * C::kRowChunk + (kk % 2) * 32) >> 4;
    wgmma_ss_tf32(s, ah + ao, bh + bo, 1);
  }
}

// x, which the compiler may not take for a loop invariant
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// A score fragment as wgmma's register A, split: key block j of `s` (its
// values 4 j .. 4 j + 3) at the permuted k (c_as_a)
template <int N>
__device__ __forceinline__ void split_frag(uint32_t (&hi)[N / 4][4],
                                           uint32_t (&lo)[N / 4][4],
                                           const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float f[4] = {s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]};
    const f32_tiles::SplitA a = f32_tiles::c_as_a(f);
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[j][e] = a.hi[e], lo[j][e] = a.lo[e];
  }
}

// D (64 x kD, or the d-streamed kernel's 64 x kPartCols) = A B over a
// stage's kBS keys (K5b: q rows) in 3xTF32, into a fresh accumulator: A the
// split score fragment, B the transposed tile at `t` (hi; lo one tile on),
// k step j at its slots 8 j .. 8 j + 7
template <class C, int N, int K>
__device__ __forceinline__ void product_f32(float (&d)[N],
                                            const uint32_t (&hi)[K][4],
                                            const uint32_t (&lo)[K][4],
                                            uint32_t t) {
  static_assert(N == C::kOutCols / 2 && K == C::kBS / 8, "shapes");
  const uint64_t th = sw64_desc(t), tl = sw64_desc(t + C::kTBytes);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t o = ((j / 2) * C::kTChunk + (j % 2) * 32) >> 4;
    wgmma_rs_tf32(d, lo[j], th + o, j > 0);
    wgmma_rs_tf32(d, hi[j], tl + o, 1);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint32_t o = ((j / 2) * C::kTChunk + (j % 2) * 32) >> 4;
    wgmma_rs_tf32(d, hi[j], th + o, 1);
  }
}

// kSplit: warpgroup 1's partial sums `a` (and `b`) added to warpgroup 0's
// through x, the idle ring (thread i of each holds the same elements);
// true on warpgroup 0, which then holds the sums
template <int N>
__device__ __forceinline__ bool sum_split(float (&a)[N], float (&b)[N],
                                          int nb, float* x, int g, int tid) {
  named_bar_sync(1, 256);  // both warpgroups are done with the ring
  if (g == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i * 128 + tid] = a[i];
      if (nb) x[(N + i) * 128 + tid] = b[i];
    }
  }
  named_bar_sync(1, 256);
  if (g == 1) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i] += x[i * 128 + tid];
    if (nb) b[i] += x[(N + i) * 128 + tid];
  }
  return true;
}

// this thread's rows row0 and row0 + 8 of a 64 x kD f32 sum (times mul)
// into a contiguous (rows, H*D) f32 output, rows < limit, columns < D
template <int N>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[N], float* out,
                                               long long hd, int row0,
                                               int limit, int D, float mul,
                                               int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= limit) continue;
    float* orow = out + row * hd;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      if (8 * j + 2 * (lane & 3) < D)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// the barriers of both kernels: "full" (one arrival, K5b the producer
// warp's 32), "empty" (one arrival a consuming warp), the resident load's
template <class C>
__device__ __forceinline__ void bwd_f32_init(const BwdF32Smem<C>& sm, int busy) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.full + 8 * s, C::kDkv ? 32 : 1);
      mbar_init(sm.empty + 8 * s, C::kSplit ? 4 : 4 * busy);
    }
    mbar_init(sm.rbar, 1);
    mbar_init_fence();
  }
  __syncthreads();
}

// K5a: tres maps Q and dO (hi, lo) of the workspace, trows K and V, tt K^T
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dq_f32_ss_kernel(const __grid_constant__ CUtensorMap tres,
                           const __grid_constant__ CUtensorMap trows,
                           const __grid_constant__ CUtensorMap tt,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int N, int M,
                           int Dt, float scale, float c) {
  constexpr int S = C::kStages, BS = C::kBS, D = C::kD;
  extern __shared__ unsigned char smem_raw[];
  const BwdF32Smem<C> sm(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * C::kRes;
  const int tiles = (M + BS - 1) / BS;
  // without kSplit a warpgroup whose 64 rows all lie past N leaves at once
  const int busy = C::kGroups > 1 && (C::kSplit || q0 + 64 < N) ? 2 : 1;
  bwd_f32_init(sm, busy);
  if (warp == C::kProducer) {  // the producer warp
    if (lane == 0) bwd_f32_load_resident(sm, &tres, bh, BH, q0);
    for (int t = 0; t < tiles; ++t)
      bwd_f32_load_stage(sm, &trows, &tt, t, bh, BH, nullptr, nullptr, N, lane);
    return;
  }

  const int g = warp >> 2;
  const int wq = warp & 3;
  if (g >= busy) return;
  const int tid = threadIdx.x & 127;
  const int rb = C::kSplit ? 0 : 64 * g;  // this warpgroup's resident rows
  // this thread's rows row0 and row0 + 8: their lse (times log2 e) and
  // delta, zero past N (those rows are zero in Q and dO, never written)
  const int row0 = q0 + rb + 16 * wq + (lane >> 2);
  float l2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row0 + 8 * r < N;
    const long long i = (long long)bh * N + row0 + 8 * r;
    l2[r] = in ? lse[i] * kLog2e : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t qa = sm.res + rb * 64, da = qa + 2 * C::kResBytes;
  mbar_wait(sm.rbar, 0);

  for (int t = C::kSplit ? g : 0; t < tiles; t += C::kSplit ? 2 : 1) {
    const int s = t % S;
    mbar_wait(sm.full + 8 * s, (t / S) & 1);
    __syncwarp();  // converged again for the warpgroup-wide wgmma
    const uint32_t st = sm.ring + s * C::kStageBytes;

    // S = Q K^T, dP = dO V^T
    float sc[BS / 2], dp[BS / 2];
    wgmma_fence();
    scores_f32<C>(sc, opaque(qa), st);
    scores_f32<C>(dp, opaque(da), st + 2 * C::kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp2(S c - lse log2 e), 0 past M; dS = P (dP - delta)
    const int k0 = t * BS;
    if (k0 + BS > M)
      ds_rows<true>(sc, dp, l2, dl, c, M - k0, lane);
    else
      ds_rows<false>(sc, dp, l2, dl, c, BS, lane);

    // dQ += dS K: K^T's hi and lo tiles after the stage's rows
    uint32_t ah[BS / 8][4], al[BS / 8][4];
    split_frag(ah, al, sc);
    float part[D / 2];
    wgmma_fence();
    product_f32<C>(part, ah, al, st + 4 * C::kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + 8 * s);  // this warp is done with it
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
  }

  if (C::kSplit && !sum_split(acc, acc, 0, sm.scratch, g, tid)) return;
  const long long hd = (long long)H * Dt;  // row stride of dQ
  store_rows_f32(acc, dq + (long long)b * N * hd + (long long)h * Dt, hd, row0,
                 N, Dt, scale, lane);
}

// K5b: tres maps K and V (hi, lo) of the workspace, trows Q and dO, tt Q^T
// and dO^T
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dkv_f32_ss_kernel(const __grid_constant__ CUtensorMap tres,
                            const __grid_constant__ CUtensorMap trows,
                            const __grid_constant__ CUtensorMap tt,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int N, int M, int Dt, float scale,
                            float c) {
  constexpr int S = C::kStages, BS = C::kBS, D = C::kD;
  constexpr bool kDoV = C::kPass != 2, kDoK = C::kPass != 1;
  extern __shared__ unsigned char smem_raw[];
  const BwdF32Smem<C> sm(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * C::kRes;
  const int tiles = (N + BS - 1) / BS;
  const int busy = C::kGroups > 1 && (C::kSplit || k0 + 64 < M) ? 2 : 1;
  bwd_f32_init(sm, busy);
  const float* lse_bh = lse + (long long)bh * N;
  const float* delta_bh = delta + (long long)bh * N;
  if (warp == C::kProducer) {  // the producer warp
    if (lane == 0) bwd_f32_load_resident(sm, &tres, bh, BH, k0);
    for (int t = 0; t < tiles; ++t)
      bwd_f32_load_stage(sm, &trows, &tt, t, bh, BH, lse_bh, delta_bh, N, lane);
    return;
  }

  const int g = warp >> 2;
  const int wk = warp & 3;
  if (g >= busy) return;
  const int tid = threadIdx.x & 127;
  const int rb = C::kSplit ? 0 : 64 * g;  // this warpgroup's resident rows
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  const uint32_t ka = sm.res + rb * 64, va = ka + 2 * C::kResBytes;
  mbar_wait(sm.rbar, 0);

  for (int t = C::kSplit ? g : 0; t < tiles; t += C::kSplit ? 2 : 1) {
    const int s = t % S;
    mbar_wait(sm.full + 8 * s, (t / S) & 1);
    __syncwarp();
    const uint32_t st = sm.ring + s * C::kStageBytes;
    // the transposed tiles after the rows: Q^T (dK), then dO^T (dV)
    const uint32_t qt = st + C::kNRows * C::kRowBytes;
    const uint32_t dot = kDoK ? qt + 2 * C::kTBytes : qt;

    // S^T = K Q^T, and for dK dP^T = V dO^T
    float sc[BS / 2], dp[BS / 2];
    wgmma_fence();
    scores_f32<C>(sc, opaque(ka), st);
    if constexpr (kDoK) scores_f32<C>(dp, opaque(va), st + 2 * C::kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if constexpr (kDoK) fence_regs(dp);

    // P^T = exp2(S^T c - lse log2 e), 0 past N; dS^T = P^T (dP^T - delta)
    const float* stat = sm.stats + s * 2 * BS;
    const int q0 = t * BS;
    if (q0 + BS > N)
      p_ds_cols<true, BS / 2, kDoK>(sc, dp, stat, c, N - q0, lane);
    else
      p_ds_cols<false, BS / 2, kDoK>(sc, dp, stat, c, BS, lane);

    // dV += P^T dO (dO^T's tiles), then dK += dS^T Q (Q^T's), each into a
    // fresh accumulator
    float part[D / 2];
    if constexpr (kDoV) {
      uint32_t ah[BS / 8][4], al[BS / 8][4];
      split_frag(ah, al, sc);
      wgmma_fence();
      product_f32<C>(part, ah, al, dot);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_v[i] += part[i];
    }
    if constexpr (kDoK) {
      uint32_t ah[BS / 8][4], al[BS / 8][4];
      split_frag(ah, al, dp);
      wgmma_fence();
      product_f32<C>(part, ah, al, qt);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
      fence_regs(ah);
      fence_regs(al);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty + 8 * s);
    if constexpr (kDoK) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc_k[i] += part[i];
    }
  }

  if (C::kSplit && !sum_split(acc_v, acc_k, 1, sm.scratch, g, tid)) return;
  const long long hd = (long long)H * Dt;  // row stride of dK and dV
  const long long off = (long long)b * M * hd + (long long)h * Dt;
  const int row0 = k0 + rb + 16 * wk + (lane >> 2);
  if (kDoV) store_rows_f32(acc_v, dv + off, hd, row0, M, Dt, 1.f, lane);
  if (kDoK) store_rows_f32(acc_k, dk + off, hd, row0, M, Dt, scale, lane);
}

// ---------------------------------------------------------------------------
// K5a/f32 and K5b/f32 past d = 160 (widths 256 and 320: num_heads 5's 24^2
// sites at 768^2, num_heads 2's 32^2 sites at 512^2). The kernels above
// keep 64 rows of the scores' first operands resident in hi and lo: at
// d = 256 Q and dO take 4 x 64 x 256 x 4 bytes = 256 KB, past a block's
// 227 KB. So this kernel keeps nothing resident and streams the score
// contraction over d, as K1/f32 at d = 512 streams its depth:
//  * One consumer warpgroup owns 64 output rows (K5a: q rows and dQ; K5b:
//    k rows and dV or dK) and the producer warp feeds it a ring of equal
//    stages with TMA from the same workspace maps. The stream is a
//    sequence of items: for each tile of kBS = 16 keys (K5a) or q rows
//    (K5b), d / 32 score items, each the 32 columns i of the block's 64
//    rows and of the tile's 16, hi and lo, of both score products (K5a: Q,
//    dO and K, V; K5b's dK pass K, V and Q, dO; its dV pass K and Q), then
//    one output item, the tile's transposed operand (K5a K^T; K5b Q^T or
//    dO^T) whole, hi and lo, with (K5b) the tile's lse log2 e and delta.
//    Both items take 40 KB at d = 320, so five stages fit (201 KB).
//  * The score items chain into one accumulator each (S and dP, 64 x 16):
//    an item's k steps' lo*hi and hi*lo, then their hi*hi, as the kernels
//    above chain a whole row's; one chain over d is as deep at d = 320
//    as theirs at 160 (40 steps, 120 products: no chain runs over M or N).
//  * At the output item P and dS (or P^T, dS^T) come from the chains as
//    above, split once as register A, and the output product runs over
//    the accumulator's columns in parts of kPartCols, each over the tile's
//    keys into a fresh accumulator added in round-to-nearest f32: the
//    running sum (d / 2 registers) and one part fit the 255 registers of
//    five warps. K5b runs as two launches, dV then dK, as at 128 and 160.
//  * What bounds it: not the tensor cores. The 64 rows' operands are read
//    again from L2 for every 16-key tile (4 x 64 x d x 4 bytes), so a
//    tile moves 320 KB at d = 320 for 3 x 2 x 64 x 16 x 320 x 2 flops of
//    scores: L2's bandwidth sets its time. It is the simple design that
//    fits; a faster one is later work.

// kD: the width (256 or 320); kStages: the ring's depth; kPartCols: the
// output product's columns a wgmma (64 or 32); kDkv: K5b (else K5a);
// kPass (K5b): 1 dV, 2 dK
template <int kD_, int kStages_, int kPartCols_, bool kDkv_, int kPass_ = 0>
struct BwdF32S {
  static constexpr int kD = kD_, kStages = kStages_, kOutCols = kPartCols_,
                       kPass = kPass_;
  static constexpr bool kDkv = kDkv_, kStream = true;
  static constexpr int kBS = 16;            // keys (K5b: q rows) a tile
  static constexpr int kDC = 32;            // the scores' depth an item
  static constexpr int kItems = kD / kDC;   // score items a tile
  static constexpr int kRes = 64;           // output rows a block
  static constexpr int kProducer = 4;       // the producer warp
  static constexpr int kThreads = 32 * (kProducer + 1);
  static constexpr bool kDvOnly = kDkv && kPass == 1;
  static constexpr int kNX = kDvOnly ? 1 : 2;  // score products an item
  static constexpr int kSteps = kDC / 8;       // an item's k steps
  // an item's 64 rows of a first operand (hi; lo one tile on), in 16-value
  // chunks, and its tile's rows of a second operand, in the 64-byte swizzle
  static constexpr uint32_t kResChunk = kRes * 64;
  static constexpr uint32_t kResBytes = kDC / 16 * kResChunk;
  static constexpr uint32_t kRowChunk = kBS * 64;
  static constexpr uint32_t kRowBytes = kDC / 16 * kRowChunk;
  static constexpr uint32_t kTChunk = kD * 64;             // 16 slots x d rows
  static constexpr uint32_t kTBytes = kBS / 16 * kTChunk;  // hi; lo after
  static constexpr int kTBoxRows = 64;  // a TMA box holds at most 256 rows
  static constexpr int kT0 = kDvOnly ? 2 : 0;  // dO^T's index, else Q^T/K^T's
  static constexpr uint32_t kScoreBytes = 2 * kNX * (kResBytes + kRowBytes);
  static constexpr uint32_t kOutBytes = 2 * kTBytes;
  static constexpr uint32_t kStageBytes =
      kScoreBytes > kOutBytes ? kScoreBytes : kOutBytes;
  static constexpr uint32_t kStatBytes = kDkv ? 2 * kBS * 4 : 0;
  static constexpr size_t kSmemBytes =
      1024 + kStages * (kStageBytes + kStatBytes) + 8 * (2 * kStages);
  static_assert(kD % 64 == 0 && kD % kDC == 0 && kD % kOutCols == 0, "tiles");
  static_assert(kStageBytes % 1024 == 0, "swizzle atoms");
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
  static_assert(kDkv ? kPass != 0 : kPass == 0, "K5b in two passes");
};

using DqS256 = BwdF32S<256, 5, 64, false>;      // 201 KB
using DvS256 = BwdF32S<256, 6, 64, true, 1>;    // 194 KB
using DkS256 = BwdF32S<256, 5, 64, true, 2>;    // 202 KB
using DqS320 = BwdF32S<320, 5, 32, false>;      // 201 KB
using DvS320 = BwdF32S<320, 5, 32, true, 1>;    // 202 KB
using DkS320 = BwdF32S<320, 5, 32, true, 2>;    // 202 KB

// The body of both kernels below: tres maps the workspace's first
// operands (K5a Q, dO; K5b K, V; hi, lo), trows the second (K5a K, V; K5b
// Q, dO), tt the transposed (K5a K^T; K5b Q^T, dO^T); out is dQ (K5a), dV
// (K5b's pass 1) or dK (its pass 2)
template <class C>
__device__ __forceinline__ void bwd_f32_stream(const CUtensorMap& tres,
                                               const CUtensorMap& trows,
                                               const CUtensorMap& tt,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* __restrict__ out, int H,
                                               int N, int M, int Dt,
                                               float scale, float c) {
  constexpr int S = C::kStages, BS = C::kBS, D = C::kD, I = C::kItems;
  constexpr int P = C::kOutCols;
  constexpr bool kDoK = C::kDkv && C::kPass == 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023u) & ~1023u;  // stage s at + s kStageBytes
  const uint32_t st0 = ring + S * C::kStageBytes;
  float* stats = reinterpret_cast<float*>(smem_raw + (st0 - base));
  const uint32_t full = st0 + S * C::kStatBytes;  // stage s's mbarrier at + 8 s
  const uint32_t empty = full + 8 * S;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y, BH = gridDim.y;
  const int b = bh / H;
  const int h = bh % H;
  const int r0 = blockIdx.x * C::kRes;  // the block's output rows
  const int len = C::kDkv ? N : M;      // the stream's rows
  const int tiles = (len + BS - 1) / BS;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // K5b: the producer warp's 32 lanes arrive, the statistics written
      mbar_init(full + 8 * s, C::kDkv ? 32 : 1);
      mbar_init(empty + 8 * s, 4);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == C::kProducer) {  // the producer warp: lane 0 loads
    int item = 0;
    for (int t = 0; t < tiles; ++t) {
      for (int i = 0; i <= I; ++i, ++item) {
        const int s = item % S;
        if (item >= S) mbar_wait(empty + 8 * s, ((item / S) - 1) & 1);
        const uint32_t bar = full + 8 * s, st = ring + s * C::kStageBytes;
        if (C::kDkv && i == I) {  // the tile's lse log2 e and delta, 0 past N
          float* sst = stats + s * 2 * BS;
          for (int j = lane; j < BS; j += 32) {
            const int row = BS * t + j;
            const bool in = row < N;
            sst[j] = in ? lse[(long long)bh * N + row] * kLog2e : 0.f;
            sst[BS + j] = in ? delta[(long long)bh * N + row] : 0.f;
          }
        }
        if (lane == 0) {
          if (i < I) {  // score item i: 32 columns of each operand, hi, lo
            mbar_expect_tx(bar, C::kScoreBytes);
            const uint32_t sy = st + 2 * C::kNX * C::kResBytes;
            for (int op = 0; op < 2 * C::kNX; ++op)
              for (int ch = 0; ch < C::kDC / 16; ++ch) {
                const int col = C::kDC * i + 16 * ch;
                tma_load_3d(st + op * C::kResBytes + ch * C::kResChunk, &tres,
                            bar, col, r0, op * BH + bh);
                tma_load_3d(sy + op * C::kRowBytes + ch * C::kRowChunk, &trows,
                            bar, col, BS * t, op * BH + bh);
              }
          } else {      // the output item: the tile's transposed operand
            mbar_expect_tx(bar, C::kOutBytes);
            for (int op = 0; op < 2; ++op)
              for (int j = 0; j < BS / 16; ++j)
                for (int rr = 0; rr < D / C::kTBoxRows; ++rr)
                  tma_load_3d(st + op * C::kTBytes + j * C::kTChunk +
                                  rr * C::kTBoxRows * 64,
                              &tt, bar, BS * t + 16 * j, C::kTBoxRows * rr,
                              (C::kT0 + op) * BH + bh);
          }
        } else if (C::kDkv) {
          mbar_arrive(bar);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: its warp w owns rows 16 w .. 16 w + 15
  const int row0 = r0 + 16 * warp + (lane >> 2);
  // K5a: this thread's rows' lse (times log2 e) and delta, zero past N
  // (those rows are zero in Q and dO, never written)
  float l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if constexpr (!C::kDkv) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row0 + 8 * r < N;
      const long long i = (long long)bh * N + row0 + 8 * r;
      l2[r] = in ? lse[i] * kLog2e : 0.f;
      dl[r] = in ? delta[i] : 0.f;
    }
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  int item = 0;
  for (int t = 0; t < tiles; ++t) {
    // S = Q K^T, dP = dO V^T (K5b: S^T = K Q^T, dP^T = V dO^T), item by item
    float sc[BS / 2], dp[BS / 2];
    for (int i = 0; i < I; ++i, ++item) {
      const int s = item % S;
      mbar_wait(full + 8 * s, (item / S) & 1);
      __syncwarp();  // converged again for the warpgroup-wide wgmma
      const uint32_t st = ring + s * C::kStageBytes;
      const uint32_t sy = st + 2 * C::kNX * C::kResBytes;
      wgmma_fence();
      scores_f32<C>(sc, opaque(st), sy, i == 0);
      if constexpr (C::kNX == 2)
        scores_f32<C>(dp, opaque(st + 2 * C::kResBytes), sy + 2 * C::kRowBytes,
                      i == 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if constexpr (C::kNX == 2) fence_regs(dp);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // the output item
    const int s = item % S;
    mbar_wait(full + 8 * s, (item / S) & 1);
    __syncwarp();
    const uint32_t tb = ring + s * C::kStageBytes;
    const int t0 = t * BS;
    uint32_t ah[BS / 8][4], al[BS / 8][4];
    if constexpr (!C::kDkv) {
      // P = exp2(S c - lse log2 e), 0 past M; dS = P (dP - delta), in sc
      if (t0 + BS > M)
        ds_rows<true>(sc, dp, l2, dl, c, M - t0, lane);
      else
        ds_rows<false>(sc, dp, l2, dl, c, BS, lane);
      split_frag(ah, al, sc);
    } else {
      // P^T = exp2(S^T c - lse log2 e), 0 past N; dS^T = P^T (dP^T - delta)
      const float* stat = stats + s * 2 * BS;
      if (t0 + BS > N)
        p_ds_cols<true, BS / 2, kDoK>(sc, dp, stat, c, N - t0, lane);
      else
        p_ds_cols<false, BS / 2, kDoK>(sc, dp, stat, c, BS, lane);
      if constexpr (kDoK) split_frag(ah, al, dp);  // dK += dS^T Q
      else split_frag(ah, al, sc);                 // dV += P^T dO
    }
    // the output's columns P at a time, each into a fresh accumulator
#pragma unroll
    for (int p = 0; p < D / P; ++p) {
      float part[P / 2];
      wgmma_fence();
      product_f32<C>(part, ah, al, tb + p * P * 64);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < P / 2; ++e) acc[p * (P / 2) + e] += part[e];
    }
    fence_regs(ah);
    fence_regs(al);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    ++item;
  }

  const long long hd = (long long)H * Dt;  // row stride of the output
  const int rows = C::kDkv ? M : N;
  store_rows_f32(acc, out + (long long)b * rows * hd + (long long)h * Dt, hd,
                 row0, rows, Dt, C::kDkv && !kDoK ? 1.f : scale, lane);
}

// K5a/f32 past d = 160: dQ
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dq_f32_stream_kernel(const __grid_constant__ CUtensorMap tres,
                               const __grid_constant__ CUtensorMap trows,
                               const __grid_constant__ CUtensorMap tt,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int H, int N, int M,
                               int Dt, float scale, float c) {
  static_assert(!C::kDkv, "K5a");
  bwd_f32_stream<C>(tres, trows, tt, lse, delta, dq, H, N, M, Dt, scale, c);
}

// K5b/f32 past d = 160: dV (C::kPass 1) or dK (2)
template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
flash_bwd_dkv_f32_stream_kernel(const __grid_constant__ CUtensorMap tres,
                                const __grid_constant__ CUtensorMap trows,
                                const __grid_constant__ CUtensorMap tt,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ out, int H, int N, int M,
                                int Dt, float scale, float c) {
  static_assert(C::kDkv, "K5b");
  bwd_f32_stream<C>(tres, trows, tt, lse, delta, out, H, N, M, Dt, scale, c);
}

// The workspace of K5a and K5b in f32, in floats, at the width D: Q and dO
// split (hi, lo each: four (B H, N, D) blocks), K and V split (four (B H,
// M, D)), K^T split (two (B H, D, Mp)), Q^T and dO^T split (four (B H, D,
// Np))
long long bwd_f32_ws_floats(int B, int H, int N, int M, int D) {
  const long long np = (N + 7) / 8 * 8, mp = (M + 7) / 8 * 8;
  return (long long)B * H * D * (4ll * N + 4ll * M + 2 * mp + 4 * np);
}

struct BwdF32Ws {
  float *qd, *kv, *kt, *tqd;
  BwdF32Ws(float* ws, int BH, int N, int M, int D) {
    const long long mp = (M + 7) / 8 * 8;
    qd = ws;
    kv = qd + 4ll * BH * N * D;
    kt = kv + 4ll * BH * M * D;
    tqd = kt + 2ll * BH * D * mp;
  }
};

// K5a (kDkv false, dq given) or K5b (or one of its passes) into the
// workspace `ws` of width C::kD; first, with `prepare`, the pre-pass of
// what K5a (bit 0) and K5b (bit 1) read; Dt is the head dim (<= the width)
template <class C>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, int B, int H, int N, int M,
                   int Dt, long long q_bs, long long q_rs, long long k_bs,
                   long long k_rs, long long v_bs, long long v_rs, float scale,
                   float* ws, int prepare, cudaStream_t stream) {
  constexpr int D = C::kD;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  const int BH = B * H, Np = (N + 7) / 8 * 8, Mp = (M + 7) / 8 * 8;
  const long long hd = (long long)H * Dt;  // dO is contiguous
  const BwdF32Ws w(ws, BH, N, M, D);
  CUtensorMap tres, trows, tt;
  int err;
  constexpr int TR = C::kTBoxRows;
  if constexpr (C::kDkv) {
    err = tensor_map_3d_f32(&tres, w.kv, D, M, 4 * BH, D, C::kRes, 16);
    if (err == 0) err = tensor_map_3d_f32(&trows, w.qd, D, N, 4 * BH, D, C::kBS, 16);
    if (err == 0) err = tensor_map_3d_f32(&tt, w.tqd, Np, D, 4 * BH, Np, TR, 16);
  } else {
    err = tensor_map_3d_f32(&tres, w.qd, D, N, 4 * BH, D, C::kRes, 16);
    if (err == 0) err = tensor_map_3d_f32(&trows, w.kv, D, M, 4 * BH, D, C::kBS, 16);
    if (err == 0) err = tensor_map_3d_f32(&tt, w.kt, Mp, D, 2 * BH, Mp, TR, 16);
  }
  if (err != 0) return err;
  static unsigned long long smem_set = 0;
  auto kern = [] {
    if constexpr (C::kStream && C::kDkv) return flash_bwd_dkv_f32_stream_kernel<C>;
    else if constexpr (C::kStream) return flash_bwd_dq_f32_stream_kernel<C>;
    else if constexpr (C::kDkv) return flash_bwd_dkv_f32_ss_kernel<C>;
    else return flash_bwd_dq_f32_ss_kernel<C>;
  }();
  err = allow_smem(kern, C::kSmemBytes, smem_set);
  if (err != 0) return err;
  if (prepare != 0) {
    const bool ta = prepare & 1, tb = prepare & 2;
    const SplitJobs<4> jobs = {{
        {static_cast<const float*>(q), q_bs, q_rs, w.qd, tb ? w.tqd : nullptr, N},
        {static_cast<const float*>(dout), N * hd, hd, w.qd + 2ll * BH * N * D,
         tb ? w.tqd + 2ll * BH * D * Np : nullptr, N},
        {static_cast<const float*>(k), k_bs, k_rs, w.kv, ta ? w.kt : nullptr, M},
        {static_cast<const float*>(v), v_bs, v_rs, w.kv + 2ll * BH * M * D,
         nullptr, M}}};
    const int rows = Np > Mp ? Np : Mp;
    flash_split_f32_kernel<D, 4><<<dim3((rows + 31) / 32, BH, 4), 256, 0,
                                   stream>>>(jobs, H, Dt);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const float c = scale * kLog2e;
  if constexpr (C::kStream) {
    float* out = static_cast<float*>(C::kDkv ? (C::kPass == 1 ? dv : dk) : dq);
    kern<<<dim3(((C::kDkv ? M : N) + C::kRes - 1) / C::kRes, BH), C::kThreads,
           C::kSmemBytes, stream>>>(tres, trows, tt, lse, delta, out, H, N, M,
                                    Dt, scale, c);
  } else if constexpr (C::kDkv) {
    kern<<<dim3((M + C::kRes - 1) / C::kRes, BH), C::kThreads, C::kSmemBytes,
           stream>>>(tres, trows, tt, lse, delta, static_cast<float*>(dk),
                     static_cast<float*>(dv), H, N, M, Dt, scale, c);
  } else {
    kern<<<dim3((N + C::kRes - 1) / C::kRes, BH), C::kThreads, C::kSmemBytes,
           stream>>>(tres, trows, tt, lse, delta, static_cast<float*>(dq), H,
                     N, M, Dt, scale, c);
  }
  return (int)cudaGetLastError();
}

int flash_bwd_f32(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int B, int H, int N, int M,
                  int D, long long q_bs, long long q_rs, long long k_bs,
                  long long k_rs, long long v_bs, long long v_rs, float scale,
                  void* ws, int prepare, void* stream) {
  // the smallest width that holds d: 40, 64, 80, 128, 160, 256 or 320
  // (d % 4 == 0); K5b past 80 as its dV pass, then its dK pass on what the
  // first prepared
  using Launch = decltype(&launch_bwd_f32<DqF40>);
  Launch first = nullptr, second = nullptr;
  const bool a = dq != nullptr;
  switch (bwd_f32_width(D)) {
    case 40: first = a ? launch_bwd_f32<DqF40> : launch_bwd_f32<DkvF40>; break;
    case 64: first = a ? launch_bwd_f32<DqF64> : launch_bwd_f32<DkvF64>; break;
    case 80: first = a ? launch_bwd_f32<DqF80> : launch_bwd_f32<DkvF80>; break;
    case 128:
      first = a ? launch_bwd_f32<DqF128> : launch_bwd_f32<DvF128>;
      if (!a) second = launch_bwd_f32<DkF128>;
      break;
    case 160:
      first = a ? launch_bwd_f32<DqF160> : launch_bwd_f32<DvF160>;
      if (!a) second = launch_bwd_f32<DkF160>;
      break;
    case 256:
      first = a ? launch_bwd_f32<DqS256> : launch_bwd_f32<DvS256>;
      if (!a) second = launch_bwd_f32<DkS256>;
      break;
    case 320:
      first = a ? launch_bwd_f32<DqS320> : launch_bwd_f32<DvS320>;
      if (!a) second = launch_bwd_f32<DkS320>;
      break;
    default: break;
  }
  if (first == nullptr || D % 4 != 0) return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = first(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, q_bs,
                  q_rs, k_bs, k_rs, v_bs, v_rs, scale, w, prepare, s);
  if (err == 0 && second != nullptr)
    err = second(q, k, v, dout, lse, delta, dq, dk, dv, B, H, N, M, D, q_bs,
                 q_rs, k_bs, k_rs, v_bs, v_rs, scale, w, 0, s);
  return err;
}

}  // namespace

// K5a. q, k, v as for llt2i_flash_fwd; dout and dq contiguous (B, N, H*D);
// lse and delta contiguous f32 (B, H, N). Every D <= 320 (D % 8 == 0) runs
// the instantiation of the smallest width that holds it (48, 64, 80, 128,
// 160, 256, 320; K5b past 160 as two launches); any other returns
// cudaErrorInvalidValue without launching.
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
// scale > 0. Every D <= 512 runs the instantiation of the smallest width
// that holds it (48, 64, 80, 128, 160, 512; zeros past D); D > 512, D % 8
// != 0 or scale <= 0 returns cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int B, int H, int N,
                              int M, int D,
                              long long q_bs, long long q_rs, long long k_bs,
                              long long k_rs, long long v_bs, long long v_rs,
                              long long o_bs, long long o_rs, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;  // max over raw scores
  if (D % 8 != 0 || D <= 0 || D > 512) return (int)cudaErrorInvalidValue;
  // the smallest width that holds d: 48 (d 40, the 64^2 sites), 64 and 128
  // (num_heads 5), 80 (the 32^2 sites), 160 (the 24^2 sites at 768^2),
  // 512 (the VAE's mid attention)
  auto run = D <= 48    ? launch<Fwd40>
             : D <= 64  ? launch<Fwd64>
             : D <= 80  ? launch<Fwd80>
             : D <= 128 ? launch<Fwd128>
             : D <= 160 ? launch<Fwd160>
                        : launch<Fwd512>;
  return run(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs, k_bs, k_rs, v_bs,
             v_rs, o_bs, o_rs, scale, s);
}

// The f32 forms: q, k, v, o (and dout, dq, dk, dv) f32, with the strides
// and layouts of the bf16 entry points; rows 16-byte aligned (strides and
// head offsets multiples of 4 floats, so D % 4 == 0). K1: every D <= 512,
// on the kernel of the smallest width that holds it (40, 64, 80, 128, 160:
// flash_fwd_f32_ss_kernel, with a workspace `ws` of
// llt2i_flash_fwd_f32_ws(B, H, M, D) bytes, 16-byte aligned, which the call
// overwrites; 512: flash_fwd_f32_wgmma_kernel, ws null); K5a and K5b: every
// D <= 320 likewise (256, 320: the d-streamed kernels, bwd_f32_stream).
// Any other d, scale <= 0 (K1) or a missing workspace returns
// cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_fwd_f32(const void* q, const void* k, const void* v,
                                  void* o, float* lse, int B, int H, int N,
                                  int M, int D, long long q_bs, long long q_rs,
                                  long long k_bs, long long k_rs,
                                  long long v_bs, long long v_rs,
                                  long long o_bs, long long o_rs, float scale,
                                  void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!(scale > 0.f)) return (int)cudaErrorInvalidValue;  // max over raw scores
  float* w = static_cast<float*>(ws);
  if (D % 4 != 0 || D <= 0 || D > 512) return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch_w) {
    return launch_w(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs, k_bs, k_rs,
                    v_bs, v_rs, o_bs, o_rs, scale, w, s);
  };
  switch (f32_width(D)) {
    case 40: return run(launch_fwd_f32<Fwd40W>);
    case 64: return run(launch_fwd_f32<Fwd64W>);
    case 80: return run(launch_fwd_f32<Fwd80W>);
    case 128: return run(launch_fwd_f32<Fwd128W>);
    case 160: return run(launch_fwd_f32<Fwd160W>);
    default:  // past 160: the 512-wide kernel
      return launch_fwd_f32_512(q, k, v, o, lse, B, H, N, M, D, q_bs, q_rs,
                                k_bs, k_rs, v_bs, v_rs, o_bs, o_rs, scale, s);
  }
}

// The bytes of llt2i_flash_fwd_f32's workspace for B x H heads of M keys
// at head dim D (0 where it needs none: past 160)
LLT2I_API long long llt2i_flash_fwd_f32_ws(int B, int H, int M, int D) {
  const int w = f32_width(D);
  return w ? 4 * fwd_f32_ws_floats(B, H, M, w) : 0;
}

// K5a and K5b f32: every d <= 320 (d % 4 == 0), and a workspace `ws` of
// llt2i_flash_bwd_f32_ws(B, H, N, M, D) bytes, 16-byte aligned. With
// `prepare`, the call first writes into it the split (and transposed)
// operands that K5a (bit 0) and K5b (bit 1) read; with 0 it reads what an
// earlier call on the same operands and workspace wrote (the autograd
// backward: K5a with prepare 3, then K5b with 0). Any other d or a missing
// workspace returns cudaErrorInvalidValue without launching.
LLT2I_API int llt2i_flash_bwd_dq_f32(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     void* dq, int B, int H, int N, int M,
                                     int D, long long q_bs, long long q_rs,
                                     long long k_bs, long long k_rs,
                                     long long v_bs, long long v_rs,
                                     float scale, void* ws, int prepare,
                                     void* stream) {
  if (dq == nullptr) return (int)cudaErrorInvalidValue;
  return flash_bwd_f32(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                       N, M, D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, ws,
                       prepare, stream);
}

LLT2I_API int llt2i_flash_bwd_dkv_f32(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int H, int N,
                                      int M, int D, long long q_bs,
                                      long long q_rs, long long k_bs,
                                      long long k_rs, long long v_bs,
                                      long long v_rs, float scale, void* ws,
                                      int prepare, void* stream) {
  if (dk == nullptr || dv == nullptr) return (int)cudaErrorInvalidValue;
  return flash_bwd_f32(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, N, M,
                       D, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale, ws,
                       prepare, stream);
}

// The bytes of the K5a/K5b f32 workspace for B x H heads of N queries and
// M keys at head dim D (0 where no kernel takes D: past 320)
LLT2I_API long long llt2i_flash_bwd_f32_ws(int B, int H, int N, int M, int D) {
  const int w = bwd_f32_width(D);
  return w ? 4 * bwd_f32_ws_floats(B, H, N, M, w) : 0;
}
