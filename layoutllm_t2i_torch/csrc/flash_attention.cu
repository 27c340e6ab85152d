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
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace nvcuda;

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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// does not link libcuda itself)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
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
  auto kern = flash_fwd_kernel<C>;
  static unsigned long long smem_set = 0;  // devices already set, a bit each
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= 64 || !(smem_set >> dev & 1)) {
    err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmemBytes);
    if (err != 0) return err;
    if (dev < 64) smem_set |= 1ull << dev;
  }
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
// the block takes that axis's place and the accumulators are WMMA fragments
// held in registers for the whole loop. Operations bound them at the 64^2
// sites: 10*N*M*d flops (S, dP, dQ in K5a; S, dP, dV, dK in K5b; S and dP
// are recomputed by both) against ~12*N*d bytes.
//
// The simple design of the first port (not yet redesigned for Hopper): one
// shared-memory stage, WMMA 16x16x16 with f32
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
