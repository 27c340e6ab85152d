// The TF32 wgmma mainloop of the f32 GEMM forms (sm_90a): f32 accuracy
// (3xTF32, csrc/f32_tiles.cuh) on wgmma fed by a TMA ring. K8a/f32
// (matmul.cu linear_f32_wgmma_kernel), K8b/f32 (matmul.cu
// geglu_f32_wgmma_kernel), the up and down GEMMs of K4/f32 and K6/f32
// (ffn.cu ffn_up_f32_wgmma_kernel, ffn_down_f32_wgmma_kernel) and, on int8
// weights (Cfg::kQ), those of K7/f32 (ffn_q_up_f32_wgmma_kernel,
// ffn_q_down_f32_wgmma_kernel) run on it; the GEGLU GEMMs (K4/f32's,
// K6/f32's and K7/f32's up, K8b/f32) share its GegluF32 epilogue. K1/f32
// (csrc/flash_attention.cu) runs TF32 wgmma of its own with this file's
// split.
//
// Every product is A B^T with both operands row-major over the
// contraction: A (M, K) activations, B (N, K) weights in the torch (out,
// in) layout. wgmma reads .tf32 operands K-major only, which both are.
//
// What bounds it on the H100: operations, three TF32 products for each f32
// one (hi*hi + hi*lo + lo*hi; 495 TFLOP/s dense TF32), two against int8
// weights, and the shared memory the tensor cores read them from. So A
// never goes through shared memory as a wgmma operand: it is the register
// A of wgmma, B alone is read by the tensor cores, and each operand is
// split into hi and lo once.
//
// Design: one block of two warpgroups (eight warps), one 128 x kBN output
// tile a block; warpgroup g owns rows 64 g .. 64 g + 63.
//  * Thread 0 keeps a ring of kStages stages in flight with TMA: a stage
//    holds a 32-deep slice of the block's 128 A rows and of its kBN B
//    rows, each row 32 f32 values (one 128-byte swizzle row, the layout of
//    hopper.cuh), from 2-d tensor maps. Rows past M or N and columns past K
//    come in as zeros, so a ragged K adds nothing. It refills a stage once
//    all eight warps have released it ("empty"). gemm_tile_pair fills the
//    B tile from two maps, kBN / 2 rows of each at the same row (the GEGLU
//    GEMM's Wa and Wg rows of one block of h columns), each map zero past
//    its own last row.
//  * B is split once, by all 256 threads together, a stage ahead: while
//    the tensor cores run stage t's products, each thread rewrites its
//    share of stage t + 1's B values as hi = tf32(x) in place and writes
//    lo = tf32(x - hi) into the stage's lo tile at the same offset (the
//    swizzle is the same in both), fences the async proxy, and the block
//    meets at a named barrier before stage t + 1's products.
//  * int8 B (Cfg::kQ, K7/f32's weights): TMA brings the raw bytes, 32 a
//    row, unswizzled, into the stage's staging area (a quarter of the f32
//    bytes), and the split above becomes a conversion, by the same threads
//    at the same point: 16 bytes read, 16 f32 values written at their
//    sw128_f32 offsets of the B tile, each the value the signed byte is.
//    An int8 value is exact in TF32, so B needs no lo part, and a product
//    is two TF32 products, a_lo q + a_hi q, with the accuracy of 3xTF32.
//    The per-channel scales stay in the epilogue, on the f32 sums.
//  * Per stage each thread reads its A fragments (four values a k step, the
//    register A map of hopper.cuh) from the raw A tile and splits them in
//    registers: an A value is read and split by one thread only. Then 12
//    wgmma m64nkBNk8 (8 with kQ): the small terms lo*hi and hi*lo of the
//    four k steps first (with kQ lo*q), then hi*hi (hi*q), into a fresh
//    accumulator zeroed by the first product's scale-d, which is added to
//    the running f32 sum with round-to-nearest adds. The tensor cores
//    truncate where they add into their accumulator, so one accumulator
//    over the whole contraction would drift toward zero by up to an ulp of
//    the sum a step; a fresh one a stage keeps each truncation relative to
//    a 32-deep partial.
//  * Registers: the running sum and the fresh one (kBN / 2 each), the
//    split A fragments and a stage's B split take ~230 a thread at kBN =
//    160. ptxas allocates one count for the whole kernel, bounded by the
//    register file of an SM's four sub-partitions, 16,384 each, across the
//    warps each holds: 255 at eight warps, 168 at nine to twelve
//    (setmaxnreg moves registers between warpgroups at run time only). So
//    no warp is set aside to load, split or convert.
//  * The epilogue is the caller's functor on the f32 sums (hopper.cuh's
//    accumulator map: rows row0 and row0 + 8, columns 8 j + 2 (lane % 4) +
//    {0, 1}), masked at the ragged M and N edges. Each output is summed by
//    one thread in a fixed order: launches repeat bit for bit.
#pragma once

#include "common.cuh"
#include "f32_tiles.cuh"
#include "hopper.cuh"

namespace tf32_gemm {

constexpr int kBM = 128;  // output rows a block: 64 a consumer warpgroup
constexpr int kBK = 32;   // contraction depth a stage: one swizzle row

// kBN: output columns a block; kQ: the B operands are int8, converted to
// f32 in shared memory
template <int kBN_, bool kQ_ = false>
struct Cfg {
  static constexpr int kBN = kBN_;
  static constexpr bool kQ = kQ_;
  static constexpr int kThreads = 256;  // two warpgroups
  static constexpr uint32_t kABytes = kBM * 128;  // a stage's A slice
  static constexpr uint32_t kBBytes = kBN * 128;  // its f32 B slice (B hi)
  // then B lo, or the int8 bytes TMA brings (32 a row, unswizzled)
  static constexpr uint32_t kLoBytes = kQ ? 0 : kBBytes;
  static constexpr uint32_t kQBytes = kQ ? kBN * kBK : 0;
  // whole 1 KB swizzle atoms, so that every stage's A and B start on one
  static constexpr uint32_t kStageBytes =
      (kABytes + kBBytes + kLoBytes + kQBytes + 1023) / 1024 * 1024;
  static constexpr uint32_t kTxBytes = kABytes + (kQ ? kQBytes : kBBytes);
  // as many stages as fit beside 1 KB of alignment slack and the mbarriers
  // ("full", "empty"), at most 4
  static constexpr int kStages =
      (232448 - 1024) / (kStageBytes + 16) < 4
          ? (232448 - 1024) / (kStageBytes + 16) : 4;
  static constexpr size_t kSmemBytes = 1024 + kStages * (kStageBytes + 16);
  static_assert(kBN % 16 == 0 && kBN <= 256, "wgmma width, TMA box rows");
  static_assert(kStages >= 3, "a ring of at least three stages");
};

// The four A values of this thread for k step kk of a 32-deep slice in the
// 128-byte swizzle (rows r0 and r0 + 8 of it), split into hi and lo
__device__ __forceinline__ void a_frag_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const unsigned char* tile, int r0,
                                             int kk, int lane) {
  const int c = 8 * kk + (lane & 3);
  const float a[4] = {
      *reinterpret_cast<const float*>(tile + sw128_f32(r0, c)),
      *reinterpret_cast<const float*>(tile + sw128_f32(r0 + 8, c)),
      *reinterpret_cast<const float*>(tile + sw128_f32(r0, c + 4)),
      *reinterpret_cast<const float*>(tile + sw128_f32(r0 + 8, c + 4))};
  f32_tiles::split(a, hi, lo);
}

// `pieces` 16-byte pieces of f32 values at p, each value in place as hi =
// tf32(x) and as lo = tf32(x - hi) at the same piece of lo; thread ct of
// kThreadsSplit, four pieces a step, their loads first
template <int kThreadsSplit>
__device__ __forceinline__ void split_tile(float4* p, float4* lo, int pieces,
                                           int ct) {
  constexpr int kU = 4;
  for (int q0 = ct; q0 < pieces; q0 += kU * kThreadsSplit) {
    float4 x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (q0 + u * kThreadsSplit < pieces) x[u] = p[q0 + u * kThreadsSplit];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int q = q0 + u * kThreadsSplit;
      if (q >= pieces) break;
      const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      uint32_t h[4], l[4];
      f32_tiles::split(v, h, l);
      p[q] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                         __uint_as_float(h[2]), __uint_as_float(h[3]));
      lo[q] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                          __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
  }
}

// four int8 values (lowest address first) as the floats they are: each
// byte, offset to unsigned, becomes the low byte of the f32 2^23 + u, and
// subtracting 2^23 + 128 leaves the signed value exactly
__device__ __forceinline__ float4 s8x4_to_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) -
           8388736.f;
  return make_float4(f[0], f[1], f[2], f[3]);
}

// kRows rows of 32 int8 values at q (32 bytes a row, as TMA writes an
// unswizzled box) as f32 values into b, 32 a row in the 128-byte swizzle;
// thread ct of kThreadsConv, 16 bytes (half a row) a step. A warp's stores
// of one piece index fall in eight distinct 16-byte bank groups.
template <int kRows, int kThreadsConv>
__device__ __forceinline__ void convert_q(unsigned char* b,
                                          const unsigned char* q, int ct) {
  for (int p = ct; p < 2 * kRows; p += kThreadsConv) {
    const uint4 w = reinterpret_cast<const uint4*>(q)[p];
    const int r = p >> 1, c = 16 * (p & 1);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(b + sw128_f32(r, c + 4 * j)) =
          s8x4_to_f32(words[j]);
  }
}

// gemm_tile's and gemm_tile_pair's body: with kPairB, stage t's B tile is
// tb's rows r .. r + kBN / 2 - 1 over tb2's same rows (r = kBN / 2
// blockIdx.x), else tb's rows n0 .. n0 + kBN - 1
template <class C, bool kPairB, class Epi>
__device__ __forceinline__ void tile_loop(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          const CUtensorMap* tb2, int K,
                                          const Epi& epi) {
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t ring = (base + 1023u) & ~1023u;  // stage s at + s kStageBytes
  const uint32_t full = ring + S * C::kStageBytes;  // stage s's at + 8 s
  const uint32_t empty = full + 8 * S;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * C::kBN;
  const int steps = (K + kBK - 1) / kBK;
  // TMA's B bytes: the f32 B tile, or with kQ the int8 staging after it
  constexpr uint32_t kBDst = C::kABytes + (C::kQ ? C::kBBytes : 0);
  constexpr uint32_t kBHalf = (C::kQ ? C::kQBytes : C::kBBytes) / 2;
  auto load = [&](int t) {
    const int s = t % S;
    const uint32_t st = ring + s * C::kStageBytes;
    mbar_expect_tx(full + 8 * s, C::kTxBytes);
    tma_load_2d(st, ta, full + 8 * s, kBK * t, m0);
    if constexpr (kPairB) {
      const int r = C::kBN / 2 * blockIdx.x;
      tma_load_2d(st + kBDst, tb, full + 8 * s, kBK * t, r);
      tma_load_2d(st + kBDst + kBHalf, tb2, full + 8 * s, kBK * t, r);
    } else {
      tma_load_2d(st + kBDst, tb, full + 8 * s, kBK * t, n0);
    }
  };
  // this thread's share of stage t's B split (with kQ: its conversion),
  // fenced for wgmma's reads
  auto prep_b = [&](int t) {
    const int s = t % S;
    mbar_wait(full + 8 * s, (t / S) & 1);
    unsigned char* b =
        smem_raw + (ring + s * C::kStageBytes + C::kABytes - base);
    if constexpr (C::kQ) {
      convert_q<C::kBN, C::kThreads>(b, b + C::kBBytes, threadIdx.x);
    } else {
      float4* hi = reinterpret_cast<float4*>(b);
      split_tile<C::kThreads>(hi, hi + C::kBBytes / 16, C::kBBytes / 16,
                              threadIdx.x);
    }
    fence_proxy_async();
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);   // the loading thread, with A's and B's bytes
      mbar_init(empty + 8 * s, 8);  // one arrival a warp
    }
    mbar_init_fence();
    for (int t = 0; t < S && t < steps; ++t) load(t);
  }
  __syncthreads();

  const int g = warp >> 2;
  const int r0 = 64 * g + 16 * (warp & 3) + (lane >> 2);  // and r0 + 8
  float acc[C::kBN / 2], part[C::kBN / 2];
#pragma unroll
  for (int j = 0; j < C::kBN / 2; ++j) acc[j] = 0.f;
  prep_b(0);
  named_bar_sync(1, C::kThreads);

  for (int t = 0; t < steps; ++t) {
    const int s = t % S;
    const uint32_t st = ring + s * C::kStageBytes;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      a_frag_split(ah[kk], al[kk], smem_raw + (st - base), r0, kk, lane);
    __syncwarp();  // converged again for the warpgroup-wide wgmma
    const uint32_t bh = st + C::kABytes;  // B hi (with kQ: B)
    wgmma_fence();
    if constexpr (C::kQ) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_tf32(part, al[kk], sw128_desc(bh + 32 * kk, 16), kk > 0);
    } else {
      const uint32_t bl = bh + C::kBBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_tf32(part, al[kk], sw128_desc(bh + 32 * kk, 16), kk > 0);
        wgmma_rs_tf32(part, ah[kk], sw128_desc(bl + 32 * kk, 16), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_tf32(part, ah[kk], sw128_desc(bh + 32 * kk, 16), 1);
    wgmma_commit();
    if (t + 1 < steps) prep_b(t + 1);  // while the tensor cores run
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(ah);
    fence_regs(al);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with stage s
    if (threadIdx.x == 0 && t + S < steps) {
      mbar_wait(empty + 8 * s, (t / S) & 1);
      load(t + S);
    }
#pragma unroll
    for (int j = 0; j < C::kBN / 2; ++j) acc[j] += part[j];
    __syncwarp();
    if (t + 1 < steps) named_bar_sync(1, C::kThreads);  // stage t + 1 ready
  }
  epi(acc, blockIdx.y * kBM + r0, n0, lane);
}

// One block's tile: acc = A[m0 : m0 + 128] B[n0 : n0 + kBN]^T over the
// whole contraction K (m0 = 128 blockIdx.y, n0 = kBN blockIdx.x), then
// epi(acc, row0, n0, lane) on every consumer thread. ta and tb are
// tensor_map_2d_f32 maps of A (boxes of kBM rows) and B (kBN rows); with
// C::kQ, tb is an int8 tensor_map_2d map with boxes of 32 columns. Launch
// with C::kThreads threads and C::kSmemBytes of dynamic shared memory.
template <class C, class Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta,
                                          const CUtensorMap* tb, int K,
                                          const Epi& epi) {
  tile_loop<C, false>(ta, tb, nullptr, K, epi);
}

// The same over two B operands of kBN / 2 rows a block each: acc's columns
// 0 .. kBN / 2 - 1 are A tb[r : r + kBN / 2]^T, the rest A tb2[r : r + kBN /
// 2]^T (r = kBN / 2 blockIdx.x). In the accumulator map a thread's
// columns 8 j + 2 (lane % 4) + {0, 1} of the first operand's product and
// the same columns of the second's are its groups j and j + kBN / 16, so
// an epilogue meets both without a shuffle. tb and tb2 are maps with boxes
// of kBN / 2 rows (whole 1 KB swizzle atoms, kBN % 16 == 0); the epilogue
// still gets n0 = kBN blockIdx.x.
template <class C, class Epi>
__device__ __forceinline__ void gemm_tile_pair(const CUtensorMap* ta,
                                               const CUtensorMap* tb,
                                               const CUtensorMap* tb2, int K,
                                               const Epi& epi) {
  tile_loop<C, true>(ta, tb, tb2, K, epi);
}

// The GEGLU epilogue of gemm_tile_pair<Cfg<128>> (K4/f32's and K6/f32's
// up GEMM, K8b/f32) and of gemm_tile_pair<Cfg<128, true>> (K7/f32's):
// groups j < 8 of acc are A Wa^T, groups j + 8 A Wg^T at the same h
// columns n0 / 2 + 8 j + 2 (lane % 4) + {0, 1}; h = (a sa + ba) *
// gelu_erf(g sg + bg) in f32, the bias b = [ba; bg] and the per-channel
// scales s = [sa; sg] (int8 weights) optional
struct GegluF32 {
  const float* b;  // (2 inner,) = [ba; bg], or null
  float* h;        // (M, inner)
  int M, inner;
  const float* s = nullptr;  // (2 inner,) = [sa; sg], or null

  __device__ __forceinline__ void operator()(const float (&acc)[64], int row0,
                                             int n0, int lane) const {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 / 2 + 8 * j + 2 * (lane & 3);
        if (col >= inner) continue;  // inner % 4 == 0: col + 1 < inner too
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = acc[4 * j + 2 * hr + e], g = acc[4 * (j + 8) + 2 * hr + e];
          if (s != nullptr) {
            a *= s[col + e];
            g *= s[inner + col + e];
          }
          if (b != nullptr) {
            a += b[col + e];
            g += b[inner + col + e];
          }
          o[e] = a * gelu_erf(g);
        }
        *reinterpret_cast<float2*>(h + (long long)row * inner + col) =
            make_float2(o[0], o[1]);
      }
    }
  }
};

// Launch kKern (a gemm_tile kernel of config C) over an (M, N) output on
// `stream`, its dynamic shared memory allowed once per device.
template <class C, auto kKern, typename... Args>
int launch(int M, int N, cudaStream_t stream, Args... args) {
  static unsigned long long smem_set = 0;
  int err = allow_smem(kKern, C::kSmemBytes, smem_set);
  if (err != 0) return err;
  const dim3 grid((N + C::kBN - 1) / C::kBN, (M + kBM - 1) / kBM);
  kKern<<<grid, C::kThreads, C::kSmemBytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace tf32_gemm
