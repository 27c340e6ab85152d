// The GEMM mainloop of K4, K6 and K7 (ffn.cu) and K8a and K8b (matmul.cu)
// for Hopper (sm_90a): warp-specialised wgmma on a TMA ring, accumulators
// in registers, and the epilogues they share.
//
// Every product is A B^T with both operands row-major over the contraction:
// A (M, K) activations and B (N, K) weights in the torch (out, in) layout,
// so both are K-major wgmma operands. A block computes one 128 x kBN output
// tile against kNB B operands at once (the GEGLU GEMMs, K4's, K6's and
// K7's up kernels and K8b, read the Wa and Wg tiles of the same columns and
// keep two accumulators).
//
// What bounds it on the H100: operations. A tile does 2 * 128 * kBN flops
// for every (128 + kBN) * 2 bytes of a 64-deep chunk it loads, about 70
// flops a byte of shared memory at kBN = 160, and the whole product
// 2*M*N*K flops against (M*K + N*K + M*N) * 2 bytes of device memory
// (hundreds of flops a byte at the port's shapes). So the design keeps the
// tensor cores fed: the loads run ahead of the products and no thread
// spends an instruction on an address.
//
// Design: one block of three warpgroups, one output tile a block.
//  * The third warpgroup is the producer. It hands its registers back
//    (setmaxnreg) and one thread keeps a ring of kStages stages in flight.
//    A stage holds one 64-deep chunk (one 128-byte swizzle chunk, the
//    layout of hopper.cuh) of the block's 128 A rows and of its kBN rows of
//    each B operand, loaded with TMA from 2-d tensor maps. Each stage has a
//    "full" mbarrier (TMA transaction bytes) and an "empty" one (one
//    arrival a consumer warp). Rows past M or N and columns past K come in
//    as zeros: a ragged K (K % 64 != 0) adds nothing to the sums, and no
//    operand is ever read past its end.
//  * int8 B operands (K7, Cfg::kQ): wgmma reads bf16 B only from shared
//    memory, so the thread loads the raw int8 chunks (64 bytes a row,
//    unswizzled) into a staging ring beside the bf16 one, and the other
//    three warps of the producer warpgroup convert them: each waits for a
//    stage's int8 bytes, writes them as bf16 into the stage's B slots in
//    the 128-byte swizzle layout, fences the async proxy and arrives on the
//    stage's "full" barrier, which then waits for the A bytes of TMA and
//    for those 96 arrivals. The consumers never wait on a converter except
//    through that barrier, and the converters run up to a ring ahead of
//    them. An int8 value is exact in bf16, and the conversion takes
//    integer and f32-add work only (s8x16_to_bf16). The per-channel scales
//    stay in the epilogue, on the f32 sums. A stage of the up GEMM holds
//    48 KB of bf16 and 16 KB of int8: three stages. The conversion adds
//    48 KB of shared-memory traffic to the 128 KB (TMA writes, wgmma
//    reads) of a bf16 up chunk; turning the weight into the register A
//    operand of wgmma (out^T = Q x^T) would not, at the cost of a
//    transposed epilogue.
//  * The first two warpgroups are the consumers, 64 output rows each, with
//    232 registers a thread at run time (224 beside the converters, which
//    take 56); ptxas compiles the kernel within 168 (hopper.cuh
//    setmaxnreg), which their kNB kBN / 2 accumulators fit. A
//    stage takes four wgmma.mma_async m64nkBNk16 per B operand, A and B
//    from shared memory, into f32 accumulators that stay in registers over
//    the whole contraction. A chunk's products stay
//    in flight while the next stage's are issued (wgmma.wait_group 1); the
//    stage they read is released once they have completed.
//  * The epilogue is the caller's functor, called by every consumer thread
//    with its accumulator fragments (hopper.cuh: rows row0 and row0 + 8,
//    columns 8 j + 2 (lane % 4) + {0, 1}). It adds, scales and rounds in
//    registers and stores bf16 pairs straight to global memory, masked at
//    the ragged M and N edges. Each output element is summed by one thread
//    in a fixed order: no atomics, and launches repeat bit for bit.
//  * The tile width: 160 and 80 divide the output widths 320 / 640 / 1280
//    of K8a and the down kernels, 128 the inner widths 1280 / 2560 / 5120
//    of the GEGLU GEMMs (128 + 2 x 128 rows a stage, 48 KB). K8a and the
//    down kernels take the narrow one of their two instantiations where it
//    needs fewer waves times width on the card's SMs (pick_narrow): at
//    M = 1024 and N = 1280, 8 x 8 tiles 160 wide fill 64 of the 132 SMs
//    for a 5,120-deep contraction, and 8 x 16 tiles 80 wide fill 128. On
//    the H100 that choice was the faster one at each of their main-path
//    shapes; for K4's up kernel, tiles 2 x 64 wide never were.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace gemm_tiles {

constexpr int kBM = 128;  // output rows a block: 64 a consumer warpgroup

constexpr int kConvThreads = 96;  // warps 9-11: the int8 converters

// kBN: output columns a block; kNB: B operands (one accumulator each); kQ:
// the B operands are int8, converted to bf16 in shared memory. The ring
// takes as many stages as fit in 192 KB (at most 8), a stage's int8
// staging included.
template <int kBN_, int kNB_, bool kQ_ = false>
struct Cfg {
  static constexpr int kBN = kBN_, kNB = kNB_;
  static constexpr bool kQ = kQ_;
  static constexpr int kThreads = 3 * 128;  // 2 consumer warpgroups, producer
  // 168 a thread at launch (64,512 registers): the converters need more
  // than one loading thread does
  static constexpr int kProducerRegs = kQ ? 56 : 40;
  static constexpr int kConsumerRegs = kQ ? 224 : 232;
  static constexpr uint32_t kABytes = kBM * 128;  // a 64-deep chunk of A
  static constexpr uint32_t kBBytes = kBN * 128;  // of one B operand
  static constexpr uint32_t kStageBytes = kABytes + kNB * kBBytes;
  static constexpr uint32_t kQBBytes = kQ ? kBN * 64 : 0;  // one int8 B chunk
  static constexpr uint32_t kQStageBytes = kNB * kQBBytes;
  static constexpr int kStages =
      196608 / (kStageBytes + kQStageBytes) < 8
          ? 196608 / (kStageBytes + kQStageBytes) : 8;
  // 1024 bytes of slack to align the swizzled chunks, the bf16 stages, the
  // int8 staging, then the mbarriers ("full", "empty", and with kQ "int8
  // full")
  static constexpr size_t kSmemBytes =
      1024 + kStages * (kStageBytes + kQStageBytes) + (kQ ? 24 : 16) * kStages;
  static_assert(kBN % 16 == 0 && kBN <= 256, "wgmma width, TMA box rows");
  static_assert(kNB == 1 || kNB == 2, "one or two B operands");
  static_assert(kStages >= 3, "a ring of at least three stages");
};

// 16 int8 values as 16 bf16, exactly, without a conversion instruction:
// each byte, offset to unsigned, becomes the low byte of the f32 2^23 + u;
// subtracting 2^23 + 128 leaves the integer exactly, and an integer of at
// most 8 significant bits has a zero lower half, so the f32's upper half
// is its bf16. lo gets values 0-7, hi 8-15, lowest address first.
__device__ __forceinline__ void s8x16_to_bf16(const uint4& q, uint4& lo,
                                              uint4& hi) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  uint32_t out[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t u = w[k] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + j)) -
             8388736.f;
    out[2 * k] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]),
                             0x7632);
    out[2 * k + 1] = __byte_perm(__float_as_uint(f[2]),
                                 __float_as_uint(f[3]), 0x7632);
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// One block's tile: acc[i] = A[m0 : m0 + 128] B_i[n0 : n0 + kBN]^T over the
// whole contraction K (m0 = 128 blockIdx.y, n0 = kBN blockIdx.x), then
// epi(acc, row0, n0, lane) on every consumer thread. tb1 is read only when
// kNB == 2; with C::kQ the B maps are of int8 (uint8) matrices, 64-byte
// unswizzled boxes. Launch with C::kThreads threads and C::kSmemBytes of
// dynamic shared memory.
template <class C, class Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta,
                                          const CUtensorMap* tb0,
                                          const CUtensorMap* tb1, int K,
                                          const Epi& epi) {
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qring = ring + S * C::kStageBytes;  // int8 staging (kQ)
  const uint32_t full = qring + S * C::kQStageBytes;  // stage s's at + 8 s
  const uint32_t empty = full + 8 * S;
  const uint32_t qfull = empty + 8 * S;  // int8 bytes landed (kQ)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * C::kBN;
  const int chunks = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the loading thread's, and with kQ each converter thread's
      mbar_init(full + 8 * s, C::kQ ? 1 + kConvThreads : 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
      if constexpr (C::kQ) mbar_init(qfull + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<C::kProducerRegs>();
    if (warp == 8 && lane == 0) {
      for (int t = 0; t < chunks; ++t) {
        const int s = t % S;
        if (t >= S) mbar_wait(empty + 8 * s, ((t / S) - 1) & 1);
        const uint32_t st = ring + s * C::kStageBytes;
        if constexpr (C::kQ) {
          // A into the stage, the int8 B chunks into its staging
          const uint32_t qst = qring + s * C::kQStageBytes;
          mbar_expect_tx(full + 8 * s, C::kABytes);
          tma_load_2d(st, ta, full + 8 * s, 64 * t, m0);
          mbar_expect_tx(qfull + 8 * s, C::kQStageBytes);
          tma_load_2d(qst, tb0, qfull + 8 * s, 64 * t, n0);
          if constexpr (C::kNB == 2)
            tma_load_2d(qst + C::kQBBytes, tb1, qfull + 8 * s, 64 * t, n0);
        } else {
          mbar_expect_tx(full + 8 * s, C::kStageBytes);
          tma_load_2d(st, ta, full + 8 * s, 64 * t, m0);
          tma_load_2d(st + C::kABytes, tb0, full + 8 * s, 64 * t, n0);
          if constexpr (C::kNB == 2)
            tma_load_2d(st + C::kABytes + C::kBBytes, tb1, full + 8 * s,
                        64 * t, n0);
        }
      }
    } else if constexpr (C::kQ) {
      if (warp > 8) {
        // the converters: 16 int8 bytes of staging (a quarter of a row) a
        // step into the two 16-byte bf16 pieces they become, placed by the
        // swizzle; the B slots of stage s are free once its int8 bytes
        // have landed, since the loading thread refilled the stage only
        // after the consumers released it
        const int ct = threadIdx.x - 9 * 32;
        constexpr int kPieces = C::kQStageBytes / 16, kU = 4;
        const uint32_t base = smem_u32(smem_raw);
        for (int t = 0; t < chunks; ++t) {
          const int s = t % S;
          mbar_wait(qfull + 8 * s, (t / S) & 1);
          const uint4* src = reinterpret_cast<const uint4*>(
              smem_raw + (qring + s * C::kQStageBytes - base));
          unsigned char* dst =
              smem_raw + (ring + s * C::kStageBytes + C::kABytes - base);
          // kU pieces a step, their loads first: plain shared loads and
          // stores, which the compiler may schedule, between the wait and
          // the fence
          for (int p0 = ct; p0 < kPieces; p0 += kU * kConvThreads) {
            uint4 q[kU];
#pragma unroll
            for (int u = 0; u < kU; ++u)
              if (p0 + u * kConvThreads < kPieces)
                q[u] = src[p0 + u * kConvThreads];
#pragma unroll
            for (int u = 0; u < kU; ++u) {
              // row p / 4 of the stacked B chunks, 16-byte pieces 2 (p % 4)
              // and 2 (p % 4) + 1 of its 128
              const int p = p0 + u * kConvThreads;
              if (p >= kPieces) break;
              uint4 lo, hi;
              s8x16_to_bf16(q[u], lo, hi);
              unsigned char* row = dst + 128 * (p >> 2);
              const int sw = (p >> 2) & 7;
              const int piece = 2 * (p & 3);
              *reinterpret_cast<uint4*>(row + ((piece ^ sw) << 4)) = lo;
              *reinterpret_cast<uint4*>(row + (((piece + 1) ^ sw) << 4)) = hi;
            }
          }
          fence_proxy_async();
          mbar_arrive(full + 8 * s);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g owns rows 64 g .. 64 g + 63 of the tile
  setmaxnreg_inc<C::kConsumerRegs>();
  const int g = warp >> 2;
  float acc[C::kNB][C::kBN / 2];
#pragma unroll
  for (int i = 0; i < C::kNB; ++i)
#pragma unroll
    for (int j = 0; j < C::kBN / 2; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < chunks; ++t) {
    const int s = t % S;
    mbar_wait(full + 8 * s, (t / S) & 1);
    __syncwarp();  // converged again for the warpgroup-wide wgmma
    const uint32_t a = ring + s * C::kStageBytes + g * 64 * 128;
    const uint32_t b = ring + s * C::kStageBytes + C::kABytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sw128_desc(a + 32 * kk, 16);
#pragma unroll
      for (int i = 0; i < C::kNB; ++i)
        wgmma_ss(acc[i], da, sw128_desc(b + i * C::kBBytes + 32 * kk, 16), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products have completed
    if (t > 0 && lane == 0) mbar_arrive(empty + 8 * ((t - 1) % S));
  }
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < C::kNB; ++i) fence_regs(acc[i]);
  epi(acc, m0 + 64 * g + 16 * (warp & 3) + (lane >> 2), n0, lane);
}

// The two bf16 values at p (4-byte aligned) as floats
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// ---------------------------------------------------------------------------
// epilogues

// Both epilogues walk a thread's column pairs in groups: a group's bias,
// scale and residual loads issue together, then its outputs are computed
// and stored. The stores alias nothing the loads read, but the compiler
// cannot know that: loaded one column at a time, each load waited for the
// stores before it. Group sizes: the up kernels' epilogue holds 8 pairs'
// bias and scales, the down kernels' 4 pairs' bias, scale and residual
// (larger groups there slowed K4's down kernel on the H100).
constexpr int kGegluCols = 8, kResidualCols = 4;

// The GEGLU GEMMs' (K4's, K6's and K7's up kernels, K8b): h = bf16((a * sa
// + ba) * gelu_erf(g * sg + bg)) in f32, a and g the two accumulators, sa
// and sg K7's int8 column scales (1 without)
struct Geglu {
  const bf16* b;  // (2 * N,) = [ba; bg], or null: no bias
  bf16* h;        // (M, N)
  int M, N;
  const float* sc = nullptr;  // (2 * N,) f32 = [sa; sg], or null: no scales

  template <int NB, int W>
  __device__ __forceinline__ void operator()(const float (&acc)[NB][W],
                                             int row0, int n0,
                                             int lane) const {
    static_assert(NB == 2, "a and g");
    if (sc != nullptr)
      cols<true>(acc, row0, n0, lane);
    else
      cols<false>(acc, row0, n0, lane);
  }

  template <bool kScaled, int NB, int W>
  __device__ __forceinline__ void cols(const float (&acc)[NB][W], int row0,
                                       int n0, int lane) const {
#pragma unroll
    for (int j0 = 0; j0 < W / 4; j0 += kGegluCols) {
      float2 va[kGegluCols], vg[kGegluCols], ca[kGegluCols], cg[kGegluCols];
#pragma unroll
      for (int jj = 0; jj < kGegluCols && j0 + jj < W / 4; ++jj) {
        const int col = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
        va[jj] = vg[jj] = make_float2(0.f, 0.f);
        ca[jj] = cg[jj] = make_float2(1.f, 1.f);
        if (col >= N) continue;
        if (b != nullptr) {
          va[jj] = load_pair(b + col);
          vg[jj] = load_pair(b + N + col);
        }
        if constexpr (kScaled) {
          ca[jj] = *reinterpret_cast<const float2*>(sc + col);
          cg[jj] = *reinterpret_cast<const float2*>(sc + N + col);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row >= M) continue;
        bf16* hrow = h + (long long)row * N;
#pragma unroll
        for (int jj = 0; jj < kGegluCols && j0 + jj < W / 4; ++jj) {
          const int col = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
          if (col >= N) continue;
          const int i = 4 * (j0 + jj) + 2 * r;
          float a0 = acc[0][i], a1 = acc[0][i + 1];
          float g0 = acc[1][i], g1 = acc[1][i + 1];
          if constexpr (kScaled) {
            a0 *= ca[jj].x, a1 *= ca[jj].y, g0 *= cg[jj].x, g1 *= cg[jj].y;
          }
          store_pair(hrow + col, (a0 + va[jj].x) * gelu_erf(g0 + vg[jj].x),
                     (a1 + va[jj].y) * gelu_erf(g1 + vg[jj].y));
        }
      }
    }
  }
};

// The down kernels' (K4, K6, K7): out = bf16(bf16((acc * s2 + b2) * s) +
// r), the FF output rounded before the residual is added (K4 and K7: r =
// x; K6: r passed in, s = 1; s2 K7's int8 column scales, 1 without)
struct ScaledResidual {
  const bf16* b2;  // (K,)
  const bf16* r;   // (M, K)
  bf16* out;       // (M, K)
  float s;
  int M, K;
  const float* sc = nullptr;  // (K,) f32 = s2, or null: no scales

  template <int NB, int W>
  __device__ __forceinline__ void operator()(const float (&acc)[NB][W],
                                             int row0, int n0,
                                             int lane) const {
    if (sc != nullptr)
      cols<true>(acc, row0, n0, lane);
    else
      cols<false>(acc, row0, n0, lane);
  }

  // row by row (the residual differs by row), each row's columns in groups
  template <bool kScaled, int NB, int W>
  __device__ __forceinline__ void cols(const float (&acc)[NB][W], int row0,
                                       int n0, int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long long at = (long long)row * K;
#pragma unroll
      for (int j0 = 0; j0 < W / 4; j0 += kResidualCols) {
        float2 vb[kResidualCols], c[kResidualCols], vr[kResidualCols];
#pragma unroll
        for (int jj = 0; jj < kResidualCols && j0 + jj < W / 4; ++jj) {
          const int col = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
          vb[jj] = vr[jj] = make_float2(0.f, 0.f);
          c[jj] = make_float2(1.f, 1.f);
          if (col >= K) continue;
          vb[jj] = load_pair(b2 + col);
          vr[jj] = load_pair(r + at + col);
          if constexpr (kScaled)
            c[jj] = *reinterpret_cast<const float2*>(sc + col);
        }
#pragma unroll
        for (int jj = 0; jj < kResidualCols && j0 + jj < W / 4; ++jj) {
          const int col = n0 + 8 * (j0 + jj) + 2 * (lane & 3);
          if (col >= K) continue;
          const int i = 4 * (j0 + jj) + 2 * h;
          float a0 = acc[0][i], a1 = acc[0][i + 1];
          if constexpr (kScaled) a0 *= c[jj].x, a1 *= c[jj].y;
          const float y0 =
              __bfloat162float(__float2bfloat16((a0 + vb[jj].x) * s));
          const float y1 =
              __bfloat162float(__float2bfloat16((a1 + vb[jj].y) * s));
          store_pair(out + at + col, y0 + vr[jj].x, y1 + vr[jj].y);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// host side

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n > 0 ? n : 132;
}

// Whether an (M, N) output runs faster in tiles `narrow` wide than `wide`:
// a launch takes ceil(tiles / SMs) waves of tiles whose time grows with
// their width, so compare waves x width; a tie keeps the wide tiles.
inline bool pick_narrow(int M, int N, int wide, int narrow) {
  const long long sms = sm_count(), mt = (M + kBM - 1) / kBM;
  auto cost = [&](int bn) {
    const long long tiles = mt * ((N + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(narrow) < cost(wide);
}

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

// Launch kKern, a GEGLU GEMM of config C (kNB == 2) with the Geglu
// epilogue, over x (M, K) and w = [Wa; Wg] (2N, K) into h (M, N). One
// tensor map on each half of w, N rows each: zero fill ends each at N, so a
// ragged tile never reads Wg as Wa. kKern takes (map of x, map of Wa, map
// of Wg, b, h, M, K, N).
template <class C, auto kKern>
int launch_geglu(const void* x, const void* w, const void* b, void* h, int M,
                 int K, int N, cudaStream_t st) {
  static_assert(C::kNB == 2, "a and g");
  const bf16* wa = static_cast<const bf16*>(w);
  CUtensorMap tx, twa, twg;
  int err = tensor_map_2d(&tx, x, M, K, kBM);
  if (err == 0) err = tensor_map_2d(&twa, wa, N, K, C::kBN);
  if (err == 0) err = tensor_map_2d(&twg, wa + (long long)N * K, N, K, C::kBN);
  if (err != 0) return err;
  return launch<C, kKern>(M, N, st, tx, twa, twg, static_cast<const bf16*>(b),
                          static_cast<bf16*>(h), M, K, N);
}

}  // namespace gemm_tiles
