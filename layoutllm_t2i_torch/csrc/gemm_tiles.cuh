// The GEMM mainloop of K4 and K6 (ffn.cu) and K8a and K8b (matmul.cu) for
// Hopper (sm_90a): warp-specialised wgmma on a TMA ring, accumulators in
// registers, and the epilogues they share.
//
// Every product is A B^T with both operands row-major over the contraction:
// A (M, K) activations and B (N, K) weights in the torch (out, in) layout,
// so both are K-major wgmma operands. A block computes one 128 x kBN output
// tile against kNB B operands at once (the GEGLU GEMMs, K4's and K6's up
// kernels and K8b, read the Wa and Wg tiles of the same columns and keep
// two accumulators).
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
//  * The first two warpgroups are the consumers, 64 output rows each, with
//    232 registers a thread. A stage takes four wgmma.mma_async m64nkBNk16
//    per B operand, A and B from shared memory, into f32 accumulators that
//    stay in registers over the whole contraction. A chunk's products stay
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

// kBN: output columns a block; kNB: B operands (one accumulator each).
// The ring takes as many stages as fit in 192 KB (at most 8).
template <int kBN_, int kNB_>
struct Cfg {
  static constexpr int kBN = kBN_, kNB = kNB_;
  static constexpr int kThreads = 3 * 128;  // two consumer warpgroups + producer
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr uint32_t kABytes = kBM * 128;  // a 64-deep chunk of A
  static constexpr uint32_t kBBytes = kBN * 128;  // of one B operand
  static constexpr uint32_t kStageBytes = kABytes + kNB * kBBytes;
  static constexpr int kStages =
      196608 / kStageBytes < 8 ? 196608 / kStageBytes : 8;
  // 1024 bytes of slack to align the swizzled chunks, then the mbarriers
  static constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 16 * kStages;
  static_assert(kBN % 16 == 0 && kBN <= 256, "wgmma width, TMA box rows");
  static_assert(kNB == 1 || kNB == 2, "one or two B operands");
  static_assert(kStages >= 3, "a ring of at least three stages");
};

// One block's tile: acc[i] = A[m0 : m0 + 128] B_i[n0 : n0 + kBN]^T over the
// whole contraction K (m0 = 128 blockIdx.y, n0 = kBN blockIdx.x), then
// epi(acc, row0, n0, lane) on every consumer thread. tb1 is read only when
// kNB == 2. Launch with C::kThreads threads and C::kSmemBytes of dynamic
// shared memory.
template <class C, class Epi>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* ta,
                                          const CUtensorMap* tb0,
                                          const CUtensorMap* tb1, int K,
                                          const Epi& epi) {
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + S * C::kStageBytes;  // mbarrier of stage s at + 8s
  const uint32_t empty = full + 8 * S;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * C::kBN;
  const int chunks = (K + 63) / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival a consumer warp
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
        mbar_expect_tx(full + 8 * s, C::kStageBytes);
        tma_load_2d(st, ta, full + 8 * s, 64 * t, m0);
        tma_load_2d(st + C::kABytes, tb0, full + 8 * s, 64 * t, n0);
        if constexpr (C::kNB == 2)
          tma_load_2d(st + C::kABytes + C::kBBytes, tb1, full + 8 * s, 64 * t,
                      n0);
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

// The GEGLU GEMMs' (K4's and K6's up kernels, K8b): h = bf16((a + ba) *
// gelu_erf(g + bg)) in f32, a and g the two accumulators
struct Geglu {
  const bf16* b;  // (2 * N,) = [ba; bg], or null: no bias
  bf16* h;        // (M, N)
  int M, N;

  template <int NB, int W>
  __device__ __forceinline__ void operator()(const float (&acc)[NB][W],
                                             int row0, int n0,
                                             int lane) const {
    static_assert(NB == 2, "a and g");
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= M) continue;
      bf16* hrow = h + (long long)row * N;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= N) continue;
        float2 va = make_float2(0.f, 0.f), vg = va;
        if (b != nullptr) {
          va = load_pair(b + col);
          vg = load_pair(b + N + col);
        }
        const int i = 4 * j + 2 * r;
        store_pair(hrow + col,
                   (acc[0][i] + va.x) * gelu_erf(acc[1][i] + vg.x),
                   (acc[0][i + 1] + va.y) * gelu_erf(acc[1][i + 1] + vg.y));
      }
    }
  }
};

// The down kernels' (K4, K6): out = bf16(bf16((acc + b2) * s) + r), the
// FF output rounded before the residual is added (K4: r = x; K6: r passed
// in, s = 1)
struct ScaledResidual {
  const bf16* b2;  // (K,)
  const bf16* r;   // (M, K)
  bf16* out;       // (M, K)
  float s;
  int M, K;

  template <int NB, int W>
  __device__ __forceinline__ void operator()(const float (&acc)[NB][W],
                                             int row0, int n0,
                                             int lane) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const long long at = (long long)row * K;
#pragma unroll
      for (int j = 0; j < W / 4; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        if (col >= K) continue;
        const float2 vb = load_pair(b2 + col);
        const float2 vr = load_pair(r + at + col);
        const int i = 4 * j + 2 * h;
        const float y0 = __bfloat162float(__float2bfloat16((acc[0][i] + vb.x) * s));
        const float y1 =
            __bfloat162float(__float2bfloat16((acc[0][i + 1] + vb.y) * s));
        store_pair(out + at + col, y0 + vr.x, y1 + vr.y);
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
