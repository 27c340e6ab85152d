// f32 tile products for the f32 form of K7 (sm_90a), its tile GEMM, and
// the split into hi and lo (and the C fragment as the A fragment, c_as_a)
// that the TF32 wgmma kernels (K1/f32, K5a/f32, K5b/f32, and K4/f32,
// K6/f32, K8a/f32, K8b/f32 on tf32_gemm.cuh) share.
//
// "f32" means f32 accuracy: a single TF32 pass rounds each operand to 10
// mantissa bits (about 4e-4 relative error of a product), which is a
// different result. These kernels use 3xTF32 on the tensor cores: each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
// is hi*hi + hi*lo + lo*hi, three TF32 products accumulated in f32 (the
// lo*lo term, ~2^-22 relative, is dropped). The tensor cores truncate
// where they add into their C operand (aligned to its exponent), so
// chaining a long sum's products into one running C biases it toward zero
// by up to an ulp of the sum a step (on the H100, 3e-5 of rms(b) over 4096
// keys, growing with the length): every kernel takes a short run of
// products into a fresh accumulator and adds it to its running sum with
// round-to-nearest f32 adds. The error of a sum is then within a few f32
// ulps a step, as the plain f32 versions' (cuBLAS with allow_tf32 False).
//
// K7/f32's instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32
// .f32: its threads load their fragments from shared memory in any layout.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4), the same maps as
// wgmma's register A and accumulator (hopper.cuh):
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment is used as the A fragment of the next product without moving
// a value between threads: the k index of a product may be permuted as long
// as A and B agree, so logical k = t is column 2t of the C tile and k = t + 4
// column 2t + 1; then (a0, a1, a2, a3) = (c0, c2, c1, c3) (``c_as_a``), and
// B holds key 2t at k = t and key 2t + 1 at k = t + 4 (the wgmma kernels'
// transposed operands, flash_attention.cu p_key_slot).
//
// Shared-memory tiles are row-major f32 with a row stride ld = width + 4
// (ld % 8 == 4): the fragment loads of a warp, at rows g and columns t,
// then fall in 32 distinct banks.
//
// int8 B operands (K7's weights) need no split: |q| <= 127 takes 7 bits,
// exact in TF32, so hi = q and lo = 0, and a_hi q + a_lo q (``mma2``, two
// products) has the accuracy of 3xTF32. Their tiles hold the raw int8
// bytes (a quarter of the f32 bytes through cp.async); a value turns into
// a float as its fragment is formed (``frag_b_q``).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32_tiles {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 relative, both TF32
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split once, for all the B fragments it meets
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
    split(a, hi, lo);
  }
};

// d += a q for a B fragment exact in TF32 (int8 values, ``frag_b_q``): the
// small term, then hi * q, into a fresh fragment added to d in
// round-to-nearest f32
__device__ __forceinline__ void mma2(float (&d)[4], const SplitA& a,
                                     const uint32_t (&q)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, q);
  mma_tf32(t, a.hi, q);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// A fragment of rows r0.. and columns k0.. of a row-major tile
__device__ __forceinline__ void frag_a(float (&a)[4], const float* s, int ld,
                                       int r0, int k0, int lane) {
  const float* p = s + (r0 + (lane >> 2)) * ld + k0 + (lane & 3);
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// B fragment (k0.., n0..) of an int8 tile stored [n][k] (K-major: a weight
// tile of x W^T), each value as the float it is (exact in TF32)
__device__ __forceinline__ void frag_b_q(uint32_t (&b)[2], const int8_t* s,
                                         int ld, int n0, int k0, int lane) {
  const int8_t* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  b[0] = __float_as_uint(static_cast<float>(p[0]));
  b[1] = __float_as_uint(static_cast<float>(p[4]));
}

// a C fragment as the A fragment of the next product (permuted k)
__device__ __forceinline__ SplitA c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return SplitA(a);
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes global -> shared, or 16 zero bytes where `in` is false

__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `kPending` of this thread's groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// rows [r0, r0 + kRows) x kCols columns of a strided f32 (or int8) operand
// (row stride rs values, 16-byte aligned rows) into a tile of row stride
// ld; rows at or past `limit` and columns at or past `cols` (a multiple of
// a 16-byte chunk's values) come in as zeros. Every thread of the block
// takes part (kThreads of them).
template <int kRows, int kCols, int kThreads, class T>
__device__ __forceinline__ void load_tile(T* tile, int ld, const T* src,
                                          long long rs, int r0, int limit,
                                          int cols) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kCols / kPer;
  static_assert(kCols % kPer == 0, "16-byte chunks");
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = kPer * (i % kChunks);
    const bool in = r0 + r < limit && c < cols;
    cp16(tile + r * ld + c, in ? src + (r0 + r) * rs + c : src, in);
  }
}

// ---------------------------------------------------------------------------
// The tile GEMM of K7/f32: 128 x 64 output tiles, 32-deep k steps in a
// two-stage cp.async ring, eight warps of 32 x 32, two TF32 products a
// product against int8 B tiles (mma2)

constexpr int kF32BM = 128, kF32BN = 64, kF32BK = 32, kF32Ld = kF32BK + 4;
constexpr int kF32Threads = 256;
// an int8 B tile's row stride in bytes: 12 words, so the 8 rows of a
// fragment load fall in 8 distinct banks (16-byte aligned for cp.async)
constexpr int kQLd = kF32BK + 16;

// bytes of one stage: an f32 A tile and kNB int8 B tiles
template <int kNB>
__host__ __device__ constexpr size_t f32_gemm_stage() {
  return 4ull * kF32Ld * kF32BM + 1ull * kNB * kF32BN * kQLd;
}

// shared memory of the f32 GEMM with kNB B operands: two stages
template <int kNB>
__host__ __device__ constexpr size_t f32_gemm_smem() {
  return 2 * f32_gemm_stage<kNB>();
}

// The (kF32BM x kF32BN) tile at (m0, n0) of A B_i^T for i < kNB: A (M x Kd,
// row stride lda) f32, B_i (N x Kd, row stride ldb) int8, both row-major,
// each product into its own accumulators. Eight warps as 4 (rows) x 2
// (columns), a warp 32 x 32: acc[i][m16 tile][n8 tile][4]. Rows past M or
// N and columns past Kd (Kd % 16 == 0) load as zeros.
template <int kNB>
__device__ __forceinline__ void gemm_f32(float (&acc)[kNB][2][4][4],
                                         const float* A, long long lda, int M,
                                         const int8_t* const (&B)[kNB],
                                         long long ldb, int N, int Kd, int m0,
                                         int n0, float* smem) {
  constexpr size_t kStage = f32_gemm_stage<kNB>();
  char* base = reinterpret_cast<char*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);
  const int tiles = (Kd + kF32BK - 1) / kF32BK;
  auto stage_a = [&](int kt) {
    return reinterpret_cast<float*>(base + (kt & 1) * kStage);
  };
  auto stage_b = [&](int kt, int i) {
    return reinterpret_cast<int8_t*>(base + (kt & 1) * kStage +
                                     4ull * kF32Ld * kF32BM) +
           i * kF32BN * kQLd;
  };
  auto load = [&](int kt) {
    const int k0 = kt * kF32BK;
    load_tile<kF32BM, kF32BK, kF32Threads>(stage_a(kt), kF32Ld,
                                           A + (long long)m0 * lda + k0, lda,
                                           0, M - m0, Kd - k0);
#pragma unroll
    for (int i = 0; i < kNB; ++i)
      load_tile<kF32BN, kF32BK, kF32Threads>(
          stage_b(kt, i), kQLd, B[i] + (long long)n0 * ldb + k0, ldb, 0,
          N - n0, Kd - k0);
  };
#pragma unroll
  for (int i = 0; i < kNB; ++i)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][mi][nt][c] = 0.f;
  load(0);
  cp_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) {  // the next stage; its last readers were synced
      load(kt + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* sA = stage_a(kt);
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {
      float a[2][4];
      frag_a(a[0], sA, kF32Ld, wm, 8 * kk, lane);
      frag_a(a[1], sA, kF32Ld, wm + 16, 8 * kk, lane);
      const SplitA a0(a[0]), a1(a[1]);
#pragma unroll
      for (int i = 0; i < kNB; ++i) {
        const int8_t* sB = stage_b(kt, i);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bq[2];
          frag_b_q(bq, sB, kQLd, wn + 8 * nt, 8 * kk, lane);
          mma2(acc[i][0][nt], a0, bq);
          mma2(acc[i][1][nt], a1, bq);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
  }
}

// fn(mi, nt, r, row, col) for each pair of output columns (col, col + 1)
// of this thread's accumulators in the tile at (m0, n0) that lies inside
// (M, N) (N even): its values are acc[.][mi][nt][2 r] and [2 r + 1]
template <class Fn>
__device__ __forceinline__ void for_each_pair(int m0, int n0, int M, int N,
                                              Fn fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + 32 * (warp >> 1) + 16 * mi + (lane >> 2) + 8 * r;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + 32 * (warp & 1) + 8 * nt + 2 * (lane & 3);
        if (col < N) fn(mi, nt, r, row, col);
      }
    }
}

}  // namespace f32_tiles
