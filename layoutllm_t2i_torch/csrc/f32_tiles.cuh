// f32 tile products for the f32 forms of K1, K5a/K5b and K4 (sm_90a).
//
// "f32" means f32 accuracy: a single TF32 pass rounds each operand to 10
// mantissa bits (about 4e-4 relative error of a product), which is a
// different result. These kernels use 3xTF32 on the tensor cores: each f32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi), and a product
// is hi*hi + hi*lo + lo*hi, three TF32 products accumulated in f32 (the
// lo*lo term, ~2^-22 relative, is dropped), each 8-deep step's partial
// added to the accumulator in round-to-nearest f32 (``mma3``). The error of
// a sum is then within a few f32 ulps a step, as the plain f32 versions'
// (cuBLAS with allow_tf32 False).
//
// The instruction is mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
// wgmma with .tf32 operands takes A and B K-major only, while P V, P^T dO
// and dS^T Q need B MN-major (V, dO and Q are stored d-contiguous); with
// mma.sync the threads load their fragments from shared memory in any
// layout, so one helper serves every product.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C fragment is used as the A fragment of the next product without moving
// a value between threads: the k index of a product may be permuted as long
// as A and B agree, so logical k = t is column 2t of the C tile and k = t + 4
// column 2t + 1; then (a0, a1, a2, a3) = (c0, c2, c1, c3), and B is read at
// rows 2t and 2t + 1 (``frag_b_kn``).
//
// Shared-memory tiles are row-major f32 with a row stride ld = width + 4
// (ld % 8 == 4): the fragment loads of a warp, at rows g and columns t, or
// at rows 2t and columns g, then fall in 32 distinct banks.
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

// d += a b in 3xTF32: the two small terms first, then hi * hi, into a
// fresh fragment that is added to d with round-to-nearest f32 adds. The
// tensor cores truncate where they add into their C operand (aligned to
// its exponent), so chaining a long sum's products into one running C
// biases it toward zero by up to an ulp of the sum a step: on the H100,
// 3e-5 of rms(b) over 4096 keys and growing with the length. A fresh C
// keeps each step's truncation relative to its own 8-term partial.
__device__ __forceinline__ void mma3(float (&d)[4], const SplitA& a,
                                     const float (&b)[2]) {
  uint32_t bh[2], bl[2];
  split(b, bh, bl);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, bh);
  mma_tf32(t, a.hi, bl);
  mma_tf32(t, a.hi, bh);
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

// B fragment (k0.., n0..) of a tile stored [n][k] (K-major: the K tile of
// S = Q K^T, a weight tile of x W^T)
__device__ __forceinline__ void frag_b_nk(float (&b)[2], const float* s, int ld,
                                          int n0, int k0, int lane) {
  const float* p = s + (n0 + (lane >> 2)) * ld + k0 + (lane & 3);
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment (k0.., n0..) of a tile stored [k][n] (MN-major: V in P V), at
// the permuted k of a C fragment used as A: rows k0 + 2t and k0 + 2t + 1
__device__ __forceinline__ void frag_b_kn(float (&b)[2], const float* s, int ld,
                                          int k0, int n0, int lane) {
  const float* p = s + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  b[0] = p[0];
  b[1] = p[ld];
}

// a C fragment as the A fragment of the next product (permuted k)
__device__ __forceinline__ SplitA c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return SplitA(a);
}

// ---------------------------------------------------------------------------
// cp.async: 16 bytes global -> shared, or 16 zero bytes where `in` is false

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
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

// rows [r0, r0 + kRows) x kCols f32 columns of a strided operand (row
// stride rs floats, 16-byte aligned rows) into a tile of row stride ld;
// rows at or past `limit` and columns at or past `cols` come in as zeros.
// Every thread of the block takes part (kThreads of them).
template <int kRows, int kCols, int kThreads>
__device__ __forceinline__ void load_tile(float* tile, int ld, const float* src,
                                          long long rs, int r0, int limit,
                                          int cols) {
  constexpr int kChunks = kCols / 4;
  static_assert(kCols % 4 == 0, "16-byte chunks");
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = 4 * (i % kChunks);
    const bool in = r0 + r < limit && c < cols;
    cp16(tile + r * ld + c, in ? src + (r0 + r) * rs + c : src, in);
  }
}

}  // namespace f32_tiles
