// The split into hi and lo (and the C fragment as the A fragment, c_as_a)
// that the TF32 wgmma kernels of the f32 forms share: K1/f32, K5a/f32 and
// K5b/f32 (flash_attention.cu), and K4/f32, K6/f32, K7/f32, K8a/f32 and
// K8b/f32 on tf32_gemm.cuh.
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
// int8 B operands (K7/f32's weights) need no split: |q| <= 128 takes 8
// bits, exact in TF32, so hi = q and lo = 0, and a_lo q + a_hi q (two
// products) has the accuracy of 3xTF32 (tf32_gemm.cuh Cfg::kQ).
//
// The register A fragment of TF32 wgmma (g = lane / 4, t = lane % 4), and
// its accumulator's (hopper.cuh):
//   A (16 x 8 of a warp):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   C (16 x 8 of a warp):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// A C fragment is used as the A fragment of the next product without moving
// a value between threads: the k index of a product may be permuted as long
// as A and B agree, so logical k = t is column 2t of the C tile and k = t + 4
// column 2t + 1; then (a0, a1, a2, a3) = (c0, c2, c1, c3) (``c_as_a``), and
// B holds key 2t at k = t and key 2t + 1 at k = t + 4 (the wgmma kernels'
// transposed operands, flash_attention.cu p_key_slot).
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

// An A fragment split once, for all the B operands it meets
struct SplitA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit SplitA(const float (&a)[4]) {
    split(a, hi, lo);
  }
};

// a C fragment as the A fragment of the next product (permuted k)
__device__ __forceinline__ SplitA c_as_a(const float (&c)[4]) {
  const float a[4] = {c[0], c[2], c[1], c[3]};
  return SplitA(a);
}

}  // namespace f32_tiles
