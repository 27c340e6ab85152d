// K2: GroupNorm(32) + affine (+ SiLU) over channels-last (N, HW, C), bf16
// in and out, f32 statistics.
//
// Replaces the TPU kernels of layoutllm_t2i_tpu/ops/pallas/norms.py:
// `_gn_kernel` (l.57, launched by `_gn_pallas` l.107/120) and the two-pass
// `_gn_stats_kernel` (l.137) + `_gn_apply_kernel` (l.176) of
// `_gn_pallas_rows` (l.191/200/220).
//
// What bounds it on the H100: bytes. Each element is read twice (statistics,
// then apply) and written once for a handful of flops.
//
// The simple design, in three launches:
//   1. gn_stats: one block per (sample, chunk of rows) reads whole rows
//      (coalesced across channels), keeps shifted per-channel sums, and
//      merges channels into per-group (count, mean, M2) partials with Chan's
//      parallel formula. The split over row chunks is what keeps the 512^2
//      VAE levels (one group = 4 x 262,144 elements) spread over the card,
//      and Chan's merge keeps the variance as accurate as a two-pass
//      `jnp.var`, which a raw f32 sum of squares over 1M elements is not.
//   2. gn_finalize: one block per sample merges the chunk partials of each
//      group and folds mean, rstd, gamma and beta into per-channel
//      (scale, shift).
//   3. gn_apply: y = x * scale + shift (then SiLU), 16 bytes per thread.
#include "common.cuh"

namespace {

constexpr int kStatsThreads = 256;
constexpr int kMaxGroups = 128;

// part layout: [N][nchunk][G][3] = (count, mean, M2)
__global__ void __launch_bounds__(kStatsThreads)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int HW,
                int C, int G, int rows_per_chunk) {
  extern __shared__ float sm[];
  float* cmean = sm;      // C
  float* cm2 = sm + C;    // C
  const int n = blockIdx.y;
  const int chunk = blockIdx.x;
  const int nchunk = gridDim.x;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  const float cnt = (float)(r1 - r0);
  const bf16* xb = x + (long long)n * HW * C;

  // channel pairs: neighbouring threads read neighbouring 4-byte words
  for (int c2 = threadIdx.x; c2 < C / 2; c2 += blockDim.x) {
    const int c = 2 * c2;
    const __nv_bfloat162* p =
        reinterpret_cast<const __nv_bfloat162*>(xb + (long long)r0 * C + c);
    const float2 shift = __bfloat1622float2(p[0]);
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          xb + (long long)r * C + c));
      const float d0 = f.x - shift.x, d1 = f.y - shift.y;
      s0 += d0;
      s1 += d1;
      q0 += d0 * d0;
      q1 += d1 * d1;
    }
    const float m0 = s0 / cnt, m1 = s1 / cnt;
    cmean[c] = shift.x + m0;
    cmean[c + 1] = shift.y + m1;
    cm2[c] = fmaxf(q0 - s0 * m0, 0.f);
    cm2[c + 1] = fmaxf(q1 - s1 * m1, 0.f);
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float na = cnt, mean = cmean[g * cg], m2 = cm2[g * cg];
    for (int j = 1; j < cg; ++j) {
      const float nab = na + cnt;
      const float delta = cmean[g * cg + j] - mean;
      mean += delta * (cnt / nab);
      m2 += cm2[g * cg + j] + delta * delta * (na * cnt / nab);
      na = nab;
    }
    float* o = part + (((long long)n * nchunk + chunk) * G + g) * 3;
    o[0] = na;
    o[1] = mean;
    o[2] = m2;
  }
}

// ss layout: [N][2][C] = (scale, shift)
__global__ void gn_finalize_kernel(const float* __restrict__ part,
                                   const bf16* __restrict__ gamma,
                                   const bf16* __restrict__ beta,
                                   float* __restrict__ ss, int nchunk, int C,
                                   int G, float eps) {
  __shared__ float smean[kMaxGroups], srstd[kMaxGroups];
  const int n = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const float* p = part + ((long long)n * nchunk * G + g) * 3;
    float na = p[0], mean = p[1], m2 = p[2];
    for (int j = 1; j < nchunk; ++j) {
      const float* q = p + (long long)j * G * 3;
      const float nb = q[0], nab = na + nb;
      const float delta = q[1] - mean;
      mean += delta * (nb / nab);
      m2 += q[2] + delta * delta * (na * nb / nab);
      na = nab;
    }
    smean[g] = mean;
    srstd[g] = rsqrtf(m2 / na + eps);
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float sc = __bfloat162float(gamma[c]) * srstd[g];
    ss[(long long)n * 2 * C + c] = sc;
    ss[(long long)n * 2 * C + C + c] = __bfloat162float(beta[c]) - smean[g] * sc;
  }
}

__global__ void gn_apply_kernel(const bf16* __restrict__ x,
                                const float* __restrict__ ss,
                                bf16* __restrict__ y, long long total_vec,
                                long long per_sample, int C, int silu) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 8;
    const int c = (int)(e % C);
    const float* sc = ss + (e / per_sample) * 2 * C;
    const float* sh = sc + C;
    float f[8];
    unpack8(reinterpret_cast<const uint4*>(x)[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float t = f[j] * sc[c + j] + sh[c + j];
      if (silu) t = t / (1.f + __expf(-t));
      f[j] = t;
    }
    reinterpret_cast<uint4*>(y)[i] = pack8(f);
  }
}

}  // namespace

// x, y: (N, HW, C) bf16 contiguous; gamma, beta: (C,) bf16;
// part: N*nchunk*G*3 f32 scratch; ss: N*2*C f32 scratch.
// C % 8 == 0, C % G == 0, G <= 128, nchunk = ceil(HW / rows_per_chunk).
LLT2I_API int llt2i_group_norm(const void* x, const void* gamma,
                               const void* beta, void* y, void* part,
                               void* ss, int N, int HW, int C, int G,
                               int rows_per_chunk, float eps, int silu,
                               int apply_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G > kMaxGroups || C % G || C % 8) return (int)cudaErrorInvalidValue;
  const int nchunk = (HW + rows_per_chunk - 1) / rows_per_chunk;
  gn_stats_kernel<<<dim3(nchunk, N), kStatsThreads, 2 * C * sizeof(float), s>>>(
      static_cast<const bf16*>(x), static_cast<float*>(part), HW, C, G,
      rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<N, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<float*>(ss), nchunk, C, G,
      eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total_vec = (long long)N * HW * C / 8;
  gn_apply_kernel<<<apply_blocks, 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ss),
      static_cast<bf16*>(y), total_vec, (long long)HW * C, C, silu);
  return (int)cudaGetLastError();
}
