// K2: GroupNorm + affine (+ SiLU) over channels-last (N, HW, C), bf16 in
// and out, f32 statistics.
//
// Replaces the TPU kernels of layoutllm_t2i_tpu/ops/pallas/norms.py:
// `_gn_kernel` (l.57, launched by `_gn_pallas` l.120), which holds a
// sample's (HW, C/k) slab in VMEM, and the two-pass `_gn_stats_kernel`
// (l.137, launched l.200) + `_gn_apply_kernel` (l.176, launched l.220) of
// `_gn_pallas_rows`, which stream rows where the slab does not fit.
//
// What bounds it on the H100: bytes. Each element must be read once and
// written once for ~10 flops; the least time is 4 bytes an element over
// 3.35 TB/s. The channels are cut into slabs of whole groups, a multiple of
// 8 channels (16-byte vectors); kernels/group_norm.py `plan_group_norm`
// picks the slab and one of two paths for each (N, HW, C, G):
//
// On-chip path, one launch (gn_cluster_kernel). One thread block cluster
// of K <= 8 blocks (a portable cluster) works on each (sample, slab); block `rank` holds rows
// [rank * rows, (rank + 1) * rows) of the slab in shared memory, loaded
// once with 16-byte cp.async (gamma and beta load meanwhile). A warp per
// 8-channel vector, a row a lane, takes per-channel sums of x minus the
// value in its first row (a shift that keeps f32 sums of squares
// accurate), summed over lanes by shuffles, and the block merges channels
// into per-group (count, mean, M2) with Chan's parallel formula in closed
// form over equal counts:
// mean = sum(mean_c) / cg, M2 = sum(M2_c) + rows * sum((mean_c - mean)^2).
// After barrier.cluster, every block reads all K blocks' partials through
// distributed shared memory and merges them the same way, weighted by their
// counts, in one warp per group (lane = rank, butterfly sums): every block
// applies bit-identical statistics. It folds gamma and beta into
// per-channel (scale, shift), normalises its rows from shared memory and
// writes y in 16-byte stores: one read and one write of x. The
// block arrives on a second cluster barrier once it has read its
// neighbours' partials and waits on it before it exits, so its own shared
// memory lives while they read it; a cluster of one block skips both
// cluster barriers.
//
// Streaming path, two launches, for slabs that no cluster holds (the VAE's
// 256^2 and 512^2 levels): gn_stats_kernel reads (sample, slab, chunk of
// rows) tiles with 16-byte loads, eight in flight a thread, and writes
// per-(sample, group, chunk) partials (count, mean, M2) made as above;
// gn_apply_kernel merges the partials of its sample's groups in its
// prologue (one warp per group, lanes over chunks, butterfly sums: a tree,
// no serial chain), then reads x a second time and writes y. That path
// moves 6 bytes an element, not 4.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;     // dynamic shared memory a block can use
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kUnroll = 8;           // 16-byte loads in flight a thread

// How a block's threads cover a tile of rows x V vectors of 8 channels:
// thread t takes vectors v0, v0 + vt, ... of rows rl, rl + R, ...; threads
// past R * vt take none.
struct Lanes {
  int vt, R, rl, v0;
  __device__ explicit Lanes(int V) {
    vt = V < kThreads ? V : kThreads;
    R = kThreads / vt;
    rl = threadIdx.x / vt;
    v0 = threadIdx.x % vt;
  }
  __device__ bool active() const { return rl < R; }
};

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// The on-chip kernel's statistics pass: warp w takes vectors w % Vw,
// w % Vw + Vw, ... of the rows in part w / Vw of P, one row a lane.
__host__ __device__ inline int stat_vectors(int V) {
  return V < kWarps ? V : kWarps;
}

// Byte offsets of the on-chip kernel's shared memory (mirrored by
// kernels/group_norm.py `cluster_smem_bytes`, which the card tests hold
// against llt2i_group_norm_cluster_smem): the bf16 tile, then f32
// arrays: red_s and red_q (P x S), shift, gam, bet (S each), part (3 per
// group), gmean, grstd (1 per group).
struct ClusterSmem {
  int red_s, red_q, shift, gam, bet, part, gmean, grstd, total;
  __host__ __device__ ClusterSmem(int rows, int S, int cg) {
    const int P = kWarps / stat_vectors(S / 8);
    const int gs = S / cg;
    red_s = round16(rows * S * 2);
    red_q = red_s + 4 * P * S;
    shift = red_q + 4 * P * S;
    gam = shift + 4 * S;
    bet = gam + 4 * S;
    part = bet + 4 * S;
    gmean = part + 4 * 3 * gs;
    grstd = gmean + 4 * gs;
    total = grstd + 4 * gs;
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// t * sigmoid(t) = t / (1 + exp(-t)): ex2.approx and rcp.approx, each
// within 2 ulps of f32, so the result is relatively accurate in the negative
// tail too, where 1 + tanh(t / 2) would cancel. Past t = -87 the denominator
// overflows and the result is -0 (the true value is under 1e-36).
__device__ __forceinline__ float silu_f(float t) {
  return __fdividef(t, 1.f + __expf(-t));
}

// One group's (mean, M2) over a tile of `rows` rows, in one warp, from the
// tile's R row parts' sums red_s, red_q (R x S floats) of x minus `shift`:
// each lane takes channels of the group (first channel c0, cg channels),
// their (mean_c, M2_c) = (shift + s / rows, q - s^2 / rows), and the warp
// merges them with Chan's formula for equal counts in closed form.
__device__ float2 group_stats(const float* red_s, const float* red_q, int R,
                              int S, const float* shift, int c0, int cg,
                              int rows) {
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  for (int c = c0 + lane; c < c0 + cg; c += 32) {
    float s = 0.f;
    for (int i = 0; i < R; ++i) s += red_s[i * S + c];
    a += shift[c] + s / rows;
  }
  const float mean = warp_sum(a) / cg;
  float b = 0.f;
  for (int c = c0 + lane; c < c0 + cg; c += 32) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < R; ++i) {
      s += red_s[i * S + c];
      q += red_q[i * S + c];
    }
    const float m = s / rows;
    const float d = shift[c] + m - mean;
    b += fmaxf(q - s * m, 0.f) + rows * d * d;
  }
  return make_float2(mean, warp_sum(b));
}

// Chan's merge of parts (count, mean, M2) held by the lanes of one warp
// (a lane without a part holds count 0): (mean, rstd) of their union.
__device__ __forceinline__ float2 merge_parts(float cnt, float mean_k,
                                              float m2_k, float eps) {
  const float tot = warp_sum(cnt);
  const float mean = warp_sum(cnt * mean_k) / tot;
  const float d = mean_k - mean;
  const float m2 = warp_sum(m2_k + cnt * d * d);
  return make_float2(mean, rsqrtf(m2 / tot + eps));
}

// grid (K, C / S, N), cluster (K, 1, 1); block rank takes `rows` rows. The
// second launch bound lets ptxas take 72 registers: aimed at more blocks an
// SM, it capped the kernel at 64 and spilled.
__global__ void __launch_bounds__(kThreads, 1)
gn_cluster_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                  const bf16* __restrict__ beta, bf16* __restrict__ y, int HW,
                  int C, int S, int cg, int rows, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const ClusterSmem L(rows, S, cg);
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + L.red_s);
  float* red_q = reinterpret_cast<float*>(smem + L.red_q);
  float* shift = reinterpret_cast<float*>(smem + L.shift);
  float* gam = reinterpret_cast<float*>(smem + L.gam);
  float* bet = reinterpret_cast<float*>(smem + L.bet);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* gmean = reinterpret_cast<float*>(smem + L.gmean);
  float* grstd = reinterpret_cast<float*>(smem + L.grstd);

  const int K = gridDim.x, rank = blockIdx.x;
  const int slab = blockIdx.y, n = blockIdx.z;
  const int r0 = rank * rows;
  const int nr = min(rows, HW - r0);
  const int V = S / 8, gs = S / cg;
  const long long base = ((long long)n * HW + r0) * C + (long long)slab * S;
  const Lanes ln(V);

  // 1. the block's rows x S tile into shared memory, once
  if (ln.active())
    for (int r = ln.rl; r < nr; r += ln.R)
      for (int v = ln.v0; v < V; v += ln.vt)
        cp_async16(tile + r * S + v * 8, x + base + (long long)r * C + v * 8);
  // gamma and beta while the tile is in flight
  for (int c = threadIdx.x; c < S; c += kThreads) {
    gam[c] = __bfloat162float(gamma[slab * S + c]);
    bet[c] = __bfloat162float(beta[slab * S + c]);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. sums of x - x[first row] per channel: a warp per vector and row
  // part, a row a lane, then butterfly sums over the lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vw = stat_vectors(V), P = kWarps / vw;
  if (warp < P * vw)
    for (int v = warp % vw; v < V; v += vw) {
      const int p = warp / vw;
      const uint4* t4 = reinterpret_cast<const uint4*>(tile) + v;
      float sh[8], s[8], q[8];
      unpack8(t4[0], sh);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
      for (int r = p * 32 + lane; r < nr; r += P * 32) {
        float f[8];
        unpack8(t4[r * V], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - sh[j];
          s[j] += d;
          q[j] += d * d;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = warp_sum(s[j]);
        q[j] = warp_sum(q[j]);
      }
      if (lane == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          red_s[p * S + v * 8 + j] = s[j];
          red_q[p * S + v * 8 + j] = q[j];
          if (p == 0) shift[v * 8 + j] = sh[j];
        }
    }
  __syncthreads();

  // 3. per group of the slab: (count, mean, M2)
  for (int gl = warp; gl < gs; gl += kWarps) {
    const float2 st = group_stats(red_s, red_q, P, S, shift, gl * cg, cg, nr);
    if (lane == 0) {
      part[3 * gl] = (float)nr * cg;
      part[3 * gl + 1] = st.x;
      part[3 * gl + 2] = st.y;
    }
  }
  if (K > 1)
    cluster.sync();
  else
    __syncthreads();

  // 4. every block merges the cluster's partials in rank order
  for (int gl = warp; gl < gs; gl += kWarps) {
    float cnt = 0.f, mk = 0.f, m2k = 0.f;
    if (lane < K) {
      const float* p =
          (K > 1 ? cluster.map_shared_rank(part, lane) : part) + 3 * gl;
      cnt = p[0];
      mk = p[1];
      m2k = p[2];
    }
    const float2 st = merge_parts(cnt, mk, m2k, eps);
    if (lane == 0) {
      gmean[gl] = st.x;
      grstd[gl] = st.y;
    }
  }
  if (K > 1) cluster_arrive();  // done reading the other blocks' partials
  __syncthreads();

  // 5. per-channel scale and shift with gamma and beta folded in; the tile
  // normalised from shared memory, 16-byte stores
  if (ln.active())
    for (int v = ln.v0; v < V; v += ln.vt) {
      float sc[8], sh[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = v * 8 + j, g = c / cg;
        sc[j] = gam[c] * grstd[g];
        sh[j] = bet[c] - gmean[g] * sc[j];
      }
      const uint4* t4 = reinterpret_cast<const uint4*>(tile) + v;
      for (int r = ln.rl; r < nr; r += ln.R) {
        float f[8];
        unpack8(t4[r * V], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = f[j] * sc[j] + sh[j];
          f[j] = silu ? silu_f(t) : t;
        }
        *reinterpret_cast<uint4*>(y + base + (long long)r * C + v * 8) = pack8(f);
      }
    }
  if (K > 1) cluster_wait();  // the others no longer read this block's part
}

// grid (chunks, C / S, N): per-(sample, group, chunk) partials
// part[((n * G + g) * chunks + k) * 3 + (count, mean, M2)] of `rows` rows.
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, int HW,
                int C, int S, int cg, int G, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int V = S / 8, gs = S / cg;
  const Lanes ln(V);
  float* red_s = reinterpret_cast<float*>(smem);
  float* red_q = red_s + ln.R * S;
  float* shift = red_q + ln.R * S;

  const int k = blockIdx.x, chunks = gridDim.x;
  const int slab = blockIdx.y, n = blockIdx.z;
  const int r0 = k * rows;
  const int nr = min(rows, HW - r0);
  const uint4* xb = reinterpret_cast<const uint4*>(
      x + ((long long)n * HW + r0) * C + (long long)slab * S);
  const long long stride = (long long)ln.R * C / 8;  // vectors between rows

  if (ln.active())
    for (int v = ln.v0; v < V; v += ln.vt) {
      float sh[8], s[8], q[8];
      unpack8(xb[v], sh);
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
      const uint4* p = xb + (long long)ln.rl * C / 8 + v;
      int r = ln.rl;
      for (; r + (kUnroll - 1) * ln.R < nr; r += kUnroll * ln.R) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) raw[u] = p[u * stride];
        p += kUnroll * stride;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float f[8];
          unpack8(raw[u], f);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float d = f[j] - sh[j];
            s[j] += d;
            q[j] += d * d;
          }
        }
      }
      for (; r < nr; r += ln.R, p += stride) {
        float f[8];
        unpack8(*p, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - sh[j];
          s[j] += d;
          q[j] += d * d;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red_s[ln.rl * S + v * 8 + j] = s[j];
        red_q[ln.rl * S + v * 8 + j] = q[j];
        if (ln.rl == 0) shift[v * 8 + j] = sh[j];
      }
    }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int gl = warp; gl < gs; gl += kWarps) {
    const float2 st = group_stats(red_s, red_q, ln.R, S, shift, gl * cg, cg, nr);
    if (lane == 0) {
      float* o = part + (((long long)n * G + slab * gs + gl) * chunks + k) * 3;
      o[0] = (float)nr * cg;
      o[1] = st.x;
      o[2] = st.y;
    }
  }
}

// grid (blocks, N): block b normalises rows [b * rows, (b + 1) * rows) of
// sample n, all C channels, after merging the sample's partials.
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                bf16* __restrict__ y, int HW, int C, int G, int chunks,
                int rows, float eps, int silu) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scale = reinterpret_cast<float*>(smem);
  float* shift = scale + C;
  float* gmean = shift + C;
  float* grstd = gmean + G;
  const int n = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the sample's partials, a warp per group, lanes over chunks
  for (int g = warp; g < G; g += kWarps) {
    const float* p = part + ((long long)n * G + g) * chunks * 3;
    float cnt = 0.f, sm = 0.f;
    for (int k = lane; k < chunks; k += 32) {
      cnt += p[3 * k];
      sm += p[3 * k] * p[3 * k + 1];
    }
    const float tot = warp_sum(cnt);
    const float mean = warp_sum(sm) / tot;
    float m2 = 0.f;
    for (int k = lane; k < chunks; k += 32) {
      const float d = p[3 * k + 1] - mean;
      m2 += p[3 * k + 2] + p[3 * k] * d * d;
    }
    m2 = warp_sum(m2);
    if (lane == 0) {
      gmean[g] = mean;
      grstd[g] = rsqrtf(m2 / tot + eps);
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / cg;
    const float sc = __bfloat162float(gamma[c]) * grstd[g];
    scale[c] = sc;
    shift[c] = __bfloat162float(beta[c]) - gmean[g] * sc;
  }
  __syncthreads();

  const int V = C / 8;
  const Lanes ln(V);
  if (!ln.active()) return;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, HW - r0);
  const long long first = ((long long)n * HW + r0) * V;  // in vectors
  const uint4* xb = reinterpret_cast<const uint4*>(x) + first;
  uint4* yb = reinterpret_cast<uint4*>(y) + first;
  const long long stride = (long long)ln.R * V;
  for (int v = ln.v0; v < V; v += ln.vt) {
    float sc[8], sh[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = scale[v * 8 + j];
      sh[j] = shift[v * 8 + j];
    }
    long long i = (long long)ln.rl * V + v;
    int r = ln.rl;
    for (; r + (kUnroll - 1) * ln.R < nr; r += kUnroll * ln.R) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) raw[u] = xb[i + u * stride];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[8];
        unpack8(raw[u], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float t = f[j] * sc[j] + sh[j];
          f[j] = silu ? silu_f(t) : t;
        }
        yb[i + u * stride] = pack8(f);
      }
      i += kUnroll * stride;
    }
    for (; r < nr; r += ln.R, i += stride) {
      float f[8];
      unpack8(xb[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = f[j] * sc[j] + sh[j];
        f[j] = silu ? silu_f(t) : t;
      }
      yb[i] = pack8(f);
    }
  }
}

// Once per device (a bit each in `set`): let `kern` use kSmemMax bytes of
// dynamic shared memory.
template <typename Kern>
int allow(Kern kern, unsigned long long& set) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 64 && (set >> dev & 1)) return 0;
  err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == 0 && dev < 64) set |= 1ull << dev;
  return err;
}

bool shape_ok(int N, int HW, int C, int G) {
  return N >= 1 && HW >= 1 && G >= 1 && G <= 128 && C % G == 0 && C % 8 == 0;
}

bool slab_ok(int C, int G, int S) {
  return S > 0 && S % 8 == 0 && C % S == 0 && S % (C / G) == 0;
}

}  // namespace

// The on-chip kernel's dynamic shared memory for a block of `rows` rows of
// an S-channel slab in groups of cg, or -1 where it exceeds what a block
// can have: the planner's `cluster_smem_bytes` is held to it.
LLT2I_API int llt2i_group_norm_cluster_smem(int rows, int S, int cg) {
  if (rows < 1 || S < 8 || S % 8 != 0 || cg < 1 || S % cg != 0) return -1;
  if ((long long)rows * S * 2 > kSmemMax) return -1;
  const int smem = ClusterSmem(rows, S, cg).total;
  return smem > kSmemMax ? -1 : smem;
}

// On-chip path. x, y: (N, HW, C) bf16 contiguous, 16-byte aligned; gamma,
// beta: (C,) bf16. Slabs of S channels (whole groups, S % 8 == 0), clusters
// of `cluster` blocks of `rows` rows: (cluster - 1) * rows < HW <=
// cluster * rows, and the tile fits shared memory.
LLT2I_API int llt2i_group_norm_cluster(const void* x, const void* gamma,
                                       const void* beta, void* y, int N,
                                       int HW, int C, int G, int S,
                                       int cluster, int rows, float eps,
                                       int silu, void* stream) {
  if (!shape_ok(N, HW, C, G) || !slab_ok(C, G, S) || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 ||
      (long long)rows * cluster < HW || (long long)rows * (cluster - 1) >= HW)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  const int smem = llt2i_group_norm_cluster_smem(rows, S, cg);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  static unsigned long long set = 0;
  int err = allow(gn_cluster_kernel, set);
  if (err != 0) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, C / S, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(
      &cfg, gn_cluster_kernel, static_cast<const bf16*>(x),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<bf16*>(y), HW, C, S, cg, rows, eps, silu);
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

// Streaming path. x, y, gamma, beta as above; part: N * G * chunks * 3 f32
// scratch. Statistics over slabs of S channels in `chunks` chunks of
// `rows` rows ((chunks - 1) * rows < HW <= chunks * rows); the apply pass
// in blocks of `apply_rows` rows.
LLT2I_API int llt2i_group_norm_stream(const void* x, const void* gamma,
                                      const void* beta, void* y, void* part,
                                      int N, int HW, int C, int G, int S,
                                      int chunks, int rows, int apply_rows,
                                      float eps, int silu, void* stream) {
  if (!shape_ok(N, HW, C, G) || !slab_ok(C, G, S) || chunks < 1 ||
      rows < 1 || (long long)rows * chunks < HW ||
      (long long)rows * (chunks - 1) >= HW || apply_rows < 1)
    return (int)cudaErrorInvalidValue;
  const int cg = C / G;
  const int V = S / 8;
  const int R = kThreads / (V < kThreads ? V : kThreads);
  const long long stats_smem = 4LL * (2 * R * S + S);
  const long long apply_smem = 4LL * (2 * C + 2 * G);
  if (stats_smem > kSmemMax || apply_smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  static unsigned long long set_stats = 0, set_apply = 0;
  int err = allow(gn_stats_kernel, set_stats);
  if (err == 0) err = allow(gn_apply_kernel, set_apply);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_stats_kernel<<<dim3(chunks, C / S, N), kThreads, stats_smem, s>>>(
      static_cast<const bf16*>(x), static_cast<float*>(part), HW, C, S, cg, G,
      rows);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int blocks = (HW + apply_rows - 1) / apply_rows;
  gn_apply_kernel<<<dim3(blocks, N), kThreads, apply_smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(part),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<bf16*>(y), HW, C, G, chunks, apply_rows, eps, silu);
  return (int)cudaGetLastError();
}
