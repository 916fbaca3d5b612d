// K4 group_norm: GroupNorm over NCHW activations with an optional (N, C)
// pre-add in bf16 and an optional SiLU, written as bf16 or f32.
//
// Replaces pww_tpu/ops/group_norm.py:group_norm, both of its schemes: the
// whole-row kernel _gn_kernel and the chunked pair _gn_stats_kernel /
// _gn_apply_kernel. They exist because of the TPU's VMEM size; on this card
// one kernel and one launch serve every shape.
//
// Bound on the H100: memory. The function reads x once and writes y once
// (at the largest VAE site, (1, 256, 512, 512) bf16: 128 MiB each way,
// about 80 us at 3.35 TB/s), with a few flops per element. x is NCHW, so a
// group's (C/G)·HW elements are one contiguous span. The design reads each
// span from device memory once wherever it fits on chip:
//   * A thread-block cluster of n CTAs (1, 2, 4, 8 or 16) per (sample,
//     group). CTA rank r owns the piece [r·piece, (r+1)·piece) of the span.
//     Its first `resident` elements come into dynamic shared memory by 1-D
//     bulk copies of 16 KB, each completing its own mbarrier, so the CTA
//     sums (x + add, rounded to bf16) and its square in f32 chunk by chunk
//     as the chunks land. The rest of the piece is read from device memory
//     twice, once per pass. The wrapper holds all of a piece or none of it:
//     spans larger than 16 CTAs' shared memory (the streamed regime) go
//     with nothing resident, so that many CTAs share each SM and overlap
//     their loads with their arithmetic, which on the H100 beats holding
//     226 KB of each piece at one CTA per SM (chip_smoke.py times both).
//   * The combine: each CTA publishes its (Σv, Σv²) in shared memory; after
//     a cluster barrier (arrive-release, wait-acquire) every CTA reads all n
//     pairs through distributed shared memory in rank order 0..n-1, so all
//     fold the same values in the same order: one mean and variance per
//     group, bit for bit the same in every run, with no float atomics.
//     var = max(E[x²] − mean², 0) as in flax's fast variance.
//   * It then normalizes its piece from shared memory (and the streamed
//     rest from device memory), v·s + (b[c] − mean·s) with s = rstd·w[c],
//     and the SiLU in f32, and writes y with 16-byte stores. A last cluster
//     barrier keeps a CTA's shared memory alive until the others have read
//     its pair. A lone CTA (n = 1) launches as a plain grid, no barriers.
//   * Threads walk the piece with a running (channel, offset) cursor, so
//     w[c], b[c] and add[n, c] come from shared memory once per vector of 8
//     and no division by HW is left in the loops.
// The wrapper (ops/group_norm.py:group_norm_plan) picks n, the piece and the
// resident part. Spans whose channels are not a multiple of 8 elements, or
// tensors not 16-byte aligned, take the same kernel with scalar loads and
// no bulk copies (kVectors = false): the threads fill the shared memory.
// The pre-add is rounded to bf16 before the statistics, as the unfused
// `h + t` in bf16 is (pww_tpu/ops/group_norm.py:96-100).
//
// The split form, for a site whose rows are cut over ranks (a spatially
// sharded call, pww_tpu_torch/parallel/spatial.py), as the JAX package's
// chunked scheme (the sums kernel _gn_stats_kernel, a group combine, the
// apply kernel _gn_apply_kernel) is split:
//   * gn_stats: a cluster of up to 8 CTAs per (sample, group) streams the
//     rank's span once and folds the CTAs' (Σv, Σv²) in rank order through
//     distributed shared memory, as gn_cluster does; CTA 0 writes the f32
//     (mean, M2) of the span, M2 = count·max(E[v²] − mean², 0).
//   * the caller combines the ranks' pairs (Chan's rule, in rank order) and
//     forms (mean, rstd) per (sample, group);
//   * gn_apply: y = (v − mean)·rstd·w[c] + b[c] (then SiLU), elementwise
//     over x with 16-byte loads and stores, a grid-stride loop.
// Both read x + add rounded to bf16, as gn_cluster does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using pww::warp_sum;

constexpr int kMaxThreads = 512;  // a CTA has 256 or 512 (the plan's choice)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kVec = 8;  // bf16 values per 16-byte load
constexpr int kChunkBytes = 16384;  // one bulk copy and one mbarrier each
constexpr int kChunkElems = kChunkBytes / 2;
constexpr int kMaxChunks = 16;
constexpr int kMaxCluster = 16;
// mbarriers (kMaxChunks × 8 B), warp partials, the CTA's pair, mean/rstd
constexpr int kTailBytes = 320;

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Shared memory of a CTA: [x piece | add, w, b per channel of the group (f32)
// | tail]. ops/group_norm.py:_smem_bytes computes the same.
__host__ __device__ constexpr int smem_bytes(int resident, int cpg) {
  return round16(2 * resident) + round16(12 * cpg) + kTailBytes;
}

__device__ __forceinline__ float param(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// Where a thread's elements lie: channel c (of the group) and offset in it.
// Advancing by one stride of the CTA costs no division.
struct Cursor {
  int c, off, dc, doff, hw;
  __device__ Cursor(int i, int stride, int hw_) : hw(hw_) {
    c = i / hw;
    off = i - c * hw;
    dc = stride / hw;
    doff = stride - dc * hw;
  }
  __device__ __forceinline__ void advance() {
    c += dc;
    off += doff;
    if (off >= hw) {
      off -= hw;
      ++c;
    }
  }
};

template <bool kVectors>
struct Walk {
  static constexpr int kStep = kVectors ? kVec : 1;  // elements per load
  static __device__ __forceinline__ int stride() { return blockDim.x * kStep; }  // per sweep
};

// kStep bf16 values at p as f32.
template <int kStep>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* p, float (&v)[kStep]) {
  if constexpr (kStep == kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// x + add rounded to bf16, as f32 (x itself without a pre-add).
__device__ __forceinline__ float with_add(float x, float a, bool has_add) {
  return has_add ? __bfloat162float(__float2bfloat16(x + a)) : x;
}

struct Group {
  const __nv_bfloat16* x;  // the group's span
  void* out;  // the same span of y
  size_t obase;  // offset of the span in y, in elements
  const float *addc, *wc, *bc;  // per channel of the group, in shared memory
  int hw;
  bool has_add;
};

// (Σv, Σv²) over the thread's elements of [a, b), read from src + (i − base).
template <bool kVectors>
__device__ __forceinline__ void sum_range(const Group& gr, const __nv_bfloat16* src, int base,
                                          int a, int b, float& s, float& ss) {
  using W = Walk<kVectors>;
  int i = a + threadIdx.x * W::kStep;
  if (i >= b) return;
  const int stride = W::stride();
  Cursor cur(i, stride, gr.hw);
#pragma unroll 4
  for (; i < b; i += stride) {
    float v[W::kStep];
    load_vals<W::kStep>(src + (i - base), v);
    const float a_c = gr.addc[cur.c];
#pragma unroll
    for (int j = 0; j < W::kStep; ++j) {
      const float t = with_add(v[j], a_c, gr.has_add);
      s += t;
      ss = fmaf(t, t, ss);
    }
    cur.advance();
  }
}

// Copies the thread's elements of [a, b) from device memory into shared
// memory at dst + (i − a0), summing them on the way (the scalar path's fill).
__device__ __forceinline__ void fill_range(const Group& gr, __nv_bfloat16* dst, int a0, int a,
                                           int b, float& s, float& ss) {
  int i = a + threadIdx.x;
  if (i >= b) return;
  Cursor cur(i, blockDim.x, gr.hw);
  for (; i < b; i += blockDim.x) {
    const __nv_bfloat16 raw = gr.x[i];
    dst[i - a0] = raw;
    const float t = with_add(__bfloat162float(raw), gr.addc[cur.c], gr.has_add);
    s += t;
    ss = fmaf(t, t, ss);
    cur.advance();
  }
}

// y = (v − mean)·rstd·w[c] + b[c] (then SiLU) for the thread's elements of
// [a, b), read from src + (i − base), written to y at obase + i. Per
// element one FMA, v·scale + shift, with scale and shift formed per channel.
template <bool kVectors>
__device__ __forceinline__ void norm_range(const Group& gr, const __nv_bfloat16* src, int base,
                                           int a, int b, float mean, float rstd, bool silu,
                                           bool out_f32) {
  using W = Walk<kVectors>;
  int i = a + threadIdx.x * W::kStep;
  if (i >= b) return;
  const int stride = W::stride();
  Cursor cur(i, stride, gr.hw);
#pragma unroll 2
  for (; i < b; i += stride) {
    float v[W::kStep];
    load_vals<W::kStep>(src + (i - base), v);
    const float a_c = gr.addc[cur.c];
    const float sc = rstd * gr.wc[cur.c], sh = fmaf(-mean, sc, gr.bc[cur.c]);
#pragma unroll
    for (int j = 0; j < W::kStep; ++j) {
      float y = fmaf(with_add(v[j], a_c, gr.has_add), sc, sh);
      if (silu) y = __fdividef(y, 1.f + __expf(-y));
      v[j] = y;
    }
    const size_t o = gr.obase + i;
    if constexpr (kVectors) {
      if (out_f32) {
        float4* q = reinterpret_cast<float4*>(static_cast<float*>(gr.out) + o);
        q[0] = make_float4(v[0], v[1], v[2], v[3]);
        q[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 raw;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(gr.out) + o) = raw;
      }
    } else if (out_f32) {
      static_cast<float*>(gr.out)[o] = v[0];
    } else {
      static_cast<__nv_bfloat16*>(gr.out)[o] = __float2bfloat16(v[0]);
    }
    cur.advance();
  }
}

// grid: cluster · N·G CTAs in clusters of `cluster` along x, one cluster per
// (sample, group); 256 or 512 threads a CTA.
template <bool kVectors>
__global__ void __launch_bounds__(kMaxThreads) gn_cluster(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ add,
    const void* __restrict__ weight, const void* __restrict__ bias, void* __restrict__ out,
    int C, int HW, int G, int cluster, int piece, int resident, float eps, int silu,
    int param_bf16, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpg = C / G, span = cpg * HW;
  const int ng = blockIdx.x / cluster, rank = blockIdx.x - ng * cluster;
  const int n = ng / G, c0 = (ng - n * G) * cpg;
  const int p0 = min(rank * piece, span), p1 = min(p0 + piece, span);
  const int r1 = min(p0 + resident, p1);  // [p0, r1) in shared memory, [r1, p1) streamed

  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* addc = reinterpret_cast<float*>(smem + round16(2 * resident));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + round16(2 * resident) + round16(12 * cpg));
  float2* warp_part = reinterpret_cast<float2*>(bars + kMaxChunks);
  float2* pair = warp_part + kMaxWarps;  // this CTA's (Σv, Σv²), read by the cluster
  float2* stats = pair + 1;  // (mean, rstd)

  const Group gr{x + (size_t)ng * span, out, (size_t)ng * span, addc, addc + cpg,
                 addc + 2 * cpg, HW, add != nullptr};
  const int nchunks = kVectors ? (r1 - p0 + kChunkElems - 1) / kChunkElems : 0;
  if (threadIdx.x == 0 && nchunks > 0) {  // the copies first: the rest waits on them
    for (int k = 0; k < nchunks; ++k) pww::mbar_init(pww::smem_u32(&bars[k]), 1);
    pww::fence_mbarrier_init();
    for (int k = 0; k < nchunks; ++k) {
      const int bytes = min(kChunkBytes, 2 * (r1 - p0) - k * kChunkBytes);
      const uint32_t bar = pww::smem_u32(&bars[k]);
      pww::mbar_expect_tx(bar, bytes);
      pww::bulk_load(pww::smem_u32(xs + k * kChunkElems), gr.x + p0 + k * kChunkElems, bytes,
                     bar);
    }
  }
  for (int i = threadIdx.x; i < cpg; i += blockDim.x) {
    addc[i] = add == nullptr ? 0.f : __bfloat162float(add[(size_t)n * C + c0 + i]);
    addc[cpg + i] = param(weight, c0 + i, param_bf16);
    addc[2 * cpg + i] = param(bias, c0 + i, param_bf16);
  }
  __syncthreads();  // the mbarriers' init and the parameters are visible

  // pass 1: the streamed rest from device memory while the copies land,
  // then the resident chunks in order
  float s = 0.f, ss = 0.f;
  sum_range<kVectors>(gr, gr.x, 0, r1, p1, s, ss);
  if constexpr (kVectors) {
    for (int k = 0; k < nchunks; ++k) {
      pww::mbar_wait(pww::smem_u32(&bars[k]), 0);
      sum_range<kVectors>(gr, xs, p0, p0 + k * kChunkElems,
                          min(r1, p0 + (k + 1) * kChunkElems), s, ss);
    }
  } else {
    fill_range(gr, xs, p0, p0, r1, s, ss);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = make_float2(s, ss);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {  // warp 0: the CTA's pair, a fixed butterfly over the warps
    const float2 p = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : make_float2(0.f, 0.f);
    const float ps = warp_sum(p.x), pss = warp_sum(p.y);
    if (lane == 0) *pair = make_float2(ps, pss);
  }

  // the combine: every CTA folds the cluster's pairs in rank order (a lone
  // CTA needs no cluster barrier); lane r of warp 0 reads rank r's pair
  if (cluster > 1) {
    pww::cluster_arrive();
    pww::cluster_wait();
  }
  if (threadIdx.x < 32) {
    float2 p = make_float2(0.f, 0.f);
    if (cluster == 1) {
      if (lane == 0) p = *pair;
    } else if (lane < cluster) {
      p = pww::cluster_load_f2(pww::cluster_map(pww::smem_u32(pair), lane));
    }
    float ts = __shfl_sync(0xffffffffu, p.x, 0), tss = __shfl_sync(0xffffffffu, p.y, 0);
    for (int r = 1; r < cluster; ++r) {
      ts += __shfl_sync(0xffffffffu, p.x, r);
      tss += __shfl_sync(0xffffffffu, p.y, r);
    }
    if (lane == 0) {
      const float count = (float)span;
      const float mean = ts / count;
      const float var = fmaxf(tss / count - mean * mean, 0.f);
      *stats = make_float2(mean, rsqrtf(var + eps));
    }
  }
  if (cluster > 1) pww::cluster_arrive();  // this CTA has read the others' pairs
  __syncthreads();
  const float mean = stats->x, rstd = stats->y;

  // pass 2: normalize the resident part from shared memory, the rest from
  // device memory again
  norm_range<kVectors>(gr, xs, p0, p0, r1, mean, rstd, silu, out_f32);
  norm_range<kVectors>(gr, gr.x, 0, r1, p1, mean, rstd, silu, out_f32);
  if (cluster > 1) pww::cluster_wait();  // no CTA leaves while another may read its pair
}

// Once per device and kernel: the shared-memory opt-in and clusters of 16.
template <bool kVectors>
cudaError_t configure() {
  static std::atomic<unsigned long long> smem_set{0}, cluster_set{0};
  const void* fn = reinterpret_cast<const void*>(gn_cluster<kVectors>);
  cudaError_t e = pww::allow_max_shared_memory(fn, smem_set);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (cluster_set.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(gn_cluster<kVectors>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1);
  if (e == cudaSuccess) cluster_set.fetch_or(bit, std::memory_order_release);
  return e;
}

template <bool kVectors>
cudaError_t launch(const void* x, const void* add, const void* weight, const void* bias,
                   void* out, int N, int C, int HW, int G, int cluster, int piece, int resident,
                   int threads, float eps, int silu, int param_bf16, int out_f32,
                   cudaStream_t st) {
  cudaError_t e = configure<kVectors>();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * N * G));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes(resident, C / G);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1;  // a lone CTA launches as a plain grid
  e = cudaLaunchKernelEx(&cfg, gn_cluster<kVectors>, static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(add), weight, bias, out, C, HW, G,
                         cluster, piece, resident, eps, silu, param_bf16, out_f32);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// grid: cluster · N·G CTAs in clusters of `cluster` (1-8) along x; 256
// threads; dynamic shared memory: the group's add per channel (f32).
template <bool kVectors>
__global__ void __launch_bounds__(256) gn_stats(const __nv_bfloat16* __restrict__ x,
                                                const __nv_bfloat16* __restrict__ add, int C,
                                                int HW, int G, int cluster, int piece,
                                                float2* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 warp_part[kMaxWarps];
  __shared__ float2 pair;
  const int cpg = C / G, span = cpg * HW;
  const int ng = blockIdx.x / cluster, rank = blockIdx.x - ng * cluster;
  const int n = ng / G, c0 = (ng - n * G) * cpg;
  const int p0 = min(rank * piece, span), p1 = min(p0 + piece, span);
  float* addc = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < cpg; i += blockDim.x)
    addc[i] = add == nullptr ? 0.f : __bfloat162float(add[(size_t)n * C + c0 + i]);
  __syncthreads();
  const Group gr{x + (size_t)ng * span, nullptr, 0, addc, nullptr, nullptr, HW, add != nullptr};
  float s = 0.f, ss = 0.f;
  sum_range<kVectors>(gr, gr.x, 0, p0, p1, s, ss);
  s = warp_sum(s);
  ss = warp_sum(ss);
  const int lane = threadIdx.x & 31;
  if (lane == 0) warp_part[threadIdx.x >> 5] = make_float2(s, ss);
  __syncthreads();
  if (threadIdx.x < 32) {
    const float2 p = lane < (int)(blockDim.x >> 5) ? warp_part[lane] : make_float2(0.f, 0.f);
    const float ps = warp_sum(p.x), pss = warp_sum(p.y);
    if (lane == 0) pair = make_float2(ps, pss);
  }
  if (cluster > 1) {
    pww::cluster_arrive();
    pww::cluster_wait();
  } else {
    __syncthreads();
  }
  if (rank == 0 && threadIdx.x < 32) {  // CTA 0 folds the cluster's pairs in rank order
    float2 p = make_float2(0.f, 0.f);
    if (cluster == 1) {
      if (lane == 0) p = pair;
    } else if (lane < cluster) {
      p = pww::cluster_load_f2(pww::cluster_map(pww::smem_u32(&pair), lane));
    }
    float ts = __shfl_sync(0xffffffffu, p.x, 0), tss = __shfl_sync(0xffffffffu, p.y, 0);
    for (int r = 1; r < cluster; ++r) {
      ts += __shfl_sync(0xffffffffu, p.x, r);
      tss += __shfl_sync(0xffffffffu, p.y, r);
    }
    if (lane == 0) {
      const float count = (float)span;
      const float mean = ts / count;
      stats[ng] = make_float2(mean, count * fmaxf(tss / count - mean * mean, 0.f));
    }
  }
  if (cluster > 1) {  // no CTA leaves while CTA 0 may read its pair
    pww::cluster_arrive();
    pww::cluster_wait();
  }
}

// stats: (N·G) f32 (mean, rstd); a grid-stride loop over x, kStep elements
// (one channel's) per load.
template <bool kVectors>
__global__ void __launch_bounds__(256) gn_apply(const __nv_bfloat16* __restrict__ x,
                                                const __nv_bfloat16* __restrict__ add,
                                                const void* __restrict__ weight,
                                                const void* __restrict__ bias,
                                                const float2* __restrict__ stats,
                                                void* __restrict__ out, int C, int HW, int G,
                                                long long total, int silu, int param_bf16,
                                                int out_f32) {
  constexpr int kStep = Walk<kVectors>::kStep;
  const int cpg = C / G;
  const long long stride = (long long)gridDim.x * blockDim.x * kStep;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kStep; i < total;
       i += stride) {
    const long long nc = i / HW;
    const int c = (int)(nc % C), n = (int)(nc / C);
    const float2 st = stats[(size_t)n * G + c / cpg];
    const float a_c = add == nullptr ? 0.f : __bfloat162float(add[nc]);
    const float sc = st.y * param(weight, c, param_bf16);
    const float sh = fmaf(-st.x, sc, param(bias, c, param_bf16));
    float v[kStep];
    load_vals<kStep>(x + i, v);
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      float y = fmaf(with_add(v[j], a_c, add != nullptr), sc, sh);
      if (silu) y = __fdividef(y, 1.f + __expf(-y));
      v[j] = y;
    }
    if constexpr (kVectors) {
      if (out_f32) {
        float4* q = reinterpret_cast<float4*>(static_cast<float*>(out) + i);
        q[0] = make_float4(v[0], v[1], v[2], v[3]);
        q[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 raw;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + i) = raw;
      }
    } else if (out_f32) {
      static_cast<float*>(out)[i] = v[0];
    } else {
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v[0]);
    }
  }
}

template <bool kVectors>
cudaError_t launch_stats(const void* x, const void* add, void* stats, int N, int C, int HW,
                         int G, int cluster, int piece, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * N * G));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = round16(4 * (C / G));
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, gn_stats<kVectors>,
                                     static_cast<const __nv_bfloat16*>(x),
                                     static_cast<const __nv_bfloat16*>(add), C, HW, G, cluster,
                                     piece, static_cast<float2*>(stats));
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// *n = the largest cluster (16, 8, 4, 2 or 1 CTAs) that the card can place
// when every CTA takes all the shared memory a CTA may opt in to.
int group_norm_max_cluster(int* n) {
  cudaError_t e = configure<true>();
  if (e != cudaSuccess) return e;
  int dev = 0, optin = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(kMaxThreads);
    cfg.dynamicSmemBytes = optin;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, gn_cluster<true>, &cfg);
    if (e != cudaSuccess) return e;
    if (active > 0) {
      *n = c;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// x (N, C, HW) contiguous bf16; add (N, C) bf16 or null; weight, bias (C,)
// f32 (param_bf16 = 0) or bf16 (1); out (N, C, HW) bf16 (out_f32 = 0) or
// f32. The plan (ops/group_norm.py:group_norm_plan): `cluster` CTAs of
// `threads` (256 or 512) per (sample, group), each owning `piece` elements
// of the group's span (a multiple of 8; cluster · piece ≥ span), the first
// `resident` of them (a multiple of 8, at most piece) held in shared memory.
int group_norm(const void* x, const void* add, const void* weight, const void* bias, void* out,
               int N, int C, int HW, int G, int cluster, int piece, int resident, int threads,
               float eps, int silu, int param_bf16, int out_f32, void* stream) {
  if (G <= 0 || C % G || HW <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long span = (long long)(C / G) * HW;
  if ((cluster & (cluster - 1)) || cluster < 1 || cluster > kMaxCluster || piece % kVec ||
      resident % kVec || resident < 0 || resident > piece || (long long)cluster * piece < span ||
      span + piece > INT_MAX || (long long)cluster * N * G > INT_MAX ||
      round16(2 * resident) > kMaxChunks * kChunkBytes || (threads != 256 && threads != 512)) {
    return cudaErrorInvalidValue;
  }
  // 16-byte loads and bulk copies need every channel to start on a 16-byte
  // boundary
  const bool vectors = HW % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vectors ? launch<true>(x, add, weight, bias, out, N, C, HW, G, cluster, piece,
                                resident, threads, eps, silu, param_bf16, out_f32, st)
                 : launch<false>(x, add, weight, bias, out, N, C, HW, G, cluster, piece,
                                 resident, threads, eps, silu, param_bf16, out_f32, st);
}

// The split form's statistics: x (N, C, HW) contiguous bf16 (a rank's rows
// of each channel), add (N, C) bf16 or null; stats (N·G) f32 pairs (mean,
// M2) over each (sample, group)'s C/G·HW elements. `cluster` (1, 2, 4 or 8)
// CTAs of 256 threads per (sample, group), each owning `piece` elements (a
// multiple of 8; cluster · piece ≥ the span): ops/group_norm.py:
// group_norm_stats_plan.
int group_norm_stats(const void* x, const void* add, void* stats, int N, int C, int HW, int G,
                     int cluster, int piece, void* stream) {
  if (G <= 0 || C % G || HW <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long span = (long long)(C / G) * HW;
  if ((cluster & (cluster - 1)) || cluster < 1 || cluster > 8 || piece % kVec || piece <= 0 ||
      (long long)cluster * piece < span || span + piece > INT_MAX ||
      (long long)cluster * N * G > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const bool vectors = HW % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vectors ? launch_stats<true>(x, add, stats, N, C, HW, G, cluster, piece, st)
                 : launch_stats<false>(x, add, stats, N, C, HW, G, cluster, piece, st);
}

// The split form's normalization: x (N, C, HW) contiguous bf16, add (N, C)
// bf16 or null, weight/bias (C,) f32 (param_bf16 = 0) or bf16, stats (N·G)
// f32 pairs (mean, rstd); out (N, C, HW) bf16 (out_f32 = 0) or f32.
int group_norm_apply(const void* x, const void* add, const void* weight, const void* bias,
                     const void* stats, void* out, int N, int C, int HW, int G, int silu,
                     int param_bf16, int out_f32, void* stream) {
  if (G <= 0 || C % G || HW <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long total = (long long)N * C * HW;
  const bool vectors = HW % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vectors ? total / kVec : total;
  const int blocks = (int)std::min<long long>((units + 255) / 256, 132LL * 8);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(add);
  const float2* sb = static_cast<const float2*>(stats);
  if (vectors) {
    gn_apply<true><<<blocks, 256, 0, st>>>(xb, ab, weight, bias, sb, out, C, HW, G, total, silu,
                                           param_bf16, out_f32);
  } else {
    gn_apply<false><<<blocks, 256, 0, st>>>(xb, ab, weight, bias, sb, out, C, HW, G, total,
                                            silu, param_bf16, out_f32);
  }
  return cudaGetLastError();
}

}  // extern "C"
