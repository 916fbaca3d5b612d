// K1 pww_reduce: the paint-with-words weight function's per-sample
// reduction r[b] = reduce(Q K^T) over (heads, Lq, Lk), without the score
// tensor ever reaching device memory.
//
// Replaces pww_tpu/ops/cross_attention_kernel.py:fused_pww_reduce (Pallas
// body _reduce_kernel).
//
// Bound on the H100: memory. Every Q and K element is read once (at 512²,
// Lq 4096, dh 40, B·H 16: 5.2 MB of Q, about 1.6 us at 3.35 TB/s) while the
// 2·B·H·Lq·Lk·dh flops are far below the card's ridge point. The design
// keeps the scores on chip: one CTA per (b·h, tile of query rows) stages K
// (Lk × dh) and its Q rows in shared memory, computes the tile's scores in
// f32 into shared memory and reduces them there to one partial
// (block max; block sum; or block mean and M2 for std). A second, tiny
// kernel with one CTA per sample combines the partials in a fixed order
// (max, sum / n, or Chan's parallel update, then sqrt(M2 / (n - 1))), so the
// result is the same from run to run: no float atomics anywhere. The score
// loops run to the real Lk; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using pww::warp_max;
using pww::warp_sum;

constexpr int kThreads = 256;
constexpr int kRowsPerCta = 32;  // query rows per partial
enum Mode { kMax = 0, kMean = 1, kStd = 2 };

// Block-wide sum or max in a fixed order; every thread gets the result.
template <bool kIsMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  v = kIsMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < kThreads / 32 ? red[lane] : (kIsMax ? -INFINITY : 0.f);
    x = kIsMax ? warp_max(x) : warp_sum(x);
    if (lane == 0) red[0] = x;
  }
  __syncthreads();
  return red[0];
}

// One partial per (b·h, query tile). part[(bh * nq + tile)] = (a, b).
__global__ void __launch_bounds__(kThreads) reduce_partials(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    float2* __restrict__ part, int Lq, int Lk, int dh, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  const int ld = dh + 2;  // bf16 row stride: an odd number of 4-byte words
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ks + Lk * ld;
  float* ss = reinterpret_cast<float*>(qs + kRowsPerCta * ld);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRowsPerCta;
  const int rows = min(kRowsPerCta, Lq - q0);
  const int half = dh / 2;
  const __nv_bfloat162* kg =
      reinterpret_cast<const __nv_bfloat162*>(k + (size_t)bh * Lk * dh);
  const __nv_bfloat162* qg =
      reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)bh * Lq + q0) * dh);
  for (int i = threadIdx.x; i < Lk * half; i += kThreads) {
    const int r = i / half, c = i - r * half;
    reinterpret_cast<__nv_bfloat162*>(ks + r * ld)[c] = kg[i];
  }
  for (int i = threadIdx.x; i < rows * half; i += kThreads) {
    const int r = i / half, c = i - r * half;
    reinterpret_cast<__nv_bfloat162*>(qs + r * ld)[c] = qg[i];
  }
  __syncthreads();

  const int n = rows * Lk;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / Lk, c = i - r * Lk;
    const __nv_bfloat162* qa = reinterpret_cast<const __nv_bfloat162*>(qs + r * ld);
    const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(ks + c * ld);
    float acc = 0.f;
    for (int d = 0; d < half; ++d) {
      const float2 a = __bfloat1622float2(qa[d]);
      const float2 b = __bfloat1622float2(ka[d]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
    ss[i] = acc;
  }
  __syncthreads();

  float a, b;
  if (mode == kMax) {
    float m = -INFINITY;
    for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, ss[i]);
    a = b = block_reduce<true>(m, red);
  } else {
    float s = 0.f;
    for (int i = threadIdx.x; i < n; i += kThreads) s += ss[i];
    s = block_reduce<false>(s, red);
    if (mode == kMean) {
      a = b = s;
    } else {
      const float mean = s / (float)n;
      float m2 = 0.f;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const float d = ss[i] - mean;
        m2 = fmaf(d, d, m2);
      }
      a = mean;
      b = block_reduce<false>(m2, red);
    }
  }
  if (threadIdx.x == 0) part[(size_t)bh * gridDim.x + blockIdx.x] = make_float2(a, b);
}

// Chan et al.'s parallel update: merge moments (nb, mb, m2b) into (na, ma, m2a).
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb; ma = mb; m2a = m2b;
    return;
  }
  const float nt = na + nb;
  const float d = mb - ma;
  ma += d * (nb / nt);
  m2a += m2b + d * d * (na * nb / nt);
  na = nt;
}

// One CTA per sample: each thread folds a contiguous run of the sample's
// H·nq partials in order, then a fixed-shape tree merges the threads.
__global__ void __launch_bounds__(kThreads) reduce_combine(
    const float2* __restrict__ part, float* __restrict__ out, int H, int nq,
    int Lq, int Lk, int mode) {
  __shared__ float sn[kThreads], sa[kThreads], sb[kThreads];
  const int m = H * nq;
  const float2* p = part + (size_t)blockIdx.x * m;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per, hi = min(lo + per, m);
  float cn = 0.f, ca = mode == kMax ? -INFINITY : 0.f, cb = 0.f;
  for (int i = lo; i < hi; ++i) {
    const float2 v = p[i];
    const int tile = i % nq;
    const float nb = (float)(min(kRowsPerCta, Lq - tile * kRowsPerCta) * Lk);
    if (mode == kMax) {
      ca = fmaxf(ca, v.x);
    } else if (mode == kMean) {
      ca += v.x;
    } else {
      chan_merge(cn, ca, cb, nb, v.x, v.y);
    }
  }
  sn[threadIdx.x] = cn;
  sa[threadIdx.x] = ca;
  sb[threadIdx.x] = cb;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const int j = threadIdx.x + s;
      if (mode == kMax) {
        sa[threadIdx.x] = fmaxf(sa[threadIdx.x], sa[j]);
      } else if (mode == kMean) {
        sa[threadIdx.x] += sa[j];
      } else {
        float na = sn[threadIdx.x], ma = sa[threadIdx.x], m2a = sb[threadIdx.x];
        chan_merge(na, ma, m2a, sn[j], sa[j], sb[j]);
        sn[threadIdx.x] = na;
        sa[threadIdx.x] = ma;
        sb[threadIdx.x] = m2a;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double n = (double)H * Lq * Lk;
    float r;
    if (mode == kMax) {
      r = sa[0];
    } else if (mode == kMean) {
      r = (float)(sa[0] / n);
    } else {
      r = sqrtf(fmaxf((float)(sb[0] / fmax(n - 1.0, 1.0)), 0.f));
    }
    out[blockIdx.x] = r;
  }
}

}  // namespace

extern "C" {

// Query rows folded into one partial: the wrapper sizes the scratch with it.
int pww_reduce_rows_per_cta() { return kRowsPerCta; }

// q (B,H,Lq,dh), k (B,H,Lk,dh): contiguous bf16, dh even. part: float2 scratch
// of B·H·ceil(Lq/kRowsPerCta) entries. out: (B,) f32.
int pww_reduce(const void* q, const void* k, void* part, void* out, int B,
               int H, int Lq, int Lk, int dh, int mode, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nq = (Lq + kRowsPerCta - 1) / kRowsPerCta;
  const size_t smem = (size_t)(Lk + kRowsPerCta) * (dh + 2) * sizeof(__nv_bfloat16) +
                      (size_t)kRowsPerCta * Lk * sizeof(float);
  cudaError_t e = pww::allow_max_shared_memory(
      reinterpret_cast<const void*>(reduce_partials), smem_set);
  if (e != cudaSuccess) return e;
  reduce_partials<<<dim3(nq, B * H), kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<float2*>(part), Lq, Lk, dh, mode);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_combine<<<B, kThreads, 0, st>>>(static_cast<const float2*>(part),
                                         static_cast<float*>(out), H, nq, Lq,
                                         Lk, mode);
  return cudaGetLastError();
}

}  // extern "C"
