// K4 group_norm: GroupNorm over NCHW activations with an optional (N, C)
// pre-add in bf16 and an optional SiLU, written as bf16 or f32.
//
// Replaces pww_tpu/ops/group_norm.py:group_norm, both of its schemes: the
// whole-row kernel _gn_kernel and the chunked pair _gn_stats_kernel /
// _gn_apply_kernel. They exist because of the TPU's VMEM size; on this card
// one design serves every shape.
//
// Bound on the H100: memory. The function reads x once and writes y once
// (at the largest VAE site, (1, 256, 512, 512) bf16: 128 MiB each way,
// about 80 us at 3.35 TB/s), with a few flops per element. The design
// reads x twice: x is NCHW, so a group's (C/G)·HW elements are one
// contiguous span, cut into chunks of kChunk elements.
//   1. gn_stats: one CTA per (chunk, n·G) sums x + add and its square in f32
//      and writes the pair to a scratch buffer. A group of a UNet site at
//      8² (2,560 or 5,120 elements) gets 1 or 2 CTAs, one of a VAE site at
//      512² (2M elements) 512: from 64 CTAs at the smallest site, where
//      launch latency dominates anyway, to 16,384 at the largest.
//   2. gn_apply: one CTA per (chunk, n·G) again. Each folds its group's
//      partials in a fixed order (every CTA of a group runs the same
//      instructions on the same values, so all see the same mean and
//      variance, and a run repeats bit for bit: no float atomics), forms
//      var = max(E[x²] − mean², 0) and rsqrt(var + eps), re-reads its chunk
//      (from L2 when the slab is under about 40 MB), applies
//      (x − mean)·rstd·w + b and the SiLU in f32, and stores.
// The pre-add is rounded to bf16 before the statistics, as the unfused
// `h + t` in bf16 is (pww_tpu/ops/group_norm.py:96-100).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using pww::warp_sum;

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values per 16-byte load
constexpr int kChunk = kThreads * kVec * 2;  // elements per CTA: two loads a thread

struct Elem {
  const __nv_bfloat16* x;  // the group's span
  const __nv_bfloat16* add;  // (C,) row of this sample, offset to the group; or null
  int hw;
};

// x + add at offset i of the group's span, rounded to bf16, as f32.
__device__ __forceinline__ float load_one(const Elem& e, int i, float xv) {
  if (e.add == nullptr) return xv;
  const float a = __bfloat162float(e.add[i / e.hw]);
  return __bfloat162float(__float2bfloat16(xv + a));
}

// The 8 values at offsets i..i+7 (i a multiple of 8, inside the span).
__device__ __forceinline__ void load8(const Elem& e, int i, float v[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(e.x + i);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const float2 f = __bfloat1622float2(p[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
  if (e.add != nullptr) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = load_one(e, i + j, v[j]);
  }
}

// Block-wide sums of (a, b) in a fixed order; every thread gets them.
__device__ float2 block_sum2(float a, float b) {
  __shared__ float ra[kThreads / 32], rb[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // ra/rb may still be read by a previous call
  if (lane == 0) {
    ra[warp] = a;
    rb[warp] = b;
  }
  __syncthreads();
  a = lane < kThreads / 32 ? ra[lane] : 0.f;
  b = lane < kThreads / 32 ? rb[lane] : 0.f;
  return make_float2(warp_sum(a), warp_sum(b));
}

__device__ __forceinline__ Elem group_elems(const __nv_bfloat16* x,
                                            const __nv_bfloat16* add, int C,
                                            int HW, int G, int span) {
  const int ng = blockIdx.y, n = ng / G, g = ng - n * G;
  return Elem{x + (size_t)ng * span,
              add == nullptr ? nullptr : add + (size_t)n * C + (size_t)g * (C / G), HW};
}

// grid (chunks, N·G): part[ng · chunks + chunk] = (Σ v, Σ v²) over the chunk.
template <bool kVectors>
__global__ void __launch_bounds__(kThreads) gn_stats(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ add,
    float2* __restrict__ part, int C, int HW, int G) {
  const int span = (C / G) * HW;
  const Elem e = group_elems(x, add, C, HW, G, span);
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, span);
  float s = 0.f, ss = 0.f;
  if (kVectors) {
    for (int i = c0 + threadIdx.x * kVec; i < c1; i += kThreads * kVec) {
      float v[kVec];
      load8(e, i, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s += v[j];
        ss = fmaf(v[j], v[j], ss);
      }
    }
  } else {
    for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
      const float v = load_one(e, i, __bfloat162float(e.x[i]));
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  const float2 t = block_sum2(s, ss);
  if (threadIdx.x == 0) part[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t;
}

__device__ __forceinline__ float param(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

// grid (chunks, N·G): fold the group's partials, then normalize the chunk.
template <bool kVectors>
__global__ void __launch_bounds__(kThreads) gn_apply(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ add,
    const void* __restrict__ weight, const void* __restrict__ bias,
    const float2* __restrict__ part, void* __restrict__ out, int C, int HW, int G,
    float eps, int silu, int param_bf16, int out_f32) {
  const int span = (C / G) * HW;
  const Elem e = group_elems(x, add, C, HW, G, span);
  const int nchunk = gridDim.x;
  const float2* p = part + (size_t)blockIdx.y * nchunk;
  float s = 0.f, ss = 0.f;
  for (int i = threadIdx.x; i < nchunk; i += kThreads) {
    s += p[i].x;
    ss += p[i].y;
  }
  const float2 t = block_sum2(s, ss);
  const float count = (float)span;
  const float mean = t.x / count;
  const float var = fmaxf(t.y / count - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  const int g = blockIdx.y % G;
  const int cbase = g * (C / G);
  const size_t obase = (size_t)blockIdx.y * span;
  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, span);
  auto norm = [&](int i, float v) {
    const int c = cbase + i / HW;
    float y = (v - mean) * (rstd * param(weight, c, param_bf16)) + param(bias, c, param_bf16);
    if (silu) y = y / (1.f + expf(-y));
    return y;
  };
  if (kVectors) {
    for (int i = c0 + threadIdx.x * kVec; i < c1; i += kThreads * kVec) {
      float v[kVec];
      load8(e, i, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) v[j] = norm(i + j, v[j]);
      if (out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + obase + i);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 raw;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j) q[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + obase + i) = raw;
      }
    }
  } else {
    for (int i = c0 + threadIdx.x; i < c1; i += kThreads) {
      const float y = norm(i, load_one(e, i, __bfloat162float(e.x[i])));
      if (out_f32) {
        static_cast<float*>(out)[obase + i] = y;
      } else {
        static_cast<__nv_bfloat16*>(out)[obase + i] = __float2bfloat16(y);
      }
    }
  }
}

}  // namespace

extern "C" {

// Elements of a group per partial: the wrapper sizes the scratch with it.
int group_norm_chunk_elems() { return kChunk; }

// x (N, C, HW) contiguous bf16; add (N, C) bf16 or null; weight, bias (C,) f32
// (param_bf16 = 0) or bf16 (1); part: float2 scratch of
// N·G·ceil(C/G·HW / kChunk) entries; out (N, C, HW) bf16 (out_f32 = 0) or f32.
int group_norm(const void* x, const void* add, const void* weight, const void* bias,
               void* part, void* out, int N, int C, int HW, int G, float eps, int silu,
               int param_bf16, int out_f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t span = (size_t)(C / G) * HW;
  if (span + kChunk > INT_MAX || N * G > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((span + kChunk - 1) / kChunk), (unsigned)(N * G));
  // 16-byte loads need every group to start on a 16-byte boundary
  const bool vectors = span % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ab = static_cast<const __nv_bfloat16*>(add);
  float2* pf = static_cast<float2*>(part);
  if (vectors) {
    gn_stats<true><<<grid, kThreads, 0, st>>>(xb, ab, pf, C, HW, G);
  } else {
    gn_stats<false><<<grid, kThreads, 0, st>>>(xb, ab, pf, C, HW, G);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (vectors) {
    gn_apply<true><<<grid, kThreads, 0, st>>>(xb, ab, weight, bias, pf, out, C, HW, G,
                                              eps, silu, param_bf16, out_f32);
  } else {
    gn_apply<false><<<grid, kThreads, 0, st>>>(xb, ab, weight, bias, pf, out, C, HW, G,
                                               eps, silu, param_bf16, out_f32);
  }
  return cudaGetLastError();
}

}  // extern "C"
