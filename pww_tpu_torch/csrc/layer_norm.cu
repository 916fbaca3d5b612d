// K5 layer_norm: per-token LayerNorm over the last dim, bf16 in, bf16 or
// f32 out.
//
// Replaces pww_tpu/ops/layer_norm.py:layer_norm (Pallas body _ln_kernel).
//
// Bound on the H100: memory. Each row is read once and written once (at the
// largest UNet site, (2, 4096, 320) bf16: 5.2 MB each way, about 3.1 us at
// 3.35 TB/s), with a few flops per element; at the 1280-wide sites, (2, 64)
// and (2, 256) rows, the call is launch latency and one row's dependent
// loads. The design keeps every row in registers and every lane busy:
//   * A row belongs to a group of L lanes (a power of two, at most a warp),
//     each lane owning VPT whole 16-byte column vectors lane, lane + L, ...
//     (coalesced). The wrapper (ops/layer_norm.py:layer_norm_plan) picks
//     L·VPT = C/8 exactly where it can: C = 320 is 8 lanes × 5 vectors, 640
//     16 × 5, 1280 32 × 5, so no lane idles.
//   * A lane loads its columns of w and b into registers once, as vectors
//     (bf16 or f32), then walks rows (a grid-stride loop): all of a row's
//     loads are issued before its shuffles.
//   * The CTA size and grid come from the row count, so that the grid
//     covers the 132 SMs wherever there are at least 132 rows: (2, 64, 1280)
//     is 128 CTAs of one warp, not 16 of eight.
//   * f32 sum and sum of squares, xor-shuffles over the group's lanes,
//     var = max(E[x²] − mean², 0) as in flax's fast variance, rsqrt; the
//     lane writes (x − mean)·rstd·w + b from the registers it holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;  // bf16 values per 16-byte load
constexpr int kMaxVpt = 8;  // C ≤ 32 · 8 · 8 = 2048
constexpr int kMaxThreads = 256;

// One lane's 8 columns of w or b, as loaded.
template <bool kBf16>
struct ParamVec;

template <>
struct ParamVec<true> {
  uint4 raw;
  __device__ __forceinline__ void load(const void* p, int j) {
    raw = static_cast<const uint4*>(p)[j];
  }
  __device__ __forceinline__ float operator[](int t) const {
    const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&raw)[t / 2]);
    return t & 1 ? f.y : f.x;
  }
};

template <>
struct ParamVec<false> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const void* p, int j) {
    const float4* q = static_cast<const float4*>(p) + 2 * j;
    lo = q[0];
    hi = q[1];
  }
  __device__ __forceinline__ float operator[](int t) const {
    return t < 4 ? reinterpret_cast<const float*>(&lo)[t] : reinterpret_cast<const float*>(&hi)[t - 4];
  }
};

template <int VPT, bool kParamBf16>
__global__ void __launch_bounds__(kMaxThreads) ln_rows(
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ weight,
    const void* __restrict__ bias, void* __restrict__ out, int rows, int C, float eps,
    int lanes_log2, int out_f32) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int nvec = C / kVec;
  // the xor-shuffles stay inside the group's lanes of the warp
  const unsigned mask = lanes == 32 ? 0xffffffffu
                                    : ((1u << lanes) - 1) << ((threadIdx.x & 31) & ~(lanes - 1));
  ParamVec<kParamBf16> w[VPT], b[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int j = lane + k * lanes;
    if (j < nvec) {
      w[k].load(weight, j);
      b[k].load(bias, j);
    }
  }
  const int groups = (gridDim.x * blockDim.x) >> lanes_log2;
  for (int row = (blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2; row < rows;
       row += groups) {  // the same rows for all lanes of a group
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
    uint4 raw[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = lane + k * lanes;
      raw[k] = j < nvec ? xr[j] : make_uint4(0u, 0u, 0u, 0u);
    }
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
#pragma unroll
      for (int t = 0; t < kVec / 2; ++t) {
        const float2 f = __bfloat1622float2(p[t]);
        s += f.x + f.y;
        ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
      }
    }
    for (int o = lanes >> 1; o > 0; o >>= 1) {
      s += __shfl_xor_sync(mask, s, o);
      ss += __shfl_xor_sync(mask, ss, o);
    }
    const float mean = s / (float)C;
    const float var = fmaxf(ss / (float)C - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int j = lane + k * lanes;
      if (j >= nvec) continue;
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw[k]);
      float y[kVec];
#pragma unroll
      for (int t = 0; t < kVec / 2; ++t) {
        const float2 f = __bfloat1622float2(p[t]);
        y[2 * t] = (f.x - mean) * (rstd * w[k][2 * t]) + b[k][2 * t];
        y[2 * t + 1] = (f.y - mean) * (rstd * w[k][2 * t + 1]) + b[k][2 * t + 1];
      }
      if (out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)row * C) + 2 * j;
        o[0] = make_float4(y[0], y[1], y[2], y[3]);
        o[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
        uint4 packed;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
        for (int t = 0; t < kVec / 2; ++t) q[t] = __floats2bfloat162_rn(y[2 * t], y[2 * t + 1]);
        reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * C)[j] = packed;
      }
    }
  }
}

template <int VPT>
cudaError_t launch(const void* x, const void* weight, const void* bias, void* out, int rows,
                   int C, float eps, int param_bf16, int out_f32, int lanes_log2, int threads,
                   int grid, cudaStream_t st) {
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (param_bf16) {
    ln_rows<VPT, true><<<grid, threads, 0, st>>>(xb, weight, bias, out, rows, C, eps,
                                                 lanes_log2, out_f32);
  } else {
    ln_rows<VPT, false><<<grid, threads, 0, st>>>(xb, weight, bias, out, rows, C, eps,
                                                  lanes_log2, out_f32);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, C) contiguous bf16, C a multiple of 8 and at most 2048; weight,
// bias (C,) f32 (param_bf16 = 0) or bf16 (1); out (rows, C) bf16 (out_f32 =
// 0) or f32; all 16-byte aligned. The plan (ops/layer_norm.py:
// layer_norm_plan): 2^lanes_log2 lanes per row, vpt vectors a lane
// (lanes · vpt · 8 ≥ C), `threads` per CTA (a multiple of the lanes, and of
// 32 unless it is under 32), `grid` CTAs.
int layer_norm(const void* x, const void* weight, const void* bias, void* out, int rows, int C,
               float eps, int param_bf16, int out_f32, int lanes_log2, int vpt, int threads,
               int grid, void* stream) {
  const int lanes = 1 << lanes_log2;
  if (C % kVec || C <= 0 || lanes_log2 < 0 || lanes_log2 > 5 || vpt < 1 || vpt > kMaxVpt ||
      lanes * vpt * kVec < C || threads < lanes || threads > kMaxThreads ||
      threads % lanes || (threads > 32 && threads % 32) || grid < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(weight) % 16 || reinterpret_cast<uintptr_t>(bias) % 16) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vpt) {
#define PWW_LN_CASE(V) \
  case V:              \
    return launch<V>(x, weight, bias, out, rows, C, eps, param_bf16, out_f32, lanes_log2, threads, grid, st);
    PWW_LN_CASE(1)
    PWW_LN_CASE(2)
    PWW_LN_CASE(3)
    PWW_LN_CASE(4)
    PWW_LN_CASE(5)
    PWW_LN_CASE(6)
    PWW_LN_CASE(7)
    PWW_LN_CASE(8)
#undef PWW_LN_CASE
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
