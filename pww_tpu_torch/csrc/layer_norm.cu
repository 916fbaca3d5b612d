// K5 layer_norm: per-token LayerNorm over the last dim, bf16 in, bf16 or
// f32 out.
//
// Replaces pww_tpu/ops/layer_norm.py:layer_norm (Pallas body _ln_kernel).
//
// Bound on the H100: memory. Each row is read once and written once (at the
// largest UNet site, (2, 4096, 320) bf16: 5.2 MB each way, about 3.1 us at
// 3.35 TB/s), with a few flops per element. The design reads each row once:
// one warp per row, 8 rows per CTA, each lane loading the row's 16-byte
// vectors lane, lane + 32, ... (coalesced) into registers (C ≤ 2048, so at
// most 8 vectors a lane). Shuffles form the f32 sum and sum of squares,
// var = max(E[x²] − mean², 0) as in flax's fast variance, and the lane
// writes (x − mean)·rstd·w + b from the registers it holds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using pww::warp_sum;

constexpr int kWarps = 8;  // rows per CTA
constexpr int kVec = 8;  // bf16 values per 16-byte load
constexpr int kMaxVecPerLane = 8;  // C ≤ 32 · 8 · 8 = 2048

__device__ __forceinline__ float param(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__global__ void __launch_bounds__(kWarps * 32) ln_rows(
    const __nv_bfloat16* __restrict__ x, const void* __restrict__ weight,
    const void* __restrict__ bias, void* __restrict__ out, int rows, int C, float eps,
    int param_bf16, int out_f32) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int nvec = C / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[kMaxVecPerLane][kVec];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxVecPerLane; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      const uint4 raw = xr[j];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int t = 0; t < kVec / 2; ++t) {
        const float2 f = __bfloat1622float2(p[t]);
        v[k][2 * t] = f.x;
        v[k][2 * t + 1] = f.y;
        s += f.x + f.y;
        ss = fmaf(f.x, f.x, fmaf(f.y, f.y, ss));
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / (float)C;
  const float var = fmaxf(ss / (float)C - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < kMaxVecPerLane; ++k) {
    const int j = lane + 32 * k;
    if (j < nvec) {
      float y[kVec];
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const int c = j * kVec + t;
        y[t] = (v[k][t] - mean) * (rstd * param(weight, c, param_bf16)) +
               param(bias, c, param_bf16);
      }
      if (out_f32) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)row * C) +
                    2 * j;
        o[0] = make_float4(y[0], y[1], y[2], y[3]);
        o[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
        uint4 raw;
        __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int t = 0; t < kVec / 2; ++t) q[t] = __floats2bfloat162_rn(y[2 * t], y[2 * t + 1]);
        reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + (size_t)row * C)[j] = raw;
      }
    }
  }
}

}  // namespace

extern "C" {

// x (rows, C) contiguous bf16, 16-byte aligned, C a multiple of 8 and at most
// 2048; weight, bias (C,) f32 (param_bf16 = 0) or bf16 (1); out (rows, C)
// bf16 (out_f32 = 0) or f32.
int layer_norm(const void* x, const void* weight, const void* bias, void* out, int rows,
               int C, float eps, int param_bf16, int out_f32, void* stream) {
  if (C % kVec || C > 32 * kVec * kMaxVecPerLane || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16) {
    return cudaErrorInvalidValue;
  }
  ln_rows<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), weight, bias, out, rows, C, eps, param_bf16,
      out_f32);
  return cudaGetLastError();
}

}  // extern "C"
