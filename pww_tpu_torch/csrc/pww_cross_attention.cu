// K2 pww_cross_attention: softmax((Q K^T + coef[b] · w[b]) · dh^-1/2) · V for
// the UNet's paint-with-words cross-attention sites (image queries against
// the text keys), with the score tensor kept on chip.
//
// Replaces pww_tpu/ops/cross_attention_kernel.py:fused_pww_cross_attention
// (Pallas body _kernel).
//
// Bound on the H100: memory. The function reads Q, K, V once (bf16) and the
// (B, Lq, Lk) f32 weight map once, and writes O once: at 512², Lq 4096,
// dh 40, B·H 16 that is about 13 MB, about 4 us at 3.35 TB/s, while its
// 4·B·H·Lq·Lk·dh flops sit far below the ridge point. The design moves no
// other bytes: one CTA per (b·h, tile of query rows) keeps K and V
// (Lk × dh bf16; 49 KB at dh 160, so the dynamic shared-memory attribute is
// set) and its Q rows in shared memory, computes the tile's biased scores in
// f32 into shared memory (the weight map is read coalesced, once, as the
// bias is added), takes the softmax in f32 one warp per row, and writes
// P·V accumulated in f32 and cast to bf16. The key loops run to the real
// Lk, so any Lk whose K, V and score tile fit in shared memory works (the
// long-prompt n·77 case included); above that the launch is refused.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using pww::warp_max;
using pww::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerCta = 32;  // query rows per CTA

__global__ void __launch_bounds__(kThreads) pww_xattn_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ coef, __nv_bfloat16* __restrict__ out, int H,
    int Lq, int Lk, int dh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = dh + 2;  // bf16 row stride: an odd number of 4-byte words
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + Lk * ld;
  __nv_bfloat16* qs = vs + Lk * ld;
  float* ss = reinterpret_cast<float*>(qs + kRowsPerCta * ld);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * kRowsPerCta;
  const int rows = min(kRowsPerCta, Lq - q0);
  const int half = dh / 2;
  const __nv_bfloat162* kg =
      reinterpret_cast<const __nv_bfloat162*>(k + (size_t)bh * Lk * dh);
  const __nv_bfloat162* vg =
      reinterpret_cast<const __nv_bfloat162*>(v + (size_t)bh * Lk * dh);
  const __nv_bfloat162* qg =
      reinterpret_cast<const __nv_bfloat162*>(q + ((size_t)bh * Lq + q0) * dh);
  for (int i = threadIdx.x; i < Lk * half; i += kThreads) {
    const int r = i / half, c = i - r * half;
    reinterpret_cast<__nv_bfloat162*>(ks + r * ld)[c] = kg[i];
    reinterpret_cast<__nv_bfloat162*>(vs + r * ld)[c] = vg[i];
  }
  for (int i = threadIdx.x; i < rows * half; i += kThreads) {
    const int r = i / half, c = i - r * half;
    reinterpret_cast<__nv_bfloat162*>(qs + r * ld)[c] = qg[i];
  }
  __syncthreads();

  // biased, scaled scores: s = (q·k + coef[b] · w[b, q, j]) · scale
  const float cf = coef[b];
  const float* wb = w + ((size_t)b * Lq + q0) * Lk;
  const int n = rows * Lk;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / Lk, c = i - r * Lk;
    const __nv_bfloat162* qa = reinterpret_cast<const __nv_bfloat162*>(qs + r * ld);
    const __nv_bfloat162* ka = reinterpret_cast<const __nv_bfloat162*>(ks + c * ld);
    float acc = 0.f;
    for (int d = 0; d < half; ++d) {
      const float2 x = __bfloat1622float2(qa[d]);
      const float2 y = __bfloat1622float2(ka[d]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    ss[i] = (acc + cf * wb[i]) * scale;
  }
  __syncthreads();

  // softmax over the keys, one warp per query row, in f32
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = ss + r * Lk;
    float m = -INFINITY;
    for (int c = lane; c < Lk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < Lk; c += 32) {
      const float p = __expf(row[c] - m);
      row[c] = p;
      sum += p;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int c = lane; c < Lk; c += 32) row[c] *= inv;
  }
  __syncthreads();

  // O = P · V, f32 accumulation, one output element per thread step
  __nv_bfloat16* og = out + ((size_t)bh * Lq + q0) * dh;
  for (int i = threadIdx.x; i < rows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    const float* p = ss + r * Lk;
    float acc = 0.f;
    for (int c = 0; c < Lk; ++c) acc = fmaf(p[c], __bfloat162float(vs[c * ld + d]), acc);
    og[i] = __float2bfloat16(acc);
  }
}

}  // namespace

extern "C" {

// q (B,H,Lq,dh), k and v (B,H,Lk,dh): contiguous bf16, dh even.
// w (B,Lq,Lk) f32, coef (B,) f32, out (B,H,Lq,dh) bf16.
int pww_cross_attention(const void* q, const void* k, const void* v,
                        const void* w, const void* coef, void* out, int B,
                        int H, int Lq, int Lk, int dh, float scale, void* stream) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = (size_t)(2 * Lk + kRowsPerCta) * (dh + 2) * sizeof(__nv_bfloat16) +
                      (size_t)kRowsPerCta * Lk * sizeof(float);
  cudaError_t e = pww::allow_max_shared_memory(
      reinterpret_cast<const void*>(pww_xattn_kernel), smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + kRowsPerCta - 1) / kRowsPerCta, B * H);
  pww_xattn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(coef), static_cast<__nv_bfloat16*>(out), H, Lq,
      Lk, dh, scale);
  return cudaGetLastError();
}

}  // extern "C"
