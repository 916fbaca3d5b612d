// One warp's share of an attention tile between the two products, shared
// by K2 (pww_cross_attention.cu, mma.sync) and K3 (flash_attention.cu,
// wgmma): 16 query rows against a tile of NT·8 keys, with the scores, the
// probabilities and the output accumulator in registers throughout, in the
// accumulator layout of hopper.cuh (lane g·4 + t holds rows g and g + 8,
// columns 2t and 2t + 1 of each n8 block).
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace pww {

using bf16 = __nv_bfloat16;

// Keys at or past `limit` get -inf; col0 is the tile's first key.
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int col0, int limit, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col0 + nt * 8 + 2 * (lane & 3) + (e & 1) >= limit) s[nt][e] = -INFINITY;
}

// One step of the online softmax over a tile of raw scores s (the softmax
// is of s·c/log2(e), c = scale·log2 e): s becomes the tile's unnormalised
// probabilities, the row maxima m and the partial row sums l (this lane's
// columns only; quad_sum at the end) are updated, and alpha is the factor
// by which the output rows must shrink.
template <int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // rows g and g + 8
    float mx = m[h];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
    mx = quad_max(mx);
    alpha[h] = ex2((m[h] - mx) * c);  // 0 on the first tile
    m[h] = mx;
    const float mc = mx * c;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = ex2(fmaf(s[nt][e], c, -mc));
        s[nt][e] = p;
        sum += p;
      }
    l[h] = l[h] * alpha[h] + sum;
  }
}

template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], const float (&alpha)[2]) {
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    o[nt][0] *= alpha[0];
    o[nt][1] *= alpha[0];
    o[nt][2] *= alpha[1];
    o[nt][3] *= alpha[1];
  }
}

// The probabilities of 16 keys (n8 blocks 2·kk and 2·kk + 1) rounded to
// bf16: the A fragment of the P·V product over those keys.
template <int NT>
__device__ __forceinline__ void p_fragment(uint32_t (&p)[4], const float (&s)[NT][4], int kk) {
  p[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
  p[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
  p[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  p[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// out[row] = o / l in bf16 for this warp's rows row0 + g and row0 + g + 8
// that are below `rows`; out has NO·8 columns.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, const float (&o)[NO][4],
                                           const float (&l)[2], int row0, int rows, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / quad_sum(l[h]);
    const int r = row0 + (lane >> 2) + 8 * h;
    if (r < rows) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)r * (NO * 8) + 2 * (lane & 3));
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
        dst[nt * 4] = pack_bf16x2(o[nt][2 * h] * inv, o[nt][2 * h + 1] * inv);
    }
  }
}

}  // namespace pww
