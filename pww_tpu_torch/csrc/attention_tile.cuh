// One warp's share of an attention tile, shared by K1 (pww_reduce.cu) and
// K2 (pww_cross_attention.cu), both on mma.sync, and K3
// (flash_attention.cu, wgmma): Q and K tiles copied into shared memory and
// their product s = q·kᵀ over 16 query rows and NT·8 keys, then the
// softmax between the two products of attention, with the scores, the
// probabilities and the output accumulator in registers throughout, in the
// accumulator layout of hopper.cuh (lane g·4 + t holds rows g and g + 8,
// columns 2t and 2t + 1 of each n8 block).
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace pww {

using bf16 = __nv_bfloat16;

// Tiles that mma.sync reads from shared memory are row-major bf16 with a
// row stride of LD elements, LD·2 an odd multiple of 16 bytes, so that the
// eight row addresses of an ldmatrix fall on eight distinct bank groups.

// Rows [r0, r0 + R) of a (rows, DH) bf16 matrix into a tile of row stride
// LD by 16-byte cp.async, thread `tid` of the `threads` that share the
// copy taking every threads-th 16-byte piece; rows past `rows` are
// zero-filled. The caller commits the group.
template <int R, int DH, int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0, int rows, int tid,
                                          int threads) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int i = tid; i < R * kChunks; i += threads) {
    const int r = i / kChunks, c = (i - r * kChunks) * 8;
    const bool ok = r0 + r < rows;
    cp_async_16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * DH + c, ok);
  }
}

// A fragments of 16 rows × 16·KS columns of a tile, from its first row.
template <int KS, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KS][4], const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldmatrix_x4(a[kk], tile + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
}

// s = q · kᵀ over the NT·8 keys of a K tile (keys × LD): ldmatrix of K rows
// is already the B fragment of kᵀ, two key blocks per load.
template <int KS, int NT, int LD>
__device__ __forceinline__ void qk_scores(float (&s)[NT][4], const uint32_t (&q)[KS][4],
                                          const bf16* kt, int lane) {
  static_assert(NT % 2 == 0, "keys per tile must be a multiple of 16");
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  const bf16* krow = kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, krow + np * 16 * LD + kk * 16);
      mma_bf16_16816(s[2 * np], q[kk], b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], q[kk], b[2], b[3]);
    }
}

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
