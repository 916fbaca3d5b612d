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
// 4·B·H·Lq·Lk·dh flops (0.8 GFLOP) take under 1 us on the tensor cores.
//
// Design: a CTA of four warps owns 64 query rows of one sample b and a group
// of G heads; each warp owns 16 rows. The CTA copies its rows of w[b] into
// shared memory once (f32, 64 × Lk) and loops over its heads, so w is read
// once per (b, query tile) when G = H — the card's counterpart of the TPU
// kernel's grid_order="q". The keys go in chunks of 80 (Lk 77 is one chunk,
// its last three keys masked to -inf): for each (head, chunk) the K and V
// chunk, and at a head's first chunk its Q tile, arrive by 16-byte cp.async
// in a two-stage ring while the previous (head, chunk) computes. The
// products run on mma.sync.m16n8k16 with everything in registers (the
// helpers below and attention_tile.cuh): S = Q K^T, the bias
// coef[b] · w[b, q, j] added in the accumulator layout, the online softmax
// across chunks (one pass at Lk ≤ 80, so n·77 long prompts need no more
// shared memory than the w rows), P rounded to bf16 as the reference kernel
// does, O += P V. Where the w rows
// do not fit shared memory (Lk above about 240 at dh 160), the kernel reads
// them from device memory in the accumulator layout instead, once per head.
// The host picks G, the largest divisor of H that still gives at least 7/8
// of a wave of CTAs, so that small Lq (256 at dh 160: 8 query tiles) still
// spreads over the SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"
#include "common.cuh"

namespace pww {

// Tiles that mma.sync reads from shared memory are row-major bf16 with a
// row stride of LD elements, LD·2 an odd multiple of 16 bytes, so that the
// eight row addresses of an ldmatrix fall on eight distinct bank groups.

// Rows [r0, r0 + R) of a (rows, DH) bf16 matrix into a tile of row stride
// LD by 16-byte cp.async from all THREADS threads; rows past `rows` are
// zero-filled. The caller commits the group.
template <int R, int DH, int LD, int THREADS>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int r0, int rows) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * kChunks; i += THREADS) {
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

// softmax_step and rescale, then o += P·V on mma.sync with P rounded to
// bf16 in registers and V (keys × LD, NT·8 keys from its first row, NO·8
// columns) loaded transposed.
template <int NT, int NO, int LD>
__device__ __forceinline__ void softmax_pv(float (&s)[NT][4], float (&o)[NO][4], float (&m)[2],
                                           float (&l)[2], float c, const bf16* vt, int lane) {
  float alpha[2];
  softmax_step<NT>(s, m, l, alpha, c);
  rescale<NO>(o, alpha);
  const bf16* vrow = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t p[4];
    p_fragment<NT>(p, s, kk);
    const bf16* vk = vrow + kk * 16 * LD;
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vk + np * 16 + (lane >> 4) * 8);
      mma_bf16_16816(o[2 * np], p, b[0], b[1]);
      mma_bf16_16816(o[2 * np + 1], p, b[2], b[3]);
    }
    if constexpr (NO % 2) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, vk + (NO - 1) * 8);
      mma_bf16_16816(o[NO - 1], p, b[0], b[1]);
    }
  }
}

}  // namespace pww

namespace {

using pww::bf16;

template <int DH_>
struct Cfg {
  static constexpr int DH = DH_;
  static constexpr int WARPS = 4;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BM = WARPS * 16;  // query rows per CTA
  static constexpr int KC = 80;          // keys per chunk
  static constexpr int DP = (DH + 15) / 16 * 16;
  static constexpr int LD = DP + 8;  // row stride: an odd number of 16-byte units
  static constexpr int KS = DP / 16;
  static constexpr int NT = KC / 8;
  static constexpr int NO = DH / 8;
  static constexpr int Q_ELEMS = BM * LD;
  static constexpr int KV_ELEMS = KC * LD;
  static constexpr int TILE_BYTES = (2 * Q_ELEMS + 4 * KV_ELEMS) * 2;  // Q, K, V: two each
  static_assert(DH % 8 == 0 && (LD / 8) % 2 == 1, "layout");
};

template <class C, bool W_SMEM>
__global__ void __launch_bounds__(C::THREADS) pww_xattn_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ coef, bf16* __restrict__ out,
    int H, int G, int Lq, int Lk, int wld, float scale_log2e) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // Q tile by head parity
  bf16* ks = qs + 2 * C::Q_ELEMS;            // K chunk by item parity
  bf16* vs = ks + 2 * C::KV_ELEMS;           // V chunk by item parity
  float* ws = reinterpret_cast<float*>(vs + 2 * C::KV_ELEMS);  // BM × wld (W_SMEM)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * C::BM;
  const int groups = H / G;
  const int b = blockIdx.y / groups;
  const int h0 = (blockIdx.y - b * groups) * G;
  const int chunks = (Lk + C::KC - 1) / C::KC;
  const int items = G * chunks;  // (head, key chunk) pairs, head-major
  const size_t head_q = (size_t)Lq * C::DH, head_kv = (size_t)Lk * C::DH;
  q += ((size_t)b * H + h0) * head_q;
  out += ((size_t)b * H + h0) * head_q;
  k += ((size_t)b * H + h0) * head_kv;
  v += ((size_t)b * H + h0) * head_kv;
  const float* wb = w + ((size_t)b * Lq + q0) * Lk;  // this tile's rows of w[b]
  const float cf = coef[b];

  auto fetch = [&](int i) {
    const int h = i / chunks, c = i - h * chunks;
    pww::copy_rows<C::KC, C::DH, C::LD, C::THREADS>(ks + (i & 1) * C::KV_ELEMS, k + h * head_kv,
                                                   c * C::KC, Lk);
    pww::copy_rows<C::KC, C::DH, C::LD, C::THREADS>(vs + (i & 1) * C::KV_ELEMS, v + h * head_kv,
                                                   c * C::KC, Lk);
    if (c == 0)
      pww::copy_rows<C::BM, C::DH, C::LD, C::THREADS>(qs + (h & 1) * C::Q_ELEMS, q + h * head_q,
                                                     q0, Lq);
  };

  if constexpr (C::DP > C::DH) {  // zero padding columns of both Q tiles and K chunks
    static_assert(C::DP - C::DH == 8, "one 16-byte chunk of padding");
    for (int r = threadIdx.x; r < 2 * (C::BM + C::KC); r += C::THREADS)
      *reinterpret_cast<uint4*>(qs + r * C::LD + C::DH) = make_uint4(0, 0, 0, 0);
  }
  if constexpr (W_SMEM) {
    for (int r = warp; r < C::BM; r += C::WARPS) {
      const bool ok = q0 + r < Lq;
      const float* src = wb + (size_t)(ok ? r : 0) * Lk;
      for (int c = lane; c < Lk; c += 32) pww::cp_async_4(ws + r * wld + c, src + c, ok);
    }
  }
  fetch(0);
  pww::cp_async_commit();

  uint32_t qf[C::KS][4];
  float o[C::NO][4], m[2], l[2];
  const int row0 = warp * 16;
  const int g = lane >> 2, t = lane & 3;

  for (int i = 0; i < items; ++i) {
    pww::cp_async_wait<0>();  // item i landed for this thread
    __syncthreads();          // ... for all; item i-1 is done with the stage i+1 takes
    if (i + 1 < items) fetch(i + 1);
    pww::cp_async_commit();
    const int h = i / chunks, c = i - h * chunks;
    if (c == 0) {
      pww::load_a<C::KS, C::LD>(qf, qs + (h & 1) * C::Q_ELEMS + row0 * C::LD, lane);
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int nt = 0; nt < C::NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    }
    float s[C::NT][4];
    pww::qk_scores<C::KS, C::NT, C::LD>(s, qf, ks + (i & 1) * C::KV_ELEMS, lane);
    // the bias before the scale: s = q·k + coef[b] · w[b, q, j]; keys past Lk → -inf
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + g + 8 * hh, col = c * C::KC + nt * 8 + 2 * t;
        float2 wv;
        if constexpr (W_SMEM) {
          wv = *reinterpret_cast<const float2*>(ws + row * wld + col);
        } else {
          const bool rok = q0 + row < Lq;
          const float* src = wb + (size_t)row * Lk + col;
          wv.x = rok && col < Lk ? src[0] : 0.f;
          wv.y = rok && col + 1 < Lk ? src[1] : 0.f;
        }
        s[nt][2 * hh] = col < Lk ? fmaf(cf, wv.x, s[nt][2 * hh]) : -INFINITY;
        s[nt][2 * hh + 1] = col + 1 < Lk ? fmaf(cf, wv.y, s[nt][2 * hh + 1]) : -INFINITY;
      }
    pww::softmax_pv<C::NT, C::NO, C::LD>(s, o, m, l, scale_log2e, vs + (i & 1) * C::KV_ELEMS,
                                         lane);
    if (c == chunks - 1) pww::store_rows<C::NO>(out + h * head_q, o, l, q0 + row0, Lq, lane);
  }
  pww::cp_async_wait<0>();
}

// The largest divisor G of H whose grid still holds 7/8 of a wave.
int head_group(int H, int ctas_per_group_set, int sms) {
  for (int g = H; g > 1; --g)
    if (H % g == 0 && 8LL * ctas_per_group_set * (H / g) >= 7LL * sms) return g;
  return 1;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* w,
                   const void* coef, void* out, int B, int H, int Lq, int Lk, float scale,
                   cudaStream_t stream) {
  using C = Cfg<DH>;
  static std::atomic<unsigned long long> set_smem{0}, set_gmem{0};
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int chunks = (Lk + C::KC - 1) / C::KC;
  const int wld = chunks * C::KC + 8;  // ≡ 8 or 24 mod 32 words: no bank conflicts
  const size_t with_w = C::TILE_BYTES + (size_t)C::BM * wld * sizeof(float);
  const int nq = (Lq + C::BM - 1) / C::BM;
  const int G = head_group(H, nq * B, sms);
  const dim3 grid(nq, B * (H / G));
  const float c = scale * 1.4426950408889634f;
  const auto* qq = static_cast<const bf16*>(q);
  const auto* kk = static_cast<const bf16*>(k);
  const auto* vv = static_cast<const bf16*>(v);
  const auto* ww = static_cast<const float*>(w);
  const auto* cc = static_cast<const float*>(coef);
  auto* oo = static_cast<bf16*>(out);
  if (with_w <= (size_t)optin) {
    e = pww::allow_max_shared_memory(reinterpret_cast<const void*>(pww_xattn_kernel<C, true>),
                                     set_smem);
    if (e != cudaSuccess) return e;
    pww_xattn_kernel<C, true><<<grid, C::THREADS, with_w, stream>>>(qq, kk, vv, ww, cc, oo, H, G,
                                                                    Lq, Lk, wld, c);
  } else {
    e = pww::allow_max_shared_memory(reinterpret_cast<const void*>(pww_xattn_kernel<C, false>),
                                     set_gmem);
    if (e != cudaSuccess) return e;
    pww_xattn_kernel<C, false><<<grid, C::THREADS, C::TILE_BYTES, stream>>>(
        qq, kk, vv, ww, cc, oo, H, G, Lq, Lk, wld, c);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B,H,Lq,dh), k and v (B,H,Lk,dh): contiguous bf16, dh one of 40, 64,
// 80, 160. w (B,Lq,Lk) f32, coef (B,) f32, out (B,H,Lq,dh) bf16.
int pww_cross_attention(const void* q, const void* k, const void* v,
                        const void* w, const void* coef, void* out, int B,
                        int H, int Lq, int Lk, int dh, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 40: return launch<40>(q, k, v, w, coef, out, B, H, Lq, Lk, scale, st);
    case 64: return launch<64>(q, k, v, w, coef, out, B, H, Lq, Lk, scale, st);
    case 80: return launch<80>(q, k, v, w, coef, out, B, H, Lq, Lk, scale, st);
    case 160: return launch<160>(q, k, v, w, coef, out, B, H, Lq, Lk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
