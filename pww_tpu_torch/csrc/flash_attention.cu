// K3 flash_self_attention: softmax(Q K^T · dh^-1/2) · V over the UNet's
// high-resolution self-attention sites, with the online-softmax recurrence
// so that the (L × L) score matrix never reaches device memory.
//
// Replaces pww_tpu/ops/flash_attention.py:flash_self_attention (Pallas body
// _flash_kernel).
//
// Bound on the H100: operations. At 512², L 4096, dh 40, B·H 16 the two
// products are 4·B·H·L²·dh ≈ 43 GFLOP, about 43 us at 989 TFLOP/s bf16,
// against 2 MB of Q, K, V and O (under 1 us at 3.35 TB/s). The design puts
// both products on the tensor cores through nvcuda::wmma (bf16 16×16×16
// tiles, f32 accumulation): one CTA of four warps per (b·h, 64-query tile)
// loops over 64-key tiles of K and V staged in shared memory. Each warp owns
// 16 query rows: it computes its S = Q K^T rows into shared memory, runs the
// online softmax on them in f32 (running max, normaliser and the per-row
// rescale of the f32 accumulator, which lives in shared memory because the
// wmma accumulator layout is opaque), writes P in bf16 and adds P · V into
// the accumulator. dh 40 is padded to 48 with zeros in shared memory only;
// ragged L is masked in the kernel (keys to -inf, rows not stored). This is
// a first, simple kernel: no asynchronous copies, no wgmma, one tile in
// flight per CTA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;  // 4 warps × 16 query rows

template <int DH>
struct Tile {
  static constexpr int DP = (DH + 15) / 16 * 16;  // head dim padded for wmma
  static constexpr int LDH = DP + 8;              // bf16 stride of Q/K/V tiles
  static constexpr int LDS = kBlockK + 4;         // f32 stride of S
  static constexpr int LDP = kBlockK + 8;         // bf16 stride of P
  static constexpr int LDO = DP + 4;              // f32 stride of O
  // byte offsets; each a multiple of 32 as wmma pointers require
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + kBlockQ * LDH * 2;
  static constexpr int V_OFF = K_OFF + kBlockK * LDH * 2;
  static constexpr int S_OFF = V_OFF + kBlockK * LDH * 2;
  static constexpr int P_OFF = S_OFF + kBlockQ * LDS * 4;
  static constexpr int O_OFF = P_OFF + kBlockQ * LDP * 2;
  static constexpr int M_OFF = O_OFF + kBlockQ * LDO * 4;
  static constexpr int L_OFF = M_OFF + kBlockQ * 4;
  static constexpr int A_OFF = L_OFF + kBlockQ * 4;
  static constexpr int BYTES = A_OFF + kBlockQ * 4;
};

// Copy rows [r0, r0 + 64) of a (L, DH) bf16 matrix into a (64, LDH) tile,
// zero-filling rows past L and the padded columns DH..DP.
template <int DH>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0, int L) {
  using T = Tile<DH>;
  constexpr int kPairs = T::DP / 2;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  for (int i = threadIdx.x; i < kBlockQ * kPairs; i += kThreads) {
    const int r = i / kPairs, c = 2 * (i - r * kPairs);
    __nv_bfloat162 x = zero;
    if (c < DH && r0 + r < L)
      x = *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<__nv_bfloat162*>(dst + r * T::LDH + c) = x;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L,
    float scale_log2e) {
  using T = Tile<DH>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + T::Q_OFF);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + T::K_OFF);
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + T::V_OFF);
  float* ss = reinterpret_cast<float*>(smem + T::S_OFF);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + T::P_OFF);
  float* os = reinterpret_cast<float*>(smem + T::O_OFF);
  float* m_run = reinterpret_cast<float*>(smem + T::M_OFF);
  float* l_run = reinterpret_cast<float*>(smem + T::L_OFF);
  float* alpha = reinterpret_cast<float*>(smem + T::A_OFF);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = warp * 16;  // this warp's first query row in the tile
  const int q0 = blockIdx.x * kBlockQ;
  const size_t base = (size_t)blockIdx.y * L * DH;

  load_tile<DH>(qs, q + base, q0, L);
  for (int i = threadIdx.x; i < kBlockQ * T::LDO; i += kThreads) os[i] = 0.f;
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBlockK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DH>(ks, k + base, k0, L);
    load_tile<DH>(vs, v + base, k0, L);
    __syncthreads();

    // S rows of this warp = Q[row0:row0+16] · K_tile^T
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < T::DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + row0 * T::LDH + kk * 16, T::LDH);
        wmma::load_matrix_sync(b, ks + n * 16 * T::LDH + kk * 16, T::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + row0 * T::LDS + n * 16, acc, T::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile's keys, f32, base 2. Lanes 2r and 2r+1
    // take row r of the warp's 16, 32 keys each, so a row needs one shuffle
    // per reduction; the columns are visited in an order rotated by the
    // lane, which puts the 32 lanes on 32 distinct shared-memory banks.
    {
      const int half = lane & 1;
      const int r = row0 + (lane >> 1);
      const float* srow = ss + r * T::LDS + half * 32;
      __nv_bfloat16* prow = ps + r * T::LDP + half * 32;
      const int kbase = k0 + half * 32;
      float sv[32];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        sv[j] = kbase + c < L ? srow[c] * scale_log2e : -INFINITY;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float p = exp2f(sv[j] - m_new);
        sum += p;
        prow[(j + lane) & 31] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both lanes of the pair have read m_run[r]
      if (half == 0) {
        const float a = exp2f(m_old - m_new);
        alpha[r] = a;
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * T::DP; i += 32) {
      const int r = row0 + i / T::DP, c = i % T::DP;
      os[r * T::LDO + c] *= alpha[r];
    }
    __syncwarp();

    // O rows of this warp += P[row0:row0+16] · V_tile
    for (int n = 0; n < T::DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + row0 * T::LDO + n * 16, T::LDO,
                             wmma::mem_row_major);
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + row0 * T::LDP + kk * 16, T::LDP);
        wmma::load_matrix_sync(b, vs + kk * 16 * T::LDH + n * 16, T::LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(os + row0 * T::LDO + n * 16, acc, T::LDO,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int i = lane; i < 16 * DH; i += 32) {
    const int rr = i / DH, c = i % DH;
    const int r = row0 + rr;
    if (q0 + r < L)
      out[base + (size_t)(q0 + r) * DH + c] = __float2bfloat16(os[r * T::LDO + c] / l_run[r]);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int L, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = pww::allow_max_shared_memory(
      reinterpret_cast<const void*>(flash_kernel<DH>), smem_set);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, BH);
  flash_kernel<DH><<<grid, kThreads, Tile<DH>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), L,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous (B·H, L, dh) bf16; dh one of 40, 64, 80, 160.
int flash_self_attention(const void* q, const void* k, const void* v, void* out,
                         int BH, int L, int dh, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 40: return launch<40>(q, k, v, out, BH, L, scale, st);
    case 64: return launch<64>(q, k, v, out, BH, L, scale, st);
    case 80: return launch<80>(q, k, v, out, BH, L, scale, st);
    case 160: return launch<160>(q, k, v, out, BH, L, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
