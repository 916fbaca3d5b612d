// K3 flash_self_attention: softmax(Q K^T · dh^-1/2) · V over the UNet's
// high-resolution self-attention sites, with the online-softmax recurrence
// so that the (L × L) score matrix never reaches device memory.
//
// Replaces pww_tpu/ops/flash_attention.py:flash_self_attention (Pallas body
// _flash_kernel).
//
// Bound on the H100: operations. At 512², L 4096, dh 40, B·H 16 the two
// products are 4·B·H·L²·dh ≈ 43 GFLOP, about 43 us at 989 TFLOP/s bf16,
// against 2 MB of Q, K, V and O (under 1 us at 3.35 TB/s). Below dh 64 the
// exponentials set a higher floor: L² of them per (b·h), 268 M at that
// shape, at 16 per clock per SM take about 65-70 us.
//
// Design (Hopper's: wgmma, TMA, mbarriers). A CTA holds WGS consumer
// warpgroups of 64 query rows each, of one (b·h), and one producer warp.
// The producer's first thread copies the CTA's Q rows once, then the K and
// V tiles of BN keys into a ring of STAGES buffers, each by TMA
// (cp.async.bulk.tensor) on a full barrier, waiting on the stage's empty
// barrier before it refills it; so tile j+1 lands while tile j computes.
// Each consumer warpgroup runs S = Q K^T as wgmma with both operands in
// shared memory and the accumulator in registers, takes the online softmax
// on those registers (running max and sum per thread, a row reduced over
// the four lanes of a quad), rounds P to bf16 in registers and feeds it as
// the register A operand of O += P V, a second wgmma whose B operand is the
// V tile read transposed (MN-major); O is rescaled in registers. Nothing
// between the two products touches shared memory. Tiles are 16-column slabs
// with the 32-byte swizzle (one TMA box per slab), so each k16 step of
// Q K^T is one slab: dh 40 takes three, the last one's columns 40-47
// zero-filled by the copy as lying outside the tensor. The queries and the
// keys may differ in length (Lq, Lk: a spatially sharded site's rows against
// the whole image's keys): the Q map and the grid take Lq, the K/V maps and
// the key-tile loop Lk. 3-D tensor maps over (B·H, Lq or Lk, dh) zero-fill
// queries past Lq and keys past Lk; those keys are masked to -inf (a zero
// fill would score 0) and those rows are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_tile.cuh"
#include "common.cuh"

namespace {

using pww::bf16;

template <int DH_, int BN_, int STAGES_, int WGS_>
struct Cfg {
  static constexpr int DH = DH_;
  static constexpr int BN = BN_;          // keys per tile
  static constexpr int STAGES = STAGES_;  // K/V ring depth
  static constexpr int WGS = WGS_;        // consumer warpgroups
  static constexpr int BM = 64 * WGS;     // query rows per CTA
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
  static constexpr int KS = (DH + 15) / 16;       // 16-column slabs
  static constexpr int NT = BN / 8, NO = DH / 8;
  static constexpr int Q_SLAB = BM * 32, KV_SLAB = BN * 32;  // bytes
  static constexpr int KV_BYTES = KS * KV_SLAB;
  static constexpr int K_OFF = KS * Q_SLAB;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q, then full and empty per stage; 1 KB to align the base
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

template <class C>
__global__ void __launch_bounds__(C::THREADS) flash_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int Lq, int Lk,
    float scale_log2e) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // slabs on 1 KB boundaries, so the swizzle pattern starts where wgmma expects
  const uint32_t base = (pww::smem_u32(smem) + 1023) & ~1023u;
  const uint32_t qbar = base + C::BAR_OFF, full = qbar + 8, empty = full + 8 * C::STAGES;
  const int tiles = (Lk + C::BN - 1) / C::BN;
  const int bh = blockIdx.y, q0 = blockIdx.x * C::BM;

  if (threadIdx.x == 0) {
    pww::mbar_init(qbar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      pww::mbar_init(full + 8 * s, 1);
      pww::mbar_init(empty + 8 * s, C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {  // the producer warp: one thread starts every copy
    if (threadIdx.x == C::CONSUMERS) {
      pww::mbar_expect_tx(qbar, C::KS * C::Q_SLAB);
      for (int s = 0; s < C::KS; ++s)
        pww::tma_load_3d(base + s * C::Q_SLAB, &tq, 16 * s, q0, bh, qbar);
      for (int j = 0; j < tiles; ++j) {
        const int st = j % C::STAGES;
        if (j >= C::STAGES) pww::mbar_wait(empty + 8 * st, (j / C::STAGES - 1) & 1);
        pww::mbar_expect_tx(full + 8 * st, 2 * C::KV_BYTES);
        const uint32_t kt = base + C::K_OFF + st * C::KV_BYTES;
        const uint32_t vt = base + C::V_OFF + st * C::KV_BYTES;
        for (int s = 0; s < C::KS; ++s) {
          pww::tma_load_3d(kt + s * C::KV_SLAB, &tk, 16 * s, j * C::BN, bh, full + 8 * st);
          pww::tma_load_3d(vt + s * C::KV_SLAB, &tv, 16 * s, j * C::BN, bh, full + 8 * st);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  float s[C::NT][4], o[C::NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
  for (int nt = 0; nt < C::NO; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  auto& sf = reinterpret_cast<float(&)[C::NT * 4]>(s);
  auto& of = reinterpret_cast<float(&)[C::NO * 4]>(o);
  const uint32_t qw = base + wg * 64 * 32;  // this warpgroup's rows in each Q slab
  pww::mbar_wait(qbar, 0);

  for (int j = 0; j < tiles; ++j) {
    const int st = j % C::STAGES;
    const uint32_t kt = base + C::K_OFF + st * C::KV_BYTES;
    const uint32_t vt = base + C::V_OFF + st * C::KV_BYTES;
    pww::mbar_wait(full + 8 * st, (j / C::STAGES) & 1);
    // S = Q K^T: K-major A and B, 8 rows of 32 bytes apart by 256 bytes
    pww::fence_regs(sf);
    pww::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk)
      pww::WgmmaSS<C::BN>::run(sf, pww::desc_sw32(qw + kk * C::Q_SLAB, 16, 256),
                               pww::desc_sw32(kt + kk * C::KV_SLAB, 16, 256), kk > 0);
    pww::wgmma_commit();
    pww::wgmma_wait<0>();
    pww::fence_regs(sf);

    if ((j + 1) * C::BN > Lk) pww::mask_keys<C::NT>(s, j * C::BN, Lk, lane);
    pww::softmax_step<C::NT>(s, m, l, alpha, scale_log2e);
    pww::rescale<C::NO>(o, alpha);
    uint32_t p[C::NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < C::NT / 2; ++kk) pww::p_fragment<C::NT>(p[kk], s, kk);

    // O += P V: V MN-major, 16-column slabs KV_SLAB apart, 8 keys 256 bytes
    // apart, a k16 step of keys 512 bytes
    pww::fence_regs(of);
    pww::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::NT / 2; ++kk)
      pww::WgmmaRS<C::DH>::run(of, p[kk], pww::desc_sw32(vt + kk * 512, C::KV_SLAB, 256), 1);
    pww::wgmma_commit();
    pww::wgmma_wait<0>();
    pww::fence_regs(of);
    pww::mbar_arrive(empty + 8 * st);
  }
  pww::store_rows<C::NO>(out + (size_t)bh * Lq * C::DH, o, l, q0 + wg * 64 + warp * 16, Lq,
                         lane);
}

// cuTensorMapEncodeTiled looked up through the runtime, so that the
// library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (B·H, L, dh) bf16 tensor as boxes of 16 columns × `rows` rows, 32-byte
// swizzle; what lies outside the tensor arrives as zeros.
bool slab_map(CUtensorMap* map, const void* ptr, int BH, int L, int dh, int rows) {
  const EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)L, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)dh * 2, (cuuint64_t)L * dh * 2};
  const cuuint32_t box[3] = {16, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int Lq,
                   int Lk, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = pww::allow_max_shared_memory(reinterpret_cast<const void*>(flash_kernel<C>),
                                               smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap tq, tk, tv;
  if (!slab_map(&tq, q, BH, Lq, C::DH, C::BM) || !slab_map(&tk, k, BH, Lk, C::DH, C::BN) ||
      !slab_map(&tv, v, BH, Lk, C::DH, C::BN))
    return cudaErrorInvalidValue;
  const dim3 grid((Lq + C::BM - 1) / C::BM, BH);
  flash_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, static_cast<bf16*>(out),
                                                         Lq, Lk, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: contiguous (B·H, Lq, dh) bf16; k, v: (B·H, Lk, dh); 16-byte
// aligned; dh one of 40, 64, 80, 160. Lq = Lk is the self-attention of one
// process, with the same launch as before Lk existed.
int flash_self_attention(const void* q, const void* k, const void* v, void* out,
                         int BH, int Lq, int Lk, int dh, float scale, void* stream) {
  if (BH <= 0 || Lq <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 40: return launch<Cfg<40, 64, 3, 3>>(q, k, v, out, BH, Lq, Lk, scale, st);
    case 64: return launch<Cfg<64, 128, 2, 2>>(q, k, v, out, BH, Lq, Lk, scale, st);
    case 80: return launch<Cfg<80, 128, 2, 2>>(q, k, v, out, BH, Lq, Lk, scale, st);
    case 160: return launch<Cfg<160, 64, 2, 2>>(q, k, v, out, BH, Lq, Lk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
