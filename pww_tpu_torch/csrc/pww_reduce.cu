// K1 pww_reduce: the paint-with-words weight function's per-sample
// reduction r[b] = reduce(Q K^T) over (heads, Lq, Lk): the max, the mean or
// the unbiased standard deviation of the scores, without the score tensor
// ever reaching device memory or shared memory.
//
// Replaces pww_tpu/ops/cross_attention_kernel.py:fused_pww_reduce (Pallas
// body _reduce_kernel and the host-side combine after it).
//
// Bound on the H100: memory, and at these sizes the launch itself. Every Q
// and K element is read once (at 512², Lq 4096, dh 40, B·H 16: 5.2 MB of Q,
// about 1.6 us at 3.35 TB/s); the 2·B·H·Lq·Lk·dh flops take a fraction of
// that on the tensor cores. The design:
//   * A CTA of 1, 2, 4 or 8 warps owns one (b, h), a run of query rows and a
//     range of 80-key chunks (all of Lk unless K does not fit). It copies
//     its K chunks into shared memory once (cp.async, keys past Lk
//     zero-filled, dh padded to a multiple of 16 with zero columns) and
//     keeps them for all its rows.
//   * Each warp walks its own run of 16-row Q tiles through a private ring
//     of cp.async stages, one per tile up to kStages, so that all of a
//     warp's tiles are in flight at once where the plan allows, later tiles
//     load while earlier ones compute, and no barrier of the CTA is needed
//     after K has landed.
//   * s = q·kᵀ per 16 × 80 tile on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate; attention_tile.cuh's load_a and qk_scores, as K2), and
//     the statistics straight from the accumulator registers: max by fmaxf,
//     mean by a sum; std by two passes over a lane's 40 values (their mean,
//     then Σ(x − mean)²) and Chan's update into the lane's running moments,
//     which stays exact when |mean| ≫ std. Rows ≥ Lq and keys ≥ Lk are left
//     out, and every count is a count of valid elements.
//   * One launch: the moments merge in a fixed order, lane → warp (a fixed
//     shuffle tree) → CTA (warps in order) → a float4 partial per CTA. Each
//     CTA then draws an integer ticket (one acquire-release atomic add); the
//     CTA that draws the last one folds all partials of each sample (lane l
//     every 32nd from l, in index order, then the same fixed tree), writes
//     r and resets the ticket counter to 0. The ticket picks which CTA
//     folds, never the fold order, so r is bit-identical from run to run;
//     no float atomics.
// The plan (warps, Q tiles per warp, K chunks per CTA, CTAs along Lq and
// along Lk) comes from ops/cross_attention_kernel.py:pww_reduce_plan; the
// entry point checks it against the shapes and its shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "attention_tile.cuh"
#include "common.cuh"

namespace {

using pww::bf16;

constexpr int kKeys = 80;  // keys per chunk
constexpr int kNT = kKeys / 8;
constexpr int kStages = 8;  // the most Q tiles in a warp's cp.async ring
constexpr int kMaxWarps = 8;
constexpr int kTailBytes = 144;  // the warps' moments and the last-CTA flag
enum Mode { kMax = 0, kMean = 1, kStd = 2 };

__host__ __device__ constexpr int row_stride(int dh) { return (dh + 15) / 16 * 16 + 8; }

// Stages of a warp's Q ring for `tiles` tiles per warp.
__host__ __device__ constexpr int ring_stages(int tiles) {
  return tiles < kStages ? tiles : kStages;
}

// Shared memory of a CTA: [K chunks | each warp's Q ring | tail].
// ops/cross_attention_kernel.py:_reduce_smem_bytes computes the same.
__host__ __device__ constexpr int smem_bytes(int dh, int warps, int tiles, int key_chunks) {
  return 2 * row_stride(dh) * (key_chunks * kKeys + warps * ring_stages(tiles) * 16) +
         kTailBytes;
}

// A running statistic: max in a; mean: the sum in a; std: the count n, the
// mean a and the sum of squared deviations b.
struct Stat {
  float n, a, b;
};

template <int MODE>
__device__ __forceinline__ Stat identity() {
  return {0.f, MODE == kMax ? -INFINITY : 0.f, 0.f};
}

// y folded into x, x first in the fold order; for std Chan et al.'s update
// (fast divisions: the weights need no last ulp, and every run rounds alike).
template <int MODE>
__device__ __forceinline__ void merge(Stat& x, const Stat& y) {
  if constexpr (MODE == kMax) {
    x.a = fmaxf(x.a, y.a);
  } else if constexpr (MODE == kMean) {
    x.a += y.a;
  } else {
    if (y.n == 0.f) return;
    if (x.n == 0.f) {
      x = y;
      return;
    }
    const float n = x.n + y.n, d = y.a - x.a, w = __fdividef(y.n, n);
    x.a = fmaf(d, w, x.a);
    x.b += fmaf(d * d, x.n * w, y.b);
    x.n = n;
  }
}

// The warp's statistics in lane 0: lane l takes lane l + o for o = 16, 8,
// 4, 2, 1, the same tree in every run.
template <int MODE>
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Stat t{__shfl_down_sync(0xffffffffu, s.n, o), __shfl_down_sync(0xffffffffu, s.a, o),
                 __shfl_down_sync(0xffffffffu, s.b, o)};
    merge<MODE>(s, t);
  }
  return s;
}

// This lane's 40 scores of a 16 × 80 tile (accumulator layout: rows g and
// g + 8, keys nt·8 + 2t and + 1) into its running statistics, four
// independent chains (one per accumulator slot e) joined in a fixed order.
// kMasked: rows whose flag is false and keys at or past `keys` are left out.
template <int MODE, bool kMasked>
__device__ __forceinline__ void lane_stats(const float (&s)[kNT][4], Stat& st, bool row_lo,
                                           bool row_hi, int keys, int t) {
  auto valid = [&](int nt, int e) {
    return !kMasked || ((e < 2 ? row_lo : row_hi) && nt * 8 + 2 * t + (e & 1) < keys);
  };
  if constexpr (MODE == kMax) {
    float m[4] = {st.a, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e] = fmaxf(m[e], valid(nt, e) ? s[nt][e] : -INFINITY);
    st.a = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
  } else {
    float sum[4] = {0.f, 0.f, 0.f, 0.f}, cnt = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum[e] += valid(nt, e) ? s[nt][e] : 0.f;
        if (kMasked) cnt += valid(nt, e) ? 1.f : 0.f;
      }
    const float total = (sum[0] + sum[1]) + (sum[2] + sum[3]);
    if constexpr (MODE == kMean) {
      st.a += total;
    } else {
      if (!kMasked) cnt = 4.f * kNT;
      if (cnt == 0.f) return;
      const float mean = __fdividef(total, cnt);
      float m2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = valid(nt, e) ? s[nt][e] - mean : 0.f;
          m2[e] = fmaf(d, d, m2[e]);
        }
      merge<kStd>(st, Stat{cnt, mean, (m2[0] + m2[1]) + (m2[2] + m2[3])});
    }
  }
}

// The counter's value before this thread's increment. Release: this
// thread's earlier writes (its CTA's partial) are visible to whoever
// acquires a later value; acquire: for the CTA that draws the last ticket,
// every other CTA's partial is visible (to the rest of the CTA after a
// barrier). One atomic in place of a fence and an atomic.
__device__ __forceinline__ unsigned draw_ticket(unsigned* counter) {
  unsigned ticket;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;\n"
               : "=r"(ticket) : "l"(counter), "r"(1u) : "memory");
  return ticket;
}

template <int MODE>
__device__ __forceinline__ float finish(const Stat& s, double n) {
  if constexpr (MODE == kMax) return s.a;
  if constexpr (MODE == kMean) return (float)(s.a / n);
  return sqrtf(fmaxf((float)(s.b / fmax(n - 1.0, 1.0)), 0.f));
}

// CTA i covers (b·h, query-row run, key range) with i = (bh · row_splits +
// rs) · key_splits + ks: rows [rs·R, rs·R + R), R = 16·warps·tiles, warp w
// the 16-row tiles [w·tiles, (w + 1)·tiles) of them; keys [ks·kc·80,
// (ks + 1)·kc·80), kc = key_chunks. A sample's partials are contiguous.
template <int DH, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32) pww_reduce_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, float4* __restrict__ part,
    unsigned* __restrict__ counter, float* __restrict__ out, int B, int H, int Lq, int Lk,
    int tiles, int key_chunks, int row_splits, int key_splits) {
  constexpr int DP = (DH + 15) / 16 * 16, LD = row_stride(DH), KS = DP / 16;
  constexpr int TILE = 16 * LD;  // one Q tile, elements
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stages = ring_stages(tiles);
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* qs = ks + key_chunks * kKeys * LD;
  bf16* ring = qs + warp * stages * TILE;
  float4* red = reinterpret_cast<float4*>(qs + warps * stages * TILE);
  int* is_last = reinterpret_cast<int*>(red + kMaxWarps);

  const int cta = blockIdx.x;
  const int kspl = cta % key_splits;
  const int rspl = (cta / key_splits) % row_splits;
  const int bh = cta / (key_splits * row_splits);
  const int key0 = kspl * key_chunks * kKeys;
  const int chunks = min(key_chunks, (Lk - key0 + kKeys - 1) / kKeys);
  const int wrow0 = (rspl * warps + warp) * tiles * 16;
  const int ntiles = max(0, min(tiles, (Lq - wrow0 + 15) / 16));
  const bf16* qg = q + (size_t)bh * Lq * DH;
  const bf16* kg = k + (size_t)bh * Lk * DH;

  if constexpr (DP > DH) {  // zero the padding columns of K and of every Q stage
    static_assert(DP - DH == 8, "one 16-byte chunk of padding");
    const int rows = key_chunks * kKeys + warps * stages * 16;
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      *reinterpret_cast<uint4*>(ks + r * LD + DH) = make_uint4(0, 0, 0, 0);
  }
  for (int c = 0; c < chunks; ++c)
    pww::copy_rows<kKeys, DH, LD>(ks + c * kKeys * LD, kg, key0 + c * kKeys, Lk, threadIdx.x,
                                  blockDim.x);
  pww::cp_async_commit();
  auto fetch = [&](int i) {  // Q tile i of this warp into stage i % stages
    if (i < ntiles)
      pww::copy_rows<16, DH, LD>(ring + (i % stages) * TILE, qg, wrow0 + i * 16, Lq, lane, 32);
    pww::cp_async_commit();  // an empty group past the last tile keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) fetch(i);
  pww::cp_async_wait<kStages - 1>();  // this thread's K copies have landed ...
  __syncthreads();                    // ... and everyone's, and the zero padding

  Stat st = identity<MODE>();
  const int g = lane >> 2, t = lane & 3;
  for (int i = 0; i < ntiles; ++i) {
    pww::cp_async_wait<kStages - 2>();  // tile i landed for this lane ...
    __syncwarp();                       // ... for the warp, which is done with tile i - 1
    uint32_t qf[KS][4];
    pww::load_a<KS, LD>(qf, ring + (i % stages) * TILE, lane);
    fetch(i + kStages - 1);  // into a stage no tile still needs (tile i - 1's, or unused)
    const int row0 = wrow0 + i * 16;
    const bool rows_full = row0 + 16 <= Lq;
    const bool row_lo = row0 + g < Lq, row_hi = row0 + g + 8 < Lq;
    for (int c = 0; c < chunks; ++c) {
      float s[kNT][4];
      pww::qk_scores<KS, kNT, LD>(s, qf, ks + c * kKeys * LD, lane);
      const int keys = Lk - key0 - c * kKeys;
      if (rows_full && keys >= kKeys) {
        lane_stats<MODE, false>(s, st, true, true, kKeys, t);
      } else {
        lane_stats<MODE, true>(s, st, row_lo, row_hi, keys, t);
      }
    }
  }
  pww::cp_async_wait<0>();

  st = warp_merge<MODE>(st);
  if (lane == 0) red[warp] = make_float4(st.n, st.a, st.b, 0.f);
  __syncthreads();
  if (threadIdx.x == 0) {
    Stat c = identity<MODE>();
    for (int w = 0; w < warps; ++w) merge<MODE>(c, Stat{red[w].x, red[w].y, red[w].z});
    part[cta] = make_float4(c.n, c.a, c.b, 0.f);
    *is_last = draw_ticket(counter) == gridDim.x - 1;
    if (*is_last) *counter = 0;  // every other CTA has drawn: ready for the next launch
  }
  __syncthreads();
  if (!*is_last) return;
  const int per_sample = gridDim.x / B;
  const double n = (double)H * Lq * Lk;
  for (int b = warp; b < B; b += warps) {
    // lane l folds partials l, l + 32, l + 64, ... of sample b, four loads
    // in flight at a time, then the warp's tree
    const float4* p = part + (size_t)b * per_sample;
    Stat s = identity<MODE>();
    for (int j0 = lane; j0 < per_sample; j0 += 4 * 32) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < per_sample) v[u] = __ldcg(p + j0 + 32 * u);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 32 * u < per_sample) merge<MODE>(s, Stat{v[u].x, v[u].y, v[u].z});
    }
    s = warp_merge<MODE>(s);
    if (lane == 0) out[b] = finish<MODE>(s, n);
  }
}

struct Plan {
  int warps, tiles, key_chunks, row_splits, key_splits;
};

template <int DH, int MODE>
cudaError_t launch(const void* q, const void* k, void* part, void* counter, void* out, int B,
                   int H, int Lq, int Lk, Plan p, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  cudaError_t e = pww::allow_max_shared_memory(
      reinterpret_cast<const void*>(pww_reduce_kernel<DH, MODE>), smem_set);
  if (e != cudaSuccess) return e;
  pww_reduce_kernel<DH, MODE><<<B * H * p.row_splits * p.key_splits, p.warps * 32,
                                smem_bytes(DH, p.warps, p.tiles, p.key_chunks), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<float4*>(part),
      static_cast<unsigned*>(counter), static_cast<float*>(out), B, H, Lq, Lk, p.tiles,
      p.key_chunks, p.row_splits, p.key_splits);
  return cudaGetLastError();
}

template <int DH>
cudaError_t by_mode(int mode, const void* q, const void* k, void* part, void* counter,
                    void* out, int B, int H, int Lq, int Lk, Plan p, cudaStream_t st) {
  switch (mode) {
    case kMax: return launch<DH, kMax>(q, k, part, counter, out, B, H, Lq, Lk, p, st);
    case kMean: return launch<DH, kMean>(q, k, part, counter, out, B, H, Lq, Lk, p, st);
    case kStd: return launch<DH, kStd>(q, k, part, counter, out, B, H, Lq, Lk, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,H,Lq,dh), k (B,H,Lk,dh): contiguous bf16, dh one of 40, 64, 80, 160.
// part: float4 scratch, one per CTA (B·H·row_splits·key_splits). counter:
// one unsigned, 0 before the launch and 0 after it; launches that may run at
// once need counters of their own. out: (B,) f32. The plan must cover Lq
// and Lk with no empty CTA, and smem must be its shared memory.
int pww_reduce(const void* q, const void* k, void* part, void* counter, void* out, int B,
               int H, int Lq, int Lk, int dh, int mode, int warps, int tiles, int key_chunks,
               int row_splits, int key_splits, int smem, void* stream) {
  const Plan p{warps, tiles, key_chunks, row_splits, key_splits};
  const long long rows = 16LL * warps * tiles, keys = (long long)kKeys * key_chunks;
  if (warps < 1 || warps > kMaxWarps || (warps & (warps - 1)) || tiles < 1 || key_chunks < 1 ||
      row_splits * rows < Lq || (row_splits - 1) * rows >= Lq || key_splits * keys < Lk ||
      (key_splits - 1) * keys >= Lk || smem != smem_bytes(dh, warps, tiles, key_chunks))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 40: return by_mode<40>(mode, q, k, part, counter, out, B, H, Lq, Lk, p, st);
    case 64: return by_mode<64>(mode, q, k, part, counter, out, B, H, Lq, Lk, p, st);
    case 80: return by_mode<80>(mode, q, k, part, counter, out, B, H, Lq, Lk, p, st);
    case 160: return by_mode<160>(mode, q, k, part, counter, out, B, H, Lq, Lk, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
