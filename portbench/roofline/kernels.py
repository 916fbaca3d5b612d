"""Operations and bytes of the program's attention kernels K1-K3, from their
shapes: frozen copies of the formulas that ``chip_smoke.py`` times each
kernel against. Bytes count each input read once and each output written
once (bf16 tensors 2 bytes, the PwW weights and statistics 4); operations
are multiply-adds × 2. B rows (CFG: two a sample), H heads, Lq queries, Lk
keys, dh the head width.

* K1, the PwW reduce (``pww_reduce_kernel``): reads q and k, writes one
  f32 a row; QKᵀ once.
* K2, the PwW cross-attention (``pww_xattn_kernel``): reads q, k, v and
  the (B, Lq, Lk) f32 weights and the coefficients, writes o; QKᵀ and PV.
* K3, flash self-attention (``flash_kernel``): reads q, k, v, writes o;
  QKᵀ and PV over Lq = Lk = L.
"""
from __future__ import annotations

from .peaks import BF16_FLOPS_PER_S, HBM_BYTES_PER_S


def k1(B, H, Lq, Lk, dh):
    return (B * H * Lq * dh + B * H * Lk * dh) * 2 + B * 4, 2 * B * H * Lq * Lk * dh


def k2(B, H, Lq, Lk, dh):
    return ((2 * B * H * Lq * dh + 2 * B * H * Lk * dh) * 2 + B * Lq * Lk * 4 + B * 4,
            4 * B * H * Lq * Lk * dh)


def k3(B, H, Lq, Lk, dh):
    return (2 * B * H * Lq * dh + 2 * B * H * Lk * dh) * 2, 4 * B * H * Lq * Lk * dh


FORMULAS = {"K1": k1, "K2": k2, "K3": k3}


def bound_s(kernel: str, B, H, Lq, Lk, dh) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the bf16 peak."""
    nbytes, flops = FORMULAS[kernel](B, H, Lq, Lk, dh)
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)
