"""K3: flash self-attention for the UNet's high-resolution self-attention sites.

Port of :mod:`pww_tpu.ops.flash_attention`. The wrapper takes its plain
PyTorch version for tensors on the CPU and launches the CUDA kernel
(``csrc/flash_attention.cu``: online softmax, tensor-core products, no
(L × L) scores in device memory) for bf16 tensors on the card; anything else
raises. Launches are counted in ``flash_self_attention.launches``.

The keys and values may be longer than the queries (Lk ≠ Lq): a spatially
sharded site (:mod:`pww_tpu_torch.parallel.spatial`) attends its rows'
queries to the whole image's keys.

Under autograd (grad mode on, and q, k or v requiring a gradient) the
wrapper goes through :class:`FlashSelfAttention`: the same forward, and the
plain backward :func:`self_attention_backward_plain`, which recomputes the
probabilities. The JAX package has no backward kernel to port, and its K3
cannot be differentiated at all (ROADMAP.md C.18); a hand-written backward
kernel is later work (ROADMAP.md §B).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cross_attention_kernel import HEAD_DIMS, check_kernel_inputs

# f32 (L × L) scores of one chunk of the backward: 8 (sample, head) pairs at L 4096
BACKWARD_CHUNK_BYTES = 512 * 2**20


def self_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``softmax(QKᵀ·dh^-½)·V`` with f32 scores, cast to V's dtype;
    q (B, H, Lq, dh), k and v (B, H, Lk, dh)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(v.dtype)


def self_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  do: torch.Tensor):
    """(dQ, dK, dV) of ``softmax(QKᵀ·dh^-½)·V`` for the output gradient
    ``do`` (q and do (B, H, Lq, dh), k and v (B, H, Lk, dh)), in the inputs'
    dtype. In f32, in chunks of (sample, head) pairs whose (Lq × Lk) scores
    take about ``BACKWARD_CHUNK_BYTES``: S = QKᵀ·dh^-½
    and P = softmax(S) recomputed, dV = PᵀdO, dP = dO·Vᵀ,
    dS = P ⊙ (dP − rowsum(dP ⊙ P)), dQ = dS·K·dh^-½, dK = dSᵀ·Q·dh^-½."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scale = dh ** -0.5
    flat = [x.reshape(b * h, -1, dh) for x in (q, k, v, do)]
    grads = [torch.empty_like(x) for x in flat[:3]]
    step = max(1, BACKWARD_CHUNK_BYTES // (lq * lk * 4))
    for i in range(0, b * h, step):
        qi, ki, vi, doi = (x[i:i + step].float() for x in flat)
        p = torch.softmax(torch.matmul(qi, ki.transpose(-1, -2)) * scale, dim=-1)
        grads[2][i:i + step] = torch.matmul(p.transpose(-1, -2), doi)
        dp = torch.matmul(doi, vi.transpose(-1, -2))
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        del dp, p
        grads[0][i:i + step] = torch.matmul(ds, ki) * scale
        grads[1][i:i + step] = torch.matmul(ds.transpose(-1, -2), qi) * scale
    return tuple(g.reshape(x.shape) for g, x in zip(grads, (q, k, v)))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version on the CPU, the CUDA kernel on the card."""
    if q.device.type == "cpu":
        return self_attention_plain(q, k, v)
    check_kernel_inputs("flash_self_attention", q, k, v)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, dh) or v.shape != k.shape:
        raise ValueError("flash_self_attention: q (B, H, Lq, dh) and k, v of one shape "
                         "(B, H, Lk, dh)")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_self_attention: head dim {dh} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "flash_self_attention",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, lq, lk,
             dh, dh ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_self_attention")
    flash_self_attention.launches += 1
    return out


class FlashSelfAttention(torch.autograd.Function):
    """K3 under autograd: the wrapper's forward (the kernel on the card), the
    plain backward. Saves q, k and v; the probabilities are recomputed."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return self_attention_backward_plain(*ctx.saved_tensors, do)


def flash_self_attention(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Self-attention, q (B, H, Lq, dh) over k, v (B, H, Lk, dh) → (B, H,
    Lq, dh). No bias, no mask."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashSelfAttention.apply(q, k, v)
    return _forward(q, k, v)


flash_self_attention.launches = 0
