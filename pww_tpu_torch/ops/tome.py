"""Token merging (ToMe) around the UNet's self-attention.

Port of :mod:`pww_tpu.ops.tome` (Bolya & Hoffman 2023, tomesd's default
policy): the most similar latent tokens are merged before ``attn1`` and
broadcast back after it, at the full-resolution sites only; ``attn2``
(per-position PwW bias) and the MLP run unmerged. As in the JAX package:

  * one dst token per 2×2 block at the fixed (0, 0) offset, the rest src
    (tomesd's per-call random offset is not taken);
  * ``r = min(int(L·ratio), L_src)`` src tokens merge, rounded down so that
    the merged length is a multiple of 1024 (L >= 4096) or 256 (L >= 1024),
    the flash kernel's blocks in the JAX package (at 512², ratio 0.5: L
    4096 → 2048);
  * the matching runs in f32: cosine similarity of the block input, each
    src's best dst by ``argmax`` (the first maximum), the src tokens ordered
    by their best similarity with a STABLE descending sort (ties keep their
    source order, as ``jnp.argsort`` does), the first r merged.

Merging, gathering and the scatter-mean are plain PyTorch on both devices;
the merged length reaches the UNet's attention dispatch unchanged, so K3
runs at L_m.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def dst_src_indices(h: int, w: int, device=None, sx: int = 2, sy: int = 2):
    """The (h, w) grid's dst tokens (one per sx × sy block, offset (0, 0),
    row-major) and src tokens (the rest, ascending), as flat indices."""
    ys = torch.arange(0, h, sy, device=device)
    xs = torch.arange(0, w, sx, device=device)
    dst = (ys[:, None] * w + xs[None, :]).reshape(-1)
    keep = torch.ones(h * w, dtype=torch.bool, device=device)
    keep[dst] = False
    return dst, torch.nonzero(keep).reshape(-1)


def merged_count(l: int, n_src: int, ratio: float) -> int:
    """The number of src tokens that merge at ``ratio``, aligned so that the
    merged length is a multiple of the flash block
    (``pww_tpu/ops/tome.py:74-90``)."""
    r = min(int(l * ratio), n_src)
    if l >= 1024 and l % 256 == 0 and r > 0:
        align = 1024 if (l >= 4096 and l % 1024 == 0) else 256
        r = max(0, l - -(-(l - r) // align) * align)
    return r


def build_token_merge(metric: torch.Tensor, h: int, w: int, ratio: float,
                      ) -> Tuple[Callable, Callable, int]:
    """Bipartite soft matching of ``metric`` (B, L = h·w, C) on its grid.

    Returns ``(merge, unmerge, L_m)``: ``merge`` maps (B, L, C') to
    (B, L_m, C'), the unmerged src tokens first, then every dst token
    averaged with the src tokens merged into it (in f32, cast back);
    ``unmerge`` maps (B, L_m, C') back to (B, L, C'), each merged src taking
    its dst's value.
    """
    b, l, _ = metric.shape
    if l != h * w:
        raise ValueError(f"ToMe: {l} tokens on a {h}x{w} grid")
    dst_idx, src_idx = dst_src_indices(h, w, metric.device)
    n_dst = dst_idx.numel()
    n_src = l - n_dst
    r = merged_count(l, n_src, ratio)
    n_unm = n_src - r

    m = metric.float()
    m = m / (torch.linalg.vector_norm(m, dim=-1, keepdim=True) + 1e-6)
    scores = torch.matmul(m[:, src_idx], m[:, dst_idx].transpose(1, 2))  # (B, n_src, n_dst)
    node_max = scores.amax(dim=-1)
    node_idx = scores.argmax(dim=-1)  # the first maximum, as jnp.argmax
    order = torch.argsort(-node_max, dim=-1, stable=True)  # most similar first
    merged_src, unm_src = order[:, :r], order[:, r:]
    merged_dst = torch.gather(node_idx, 1, merged_src)  # (B, r) into dst_idx
    counts = torch.ones((b, n_dst), dtype=torch.float32, device=metric.device)
    counts.scatter_add_(1, merged_dst, torch.ones_like(merged_dst, dtype=torch.float32))

    def take(x, idx):  # x (B, N, C), idx (B, K) → (B, K, C)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    def merge(x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        src, dst = xf[:, src_idx], xf[:, dst_idx]
        dst = dst.scatter_add(1, merged_dst[..., None].expand(-1, -1, x.shape[-1]),
                              take(src, merged_src))
        return torch.cat([take(src, unm_src), dst / counts[..., None]], dim=1).to(x.dtype)

    def unmerge(x: torch.Tensor) -> torch.Tensor:
        unm, dst = x[:, :n_unm], x[:, n_unm:]
        c = x.shape[-1]
        # src positions in ``order`` are [merged..., unmerged...]
        src = torch.empty((b, n_src, c), dtype=x.dtype, device=x.device)
        src.scatter_(1, order[..., None].expand(-1, -1, c),
                     torch.cat([take(dst, merged_dst), unm], dim=1))
        full = torch.empty((b, l, c), dtype=x.dtype, device=x.device)
        full[:, dst_idx] = dst
        full[:, src_idx] = src
        return full

    return merge, unmerge, n_unm + n_dst
