"""SD UNet2DCondition with first-class paint-with-words bias threading.

Port of :mod:`pww_tpu.models.unet` for SD-1.x, SD-2.x and SDXL base and
refiner, as a torch ``nn.Module`` with diffusers' ``UNet2DConditionModel``
parameter names, NCHW inside the conv stacks. SDXL adds a transformer depth
per stage (``UNetConfig.depth_for``) and the ``text_time`` ``add_embedding``
of the pooled text and the micro-conditioning ``time_ids``. GroupNorm
epsilon is 1e-5 in the ResNets and 1e-6 in Transformer2D; GEGLU uses the
exact f32 GELU. Every GroupNorm site runs kernel K4 (one pass, bf16 in and
out, f32 statistics; a ResNet's norm2 takes the time-embedding projection
as its pre-add, and the SiLU is fused) and every transformer LayerNorm
runs K5 where the site's input is bf16 on the card and autograd records no
gradient through it (``ops/cuda_build.py:norm_site_takes_kernel``; K5 also
needs a width that is a multiple of 8 of at most 2048). Everything else,
the CPU, f32 pipelines and training, computes the norms in f32 and casts
to the compute dtype. ``UNetConfig.fused_group_norm`` and
``fused_layer_norm`` send every site to K4 and K5 on every device (their
plain versions on the CPU).

Attention dispatch (``pww_tpu/models/unet.py:177-211``), per site:
  * self-attention with L >= ``flash_min_seq`` → K3 flash kernel;
  * cross-attention with a PwW bias, Lq >= ``fused_cross_min_seq`` and a
    structured weight function → K1 reduce, then K2 fused cross-attention;
  * everything else → dense :func:`pww_attention`, and so is any head dim
    the kernels are not built for (``HEAD_DIMS``), the reference's own
    route for shapes its kernels do not take;
  * SAG's site, when a call asks for its probabilities → dense f32.

The sampling extras are arguments of :meth:`UNet2DConditionModel.forward`:
ToMe, FreeU, SAG's probabilities and DeepCache's collect and use passes.

The IP-Adapter (``UNetConfig.ip_adapter_tokens``,
``pww_tpu/models/unet.py:212-232``): every attn2 gains ``to_k_ip`` and
``to_v_ip``, and adds ``scale`` times a dense attention of its queries over
the image-prompt tokens (:class:`~pww_tpu_torch.types.IpState`) to the text
branch's output. The PwW bias and the K1/K2 route stay on the text branch.

Tensor parallelism (:func:`pww_tpu_torch.parallel.mesh.shard_params`): a
transformer block whose head count the mesh's tp divides runs H/tp heads
on each rank (``to_q``/``to_k``/``to_v`` and the IP branch's projections
cut by rows, K1-K3 at B·H/tp) and 1/tp of GEGLU's inner width (each half
of ``proj`` cut alike); ``to_out`` and ``ff.net.2``, cut by columns, are
summed over tp in the activation dtype before their bias. The weight
function still sees every head: K1's and the dense path's reductions are
combined over tp, a callable gets the gathered scores, SAG the gathered
probabilities. Blocks whose head count tp does not divide run whole on
every rank with no collective: SD-2.1's 5-head level at tp 2 (at tp 4
its 5- and 10-head levels), SDXL's 10-head level at tp 4, the tiny
configs (4 heads) at tp 8. Under autograd the collectives carry the
gradient (:mod:`pww_tpu_torch.parallel.tp`): each cut layer's replicated
input enters through :meth:`~pww_tpu_torch.parallel.tp.TensorParallel.enter`.

Spatial sharding (:mod:`pww_tpu_torch.parallel.spatial`, active for a
``generate(sharding="spatial")`` call): each rank holds its block of rows
at every level; the 3×3 convolutions exchange a row with each neighbour,
the stride-2 downsample takes the row above, the GroupNorms combine their
moments over dp, a self-attention's queries (this rank's rows) attend the
keys and values gathered over dp, a cross-attention looks its PwW bias up
by the whole site's count and keeps its rows, and K1's (or the dense
path's) reduction is combined over dp (then over tp as well). The
dispatch thresholds test the whole site's token count, so that a site
takes the kernel it takes in one process; K3 then runs at Lq = L/dp
against Lk = L. ToMe's matching, FreeU's filter, SAG's probabilities and a
custom weight function see the whole site, on gathered rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import UNetConfig
from ..ops.attention import merge_heads, pww_attention, split_heads
from ..ops.cross_attention_kernel import (HEAD_DIMS, fused_pww_cross_attention,
                                         fused_pww_reduce)
from ..ops.flash_attention import flash_self_attention
from ..ops.group_norm import group_norm_site
from ..ops.layer_norm import layer_norm_site
from ..ops.tome import build_token_merge
from ..ops.weight_functions import CustomWeightFunction
from ..parallel import spatial
from ..parallel.tp import row_parallel
from ..types import IpState, PwwState


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, SD convention (flip_sin_to_cos=True, shift=0)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def text_time_embedding(add_embedding: nn.Module, added_cond: dict, time_dim: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """SDXL's ``text_time`` addition: the pooled text ++ each micro-
    conditioning ``time_ids`` entry's Fourier features (``time_dim`` each),
    through ``add_embedding``."""
    time_ids = added_cond["time_ids"]
    add_t = timestep_embedding(time_ids.reshape(-1), time_dim)
    add_in = torch.cat([added_cond["text_embeds"].float(),
                        add_t.reshape(time_ids.shape[0], -1)], dim=-1)
    return add_embedding(add_in.to(dtype))


class TimestepEmbedding(nn.Module):
    """``cond_dim``: an LCM-distilled UNet's guidance-scale condition, whose
    bias-free projection ``cond_proj`` joins the sinusoidal embedding before
    ``linear_1`` (diffusers' ``TimestepEmbedding.cond_proj``,
    ``pww_tpu/models/unet.py:44-62``)."""

    def __init__(self, in_dim: int, dim: int, cond_dim: Optional[int] = None):
        super().__init__()
        self.cond_proj = None if cond_dim is None else nn.Linear(cond_dim, in_dim, bias=False)
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        if cond is not None:
            t_emb = t_emb + self.cond_proj(cond)
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb_dim: int, groups: int,
                 fused_norm: bool = False):
        super().__init__()
        self.fused_norm = fused_norm
        self.norm1 = nn.GroupNorm(groups, c_in, eps=1e-5)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = nn.GroupNorm(groups, c_out, eps=1e-5)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        fused = self.fused_norm
        h = spatial.conv(self.conv1, group_norm_site(self.norm1, x, fused=fused, silu=True))
        t = self.time_emb_proj(F.silu(temb))
        h = spatial.conv(self.conv2, group_norm_site(self.norm2, h, fused=fused, silu=True,
                                                     add=t))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate.float()).to(h.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 GEGLU, net.1 dropout (no params), net.2 out
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])
        self.tp = None  # parallel.mesh.shard_params: 1/tp of the inner width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = self.tp.enter(x)
        return row_parallel(self.net[2], self.net[0](x), self.tp)


class Attention(nn.Module):
    """q from hidden states; k, v from a context sequence (or the states);
    ``ip``: the IP-Adapter's ``to_k_ip``/``to_v_ip`` (a cross-attention)."""

    def __init__(self, dim: int, ctx_dim: int, heads: int, cfg: UNetConfig, ip: bool = False):
        super().__init__()
        self.heads = heads
        self.cfg = cfg
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        if ip:
            self.to_k_ip = nn.Linear(ctx_dim, dim, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, dim, bias=False)
        self.has_ip = ip
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.tp = None  # parallel.mesh.shard_params: this rank's heads only

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                pww: Optional[PwwState] = None,
                sag_probs: Optional[List[torch.Tensor]] = None,
                ip: Optional[IpState] = None, sp: Optional[spatial.Spatial] = None,
                ) -> torch.Tensor:
        """``sag_probs`` (self-attention only): a list that takes this site's
        f32 attention probabilities (B, H, L, L) for SAG; the site's output
        then comes from those probabilities in f32 too, as in
        ``pww_tpu/models/unet.py:163-176``, on every path. ``ip``: the
        image-prompt tokens, in the compute dtype, and the scale, rounded to
        it, where this site has the IP branch. ``sp``: the spatial handle
        where ``x`` holds this rank's rows of the site's tokens."""
        cfg, tp = self.cfg, self.tp
        is_self = context is None
        if tp is not None:  # replicated inputs of the column-cut projections
            x = tp.enter(x)
            context = None if is_self else tp.enter(context)
        ctx = x if is_self else context
        heads = self.heads if tp is None else self.heads // tp.size
        q, k, v = (split_heads(t, heads)
                   for t in (self.to_q(x), self.to_k(ctx), self.to_v(ctx)))
        lq, dh = q.shape[2], q.shape[3]
        l_site = lq if sp is None else lq * sp.size  # the whole site's queries
        if is_self and sp is not None:
            k, v = sp.gather_tokens(k, v, dim=2)
        bias_w = bias_rows = weight_fn = sigma = None
        if pww is not None and not is_self:
            bias_w = bias_rows = pww.bias_for(l_site)
            if sp is not None and bias_w is not None:  # K2 takes it contiguous
                bias_rows = sp.local_tokens(bias_w, 1).contiguous()
            weight_fn, sigma = pww.weight_fn, pww.sigma
        groups = [g for g in (tp, sp) if g is not None]  # reductions combine over these
        custom = isinstance(weight_fn, CustomWeightFunction)

        def combined(mode, r, n_local, local_mean):
            """A reduction over this rank's heads and rows, combined over tp,
            then over dp (std: the next stage takes the combined mean)."""
            for i, g in enumerate(groups):
                mean_now = local_mean
                r = g.combine_reduce(mode, r, n_local, mean_now)
                if mode == "std" and i + 1 < len(groups):
                    m = g.combine_reduce("mean", mean_now().float(), n_local, None)
                    local_mean = lambda m=m: m  # noqa: E731
                n_local *= g.size
            return r

        if is_self and sag_probs is not None:
            s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * dh ** -0.5
            probs = torch.softmax(s, dim=-1)
            full = probs if tp is None else tp.gather_heads(probs)
            if sp is not None:
                full = sp.gather_tokens(full, dim=2, kind="rows")[0]
            sag_probs.append(full)
            out = torch.matmul(probs, v.float()).to(v.dtype)
        elif is_self and cfg.flash_attention and l_site >= cfg.flash_min_seq and dh in HEAD_DIMS:
            out = flash_self_attention(q, k, v)
        elif (bias_w is not None and cfg.fused_cross_attention
              and l_site >= cfg.fused_cross_min_seq and dh in HEAD_DIMS and not custom):
            r = fused_pww_reduce(q, k, weight_fn)
            if groups:
                mean_fn = dataclasses.replace(weight_fn, reduce_mode="mean")
                r = combined(weight_fn.reduce_mode, r, heads * lq * k.shape[2],
                             lambda: fused_pww_reduce(q, k, mean_fn))
            out = fused_pww_cross_attention(q, k, v, bias_rows, weight_fn.sigma_coef(sigma) * r)
        elif groups and bias_w is not None and custom:
            # the callable sees every head and row: the site runs whole, each
            # rank keeps its heads and rows
            qw, kw, vw = (q, k, v) if tp is None else map(tp.gather_heads, (q, k, v))
            if sp is not None:
                qw = sp.gather_tokens(qw, dim=2, kind="rows")[0]
            out = pww_attention(qw, kw, vw, bias_w=bias_w, weight_fn=weight_fn, sigma=sigma)
            out = out if tp is None else tp.local_heads(out)
            out = out if sp is None else sp.local_tokens(out, 2)
        else:
            reduce = None
            if groups and weight_fn is not None:
                def reduce(s):  # this rank's heads' and rows' reduction, combined
                    r = weight_fn.reduce_qk(s, batch_axes=1)
                    return combined(weight_fn.reduce_mode, r.reshape(-1), s[0].numel(),
                                    lambda: s.mean(dim=(1, 2, 3))).reshape(r.shape)
            out = pww_attention(q, k, v, bias_w=bias_rows, weight_fn=weight_fn,
                                sigma=sigma, reduce=reduce)
        if self.has_ip:
            if ip is None:
                raise ValueError("ip_adapter_tokens is set: pass an IpState operand")
            tokens = ip.tokens if tp is None else tp.enter(ip.tokens)
            out_ip = pww_attention(q, split_heads(self.to_k_ip(tokens), heads),
                                   split_heads(self.to_v_ip(tokens), heads))
            out = out + ip.scale * out_ip
        return row_parallel(self.to_out[0], merge_heads(out), tp)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, heads: int, cfg: UNetConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, dim, heads, cfg)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, ctx_dim, heads, cfg, ip=cfg.ip_adapter_tokens is not None)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)
        self.fused_norm = cfg.fused_layer_norm

    def forward(self, x, context, pww, grid=None, tome_ratio: float = 0.0, sag_probs=None,
                ip=None, sp=None):
        """``tome_ratio`` > 0 with the token ``grid`` (h, w): ToMe around
        ``attn1``, the block input as the similarity metric
        (``pww_tpu/models/unet.py:264-275``). ``sp``: the spatial handle
        where ``x`` holds this rank's rows of the (whole) ``grid``; ToMe then
        matches and runs ``attn1`` on the gathered rows."""
        fused = self.fused_norm
        h = layer_norm_site(self.norm1, x, fused=fused)
        if tome_ratio > 0.0 and grid is not None:
            xw, hw = (x, h) if sp is None else sp.gather_tokens(x, h, dim=1, kind="rows")
            merge, unmerge, _ = build_token_merge(xw, grid[0], grid[1], tome_ratio)
            y = unmerge(self.attn1(merge(hw)))
            x = x + (y if sp is None else sp.local_tokens(y, 1))
        else:
            x = x + self.attn1(h, sag_probs=sag_probs, sp=sp)
        x = x + self.attn2(layer_norm_site(self.norm2, x, fused=fused), context, pww, ip=ip,
                           sp=sp)
        return x + self.ff(layer_norm_site(self.norm3, x, fused=fused))


class Transformer2DModel(nn.Module):
    """GroupNorm → 1x1 proj → ``depth`` transformer blocks over flattened
    space → 1x1 proj."""

    def __init__(self, channels: int, ctx_dim: int, heads: int, cfg: UNetConfig,
                 depth: int = 1):
        super().__init__()
        self.fused_norm = cfg.fused_group_norm
        self.tome_min_tokens = cfg.tome_min_tokens
        self.norm = nn.GroupNorm(cfg.norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, ctx_dim, heads, cfg) for _ in range(depth)
        )
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, pww, tome_ratio: float = 0.0, sag_probs=None, ip=None):
        """ToMe only at sites of at least ``tome_min_tokens`` tokens (tomesd's
        max_downsample=1); ``sag_probs`` goes to block 0's ``attn1``, ``ip``
        to every block's ``attn2``."""
        b, c, h, w = x.shape
        sp = spatial.site(x)
        grid = (h if sp is None else sp.site_height(w), w)  # the whole site's
        z = self.proj_in(group_norm_site(self.norm, x, fused=self.fused_norm))
        z = z.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        tome = tome_ratio if grid[0] * w >= self.tome_min_tokens else 0.0
        for i, blk in enumerate(self.transformer_blocks):
            z = blk(z, context, pww, grid, tome, sag_probs if i == 0 else None, ip, sp)
        z = z.reshape(b, h, w, c).permute(0, 3, 1, 2)
        # x first: the sum takes x's NCHW layout rather than proj_out's
        # channels-last one, so the norm sites after it need no copy for K4
        return x + self.proj_out(z)


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return spatial.down_conv(self.conv, x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        x = spatial.settle(F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return spatial.conv(self.conv, x)


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (with attentions, ``depth`` transformer blocks
    each) or DownBlock2D."""

    def __init__(self, c_in, c_out, temb_dim, cfg: UNetConfig, has_attn, last, depth=1):
        super().__init__()
        nh = cfg.heads_for(c_out)[0]
        self.resnets = nn.ModuleList(
            ResnetBlock2D(c_in if i == 0 else c_out, c_out, temb_dim,
                          cfg.norm_num_groups, cfg.fused_group_norm)
            for i in range(cfg.layers_per_block)
        )
        self.attentions = nn.ModuleList(
            Transformer2DModel(c_out, cfg.cross_attention_dim, nh, cfg, depth)
            for _ in range(cfg.layers_per_block)
        ) if has_attn else None
        self.downsamplers = None if last else nn.ModuleList([Downsample2D(c_out)])

    def forward(self, x, temb, ctx, pww, skips: List[torch.Tensor],
                intrablock: Optional[torch.Tensor] = None, tome_ratio: float = 0.0,
                downsample: bool = True, ip: Optional[IpState] = None):
        """``intrablock``: a T2I-Adapter feature, added after the last
        transformer, so that it joins that skip and the downsampler's input
        (diffusers' CrossAttnDownBlock2D ``additional_residuals``). An
        attention-less block takes its feature in the UNet, after the block.
        ``downsample=False`` stops before the downsampler and its skip (the
        JAX package's ``_down_block``, which DeepCache's shallow pass runs)."""
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx, pww, tome_ratio, ip=ip)
                if intrablock is not None and i == len(self.resnets) - 1:
                    x = x + intrablock.to(x.dtype)
            skips.append(x)
        if self.downsamplers is not None and downsample:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (with attentions) or UpBlock2D."""

    def __init__(self, c_prev, c_out, skip_chs, temb_dim, cfg: UNetConfig,
                 has_attn, last, depth=1):
        super().__init__()
        nh = cfg.heads_for(c_out)[0]
        self.resnets = nn.ModuleList(
            ResnetBlock2D((c_prev if i == 0 else c_out) + skip_chs[i], c_out,
                          temb_dim, cfg.norm_num_groups, cfg.fused_group_norm)
            for i in range(cfg.layers_per_block + 1)
        )
        self.attentions = nn.ModuleList(
            Transformer2DModel(c_out, cfg.cross_attention_dim, nh, cfg, depth)
            for _ in range(cfg.layers_per_block + 1)
        ) if has_attn else None
        self.upsamplers = None if last else nn.ModuleList([Upsample2D(c_out)])

    def forward(self, x, temb, ctx, pww, skips: List[torch.Tensor], tome_ratio: float = 0.0,
                freeu: Optional[Tuple[float, float]] = None, ip: Optional[IpState] = None):
        """``freeu`` = (b, s): FreeU before each resnet, the backbone's first
        half of the channels times b and the skip's low frequencies times s
        (``pww_tpu/models/unet.py:441-450``)."""
        for i, resnet in enumerate(self.resnets):
            skip = skips.pop()
            if freeu is not None:
                half = x.shape[1] // 2
                x = torch.cat([x[:, :half] * freeu[0], x[:, half:]], dim=1)
                skip = spatial.whole_site(lambda s: fourier_filter(s, 1, freeu[1]), skip)
            x = resnet(torch.cat([x, skip], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, ctx, pww, tome_ratio, ip=ip)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, ch, temb_dim, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim, cfg.norm_num_groups, cfg.fused_group_norm)
             for _ in range(2)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2DModel(ch, cfg.cross_attention_dim, cfg.heads_for(ch)[0], cfg,
                                cfg.depth_for(len(cfg.block_out_channels) - 1))]
        )

    def forward(self, x, temb, ctx, pww, tome_ratio: float = 0.0, sag_probs=None, ip=None):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, ctx, pww, tome_ratio, sag_probs, ip)
        return self.resnets[1](x, temb)


def fourier_filter(x: torch.Tensor, threshold: int, scale: float) -> torch.Tensor:
    """FreeU's skip filter (Si et al. 2023, ``Fourier_filter``): the
    frequencies inside the centred ``threshold`` box of the shifted 2-D
    spectrum of the last two axes times ``scale``, in f32, cast back
    (``pww_tpu/models/unet.py:368-385``, there over NHWC's spatial axes)."""
    dims = (-2, -1)
    xf = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=dims), dim=dims)
    h, w = x.shape[-2], x.shape[-1]
    rows = torch.arange(h, device=x.device) - h // 2
    cols = torch.arange(w, device=x.device) - w // 2
    box = (((rows >= -threshold) & (rows < threshold))[:, None]
           & ((cols >= -threshold) & (cols < threshold))[None, :])
    ones = torch.ones((h, w), dtype=torch.float32, device=x.device)
    xf = xf * torch.where(box, ones * scale, ones)
    xf = torch.fft.ifftshift(xf, dim=dims)
    return torch.fft.ifftn(xf, dim=dims).real.to(x.dtype)


def skip_channels(cfg: UNetConfig) -> List[int]:
    """Channels of the down path's skips, in the order it appends them: the
    ``conv_in`` output, each layer of each block, each downsampler."""
    chs = cfg.block_out_channels
    out = [chs[0]]
    for i, ch in enumerate(chs):
        out += [ch] * cfg.layers_per_block + ([ch] if i < len(chs) - 1 else [])
    return out


class UNet2DConditionModel(nn.Module):
    """SD UNet; ``pww`` carries the paint-with-words bias pyramid."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.config = cfg
        chs = cfg.block_out_channels
        n = len(chs)
        temb_dim = chs[0] * cfg.time_embed_mult
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim, cfg.time_cond_proj_dim)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb_dim)
        elif cfg.addition_embed_type is not None:
            raise ValueError(f"addition_embed_type {cfg.addition_embed_type!r}: the UNet "
                             "takes text_time (SDXL) only")
        self.down_blocks = nn.ModuleList(
            DownBlock(chs[max(i - 1, 0)], chs[i], temb_dim, cfg,
                      cfg.down_block_has_attn[i], i == n - 1, cfg.depth_for(i))
            for i in range(n)
        )
        self.mid_block = UNetMidBlock2DCrossAttn(chs[-1], temb_dim, cfg)
        skip_chs = skip_channels(cfg)
        rev = list(reversed(chs))
        ups = []
        for i, ch in enumerate(rev):
            pops = [skip_chs.pop() for _ in range(cfg.layers_per_block + 1)]
            ups.append(UpBlock(rev[max(i - 1, 0)], ch, pops, temb_dim, cfg,
                               cfg.up_block_has_attn[i], i == n - 1, cfg.depth_for(n - 1 - i)))
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, chs[0], eps=1e-5)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                pww: Optional[PwwState] = None,
                down_block_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_residual: Optional[torch.Tensor] = None,
                down_intrablock_residuals: Optional[Sequence[torch.Tensor]] = None,
                added_cond: Optional[dict] = None,
                *,
                tome_ratio: float = 0.0,
                freeu: Optional[Tuple[float, float, float, float]] = None,
                sag_probs: Optional[List[torch.Tensor]] = None,
                cache_mode: Optional[str] = None,
                cached_feature: Optional[torch.Tensor] = None,
                ip: Optional[IpState] = None,
                ):
        """(B, C_in, h, w) latents → (B, C_out, h, w) in the compute dtype.

        ``down_block_residuals`` (one per skip, the ``conv_in`` skip first)
        and ``mid_block_residual`` are ControlNet residuals: added to every
        skip, and to the mid block's output. ``down_intrablock_residuals``
        (one per down block) are T2I-Adapter features
        (``pww_tpu/models/unet.py:424-432, 585-600``): on an attention
        block after its last transformer, inside its skip; on an
        attention-less one after the whole block, outside every skip.

        ``added_cond`` = {"text_embeds": (B, pooled), "time_ids": (B, 5 or
        6)}, both f32, is SDXL's micro-conditioning
        (``pww_tpu/models/unet.py:538-553``): the time ids' sinusoidal
        embeddings after the pooled text, cast to the compute dtype and
        through ``add_embedding``, join the timestep embedding. An
        LCM-distilled UNet (``time_cond_proj_dim``) takes the embedded
        guidance scale as ``added_cond["timestep_cond"]`` (B, dim).

        The sampling extras, per call (the JAX package builds a module per
        setting, ``pww_tpu/pipeline/pipeline.py:1161-1190``): ``tome_ratio``
        merges tokens around every ``attn1`` of at least
        ``config.tome_min_tokens`` tokens; ``freeu`` = (b1, b2, s1, s2)
        re-weights up blocks 0 and 1; ``sag_probs`` takes the mid block's
        first self-attention probabilities (SAG). DeepCache
        (``pww_tpu/models/unet.py:490-512, 565-581, 638-648``):
        ``cache_mode="collect"`` returns ``(out, feature)``, the feature the
        output of up block n−2 after its upsampler (the last up block's
        input); ``cache_mode="use"`` runs only ``conv_in``, down block 0
        (without its downsampler), the last up block on ``cached_feature``
        and the head.

        ``ip``: the IP-Adapter's tokens (B, n_ip, D_ctx) and scale, for a
        UNet with ``ip_adapter_tokens``; both passes of DeepCache take it.
        """
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        t_cond = None
        if cfg.time_cond_proj_dim is not None:
            if added_cond is None or "timestep_cond" not in added_cond:
                raise ValueError('time_cond_proj_dim is set: pass added_cond='
                                 '{"timestep_cond": (B, time_cond_proj_dim)} '
                                 "(the embedded guidance scale)")
            t_cond = added_cond["timestep_cond"].to(dtype)
        temb = self.time_embedding(t_emb.to(dtype), t_cond)
        if cfg.addition_embed_type == "text_time":
            if added_cond is None:
                raise ValueError('addition_embed_type="text_time" requires added_cond='
                                 '{"text_embeds": (B, D_pool), "time_ids": (B, 6)}')
            temb = temb + text_time_embedding(self.add_embedding, added_cond,
                                              cfg.addition_time_embed_dim, dtype)
        ctx = encoder_hidden_states.to(dtype)
        if ip is not None:  # the tokens and the scale in the compute dtype, once
            ip = IpState(ip.tokens.to(dtype),
                         float(torch.tensor(ip.scale, dtype=torch.float32).to(dtype)))
        x = spatial.conv(self.conv_in, sample.to(dtype))
        skips = [x]
        n = len(self.up_blocks)

        def up_freeu(i):
            if freeu is None or i >= 2:
                return None
            return (freeu[0], freeu[2]) if i == 0 else (freeu[1], freeu[3])

        if cache_mode == "use":
            if down_block_residuals is not None or mid_block_residual is not None:
                raise ValueError("DeepCache shallow pass + ControlNet residuals "
                                 "is not supported")
            if cached_feature is None:
                raise ValueError('cache_mode="use" requires cached_feature')
            self.down_blocks[0](x, temb, ctx, pww, skips, tome_ratio=tome_ratio,
                                downsample=False, ip=ip)
            x = self.up_blocks[n - 1](cached_feature.to(dtype), temb, ctx, pww, skips,
                                      tome_ratio, up_freeu(n - 1), ip)
            return self._head(x)
        for i, blk in enumerate(self.down_blocks):
            intra = None if down_intrablock_residuals is None else down_intrablock_residuals[i]
            x = blk(x, temb, ctx, pww, skips, intra, tome_ratio, ip=ip)
            if intra is not None and blk.attentions is None:
                x = x + intra.to(x.dtype)
        if down_block_residuals is not None:
            if len(down_block_residuals) != len(skips):
                raise ValueError(f"{len(down_block_residuals)} down-block residuals for "
                                 f"{len(skips)} skips")
            skips = [s + r for s, r in zip(skips, down_block_residuals)]
        x = self.mid_block(x, temb, ctx, pww, tome_ratio, sag_probs, ip)
        if mid_block_residual is not None:
            x = x + mid_block_residual
        feature = None
        for i, blk in enumerate(self.up_blocks):
            x = blk(x, temb, ctx, pww, skips, tome_ratio, up_freeu(i), ip)
            if i == n - 2:
                feature = x
        out = self._head(x)
        return (out, feature) if cache_mode == "collect" else out

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.conv(self.conv_out, group_norm_site(
            self.conv_norm_out, x, silu=True, fused=self.config.fused_group_norm))
