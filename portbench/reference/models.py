"""Plain float32 PyTorch models of Stable Diffusion, the benchmark's reference.

CLIP text towers, the UNet of SD-1.x and SDXL-base, and the VAE, written
from diffusers' and transformers' equations with their parameter names, so
that one state dict loads into these modules and into the program's. Every
norm, softmax and GELU runs in float32; every product goes through
:mod:`.lowp`, which can round its operands to fp8 for the control. No
kernel, cache, batching trick or sharding: attention is two matrix
products and a softmax.

Paint-with-words cross-attention follows the paper's code: the bias
``0.1 · log(1 + sigma) · max(QK^T) · w`` is added to the raw logits before
the ``1/sqrt(d)`` scale, the maximum taken over each sample's heads, queries
and keys.

The configuration is the plain dict of ``portbench/configs/<name>.json``:
``clip``, optional ``clip2``, ``unet``, ``vae``, ``scheduler``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .lowp import Conv2d, Linear, matmul


def group_norm(gn: nn.GroupNorm, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
    y = F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps)
    return F.silu(y) if silu else y


def attention(q, k, v, heads: int, fp8: bool, bias_w=None, coef=None, causal=False):
    """(B, Lq, H·d) queries against (B, Lk, H·d) keys and values. ``bias_w``
    (B, Lq, Lk) with ``coef`` (scalar): the PwW bias on the raw logits."""
    b, lq, d = q.shape
    dh = d // heads

    def split(x):
        return x.reshape(b, x.shape[1], heads, dh).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    rows = max(1, (1 << 28) // (b * heads * k.shape[2]))
    if bias_w is None and not causal and rows < lq:  # query blocks, to fit in memory
        return torch.cat([attention_rows(q[:, :, i:i + rows], k, v, fp8)
                          for i in range(0, lq, rows)], dim=2).transpose(1, 2).reshape(b, lq, d)
    s = matmul(q, k.transpose(-1, -2), fp8)
    if bias_w is not None:
        r = s.amax(dim=(1, 2, 3), keepdim=True)
        s = s + coef * r * bias_w[:, None]
    if causal:
        mask = torch.ones(lq, k.shape[2], dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s * dh ** -0.5, dim=-1)
    return matmul(p, v, fp8).transpose(1, 2).reshape(b, lq, d)


def attention_rows(q, k, v, fp8: bool):
    """softmax(QKᵀ/√d)V for a block of query rows, (B, H, rows, d)."""
    p = torch.softmax(matmul(q, k.transpose(-1, -2), fp8) * q.shape[-1] ** -0.5, dim=-1)
    return matmul(p, v, fp8)


# -- CLIP --------------------------------------------------------------------------
class CLIPAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.fp8_attention = False
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (Linear(d, d) for _ in range(4))

    def forward(self, x):
        return self.out_proj(attention(self.q_proj(x), self.k_proj(x), self.v_proj(x),
                                       self.heads, self.fp8_attention, causal=True))


class CLIPMLP(nn.Module):
    def __init__(self, d: int, inner: int, act: str):
        super().__init__()
        self.act = act
        self.fc1, self.fc2 = Linear(d, inner), Linear(inner, d)

    def forward(self, x):
        h = self.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPLayer(nn.Module):
    def __init__(self, c: Dict):
        super().__init__()
        d = c["hidden_size"]
        self.self_attn = CLIPAttention(d, c["num_heads"])
        self.layer_norm1 = nn.LayerNorm(d, eps=c["layer_norm_eps"])
        self.mlp = CLIPMLP(d, c["intermediate_size"], c["hidden_act"])
        self.layer_norm2 = nn.LayerNorm(d, eps=c["layer_norm_eps"])

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class CLIPText(nn.Module):
    """transformers' CLIPTextModel(WithProjection) parameter layout."""

    def __init__(self, c: Dict):
        super().__init__()
        self.c = c
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(c["vocab_size"], c["hidden_size"])
        tm.embeddings.position_embedding = nn.Embedding(c["max_position_embeddings"],
                                                        c["hidden_size"])
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(CLIPLayer(c) for _ in range(c["num_layers"]))
        tm.final_layer_norm = nn.LayerNorm(c["hidden_size"], eps=c["layer_norm_eps"])
        self.text_model = tm
        if c.get("projection_dim"):
            self.text_projection = Linear(c["hidden_size"], c["projection_dim"], bias=False)

    def forward(self, ids: torch.Tensor, output: str = "final"):
        """``"final"``: the final LayerNorm's states; ``"penultimate"``: the
        states entering the last layer; ``"pooled"``: those and the
        projected pooled vector at the first EOS."""
        tm = self.text_model
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[
            :ids.shape[1]]
        layers = tm.encoder.layers
        for layer in layers[:-1]:
            x = layer(x)
        if output == "penultimate":
            return x
        pen = x
        x = tm.final_layer_norm(layers[-1](x))
        if output == "final":
            return x
        eos = self.c.get("eos_token_id")
        pos = (torch.argmax((ids == eos).int(), dim=-1) if eos not in (None, 2)
               else torch.argmax(ids, dim=-1))
        pooled = x[torch.arange(x.shape[0], device=x.device), pos]
        return pen, self.text_projection(pooled)


# -- UNet --------------------------------------------------------------------------
def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, din: int, d: int):
        super().__init__()
        self.linear_1, self.linear_2 = Linear(din, d), Linear(d, d)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, temb: Optional[int], eps: float):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        if temb is not None:
            self.time_emb_proj = Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(group_norm(self.norm1, x, silu=True))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(group_norm(self.norm2, h, silu=True))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, d: int, ctx: int, heads: int):
        super().__init__()
        self.heads = heads
        self.fp8_attention = False
        self.to_q = Linear(d, d, bias=False)
        self.to_k = Linear(ctx, d, bias=False)
        self.to_v = Linear(ctx, d, bias=False)
        self.to_out = nn.ModuleList([Linear(d, d)])

    def forward(self, x, context=None, pww=None):
        ctx = x if context is None else context
        bias_w = coef = None
        if pww is not None and context is not None:
            bias_w = pww["weights"][x.shape[1]]
            coef = pww["coef"]
        out = attention(self.to_q(x), self.to_k(ctx), self.to_v(ctx), self.heads,
                        self.fp8_attention, bias_w, coef)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, d: int, inner: int):
        super().__init__()
        self.proj = Linear(d, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class TransformerBlock(nn.Module):
    def __init__(self, d: int, ctx: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.attn1 = Attention(d, d, heads)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.attn2 = Attention(d, ctx, heads)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(d, 4 * d), nn.Identity(), Linear(4 * d, d)])

    def forward(self, x, ctx, pww):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), ctx, pww)
        return x + self.ff.net[2](self.ff.net[0](self.norm3(x)))


class Transformer2D(nn.Module):
    def __init__(self, c: int, ctx: int, heads: int, groups: int, depth: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.proj_in = Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(c, ctx, heads) for _ in range(depth))
        self.proj_out = Conv2d(c, c, 1)

    def forward(self, x, ctx, pww):
        b, c, h, w = x.shape
        z = self.proj_in(group_norm(self.norm, x))
        z = z.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for blk in self.transformer_blocks:
            z = blk(z, ctx, pww)
        return self.proj_out(z.reshape(b, h, w, c).permute(0, 3, 1, 2)) + x


def heads_for(u: Dict, ch: int) -> int:
    return ch // u["attention_head_dim"] if u.get("attention_head_dim") else u[
        "num_attention_heads"]


def depth_for(u: Dict, i: int) -> int:
    return 1 if u.get("transformer_depth") is None else u["transformer_depth"][i]


class UNet(nn.Module):
    """diffusers' UNet2DConditionModel for SD-1.x and SDXL-base (1×1
    convolutions for ``proj_in``/``proj_out`` at every level)."""

    def __init__(self, u: Dict):
        super().__init__()
        self.u = u
        chs, g, lpb, ctx = (u["block_out_channels"], u["norm_num_groups"],
                            u["layers_per_block"], u["cross_attention_dim"])
        n, temb = len(chs), chs[0] * 4
        self.conv_in = Conv2d(u["in_channels"], chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb)
        if u.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(u["projection_class_embeddings_input_dim"],
                                                   temb)
        self.down_blocks = nn.ModuleList()
        skips = [chs[0]]
        for i, ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(Resnet(chs[max(i - 1, 0)] if j == 0 else ch, ch, g,
                                               temb, 1e-5) for j in range(lpb))
            blk.attentions = (nn.ModuleList(Transformer2D(ch, ctx, heads_for(u, ch), g,
                                                          depth_for(u, i))
                                            for _ in range(lpb))
                              if u["down_block_has_attn"][i] else None)
            blk.downsamplers = (nn.ModuleList([Conv2dStride(ch)]) if i < n - 1 else None)
            skips += [ch] * lpb + ([ch] if i < n - 1 else [])
            self.down_blocks.append(blk)
        mid = nn.Module()
        mid.resnets = nn.ModuleList([Resnet(chs[-1], chs[-1], g, temb, 1e-5) for _ in range(2)])
        mid.attentions = nn.ModuleList([Transformer2D(chs[-1], ctx, heads_for(u, chs[-1]), g,
                                                      depth_for(u, n - 1))])
        self.mid_block = mid
        rev = list(reversed(chs))
        up_attn = list(reversed(u["down_block_has_attn"]))
        self.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            blk = nn.Module()
            cprev = rev[max(i - 1, 0)]
            blk.resnets = nn.ModuleList(
                Resnet((cprev if j == 0 else ch) + skips.pop(), ch, g, temb, 1e-5)
                for j in range(lpb + 1))
            blk.attentions = (nn.ModuleList(Transformer2D(ch, ctx, heads_for(u, ch), g,
                                                          depth_for(u, n - 1 - i))
                                            for _ in range(lpb + 1)) if up_attn[i] else None)
            blk.upsamplers = nn.ModuleList([Upsample(ch)]) if i < n - 1 else None
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, chs[0], eps=1e-5)
        self.conv_out = Conv2d(chs[0], u["out_channels"], 3, padding=1)

    def forward(self, x, t, ctx, pww, added: Optional[Dict] = None):
        u = self.u
        temb = self.time_embedding(timestep_embedding(t.expand(x.shape[0]),
                                                      u["block_out_channels"][0]))
        if added is not None:
            ids = added["time_ids"]
            tf = timestep_embedding(ids.reshape(-1), u["addition_time_embed_dim"])
            temb = temb + self.add_embedding(torch.cat(
                [added["text_embeds"], tf.reshape(ids.shape[0], -1)], dim=-1))
        x = self.conv_in(x)
        skips: List[torch.Tensor] = [x]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(x, temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, ctx, pww)
                skips.append(x)
            if blk.downsamplers is not None:
                x = blk.downsamplers[0](x)
                skips.append(x)
        m = self.mid_block
        x = m.resnets[1](m.attentions[0](m.resnets[0](x, temb), ctx, pww), temb)
        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                x = res(torch.cat([x, skips.pop()], dim=1), temb)
                if blk.attentions is not None:
                    x = blk.attentions[j](x, ctx, pww)
            if blk.upsamplers is not None:
                x = blk.upsamplers[0](x)
        return self.conv_out(group_norm(self.conv_norm_out, x, silu=True))


class Conv2dStride(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


# -- VAE ---------------------------------------------------------------------------
class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.fp8_attention = False
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q, self.to_k, self.to_v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        b, c, h, w = x.shape
        z = group_norm(self.group_norm, x).reshape(b, c, h * w).transpose(1, 2)
        out = attention(self.to_q(z), self.to_k(z), self.to_v(z), 1, self.fp8_attention)
        return x + self.to_out[0](out).transpose(1, 2).reshape(b, c, h, w)


class VAEMid(nn.Module):
    def __init__(self, c: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(c, c, g, None, 1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(c, g)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class PadDown(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAE(nn.Module):
    """diffusers' AutoencoderKL parameter layout; only the decoder runs here,
    the encoder is there for the layout."""

    def __init__(self, v: Dict):
        super().__init__()
        self.v = v
        chs, g, lpb, lat = (v["block_out_channels"], v["norm_num_groups"],
                            v["layers_per_block"], v["latent_channels"])
        enc = nn.Module()
        enc.conv_in = Conv2d(v["in_channels"], chs[0], 3, padding=1)
        enc.down_blocks = nn.ModuleList()
        for i, ch in enumerate(chs):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(Resnet(chs[max(i - 1, 0)] if j == 0 else ch, ch, g,
                                               None, 1e-6) for j in range(lpb))
            blk.downsamplers = nn.ModuleList([PadDown(ch)]) if i < len(chs) - 1 else None
            enc.down_blocks.append(blk)
        enc.mid_block = VAEMid(chs[-1], g)
        enc.conv_norm_out = nn.GroupNorm(g, chs[-1], eps=1e-6)
        enc.conv_out = Conv2d(chs[-1], 2 * lat, 3, padding=1)
        self.encoder = enc
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = Conv2d(lat, lat, 1)
        dec = nn.Module()
        rev = list(reversed(chs))
        dec.conv_in = Conv2d(lat, rev[0], 3, padding=1)
        dec.mid_block = VAEMid(rev[0], g)
        dec.up_blocks = nn.ModuleList()
        for i, ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList(Resnet(rev[max(i - 1, 0)] if j == 0 else ch, ch, g,
                                               None, 1e-6) for j in range(lpb + 1))
            blk.upsamplers = nn.ModuleList([Upsample(ch)]) if i < len(rev) - 1 else None
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        dec.conv_out = Conv2d(rev[-1], v["out_channels"], 3, padding=1)
        self.decoder = dec

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        d = self.decoder
        h = d.mid_block(d.conv_in(self.post_quant_conv(z)))
        for blk in d.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return d.conv_out(group_norm(d.conv_norm_out, h, silu=True))


def build(config: Dict, device="meta") -> Dict[str, nn.Module]:
    """{"unet", "clip", ["clip2",] "vae"} for a configuration dict, on
    ``device`` (the meta device by default: no memory, for shapes and
    counts)."""
    with torch.device(device):
        parts = {"unet": UNet(config["unet"]), "clip": CLIPText(config["clip"]),
                 "vae": VAE(config["vae"])}
        if config.get("clip2"):
            parts["clip2"] = CLIPText(config["clip2"])
    return {k: m.eval().requires_grad_(False) for k, m in parts.items()}
