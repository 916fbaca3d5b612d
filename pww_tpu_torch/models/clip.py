"""CLIP text encoder (SD 1.x text conditioning) as a torch ``nn.Module``.

Port of :mod:`pww_tpu.models.clip` (final hidden state only). Parameter
names are transformers' ``CLIPTextModel`` names
(``text_model.encoder.layers.0.self_attn.q_proj.weight``, …). Pre-LN
transformer with causal self-attention and a quick-GELU MLP; LayerNorms
compute in f32 and cast back to the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPTextConfig
from ..ops.attention import merge_heads, pww_attention, split_heads
from ..ops.layer_norm import layer_norm_f32


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(x), self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(merge_heads(pww_attention(q, k, v, causal=True)))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        h = quick_gelu(h) if self.act == "quick_gelu" else F.gelu(h)
        return self.fc2(h)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.layer_norm1, x))
        return x + self.mlp(layer_norm_f32(self.layer_norm2, x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.token_embedding(ids) + self.position_embedding.weight[: ids.shape[1]]


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)
        )


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    """(B, L) int64 ids → (B, L, hidden_size) last hidden state."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        x = tm.embeddings(input_ids)
        for layer in tm.encoder.layers:
            x = layer(x)
        return layer_norm_f32(tm.final_layer_norm, x)
