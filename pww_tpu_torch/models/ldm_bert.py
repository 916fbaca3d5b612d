"""LDM-BERT, the original latent-diffusion text tower.

Port of :mod:`pww_tpu.models.ldm_bert`: the reference converter rebuilds
diffusers 0.10.0's ``LDMBertModel`` from a CompVis latent-diffusion
checkpoint (reference ``change_model_path.py:742-792``) for the plain
text-to-image pipeline only; paint-with-words conditions on CLIP. The tower
is here so that such checkpoints convert with nothing dropped.

Token and absolute position embeddings summed (no embedding norm); pre-LN
encoder layers of bidirectional self-attention whose q/k/v projections map
``d_model`` to ``num_heads · head_dim`` without bias, and an exact-erf GELU
MLP; a final LayerNorm. LayerNorms compute in f32. The ``to_logits`` head,
unused by the forward pass but present in checkpoints, is applied with
``return_logits=True``. Parameter names are diffusers' (without its
``model.`` prefix).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import LDMBertConfig
from ..ops.attention import merge_heads, pww_attention, split_heads
from ..ops.layer_norm import layer_norm_f32


class LDMBertAttention(nn.Module):
    def __init__(self, cfg: LDMBertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.q_proj = nn.Linear(cfg.d_model, cfg.inner_dim, bias=False)
        self.k_proj = nn.Linear(cfg.d_model, cfg.inner_dim, bias=False)
        self.v_proj = nn.Linear(cfg.d_model, cfg.inner_dim, bias=False)
        self.out_proj = nn.Linear(cfg.inner_dim, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(x), self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(merge_heads(pww_attention(q, k, v)))


class LDMBertEncoderLayer(nn.Module):
    def __init__(self, cfg: LDMBertConfig):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.self_attn = LDMBertAttention(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(cfg.d_model, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, cfg.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(layer_norm_f32(self.self_attn_layer_norm, x))
        h = F.gelu(self.fc1(layer_norm_f32(self.final_layer_norm, x)))
        return x + self.fc2(h)


class LDMBertModel(nn.Module):
    """(B, L) ids → (B, L, d_model) last hidden state (f32 after the final
    LayerNorm); with ``return_logits`` also ``to_logits`` of it, (B, L,
    vocab)."""

    def __init__(self, cfg: LDMBertConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.embed_positions = nn.Embedding(cfg.max_position_embeddings, cfg.d_model)
        self.layers = nn.ModuleList(LDMBertEncoderLayer(cfg) for _ in range(cfg.num_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)
        self.to_logits = nn.Linear(cfg.d_model, cfg.vocab_size)

    def forward(self, input_ids: torch.Tensor, return_logits: bool = False):
        x = self.embed_tokens(input_ids) + self.embed_positions.weight[: input_ids.shape[-1]]
        for layer in self.layers:
            x = layer(x)
        x = layer_norm_f32(self.layer_norm, x.float())
        if return_logits:
            return x, self.to_logits(x.to(self.to_logits.weight.dtype))
        return x
