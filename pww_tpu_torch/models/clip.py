"""CLIP text encoder (SD text conditioning) as a torch ``nn.Module``.

Port of :mod:`pww_tpu.models.clip`: the final hidden state (SD-1.x/2.x), or
SDXL's penultimate hidden state with the projected pooled vector. Parameter
names are transformers' ``CLIPTextModel`` names
(``text_model.encoder.layers.0.self_attn.q_proj.weight``, …), and
``CLIPTextModelWithProjection``'s top-level ``text_projection.weight`` for a
tower with ``projection_dim``. Pre-LN transformer with causal
self-attention and a quick-GELU (or GELU) MLP; LayerNorms compute in f32
and cast back to the compute dtype.
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
    """Causal for the text tower; ``causal=False`` for the vision tower
    (:mod:`~pww_tpu_torch.models.clip_vision`)."""

    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.causal = causal
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (split_heads(p(x), self.num_heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(merge_heads(pww_attention(q, k, v, causal=self.causal)))


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
    """Pre-LN layer; ``cfg`` is a text or a vision tower's config."""

    def __init__(self, cfg: CLIPTextConfig, causal: bool = True):
        super().__init__()
        self.self_attn = CLIPAttention(cfg, causal)
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
    """(B, L) int64 ids → (B, L, hidden_size) last hidden state.

    ``output="penultimate"`` returns the hidden state entering the last
    layer (transformers' ``hidden_states[-2]``, no final LayerNorm), and
    ``"penultimate_and_pooled"`` that and ``text_projection`` of the final
    state at the EOS position: the first ``eos_token_id``, or the largest id
    where ``eos_token_id`` is None or the legacy 2 of SD config files, which
    never occurs in a prompt (``pww_tpu/models/clip.py:139-157``).

    ``skip_layers=k`` (A1111's "CLIP skip" k + 1, diffusers' ``clip_skip``):
    ``output="final"`` is the final LayerNorm of ``hidden_states[-(k+1)]``,
    the penultimate modes take ``hidden_states[-(k+2)]``; the pooled vector
    always comes from the full tower (``pww_tpu/models/clip.py:81-121``)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor, output: str = "final", skip_layers: int = 0):
        if output not in ("final", "penultimate", "penultimate_and_pooled"):
            raise ValueError(f"unknown output mode {output!r}")
        cfg = self.config
        if not 0 <= skip_layers < cfg.num_layers:
            raise ValueError(f"skip_layers={skip_layers} out of range for "
                             f"{cfg.num_layers}-layer tower")
        tm = self.text_model
        x = tm.embeddings(input_ids)
        layers = tm.encoder.layers
        cut = cfg.num_layers - 1 - skip_layers  # the last layer whose output is kept
        if output == "final":
            for layer in layers[:cut + 1]:
                x = layer(x)
            return layer_norm_f32(tm.final_layer_norm, x)
        for layer in layers[:cut]:
            x = layer(x)
        if output == "penultimate":
            return x
        penultimate = x
        for layer in layers[cut:]:  # the pooled vector takes the full tower
            x = layer(x)
        final = layer_norm_f32(tm.final_layer_norm, x)
        if cfg.projection_dim is None:
            raise ValueError("pooled output requires CLIPTextConfig.projection_dim")
        if cfg.eos_token_id is not None and cfg.eos_token_id != 2:
            eos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
        else:
            eos = torch.argmax(input_ids, dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device), eos]
        return penultimate, self.text_projection(pooled)
