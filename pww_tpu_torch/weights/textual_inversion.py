"""Textual-inversion embeddings in the text tower.

Port of :mod:`pww_tpu.weights.textual_inversion` (the reference's TI
notebook, ``README.md:301-307``): read a learned embedding, register its
placeholder with the tokenizer, grow the CLIP token-embedding table, write
the vectors at the placeholder's ids, then run paint-with-words with the
placeholder in the prompt and in a region label.

``.bin``/``.pt`` files load through ``torch.load(weights_only=True)``: the
port unpickles no arbitrary objects, and an A1111 file holds only dicts,
strings, ints and tensors. ``.safetensors`` files load through
:mod:`.safetensors_io`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import safetensors_io

TOKEN_EMBEDDING = "text_model.embeddings.token_embedding.weight"


def read_learned_embedding(path: str) -> Dict[str, torch.Tensor]:
    """{token: vectors} from a diffusers ``{token: vec}`` file or an A1111
    one (``string_to_param["*"]`` under its ``name``)."""
    if path.endswith(".safetensors"):
        raw = safetensors_io.load_file(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    if "string_to_param" in raw:  # A1111
        return {raw.get("name", "<embedding>"):
                torch.as_tensor(raw["string_to_param"]["*"]).detach()}
    return {k: torch.as_tensor(v).detach().float() for k, v in raw.items()}


def load_learned_embed_in_clip(path: str, clip_state: Dict[str, torch.Tensor], tokenizer,
                               token: Optional[str] = None
                               ) -> Tuple[Dict[str, torch.Tensor], str]:
    """(the CLIP state dict with the embedding written in, the placeholder
    string). A multi-vector embedding registers ``token``, ``token_1``, …,
    and the placeholder string names them all. Each vector goes to its
    token's id, growing the table where the id lies past its end, in the
    table's device and type; re-applying an embedding overwrites its rows in
    place (``pww_tpu/weights/textual_inversion.py:45-97``)."""
    embeds = read_learned_embedding(path)
    trained_token = next(iter(embeds))
    vecs = embeds[trained_token]
    if vecs.dim() == 1:
        vecs = vecs[None]
    token = token or trained_token
    table = clip_state[TOKEN_EMBEDDING]
    if vecs.shape[-1] != table.shape[-1]:
        raise ValueError(f"embedding dim {vecs.shape[-1]} != CLIP hidden {table.shape[-1]}")
    names = [token] + [f"{token}_{i}" for i in range(1, len(vecs))]
    ids = []
    for name in names:
        tokenizer.add_tokens(name)
        ids.append(int(tokenizer.convert_tokens_to_ids(name)))
    new_size = max(table.shape[0], max(ids) + 1)
    new_table = torch.cat([table, table.new_zeros((new_size - table.shape[0],
                                                   table.shape[-1]))])
    new_table[torch.tensor(ids, device=table.device)] = vecs.to(table)
    return {**clip_state, TOKEN_EMBEDDING: new_table}, " ".join(names)


def apply_textual_inversion(pipeline, path: str, token: Optional[str] = None) -> str:
    """Write an embedding into a :class:`~..pipeline.pipeline.PwwPipeline`'s
    (first) text tower and tokenizer in place; returns the placeholder
    string. ``config.clip.vocab_size`` follows the table, and the encode
    caches are dropped."""
    embedding = pipeline.clip.text_model.embeddings.token_embedding
    state, placeholder = load_learned_embed_in_clip(
        path, {TOKEN_EMBEDDING: embedding.weight.detach()}, pipeline.tokenizer, token)
    set_token_table(pipeline, state[TOKEN_EMBEDDING])
    return placeholder


def set_token_table(pipeline, table: torch.Tensor) -> None:
    """Install ``table`` as the (first) text tower's token table, frozen;
    ``config.clip.vocab_size`` follows it, and the encode caches are dropped."""
    embedding = pipeline.clip.text_model.embeddings.token_embedding
    embedding.weight = torch.nn.Parameter(table, requires_grad=False)
    embedding.num_embeddings = table.shape[0]
    clip_cfg = dataclasses.replace(pipeline.config.clip, vocab_size=table.shape[0])
    pipeline.config = dataclasses.replace(pipeline.config, clip=clip_cfg)
    pipeline.clip.config = clip_cfg
    pipeline.invalidate_encode_caches()
