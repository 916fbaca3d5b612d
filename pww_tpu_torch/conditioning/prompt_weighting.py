"""A1111-style prompt attention weighting: ``(word:1.2)``, ``((word))``,
``[word]``.

Port of :mod:`pww_tpu.conditioning.prompt_weighting` (the parser and the
tokenizer pass are pure Python, copied here so that the port imports
nothing of the JAX package; ``tests/test_torch_prompts.py`` holds the copy
equal to the original). Opt-in through ``generate(prompt_weighting=True)``:

- ``(text)`` multiplies the enclosed tokens' emphasis by 1.1, nesting
  compounds (``((text))`` → 1.21); ``[text]`` divides by 1.1;
  ``(text:1.5)`` sets an explicit multiplier; ``\\(`` escapes a literal
  parenthesis.
- The multipliers scale the CLIP **output** hidden states of the affected
  tokens, then the whole sequence is rescaled so that its mean matches the
  unweighted mean (A1111's normalization).

The weighted token-id sequence is also what region labels are matched
against, so ``(cat:1.4)`` still matches a ``"cat,0.5"`` color context.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

_ATTENTION = re.compile(
    r"\\\(|\\\)|\\\[|\\\]|\\\\|\\|\(|\[|:\s*([+-]?[.\d]+)\s*\)|\)|\]"
    r"|[^\\()\[\]:]+|:"
)

_ROUND_MULT = 1.1
_SQUARE_MULT = 1.0 / 1.1


def parse_prompt_attention(text: str) -> List[List]:
    """``"a (big:1.5) cat"`` → ``[["a ", 1.0], ["big", 1.5], [" cat", 1.0]]``.

    Stack-based parser with the A1111 rules; unbalanced open brackets apply
    their default multiplier to the rest of the prompt, and unmatched
    closing ones stay literal text.
    """
    res: List[List] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def multiply_range(start: int, mult: float) -> None:
        for item in res[start:]:
            item[1] *= mult

    for m in _ATTENTION.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None and round_stack:
            multiply_range(round_stack.pop(), float(weight))
        elif tok == ")" and round_stack:
            multiply_range(round_stack.pop(), _ROUND_MULT)
        elif tok == "]" and square_stack:
            multiply_range(square_stack.pop(), _SQUARE_MULT)
        else:
            res.append([tok, 1.0])
    for pos in round_stack:
        multiply_range(pos, _ROUND_MULT)
    for pos in square_stack:
        multiply_range(pos, _SQUARE_MULT)
    if not res:
        return [["", 1.0]]
    merged: List[List] = [res[0]]  # adjacent fragments of equal weight
    for frag, w in res[1:]:
        if w == merged[-1][1]:
            merged[-1][0] += frag
        else:
            merged.append([frag, w])
    return merged


def weighted_prompt_ids(tokenizer, text: str) -> Tuple[List[int], np.ndarray]:
    """Tokenize a weighted prompt → (padded input_ids, per-token weights).

    Fragment tokens are concatenated (specials stripped per fragment, and
    trailing pads where the pad id is not the EOS id: an OpenCLIP tower pads
    with id 0, which is also a real token), truncated to the model length,
    wrapped in BOS/EOS and padded; BOS/EOS/pad positions carry weight 1.0.
    """
    max_len = tokenizer.model_max_length
    body_ids: List[int] = []
    body_w: List[float] = []
    for frag, w in parse_prompt_attention(text):
        ids = tokenizer(frag)["input_ids"]
        ids = [i for i in ids if i not in (tokenizer.bos_token_id, tokenizer.eos_token_id)]
        pad = getattr(tokenizer, "pad_token_id", None)
        if pad is not None and pad != tokenizer.eos_token_id:
            while ids and ids[-1] == pad:
                ids.pop()
        body_ids.extend(ids)
        body_w.extend([w] * len(ids))
    body_ids = body_ids[: max_len - 2]
    body_w = body_w[: max_len - 2]

    pad_id = getattr(tokenizer, "pad_token_id", tokenizer.eos_token_id)
    ids = [tokenizer.bos_token_id] + body_ids + [tokenizer.eos_token_id]
    ids += [pad_id] * (max_len - len(ids))
    weights = [1.0] + body_w + [1.0]
    weights += [1.0] * (max_len - len(weights))
    return ids, np.asarray(weights, np.float32)


def apply_token_weights(states: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """Scale one prompt's hidden states (T, D) by per-token weights, then
    restore the pre-scaling mean (A1111 normalization); f32 inside."""
    x = states.float()
    orig_mean = x.mean()
    x = x * torch.from_numpy(np.asarray(weights, np.float32)).to(x.device)[:, None]
    x = x * (orig_mean / x.mean())
    return x.to(states.dtype)
