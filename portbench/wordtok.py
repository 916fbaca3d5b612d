"""The benchmark's tokenizer, handed to the program and to the reference alike.

No CLIP vocabulary is on disk, so the benchmark brings a word-level
tokenizer with CLIP's interface and ids: ``<|startoftext|>`` 49406,
``<|endoftext|>`` 49407, 77 positions, padding with the EOS id (SDXL's
second tokenizer pads with 0). Each lowercase word or punctuation mark is
one id, ``1000 + crc32(word) mod 48000``, stable across processes. The
prompts use one word list, so the id of a region's label occurs in its
prompt as the label's words do.
"""
from __future__ import annotations

import re
import zlib
from typing import Dict, List

BOS, EOS, MAX_LENGTH = 49406, 49407, 77


class WordTokenizer:
    bos_token_id = BOS
    eos_token_id = EOS
    model_max_length = MAX_LENGTH

    def __init__(self, pad_token_id: int = EOS):
        self.pad_token_id = pad_token_id

    @staticmethod
    def word_id(word: str) -> int:
        return 1000 + zlib.crc32(word.encode()) % 48000

    def tokenize(self, text: str) -> List[int]:
        return [self.word_id(w) for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())]

    def __call__(self, text: str, max_length: int = None, truncation: bool = False,
                 padding=False, **_) -> Dict[str, List[int]]:
        max_length = max_length or self.model_max_length
        ids = self.tokenize(text)
        if truncation:
            ids = ids[:max_length - 2]
        ids = [BOS] + ids + [EOS]
        if padding and len(ids) < max_length:
            ids += [self.pad_token_id] * (max_length - len(ids))
        return {"input_ids": ids}


def padded_ids(tok: WordTokenizer, text: str) -> List[int]:
    return tok(text, max_length=MAX_LENGTH, truncation=True, padding="max_length")["input_ids"]
