"""Pure-Python CLIP BPE tokenizer.

The reference relies on ``transformers.CLIPTokenizer`` pulled from the HF hub
(reference `paint_with_words/paint_with_words.py:170`). This implementation is
hub-independent: point it at any local ``vocab.json`` + ``merges.txt`` pair
(the standard CLIP tokenizer assets shipped inside every SD checkpoint dir).
For test environments with no checkpoint on disk, :func:`toy_tokenizer` builds
a deterministic synthetic vocabulary with identical API and padding behavior.

Algorithm: byte-level BPE with ``</w>`` word-end markers, lowercasing, and the
CLIP text regex — functionally equivalent to openai/CLIP's SimpleTokenizer.
"""
from __future__ import annotations

import functools
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

MAX_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte→unicode map (GPT-2/CLIP convention)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


try:  # transformers.CLIPTokenizer prefers ftfy text fixing when available
    import ftfy as _ftfy
except ImportError:  # pragma: no cover - ftfy absent in this env
    _ftfy = None


def _is_cjk_ideograph(cp: int) -> bool:
    """CJK unified-ideograph ranges (BasicTokenizer._is_chinese_char)."""
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _clean_text(text: str) -> str:
    """Normalize like ``transformers.CLIPTokenizer`` does.

    With ftfy installed transformers runs ``whitespace_clean(fix_text(t))``;
    without it, it falls back to ``BasicTokenizer`` — control-char removal,
    CJK-ideograph spacing, NFC normalization, lowercasing. Mirroring the
    same two paths keeps token-id parity with whatever the host env does.
    """
    import unicodedata

    if _ftfy is not None:
        return _whitespace_clean(_ftfy.fix_text(text)).lower()
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue
        if _is_cjk_ideograph(cp):
            out.extend((" ", ch, " "))
        elif cat == "Zs" or ch in ("\t", "\n", "\r"):
            out.append(" ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return _whitespace_clean(text).lower()


# The CLIP text-splitting pattern needs unicode \p{L}/\p{N} classes for
# non-ASCII parity with transformers.CLIPTokenizer; the stdlib `re` lacks
# them, so prefer the `regex` module and fall back to an ASCII approximation.
try:
    import regex as _regex

    _PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex is available in this env
    _PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
        re.IGNORECASE,
    )


class CLIPTokenizer:
    """Encode/decode with CLIP byte-level BPE.

    Args:
      vocab: token string → id.
      merges: ordered list of merge pairs.
    """

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_token_id = self.encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = self.encoder.get("<|endoftext|>", 49407)
        self.pad_token_id = self.eos_token_id  # OpenCLIP towers use 0 ("!")
        self.model_max_length = MAX_LENGTH
        self._cache: Dict[str, str] = {}
        self.added_tokens: Dict[str, int] = {}
        # lowercase aliases of uppercase added tokens → same id (ids are
        # allocated from len(added_tokens), so aliases live separately)
        self.added_aliases: Dict[str, int] = {}

    def add_tokens(self, token: str) -> int:
        """Register an atomic extra token (textual-inversion placeholder).

        Mirrors ``tokenizer.add_tokens`` in the reference's TI notebook
        (reference `contents/notebooks/paint_with_words_textual_inversion.ipynb`).
        Returns the new vocabulary size.
        """
        if token not in self.added_tokens:
            new_id = len(self.encoder) + len(self.added_tokens)
            self.added_tokens[token] = new_id
            self.decoder[new_id] = token
            # CLIP lowercases plain text, so prompts typed in lowercase must
            # still hit an uppercase placeholder: alias the lowered form to
            # the SAME id (not a new row; tokenize() matches raw text).
            low = token.lower()
            if low != token:
                self.added_aliases[low] = new_id
        return len(self.encoder) + len(self.added_tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.added_tokens:
            return self.added_tokens[token]
        if token in self.added_aliases:
            return self.added_aliases[token]
        return self.encoder[token]

    # -- loading -------------------------------------------------------------
    @classmethod
    def from_dir(cls, path: str) -> "CLIPTokenizer":
        """Load from a diffusers-layout dir (``tokenizer/vocab.json`` etc.).

        Honors ``tokenizer_config.json``'s ``pad_token_id`` when present
        (SDXL's tokenizer_2 pads with "!" = id 0, not EOS).
        """
        for sub in ("", "tokenizer"):
            base = os.path.join(path, sub)
            vj, mt = os.path.join(base, "vocab.json"), os.path.join(base, "merges.txt")
            if os.path.exists(vj) and os.path.exists(mt):
                with open(vj, encoding="utf-8") as f:
                    vocab = json.load(f)
                with open(mt, encoding="utf-8") as f:
                    lines = f.read().split("\n")
                merges = [
                    tuple(l.split()) for l in lines
                    if l and not l.startswith("#version") and len(l.split()) == 2
                ]
                tok = cls(vocab, merges)
                tc = os.path.join(base, "tokenizer_config.json")
                if os.path.exists(tc):
                    with open(tc, encoding="utf-8") as f:
                        conf = json.load(f)
                    if isinstance(conf.get("pad_token_id"), int):
                        tok.pad_token_id = conf["pad_token_id"]
                return tok
        raise FileNotFoundError(f"no vocab.json/merges.txt under {path!r}")

    @classmethod
    def from_bpe_gz(cls, path: str) -> "CLIPTokenizer":
        """Load from openai/CLIP's ``bpe_simple_vocab_16e6.txt.gz``."""
        with gzip.open(path, "rt", encoding="utf-8") as f:
            merges_lines = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges_lines]
        vocab_list = list(bytes_to_unicode().values())
        vocab_list = vocab_list + [v + "</w>" for v in vocab_list]
        for m in merges:
            vocab_list.append("".join(m))
        vocab_list.extend(["<|startoftext|>", "<|endoftext|>"])
        return cls({v: i for i, v in enumerate(vocab_list)}, merges)

    # -- BPE -----------------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[int]:
        """Text → raw BPE ids (no special tokens).

        Added tokens (TI placeholders) are split out of the RAW text before
        CLIP's lowercasing — transformers extracts added tokens verbatim, so
        an uppercase placeholder like ``<MyStyle>`` or ``EasyNegative`` must
        match as written — and alternatives are tried longest-first so a
        multi-vector name ``<cat>_1`` is not eaten by its ``<cat>`` prefix
        (Python ``re`` alternation is leftmost-first, not longest-match).
        """
        lookup = {**self.added_aliases, **self.added_tokens}
        if lookup:
            alts = sorted(lookup, key=len, reverse=True)
            pattern = "(" + "|".join(re.escape(t) for t in alts) + ")"
            parts = re.split(pattern, text)
        else:
            parts = [text]
        ids: List[int] = []
        for part in parts:
            if part in lookup:
                ids.append(lookup[part])
                continue
            for tok in _PAT.findall(_clean_text(part)):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                for bpe_tok in self.bpe(tok).split(" "):
                    ids.append(self.encoder[bpe_tok])
        return ids

    def __call__(
        self,
        text: str,
        max_length: Optional[int] = None,
        truncation: bool = True,
        padding: bool = False,
    ) -> Dict[str, List[int]]:
        """HF-compatible call: BOS + ids + EOS, optional pad-to-max with EOS.

        Matches ``transformers.CLIPTokenizer`` so the reference's token-match
        semantics (reference `paint_with_words.py:222-227, 259-268`) carry over.
        """
        max_length = max_length or self.model_max_length
        ids = self.tokenize(text)
        if truncation:
            ids = ids[: max_length - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if padding and len(ids) < max_length:
            # CLIP pads with eos; SDXL's tokenizer_2 sets pad_token_id = 0
            pad = getattr(self, "pad_token_id", self.eos_token_id)
            ids = ids + [pad] * (max_length - len(ids))
        return {"input_ids": ids}

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids)
        raw = bytearray(self.byte_decoder.get(c, 32) for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


def synthetic_tokenizer(vocab_size: int = 49408) -> CLIPTokenizer:
    """Full-size tokenizer running the REAL byte-level BPE machinery over a
    synthetic vocabulary (for benchmarks/tests where no checkpoint assets
    exist): 256 byte tokens, their ``</w>`` forms, a deterministic ladder of
    ASCII-pair merges, filler ids, and the CLIP specials at the canonical
    positions (49406/49407). Ids do NOT match the real CLIP vocabulary —
    never use with a real checkpoint; it exists so the measured serving/bench
    path exercises ``CLIPTokenizer.bpe`` + the encode cache rather than the
    hash-based toy shortcut."""
    import itertools

    chars = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for c in chars:
        vocab[c] = len(vocab)
    for c in chars:
        vocab[c + "</w>"] = len(vocab)
    merges = []
    letters = "abcdefghijklmnopqrstuvwxyz"
    for a, b in itertools.product(letters, repeat=2):
        if len(vocab) >= vocab_size - 2:
            break
        merges.append((a, b + "</w>"))
        vocab[a + b + "</w>"] = len(vocab)
        if len(vocab) >= vocab_size - 2:
            break
        merges.append((a, b))
        vocab[a + b] = len(vocab)
    i = 0
    while len(vocab) < vocab_size - 2:
        vocab[f"<fill{i}>"] = len(vocab)
        i += 1
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return CLIPTokenizer(vocab, merges)


def toy_tokenizer(vocab_size: int = 1000) -> CLIPTokenizer:
    """Deterministic synthetic tokenizer for tests (no vocab files needed).

    Every lowercase ASCII word hashes to a stable id in [3, vocab_size);
    multi-character determinism mirrors real BPE's multi-token labels by
    splitting words longer than 6 chars into two tokens.
    """

    class _Toy(CLIPTokenizer):
        def __init__(self, n):
            self.n = n
            self.bos_token_id = 0
            self.eos_token_id = 1
            self.model_max_length = MAX_LENGTH
            self.added_tokens = {}
            self.added_aliases = {}
            self.encoder = {}  # base vocab is implicit (hash-based)

        def add_tokens(self, token: str) -> int:
            if token not in self.added_tokens:
                self.added_tokens[token] = self.n + len(self.added_tokens)
                if token.lower() != token:
                    self.added_aliases[token.lower()] = (
                        self.added_tokens[token]
                    )
            return self.n + len(self.added_tokens)

        def _word_ids(self, w: str) -> List[int]:
            def h(s):
                v = 5381
                for ch in s:
                    v = (v * 33 + ord(ch)) % (self.n - 3)
                return v + 3

            if len(w) > 6:
                return [h(w[:4]), h(w[4:])]
            return [h(w)]

        def tokenize(self, text):
            # split added tokens from the RAW text (longest alternative
            # first), lowercase only the plain segments — same contract as
            # the real tokenizer above
            text = _whitespace_clean(text)
            lookup = {**self.added_aliases, **self.added_tokens}
            if lookup:
                alts = sorted(lookup, key=len, reverse=True)
                pattern = "(" + "|".join(re.escape(t) for t in alts) + ")"
                parts = re.split(pattern, text)
            else:
                parts = [text]
            ids = []
            for part in parts:
                if part in lookup:
                    ids.append(lookup[part])
                    continue
                for w in re.findall(r"[a-z0-9]+|[^\sa-z0-9]", part.lower()):
                    ids.extend(self._word_ids(w))
            return ids

        def decode(self, ids):  # pragma: no cover
            return " ".join(str(i) for i in ids)

    return _Toy(vocab_size)


def save_tokenizer_assets(tokenizer, tdir: str) -> bool:
    """Write ``vocab.json`` + ``merges.txt`` (+ ``tokenizer_config.json``
    with the pad id) for a real-BPE tokenizer; returns False for toy/hashed
    tokenizers with no serializable vocab. Shared by
    ``PwwPipeline.save_pretrained`` and the LDM converter CLI."""
    enc = getattr(tokenizer, "encoder", None)
    ranks = getattr(tokenizer, "bpe_ranks", None)
    if not enc or ranks is None:
        return False
    os.makedirs(tdir, exist_ok=True)
    with open(os.path.join(tdir, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(enc, f)
    with open(os.path.join(tdir, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        f.writelines(
            f"{a} {b}\n"
            for (a, b), _ in sorted(ranks.items(), key=lambda kv: kv[1])
        )
    with open(os.path.join(tdir, "tokenizer_config.json"), "w") as f:
        json.dump({"pad_token_id": getattr(
            tokenizer, "pad_token_id", tokenizer.eos_token_id
        )}, f)
    return True


def pad_to_length(ids: List[int], length: int, pad_id: int) -> List[int]:
    return (ids + [pad_id] * length)[:length]
