"""CLIP byte-pair-encoding tokenizer (``laff_tpu.models.clip.tokenizer``;
stdlib and numpy only).

The standard CLIP BPE scheme: lower-cased, whitespace-cleaned text; the
byte-level unicode mapping; the merge table of the public
``bpe_simple_vocab_16e6`` data file (the port keeps its own copy under
``assets/``); ``<|startoftext|>`` / ``<|endoftext|>`` wrapping; a 77-token
context with truncation that keeps ``<|endoftext|>`` last. The token
pattern uses the ``regex`` package's unicode classes where it is installed
and an ASCII pattern otherwise, as ``laff_tpu`` does. The ``_bpe`` cache
and the module's ``_tokenizer`` are its only process state.

Reference behavior: ``model/clip/simple_tokenizer.py`` and
``clip.tokenize`` (``model/clip/clip.py:162-192``).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Tuple

import numpy as np

_BPE_PATH = os.path.join(
    os.path.dirname(__file__), "assets", "bpe_simple_vocab_16e6.txt.gz"
)

CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode mapping (standard GPT-2/CLIP
    construction: keep printable latin bytes, remap the rest upward)."""
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


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


try:
    import regex as _re_mod

    _TOKEN_PATTERN = _re_mod.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
        _re_mod.IGNORECASE,
    )
except ImportError:  # ascii-only fallback
    _TOKEN_PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

_WHITESPACE_RE = re.compile(r"\s+")


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = _WHITESPACE_RE.sub(" ", text.strip())
    return text.lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = _BPE_PATH) -> None:
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as fh:
            merges = fh.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _TOKEN_PATTERN.findall(_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: List[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_tokenizer = None


def get_tokenizer() -> ClipTokenizer:
    global _tokenizer
    if _tokenizer is None:
        _tokenizer = ClipTokenizer()
    return _tokenizer


def tokenize(
    texts, context_length: int = CONTEXT_LENGTH, truncate: bool = True
) -> np.ndarray:
    """(B, 77) int32 token matrix: <sot> tokens <eot>, zero-padded, long
    captions truncated with <eot> forced at the end (reference
    ``clip.py:162-192`` semantics)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"input too long for context {context_length}")
            ids = ids[:context_length]
            ids[-1] = tok.eot
        out[i, : len(ids)] = ids
    return out
