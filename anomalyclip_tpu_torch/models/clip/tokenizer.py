"""CLIP byte-level BPE tokenizer, pure Python, standard library ``re`` only.

A copy of anomalyclip_tpu/models/clip/tokenizer.py that needs no ``regex``
package: the ``\\p{L}`` and ``\\p{N}`` classes of the canonical CLIP pattern are
built once from ``unicodedata`` as explicit code-point ranges (every code point
whose general category starts with L, resp. N), so the stdlib pattern matches
exactly what the ``regex`` pattern matches. The BPE merge table is the JAX
package's vendored ``bpe_simple_vocab_16e6.txt.gz``, read by path; reading it
imports nothing of that package. ``CLIP_BPE_PATH`` overrides the path.
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Union

import re
import sys
import unicodedata

import numpy as np

CONTEXT_LENGTH = 77

# the public OpenAI merge table, vendored once in the JAX package
_VOCAB_PATH = (
    Path(__file__).resolve().parents[3]
    / "anomalyclip_tpu" / "models" / "clip" / "bpe_simple_vocab_16e6.txt.gz"
)


def find_bpe_vocab(explicit: Optional[str] = None) -> Path:
    """Locate the BPE merge table; raises FileNotFoundError with guidance if absent."""
    candidates: List[Path] = []
    if explicit:
        candidates.append(Path(explicit))
    env = os.environ.get("CLIP_BPE_PATH")
    if env:
        candidates.append(Path(env))
    candidates.append(_VOCAB_PATH)
    for path in candidates:
        if path.is_file():
            return path
    raise FileNotFoundError(
        "CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz) not found. Set CLIP_BPE_PATH "
        "or restore anomalyclip_tpu/models/clip/bpe_simple_vocab_16e6.txt.gz. "
        f"Searched: {[str(c) for c in candidates]}"
    )


@lru_cache()
def bytes_to_unicode() -> dict:
    """The standard GPT-2/CLIP reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@lru_cache()
def _category_class(major: str) -> str:
    """Regex class body of every code point whose Unicode general category
    starts with ``major`` ("L" letters, "N" numbers): the stdlib spelling of
    ``\\p{L}`` / ``\\p{N}``."""
    parts = []
    start = None
    for cp in range(sys.maxunicode + 2):
        inside = cp <= sys.maxunicode and unicodedata.category(chr(cp))[0] == major
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            lo, hi = re.escape(chr(start)), re.escape(chr(cp - 1))
            parts.append(lo if start == cp - 1 else f"{lo}-{hi}")
            start = None
    return "".join(parts)


def _get_pairs(word: Sequence[str]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """Byte-level BPE with a 49408-token vocabulary (49152 merges-derived + 256 byte
    tokens with ``</w>`` variants + 2 specials)."""

    def __init__(self, bpe_path: Optional[str] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges_raw = gzip.open(find_bpe_vocab(bpe_path)).read().decode("utf-8").split("\n")
        # Standard slice: skip the header line, keep the first 49152-256-2 merges.
        merges_raw = merges_raw[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges_raw]

        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])

        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        letters, numbers = _category_class("L"), _category_class("N")
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
            rf"""[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+""",
            re.IGNORECASE,
        )

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)

        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_default_tokenizer: Optional[ClipTokenizer] = None


def _get_default_tokenizer() -> ClipTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = ClipTokenizer()
    return _default_tokenizer


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
    tokenizer: Optional[ClipTokenizer] = None,
) -> np.ndarray:
    """Tokenize into a fixed ``(len(texts), context_length)`` int32 array with
    SOT/EOT wrapping (reference: clip.py:225-268)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or _get_default_tokenizer()

    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(tokens) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            tokens = tokens[:context_length]
            tokens[-1] = tok.eot_token
        result[i, : len(tokens)] = tokens
    return result
