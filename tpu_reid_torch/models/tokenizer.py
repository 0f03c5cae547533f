"""CLIP byte-level BPE tokenizer — pure-Python, no external clip package.

Reimplements the published CLIP tokenization scheme (the reference consumes
it via the `clip` pip package, e.g. zero_shot_learning.py:44,
coop.py:88-93): GPT-2-style byte-to-unicode mapping, lowercased text, BPE
merges with a `</w>` end-of-word marker, and the special
<|startoftext|>/<|endoftext|> tokens. The merges table is loaded from the
standard `bpe_simple_vocab_16e6.txt.gz` file (path supplied by the caller;
we ship no vocab data). Vocab layout matches CLIP exactly:

    [0, 256)       byte symbols
    [256, 512)     byte symbols + '</w>'
    [512, 512+M)   merge results (M = 49152 - 512 - 2 for the full file)
    last two       <|startoftext|>, <|endoftext|>

EOT has the largest id, which is what makes the `argmax(tokens)` EOT-pooling
of the text encoder work (reference: text_encoder.py:23).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Sequence

import numpy as np

try:  # ftfy is optional; CLIP applies it before html unescape when present
    import ftfy  # type: ignore

    _fix_text = ftfy.fix_text
except ImportError:  # pragma: no cover
    def _fix_text(s: str) -> str:
        return s

import regex as re

_TOKEN_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)

CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """GPT-2 byte→unicode table: printable bytes map to themselves, the rest
    to 256+ codepoints, so every byte string has a lossless char form."""
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


def _get_pairs(word: Sequence[str]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def _basic_clean(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """BPE tokenizer over a merges file.

    `bpe_path` points at `bpe_simple_vocab_16e6.txt.gz` (or an uncompressed
    copy, or any file in the same format for testing). `n_merges` limits how
    many merge rules are consumed — the full CLIP tokenizer uses
    49152 - 256*2 - 2 = 48894.
    """

    def __init__(self, bpe_path: str, n_merges: int | None = None):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"BPE merges file not found: {bpe_path}. Download "
                "bpe_simple_vocab_16e6.txt.gz (shipped with OpenAI CLIP) and "
                "point --bpe_path at it."
            )
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        if n_merges is None:
            n_merges = 49152 - 256 - 256 - 2
        merges = [
            tuple(line.split()) for line in lines[1 : 1 + n_merges] if line.strip()
        ]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
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
                if i < len(word) - 1 and word[i + 1] == second:
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
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in re.findall(_TOKEN_PATTERN, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(
        self,
        texts: str | Sequence[str],
        context_length: int = CONTEXT_LENGTH,
        truncate: bool = False,
    ) -> np.ndarray:
        """(N, context_length) int32 token matrix: SOT + tokens + EOT + pad,
        matching `clip.tokenize` semantics (raises on overflow unless
        `truncate`, in which case the last slot stays EOT)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length "
                        f"{context_length}"
                    )
                toks = toks[:context_length]
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


def write_test_merges(path: str, merges: Sequence[tuple]) -> None:
    """Write a merges file in the standard format (for unit tests)."""
    lines = ["#version: test"] + [" ".join(m) for m in merges]
    data = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt", encoding="utf-8") as f:
            f.write(data)
    else:
        with open(path, "w", encoding="utf-8") as f:
            f.write(data)
