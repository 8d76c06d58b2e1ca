"""CLIP byte-pair-encoding tokenizer (`dg_sct_tpu/ops/bpe.py`): the standard
lower-cased BPE over the public `bpe_simple_vocab_16e6` merge table, of
which the port keeps its own copy under `dg_sct_tpu_torch/assets/`.

The text is cleaned by unescaping HTML twice and stripping it. The JAX
package also runs `ftfy.fix_text` first when `ftfy` imports; the port never
does (the card machine has neither `ftfy` nor `regex`), so the ids agree
wherever `ftfy` would change nothing: plain ASCII class names among them.
"""
from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List

import numpy as np

DEFAULT_BPE_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                                "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77
SOT, EOT = "<|startoftext|>", "<|endoftext|>"


@functools.lru_cache(maxsize=None)
def bytes_to_unicode():
    """Each byte -> a printable unicode character, as GPT-2's BPE maps them."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


class ClipTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges] + [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT: SOT, EOT: EOT}
        self.pat = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
                              r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)

    def bpe(self, token: str) -> str:
        """One pre-token -> its BPE pieces joined by spaces (the last one
        carries "</w>"), merging the lowest-ranked pair first."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", basic_clean(text)).strip().lower()
        ids: List[int] = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids


@functools.lru_cache(maxsize=None)
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """A string or a list of them -> int32 (n, context_length): SOT, the
    text's ids cut to context_length - 2, EOT, then zeros."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    sot, eot = tok.encoder[SOT], tok.encoder[EOT]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, t in enumerate(texts):
        ids = [sot] + tok.encode(t)[: context_length - 2] + [eot]
        out[i, : len(ids)] = ids
    return out
