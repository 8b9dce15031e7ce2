"""CLIP BPE tokenizer (counterpart of ``peft_vit_tpu/data/tokenizer.py``).

The byte-level BPE of OpenAI CLIP over the public merge table
``bpe_simple_vocab_16e6.txt.gz``, which this package reads from the JAX
package's resources by path (``DEFAULT_BPE_PATH``) rather than keeping a
second copy.  ``tokenize``: lowercase, whitespace-collapse,
``<|startoftext|> tokens <|endoftext|>``, pad or truncate to the context
length with the end token kept on truncation (the reference's
evaluation/clip_load.py:484-516).  Pure Python and numpy: the same ids as
the JAX package's tokenizer.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the merge table, read from the JAX package's resources
DEFAULT_BPE_PATH = os.path.join(_REPO, "peft_vit_tpu", "resources",
                                "bpe_simple_vocab_16e6.txt.gz")

# the stdlib ``re`` spelling of CLIP's \p{L} / \p{N} pattern (ASCII letter and
# digit classes; ``_clean`` lowercases first)
_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """The reversible byte -> printable-unicode map (the GPT-2 / CLIP one)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text.strip()).lower()


class ClipTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        # the header line, then the 48,894 merges CLIP uses
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {"<|startoftext|>": "<|startoftext|>",
                                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
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
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in _WORD_RE.findall(_clean(text)):
            tok_b = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok_b).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        data = bytearray(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts, context_length: int = 77) -> np.ndarray:
        """(B, context_length) int32 ids with the start and end tokens."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out


@functools.lru_cache()
def get_tokenizer(bpe_path: str = DEFAULT_BPE_PATH) -> ClipTokenizer:
    return ClipTokenizer(bpe_path)


def tokenize(texts, context_length: int = 77) -> np.ndarray:
    return get_tokenizer().tokenize(texts, context_length)


class HFTokenizer:
    """The HuggingFace tokenizer of the JAX package needs ``transformers``,
    which this package does not use."""

    def __init__(self, name: str = "bert-base-uncased"):
        raise NotImplementedError(
            "HFTokenizer needs transformers and is not ported to peft_vit_tpu_torch "
            "(ROADMAP §1, the rest)")
