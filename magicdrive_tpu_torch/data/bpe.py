"""CLIP byte-pair-encoding tokenizer (counterpart of ``data/bpe.py``).

A self-contained restatement of the CLIP text tokenizer used by the
reference through HuggingFace transformers (ref:magicdrive/dataset/utils.py:28-49
tokenizes captions with the SD-v1.5 CLIPTokenizer): byte-level BPE with
``</w>`` end-of-word markers, the CLIP pre-tokenization regex, lowercase +
whitespace normalization, and ``<|startoftext|> ... <|endoftext|>`` framing
padded with ``<|endoftext|>`` to 77 tokens.

Loads the standard ``vocab.json`` + ``merges.txt`` files (the SD-v1.5
tokenizer directory layout). Held token for token to the JAX package's
tokenizer in ``tests/test_torch_port_data.py``.
"""
from __future__ import annotations

import functools
import json
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np
import regex as re

MAX_LENGTH = 77
BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte->unicode table (avoids control chars)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class CLIPBPETokenizer:
    """Callable mapping a list of strings to (B, 77) int32 token ids."""

    model_max_length = MAX_LENGTH

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.unk_id = self.eos_id
        self._cache: Dict[str, str] = {BOS_TOKEN: BOS_TOKEN, EOS_TOKEN: EOS_TOKEN}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "CLIPBPETokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1: 49152 - 256 - 2 + 1]
        merges = [tuple(l.split()) for l in lines]
        return cls(vocab, merges)

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
        out = " ".join(word)
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = unicodedata.normalize("NFC", text)
        text = re.sub(r"\s+", " ", text).strip().lower()
        toks: List[str] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            toks.extend(self._bpe(token).split(" "))
        return toks

    def encode(self, text: str) -> List[int]:
        ids = [self.encoder.get(t, self.unk_id) for t in self.tokenize(text)]
        ids = ids[: MAX_LENGTH - 2]
        return [self.bos_id] + ids + [self.eos_id]

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), MAX_LENGTH), self.eos_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out
