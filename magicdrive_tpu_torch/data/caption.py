"""Caption templating and tokenization (counterpart of
``data/caption.py``).

Caption = template.format(location=..., description=...), with one null
("") caption per batch for CFG (ref:magicdrive/dataset/utils.py:28-49;
template ref:configs/dataset/Nuscenes.yaml:9). ``load_clip_tokenizer``
gives the CLIP BPE tokenizer from a vocab directory (``bpe.py``) or, with
no directory, ``HashTokenizer``: the CLIP framing (BOS, one id per word,
EOS, EOS padding to 77) with word ids from CRC32, the same in every
process. The JAX package's stand-in hashes words with Python's salted
``hash``, so only the two stand-ins' framing agrees.
"""
from __future__ import annotations

import os
import zlib
from typing import List, Optional, Sequence

import numpy as np

DEFAULT_TEMPLATE = "A driving scene image at {location}. {description}."
MAX_LENGTH = 77
BOS, EOS = 49406, 49407


class HashTokenizer:
    """Deterministic stand-in tokenizer with the CLIP framing."""

    model_max_length = MAX_LENGTH

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), MAX_LENGTH), EOS, np.int32)
        for i, t in enumerate(texts):
            words = t.lower().split()[:MAX_LENGTH - 2]
            ids = [BOS] + [zlib.crc32(w.encode()) % 49000 + 300
                           for w in words] + [EOS]
            out[i, :len(ids)] = ids
        return out


def load_clip_tokenizer(path: Optional[str] = None):
    """The CLIP BPE tokenizer of a directory holding ``vocab.json`` and
    ``merges.txt`` (the SD-v1.5 tokenizer layout); ``None`` gives
    ``HashTokenizer``."""
    if path is None:
        return HashTokenizer()
    from .bpe import CLIPBPETokenizer

    return CLIPBPETokenizer.from_files(
        os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"))


def format_caption(template: str, metas: dict) -> str:
    return template.format(**metas)


def tokenize_captions(metas_list: List[dict], tokenizer,
                      template: str = DEFAULT_TEMPLATE):
    """(input_ids (B, 77), uncond_ids (1, 77))."""
    captions = [format_caption(template, m) for m in metas_list]
    ids = tokenizer(captions + [""])
    return ids[:-1], ids[-1:]
