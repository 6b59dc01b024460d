"""Deterministic word-hash tokenizer.

The port loads no tokenizer files: there is no snapshot loading yet and no
`transformers`. This tokenizer has the call signature of the HF tokenizers the
JAX pipeline calls (tango_tpu/pipeline.py:235-254): it splits on whitespace,
maps each word to an id in [2, vocab_size) by CRC-32, truncates to
max_length - 1 words, appends EOS (id 1) and pads with 0 to max_length.
"""

from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1


class WordHashTokenizer:
    def __init__(self, vocab_size: int = 32128):
        if vocab_size < 3:
            raise ValueError("vocab_size must leave room for PAD, EOS and words")
        self.vocab_size = vocab_size

    def encode(self, text: str) -> list[int]:
        return [zlib.crc32(w.encode()) % (self.vocab_size - 2) + 2 for w in text.split()]

    def __call__(self, texts: Sequence[str], max_length: int = 128, padding="max_length",
                 truncation: bool = True, return_tensors="np"):
        ids = np.full((len(texts), max_length), PAD_ID, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = self.encode(t)
            if truncation:
                toks = toks[: max_length - 1]
            elif len(toks) + 1 > max_length:
                raise ValueError(f"{len(toks) + 1} tokens exceed max_length {max_length}")
            toks = toks + [EOS_ID]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
