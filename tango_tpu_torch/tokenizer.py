"""Deterministic word-hash tokenizer.

The port loads no tokenizer files and does not use `transformers`. This
tokenizer has the call signature of the HF tokenizers the JAX package calls
(tango_tpu/pipeline.py:235-254): it splits on whitespace, maps each word by
CRC-32 to an id above the special ids and below vocab_size, truncates, and
pads to max_length. Its special ids are parameters: FLAN-T5's by default
(pad 0, EOS 1, no BOS), and RoBERTa's for CLAP's text tower through
`roberta_word_hash` (BOS `<s>` 0 first, pad 1, EOS `</s>` 2), whose position
ids count the non-pad tokens and whose pooler reads the first.
"""

from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1


class WordHashTokenizer:
    def __init__(self, vocab_size: int = 32128, pad_id: int = PAD_ID, eos_id: int = EOS_ID,
                 bos_id: Optional[int] = None):
        specials = [i for i in (pad_id, eos_id, bos_id) if i is not None]
        self.first_word_id = max(specials) + 1
        if vocab_size <= self.first_word_id:
            raise ValueError("vocab_size must leave room for the special ids and words")
        self.vocab_size = vocab_size
        self.pad_id, self.eos_id, self.bos_id = pad_id, eos_id, bos_id

    def encode(self, text: str) -> list[int]:
        first = self.first_word_id
        return [zlib.crc32(w.encode()) % (self.vocab_size - first) + first for w in text.split()]

    def __call__(self, texts: Sequence[str], max_length: int = 128, padding="max_length",
                 truncation: bool = True, return_tensors="np"):
        bos = [] if self.bos_id is None else [self.bos_id]
        room = max_length - 1 - len(bos)
        ids = np.full((len(texts), max_length), self.pad_id, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = self.encode(t)
            if truncation:
                toks = toks[:room]
            elif len(toks) > room:
                raise ValueError(f"{len(toks) + 1 + len(bos)} tokens exceed max_length "
                                 f"{max_length}")
            toks = bos + toks + [self.eos_id]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def roberta_word_hash(vocab_size: int = 50265) -> WordHashTokenizer:
    """WordHashTokenizer with RoBERTa's special ids: <s> 0, pad 1, </s> 2."""
    return WordHashTokenizer(vocab_size, pad_id=1, eos_id=2, bos_id=0)
