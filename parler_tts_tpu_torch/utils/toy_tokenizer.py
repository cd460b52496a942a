"""Dependency-free stand-in for the T5 tokenizer, for the smoke run and the
tests (not a production component).

Whitespace-separated words are hashed (CRC-32, stable across processes)
into ids ``[3, vocab_size)``; id 1 pads.  The call shape is HF's:
``tok(texts, padding=True, return_tensors="np")`` returns an object with
``input_ids`` and ``attention_mask``, right-padded to the longest text.
"""

from __future__ import annotations

import types
import zlib

import numpy as np

PAD_ID = 1
FIRST_WORD_ID = 3


class ToyTokenizer:
    def __init__(self, vocab_size: int = 100):
        if vocab_size <= FIRST_WORD_ID:
            raise ValueError(f"vocab_size must exceed {FIRST_WORD_ID}, got {vocab_size}")
        self.vocab_size = vocab_size
        self.pad_token_id = PAD_ID

    def encode(self, text: str) -> list[int]:
        span = self.vocab_size - FIRST_WORD_ID
        return [FIRST_WORD_ID + zlib.crc32(w.encode()) % span for w in text.split()]

    def __call__(self, texts, padding: bool = True, return_tensors: str = "np"):
        if return_tensors != "np" or not padding:
            raise ValueError("ToyTokenizer returns padded numpy arrays only")
        texts = [texts] if isinstance(texts, str) else list(texts)
        ids = [self.encode(t) for t in texts]
        width = max((len(x) for x in ids), default=0)
        input_ids = np.full((len(ids), width), PAD_ID, dtype=np.int64)
        attention_mask = np.zeros((len(ids), width), dtype=np.int64)
        for row, x in enumerate(ids):
            input_ids[row, : len(x)] = x
            attention_mask[row, : len(x)] = 1
        return types.SimpleNamespace(input_ids=input_ids, attention_mask=attention_mask)
