"""Byte-level tokenizer (counterpart of ``fairness_llm_tpu/models/tokenizer.py``).

``encode_batch`` produces **left-padded** fixed-shape ``[B, S]`` int32 arrays:
left padding keeps the KV write index uniform across the batch. The HF
tokenizer adapter is not ported yet; ``tokenizer_for`` serves the byte
tokenizer, which is what randomly initialised models use.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class TokenBatch:
    """Left-padded prompt batch ready for prefill."""

    tokens: np.ndarray  # [B, S] int32
    valid: np.ndarray  # [B, S] bool (False on left pads)
    lengths: np.ndarray  # [B] int32 real token counts


def _left_pad(rows: Sequence[List[int]], pad_id: int, max_len: Optional[int] = None) -> TokenBatch:
    n = len(rows)
    s = max_len or max((len(r) for r in rows), default=1)
    s = max(s, 1)
    tokens = np.full((n, s), pad_id, dtype=np.int32)
    valid = np.zeros((n, s), dtype=bool)
    lengths = np.zeros((n,), dtype=np.int32)
    for i, row in enumerate(rows):
        row = row[-s:] if len(row) > s else row  # truncate from the left, keep recency
        if row:
            tokens[i, s - len(row):] = row
            valid[i, s - len(row):] = True
        lengths[i] = len(row)
    return TokenBatch(tokens=tokens, valid=valid, lengths=lengths)


class ByteTokenizer:
    """UTF-8 bytes -> ids with reserved specials.

    Layout: 0=pad, 1=eos, 2=bos, bytes b -> 3+b. Total 259 ids; any model with
    vocab_size >= 259 can host it.
    """

    PAD_ID = 0
    EOS_ID = 1
    BOS_ID = 2
    OFFSET = 3

    def __init__(self, vocab_size: int = 512):
        if vocab_size < self.OFFSET + 256:
            raise ValueError(f"vocab_size {vocab_size} < {self.OFFSET + 256}")
        self.vocab_size = vocab_size
        self.pad_id = self.PAD_ID
        self.eos_id = self.EOS_ID
        self.bos_id = self.BOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [self.OFFSET + b for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(
            i - self.OFFSET for i in ids if self.OFFSET <= i < self.OFFSET + 256
        )
        return data.decode("utf-8", errors="replace")

    def encode_batch(self, texts: Sequence[str], max_len: Optional[int] = None) -> TokenBatch:
        return _left_pad([self.encode(t) for t in texts], self.pad_id, max_len)


def tokenizer_for(model_config) -> ByteTokenizer:
    """The byte tokenizer sized to the model's vocabulary."""
    return ByteTokenizer(model_config.vocab_size)
