"""Interning free-text items into integer ids for fixed-shape metric kernels
(the port's copy of ``fairness_llm_tpu/metrics/encode.py``, which is pure
numpy).

Every distinct item (a movie title) gets an id in a ``Vocab``; each
recommendation list becomes a padded row of int32 ids (``PAD = -1``). Set
membership is then a one-hot row and every set operation a vector
reduction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PAD = -1


@dataclasses.dataclass
class Vocab:
    """Bidirectional item <-> id mapping, insertion-ordered."""

    items: List[str] = dataclasses.field(default_factory=list)
    index: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, item: str) -> int:
        idx = self.index.get(item)
        if idx is None:
            idx = len(self.items)
            self.index[item] = idx
            self.items.append(item)
        return idx

    def extend(self, items: Iterable[str]) -> None:
        for it in items:
            self.add(it)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, item: str) -> int:
        return self.index[item]


def encode_rec_lists(
    rec_lists: Sequence[Sequence[str]],
    vocab: Optional[Vocab] = None,
    max_len: Optional[int] = None,
) -> Tuple[np.ndarray, Vocab]:
    """Encode variable-length string lists into a padded int32 matrix [N, K].

    Duplicates within a list are preserved (the reference's demographic-parity
    distributions count duplicates; its Jaccard/set metrics dedupe later — both
    behaviors are recoverable from the padded ID rows).
    """
    vocab = vocab or Vocab()
    encoded = [[vocab.add(item) for item in recs] for recs in rec_lists]
    k = max_len or max((len(e) for e in encoded), default=1)
    k = max(k, 1)
    out = np.full((len(encoded), k), PAD, dtype=np.int32)
    for i, row in enumerate(encoded):
        out[i, : min(len(row), k)] = row[:k]
    return out, vocab


def one_hot_membership(ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """[N, K] padded ID rows -> [N, V] boolean membership (dedup semantics)."""
    n = ids.shape[0]
    out = np.zeros((n, vocab_size), dtype=bool)
    for i in range(n):
        row = ids[i]
        out[i, row[row >= 0]] = True
    return out


def count_matrix(ids: np.ndarray, vocab_size: int) -> np.ndarray:
    """[N, K] padded ID rows -> [N, V] float32 occurrence counts (keeps duplicates)."""
    n, _ = ids.shape
    out = np.zeros((n, vocab_size), dtype=np.float32)
    for i in range(n):
        row = ids[i]
        valid = row[row >= 0]
        np.add.at(out[i], valid, 1.0)
    return out
