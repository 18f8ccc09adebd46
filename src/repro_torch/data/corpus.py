"""Bag-of-words corpus container (counterpart of ``repro/data/corpus.py``).

Documents are packed into fixed-shape (D, L) int32 arrays with a boolean
mask. Host-side numpy only; the trainer moves the arrays to its device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


class Corpus(NamedTuple):
    tokens: np.ndarray  # (D, L) int32, padded
    mask: np.ndarray    # (D, L) bool
    V: int

    @property
    def num_docs(self) -> int:
        return self.tokens.shape[0]

    @property
    def num_tokens(self) -> int:
        return int(self.mask.sum())

    @property
    def max_len(self) -> int:
        return self.tokens.shape[1]


def pack_documents(
    docs: Sequence[np.ndarray], V: int, max_len: int | None = None,
    pad_docs_to: int | None = None,
) -> Corpus:
    """Pack a list of variable-length documents into a fixed-shape Corpus.

    Documents longer than max_len are split into continuation rows (bag of
    words — splitting is statistically harmless for LDA-family models only
    at the m-statistic level, so by default max_len covers the longest doc).
    """
    if max_len is None:
        max_len = max((len(d) for d in docs), default=1)
    rows = []
    for d in docs:
        d = np.asarray(d, dtype=np.int32)
        for s in range(0, max(len(d), 1), max_len):
            rows.append(d[s : s + max_len])
    n_rows = len(rows)
    if pad_docs_to is not None:
        n_rows = max(n_rows, pad_docs_to)
    tokens = np.zeros((n_rows, max_len), dtype=np.int32)
    mask = np.zeros((n_rows, max_len), dtype=bool)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = r
        mask[i, : len(r)] = True
    return Corpus(tokens=tokens, mask=mask, V=V)
