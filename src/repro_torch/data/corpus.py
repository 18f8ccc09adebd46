"""Bag-of-words corpus container and document sharding (counterpart of
``repro/data/corpus.py``).

Documents are packed into fixed-shape (D, L) int32 arrays with a boolean
mask. Host-side numpy only; the trainer moves the arrays to its device.
Sharding is by token-count-balanced blocks (greedy LPT bin packing): work
per rank scales with its token count, so token counts are equalized, not
document counts (Gal & Ghahramani 2014, cited by the paper).
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


def balanced_shards(corpus: Corpus, num_shards: int) -> np.ndarray:
    """Greedy LPT assignment of document rows to shards by token count.

    Returns a permutation such that reshaping the permuted rows to
    (num_shards, D/num_shards, L) yields token-balanced shards.
    """
    lengths = corpus.mask.sum(axis=1)
    order = np.argsort(-lengths)  # longest first
    loads = np.zeros(num_shards, dtype=np.int64)
    fill = [[] for _ in range(num_shards)]
    for idx in order:
        s = int(np.argmin(loads))
        fill[s].append(idx)
        loads[s] += lengths[idx]
    per = (corpus.num_docs + num_shards - 1) // num_shards
    perm = np.full(num_shards * per, -1, dtype=np.int64)
    spare = []
    for s in range(num_shards):
        rows = fill[s][:per]
        spare.extend(fill[s][per:])
        for j, r in enumerate(rows):
            perm[s * per + j] = r
    # place overflow rows into empty slots (keeps every row exactly once)
    empty = np.nonzero(perm < 0)[0]
    for slot, r in zip(empty, spare):
        perm[slot] = r
    # remaining empties point at a zero-mask padding row: use row 0 dup-free
    if (perm < 0).any():
        raise AssertionError("balanced_shards: unfilled slots")
    return perm


def shard_balanced(corpus: Corpus, num_shards: int) -> Corpus:
    """Return a corpus with rows permuted for balanced sharding, padded so
    D is divisible by num_shards."""
    per = (corpus.num_docs + num_shards - 1) // num_shards
    d_pad = per * num_shards
    if d_pad != corpus.num_docs:
        pad = d_pad - corpus.num_docs
        tokens = np.concatenate(
            [corpus.tokens, np.zeros((pad, corpus.max_len), np.int32)]
        )
        mask = np.concatenate(
            [corpus.mask, np.zeros((pad, corpus.max_len), bool)]
        )
        corpus = Corpus(tokens, mask, corpus.V)
    perm = balanced_shards(corpus, num_shards)
    return Corpus(corpus.tokens[perm], corpus.mask[perm], corpus.V)
