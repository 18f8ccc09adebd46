"""Deterministic synthetic LM token stream (Zipf unigrams + a planted
bigram structure so the loss has learnable signal); the port's own copy
of ``repro/data/lm_data.py`` (numpy, the same ``default_rng((seed,
step))`` stream), so that its batches are bitwise the reference's.

Deterministic in (seed, step): after an elastic restart the pipeline
re-emits exactly the batches the restored step expects, on any device
count — the data side of fault tolerance.
"""

from __future__ import annotations

import numpy as np


class SyntheticLMStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, prefix_len: int = 0, d_model: int = 0):
        self.V = vocab_size
        self.B = batch
        self.S = seq_len
        self.seed = seed
        self.prefix_len = prefix_len
        self.d_model = d_model
        ranks = np.arange(1, self.V + 1, dtype=np.float64)
        p = 1.0 / (ranks + 2.7) ** 1.07
        self.p = p / p.sum()
        # planted bigram: token t is followed by (t * 31 + 7) % V with p=0.5
        self.bigram = (np.arange(self.V) * 31 + 7) % self.V

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        toks = np.empty((self.B, self.S + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(self.V, size=self.B, p=self.p)
        unigram = rng.choice(self.V, size=(self.B, self.S), p=self.p)
        use_bigram = rng.random((self.B, self.S)) < 0.5
        for t in range(self.S):
            toks[:, t + 1] = np.where(
                use_bigram[:, t], self.bigram[toks[:, t]], unigram[:, t]
            )
        out = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:].copy(),
            "mask": np.ones((self.B, self.S), dtype=bool),
        }
        if self.prefix_len:
            out["embeds"] = rng.standard_normal(
                (self.B, self.prefix_len, self.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batches(stream: SyntheticLMStream, num: int, start: int = 0):
    for i in range(start, start + num):
        yield stream.batch(i)
