"""Synthetic corpora (counterpart of ``repro/data/synthetic.py``).

With the same numpy generator state these give the same arrays as the
reference:
  * ``planted_topics_corpus`` — documents from a ground-truth topic
    process with known topics; used for recovery tests.
  * ``paper_corpus`` — a Zipfian replica of the paper's Table 2 corpora
    (V, D, N; Heaps-law vocabulary) at full or scaled-down size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.data.corpus import Corpus, pack_documents

# Paper Table 2.
PAPER_CORPORA = {
    "ap": dict(V=7074, D=2206, N=393567),
    "cgcbib": dict(V=6079, D=5940, N=570370),
    "neurips": dict(V=12419, D=1499, N=1894051),
    "pubmed": dict(V=89987, D=8199999, N=768434972),
}


class PlantedTruth(NamedTuple):
    phi: np.ndarray   # (K_true, V)
    psi: np.ndarray   # (K_true,)
    theta: np.ndarray  # (D, K_true)


def planted_topics_corpus(
    rng: np.random.Generator, D: int, V: int, K_true: int,
    doc_len: tuple[int, int] = (20, 60), alpha: float = 0.5,
    topic_sharpness: float = 0.05,
) -> tuple[Corpus, PlantedTruth]:
    phi = rng.dirichlet(np.full(V, topic_sharpness), size=K_true)
    psi = rng.dirichlet(np.full(K_true, 2.0))
    theta = rng.dirichlet(alpha * K_true * psi, size=D)
    docs = []
    for d in range(D):
        nd = rng.integers(doc_len[0], doc_len[1] + 1)
        ks = rng.choice(K_true, size=nd, p=theta[d])
        ws = np.array([rng.choice(V, p=phi[k]) for k in ks], dtype=np.int32)
        docs.append(ws)
    return pack_documents(docs, V), PlantedTruth(phi, psi, theta)


def paper_corpus(
    name: str, rng: np.random.Generator, scale: float = 1.0,
    max_len: int | None = None,
) -> Corpus:
    """Zipfian synthetic replica of a paper corpus, optionally scaled.

    scale in (0, 1] shrinks D and N proportionally (V follows Heaps' law
    V = xi * N^zeta with zeta calibrated from the full-size pair).
    """
    spec = PAPER_CORPORA[name]
    D = max(int(spec["D"] * scale), 1)
    N = max(int(spec["N"] * scale), D)
    if scale >= 1.0:
        V = spec["V"]
    else:
        # Heaps calibration: zeta from (N, V) anchor with xi = 1.
        zeta = np.log(spec["V"]) / np.log(spec["N"])
        V = max(int(N**zeta), 64)
    avg_len = N / D
    # Zipf-Mandelbrot unigram marginal.
    ranks = np.arange(1, V + 1, dtype=np.float64)
    pz = 1.0 / (ranks + 2.7) ** 1.07
    pz /= pz.sum()
    lengths = rng.poisson(avg_len, size=D).clip(1)
    docs = [
        rng.choice(V, size=int(nd), p=pz).astype(np.int32) for nd in lengths
    ]
    return pack_documents(docs, V, max_len=max_len)
