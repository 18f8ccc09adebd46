"""Held-out evaluation: document-completion perplexity by fold-in
(counterpart of ``repro/serve/eval.py``).

The estimate-then-predict protocol (Wallach et al. 2009, "Evaluation
Methods for Topic Models"): each held-out document is split by the
parity of its live tokens into an estimation half (1st, 3rd, ...) and a
prediction half (2nd, 4th, ...); the estimation half is folded into the
frozen model for theta_d, and the prediction half is scored under

    log p(w) = log sum_k theta_dk phi_kw,

perplexity = exp(-sum log p / N_pred). It is comparable across
snapshots, truncations K* and schedules, and falls as training learns
topic structure.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.serve import foldin as F
from repro_torch.serve.snapshot import ModelSnapshot


def completion_split(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split (D, L) masks by live-token parity: (estimation, prediction).
    Parity counts live tokens only, so padding cannot move the split."""
    cnt = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    return mask & (cnt % 2 == 0), mask & (cnt % 2 == 1)


def _scores(snap: ModelSnapshot, tokens, pred, theta) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-likelihood, token count) of the prediction half under
    mixtures ``theta``. The (D, K) x (K, V) product is a plain matmul, as
    the reference leaves it to XLA."""
    probs = theta @ snap.phi.to(torch.float32)  # (D, V)
    tt = torch.where(pred, tokens, 0).to(torch.int64)
    tok_p = probs.gather(1, tt)
    ll = torch.where(pred, torch.log(torch.clamp(tok_p, min=1e-30)), 0.0).sum()
    return ll, pred.sum()


def heldout_scores_from_uniforms(
    snap: ModelSnapshot, tokens: torch.Tensor, mask: torch.Tensor,
    u_init: torch.Tensor, u_sweeps: Iterable[torch.Tensor], *, impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``heldout_scores`` on given uniforms (``foldin_from_uniforms``'s
    seam), so a test can feed the reference's own."""
    est, pred = completion_split(mask)
    theta, _ = F.foldin_from_uniforms(snap, tokens, est, u_init, u_sweeps, impl=impl)
    return _scores(snap, tokens, pred, theta)


def heldout_scores(
    snap: ModelSnapshot, tokens: torch.Tensor, mask: torch.Tensor,
    seeds: torch.Tensor, base_seed: int, *, burnin: int = 16, impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(total log-likelihood, token count) of the prediction halves
    under fold-in mixtures estimated from the estimation halves, on the
    uniforms ``foldin_docs`` draws for these seeds."""
    u0, sweeps = F.foldin_uniforms(base_seed, seeds, tokens.shape[1], burnin)
    return heldout_scores_from_uniforms(snap, tokens, mask, u0, sweeps, impl=impl)


def heldout_perplexity(
    snap: ModelSnapshot, tokens, mask, base_seed: int, *, burnin: int = 16,
    impl: str = "cuda", seeds=None,
) -> float:
    """Fold-in perplexity of a held-out (D, L) batch (arrays or tensors;
    they go to the snapshot's device)."""
    dev = snap.device
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    if seeds is None:
        seeds = torch.arange(tokens.shape[0], dtype=torch.int32, device=dev)
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev)
    ll, n = heldout_scores(snap, tokens, mask, seeds, base_seed, burnin=burnin,
                           impl=impl)
    return float(np.exp(-float(ll) / max(int(n), 1)))
