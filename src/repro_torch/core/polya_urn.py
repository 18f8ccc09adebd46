"""Poisson Polya Urn (PPU) sampling of Phi (counterpart of
``repro/core/polya_urn.py``).

The Dirichlet full conditional ``phi_k | n ~ Dir(beta + n_k)`` is
approximated by normalized independent Poisson draws
``varphi ~ Poisson(beta + n)``, ``phi = varphi / rowsum`` — integer
counts, so Phi is sparse. Every draw takes an explicit
``torch.Generator`` on the tensors' device; the two frameworks never give
the same bits, so these are held to the reference in distribution.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ppu_counts(gen: torch.Generator, n: torch.Tensor, beta: float) -> torch.Tensor:
    """Draw integer PPU counts varphi ~ Poisson(beta + n). n: (K, V) int."""
    rate = n.to(torch.float32) + beta
    return torch.poisson(rate, generator=gen).to(torch.int32)


def ppu_normalize(varphi: torch.Tensor) -> torch.Tensor:
    """Normalize integer counts to rows of Phi; all-zero rows stay zero.

    The row sums are integers below 2**24, exact in float32, so the
    result is one correctly rounded division per cell, bitwise-equal to
    the reference's."""
    row = varphi.sum(-1, keepdim=True).to(torch.float32)
    return varphi.to(torch.float32) / torch.clamp(row, min=1.0)


def ppu_sample(
    gen: torch.Generator, n: torch.Tensor, beta: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample Phi via the PPU approximation. Returns (phi, varphi)."""
    varphi = ppu_counts(gen, n, beta)
    return ppu_normalize(varphi), varphi


# Number of inversion terms for the tiny-rate beta background. P(X >= 8)
# at rate 0.5 is ~2e-13 — far below float32 CDF resolution near 1, so the
# truncated inversion is exact with respect to float32 uniforms.
_BG_CDF_TERMS = 8
_BG_RATE_MAX = 0.5


def _poisson_cdf_terms(rate: float) -> tuple[float, ...]:
    """float32-rounded CDF of Poisson(rate) at 0..TERMS-1."""
    cdf, acc, term = [], 0.0, math.exp(-rate)
    for j in range(_BG_CDF_TERMS):
        acc += term
        cdf.append(float(np.float32(acc)))
        term *= rate / (j + 1)
    return tuple(cdf)


def ppu_counts_budgeted(
    gen: torch.Generator, n: torch.Tensor, beta: float, budget: int,
) -> torch.Tensor:
    """``ppu_counts`` drawn sparsely: Poisson(n + beta) split over the
    zero/non-zero structure of n (Poisson additivity).

      * every cell gets a Poisson(beta) background by truncated CDF
        inversion of one uniform;
      * the at-most ``budget`` non-zero cells add a Poisson(n) on top.

    Same law as ``ppu_counts``, a different random stream. Requires
    beta <= 0.5 for the truncated inversion; larger beta draws dense.
    As in the reference, non-zeros beyond ``budget`` get no n-part, so
    the budget must bound nnz(n) (the corpus token count always does).
    """
    if beta > _BG_RATE_MAX:
        return ppu_counts(gen, n, beta)
    bg = torch.zeros(n.shape, dtype=torch.int32, device=n.device)
    if beta > 0:
        uu = torch.rand(n.shape, generator=gen, device=n.device)
        for c in _poisson_cdf_terms(beta):
            bg += (uu >= c).to(torch.int32)
    flat = n.reshape(-1)
    idx = torch.nonzero(flat).reshape(-1)[: int(budget)]
    draws = torch.poisson(flat[idx].to(torch.float32), generator=gen)
    bg.view(-1).index_add_(0, idx, draws.to(torch.int32))
    return bg


def ppu_sample_budgeted(
    gen: torch.Generator, n: torch.Tensor, beta: float, budget: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample Phi via the doubly-sparse PPU draw. Returns (phi, varphi)."""
    varphi = ppu_counts_budgeted(gen, n, beta, budget)
    return ppu_normalize(varphi), varphi


def dirichlet_sample(
    gen: torch.Generator, n: torch.Tensor, beta: float,
) -> torch.Tensor:
    """Exact Dirichlet full conditional (the distribution PPU
    approximates), as normalized gamma draws."""
    alpha = n.to(torch.float32) + beta
    g = torch._standard_gamma(alpha, generator=gen)
    return g / g.sum(-1, keepdim=True)
