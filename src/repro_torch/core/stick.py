"""Stick-breaking posterior for Psi and the binomial-trick draw of l
(counterpart of ``repro/core/stick.py``).

Psi | l is stick-breaking with sigma_k ~ Beta(1 + l_k, gamma +
sum_{i>k} l_i) and the flag topic's sigma fixed to 1 (FGEM truncation).
l is drawn by the binomial trick, constant in D and N:
l_k = sum_j Binomial(D_{k,j}, Psi_k alpha / (Psi_k alpha + j - 1)) with
D_{k,j} the number of documents holding at least j tokens of topic k.

``torch.distributions.Beta`` takes no generator, so Beta(a, b) is drawn
as Ga / (Ga + Gb) from two ``torch._standard_gamma`` draws.
"""

from __future__ import annotations

import torch


def _beta(gen: torch.Generator, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ga = torch._standard_gamma(a, generator=gen)
    gb = torch._standard_gamma(b, generator=gen)
    return ga / (ga + gb)


def sample_l(
    gen: torch.Generator, d_hist: torch.Tensor, psi: torch.Tensor,
    alpha: float,
) -> torch.Tensor:
    """Binomial-trick draw of l.

    d_hist: (K, P+1) int32, d_hist[k, p] = #docs with m_{d,k} == p
            (column 0 unused). psi: (K,). Returns l: (K,) int32.
    """
    kk, pp1 = d_hist.shape
    # D_{k,j} = sum_{p >= j} d_hist[k, p] (integer reverse cumsum: exact).
    d_geq = torch.flip(torch.cumsum(torch.flip(d_hist, [1]), 1), [1])
    j = torch.arange(pp1, dtype=torch.float32, device=psi.device)
    rate = psi[:, None].to(torch.float32) * alpha
    p_j = rate / (rate + torch.clamp(j[None, :] - 1.0, min=0.0))
    # j = 1 has probability 1 (the first token of a topic in a document
    # always counts), also when rate is 0 and the ratio above is 0/0.
    p_j = torch.where(j[None, :] == 1.0, 1.0, p_j).clamp(0.0, 1.0)
    draws = torch.binomial(d_geq.to(torch.float32), p_j, generator=gen)
    draws[:, 0] = 0.0
    return draws.sum(1).to(torch.int32)


def _fgem(sigma: torch.Tensor) -> torch.Tensor:
    """Psi_k = sigma_k prod_{i<k} (1 - sigma_i) with sigma_{K*} = 1,
    in log space, renormalized."""
    kk = sigma.shape[0]
    sigma = sigma.clone()
    sigma[kk - 1] = 1.0
    log1m = torch.log1p(-torch.clamp(sigma, max=1.0 - 1e-7))
    log1m[kk - 1] = 0.0
    cum = torch.cat([log1m.new_zeros(1), torch.cumsum(log1m, 0)[:-1]])
    psi = sigma * torch.exp(cum)
    return psi / psi.sum()


def sample_psi(gen: torch.Generator, l: torch.Tensor, gamma: float) -> torch.Tensor:
    """FGEM stick-breaking posterior draw of Psi given l: (K,) on the
    simplex, the last index being the flag topic."""
    lf = l.to(torch.float32)
    a = 1.0 + lf
    tail = torch.flip(torch.cumsum(torch.flip(lf, [0]), 0), [0]) - lf
    b = gamma + tail
    sigma = torch.clamp(_beta(gen, a, b), 1e-30, 1.0 - 1e-7)
    return _fgem(sigma)


def gem_prior_sample(gen: torch.Generator, k: int, gamma: float) -> torch.Tensor:
    """Draw Psi ~ FGEM(gamma, K) from the prior (for initialization), on
    the generator's device."""
    ones = torch.ones((k,), device=gen.device)
    sigma = _beta(gen, ones, torch.full((k,), float(gamma), device=gen.device))
    return _fgem(sigma)
