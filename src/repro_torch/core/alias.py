"""Walker alias tables (counterpart of ``repro/core/alias.py``).

The global term (a) of the z full conditional, ``phi[k, v] * alpha *
psi_k``, is drawn from one alias table per word over its W table slots.
The construction is the reference's sort-free, index-ordered prefix-sum
partition: small i's donor is the first large whose cumulative surplus
covers the deficit before i, and large j demotes at the first small whose
cumulative deficit exceeds the surplus up to j (``searchsorted`` both
ways on the cumulative lines).

Canonical float32 summation order. Every float sum in the sweep and in
the table build — the alias normalisation total, the deficit and surplus
lines ``dcum``/``ucum``, ``q_a`` and the term-(b) prefix — is taken
sequentially, left to right over the slots, one float32 add at a time
(``ordered_cumsum``/``ordered_sum``). The CUDA kernel walks the slots in
the same order, so kernel and plain version agree bit for bit; and over
topic-ordered slots the sum equals the same sum over a dense
ascending-topic K vector, because the absent topics add exactly 0.0.
``torch.cumsum`` and ``torch.sum`` are not used for these sums: their
order differs between the CPU (double accumulation) and the card
(parallel scan).

Tables are not bitwise-equal to the reference's (its sums use XLA's
order); they reconstruct the same pmf to float accuracy.
"""

from __future__ import annotations

import torch


def ordered_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-to-right float32 prefix sums over the last axis:
    ``c[..., 0] = x[..., 0]`` and ``c[..., j] = c[..., j-1] + x[..., j]``,
    each add rounded to float32."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    acc = x[..., 0].clone()
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """Last element of ``ordered_cumsum(x)``, without storing the line."""
    acc = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _normalized(p: torch.Tensor) -> torch.Tensor:
    """q = p / mean(p) over the last axis, where "small" entries sit
    below 1.

    Guards: non-finite and negative weights are clamped to zero before
    normalizing, and rows whose total is zero (padded words, or rows that
    were entirely non-finite) fall back to uniform.
    """
    k = p.shape[-1]
    p = torch.where(torch.isfinite(p) & (p > 0), p, 0.0)
    total = ordered_sum(p)[..., None]
    return torch.where(
        total > 0, p / torch.clamp(total, min=1e-30) * k, torch.ones_like(p)
    )


def alias_build(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched alias build (sort-free index-ordered partition).

    p: (..., K) unnormalized float32 weights, one table per leading index.
    Returns (prob f32, alias int32) of the same shape: prob[j] is the
    probability that slot j keeps its own index, alias[j] the donor.
    """
    shape = p.shape
    k = shape[-1]
    q = _normalized(p.reshape(-1, k).to(torch.float32))
    pos = torch.arange(k, device=q.device).expand_as(q)
    small = q < 1.0
    large = ~small
    cs = torch.cumsum(small.to(torch.int64), -1)   # 1-based count of smalls
    cl = torch.cumsum(large.to(torch.int64), -1)   # 1-based count of larges
    ns = cs[:, -1:]
    nl = k - ns
    rank_l = cl - 1

    d = torch.where(small, 1.0 - q, 0.0)
    u = torch.where(large, q - 1.0, 0.0)
    dcum = ordered_cumsum(d)    # S: plateaus at larges
    ucum = ordered_cumsum(u)    # U: plateaus at smalls

    # smalls: donor = first large whose running surplus covers D-before.
    dprev = dcum - d
    t1 = torch.searchsorted(ucum, dprev, side="left")
    r = torch.where(t1 > 0, cl.gather(-1, (t1 - 1).clamp(min=0)), 0)
    has_donor = small & (r < nl)
    jstar = torch.searchsorted(cl, r, side="right")
    alias_small = torch.where(has_donor, jstar.clamp(max=k - 1), pos)

    # larges: demoting small = first with cumulative deficit > U[j].
    t2 = torch.searchsorted(dcum, ucum, side="right")
    mstar = torch.where(t2 > 0, cs.gather(-1, (t2 - 1).clamp(min=0)), 0)
    demoted = large & (mstar < ns)
    p2 = torch.searchsorted(cs, mstar, side="right").clamp(max=k - 1)
    resid = 1.0 + ucum - dcum.gather(-1, p2)
    has_next = demoted & (rank_l + 1 < nl)
    next_l = torch.searchsorted(cl, rank_l + 1, side="right").clamp(max=k - 1)

    prob = torch.where(small, q, torch.where(demoted, resid, 1.0))
    alias = torch.where(small, alias_small, torch.where(has_next, next_l, pos))
    prob = prob.clamp(0.0, 1.0)
    return prob.reshape(shape), alias.to(torch.int32).reshape(shape)


def alias_build_row_onehot(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``alias_build`` re-expressed with comparisons, counts and one-hot
    selections over an (..., K, K) comparison matrix: no sort, gather or
    ``searchsorted``. It is the per-token build that the kernel's
    prologue mode runs, written out the way the reference's Pallas
    prologue writes it, and it is bitwise-equal to ``alias_build``: a
    binary search on a nondecreasing line equals its comparison count,
    and a one-hot selection moves a value without arithmetic on it.
    O(K^2) per row.
    """
    k = p.shape[-1]
    q = _normalized(p.to(torch.float32))
    pos = torch.arange(k, device=q.device)
    small = q < 1.0
    large = ~small
    ns = small.sum(-1, keepdim=True)
    nl = k - ns

    d = torch.where(small, 1.0 - q, 0.0)
    u = torch.where(large, q - 1.0, 0.0)
    dcum = ordered_cumsum(d)
    ucum = ordered_cumsum(u)
    rank_s = torch.cumsum(small.to(torch.int64), -1) - 1
    rank_l = torch.cumsum(large.to(torch.int64), -1) - 1

    # smalls: r = |{larges j : U[j] < dprev}| == searchsorted(side='left')
    dprev = dcum - d
    lt = large[..., None, :] & (ucum[..., None, :] < dprev[..., :, None])
    r = lt.sum(-1)
    has_donor = small & (r < nl)
    sel = large[..., None, :] & (rank_l[..., None, :] == r[..., :, None])
    alias_small = torch.where(has_donor, (sel * pos).sum(-1), pos)

    # larges: mstar = |{smalls m : S[m] <= U[j]}| == side='right'
    le = small[..., None, :] & (dcum[..., None, :] <= ucum[..., :, None])
    mstar = le.sum(-1)
    demoted = large & (mstar < ns)
    sel_m = small[..., None, :] & (rank_s[..., None, :] == mstar[..., :, None])
    # one selected value plus exact zeros: any summation order is exact
    s_at = torch.where(sel_m, dcum[..., None, :], 0.0).sum(-1)
    resid = 1.0 + ucum - s_at
    has_next = demoted & (rank_l + 1 < nl)
    sel_n = large[..., None, :] & (
        rank_l[..., None, :] == (rank_l + 1)[..., :, None])
    next_l = (sel_n * pos).sum(-1)

    prob = torch.where(small, q, torch.where(demoted, resid, 1.0))
    alias = torch.where(small, alias_small, torch.where(has_next, next_l, pos))
    prob = prob.clamp(0.0, 1.0)
    return prob, alias.to(torch.int32)


def alias_sample(
    prob: torch.Tensor, alias: torch.Tensor, u1: torch.Tensor,
    u2: torch.Tensor,
) -> torch.Tensor:
    """Draw indices from one alias table, deterministically given uniforms.

    prob/alias: (K,) single table, u1/u2 broadcastable uniforms in [0,1).
    """
    k = prob.shape[-1]
    slot = torch.clamp((u1 * k).to(torch.int64), max=k - 1)
    keep = u2 < prob[slot]
    return torch.where(keep, slot, alias[slot].to(torch.int64)).to(torch.int32)
