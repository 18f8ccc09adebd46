"""Doubly sparse partially collapsed Gibbs sampling for the HDP topic
model (counterpart of ``repro/core/hdp.py``; Terenin, Magnusson & Jonsson,
EMNLP 2020).

State layout (fixed shapes; padding via ``mask``):
  tokens : (D, L) int32   word types, padded docs (mask False on padding)
  z      : (D, L) int32   topic indicators
  n      : (K, V) int32   topic-word sufficient statistic
  phi    : (K, V) f32     topic-word probabilities (PPU-normalized)
  varphi : (K, V) int32   integer PPU counts (sparsity pattern of Phi)
  psi    : (K,)   f32     global topic distribution (FGEM-truncated)
  l      : (K,)   int32   global-draw sufficient statistic

One Gibbs iteration = Algorithm 2 of the paper:
  1. Phi-step : phi_k ~ PPU(n_k + beta)
  2. z-step   : z_{i,d} ~ phi[k,v] (alpha Psi_k + m_dk^-i), sequential
                within a document, parallel across documents
  3. l-step   : binomial trick
  4. Psi-step : FGEM stick-breaking posterior, sigma_{K*} = 1

Every z-step returns ``(z_new, m)`` with m the (D, K) per-document
histogram from the sweep carry; n advances by the exact integer delta
over changed tokens, ``n + delta_n == count_n(z_new)``.

  * ``dense`` — O(K) per token inverse CDF, the semantics oracle;
  * ``cuda``  — the word-sparse sweep of ``kernels/hdp_z`` (the CUDA
                kernel on the card, its plain version on CPU tensors),
                which emits delta_n in the sweep.

Randomness. The reference splits a JAX key; the port draws from one
``torch.Generator`` on the state's device, held in ``HDPState.gen`` and
advanced in place. The draw order is fixed: ``init_state`` draws Phi
(Poisson), then Psi (two gamma draws); every ``gibbs_iteration`` draws
Phi (Poisson; Dirichlet gammas with ``exact_phi``; background uniforms
then Poissons when budgeted), then the (D, L, 3) z-step uniforms, then
l (binomial), then Psi (two gamma draws). A chain is therefore
determined by its seed, its device and this order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.alias import ordered_cumsum
from repro_torch.core.polya_urn import (
    dirichlet_sample, ppu_sample, ppu_sample_budgeted)
from repro_torch.core.stick import gem_prior_sample, sample_l, sample_psi

Z_IMPLS = ("dense", "cuda")


class HDPConfig(NamedTuple):
    K: int = 1000            # K* truncation (incl. flag topic)
    V: int = 1000            # vocabulary size
    alpha: float = 0.1       # document DP concentration
    beta: float = 0.01       # topic-word Dirichlet/PPU concentration
    gamma: float = 1.0       # GEM concentration
    bucket: int = 64         # W: table slots per word for the cuda z-step
    z_impl: str = "cuda"     # dense | cuda
    exact_phi: bool = False  # Algorithm 1: exact Dirichlet Phi instead of PPU
    hist_cap: int = 256      # P: per-(doc,topic) count cap for the l histogram
    alias_in_kernel: str = "auto"  # cuda only: build the term-(a) alias
    #                          entries in the kernel (auto|on|off; auto =
    #                          on for CUDA tensors, off for CPU tensors)
    ppu_nnz_budget: int | None = None  # doubly-sparse PPU draw over at
    #                          most this many non-zero n cells; None = dense


class HDPState(NamedTuple):
    z: torch.Tensor
    n: torch.Tensor
    phi: torch.Tensor
    varphi: torch.Tensor
    psi: torch.Tensor
    l: torch.Tensor
    gen: torch.Generator  # advanced in place, see the module docstring
    it: int


def make_generator(seed: int, device: torch.device | str) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen


# --------------------------------------------------------------------------
# sufficient statistics
# --------------------------------------------------------------------------

def count_n(z, tokens, mask, k: int, v: int) -> torch.Tensor:
    """Topic-word counts n[k, v] from assignments (scatter-add)."""
    zz = torch.where(mask, z, 0).reshape(-1).to(torch.int64)
    tt = torch.where(mask, tokens, 0).reshape(-1).to(torch.int64)
    n = torch.zeros((k * v,), dtype=torch.int32, device=z.device)
    n.index_add_(0, zz * v + tt, mask.reshape(-1).to(torch.int32))
    return n.reshape(k, v)


def delta_n(z_old, z_new, tokens, mask, k: int, v: int) -> torch.Tensor:
    """Exact integer update to n from one sweep: +1 at (z_new, token) and
    -1 at (z_old, token) for every changed live token."""
    ch = (mask & (z_new != z_old)).reshape(-1).to(torch.int32)
    zo = torch.where(mask, z_old, 0).reshape(-1).to(torch.int64)
    zn = torch.where(mask, z_new, 0).reshape(-1).to(torch.int64)
    tt = torch.where(mask, tokens, 0).reshape(-1).to(torch.int64)
    dn = torch.zeros((k * v,), dtype=torch.int32, device=z_old.device)
    dn.index_add_(0, zn * v + tt, ch)
    dn.index_add_(0, zo * v + tt, -ch)
    return dn.reshape(k, v)


def doc_topic_counts(z, mask, k: int) -> torch.Tensor:
    """Per-document topic histogram m: (D, K) from (D, L) assignments."""
    m = torch.zeros((z.shape[0], k), dtype=torch.int32, device=z.device)
    zz = torch.where(mask, z, 0).to(torch.int64)
    return m.scatter_add_(1, zz, mask.to(torch.int32))


def d_histogram(m: torch.Tensor, hist_cap: int) -> torch.Tensor:
    """d[k, p] = #docs with m_{d,k} == p, for p in 1..P (paper Section 2.6)."""
    _, k = m.shape
    p = torch.clamp(m, 0, hist_cap).to(torch.int64)
    valid = (m > 0).to(torch.int32)
    kidx = torch.arange(k, device=m.device)[None, :].expand_as(p)
    hist = torch.zeros((k * (hist_cap + 1),), dtype=torch.int32, device=m.device)
    hist.index_add_(0, (kidx * (hist_cap + 1) + p).reshape(-1), valid.reshape(-1))
    return hist.reshape(k, hist_cap + 1)


# --------------------------------------------------------------------------
# z-step: dense oracle
# --------------------------------------------------------------------------

def _sample_invcdf(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw per row of unnormalized weights (D, K), given
    uniforms (D,), with the canonical left-to-right prefix."""
    c = ordered_cumsum(w)
    t = u * c[:, -1]
    idx = torch.searchsorted(c, t[:, None], side="right")[:, 0]
    return torch.clamp(idx, max=w.shape[-1] - 1).to(torch.int32)


def z_step_dense(tokens, mask, z, phi, psi, alpha: float, uniforms):
    """O(K)-per-token Gibbs sweep; the semantics oracle for all z-steps.
    Returns ``(z_new, m)``."""
    d, l = tokens.shape
    k = phi.shape[0]
    apsi = torch.tensor(alpha, dtype=torch.float32, device=psi.device) * psi
    z_new = z.clone()
    m = doc_topic_counts(z, mask, k)
    ar = torch.arange(d, device=tokens.device)
    for i in range(l):
        v = tokens[:, i].to(torch.int64)
        live = mask[:, i]
        live_i = live.to(torch.int32)
        zi = z_new[:, i]
        m[ar, zi.to(torch.int64)] -= live_i
        w = phi[:, v].T * (apsi + m.to(torch.float32))
        k_new = _sample_invcdf(w, uniforms[:, i, 0])
        # zero total mass (word absent from every PPU topic): keep.
        k_new = torch.where(live & (ordered_cumsum(w)[:, -1] > 0), k_new, zi)
        m[ar, k_new.to(torch.int64)] += live_i
        z_new[:, i] = k_new
    return z_new, m


# --------------------------------------------------------------------------
# full Gibbs iteration (Algorithm 2; Algorithm 1 when exact_phi)
# --------------------------------------------------------------------------

def validate_bucket(cfg: HDPConfig, max_len: int) -> None:
    """Reject z-step configurations the port cannot run.

    The reference's bucketed pure-JAX z-step (``z_impl="sparse"``), whose
    bucket must hold min(K, L) topics, is not ported; the port's z-steps
    (``dense``, ``cuda``) have no bucket overflow. ``max_len`` is kept
    for the reference's signature.
    """
    del max_len
    if cfg.z_impl not in Z_IMPLS:
        raise ValueError(
            f"unknown z_impl {cfg.z_impl!r}: the port runs {Z_IMPLS}")


def init_state(gen: torch.Generator, tokens, mask, cfg: HDPConfig) -> HDPState:
    """Initialize with a single topic (paper Section 3, following Teh)."""
    validate_bucket(cfg, tokens.shape[1])
    z = torch.zeros_like(tokens)
    n = count_n(z, tokens, mask, cfg.K, cfg.V)
    if cfg.ppu_nnz_budget is not None:
        phi, varphi = ppu_sample_budgeted(gen, n, cfg.beta, cfg.ppu_nnz_budget)
    else:
        phi, varphi = ppu_sample(gen, n, cfg.beta)
    psi = gem_prior_sample(gen, cfg.K, cfg.gamma)
    return HDPState(
        z=z, n=n, phi=phi, varphi=varphi, psi=psi,
        l=torch.zeros((cfg.K,), dtype=torch.int32, device=tokens.device),
        gen=gen, it=0,
    )


def _z_step(cfg: HDPConfig, tokens, mask, z, phi, psi, uniforms):
    """Dispatch to the configured z-step: ``(z_new, m, dn)`` where dn is
    the (K, V) delta the cuda z-step emits in its sweep, None for dense."""
    if cfg.z_impl == "dense":
        z_new, m = z_step_dense(tokens, mask, z, phi, psi, cfg.alpha, uniforms)
        return z_new, m, None
    if cfg.z_impl == "cuda":
        from repro_torch.kernels.hdp_z import ops as zops

        return zops.z_step_cuda(
            tokens, mask, z, phi, psi, cfg.alpha, uniforms, cfg.bucket,
            emit_delta=True, alias_in_kernel=cfg.alias_in_kernel,
        )
    raise ValueError(f"unknown z_impl {cfg.z_impl!r}")


def phi_step(gen: torch.Generator, n, varphi, cfg: HDPConfig):
    """Step 1, the Phi-step (parallel over topics): ``(phi, varphi)``
    drawn from n; with ``exact_phi`` a Dirichlet phi and the incoming
    varphi."""
    if cfg.exact_phi:
        return dirichlet_sample(gen, n, cfg.beta), varphi
    if cfg.ppu_nnz_budget is not None:
        return ppu_sample_budgeted(gen, n, cfg.beta, cfg.ppu_nnz_budget)
    return ppu_sample(gen, n, cfg.beta)


def gibbs_iteration(state: HDPState, tokens, mask, cfg: HDPConfig) -> HDPState:
    gen = state.gen

    # 1. Phi-step (parallel over topics)
    phi, varphi = phi_step(gen, state.n, state.varphi, cfg)

    # 2. z-step (parallel over documents); n advances by the exact delta.
    uniforms = torch.rand(tokens.shape + (3,), generator=gen,
                          device=tokens.device, dtype=torch.float32)
    z, m, dn = _z_step(cfg, tokens, mask, state.z, phi, state.psi, uniforms)
    if dn is None:
        dn = delta_n(state.z, z, tokens, mask, cfg.K, cfg.V)
    n = state.n + dn
    dh = d_histogram(m, cfg.hist_cap)

    # 3. l-step (binomial trick)
    l = sample_l(gen, dh, state.psi, cfg.alpha)

    # 4. Psi-step (FGEM stick-breaking, flag topic at K*-1)
    psi = sample_psi(gen, l, cfg.gamma)

    return HDPState(z=z, n=n, phi=phi, varphi=varphi, psi=psi, l=l,
                    gen=gen, it=state.it + 1)


# --------------------------------------------------------------------------
# diagnostics (paper Figure 1 metrics)
# --------------------------------------------------------------------------

def log_marginal_likelihood(state: HDPState, tokens, mask, cfg: HDPConfig):
    """log p(w, z | Phi, Psi): token term + Polya-sequence term per doc,
    accumulated in float32 over token positions as the reference does."""
    zz = torch.where(mask, state.z, 0).to(torch.int64)
    tt = torch.where(mask, tokens, 0).to(torch.int64)
    tok = torch.log(torch.clamp(state.phi[zz, tt], min=1e-30))
    tok_ll = torch.where(mask, tok, 0.0).sum()
    apsi = cfg.alpha * state.psi
    d, l = tokens.shape
    m = torch.zeros((d, cfg.K), dtype=torch.float32, device=tokens.device)
    ll = torch.zeros((d,), dtype=torch.float32, device=tokens.device)
    cnt = torch.zeros((d,), dtype=torch.float32, device=tokens.device)
    ar = torch.arange(d, device=tokens.device)
    for i in range(l):
        zi = zz[:, i]
        live = mask[:, i]
        num = apsi[zi] + m[ar, zi]
        ll = ll + torch.where(live, torch.log(num / (cfg.alpha + cnt)), 0.0)
        livef = live.to(torch.float32)
        m[ar, zi] += livef
        cnt = cnt + livef
    return tok_ll + ll.sum()


def posterior_predictive_ll(state: HDPState, tokens, mask, cfg: HDPConfig):
    """Token log-likelihood under posterior-mean parameters:
    phi_mean ∝ n + beta, theta_mean ∝ m + alpha psi. Deterministic given
    the state."""
    nb = state.n.to(torch.float32) + cfg.beta
    phi_mean = nb / nb.sum(1, keepdim=True)
    m = doc_topic_counts(state.z, mask, cfg.K).to(torch.float32)
    theta = m + cfg.alpha * state.psi
    theta = theta / theta.sum(1, keepdim=True)
    probs = theta @ phi_mean  # (D, V)
    tt = torch.where(mask, tokens, 0).to(torch.int64)
    tok_p = probs.gather(1, tt)
    return torch.where(mask, torch.log(torch.clamp(tok_p, min=1e-30)), 0.0).sum()


def active_topics(state: HDPState) -> torch.Tensor:
    """Number of topics with at least one token assigned."""
    return (state.n.sum(1) > 0).sum()


def flag_topic_tokens(state: HDPState) -> torch.Tensor:
    """Tokens at the flag topic K* (should stay 0 if K* is large enough)."""
    return state.n[-1].sum()


def topic_sizes(state: HDPState) -> torch.Tensor:
    return state.n.sum(1)
