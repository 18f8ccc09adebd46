"""Frozen-Phi fold-in Gibbs: topic mixtures for unseen documents
(counterpart of ``repro/serve/foldin.py``).

Query inference is the training z-step with the model side frozen: Phi
and Psi (hence the snapshot's word-sparse tables and q_a) are constants,
and only each document's topic histogram m evolves over a short burn-in.
Each sweep runs ``core/conformance.py::z_step_conformant`` on the
snapshot's topic-ordered tables, so the "dense", "sparse" and "cuda"
strategies give bitwise the same draws; "cuda" (the default) is the
``hdp_z_cuda`` kernel on the card, in table mode.

Randomness contract (shared with ``serve/engine.py``, so a document's
mixture does not depend on how the engine batches it): each query
document is named by an integer ``seed``; its z initialization consumes
the uniforms of sweep 0 and burn-in sweep s (1-based) those of sweep s,
from ``sweep_uniforms``, whose row d is a pure function of (base_seed,
seeds[d], s): never of d, the batch or the slot. The reference draws
them from ``fold_in(fold_in(base_key, seed), s)``, whose bits torch
cannot replay; the port keeps the same contract with a counter-based
generator (Philox-4x32-10) in plain integer ops, which gives the same
bits on the CPU and on the card. ``foldin_from_uniforms`` takes the
uniforms from the caller, so a test can feed the reference's own.

z is initialized from the tables' global term alone (k ~ phi[k,v] alpha
psi_k, one alias draw per token): the document prior before any
document-side evidence, identical across strategies.

``restrict_snapshot`` slices a snapshot to the vocabulary a batch
touches: every table access is a row gather by token id, so a fold-in
into the restricted snapshot with remapped tokens is bitwise the full
one.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from repro_torch.core import conformance as C
from repro_torch.core.hdp import doc_topic_counts
from repro_torch.serve.snapshot import ModelSnapshot

IMPLS = ("dense", "sparse", "cuda")

# -- the counter-based generator ---------------------------------------------
# Philox-4x32-10 (Salmon et al., SC 2011): a 4-word counter and a 2-word
# key, ten rounds of two 32x32 -> 64-bit products. Every value is held in
# int64 below 2**32 and each product is formed from 16-bit halves, so no
# intermediate leaves int64's range: the same integer ops on any device.

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
_ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product ``m * x``."""
    p_lo = x * (m & 0xFFFF)          # < 2**48
    p_hi = x * (m >> 16)             # < 2**48
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 of the counter words (int64 tensors, each below
    2**32, broadcast together) under the key (k0, k1); returns the four
    output words as int64 tensors."""
    for r in range(_ROUNDS):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        kr0 = (k0 + r * _W0) & _MASK32
        kr1 = (k1 + r * _W1) & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ kr0, lo1, hi0 ^ c3 ^ kr1, lo0
    return c0, c1, c2, c3


def sweep_uniforms(base_seed: int, seeds: torch.Tensor, sweep_ids: torch.Tensor,
                   length: int) -> torch.Tensor:
    """(D, L, 3) float32 uniforms in [0, 1) for one sweep, on ``seeds``'
    device. Entry (d, i, j) is output word j of Philox-4x32-10 with the
    counter (i, sweep_ids[d], seeds[d] low 32 bits, high 32 bits) and the
    key (base_seed low 32 bits, high 32 bits), its top 24 bits scaled by
    2**-24: a pure function of (base_seed, seeds[d], sweep_ids[d], i, j).
    Seeds and sweep ids are taken as non-negative integers."""
    dev = seeds.device
    s = seeds.to(torch.int64)[:, None]
    c0 = torch.arange(length, dtype=torch.int64, device=dev)[None, :]
    c1 = sweep_ids.to(torch.int64)[:, None] & _MASK32
    c2, c3 = s & _MASK32, (s >> 32) & _MASK32
    base = int(base_seed)
    x = philox4x32(c0, c1, c2, c3, base & _MASK32, (base >> 32) & _MASK32)
    return torch.stack([(w >> 8).to(torch.float32) * 2.0**-24 for w in x[:3]],
                       dim=-1)


# -- fold-in --------------------------------------------------------------------

def restrict_snapshot(snap: ModelSnapshot, tokens, *, bucket: int = 64):
    """The snapshot restricted to the vocabulary rows a query batch
    touches, and the batch's tokens remapped to those rows (int32, on
    the snapshot's device): ``(sub_snapshot, remapped_tokens)``.

    Fold-in reads the tables only by row gathers of token ids and its
    uniforms depend only on seeds, so folding into the restricted
    snapshot is bitwise the full one, while the table bytes a batch
    stages fall from O(V W) to O(U W) for U distinct words. The rows are
    padded up to a multiple of ``bucket`` with copies of the first id's
    row (whose live slots are that row's), so a bounded set of shapes
    reaches the sweep. Host-side preprocessing, once per batch.
    """
    tok = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) else np.asarray(tokens)
    ids = np.unique(tok).astype(np.int64)
    if ids.size == 0:
        ids = np.zeros((1,), np.int64)
    lut = np.zeros((snap.V,), np.int32)
    lut[ids] = np.arange(ids.size, dtype=np.int32)
    pad = (-ids.size) % max(bucket, 1)
    if pad:
        ids = np.concatenate([ids, np.full((pad,), ids[0], ids.dtype)])
    rows = torch.from_numpy(ids).to(snap.device)
    sub = ModelSnapshot(
        phi=snap.phi[:, rows].contiguous(), psi=snap.psi,
        q_a=snap.q_a[rows].contiguous(), fpack=snap.fpack[rows].contiguous(),
        ipack=snap.ipack[rows].contiguous(), alpha=snap.alpha, it=snap.it,
    )
    remapped = torch.from_numpy(lut[tok].astype(np.int32)).to(snap.device)
    return sub, remapped


def init_z(tokens: torch.Tensor, mask: torch.Tensor, uniforms: torch.Tensor,
           fpack: torch.Tensor, ipack: torch.Tensor) -> torch.Tensor:
    """Initial assignments from the global term: one alias draw per token
    over its word's W slots, from uniform columns 1 and 2 (the sweep's
    global-branch columns). Reads only the drawn slot of each row."""
    w = fpack.shape[-1]
    t = tokens.to(torch.int64)
    slot = torch.clamp((uniforms[..., 1] * w).to(torch.int64), max=w - 1)
    keep = uniforms[..., 2] < fpack[t, 1, slot].to(torch.float32)
    slot = torch.where(keep, slot, ipack[t, 1, slot].to(torch.int64))
    z0 = ipack[t, 0, slot].to(torch.int32)
    return torch.where(mask, z0, 0).to(torch.int32)


def topic_mixture_from_m(m: torch.Tensor, psi: torch.Tensor,
                         alpha: torch.Tensor) -> torch.Tensor:
    """Posterior-mean document mixtures theta_d ∝ m_dk + alpha psi_k from
    the sweep-emitted (D, K) histogram. The normalizer is the document's
    exact token count plus sum_k alpha psi_k, and every other step is
    elementwise, so a row does not depend on its batch (a float sum over
    each row would: its order follows the tensor's shape on the card)."""
    apsi = alpha.to(torch.float32) * psi
    n = m.sum(1, dtype=torch.int64).to(torch.float32)
    return (m.to(torch.float32) + apsi[None, :]) / (n + apsi.sum())[:, None]


def topic_mixture(z: torch.Tensor, mask: torch.Tensor, psi: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """Mixtures from raw assignments (recounts m; prefer
    ``topic_mixture_from_m`` where a sweep already emitted m)."""
    return topic_mixture_from_m(doc_topic_counts(z, mask, psi.shape[0]), psi, alpha)


def foldin_from_uniforms(
    snap: ModelSnapshot, tokens: torch.Tensor, mask: torch.Tensor,
    u_init: torch.Tensor, u_sweeps: Iterable[torch.Tensor], *,
    impl: str = "cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a (D, L) batch into the frozen model on given uniforms: z
    from ``u_init``, then one sweep for each (D, L, 3) tensor of
    ``u_sweeps`` (a (S, D, L, 3) tensor iterates as S sweeps). Returns
    ``(theta (D, K), z (D, L))``; theta comes from the last sweep's
    emitted m (from a recount of z when there is no sweep)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown fold-in impl {impl!r}; one of {IMPLS}")
    z = init_z(tokens, mask, u_init, snap.fpack, snap.ipack)
    m = None
    for u in u_sweeps:
        z, m = C.z_step_conformant(impl, tokens, mask, z, u, snap.q_a,
                                   snap.fpack, snap.ipack, kk=snap.K)
    if m is None:
        m = doc_topic_counts(z, mask, snap.K)
    return topic_mixture_from_m(m, snap.psi, snap.alpha), z


def foldin_uniforms(base_seed: int, seeds: torch.Tensor, length: int, burnin: int):
    """The uniforms of a fold-in: sweep 0's (the z initialization), and
    an iterator that draws each burn-in sweep's just before it is used,
    so memory holds one sweep's worth."""
    u0 = sweep_uniforms(base_seed, seeds, torch.zeros_like(seeds), length)
    sweeps = (sweep_uniforms(base_seed, seeds, torch.full_like(seeds, s), length)
              for s in range(1, burnin + 1))
    return u0, sweeps


def foldin_docs(
    snap: ModelSnapshot, tokens: torch.Tensor, mask: torch.Tensor,
    seeds: torch.Tensor, base_seed: int, *, burnin: int = 16,
    impl: str = "cuda", return_z: bool = False,
):
    """Fold a (D, L) batch of unseen documents into the frozen model.

    Returns (D, K) topic mixtures (rows on the simplex); with
    ``return_z`` also the final assignments, on the uniforms of
    ``foldin_uniforms``.
    """
    u0, sweeps = foldin_uniforms(base_seed, seeds, tokens.shape[1], burnin)
    theta, z = foldin_from_uniforms(snap, tokens, mask, u0, sweeps, impl=impl)
    return (theta, z) if return_z else theta
