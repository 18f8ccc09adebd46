"""Plain PyTorch versions of the hdp_z sweep (counterparts of
``repro/kernels/hdp_z/ref.py``).

Same math over the same word-sparse tables, consuming the same (D, L, 3)
uniforms as the CUDA kernel in ``csrc/hdp_z.cu``, which must match them
bit for bit. They loop over token positions in Python and advance every
document at once, so the Gibbs order within a document is kept while
documents run in parallel. Every float sum over the W slots is taken in
the canonical left-to-right order (``core/alias.py``), with
``qb = c[W-1]``. Like every z-step they return ``(z_new, m)`` with m the
(D, K) sweep-carry histogram of z_new, plus the (K, V) ``delta_n`` of the
changed live tokens when ``emit_delta``.
"""

from __future__ import annotations

import torch

from repro_torch.core.alias import alias_build, ordered_cumsum, ordered_sum
from repro_torch.core.hdp import delta_n, doc_topic_counts


def _sweep(tokens, mask, z, uniforms, kk, row_fn):
    """The per-position Gibbs step shared by both modes. ``row_fn(v)``
    returns (vals, ids, qa, aprob, aalias) for the (D,) word ids v."""
    d, l = tokens.shape
    z_new = z.clone()
    m = doc_topic_counts(z, mask, kk)
    ar = torch.arange(d, device=tokens.device)
    for i in range(l):
        v = tokens[:, i].to(torch.int64)
        live = mask[:, i]
        z_old = z_new[:, i]
        live_i = live.to(torch.int32)
        m[ar, z_old.to(torch.int64)] -= live_i

        vals, ids, qa, aprob, aalias = row_fn(v)
        w = vals.shape[-1]
        ids64 = ids.to(torch.int64)
        wb = vals * m.gather(1, ids64).to(torch.float32)
        c = ordered_cumsum(wb)
        qb = c[:, -1]
        tot = qa + qb

        u1, u2, u3 = uniforms[:, i, 0], uniforms[:, i, 1], uniforms[:, i, 2]
        t = u1 * tot

        slot_b = torch.clamp((c < t[:, None]).sum(1), max=w - 1)
        k_doc = ids64.gather(1, slot_b[:, None])[:, 0]

        slot_a = torch.clamp((u2 * w).to(torch.int64), max=w - 1)[:, None]
        keep = u3[:, None] < aprob.gather(1, slot_a)
        slot_a = torch.where(keep, slot_a, aalias.gather(1, slot_a).to(torch.int64))
        k_glob = ids64.gather(1, slot_a)[:, 0]

        doc_branch = (t < qb) | (qa <= 0.0)
        k_new = torch.where(doc_branch, k_doc, k_glob).to(torch.int32)
        k_new = torch.where(live & (tot > 0), k_new, z_old)

        m[ar, k_new.to(torch.int64)] += live_i
        z_new[:, i] = k_new
    return z_new, m


def hdp_z_ref(
    tokens: torch.Tensor,    # (D, L) int32
    mask: torch.Tensor,      # (D, L) bool
    z: torch.Tensor,         # (D, L) int32
    uniforms: torch.Tensor,  # (D, L, 3) f32
    q_a: torch.Tensor,       # (V,) f32
    fpack: torch.Tensor,     # (V, 2, W) f32 [vals, aprob]
    ipack: torch.Tensor,     # (V, 2, W) int32 [ids, alias]
    *,
    kk: int,
    emit_delta: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Table mode: the word's packed rows carry its values, topic ids and
    alias table; ``q_a[v]`` is its term-(a) mass."""

    def rows(v):
        f = fpack[v].to(torch.float32)
        i = ipack[v].to(torch.int32)
        return f[:, 0], i[:, 0], q_a[v], f[:, 1], i[:, 1]

    z_new, m = _sweep(tokens, mask, z, uniforms, kk, rows)
    if not emit_delta:
        return z_new, m
    return z_new, m, delta_n(z, z_new, tokens, mask, kk, q_a.shape[0])


def hdp_z_ref_prologue(
    tokens: torch.Tensor,    # (D, L) int32
    mask: torch.Tensor,      # (D, L) bool
    z: torch.Tensor,         # (D, L) int32
    uniforms: torch.Tensor,  # (D, L, 3) f32
    apsi: torch.Tensor,      # (K,) f32, alpha * psi
    vals_all: torch.Tensor,  # (V, W) f32 raw support values
    ids_all: torch.Tensor,   # (V, W) int32 raw support topic ids
    *,
    kk: int,
    emit_delta: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Prologue mode: per token, ``wa = vals * apsi[ids]``,
    ``q_a = sum(wa)`` and the word's alias row are rebuilt from the raw
    supports. The row is built with the batched ``alias_build`` over the
    (D, W) rows of one position — bitwise ``alias_build_row_onehot``,
    which the kernel's per-slot build follows — so memory stays at
    (D, W) per position."""

    def rows(v):
        vals = vals_all[v].to(torch.float32)
        ids = ids_all[v].to(torch.int32)
        wa = vals * apsi[ids.to(torch.int64)]
        aprob, aalias = alias_build(wa)
        return vals, ids, ordered_sum(wa), aprob, aalias

    z_new, m = _sweep(tokens, mask, z, uniforms, kk, rows)
    if not emit_delta:
        return z_new, m
    return z_new, m, delta_n(z, z_new, tokens, mask, kk, vals_all.shape[0])
