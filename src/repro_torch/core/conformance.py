"""z-step conformance contract (counterpart of ``repro/core/conformance.py``):
one canonical uniform->topic map, three execution strategies, bitwise-equal
results.

  * ``dense``  — O(K) per token: the document term is accumulated over a
                 dense ascending-topic K vector;
  * ``sparse`` — O(W) per token: the plain sweep over the table slots
                 (``kernels/hdp_z/ref.py::hdp_z_ref``);
  * ``cuda``   — ``hdp_z_cuda``: the CUDA kernel on CUDA tensors, the
                 plain sweep on CPU tensors.

Agreement relies on tables built with ``order="topic"`` that cover each
word's full support (W >= max_column_nnz(phi)): every left-to-right
partial sum over the slots then equals the same sum over the dense K
vector, since absent topics add exactly 0.0.
"""

from __future__ import annotations

import torch

from repro_torch.core.alias import ordered_cumsum
from repro_torch.core.hdp import doc_topic_counts
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda
from repro_torch.kernels.hdp_z.ref import hdp_z_ref


def build_tables(phi: torch.Tensor, psi: torch.Tensor, alpha: float, w: int):
    """Canonical (topic-ordered) word-sparse tables shared by all
    strategies: (q_a (V,), fpack (V, 2, W), ipack (V, 2, W))."""
    return zops.build_word_sparse_tables(phi, psi, alpha, w, order="topic")


def z_step_dense_tables(
    tokens: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
    uniforms: torch.Tensor, q_a: torch.Tensor, fpack: torch.Tensor,
    ipack: torch.Tensor, *, kk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense execution of the canonical map: the document term is a
    dense (K,) accumulation in ascending topic order; the global (alias)
    term is read from the shared table."""
    d, l = tokens.shape
    w = fpack.shape[-1]
    z_new = z.clone()
    m = doc_topic_counts(z, mask, kk)
    ar = torch.arange(d, device=tokens.device)
    for i in range(l):
        v = tokens[:, i].to(torch.int64)
        live = mask[:, i]
        live_i = live.to(torch.int32)
        z_old = z_new[:, i]
        m[ar, z_old.to(torch.int64)] -= live_i

        vals = fpack[v, 0].to(torch.float32)
        ids = ipack[v, 0].to(torch.int64)
        # dense (D, K) expansion: a word's ids are distinct
        phi_v = torch.zeros((d, kk), dtype=torch.float32, device=tokens.device)
        phi_v.scatter_(1, ids, vals)
        wb = phi_v * m.to(torch.float32)
        c = ordered_cumsum(wb)
        qb = c[:, -1]
        qa = q_a[v]
        tot = qa + qb

        u1, u2, u3 = uniforms[:, i, 0], uniforms[:, i, 1], uniforms[:, i, 2]
        t = u1 * tot
        k_doc = torch.clamp((c < t[:, None]).sum(1), max=kk - 1)

        aprob = fpack[v, 1].to(torch.float32)
        aalias = ipack[v, 1].to(torch.int64)
        slot_a = torch.clamp((u2 * w).to(torch.int64), max=w - 1)[:, None]
        keep = u3[:, None] < aprob.gather(1, slot_a)
        slot_a = torch.where(keep, slot_a, aalias.gather(1, slot_a))
        k_glob = ids.gather(1, slot_a)[:, 0]

        doc_branch = (t < qb) | (qa <= 0.0)
        k_new = torch.where(doc_branch, k_doc, k_glob).to(torch.int32)
        k_new = torch.where(live & (tot > 0), k_new, z_old)
        m[ar, k_new.to(torch.int64)] += live_i
        z_new[:, i] = k_new
    return z_new, m


def z_step_conformant(
    impl: str, tokens: torch.Tensor, mask: torch.Tensor, z: torch.Tensor,
    uniforms: torch.Tensor, q_a: torch.Tensor, fpack: torch.Tensor,
    ipack: torch.Tensor, *, kk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the canonical z-step via the chosen strategy; returns
    ``(z_new, m)``."""
    if impl == "dense":
        return z_step_dense_tables(
            tokens, mask, z, uniforms, q_a, fpack, ipack, kk=kk)
    if impl == "sparse":
        return hdp_z_ref(tokens, mask, z, uniforms, q_a, fpack, ipack, kk=kk)
    if impl == "cuda":
        return hdp_z_cuda(tokens, mask, z, uniforms, kk=kk,
                          q_a=q_a, fpack=fpack, ipack=ipack)
    raise ValueError(f"unknown conformance impl {impl!r}")
