"""Table builders and z-step entry points for the hdp_z kernel
(counterpart of ``repro/kernels/hdp_z/ops.py``).

``build_word_sparse_tables`` converts a (K, V) Phi into the kernel's
word-sparse layout: per word, the top-W topics by phi value (the whole
non-zero set when W >= max column nnz), the word's alias table over
those W slots, and its term-(a) mass q_a. ``build_word_sparse_supports``
gives only the raw top-W values and ids, for the kernel's prologue mode,
which builds q_a and the alias entry per token.
"""

from __future__ import annotations

import torch

from repro_torch.core.alias import alias_build, ordered_sum
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda
from repro_torch.kernels.hdp_z.ref import hdp_z_ref, hdp_z_ref_prologue


def resolve_alias_in_kernel(
    explicit: str | bool | None = "auto", *, on_cuda: bool,
    compact: bool = False,
) -> bool:
    """Whether the alias entries are built in the kernel (prologue mode).

    An explicit ``"on"``/``"off"`` (or bool) wins; ``"auto"`` (or None)
    is on exactly for CUDA tensors and off for CPU tensors, as the JAX
    counterpart is on exactly when its kernel is compiled. Both modes
    give bitwise the same sweep; PERF.md holds the z-step times of each
    on the card. Prologue mode reads raw f32 supports, so an explicit
    "on" with compact tables raises and "auto" with them resolves to off.
    """
    if explicit not in (None, True, False, "auto", "on", "off"):
        raise ValueError(f"unknown alias_in_kernel mode {explicit!r}")
    if explicit in ("on", True):
        if compact:
            raise ValueError("alias_in_kernel='on' requires compact=False "
                             "(the prologue reads raw f32 supports)")
        return True
    if explicit in ("off", False):
        return False
    return on_cuda and not compact


def _apsi(alpha: float, psi: torch.Tensor) -> torch.Tensor:
    return torch.tensor(alpha, dtype=torch.float32, device=psi.device) * psi


def _word_supports(pt: torch.Tensor, w: int, order: str):
    """Per-word top-W supports of a (V, K) phi-transpose: (vals, ids).

    A stable descending sort, so tied values keep ascending topic order,
    as ``jax.lax.top_k`` does (``torch.topk`` orders ties differently).
    Row-independent, like the reference.
    """
    if order not in ("value", "topic"):
        raise ValueError(f"unknown table order {order!r}")
    w = min(w, pt.shape[-1])
    vals, idx = torch.sort(pt, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :w], idx[..., :w]
    if order == "topic":
        perm = torch.argsort(idx, dim=-1, stable=True)
        vals = vals.gather(-1, perm)
        idx = idx.gather(-1, perm)
    return vals.to(torch.float32).contiguous(), idx.to(torch.int32).contiguous()


def build_word_sparse_supports(
    phi: torch.Tensor, w: int, order: str = "value",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw word-sparse supports ``(vals (V, W) f32, ids (V, W) int32)``
    for prologue mode: no alias tables, no q_a."""
    return _word_supports(phi.T, w, order)


def build_word_sparse_tables(
    phi: torch.Tensor, psi: torch.Tensor, alpha: float, w: int,
    compact: bool = False, order: str = "value",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q_a (V,), fpack (V, 2, W), ipack (V, 2, W)).

    Exact when every word appears in <= W topics; otherwise the smallest
    phi entries beyond W are dropped (see ``max_column_nnz``).
    ``compact=True`` packs fpack in bf16 and ipack in int16 (K <= 32768,
    enforced); the plain sweep and both CUDA routes read them. ``order`` is "value" (sorted by phi, the default) or
    "topic" (ascending topic id, the conformance layout: every
    left-to-right partial sum over the slots then equals the same sum
    over a dense ascending-topic sweep). q_a and the alias rows use the
    canonical left-to-right sum order, as the kernel's prologue does.
    """
    if compact and phi.shape[0] > 2**15:
        raise ValueError(
            f"compact int16 topic ids need K <= 32768, got K={phi.shape[0]}"
        )
    vals, ids = _word_supports(phi.T, w, order)
    wa = vals * _apsi(alpha, psi)[ids.to(torch.int64)]
    q_a = ordered_sum(wa)
    aprob, aalias = alias_build(wa)
    if compact:
        fpack = torch.stack(
            [vals.to(torch.bfloat16), aprob.to(torch.bfloat16)], dim=1)
        ipack = torch.stack([ids.to(torch.int16), aalias.to(torch.int16)], dim=1)
    else:
        fpack = torch.stack([vals, aprob], dim=1)
        ipack = torch.stack([ids, aalias], dim=1)
    return q_a.contiguous(), fpack.contiguous(), ipack.contiguous()


def build_word_sparse_tables_masked(
    phi: torch.Tensor, psi: torch.Tensor, alpha: float, w: int,
    u_mask: torch.Tensor, compact: bool = False, order: str = "value",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block-sparse ``build_word_sparse_tables`` (counterpart of the
    reference's ``build_word_sparse_tables_masked``): only the vocabulary
    rows flagged in ``u_mask`` (V,) bool are built, the rest stay zero.

    Every step of the build is row-independent, so a flagged row is
    bitwise the dense build's, and a sweep over tokens whose words are
    flagged is bitwise unchanged; the cost falls from O(V K) to O(rows K).
    The reference takes a static ``cap`` on the flagged rows (its fill
    slots alias row 0); here the rows are gathered at their count.
    """
    v = phi.shape[1]
    rows = torch.nonzero(u_mask, as_tuple=True)[0]
    q_sub, f_sub, i_sub = build_word_sparse_tables(
        phi[:, rows], psi, alpha, w, compact=compact, order=order)
    q_a = torch.zeros((v,), dtype=q_sub.dtype, device=phi.device)
    fpack = torch.zeros((v,) + f_sub.shape[1:], dtype=f_sub.dtype, device=phi.device)
    ipack = torch.zeros((v,) + i_sub.shape[1:], dtype=i_sub.dtype, device=phi.device)
    q_a[rows] = q_sub
    fpack[rows] = f_sub
    ipack[rows] = i_sub
    return q_a, fpack, ipack


def max_column_nnz(phi: torch.Tensor) -> int:
    """Largest number of topics any single word appears in (for W)."""
    return int((phi > 0).sum(0).max())


def delta_sparsify(dn: torch.Tensor, cap: int):
    """COO extraction of a sweep's integer delta_n on its device: the
    device half of the sparse bit-packed exchange (``data/deltawire.py``)
    (counterpart of ``repro/kernels/hdp_z/ops.py::delta_sparsify``).

    Returns ``(idx, val, nnz)``: ``idx`` the first ``cap`` flat C-order
    nonzero positions (ascending, zero-padded past ``nnz``), ``val`` the
    deltas there (past ``nnz`` the delta at position 0, as the
    reference's padded gather gives), ``nnz`` the true count as an int.
    ``torch.nonzero`` has no static size, so this waits for the current
    stream: the sweep lanes call it on their own threads, which wait on
    their streams anyway. Only ``idx[:nnz]`` and ``val[:nnz]`` need to
    cross to the host (``deltawire.pack_coo``)."""
    flat = dn.reshape(-1)
    nz = torch.nonzero(flat).reshape(-1)
    nnz = int(nz.numel())
    idx = torch.zeros((cap,), dtype=torch.int32, device=dn.device)
    take = min(nnz, cap)
    idx[:take] = nz[:take].to(torch.int32)
    return idx, flat[idx.to(torch.int64)], nnz


def z_step_cuda(
    tokens, mask, z, phi, psi, alpha, uniforms, bucket, *,
    order="value", compact=False, emit_delta=False, alias_in_kernel="auto",
):
    """Drop-in z-step (counterpart of ``z_step_pallas``): builds the
    tables (or, in prologue mode, only the supports) with W = bucket and
    runs ``hdp_z_cuda``. Returns ``(z_new, m)``, plus the (K, V)
    ``delta_n`` when ``emit_delta``."""
    in_kernel = resolve_alias_in_kernel(
        alias_in_kernel, on_cuda=tokens.is_cuda, compact=compact)
    if in_kernel:
        vals, ids = build_word_sparse_supports(phi, bucket, order=order)
        return hdp_z_cuda(
            tokens, mask, z, uniforms, kk=phi.shape[0],
            apsi=_apsi(alpha, psi), vals=vals, ids=ids, emit_delta=emit_delta,
        )
    q_a, fpack, ipack = build_word_sparse_tables(
        phi, psi, alpha, bucket, compact=compact, order=order)
    return hdp_z_cuda(
        tokens, mask, z, uniforms, kk=phi.shape[0],
        q_a=q_a, fpack=fpack, ipack=ipack, emit_delta=emit_delta,
    )


def z_step_ref(
    tokens, mask, z, phi, psi, alpha, uniforms, bucket, *,
    order="value", compact=False, emit_delta=False, alias_in_kernel="off",
):
    """Same math through the plain versions on any device; returns
    ``(z_new, m)`` (plus ``delta_n`` when ``emit_delta``)."""
    if resolve_alias_in_kernel(alias_in_kernel, on_cuda=False, compact=compact):
        vals, ids = build_word_sparse_supports(phi, bucket, order=order)
        return hdp_z_ref_prologue(
            tokens, mask, z, uniforms, _apsi(alpha, psi), vals, ids,
            kk=phi.shape[0], emit_delta=emit_delta,
        )
    q_a, fpack, ipack = build_word_sparse_tables(
        phi, psi, alpha, bucket, compact=compact, order=order)
    return hdp_z_ref(
        tokens, mask, z, uniforms, q_a, fpack, ipack, kk=phi.shape[0],
        emit_delta=emit_delta,
    )
