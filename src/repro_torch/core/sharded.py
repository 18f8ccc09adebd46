"""The sub-steps of one Gibbs iteration that the streaming driver calls
once per iteration and once per block (counterparts of the mesh-local
sub-steps of ``repro/core/sharded.py::ShardedHDP``), as plain functions
on tensors of one device: the port has no mesh, so the reference's
collectives (the row-sum psum, the table all-gathers, the delta
psum-scatter) are identities here.

  * ``phi_tables``: the Phi-step and the z-step's operands, once per
    iteration (``ShardedHDP._phi_tables``, ``phi_tables_fn`` and
    ``phi_tables_masked_fn``);
  * ``z_sweep_u``: one block's z-step on given uniforms
    (``ShardedHDP._z_sweep_u``);
  * ``block_stats``: the block's integer delta to n and its histogram dh
    (``ShardedHDP._block_stats``);
  * ``z_block``: the two together (``ShardedHDP.z_block_fn``);
  * ``z_lane``: one sweep lane's rows of a block
    (``ShardedHDP.z_lane_fn``), for the streamed trainer's lane mode.

The operands ``phi_tables`` returns depend on the z-step: ``(phi,)`` for
``dense``; for ``cuda`` either the supports ``(apsi, vals, ids)``, which
the kernel's prologue turns into alias rows (``in_kernel``), or the
tables ``(q_a, fpack, ipack)``, optionally built only for the rows a
``u_mask`` flags.
"""

from __future__ import annotations

import torch

from repro_torch.core import hdp as H
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda


def resolve_in_kernel(cfg: H.HDPConfig, device: torch.device) -> bool:
    """Whether the cuda z-step builds its alias rows in the kernel
    (``cfg.alias_in_kernel``; "auto" is on for the card); False for the
    dense z-step, which has no tables."""
    if cfg.z_impl != "cuda":
        return False
    return zops.resolve_alias_in_kernel(cfg.alias_in_kernel,
                                        on_cuda=device.type == "cuda")


def supports_masked_tables(cfg: H.HDPConfig, in_kernel: bool) -> bool:
    """True where a block-sparse table build can change anything: the
    cuda z-step in table mode (the dense z-step has no tables, and the
    prologue mode builds its alias rows per token) (counterpart of
    ``ShardedHDP.supports_masked_tables``)."""
    return cfg.z_impl == "cuda" and not in_kernel


def phi_tables(gen: torch.Generator, n, varphi, psi, cfg: H.HDPConfig, *,
               in_kernel: bool, u_mask: torch.Tensor | None = None):
    """The Phi-step and the z-step's operands: ``(phi, varphi, ztables)``.
    It draws exactly what ``gibbs_iteration``'s Phi-step draws."""
    phi, varphi = H.phi_step(gen, n, varphi, cfg)
    if cfg.z_impl == "dense":
        return phi, varphi, (phi,)
    if in_kernel:
        vals, ids = zops.build_word_sparse_supports(phi, cfg.bucket)
        apsi = torch.tensor(cfg.alpha, dtype=torch.float32, device=psi.device) * psi
        return phi, varphi, (apsi, vals, ids)
    if u_mask is not None:
        return phi, varphi, zops.build_word_sparse_tables_masked(
            phi, psi, cfg.alpha, cfg.bucket, u_mask)
    return phi, varphi, zops.build_word_sparse_tables(phi, psi, cfg.alpha,
                                                      cfg.bucket)


def z_sweep_u(cfg: H.HDPConfig, ztables, z, tokens, mask, psi, u, *,
              in_kernel: bool):
    """One block's z-step on the uniforms ``u`` (tokens.shape + (3,)):
    ``(z_new, m, dn)``, dn the (K, V) delta the cuda sweep emits, None
    for dense."""
    if cfg.z_impl == "dense":
        (phi,) = ztables
        z_new, m = H.z_step_dense(tokens, mask, z, phi, psi, cfg.alpha, u)
        return z_new, m, None
    if in_kernel:
        apsi, vals, ids = ztables
        return hdp_z_cuda(tokens, mask, z, u, kk=cfg.K, apsi=apsi, vals=vals,
                          ids=ids, emit_delta=True)
    q_a, fpack, ipack = ztables
    return hdp_z_cuda(tokens, mask, z, u, kk=cfg.K, q_a=q_a, fpack=fpack,
                      ipack=ipack, emit_delta=True)


def block_stats(cfg: H.HDPConfig, z_old, z_new, m, tokens, mask, dn=None):
    """The block's exact integer delta to n (``n + dn`` equals a recount)
    and its histogram dh from the sweep's m; both are sums over
    documents, so blocks merge by addition."""
    if dn is None:
        dn = H.delta_n(z_old, z_new, tokens, mask, cfg.K, cfg.V)
    return dn, H.d_histogram(m, cfg.hist_cap)


def z_block(cfg: H.HDPConfig, ztables, z, tokens, mask, psi, u, *,
            in_kernel: bool):
    """One block: ``(z_new, dn, dh)``."""
    z_new, m, dn = z_sweep_u(cfg, ztables, z, tokens, mask, psi, u,
                             in_kernel=in_kernel)
    dn, dh = block_stats(cfg, z, z_new, m, tokens, mask, dn)
    return z_new, dn, dh


def z_lane(cfg: H.HDPConfig, ztables, z, tokens, mask, psi, u_block, *,
           n_lanes: int, lane: int, in_kernel: bool):
    """One sweep lane of a block: ``(z_rows', dn_full, dh)`` over the
    lane's ``block_docs // n_lanes`` document rows (``z``, ``tokens`` and
    ``mask`` are those rows, on the lane's device).

    ``u_block`` is the whole block's ``(block_docs, L, 3)`` draw, made once
    on the driver thread; the lane takes rows ``[lane * rows, (lane + 1) *
    rows)`` of it, as the reference's lane slices the block-global draw
    from ``fold_in(k_ub, 0)``, so every lane count sweeps each token with
    the same uniforms. ``dn_full`` is the lane's whole (K, V) delta and
    ``dh`` its histogram: lanes merge by integer addition."""
    block_docs = u_block.shape[0]
    if block_docs % n_lanes:
        raise ValueError(f"block_docs={block_docs} not divisible by "
                         f"n_lanes={n_lanes}")
    rows = block_docs // n_lanes
    if not 0 <= lane < n_lanes or z.shape[0] != rows:
        raise ValueError(f"lane {lane} of {n_lanes} takes {rows} rows, "
                         f"got {z.shape[0]}")
    u = u_block[lane * rows:(lane + 1) * rows].to(z.device, non_blocking=True)
    return z_block(cfg, ztables, z, tokens, mask, psi, u, in_kernel=in_kernel)
