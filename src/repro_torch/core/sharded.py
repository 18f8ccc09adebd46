"""The data-parallel HDP sampler over ``torch.distributed`` (counterpart
of ``repro/core/sharded.py::ShardedHDP``), and the sub-steps of one Gibbs
iteration that the streamed trainer (``core/streaming.py``) calls on one
device.

``ShardedHDP`` runs one process a rank on a ``Grid`` of named axes,
``(data, model)`` or ``(pod, data, model)`` (``launch/mesh.py``), laid
out as the reference lays its mesh:

  * documents  -> sharded over every axis (rank r sweeps row block r);
  * n, Phi     -> sharded over the vocabulary on ``model``, replicated
                  over the other axes; the PPU draw and the table build
                  run on the vocabulary shard;
  * Psi, l     -> replicated: drawn from one stream, the same on every
                  rank, so they are bitwise equal across ranks.

Collectives of one iteration (``core/collectives.py``), by the labels of
``Collectives.sent``:

  1. psum(row sums of varphi), int64          [model]
  2. all_gather(phi shard), dense z-step only  [model]
  3. all_gather(supports or tables)            [model]
  4. the z-sweep on the rank's documents       none
  5. psum_scatter(delta_n), int32              [model]
  6. psum(delta_n shard), int32                [pod, data]
  7. psum(d_hist), int32                       [all]

Randomness: the chain is grid-shaped, as the reference's is mesh-shaped;
it replays no JAX key. Each draw of iteration ``it`` comes from a
generator of its own, seeded from ``(seed, it, draw, index)``
(``stream``): the PPU draw from index = the model index (the same on
every rank of a ``model`` column, as ``fold_in(k_phi, midx)``), the
z-step uniforms from index = the rank (``fold_in(k_u, dev_idx)``), l
then Psi from index 0. ``iteration`` also takes the varphi shard, the
uniforms and the l/Psi generator from the caller, so a test feeds any
grid the reference's draws, or the one-process chain's.

The module-level functions are the sub-steps on one device, with the
reference's collectives as identities; the streamed trainer calls them
once per iteration and once per block:

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

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hdp as H
from repro_torch.core.collectives import Collectives
from repro_torch.core.polya_urn import ppu_counts, ppu_counts_budgeted
from repro_torch.core.stick import gem_prior_sample, sample_l, sample_psi
from repro_torch.device import synchronize
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda
from repro_torch.launch.mesh import Grid
from repro_torch.train import checkpoint as CKPT


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


# --------------------------------------------------------------------------
# the data-parallel sampler
# --------------------------------------------------------------------------

DRAWS = ("phi", "u", "l_psi")
# the vocabulary axis, the grid's last (``launch/mesh.py``)
MODEL = "model"

# labels of Collectives.sent, by the step of the module docstring
BYTES_ROW_SUMS = "1 psum row sums [model]"
BYTES_PHI = "2 all_gather phi [model]"
BYTES_TABLES = "3 all_gather tables [model]"
BYTES_DN_SCATTER = "5 psum_scatter dn [model]"
BYTES_DN_PSUM = "6 psum dn [pod, data]"
BYTES_DH = "7 psum dh [all]"


def iteration_bytes(cfg: H.HDPConfig, grid: Grid, *, in_kernel: bool,
                    compact_tables: bool = False,
                    phi_dtype: torch.dtype = torch.float32) -> dict[str, int]:
    """The bytes one rank hands each collective in one
    ``ShardedHDP.iteration``, by the labels above, from the config and
    the grid alone (every rank's are the same): the row sums as int64,
    the Phi shard (dense z-step) or the supports (prologue mode, float32
    values and int32 ids of W slots) or the tables (q_a float32, and
    value/probability and id/alias packs of W slots, 4 bytes a slot or 2
    compact) of the rank's V / model words, dn whole (K, V) int32 into the
    scatter and its shard over the other axes, and dh (K, hist_cap + 1)
    int32."""
    m = grid.size(MODEL)
    vm, w = cfg.V // m, min(cfg.bucket, cfg.K)
    out = {BYTES_ROW_SUMS: cfg.K * 8, BYTES_DN_SCATTER: cfg.K * cfg.V * 4}
    if grid.axes[:-1]:
        out[BYTES_DN_PSUM] = cfg.K * vm * 4
    out[BYTES_DH] = cfg.K * (cfg.hist_cap + 1) * 4
    if cfg.z_impl == "dense":
        out[BYTES_PHI] = cfg.K * vm * phi_dtype.itemsize
    elif in_kernel:
        out[BYTES_TABLES] = vm * w * (4 + 4)
    else:
        item = 2 if compact_tables else 4
        out[BYTES_TABLES] = vm * 4 + 2 * (vm * 2 * w * item)
    return out


def stream(seed: int, it: int, draw: str, index: int,
           device: torch.device | str) -> torch.Generator:
    """The generator of one draw of iteration ``it``: ``draw`` is one of
    ``DRAWS``, ``index`` the model index (phi), the rank (u) or 0 (l and
    Psi). A pure function of its arguments, so every rank that asks for
    the same draw gets the same stream."""
    words = np.random.SeedSequence(
        [int(seed), int(it), DRAWS.index(draw), int(index)]).generate_state(2)
    return H.make_generator(int(words[0]) << 32 | int(words[1]), device)


class ShardState(NamedTuple):
    """One rank's part of the sampler's state."""

    z: torch.Tensor       # (D / ranks, L) int32: the rank's documents
    n: torch.Tensor       # (K, V / model) int32: its vocabulary columns
    phi: torch.Tensor     # (K, V / model) phi_dtype
    varphi: torch.Tensor  # (K, V / model) int32
    psi: torch.Tensor     # (K,) f32, the same on every rank
    l: torch.Tensor       # (K,) int32, the same on every rank
    seed: int
    it: int


class ShardedHDP:
    """The HDP sampler on a grid of ranks, one process a rank.

    ``comm`` holds the grid, the backend and the rank's device. ``cfg.V``
    must divide by the ``model`` axis (pad the vocabulary, as
    ``launch/train.py`` does). ``z_impl`` is ``dense`` or ``cuda`` (the
    reference's ``pallas``); ``compact_tables`` packs the cuda z-step's
    tables in bf16/int16; ``phi_dtype`` is the dtype Phi is stored and,
    for the dense z-step, gathered in. The reference's ``gather_tables``
    is not ported: it selects between table builds of its ``sparse``
    z-step, which the port does not have (``core/hdp.py::Z_IMPLS``).

    After each ``iteration``, ``last`` holds its fully reduced histogram
    ``dh`` and the bytes this rank handed to each collective.
    """

    def __init__(self, comm: Collectives, cfg: H.HDPConfig, *,
                 phi_dtype: torch.dtype = torch.float32,
                 compact_tables: bool = False):
        grid: Grid = comm.grid
        if grid.axes[-1] != MODEL:
            raise ValueError(f"the grid's last axis must be {MODEL!r}: {grid.axes}")
        m = grid.size(MODEL)
        if cfg.V % m:
            raise ValueError(f"V={cfg.V} must divide model axis {m}")
        H.validate_bucket(cfg, 0)
        if cfg.exact_phi:
            raise ValueError("ShardedHDP draws Phi by the PPU; exact_phi "
                             "runs in core/hdp.py::gibbs_iteration")
        self.comm = comm
        self.grid = grid
        self.cfg = cfg
        self.device = comm.device
        self.repl_axes = grid.axes[:-1]
        self.phi_dtype = phi_dtype
        self.compact_tables = compact_tables
        self.midx = grid.index(MODEL)
        cols = cfg.V // m
        self.vocab_cols = slice(self.midx * cols, (self.midx + 1) * cols)
        self.in_kernel = cfg.z_impl == "cuda" and zops.resolve_alias_in_kernel(
            cfg.alias_in_kernel, on_cuda=self.device.type == "cuda",
            compact=compact_tables)
        self.last: dict = {}

    # -- shard bounds (counterparts of ``specs``) -----------------------------
    def doc_rows(self, d: int) -> slice:
        """The rank's document rows of a (d, L) corpus: block ``rank`` of
        ``world_size`` equal blocks (documents over every axis)."""
        ranks = self.grid.world_size
        if d % ranks:
            raise ValueError(f"{d} documents do not split over {ranks} ranks: "
                             f"pad them (data/corpus.py::shard_balanced)")
        per = d // ranks
        return slice(self.grid.rank * per, (self.grid.rank + 1) * per)

    # -- the draws --------------------------------------------------------------
    def draw_varphi(self, state: ShardState) -> torch.Tensor:
        """Step 1's PPU counts on the vocabulary shard, from the stream of
        the model index: the same on every rank of a ``model`` column."""
        gen = stream(state.seed, state.it, "phi", self.midx, self.device)
        if self.cfg.ppu_nnz_budget is not None:
            return ppu_counts_budgeted(gen, state.n, self.cfg.beta,
                                       self.cfg.ppu_nnz_budget)
        return ppu_counts(gen, state.n, self.cfg.beta)

    def draw_uniforms(self, state: ShardState, shape) -> torch.Tensor:
        """The z-step's (D_rank, L, 3) uniforms, from the rank's stream."""
        gen = stream(state.seed, state.it, "u", self.grid.rank, self.device)
        return torch.rand(tuple(shape) + (3,), generator=gen,
                          device=self.device, dtype=torch.float32)

    def l_psi_generator(self, state: ShardState) -> torch.Generator:
        """The generator l and then Psi are drawn from: one stream for
        every rank."""
        return stream(state.seed, state.it, "l_psi", 0, self.device)

    # -- the sub-steps ----------------------------------------------------------
    def phi_step(self, varphi_shard: torch.Tensor) -> torch.Tensor:
        """Step 1: phi on the vocabulary shard. The row sums are reduced
        over ``model`` as integers and cast to float32 after, so the shard
        is bitwise ``ppu_normalize`` of the whole varphi at any grid."""
        row = self.comm.psum(varphi_shard.sum(1), MODEL,
                             label=BYTES_ROW_SUMS)
        row = row.to(torch.float32)[:, None]
        phi = varphi_shard.to(torch.float32) / torch.clamp(row, min=1.0)
        return phi.to(self.phi_dtype)

    def ztables(self, phi_shard: torch.Tensor, psi: torch.Tensor,
                u_mask_shard: torch.Tensor | None = None):
        """Steps 2-3: the z-step's operands, built on the vocabulary shard
        and gathered over ``model``: ``(phi,)`` for dense (gathered in
        ``phi_dtype``); in prologue mode only the supports ``(apsi, vals,
        ids)``; in table mode ``(q_a, fpack, ipack)``, compact or not, and
        with ``u_mask_shard`` ((V / model,) bool) built only for the rows
        it flags (the rest zero). The mask changes nothing where there are
        no tables to skip (dense, prologue mode)."""
        cfg = self.cfg
        if cfg.z_impl == "dense":
            return (self.comm.all_gather(phi_shard, MODEL, 1, label=BYTES_PHI),)
        phi32 = phi_shard.to(torch.float32)
        if self.in_kernel:
            shards = zops.build_word_sparse_supports(phi32, cfg.bucket)
            vals, ids = (self.comm.all_gather(t, MODEL, 0, label=BYTES_TABLES)
                         for t in shards)
            apsi = torch.tensor(cfg.alpha, dtype=torch.float32,
                                device=psi.device) * psi
            return apsi, vals, ids
        if u_mask_shard is not None:
            shards = zops.build_word_sparse_tables_masked(
                phi32, psi, cfg.alpha, cfg.bucket, u_mask_shard,
                compact=self.compact_tables)
        else:
            shards = zops.build_word_sparse_tables(
                phi32, psi, cfg.alpha, cfg.bucket, compact=self.compact_tables)
        return tuple(self.comm.all_gather(t, MODEL, 0, label=BYTES_TABLES)
                     for t in shards)

    def z_sweep_u(self, ztables, z, tokens, mask, psi, u):
        """Step 4 on the rank's documents (no communication): ``(z_new, m,
        dn)``, dn the (K, V) delta the cuda sweep emits, None for dense."""
        return z_sweep_u(self.cfg, ztables, z, tokens, mask, psi, u,
                         in_kernel=self.in_kernel)

    def block_stats(self, z_old, z_new, m, tokens, mask, dn=None):
        """Steps 5-7: ``(dn_shard, dh)``, the exact integer delta to the
        rank's columns of n summed over every rank's documents, and the
        histogram of every document."""
        cfg = self.cfg
        if dn is None:
            dn = H.delta_n(z_old, z_new, tokens, mask, cfg.K, cfg.V)
        dn_shard = self.comm.psum_scatter(dn, MODEL, 1,
                                          label=BYTES_DN_SCATTER)
        if self.repl_axes:
            dn_shard = self.comm.psum(dn_shard, self.repl_axes,
                                      label=BYTES_DN_PSUM)
        dh = self.comm.psum(H.d_histogram(m, cfg.hist_cap), self.grid.axes,
                            label=BYTES_DH)
        return dn_shard, dh

    def iteration_bytes(self) -> dict[str, int]:
        """``iteration_bytes`` for this sampler: what ``last["bytes"]``
        holds after each ``iteration``."""
        return iteration_bytes(self.cfg, self.grid, in_kernel=self.in_kernel,
                               compact_tables=self.compact_tables,
                               phi_dtype=self.phi_dtype)

    # -- the iteration ----------------------------------------------------------
    def iteration(self, state: ShardState, tokens, mask, *, varphi=None,
                  u=None, gen=None, timings: dict | None = None) -> ShardState:
        """One Gibbs iteration (Algorithm 2) on the rank's shards.

        ``varphi`` (the PPU counts of the rank's columns), ``u`` (its
        documents' uniforms) and ``gen`` (l, then Psi) are drawn from the
        state's streams unless given. With ``timings``, the card is
        synchronized around each sub-step and its wall ms added there."""
        cfg = self.cfg
        self.comm.sent.clear()
        split = _Split(timings, self.device)
        with split("draw_phi"):
            if varphi is None:
                varphi = self.draw_varphi(state)
        with split("phi_step"):
            phi = self.phi_step(varphi)
        with split("tables"):
            ztables = self.ztables(phi, state.psi)
        with split("draw_u"):
            if u is None:
                u = self.draw_uniforms(state, tokens.shape)
        with split("z_sweep"):
            z, m, dn = self.z_sweep_u(ztables, state.z, tokens, mask,
                                      state.psi, u)
        with split("stats"):
            dn_shard, dh = self.block_stats(state.z, z, m, tokens, mask, dn)
            n = state.n + dn_shard
        with split("l_psi"):
            if gen is None:
                gen = self.l_psi_generator(state)
            l = sample_l(gen, dh, state.psi, cfg.alpha)
            psi = sample_psi(gen, l, cfg.gamma)
        self.last = {"dh": dh, "bytes": dict(self.comm.sent)}
        return ShardState(z=z, n=n, phi=phi, varphi=varphi, psi=psi, l=l,
                          seed=state.seed, it=state.it + 1)

    # -- state --------------------------------------------------------------------
    def init_state(self, seed: int, tokens, mask) -> ShardState:
        """The single-topic init (paper Section 3): ``core/hdp.py::init_state``
        of the whole corpus, sliced. n is the psum of the ranks' counts; Phi
        and Psi come from the generator of ``seed`` on every rank, as the
        one-process init draws them."""
        cfg = self.cfg
        z = torch.zeros_like(tokens)
        n = self.comm.psum(H.count_n(z, tokens, mask, cfg.K, cfg.V),
                           self.grid.axes)
        gen = H.make_generator(seed, self.device)
        phi, varphi = H.phi_step(gen, n, None, cfg)
        psi = gem_prior_sample(gen, cfg.K, cfg.gamma)
        cols = self.vocab_cols
        return ShardState(
            z=z, n=n[:, cols].contiguous(),
            phi=phi[:, cols].to(self.phi_dtype).contiguous(),
            varphi=varphi[:, cols].contiguous(), psi=psi,
            l=torch.zeros((cfg.K,), dtype=torch.int32, device=self.device),
            seed=int(seed), it=0)

    def gather_state(self, state: ShardState):
        """``(z, n)`` whole on rank 0 (documents in rank order), None on
        the other ranks; every rank must call it."""
        z = self.comm.all_gather(state.z, self.grid.axes, 0)
        n = self.comm.all_gather(state.n, MODEL, 1)
        return (z, n) if self.grid.rank == 0 else None

    # -- checkpoints at logical shape ----------------------------------------------
    def save(self, ckpt_dir: str, state: ShardState, *, keep: int = 3) -> str | None:
        """Checkpoint the state at step ``state.it`` at logical shape, as
        the reference's ``CKPT.save`` stores a sharded array: z (D, L) with
        the documents in rank order, n, phi and varphi (K, V) gathered
        over ``model``, psi, l, the seed, the iteration and the number of
        ranks whose document order z follows. Rank 0 writes, a leaf at a
        time; every rank must call it. Returns the path on rank 0."""
        comm, everyone = self.comm, self.grid.axes

        def items():
            yield "z", comm.all_gather(state.z, everyone, 0)
            for f in ("n", "phi", "varphi"):
                yield f, comm.all_gather(getattr(state, f), MODEL, 1)
            yield "psi", state.psi
            yield "l", state.l
            yield "seed", np.int64(state.seed)
            yield "it", np.int32(state.it)
            yield "ranks", np.int32(self.grid.world_size)

        path = None
        if self.grid.rank == 0:
            path = CKPT.save_items(ckpt_dir, state.it, items(), keep=keep)
        else:
            for _ in items():
                pass
        if self.grid.world_size > 1:
            torch.distributed.barrier()
        return path

    def restore(self, ckpt_dir: str, max_len: int, step: int | None = None, *,
                doc_ranks: int | None = None) -> ShardState | None:
        """This rank's slices of a ``save`` checkpoint (by default the
        latest; None when there is none), on any grid whose documents and
        vocabulary split the stored shapes: rows ``doc_rows`` of z and
        columns ``vocab_cols`` of n, phi and varphi. z's rows follow the
        document order of the run that saved it (``ranks`` in the
        checkpoint); with ``doc_ranks``, the caller's corpus order (the
        ranks it was ``shard_balanced`` over) must be the same."""
        if step is None:
            step = CKPT.latest_step(ckpt_dir)
            if step is None:
                return None
        saved = int(CKPT.load_array(ckpt_dir, step, "ranks"))
        if doc_ranks is not None and saved != doc_ranks:
            raise ValueError(f"the checkpoint's documents are ordered for {saved} "
                             f"ranks (shard_balanced), this run's for {doc_ranks}: "
                             f"resume on {saved} ranks")
        shapes = CKPT.stored_shapes(ckpt_dir, step)
        d, length = shapes["z"]
        if length != max_len or shapes["n"] != (self.cfg.K, self.cfg.V):
            raise ValueError(f"checkpoint z {shapes['z']} and n {shapes['n']} "
                             f"do not match max_len {max_len} and (K, V) "
                             f"({self.cfg.K}, {self.cfg.V})")
        rows, cols = self.doc_rows(d), self.vocab_cols

        def load(key, index=()):
            return CKPT.load_slice(ckpt_dir, step, key, index).to(self.device)

        return ShardState(
            z=load("z", (rows,)), n=load("n", (slice(None), cols)),
            phi=load("phi", (slice(None), cols)).to(self.phi_dtype),
            varphi=load("varphi", (slice(None), cols)), psi=load("psi"),
            l=load("l"), seed=int(CKPT.load_array(ckpt_dir, step, "seed")),
            it=int(CKPT.load_array(ckpt_dir, step, "it")))

    def diagnostics(self, state: ShardState, tokens, mask) -> dict:
        """The training CLI's log line: ``log_marginal_likelihood`` (the ranks'
        float32 sums added over the grid), the active topics and the flag
        topic's tokens. Every rank must call it."""
        cfg = self.cfg
        phi = self.comm.all_gather(state.phi, MODEL, 1)
        local = H.log_marginal_likelihood(
            H.HDPState(z=state.z, n=None, phi=phi.to(torch.float32), varphi=None,
                       psi=state.psi, l=None, gen=None, it=state.it),
            tokens, mask, cfg)
        ll = self.comm.psum(local.reshape(1), self.grid.axes)
        rows = self.comm.psum(state.n.sum(1), MODEL)
        return {"log_lik": float(ll[0]), "active_topics": int((rows > 0).sum()),
                "flag_tokens": int(rows[-1])}


class _Split:
    """Wall ms of named sub-steps, the card synchronized around each; a
    no-op without a dict to add them to."""

    def __init__(self, out: dict | None, device: torch.device):
        self.out, self.device = out, device

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.out is None:
            yield
            return
        synchronize(self.device)
        t0 = time.perf_counter()
        yield
        synchronize(self.device)
        self.out[name] = self.out.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
