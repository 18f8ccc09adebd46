"""Block-streamed Gibbs driver (counterpart of the single-device path of
``repro/core/streaming.py``): corpora larger than the card's memory, and
with the disk slab store larger than host memory.

``StreamingHDP`` sweeps a ``ShardedCorpusStore`` block by block within
each Gibbs iteration:

  * the model state (n, phi, varphi, psi, l) stays on the card across
    blocks, O(K V) whatever the corpus size; n advances by the sweep's
    exact integer delta, ``n += dn`` in int32, with no recount;
  * z lives in a ``ZSlabStore`` (data/zstore.py), in host RAM or as
    per-block version files on disk, packed to uint8/uint16
    (``z_pack="auto"``) for the copies and the files;
  * the Phi-step and the z-step's tables run once per iteration
    (core/sharded.py), as Phi and Psi stay fixed during the z-step; with
    ``block_sparse_tables`` the tables are built only for the words the
    corpus holds ("auto": below half the vocabulary, in table mode).

Per block the pipeline overlaps four stages:

    read  block b+2           (BlockPrefetcher's pre thread: its rows
                               and z slab, the slab from disk for the
                               disk store, into a pinned host buffer)
    H2D   stage block b+1     (its stage thread: the buffer copied on a
                               side CUDA stream, an event recorded
                               after the copy)
    sweep block b             (the driver thread queues it on the
                               current stream, after waiting on b's event)
    D2H   write back b-1      (BlockWriteback's thread: a side stream
                               that waits on the sweep's event)

A pinned buffer is refilled only after its last copy's event completed;
a staged tensor is marked as used on the sweep's stream (``record_stream``)
so the allocator does not hand its memory to the next copy early; each
worker thread sets the card and stream it uses, which are per thread.

Randomness. torch cannot replay the reference's ``fold_in`` keys, so the
port keeps its invariants on one ``torch.Generator`` (``state.gen``),
drawn on the driver thread only, in the order of ``gibbs_iteration``:
Phi, then each block's (DB, L, 3) uniforms in block order, then l, then
Psi. A one-block stream therefore consumes the generator exactly as
``gibbs_iteration`` does and is bitwise the monolithic chain; block b's
uniforms are fixed by the iteration's starting state and b. A mid-epoch
checkpoint stores the generator's state at the iteration's start (to
redraw Phi and the tables) and at the cursor (to draw blocks cursor..
onward).

Checkpoints share storage with the live state: a save flushes dirty z
slabs into per-block version files (``ZBlockStore``) and pins the
version vector in the payload; for a disk store homed at the checkpoint
directory the live files are the checkpoint files.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import hdp as H
from repro_torch.core import sharded as SH
from repro_torch.core.polya_urn import ppu_sample, ppu_sample_budgeted
from repro_torch.core.stick import gem_prior_sample, sample_l, sample_psi
from repro_torch.data.stream import (BlockPrefetcher, BlockWriteback,
                                     ShardedCorpusStore)
from repro_torch.data.zstore import (ZBlockStore, ZSlabStore,
                                     make_zslab_store, pack_dtype_for)
from repro_torch.device import resolve_device
from repro_torch.perf import PhaseTimers
from repro_torch.train import checkpoint as CKPT

# How a packed slab crosses to the card: torch's uint16 is not a full
# dtype on every device, so uint16 slabs move as int16 (the same bits)
# and widen on the card with & 0xFFFF.
_TRANSPORT = {np.dtype(np.uint8): (np.uint8, torch.uint8),
              np.dtype(np.uint16): (np.int16, torch.int16),
              np.dtype(np.int32): (np.int32, torch.int32)}


class StreamingState(NamedTuple):
    """The card-resident model state and a handle to the z slabs."""
    n: torch.Tensor        # (K, V) int32
    phi: torch.Tensor      # (K, V) f32
    varphi: torch.Tensor   # (K, V) int32
    psi: torch.Tensor      # (K,) f32
    l: torch.Tensor        # (K,) int32
    gen: torch.Generator   # advanced in place; see the module docstring
    it: int                # completed Gibbs iterations
    z_blocks: ZSlabStore   # (B, DB, L) slabs behind the store API


class _HostBlock:
    """A block's tokens, mask and (packed) z on the host, ready for the
    copy to the device: on the card's path one of a ring of pinned
    buffers, with the event recorded after its last copy."""

    def __init__(self, shape, zdtype, pin: bool):
        self.tokens = torch.empty(shape, dtype=torch.int32, pin_memory=pin)
        self.mask = torch.empty(shape, dtype=torch.bool, pin_memory=pin)
        self.z = torch.empty(shape, dtype=zdtype, pin_memory=pin)
        self.index = -1
        self.event: Optional[torch.cuda.Event] = None


class StreamingHDP:
    """Minibatch Gibbs driver over a block store, on one device.

    The card holds the model state plus the blocks in flight (at most
    ``prefetch_depth`` staged, one swept, ``writeback_depth`` awaiting
    write-back), whatever the corpus size; with ``z_store="disk"`` host
    memory holds only the slabs in flight too.

    ``z_store`` is "ram" or "disk"; ``z_dir`` roots the disk store's
    version files (point it at the checkpoint directory to make saves
    nearly free; default a temporary directory; one live run per
    directory). ``z_pack`` "auto" packs the slabs to ``pack_dtype_for(K)``,
    "off" keeps int32; both give bitwise the same chain.
    ``block_sparse_tables`` "on", "off" or "auto" (on below 50% vocabulary
    coverage where the z-step has per-word tables); "on" where it has
    none raises.
    """

    def __init__(self, cfg: H.HDPConfig, store: ShardedCorpusStore, *,
                 device: torch.device | str = "cuda",
                 prefetch_depth: int = 2, writeback_depth: int = 2,
                 z_store: str = "ram", z_dir: Optional[str] = None,
                 z_pack: str = "auto", block_sparse_tables: str = "auto"):
        H.validate_bucket(cfg, store.max_len)
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.prefetch_depth = prefetch_depth
        self.writeback_depth = writeback_depth
        if block_sparse_tables not in ("auto", "on", "off"):
            raise ValueError(
                "block_sparse_tables must be 'auto', 'on' or 'off', got "
                f"{block_sparse_tables!r}")
        self.in_kernel = SH.resolve_in_kernel(cfg, self.device)
        supported = SH.supports_masked_tables(cfg, self.in_kernel)
        if block_sparse_tables == "on" and not supported:
            raise ValueError(
                "block_sparse_tables='on' needs per-word alias tables (the "
                "cuda z-step in table mode, alias_in_kernel='off') — this "
                "configuration has none")
        if z_store not in ("ram", "disk"):
            raise ValueError(f"z_store must be 'ram' or 'disk', got {z_store!r}")
        if z_pack not in ("auto", "off"):
            raise ValueError(f"z_pack must be 'auto' or 'off', got {z_pack!r}")
        self.z_store, self.z_dir, self.z_pack = z_store, z_dir, z_pack
        self.z_dtype = (pack_dtype_for(cfg.K) if z_pack == "auto"
                        else np.dtype(np.int32))
        self._np_wire, self._wire = _TRANSPORT[self.z_dtype]
        self.block_sparse_tables = supported and block_sparse_tables != "off" and (
            block_sparse_tables == "on" or store.vocab_coverage < 0.5)
        self._u_mask = None
        if self.block_sparse_tables:
            u_mask = np.zeros((cfg.V,), bool)
            u_mask[store.vocab_ids()] = True
            self._u_mask = torch.from_numpy(u_mask).to(self.device)
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
            self._pinned: list[_HostBlock] = []
            self._next_pinned = 0
        # checkpoint stores of save dirs that are not a disk slab store's home
        self._zstores: dict[str, ZBlockStore] = {}

    # -- tables, slabs ----------------------------------------------------
    def _phi_tables(self, gen, n, varphi, psi):
        return SH.phi_tables(gen, n, varphi, psi, self.cfg,
                             in_kernel=self.in_kernel, u_mask=self._u_mask)

    def _make_slab_store(self) -> ZSlabStore:
        return make_zslab_store(
            self.z_store, self.store.num_blocks,
            (self.store.block_docs, self.store.max_len), root=self.z_dir,
            dtype=self.z_dtype)

    def _zstore(self, ckpt_dir: str, slab: ZSlabStore) -> ZBlockStore:
        home = slab.blockstore_for(ckpt_dir)
        if home is not None:
            # the disk slab store homed here owns the one ZBlockStore on
            # this dir: drop any other handle, so two never race a version
            self._zstores.pop(ckpt_dir, None)
            return home
        zs = self._zstores.get(ckpt_dir)
        if zs is None:
            zs = self._zstores[ckpt_dir] = ZBlockStore(ckpt_dir, self.store.num_blocks)
        return zs

    # -- init ---------------------------------------------------------------
    def init_state(self, seed: int) -> StreamingState:
        """Single-topic init, bitwise ``H.init_state`` on the same
        (concatenated) corpus from the same seed: z = 0, n counted block
        by block (exact integer sums), Phi and Psi drawn as there."""
        cfg, dev = self.cfg, self.device
        n = torch.zeros((cfg.K, cfg.V), dtype=torch.int32, device=dev)
        for blk in self.store.blocks():
            tokens = torch.from_numpy(blk.tokens).to(dev)
            mask = torch.from_numpy(blk.mask).to(dev)
            n += H.count_n(torch.zeros_like(tokens), tokens, mask, cfg.K, cfg.V)
        gen = H.make_generator(seed, dev)
        if cfg.ppu_nnz_budget is not None:
            phi, varphi = ppu_sample_budgeted(gen, n, cfg.beta, cfg.ppu_nnz_budget)
        else:
            phi, varphi = ppu_sample(gen, n, cfg.beta)
        psi = gem_prior_sample(gen, cfg.K, cfg.gamma)
        return StreamingState(
            n=n, phi=phi, varphi=varphi, psi=psi,
            l=torch.zeros((cfg.K,), dtype=torch.int32, device=dev),
            gen=gen, it=0, z_blocks=self._make_slab_store())

    # -- the copies to and from the card --------------------------------------
    def _host_block(self, b: int) -> _HostBlock:
        """Block b's tokens and mask in a host buffer, straight from the
        store (the padded rows zeroed): on the card's path the next pinned
        buffer of the ring, once its last copy's event has completed; on
        the CPU a new one. Runs on the prefetcher's pre thread."""
        shape = (self.store.block_docs, self.store.max_len)
        if not self._cuda:
            host = _HostBlock(shape, self._wire, pin=False)
        else:
            # at most prefetch_depth blocks are between this thread and the
            # sweep, so the buffer's last block has had its copy queued
            if len(self._pinned) < self.prefetch_depth + 2:
                with torch.cuda.device(self.device):
                    self._pinned.append(_HostBlock(shape, self._wire, pin=True))
            host = self._pinned[self._next_pinned % len(self._pinned)]
            self._next_pinned += 1
            if host.event is not None:
                host.event.synchronize()  # its last copy has left the buffer
        self.store.fill(b, host.tokens.numpy(), host.mask.numpy())
        host.index = b
        return host

    def _host_z(self, host: _HostBlock, z_store: ZSlabStore) -> _HostBlock:
        """Copy the block's z slab into ``host`` (as the wire dtype) and
        check the slab back in."""
        z = z_store.read(host.index)
        try:
            host.z.numpy()[...] = np.asarray(z).view(self._np_wire)
        finally:
            z_store.release(host.index)
        return host

    def _to_device(self, host: _HostBlock):
        """The block on the device: ``(b, tokens, mask, z_wire, event)``,
        the event recorded after the copy on the side stream (None on the
        CPU, where the host's tensors are the block). Runs on the stage
        thread."""
        if not self._cuda:
            return (host.index, host.tokens, host.mask, host.z, None)
        with torch.cuda.device(self.device), torch.cuda.stream(self._h2d_stream):
            out = tuple(t.to(self.device, non_blocking=True)
                        for t in (host.tokens, host.mask, host.z))
            host.event = torch.cuda.Event()
            host.event.record(self._h2d_stream)
        return (host.index, *out, host.event)

    def _take(self, item):
        """On the driver thread: wait (on the card) for a staged block's
        copy and widen its z to int32. Returns ``(b, tokens, mask, z)``."""
        b, tokens, mask, zw, event = item
        if event is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(event)
            for t in (tokens, mask, zw):
                t.record_stream(main)
        z = zw.to(torch.int32)
        if self._wire == torch.int16:
            z &= 0xFFFF
        return b, tokens, mask, z

    def _narrow(self, z: torch.Tensor):
        """A swept block's z, narrowed to the wire dtype on its device, and
        the event after it on the current stream (None on the CPU)."""
        zw = z if self._wire == torch.int32 else z.to(self._wire)
        if not self._cuda:
            return zw, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return zw, event

    def _to_host(self, payload) -> np.ndarray:
        """A narrowed z block as a host array of the store's dtype. On the
        card the copy runs on a side stream that waits on the sweep's
        event; this thread holds the tensor until the copy is done. Runs on
        the write-back thread."""
        zw, event = payload
        if event is None:
            host = zw
        else:
            with torch.cuda.device(self.device), torch.cuda.stream(self._d2h_stream):
                self._d2h_stream.wait_event(event)
                host = torch.empty(zw.shape, dtype=zw.dtype, pin_memory=True)
                host.copy_(zw, non_blocking=True)
                self._d2h_stream.synchronize()
        return host.numpy().view(self.z_dtype)

    def _staged_blocks(self, z_store: ZSlabStore, start: int):
        """The two-stage prefetch pipeline from block ``start``: the pre
        stage fills a host buffer with the block and its z slab (a disk
        read for the disk store) and checks the slab back in; the stage
        thread queues the buffer's copy to the card. The two share a
        budget of ``prefetch_depth`` blocks in flight."""

        def read(b):
            return self._host_z(self._host_block(b), z_store)

        return BlockPrefetcher(range(start, self.store.num_blocks), self._to_device,
                               depth=self.prefetch_depth, pre=read)

    def _uniforms(self, gen):
        shape = (self.store.block_docs, self.store.max_len, 3)
        return torch.rand(shape, generator=gen, device=self.device,
                          dtype=torch.float32)

    def _zero_dh(self):
        return torch.zeros((self.cfg.K, self.cfg.hist_cap + 1), dtype=torch.int32,
                           device=self.device)

    def _tail(self, gen, dh_acc, state, n_run, phi, varphi):
        l = sample_l(gen, dh_acc, state.psi, self.cfg.alpha)
        psi = sample_psi(gen, l, self.cfg.gamma)
        return StreamingState(n=n_run, phi=phi, varphi=varphi, psi=psi, l=l,
                              gen=gen, it=state.it + 1, z_blocks=state.z_blocks)

    # -- one iteration (optionally partial, for checkpoint and resume) -----
    def iteration(
        self, state: StreamingState, *,
        start_block: int = 0, n_run=None, dh_acc=None, ztables=None,
        gen_start: Optional[torch.Tensor] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every_blocks: Optional[int] = None,
        stop_after_blocks: Optional[int] = None,
    ) -> Optional[StreamingState]:
        """One Gibbs iteration, one sweep over all blocks.

        Per block the sweep emits (z', dn, dh), and the card-resident
        statistic advances by ``n_run += dn``. The driver thread only
        queues work on the card: block b+1's copy, block b's sweep and
        block b-1's write-back run at once.

        The keyword arguments resume a partly swept iteration from a
        checkpoint (``restore`` returns them: the cursor ``start_block``,
        ``n_run``, the histogram sum ``dh_acc``, the iteration's
        ``ztables`` and its starting generator state ``gen_start``) and
        let tests stop it after ``stop_after_blocks`` blocks. A stopped
        iteration returns None and lives only in its checkpoint (a
        partial save is forced at the stop), since its swept slabs are
        already stored while n and psi are not; so ``stop_after_blocks``
        needs ``ckpt_dir``.
        """
        if stop_after_blocks is not None and not ckpt_dir:
            raise ValueError(
                "stop_after_blocks without ckpt_dir would drop the partial "
                "sweep (z slabs are updated in place)")
        cfg, gen = self.cfg, state.gen
        if ztables is None:
            gen_start = gen.get_state()
            phi, varphi, ztables = self._phi_tables(gen, state.n, state.varphi,
                                                    state.psi)
        else:
            phi, varphi, ztables = ztables
        n_run = state.n if n_run is None else n_run
        dh_acc = self._zero_dh() if dh_acc is None else dh_acc
        z_store = state.z_blocks
        done, saved_cursor = 0, -1
        staged = self._staged_blocks(z_store, start_block)
        writer = BlockWriteback(z_store.write, self._to_host,
                                depth=self.writeback_depth)
        try:
            for item in staged:
                b, tokens_b, mask_b, z_b = self._take(item)
                u = self._uniforms(gen)
                z_b, dn, dh = SH.z_block(cfg, ztables, z_b, tokens_b, mask_b,
                                         state.psi, u, in_kernel=self.in_kernel)
                n_run = n_run + dn if n_run is state.n else n_run.add_(dn)
                dh_acc += dh
                writer.submit(b, self._narrow(z_b))
                done += 1
                cursor = b + 1
                more = cursor < self.store.num_blocks
                if (ckpt_dir and ckpt_every_blocks and more
                        and cursor % ckpt_every_blocks == 0):
                    writer.flush()  # the save reads the stored slabs
                    self._save(ckpt_dir, state, cursor, n_run, dh_acc,
                               gen_start, gen.get_state())
                    saved_cursor = cursor
                if stop_after_blocks is not None and done >= stop_after_blocks and more:
                    if saved_cursor != cursor:
                        writer.flush()
                        self._save(ckpt_dir, state, cursor, n_run, dh_acc,
                                   gen_start, gen.get_state())
                    return None
        finally:
            staged.close()  # unblocks the prefetch threads on an early exit
            writer.close()  # drains the write-backs
        return self._tail(gen, dh_acc, state, n_run, phi, varphi)

    def iteration_profiled(self, state: StreamingState, timers=None):
        """One Gibbs iteration, bitwise ``iteration()``, with its wall time
        split by phase: serialized (no prefetch or write-back threads) and
        the card synchronized at every phase boundary (``PhaseTimers``), so
        each span holds one phase: tables.build, corpus_read (the block
        into its host buffer), z_read (its slab too), h2d,
        sweep (the block's uniforms and its z-step), merge (n += dn,
        dh), writeback (narrow, D2H and the store's write) and tail (l
        and Psi). Use ``iteration()`` for throughput: the overlap is the
        point there. Returns ``(state', timers)``."""
        cfg, gen = self.cfg, state.gen
        timers = PhaseTimers(self.device) if timers is None else timers
        with timers.phase("tables.build"):
            phi, varphi, ztables = self._phi_tables(gen, state.n, state.varphi,
                                                    state.psi)
        n_run, dh_acc = state.n, self._zero_dh()
        z_store = state.z_blocks
        for b in range(self.store.num_blocks):
            with timers.phase("corpus_read"):
                host = self._host_block(b)
            with timers.phase("z_read"):
                self._host_z(host, z_store)
            with timers.phase("h2d"):
                _, tokens_b, mask_b, z_old = self._take(self._to_device(host))
            with timers.phase("sweep"):
                u = self._uniforms(gen)
                z_b, m, dn = SH.z_sweep_u(cfg, ztables, z_old, tokens_b, mask_b,
                                          state.psi, u, in_kernel=self.in_kernel)
            with timers.phase("merge"):
                dn, dh = SH.block_stats(cfg, z_old, z_b, m, tokens_b, mask_b, dn)
                n_run = n_run + dn if n_run is state.n else n_run.add_(dn)
                dh_acc += dh
            with timers.phase("writeback"):
                z_store.write(b, self._to_host(self._narrow(z_b)))
        with timers.phase("tail"):
            out = self._tail(gen, dh_acc, state, n_run, phi, varphi)
        return out, timers

    def run(
        self, state: StreamingState, iters: int, *,
        ckpt_dir: Optional[str] = None,
        ckpt_every_iters: Optional[int] = None,
        ckpt_every_blocks: Optional[int] = None,
        registry=None, publish_every_iters: Optional[int] = None,
        publish_w: Optional[int] = None, publish_compact: bool = False,
        publish_keep: Optional[int] = None,
    ) -> StreamingState:
        """Drive ``iters`` Gibbs iterations; optionally checkpoint, and
        publish serving snapshots.

        ``registry`` (a ``serve.registry.SnapshotRegistry``) with
        ``publish_every_iters`` turns a live run into a fleet's feed:
        every N completed iterations the current (Phi, Psi) is distilled
        and published atomically, and fleet workers watching the registry
        swap to it between engine steps. Publishing only reads the state
        and draws nothing, so the chain is bitwise the one without it."""
        if bool(publish_every_iters) != (registry is not None):
            raise ValueError(
                "registry and publish_every_iters go together: passing "
                "only one would silently never publish")
        for _ in range(iters):
            state = self.iteration(state, ckpt_dir=ckpt_dir,
                                   ckpt_every_blocks=ckpt_every_blocks)
            if ckpt_dir and ckpt_every_iters and state.it % ckpt_every_iters == 0:
                self.save(ckpt_dir, state)
            if registry is not None and state.it % publish_every_iters == 0:
                self.export_snapshot(registry, state, w=publish_w,
                                     compact=publish_compact, keep=publish_keep)
        return state

    def export_snapshot(self, dest, state: StreamingState, *,
                        w: Optional[int] = None, compact: bool = False,
                        keep: Optional[int] = None):
        """Distill the current model into a serving snapshot
        (``serve/snapshot.py``): Phi, Psi and the word-sparse tables, exact
        for the snapshot's life since serving never resamples Phi.

        ``dest`` is a snapshot directory (one artifact, replaced in place)
        or a ``SnapshotRegistry``, into which the snapshot is published as
        a new version (``keep`` bounds the registry's retention)."""
        from repro_torch.serve import snapshot as SNAP

        snap = SNAP.snapshot_from_state(state, self.cfg, w=w, compact=compact)
        if hasattr(dest, "publish"):
            dest.publish(snap, keep=keep)
        else:
            SNAP.save(dest, snap)
        return snap

    # -- checkpoints ----------------------------------------------------------
    # One step per saved payload, step = it * B + cursor, so mid-epoch saves
    # order between iteration boundaries. z slabs are not in the payload: a
    # save flushes dirty slabs into per-block version files (nothing to copy
    # for a disk store homed at ckpt_dir) and the payload pins their (B,)
    # version vector. GC keeps the union of the retained manifests' vectors
    # and the live store's current versions.

    def _payload(self, state, cursor, n_run, dh_acc, gen_start, gen_cursor,
                 z_versions):
        store = self.store
        return {
            "model": {"n": state.n, "phi": state.phi, "varphi": state.varphi,
                      "psi": state.psi, "l": state.l, "key": gen_start,
                      "it": np.int64(state.it)},
            "z_versions": np.asarray(z_versions, np.int64),
            "z_shape": np.asarray([store.num_blocks, store.block_docs,
                                   store.max_len], np.int64),
            "cursor": np.int64(cursor),
            # the running statistic at the cursor and the histogram sum
            "n_run": n_run, "dh_acc": dh_acc,
            # the generator after blocks < cursor drew their uniforms
            "gen_cursor": gen_cursor,
        }

    def _template(self):
        cfg, dev = self.cfg, self.device
        kv = lambda dt: torch.zeros((cfg.K, cfg.V), dtype=dt, device=dev)  # noqa: E731
        return {
            "model": {"n": kv(torch.int32), "phi": kv(torch.float32),
                      "varphi": kv(torch.int32),
                      "psi": torch.zeros((cfg.K,), dtype=torch.float32, device=dev),
                      "l": torch.zeros((cfg.K,), dtype=torch.int32, device=dev),
                      "key": torch.zeros((0,), dtype=torch.uint8),
                      "it": np.int64(0)},
            "z_versions": np.zeros((self.store.num_blocks,), np.int64),
            "z_shape": np.zeros((3,), np.int64),
            "cursor": np.int64(0),
            "n_run": kv(torch.int32), "dh_acc": self._zero_dh(),
            "gen_cursor": torch.zeros((0,), dtype=torch.uint8),
        }

    def _referenced_z_versions(self, ckpt_dir: str) -> set:
        """(block, version) pairs that any retained manifest in
        ``ckpt_dir`` pins (version -1, the implicit zero slab, has no
        file)."""
        refs = set()
        for vers in CKPT.arrays_across_steps(ckpt_dir, "z_versions").values():
            refs |= {(b, int(v)) for b, v in enumerate(vers) if int(v) >= 0}
        return refs

    def _save(self, ckpt_dir, state, cursor, n_run, dh_acc, gen_start,
              gen_cursor) -> str:
        """Flush dirty slabs into immutable version files, commit the
        payload that pins their versions, then sweep every version file
        that no retained manifest pins and that is not live. A crash
        between the first two steps leaves only orphan files."""
        slab = state.z_blocks
        zbs = self._zstore(ckpt_dir, slab)
        versions, _ = slab.sync_to(zbs)
        step = int(state.it) * self.store.num_blocks + cursor
        path = CKPT.save(ckpt_dir, step, self._payload(
            state, cursor, n_run, dh_acc, gen_start, gen_cursor, versions))
        referenced = self._referenced_z_versions(ckpt_dir)
        slab.pin_versions(zbs, referenced)
        zbs.gc(referenced | slab.live_versions_in(zbs))
        return path

    def save(self, ckpt_dir: str, state: StreamingState) -> str:
        """Iteration-boundary checkpoint (cursor 0; restore reads no
        n_run or dh_acc there)."""
        key = state.gen.get_state()
        return self._save(ckpt_dir, state, 0, state.n, self._zero_dh(), key, key)

    def restore(self, ckpt_dir: str):
        """``(state, resume_kwargs)`` from the latest checkpoint in
        ``ckpt_dir`` (``(None, {})`` when there is none); pass
        ``resume_kwargs`` to ``iteration`` to finish a partly swept
        iteration (empty at an iteration boundary). The slab store adopts
        the pinned version vector (for a disk store homed at ``ckpt_dir``
        without copying); orphan version files are swept."""
        payload = CKPT.restore_latest(ckpt_dir, self._template())
        if payload is None:
            return None, {}
        store = self.store
        want = (store.num_blocks, store.block_docs, store.max_len)
        got = tuple(int(x) for x in payload["z_shape"])
        if got != want:
            raise ValueError(
                f"checkpoint block geometry {got} does not match the store "
                f"{want} — resume with the block_docs/corpus the checkpoint "
                f"was written with")
        slab = self._make_slab_store()
        zbs = self._zstore(ckpt_dir, slab)
        slab.load_from(zbs, payload["z_versions"])
        referenced = self._referenced_z_versions(ckpt_dir)
        slab.pin_versions(zbs, referenced)
        zbs.gc(referenced | slab.live_versions_in(zbs))
        m = payload["model"]
        gen = torch.Generator(device=self.device)
        gen.set_state(m["key"])
        state = StreamingState(n=m["n"], phi=m["phi"], varphi=m["varphi"],
                               psi=m["psi"], l=m["l"], gen=gen,
                               it=int(m["it"]), z_blocks=slab)
        cursor = int(payload["cursor"])
        if cursor == 0:
            return state, {}
        # mid-epoch: redraw this iteration's Phi and tables from its
        # starting generator state, then draw on from the cursor's
        ztables = self._phi_tables(gen, state.n, state.varphi, state.psi)
        gen.set_state(payload["gen_cursor"])
        return state, {"start_block": cursor, "n_run": payload["n_run"],
                       "dh_acc": payload["dh_acc"], "ztables": ztables,
                       "gen_start": m["key"]}
