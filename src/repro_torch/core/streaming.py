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

Sweep lanes (``n_lanes > 1``, the reference's lane mode, its
``n_devices``): each block's document rows split evenly over the lanes,
lane d on ``devices[d % len(devices)]`` (by default the trainer's one
device), each a thread (``_SweepLane``) with its own CUDA stream. The
driver still draws the block's whole ``(DB, L, 3)`` uniforms, and lane d
sweeps its rows with rows ``[d * DB / N, (d + 1) * DB / N)`` of that draw
(``sharded.z_lane``), so N lanes are bitwise one lane and the monolithic
chain. Each lane extracts its delta's nonzeros (``delta_sparsify``), and
a reducer thread (an ``AsyncStage``) merges the lanes in ascending order
through the packed exchange of ``data/deltawire.py`` (the single-host
prototype of the wire protocol) and advances n and dh by one add each.

Observability (``repro_torch.obs``): the pipeline's stages are spans on
the tracer, one track per thread (``tables.build``, ``stage_wait``,
``sweep``, ``sweep_submit``, ``wb_submit``, ``checkpoint``, ``tail`` on
the driver; ``corpus_read`` and ``z_read`` on the prefetch thread,
``h2d`` on the stage thread, ``sweep.d{d}`` on each lane,
``delta_reduce`` on the reducer, ``writeback``); each iteration
publishes counters and gauges into the registry (``_publish_health``).
The reductions that only feed metrics (K*, delta sparsity, the
convergence diagnostics) run only with a sink attached
(``obs.metrics_on()``); they read the state and draw nothing, so an
observed chain is bitwise a silent one.

Checkpoints share storage with the live state: a save flushes dirty z
slabs into per-block version files (``ZBlockStore``) and pins the
version vector in the payload; for a disk store homed at the checkpoint
directory the live files are the checkpoint files.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import hdp as H
from repro_torch.core import sharded as SH
from repro_torch.core.polya_urn import ppu_sample, ppu_sample_budgeted
from repro_torch.core.stick import gem_prior_sample, sample_l, sample_psi
from repro_torch.data import deltawire as DW
from repro_torch.data.stream import (AsyncStage, BlockPrefetcher,
                                     BlockWriteback, ShardedCorpusStore)
from repro_torch.data.zstore import (ZBlockStore, ZSlabStore,
                                     make_zslab_store, pack_dtype_for)
from repro_torch.device import resolve_device
from repro_torch.kernels.hdp_z import ops as zops
from repro_torch.obs.diagnostics import NULL_CLOCK, PhaseClock
from repro_torch.perf import PhaseTimers
from repro_torch.train import checkpoint as CKPT

# How a packed slab crosses to the card: torch's uint16 is not a full
# dtype on every device, so uint16 slabs move as int16 (the same bits)
# and widen on the card with & 0xFFFF.
_TRANSPORT = {np.dtype(np.uint8): (np.uint8, torch.uint8),
              np.dtype(np.uint16): (np.int16, torch.int16),
              np.dtype(np.int32): (np.int32, torch.int32)}


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index ("cuda" is the current card), so devices
    compare equal to a tensor's ``.device``."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class _SweepLane:
    """One sweep lane of the streamed trainer's lane mode (counterpart of
    the reference's ``_SweepLane``): a daemon thread that runs
    ``sweep(lane, work)`` for each submitted block, on its own CUDA stream
    of its device, and waits for the stream before it hands the result
    on. The thread puts each lane's ``sweep.d{d}`` span on a track of its
    own, and the wait inside the span makes it measure the lane's device
    work, not its dispatch.

    The bounded input queue (depth 2) holds the driver back, so at most
    two blocks' rows are in flight a lane. Errors are re-raised on the
    consumer's side (``take``); after one, further submissions drain
    unprocessed.
    """

    _DONE = object()

    def __init__(self, d: int, device: torch.device, sweep):
        self.d = d
        self.device = device
        self.wall_s = 0.0   # the lane's summed sweep wall time
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self._sweep = sweep
        self._in: queue.Queue = queue.Queue(maxsize=2)
        self._out: queue.Queue = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name=f"sweep.d{d}")
        self._thread.start()

    def submit(self, b: int, work):
        self._in.put((b, work))

    def take(self, b: int):
        """Block b's result; re-raises the lane's error if it failed."""
        got = self._out.get()
        if got[0] == "err":
            raise got[1]
        _, rb, payload = got
        if rb != b:
            raise RuntimeError(f"sweep lane d{self.d} produced block {rb}, "
                               f"expected {b}")
        return payload

    def _run(self, work):
        if self.stream is None:
            return self._sweep(self, work)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = self._sweep(self, work)
            self.stream.synchronize()
        return out

    def _worker(self):
        tr = obs.tracer()
        while True:
            item = self._in.get()
            if item is self._DONE:
                return
            if self._err is not None:
                continue  # drain the submissions after an error
            b, work = item
            try:
                t0 = time.perf_counter()
                with tr.span(f"sweep.d{self.d}", cat="pipeline", block=b):
                    payload = self._run(work)
                self.wall_s += time.perf_counter() - t0
                self._out.put(("ok", b, payload))
            except BaseException as e:  # surfaced on take()
                self._err = e
                self._out.put(("err", e))

    def close(self):
        if self._thread.is_alive():
            self._in.put(self._DONE)
            self._thread.join(timeout=600)
            if self._thread.is_alive():
                raise RuntimeError(f"sweep lane d{self.d} failed to drain "
                                   "within 600 s (wedged device?)")


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

    ``n_lanes`` > 1 splits each block's rows over that many sweep lanes
    (the module docstring), lane d on ``devices[d % len(devices)]``
    (default ``[device]``: every lane on the one card, a stream each);
    ``block_docs`` must divide evenly. Every lane count gives bitwise the
    same chain.
    """

    def __init__(self, cfg: H.HDPConfig, store: ShardedCorpusStore, *,
                 device: torch.device | str = "cuda",
                 prefetch_depth: int = 2, writeback_depth: int = 2,
                 z_store: str = "ram", z_dir: Optional[str] = None,
                 z_pack: str = "auto", block_sparse_tables: str = "auto",
                 n_lanes: int = 1,
                 devices: Optional[Sequence[torch.device | str]] = None):
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
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        if store.block_docs % n_lanes:
            raise ValueError(f"block_docs={store.block_docs} must divide evenly "
                             f"over n_lanes={n_lanes} sweep lanes")
        devices = [self.device] if devices is None else [
            resolve_device(d) for d in devices]
        if not devices or any(d.type != self.device.type for d in devices):
            raise ValueError(f"sweep lanes run on {self.device.type} devices "
                             f"like the trainer, got {devices}")
        self.n_lanes = n_lanes
        self.lane_devices = [_indexed(devices[d % len(devices)])
                             for d in range(n_lanes)]
        self._lane_rows = store.block_docs // n_lanes
        # a lane's delta changes at most two cells a token it resamples
        self._nnz_cap = int(min(2 * self._lane_rows * store.max_len,
                                cfg.K * cfg.V))
        self.delta_reduce_bytes = 0  # the packed exchange's bytes, in all
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            # a D2H stream on each device a swept z block can lie on
            self._d2h_streams = {
                dev: torch.cuda.Stream(dev)
                for dev in {_indexed(self.device), *self.lane_devices}}
            self._pinned: list[_HostBlock] = []
            self._next_pinned = 0
        # checkpoint stores of save dirs that are not a disk slab store's home
        self._zstores: dict[str, ZBlockStore] = {}
        # the convergence diagnostics, built on the first iteration that
        # runs with a metrics sink attached
        self._diag = None

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
            stream = self._d2h_streams[zw.device]
            with torch.cuda.device(zw.device), torch.cuda.stream(stream):
                stream.wait_event(event)
                host = torch.empty(zw.shape, dtype=zw.dtype, pin_memory=True)
                host.copy_(zw, non_blocking=True)
                stream.synchronize()
        return host.numpy().view(self.z_dtype)

    def _lanes_to_host(self, parts) -> np.ndarray:
        """The sweep lanes' narrowed z rows, in lane order, as one host
        slab. Runs on the write-back thread."""
        return np.concatenate([self._to_host(p) for p in parts], axis=0)

    def _staged_blocks(self, z_store: ZSlabStore, start: int):
        """The two-stage prefetch pipeline from block ``start``: the pre
        stage fills a host buffer with the block and its z slab (a disk
        read for the disk store) and checks the slab back in; the stage
        thread queues the buffer's copy to the card. The two share a
        budget of ``prefetch_depth`` blocks in flight."""

        def read(b):
            tr = obs.tracer()
            with tr.span("corpus_read", cat="pipeline", block=b):
                host = self._host_block(b)
            with tr.span("z_read", cat="pipeline", block=b):
                return self._host_z(host, z_store)

        def stage(host):
            with obs.tracer().span("h2d", cat="pipeline", block=host.index):
                return self._to_device(host)

        return BlockPrefetcher(range(start, self.store.num_blocks), stage,
                               depth=self.prefetch_depth, pre=read)

    def _uniforms(self, gen):
        shape = (self.store.block_docs, self.store.max_len, 3)
        return torch.rand(shape, generator=gen, device=self.device,
                          dtype=torch.float32)

    def _zero_dh(self):
        return torch.zeros((self.cfg.K, self.cfg.hist_cap + 1), dtype=torch.int32,
                           device=self.device)

    def _ready_event(self):
        """An event after the driver's queued work on the current stream
        (the staged block, its widened z, its uniforms and the tables),
        which the sweep lanes wait on; None on the CPU."""
        if not self._cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def _lane_rows_of(self, lane: int, tensors, stream=None):
        """Lane ``lane``'s rows of the block tensors, on its device. With a
        stream, the block's memory is marked as used there too."""
        dev = self.lane_devices[lane]
        rows = slice(lane * self._lane_rows, (lane + 1) * self._lane_rows)
        out = []
        for t in tensors:
            if stream is not None and t.device == dev:
                t.record_stream(stream)
            out.append(t[rows].to(dev, non_blocking=True))
        return out

    def _lane_sweep(self, lane: _SweepLane, work):
        """One lane's rows of one block, on the lane's thread and stream:
        the sweep (``z_lane``), the nonzeros of its delta
        (``delta_sparsify``, which waits for the stream), and the swept z
        narrowed for the write-back. Returns the narrowed z with its event,
        the first ``nnz`` COO entries and the histogram, on the host."""
        ztables, psi, tokens, mask, z, u, ready = work
        if lane.stream is not None:
            lane.stream.wait_event(ready)
            if u.device == lane.device:
                u.record_stream(lane.stream)
        tokens_r, mask_r, z_r = self._lane_rows_of(
            lane.d, (tokens, mask, z), lane.stream)
        z_new, dn, dh = SH.z_lane(self.cfg, ztables, z_r, tokens_r, mask_r,
                                  psi, u, n_lanes=self.n_lanes, lane=lane.d,
                                  in_kernel=self.in_kernel)
        return (self._narrow(z_new), *self._lane_delta(dn, dh))

    def _lane_delta(self, dn, dh):
        """A lane's delta as its first ``nnz`` COO entries
        (``delta_sparsify``, which waits for the current stream) and its
        histogram, on the host."""
        idx, val, nnz = zops.delta_sparsify(dn, self._nnz_cap)
        return (idx[:nnz].cpu().numpy(), val[:nnz].cpu().numpy()), dh.cpu().numpy()

    def _merge_lanes(self, hold: dict, parts, health: bool):
        """Merge one block's lane results in ascending lane order through
        the packed exchange, and advance ``hold``'s n and dh by one add
        each. Returns the merged host delta's nonzero count (None without
        ``health``)."""
        K, V = self.cfg.K, self.cfg.V
        packs = [DW.pack_coo(idx, val, (K, V)) for _, (idx, val), _ in parts]
        merged = DW.reduce_packed(packs, shape=(K, V))
        self.delta_reduce_bytes += DW.packed_nbytes(packs)
        dh_sum = np.sum([dh for _, _, dh in parts], axis=0, dtype=np.int64)
        dn_dev = torch.from_numpy(merged).to(self.device)
        dh_dev = torch.from_numpy(dh_sum.astype(np.int32)).to(self.device)
        n_run = hold["n_run"]
        hold["n_run"] = (n_run + dn_dev if n_run is hold["n_in"]
                         else n_run.add_(dn_dev))
        hold["dh_acc"] += dh_dev
        return int(np.count_nonzero(merged)) if health else None

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
        block b-1's write-back run at once. With sweep lanes the driver
        hands each lane its rows and the reducer thread merges the lanes'
        deltas (the module docstring).

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
        tr = obs.tracer()
        # reductions that only feed metrics run with a sink attached
        health = obs.metrics_on()
        clock = PhaseClock() if health else NULL_CLOCK
        dn_nnz = torch.zeros((), dtype=torch.int64, device=self.device) if health else None
        n_run = state.n if n_run is None else n_run
        dh_acc = self._zero_dh() if dh_acc is None else dh_acc
        lane_mode = self.n_lanes > 1
        lanes: list[_SweepLane] = []
        reducer = None
        # lane mode: the reducer thread owns the statistic; the driver reads
        # it back from `hold` after a flush or close
        hold = {"n_in": state.n, "n_run": n_run, "dh_acc": dh_acc, "dn_nnz": 0}
        done, saved_cursor = 0, -1
        z_store = state.z_blocks
        staged = self._staged_blocks(z_store, start_block)
        writer = BlockWriteback(z_store.write,
                                self._lanes_to_host if lane_mode else self._to_host,
                                depth=self.writeback_depth)
        try:
            if ztables is None:
                # queued while the prefetch threads read and stage block 0;
                # the span waits for the card to finish the tables
                gen_start = gen.get_state()
                phi, varphi, ztables = self._phi_tables(gen, state.n, state.varphi,
                                                        state.psi)
                obs.metrics().counter("train.alias_rebuilds").inc()
                with tr.span("tables.build", cat="pipeline"), \
                        clock.time("tables.build"):
                    ready = self._ready_event()
                    if ready is not None:
                        ready.synchronize()
            else:
                phi, varphi, ztables = ztables
            if lane_mode:
                # each lane device holds the (small) tables and psi
                ztab_lanes = [tuple(t.to(dev) for t in ztables)
                              for dev in self.lane_devices]
                psi_lanes = [state.psi.to(dev) for dev in self.lane_devices]
                lanes = [_SweepLane(d, dev, self._lane_sweep)
                         for d, dev in enumerate(self.lane_devices)]
                main = torch.cuda.current_stream(self.device) if self._cuda else None

                def reduce_block(b):
                    parts = [lane.take(b) for lane in lanes]
                    with tr.span("delta_reduce", cat="pipeline", block=b):
                        if main is None:
                            nnz = self._merge_lanes(hold, parts, health)
                        else:
                            with torch.cuda.device(self.device), torch.cuda.stream(main):
                                nnz = self._merge_lanes(hold, parts, health)
                        if health:
                            hold["dn_nnz"] += nnz
                    writer.submit(b, [z for z, _, _ in parts])

                reducer = AsyncStage(reduce_block, depth=2, name="delta_reduce")
            staged_it = iter(staged)
            while True:
                with tr.span("stage_wait", cat="pipeline"), clock.time("stage_wait"):
                    item = next(staged_it, None)
                if item is None:
                    break
                b, tokens_b, mask_b, z_b = self._take(item)
                if lane_mode:
                    with tr.span("sweep_submit", cat="pipeline", block=b), \
                            clock.time("sweep_submit"):
                        u = self._uniforms(gen)
                        ready = self._ready_event()
                        for d, lane in enumerate(lanes):
                            lane.submit(b, (ztab_lanes[d], psi_lanes[d], tokens_b,
                                            mask_b, z_b, u, ready))
                        reducer.submit(b)
                else:
                    with tr.span("sweep", cat="pipeline", block=b), clock.time("sweep"):
                        u = self._uniforms(gen)
                        z_b, dn, dh = SH.z_block(cfg, ztables, z_b, tokens_b, mask_b,
                                                 state.psi, u, in_kernel=self.in_kernel)
                        n_run = n_run + dn if n_run is state.n else n_run.add_(dn)
                        dh_acc += dh
                        if health:
                            dn_nnz += torch.count_nonzero(dn)
                    with tr.span("wb_submit", cat="pipeline", block=b), \
                            clock.time("wb_submit"):
                        writer.submit(b, self._narrow(z_b))
                done += 1
                cursor = b + 1
                more = cursor < self.store.num_blocks
                due = (ckpt_dir and ckpt_every_blocks and more
                       and cursor % ckpt_every_blocks == 0)
                stop = stop_after_blocks is not None and done >= stop_after_blocks and more
                if due or (stop and saved_cursor != cursor):
                    with tr.span("checkpoint", cat="pipeline", block=b), \
                            clock.time("checkpoint"):
                        if lane_mode:
                            reducer.flush()  # the statistic is current in hold
                            n_run, dh_acc = hold["n_run"], hold["dh_acc"]
                        writer.flush()  # the save reads the stored slabs
                        self._save(ckpt_dir, state, cursor, n_run, dh_acc,
                                   gen_start, gen.get_state())
                    saved_cursor = cursor
                if stop:
                    return None
        finally:
            staged.close()  # unblocks the prefetch threads on an early exit
            try:
                try:
                    if reducer is not None:
                        reducer.close()  # drains the merges, which read the lanes
                finally:
                    for lane in lanes:
                        lane.close()
            finally:
                writer.close()  # drains the write-backs
        if lane_mode:
            n_run, dh_acc = hold["n_run"], hold["dh_acc"]
            if health:
                dn_nnz = hold["dn_nnz"]
        with tr.span("tail", cat="pipeline"), clock.time("tail"):
            out = self._tail(gen, dh_acc, state, n_run, phi, varphi)
        lane_walls = [(lane.d, lane.wall_s) for lane in lanes] if health else None
        self._publish_health(out, dn_nnz, done, dh_acc=dh_acc, clock=clock,
                             lane_walls=lane_walls)
        return out

    def _publish_health(self, state: StreamingState, dn_nnz, blocks_done,
                        dh_acc=None, clock=None, lane_walls=None):
        """An iteration's counters and gauges in the global registry
        (the reference's names). The host-side counts are always kept;
        K*, the delta's sparsity and the convergence diagnostics
        (``obs/diagnostics.py``) only when ``iteration`` gathered them,
        that is with a metrics sink attached. All read the state and draw
        nothing. Ends with a rate-limited flush of the sink."""
        M = obs.metrics()
        store = state.z_blocks
        M.counter("train.iterations").inc()
        M.counter("train.tokens_swept").inc(self.store.num_tokens)
        M.gauge("train.it").set(int(state.it))
        M.gauge("train.zstore_read_mb").set(round(store.bytes_read / 2**20, 3))
        M.gauge("train.zstore_written_mb").set(round(store.bytes_written / 2**20, 3))
        M.gauge("train.resident_z_slabs_hwm").set(int(store.high_water))
        M.gauge("train.n_devices").set(self.n_lanes)
        if self.n_lanes > 1:
            M.gauge("train.delta_reduce_mb").set(
                round(self.delta_reduce_bytes / 2**20, 3))
        if lane_walls:
            # each lane's sweep wall time, as a phase counter labelled by lane
            for d, sec in lane_walls:
                M.counter("train.phase_ms", phase="sweep",
                          proc=f"d{d}").inc(round(sec * 1e3, 3))
        if dn_nnz is not None:
            M.gauge("train.k_star").set(int((state.n > 0).any(dim=1).sum()))
            denom = max(blocks_done, 1) * self.cfg.K * self.cfg.V
            M.gauge("train.delta_nnz_frac").set(round(int(dn_nnz) / denom, 6))
            if dh_acc is not None:
                if self._diag is None:
                    from repro_torch.obs.diagnostics import ConvergenceDiagnostics
                    self._diag = ConvergenceDiagnostics(
                        self.cfg, num_tokens=self.store.num_tokens)
                self._diag.update(M, state.n, dh_acc, state.psi)
        if clock is not None:
            for phase, sec in clock.acc.items():
                M.counter("train.phase_ms", phase=phase).inc(round(sec * 1e3, 3))
        obs.flush_metrics()

    def iteration_profiled(self, state: StreamingState, timers=None):
        """One Gibbs iteration, bitwise ``iteration()``, with its wall time
        split by phase: serialized (no prefetch, write-back or lane
        threads) and the card synchronized at every phase boundary
        (``PhaseTimers``), so each span holds one phase: tables.build,
        corpus_read (the block into its host buffer), z_read (its slab
        too), h2d, sweep (the block's uniforms and its z-step, every
        lane's in turn with lanes), merge (n += dn, dh; with lanes the
        nonzeros' extraction and the packed exchange too), writeback
        (narrow, D2H and the store's write) and tail (l and Psi). Use
        ``iteration()`` for throughput: the overlap is the point there.
        Returns ``(state', timers)``."""
        cfg, gen = self.cfg, state.gen
        timers = PhaseTimers(self.device) if timers is None else timers
        with timers.phase("tables.build"):
            phi, varphi, ztables = self._phi_tables(gen, state.n, state.varphi,
                                                    state.psi)
            ztab_lanes = [tuple(t.to(dev) for t in ztables) for dev in self.lane_devices]
            psi_lanes = [state.psi.to(dev) for dev in self.lane_devices]
        n_run, dh_acc = state.n, self._zero_dh()
        hold = {"n_in": state.n, "n_run": n_run, "dh_acc": dh_acc}
        z_store = state.z_blocks
        lanes = range(self.n_lanes)
        for b in range(self.store.num_blocks):
            with timers.phase("corpus_read"):
                host = self._host_block(b)
            with timers.phase("z_read"):
                self._host_z(host, z_store)
            with timers.phase("h2d"):
                _, tokens_b, mask_b, z_old = self._take(self._to_device(host))
            if self.n_lanes > 1:
                with timers.phase("sweep"):
                    u = self._uniforms(gen)
                    outs = [SH.z_lane(cfg, ztab_lanes[d],
                                      *self._lane_rows_of(d, (z_old, tokens_b, mask_b)),
                                      psi_lanes[d], u, n_lanes=self.n_lanes, lane=d,
                                      in_kernel=self.in_kernel) for d in lanes]
                with timers.phase("merge"):
                    parts = [(z_new, *self._lane_delta(dn, dh)) for z_new, dn, dh in outs]
                    del outs
                    self._merge_lanes(hold, parts, health=False)
                with timers.phase("writeback"):
                    z_store.write(b, self._lanes_to_host(
                        [self._narrow(z) for z, _, _ in parts]))
                continue
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
        if self.n_lanes > 1:
            n_run, dh_acc = hold["n_run"], hold["dh_acc"]
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
