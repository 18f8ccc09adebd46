"""Continuous-batching engine for fold-in queries (counterpart of
``repro/serve/engine.py``).

Variable-length query documents are packed into fixed-shape (B, L)
batches, one shape per length bucket:

  * each length bucket owns a pool of B *slots*; a slot holds one
    in-flight document for the ``init + burnin`` sweeps it needs;
  * every engine step runs ONE frozen-Phi sweep over a bucket's whole
    slot batch: documents admitted at different times share a batch at
    different sweep counts (iteration-level continuous batching);
  * a document that reaches ``burnin`` sweeps retires (its mixture is
    read out from the sweep-emitted m) and frees its slot for the next
    queued request.

A document's mixture depends only on (snapshot, base_seed, its seed,
its tokens), the fold-in randomness contract of ``serve/foldin.py``,
never on the slot, the batch or the admission time, so the engine is
bitwise a direct ``foldin_docs`` call. Empty slots carry all-False masks
and cost the sweep nothing beyond their lane.

Every step hands the sweep fresh device tensors of the host's staging
arrays (tokens, mask and seeds when admission changed them, the sweep
counts always), never a view that the host mutates afterwards.

Observability (``repro_torch.obs``), as the reference's engine: each
request's ``request.queued`` and ``request.inflight`` async spans, the
``serve.queue_wait_ms`` and ``serve.service_ms`` histograms a bucket,
and an ``engine_step`` span a step. None of it reaches a mixture.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import conformance as C
from repro_torch.data.stream import AsyncStage
from repro_torch.serve import foldin as F
from repro_torch.serve.snapshot import ModelSnapshot

DEFAULT_BUCKETS = (32, 64, 128, 256)


def _engine_step(snap: ModelSnapshot, tokens, mask, z, seeds, sweeps, base_seed,
                 *, impl: str, has_fresh: bool):
    """One engine step on a (B, L) slot batch: initialize the fresh slots
    (sweeps == 0) from the global term, then run one frozen z-sweep with
    each slot's own sweep-indexed uniforms. ``has_fresh`` (the host knows
    whether admission placed anything) skips the init otherwise.

    Returns ``(z, m)``: the sweep-emitted (B, K) histogram stays with the
    pool, so retirement builds mixtures without recounting z.
    """
    length = tokens.shape[1]
    if has_fresh:
        u0 = F.sweep_uniforms(base_seed, seeds, torch.zeros_like(sweeps), length)
        z_init = F.init_z(tokens, mask, u0, snap.fpack, snap.ipack)
        z = torch.where((sweeps == 0)[:, None], z_init, z)
    u = F.sweep_uniforms(base_seed, seeds, sweeps + 1, length)
    return C.z_step_conformant(impl, tokens, mask, z, u, snap.q_a, snap.fpack,
                               snap.ipack, kk=snap.K)


@dataclass
class _Slots:
    """One length bucket's slot pool. tokens/mask/seeds/sweeps are host
    staging arrays; their device copies are made anew when admission
    writes them (``mark_dirty``). z and m stay on the device for the
    pool's life: a fresh slot is re-initialized in the step (sweeps ==
    0), so stale rows never need zeroing."""
    device: torch.device
    tokens: np.ndarray                    # (B, L) int32
    mask: np.ndarray                      # (B, L) bool
    seeds: np.ndarray                     # (B,) int64
    sweeps: np.ndarray                    # (B,) int32
    req: list                             # (B,) Optional[request id]
    z: torch.Tensor                       # (B, L) int32, on the device
    m: Optional[torch.Tensor] = None      # (B, K) sweep-emitted histograms
    d_tokens: Optional[torch.Tensor] = None  # device copies (None = dirty)
    d_mask: Optional[torch.Tensor] = None
    d_seeds: Optional[torch.Tensor] = None

    @classmethod
    def empty(cls, batch: int, length: int, device: torch.device) -> "_Slots":
        return cls(
            device=device,
            tokens=np.zeros((batch, length), np.int32),
            mask=np.zeros((batch, length), bool),
            seeds=np.zeros((batch,), np.int64),
            sweeps=np.zeros((batch,), np.int32),
            req=[None] * batch,
            z=torch.zeros((batch, length), dtype=torch.int32, device=device),
        )

    def mark_dirty(self):
        self.d_tokens = self.d_mask = self.d_seeds = None

    def device_batch(self):
        if self.d_tokens is None:
            # torch.tensor copies: the host arrays may change at once
            self.d_tokens = torch.tensor(self.tokens, device=self.device)
            self.d_mask = torch.tensor(self.mask, device=self.device)
            self.d_seeds = torch.tensor(self.seeds, device=self.device)
        return self.d_tokens, self.d_mask, self.d_seeds


@dataclass
class _Pending:
    rid: int
    tokens: Optional[np.ndarray]      # dropped once packed
    submit_t: float
    admit_t: Optional[float] = None
    # the bucket-padded row pair that admission installs with two copies:
    # packed at submit time (sync) or by the admission packer (async)
    # before the entry becomes visible to ``_admit``
    row_tokens: Optional[np.ndarray] = None
    row_mask: Optional[np.ndarray] = None


@dataclass
class EngineStats:
    completed: int = 0
    steps: int = 0
    wall_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    latencies_dropped: int = 0  # oldest samples evicted by the window cap
    shapes: set = field(default_factory=set)

    # a long-lived engine keeps a bounded window: past the cap the oldest
    # half is evicted and counted, so the percentiles say what they cover
    _LAT_CAP = 65536

    def record_latency(self, dt_s: float):
        self.latencies_s.append(dt_s)
        if len(self.latencies_s) > self._LAT_CAP:
            drop = self._LAT_CAP // 2
            del self.latencies_s[:drop]
            self.latencies_dropped += drop

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_s) * 1e3
        return {
            "completed": self.completed,
            "steps": self.steps,
            "docs_per_s": round(self.completed / max(self.wall_s, 1e-9), 2),
            "p50_latency_ms": round(float(np.percentile(lat, 50)), 2)
            if len(lat) else None,
            "p95_latency_ms": round(float(np.percentile(lat, 95)), 2)
            if len(lat) else None,
            # the percentiles cover the latest `latency_window` completions
            "latency_window": len(lat),
            "latencies_dropped": self.latencies_dropped,
            "compiled_shapes": sorted(self.shapes),
        }


class ServeEngine:
    """Slot-based continuous batching over a frozen ``ModelSnapshot``, on
    the snapshot's device (the caller's current CUDA stream on the card).

    ``submit`` enqueues documents; ``run`` drives steps until the queue
    drains and returns {request id: (K,) mixture}. Documents longer than
    the largest bucket are truncated to it (fold-in over a prefix).
    ``trace_tag`` names the engine in its trace spans (a fleet worker's
    ``w{worker}.v{version}``).
    """

    def __init__(
        self, snap: ModelSnapshot, *, slots: int = 8, burnin: int = 16,
        impl: str = "cuda", buckets: Sequence[int] = DEFAULT_BUCKETS,
        base_seed: int = 0, async_admit: bool = False, trace_tag: str = "",
    ):
        if slots <= 0:
            raise ValueError("slots must be positive")
        if burnin < 1:
            # a document retires after >= 1 sweep; burnin=0 would differ
            # from foldin_docs(burnin=0) (init only) and break the bitwise
            # engine == direct fold-in contract
            raise ValueError("burnin must be >= 1")
        if impl not in F.IMPLS:
            raise ValueError(f"unknown fold-in impl {impl!r}; one of {F.IMPLS}")
        self.snap = snap
        self.device = snap.device
        self.slots = slots
        self.burnin = burnin
        self.impl = impl
        self.buckets = tuple(sorted(buckets))
        self.base_seed = int(base_seed)
        self.trace_tag = trace_tag
        self._pools: dict[int, _Slots] = {}
        self._queue: dict[int, list[_Pending]] = {b: [] for b in self.buckets}
        self._reqs: dict[int, _Pending] = {}          # in flight only
        self._completed: dict[int, np.ndarray] = {}   # drained by run()
        self._next_rid = 0
        self.stats = EngineStats()
        # async admission: packing queued documents into padded bucket rows
        # runs on a bounded daemon stage, beside the sweeps; it is value-
        # identical to the inline packing, so timing reaches no mixture
        self._packer: Optional[AsyncStage] = (
            AsyncStage(self._pack_and_enqueue, depth=4, name="ServeEngine.admit")
            if async_admit else None)

    def _pack_and_enqueue(self, item):
        p, bucket = item
        self._pack(p, bucket)
        self._queue[bucket].append(p)  # atomic under the GIL; seen by _admit

    def _pack(self, p: _Pending, bucket: int):
        n = min(p.tokens.size, bucket)
        row_t = np.zeros((bucket,), np.int32)
        row_m = np.zeros((bucket,), bool)
        row_t[:n] = p.tokens[:n]
        row_m[:n] = True
        p.row_tokens, p.row_mask = row_t, row_m
        p.tokens = None

    # -- request lifecycle -------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, tokens, *, seed: Optional[int] = None) -> int:
        """Enqueue one document (1-D word ids). ``seed`` defaults to the
        request id; it fully determines the fold-in randomness and must be
        unique among in-flight requests (it is the request id)."""
        tokens = np.asarray(tokens, np.int32).ravel()
        if tokens.size == 0:
            raise ValueError("empty document")
        rid = self._next_rid if seed is None else int(seed)
        if rid in self._reqs:
            raise ValueError(f"seed/request id {rid} already in flight")
        self._next_rid = max(self._next_rid, rid) + 1
        p = _Pending(rid=rid, tokens=tokens, submit_t=time.perf_counter())
        self._reqs[rid] = p
        bucket = self._bucket(tokens.size)
        tr = obs.tracer()
        if tr.enabled:
            tr.async_begin("request.queued", self._aid(rid), cat="serve",
                           bucket=bucket, tag=self.trace_tag)
        if self._packer is not None:
            self._packer.submit((p, bucket))  # packs and enqueues off-thread
        else:
            self._pack(p, bucket)
            self._queue[bucket].append(p)
        return rid

    def _aid(self, rid: int) -> str:
        """A request's async trace-event id (unique within the engine)."""
        return f"{self.trace_tag}:{rid}" if self.trace_tag else str(rid)

    # -- slot admission and retirement -------------------------------------
    def _admit(self, pool: _Slots, bucket: int):
        q = self._queue[bucket]
        admitted = False
        tr = obs.tracer()
        hist = obs.metrics().histogram("serve.queue_wait_ms", bucket=bucket)
        for s in range(self.slots):
            if pool.req[s] is not None or not q:
                continue
            p = q.pop(0)
            pool.tokens[s] = p.row_tokens
            pool.mask[s] = p.row_mask
            pool.seeds[s] = p.rid
            pool.sweeps[s] = 0
            pool.req[s] = p.rid
            p.row_tokens = p.row_mask = None
            p.admit_t = time.perf_counter()
            hist.observe((p.admit_t - p.submit_t) * 1e3)
            if tr.enabled:
                aid = self._aid(p.rid)
                tr.async_end("request.queued", aid, cat="serve")
                tr.async_begin("request.inflight", aid, cat="serve",
                               bucket=bucket, slot=s, tag=self.trace_tag)
            admitted = True
        if admitted:
            pool.mark_dirty()

    def _retire(self, pool: _Slots):
        done = [s for s in range(self.slots)
                if pool.req[s] is not None and pool.sweeps[s] >= self.burnin]
        if not done:
            return
        # mixtures of the retiring rows from the last sweep's m; the copy
        # to the host waits for this stream only
        rows = torch.tensor(done, dtype=torch.int64, device=self.device)
        theta = F.topic_mixture_from_m(pool.m[rows], self.snap.psi,
                                       self.snap.alpha).cpu().numpy()
        now = time.perf_counter()
        tr = obs.tracer()
        hist = obs.metrics().histogram("serve.service_ms", bucket=pool.tokens.shape[1])
        for i, s in enumerate(done):
            # evict the request: a long-lived engine keeps no per-request state
            p = self._reqs.pop(pool.req[s])
            self._completed[p.rid] = theta[i]
            self.stats.completed += 1
            self.stats.record_latency(now - p.submit_t)
            if p.admit_t is not None:
                hist.observe((now - p.admit_t) * 1e3)
            if tr.enabled:
                tr.async_end("request.inflight", self._aid(p.rid), cat="serve")
            pool.req[s] = None
            pool.mask[s] = False
        # the freed rows' device mask stays live until the next upload:
        # stale rows only cost sweep lanes, and a new request's row is
        # re-initialized in the step

    # -- the step loop ---------------------------------------------------------
    def step(self) -> bool:
        """Admit, sweep every bucket with in-flight work, retire. Returns
        False when nothing is in flight and the queue is empty."""
        busy = False
        for bucket in self.buckets:
            if self._queue[bucket] and bucket not in self._pools:
                self._pools[bucket] = _Slots.empty(self.slots, bucket, self.device)
            pool = self._pools.get(bucket)
            if pool is None:
                continue
            self._admit(pool, bucket)
            live = np.array([r is not None for r in pool.req])
            if not live.any():
                continue
            busy = True
            has_fresh = bool((live & (pool.sweeps == 0)).any())
            with obs.tracer().span("engine_step", cat="serve", bucket=bucket,
                                   tag=self.trace_tag):
                d_tokens, d_mask, d_seeds = pool.device_batch()
                sweeps = torch.tensor(pool.sweeps, device=self.device)
                pool.z, pool.m = _engine_step(
                    self.snap, d_tokens, d_mask, pool.z, d_seeds, sweeps,
                    self.base_seed, impl=self.impl, has_fresh=has_fresh)
            pool.sweeps[live] += 1
            self.stats.steps += 1
            self.stats.shapes.add((self.slots, bucket))
            self._retire(pool)
        return busy or any(self._queue.values())

    def drain_completed(self) -> dict[int, np.ndarray]:
        """Hand back (and forget) the mixtures completed since the last
        drain: the incremental ``run`` of fleet workers, which interleave
        the steps of several engines."""
        out, self._completed = self._completed, {}
        return out

    def in_flight(self) -> int:
        """Requests submitted but not yet completed (queued, being packed
        or in a slot)."""
        return len(self._reqs)

    def close(self):
        """Stop the admission packer, if any (idempotent)."""
        if self._packer is not None:
            self._packer.close()

    def run(self) -> dict[int, np.ndarray]:
        """Drive steps until the queue drains; returns {rid: mixture} for
        the requests completed since the previous ``run`` (drained, not
        retained)."""
        if self._packer is not None:
            self._packer.flush()  # everything submitted is admissible
        t0 = time.perf_counter()
        while self.step():
            pass
        self.stats.wall_s += time.perf_counter() - t0
        return self.drain_completed()
