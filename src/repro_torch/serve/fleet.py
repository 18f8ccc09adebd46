"""Replicated serving fleet (counterpart of ``repro/serve/fleet.py``): N
continuous-batching engines behind one admission router, fed by a
snapshot registry.

With (Phi, Psi) frozen, a query's fold-in touches only read-only tables
and its own slots, so engines replicate with no coordination beyond
dispatch. A ``ServeFleet`` runs one worker thread per engine (by default
one per card), each with its own device and, on the card, its own CUDA
stream; several workers may share one card, each on its stream. A
snapshot is copied to a worker's device only where it lies elsewhere;
otherwise the workers share its tensors, read-only.

A request's mixture is bitwise the single ``ServeEngine``'s for the same
(snapshot, base_seed, seed, tokens), whatever the worker count, the
dispatch order, the admission time or a concurrent registry publish: it
follows from the fold-in randomness contract (``serve/foldin.py``).

Hot swap: workers watching a ``SnapshotRegistry`` re-check ``latest``
between engine steps. After a publish, NEW admissions bind to the new
version while in-flight slots finish on the engine (hence the snapshot)
they started on; a drained old engine is then discarded.

Ensembles: ``ensemble=E`` fans each request out to the E newest registry
versions; the router averages the E mixtures in ascending version order,
so the result is deterministic given (version set, seed).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serve.engine import DEFAULT_BUCKETS, ServeEngine
from repro_torch.serve.registry import SnapshotRegistry
from repro_torch.serve.router import AdmissionRouter, Task
from repro_torch.serve.snapshot import ModelSnapshot

_PINNED = -1  # engine key of a fleet built from a bare snapshot


class _Worker(threading.Thread):
    """One fleet worker: a device (and its own stream on the card), a
    dict of per-version engines, and a pull -> admit -> step -> post
    loop."""

    def __init__(self, fleet: "ServeFleet", wid: int, device: torch.device):
        super().__init__(daemon=True, name=f"ServeFleet.worker{wid}")
        self.fleet = fleet
        self.wid = wid
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)
        self.engines: dict[int, ServeEngine] = {}
        self.tasks: dict[tuple[int, int], Task] = {}  # (version, rid)
        self.completed = 0
        self.steps_retired = 0          # steps of already-discarded engines
        self.swaps = 0
        self.error: Optional[BaseException] = None
        self._warm_bucket: Optional[int] = None

    # -- engines -----------------------------------------------------------
    def _engine(self, version: int) -> ServeEngine:
        eng = self.engines.get(version)
        if eng is None:
            f = self.fleet
            eng = ServeEngine(
                f._snapshot(version).to(self.device), slots=f.slots,
                burnin=f.burnin, impl=f.impl, buckets=f.buckets,
                base_seed=f.base_seed, async_admit=True,
                trace_tag=f"w{self.wid}.v{version}")
            self.engines[version] = eng
        return eng

    def _discard_drained(self, current: int):
        for v, eng in list(self.engines.items()):
            if v != current and eng.in_flight() == 0:
                if eng.stats.steps:
                    self.swaps += 1
                self.steps_retired += eng.stats.steps
                eng.close()
                del self.engines[v]

    # -- the loop ----------------------------------------------------------
    def _tick(self) -> bool:
        f = self.fleet
        f._maybe_poll()
        self._engine(f._target_version)  # the admission target exists
        # a worker's capacity is `slots` in all across its engines: counting
        # only the current engine would let version-pinned (ensemble)
        # subtasks pile into the other engines' unbounded queues, defeating
        # the router's max_pending backpressure
        inflight = sum(e.in_flight() for e in self.engines.values())
        free = max(f.slots - inflight, 0)
        # a worker with slots in flight keeps sweeping (timeout 0); only an
        # idle one waits for work
        idle = inflight == 0
        pulled = (f.router.pull(free, prefer=self._warm_bucket,
                                timeout=0.05 if idle else 0.0)
                  if free else [])
        # bind version-less tasks after the (blocking) pull: a hot swap
        # that lands while this worker waits redirects every task it then
        # pulls (the swap boundary is engine admission)
        current = f._target_version
        for t in pulled:
            version = current if t.version is None else t.version
            self._engine(version).submit(t.tokens, seed=t.rid)
            self.tasks[(version, t.rid)] = t
            self._warm_bucket = t.bucket
        busy = False
        for v, e in list(self.engines.items()):
            if not e.in_flight():
                continue
            busy |= e.step()
            done = e.drain_completed()
            # counted before posting: a caller whose run() returns on the
            # last post then reads every count in stats_summary
            self.completed += len(done)
            for rid, theta in done.items():
                f.router.post(self.tasks.pop((v, rid)), theta)
        self._discard_drained(current)
        return bool(pulled) or busy

    def _on_device(self) -> contextlib.ExitStack:
        """The worker's card and stream, which are per thread in torch."""
        stack = contextlib.ExitStack()
        if self.stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self.stream))
        return stack

    def run(self):
        try:
            with self._on_device():
                while not self.fleet._stop.is_set():
                    self._tick()  # pull() blocks briefly when idle
        except BaseException as e:  # surfaced by ServeFleet.run/close
            self.error = e
        finally:
            for eng in self.engines.values():
                try:
                    eng.close()
                except Exception:
                    pass

    # -- stats -------------------------------------------------------------
    def summary(self) -> dict:
        engines = list(self.engines.values())  # the worker may mutate the dict
        return {
            "worker": self.wid,
            "device": str(self.device),
            "completed": self.completed,
            "steps": self.steps_retired + sum(e.stats.steps for e in engines),
            "snapshot_swaps": self.swaps,
            "compiled_shapes": sorted(
                {s for e in engines for s in list(e.stats.shapes)}),
        }


class ServeFleet:
    """N replicated ``ServeEngine`` workers behind an admission router.

    ``source`` is a frozen ``ModelSnapshot`` (a fixed fleet) or a
    ``SnapshotRegistry`` (serves ``latest``; with ``watch_registry``
    hot-swaps on publish; with ``ensemble=E`` fans every request out to
    the E newest versions and averages). ``device`` is "cuda" (default:
    ``workers`` defaults to the card count, worker w on card w mod count)
    or "cpu" (default 1 worker).

    ``slo_ms`` turns on the router's SLO accounting (ok/miss counts
    against the end-to-end latency, in ``stats_summary``).

    ``submit``/``run`` mirror ``ServeEngine``: submit enqueues (blocking
    under backpressure beyond ``max_pending`` queued subtasks), ``run``
    blocks until everything submitted has completed and hands back
    {rid: mixture}, drained. Use it as a context manager or ``close()``
    it: workers are threads.
    """

    def __init__(
        self,
        source: Union[ModelSnapshot, SnapshotRegistry],
        *,
        workers: Optional[int] = None,
        slots: int = 8,
        burnin: int = 16,
        impl: str = "cuda",
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        base_seed: int = 0,
        ensemble: int = 1,
        watch_registry: bool = False,
        max_pending: int = 1024,
        poll_registry_s: float = 0.05,
        slo_ms: Optional[float] = None,
        device: torch.device | str = "cuda",
    ):
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
        if workers is None:
            workers = len(devices)
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if ensemble < 1:
            raise ValueError("ensemble must be >= 1")
        self.registry = source if isinstance(source, SnapshotRegistry) else None
        if self.registry is None:
            if watch_registry:
                raise ValueError("watch_registry needs a SnapshotRegistry")
            if ensemble > 1:
                raise ValueError("ensemble > 1 needs a SnapshotRegistry")
            if source.device.type == "cuda":
                # the workers' streams read the snapshot: finish its making
                torch.cuda.synchronize(source.device)
            self._snap_cache: dict[int, ModelSnapshot] = {_PINNED: source}
            self._target_version = _PINNED
        else:
            latest = self.registry.latest_version()
            if latest is None:
                raise FileNotFoundError(
                    f"registry {self.registry.path!r} has no published "
                    "versions to serve")
            self._snap_cache = {}
            self._target_version = latest
        self.slots = slots
        self.burnin = burnin
        self.impl = impl
        self.buckets = tuple(sorted(buckets))
        self.base_seed = int(base_seed)
        self.ensemble = ensemble
        self.watch = watch_registry
        self.poll_registry_s = poll_registry_s
        self.router = AdmissionRouter(buckets=self.buckets, max_pending=max_pending,
                                      slo_ms=slo_ms)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._last_poll = 0.0
        self._next_rid = 0
        self._wall_s = 0.0
        self._t0: Optional[float] = None
        self.workers = [_Worker(self, w, devices[w % len(devices)])
                        for w in range(workers)]
        for w in self.workers:
            w.start()

    # -- snapshots and the registry ----------------------------------------
    def _snapshot(self, version: int) -> ModelSnapshot:
        """A version's snapshot, loaded once onto the host (each worker
        copies it to its own device)."""
        with self._lock:
            snap = self._snap_cache.get(version)
            if snap is None:
                snap = self._snap_cache[version] = self.registry.load(
                    version, device="cpu")
                # bound the host cache across many hot swaps; a dropped
                # entry costs at most a reload
                cap = max(8, self.ensemble + 2)
                for v in sorted(self._snap_cache):
                    if len(self._snap_cache) <= cap:
                        break
                    if v not in (version, self._target_version, _PINNED):
                        del self._snap_cache[v]
            return snap

    def _maybe_poll(self):
        """Rate-limited registry re-check (workers call it between engine
        steps when ``watch_registry`` is on)."""
        if not self.watch:
            return
        now = time.perf_counter()
        with self._lock:
            if now - self._last_poll < self.poll_registry_s:
                return
            self._last_poll = now
        self.refresh_registry()

    def refresh_registry(self):
        """Re-read the registry's latest version now. After it returns,
        every admission that has not reached an engine binds to the new
        version (in-flight slots are untouched). The target only moves
        forward: a worker's poll may race a publish, and a stale read
        must never swap the fleet back to an older snapshot."""
        if self.registry is None:
            return
        latest = self.registry.latest_version()
        with self._lock:
            if latest is not None and latest > self._target_version:
                self._target_version = latest

    # -- request lifecycle -------------------------------------------------
    def submit(self, tokens, *, seed: Optional[int] = None,
               timeout: Optional[float] = None) -> int:
        """Enqueue one document. ``seed`` defaults to the request id and
        fully determines the fold-in randomness (as in
        ``ServeEngine.submit``); blocks under backpressure."""
        self._raise_worker_errors()
        versions = None
        if self.ensemble > 1:
            versions = self.registry.latest_versions(self.ensemble)
        with self._lock:
            rid = self._next_rid if seed is None else int(seed)
            self._next_rid = max(self._next_rid, rid) + 1
            if self._t0 is None:
                self._t0 = time.perf_counter()
        self.router.submit(rid, tokens, versions=versions, timeout=timeout)
        return rid

    def run(self, timeout: Optional[float] = None) -> dict[int, np.ndarray]:
        """Block until every submitted request has completed; returns
        {rid: mixture}, drained. Worker failures surface here."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            self._raise_worker_errors()
            left = (None if deadline is None
                    else max(deadline - time.perf_counter(), 0.0))
            try:
                out = self.router.drain(timeout=0.5 if left is None else min(left, 0.5))
                break
            except TimeoutError:
                if deadline is not None and time.perf_counter() >= deadline:
                    raise
        with self._lock:
            if self._t0 is not None:
                self._wall_s += time.perf_counter() - self._t0
                self._t0 = None
        return out

    def _raise_worker_errors(self):
        for w in self.workers:
            if w.error is not None:
                err, w.error = w.error, None
                raise RuntimeError(f"fleet worker {w.wid} failed") from err

    # -- stats and lifecycle -----------------------------------------------
    def stats_summary(self) -> dict:
        per_worker = [w.summary() for w in self.workers]
        # requests completed, from the router: an ensemble request counts
        # once here, while the per-worker counts are engine subtasks
        completed = self.router.completed_total()
        wall = self._wall_s + (time.perf_counter() - self._t0
                               if self._t0 is not None else 0.0)
        return {
            "workers": len(self.workers),
            "ensemble": self.ensemble,
            "completed": completed,
            "steps": sum(s["steps"] for s in per_worker),
            "snapshot_swaps": sum(s["snapshot_swaps"] for s in per_worker),
            "wall_s": round(wall, 3),
            "docs_per_s": round(completed / max(wall, 1e-9), 2),
            **self.router.latency_summary(),
            "per_worker": per_worker,
        }

    def close(self):
        """Stop the workers and release their engines (idempotent)."""
        self._stop.set()
        self.router.close()
        for w in self.workers:
            w.join(timeout=60)
        alive = [w.wid for w in self.workers if w.is_alive()]
        if alive:
            raise RuntimeError(f"fleet workers {alive} failed to stop")
        self._raise_worker_errors()

    def __enter__(self) -> "ServeFleet":
        return self

    def __exit__(self, *exc):
        self.close()
