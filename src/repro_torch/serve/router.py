"""Async admission router (counterpart of ``repro/serve/router.py``):
the shared front door of a serving fleet.

One router sits between callers and N fleet workers:

  * **admission queue with backpressure** — ``submit`` appends subtasks
    to per-bucket FIFO queues and blocks while ``max_pending`` subtasks
    are already queued, so a burst of callers cannot grow host memory
    unboundedly; workers pulling work releases the backpressure.
  * **bucket-aware dispatch** — a worker's ``pull`` drains up to its
    free slot count from ONE bucket (preferring the bucket it already
    has a warm pool for, else the deepest queue), so slot batches stay
    shape-homogeneous instead of fragmenting admissions across buckets.
  * **ensemble fan-out / aggregation** — with ``versions`` a request
    becomes E subtasks pinned to E registry snapshot versions; ``post``
    collects the per-version mixtures and averages them in ascending
    version order once all E arrived. Fixed order + fixed f32 reduction
    makes the ensemble result deterministic given (version set, seed),
    independent of worker count or completion order.

Dispatch policy is deliberately free to be greedy/racy: a document's
mixture depends only on (snapshot, base_key, seed, tokens) — the
fold-in randomness contract — never on which worker computed it, so
load balancing cannot perturb results.

The router reports into ``repro_torch.obs`` as the reference's does: a
``serve.queue_depth`` gauge a bucket, a ``request`` async span per
request, and at completion the ``serve.latency_ms`` histogram and the
``serve.slo_ok``/``serve.slo_miss`` counters a bucket.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from repro_torch import obs


@dataclass
class Task:
    """One unit of worker work: a (document, snapshot-version) pair.

    ``version`` is an explicit registry version for ensemble subtasks;
    ``None`` binds to the worker's current version at engine-admission
    time (which is what lets a registry hot-swap redirect QUEUED work to
    the new snapshot while in-flight slots finish on the old one).
    """
    rid: int
    tokens: np.ndarray
    bucket: int
    version: Optional[int]
    submit_t: float


@dataclass
class _Outstanding:
    versions: tuple          # () for version=None requests
    got: dict = field(default_factory=dict)  # version-slot -> (K,) theta
    submit_t: float = 0.0


class AdmissionRouter:
    """Bounded shared admission queue + result aggregation.

    ``slo_ms`` (optional) turns on SLO accounting: every completed
    request's end-to-end latency is classified against the threshold
    into the router's ok / miss tallies, which ``latency_summary``
    reports.
    """

    _LAT_CAP = 65536  # raw end-to-end latency sample window

    def __init__(self, *, buckets: Sequence[int], max_pending: int = 1024,
                 slo_ms: Optional[float] = None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms}")
        self.buckets = tuple(sorted(buckets))
        self.max_pending = max_pending
        self.slo_ms = slo_ms
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # workers wait here
        self._space = threading.Condition(self._lock)  # submitters wait here
        self._done = threading.Condition(self._lock)   # drainers wait here
        self._queues: dict[int, deque] = {b: deque() for b in self.buckets}
        self._queued = 0
        self._outstanding: dict[int, _Outstanding] = {}
        self._completed: dict[int, np.ndarray] = {}
        self._completed_total = 0  # requests ever completed (not drained)
        self._latencies: list[float] = []
        self._latencies_dropped = 0
        self._slo_ok = 0
        self._slo_miss = 0
        self._closed = False

    def _depth_gauge(self, bucket: int):
        return obs.metrics().gauge("serve.queue_depth", bucket=bucket)

    # -- admission ---------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def submit(self, rid: int, tokens: np.ndarray, *,
               versions: Optional[Sequence[int]] = None,
               timeout: Optional[float] = None) -> int:
        """Enqueue one request; blocks while the router is at
        ``max_pending`` queued subtasks (backpressure). ``versions``
        pins the ensemble fan-out set; None routes to each worker's
        current snapshot."""
        tokens = np.asarray(tokens, np.int32).ravel()
        if tokens.size == 0:
            raise ValueError("empty document")
        vset = tuple(sorted(versions)) if versions else ()
        if len(set(vset)) != len(vset):
            raise ValueError(f"duplicate ensemble versions {vset}")
        n_sub = max(len(vset), 1)
        bucket = self._bucket(tokens.size)
        now = time.perf_counter()
        with self._lock:
            if rid in self._outstanding or rid in self._completed:
                raise ValueError(f"request id {rid} already in flight")
            deadline = None if timeout is None else now + timeout
            while self._queued + n_sub > self.max_pending:
                if self._closed:
                    raise RuntimeError("router is closed")
                wait = (None if deadline is None
                        else deadline - time.perf_counter())
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"router backpressure: {self._queued} subtasks "
                        f"queued (max_pending={self.max_pending})"
                    )
                self._space.wait(timeout=wait)
            if self._closed:
                raise RuntimeError("router is closed")
            self._outstanding[rid] = _Outstanding(
                versions=vset, submit_t=now
            )
            for v in (vset or (None,)):
                self._queues[bucket].append(Task(
                    rid=rid, tokens=tokens, bucket=bucket, version=v,
                    submit_t=now,
                ))
                self._queued += 1
            self._depth_gauge(bucket).set(len(self._queues[bucket]))
            self._work.notify_all()
        tr = obs.tracer()
        if tr.enabled:
            tr.async_begin("request", rid, cat="router", bucket=bucket,
                           subtasks=n_sub)
        return rid

    # -- dispatch ----------------------------------------------------------
    def pull(self, max_tasks: int, *, prefer: Optional[int] = None,
             timeout: float = 0.05) -> list[Task]:
        """Take up to ``max_tasks`` subtasks from ONE bucket queue —
        ``prefer`` if non-empty (the worker's warm pool), else the
        deepest queue. Blocks up to ``timeout`` for work; returns []
        on timeout or close. Workers with in-flight slots pass
        ``timeout=0`` — they must keep sweeping, not park here."""
        if max_tasks <= 0:
            return []
        with self._lock:
            if timeout > 0 and self._queued == 0 and not self._closed:
                self._work.wait(timeout=timeout)
            bucket = None
            if prefer is not None and self._queues.get(prefer):
                bucket = prefer
            else:
                depth, bucket = max(
                    ((len(q), b) for b, q in self._queues.items()),
                    key=lambda t: t[0],
                )
                if depth == 0:
                    return []
            q = self._queues[bucket]
            out = []
            while q and len(out) < max_tasks:
                out.append(q.popleft())
            self._queued -= len(out)
            if out:
                self._depth_gauge(bucket).set(len(q))
                self._space.notify_all()
            return out

    # -- results -----------------------------------------------------------
    def post(self, task: Task, theta: np.ndarray):
        """Deliver one subtask result. When a request's full version set
        has arrived, its mixtures are averaged in ascending version
        order (deterministic) and the request completes."""
        with self._lock:
            o = self._outstanding.get(task.rid)
            if o is None:
                return  # late duplicate after a drain; drop
            slot = task.version if o.versions else None
            o.got[slot] = np.asarray(theta)
            need = o.versions or (None,)
            if len(o.got) < len(need):
                return
            parts = [o.got[v] for v in need]  # ascending version order
            theta = (parts[0] if len(parts) == 1 else
                     np.mean(np.stack(parts), axis=0, dtype=np.float32))
            del self._outstanding[task.rid]
            self._completed[task.rid] = theta
            self._completed_total += 1
            lat_s = time.perf_counter() - o.submit_t
            self._latencies.append(lat_s)
            if len(self._latencies) > self._LAT_CAP:
                drop = self._LAT_CAP // 2
                del self._latencies[:drop]
                self._latencies_dropped += drop
            lat_ms = lat_s * 1e3
            M = obs.metrics()
            M.histogram("serve.latency_ms", bucket=task.bucket).observe(lat_ms)
            if self.slo_ms is not None:
                if lat_ms <= self.slo_ms:
                    self._slo_ok += 1
                    M.counter("serve.slo_ok", bucket=task.bucket).inc()
                else:
                    self._slo_miss += 1
                    M.counter("serve.slo_miss", bucket=task.bucket).inc()
            tr = obs.tracer()
            if tr.enabled:
                tr.async_end("request", task.rid, cat="router")
            self._done.notify_all()

    def drain(self, timeout: Optional[float] = None) -> dict:
        """Block until nothing is queued or outstanding; hand back (and
        forget) every completed {rid: mixture} since the last drain."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while self._outstanding or self._queued:
                wait = None if deadline is None else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    raise TimeoutError(
                        f"drain timed out with {len(self._outstanding)} "
                        f"outstanding / {self._queued} queued"
                    )
                self._done.wait(timeout=1.0 if wait is None else min(wait, 1.0))
            out, self._completed = self._completed, {}
            return out

    # -- lifecycle / stats -------------------------------------------------
    def close(self):
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
            self._done.notify_all()

    def queued(self) -> int:
        with self._lock:
            return self._queued

    def completed_total(self) -> int:
        """Requests fully completed since construction (an ensemble
        request counts once, not per subtask)."""
        with self._lock:
            return self._completed_total

    def latency_summary(self) -> dict:
        with self._lock:
            lat = np.asarray(self._latencies) * 1e3
            dropped = self._latencies_dropped
            slo_ok, slo_miss = self._slo_ok, self._slo_miss
        out = {
            "p50_latency_ms": round(float(np.percentile(lat, 50)), 2)
            if len(lat) else None,
            "p95_latency_ms": round(float(np.percentile(lat, 95)), 2)
            if len(lat) else None,
            # percentiles cover the most recent `latency_window` samples
            "latency_window": int(len(lat)),
            "latencies_dropped": dropped,
        }
        if self.slo_ms is not None:
            out.update(slo_ms=self.slo_ms, slo_ok=slo_ok,
                       slo_miss=slo_miss)
        return out
