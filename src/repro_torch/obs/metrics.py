"""Thread-safe metrics registry: counters, gauges, histograms + a JSONL
sink (the port's copy of ``repro/obs/metrics.py``: the same classes and
the same snapshot schema, so one reader serves both packages' files).

One registry instance (usually the process-global one in
``repro_torch.obs``) is the publication point for every subsystem: the
streaming trainer's model-health gauges (live K*, delta_n sparsity —
the "doubly sparse" quantities the paper's speed argument rests on),
the zstore's byte counters, and the serving fleet's per-bucket latency
histograms and SLO counters all land here under dotted names with
optional label sets, e.g. ``serve.latency_ms{bucket=64}``.

Updating a metric is always legal and always cheap (a dict lookup plus
a per-metric lock) — the registry is *always on*. What is opt-in is the
JSONL sink: ``MetricsLogger`` appends one self-describing snapshot line
per flush (see ``MetricsRegistry.snapshot`` for the schema), either on
an explicit cadence (the trainer flushes at iteration boundaries) or on
a periodic daemon thread. ``launch/monitor.py`` tails and summarizes
the resulting file; ``chip_smoke.py`` phase 10 checks the trainer's
file on the card.

Schema (one JSON object per line):

    {"ts": <unix seconds>,
     "proc": str,   # stable per-process shard label (shard-merge key)
     "seq": int,    # per-logger snapshot sequence number (0, 1, ...)
     "metrics": [
       {"name": str, "type": "counter",   "labels": {..}, "value": num},
       {"name": str, "type": "gauge",     "labels": {..}, "value": num},
       {"name": str, "type": "histogram", "labels": {..},
        "count": int, "sum": num, "le": [edge...],
        "bucket_counts": [int...]}   # len == len(le) + 1 (+inf bucket)
    ]}

``proc``/``seq`` are what make a *directory* of per-process shard files
mergeable (``launch/monitor.py --merge``): counters sum across procs,
gauges resolve last-write by (ts, seq), histogram bucket counts add.
Readers must tolerate their absence — pre-shard files carried only
``ts`` + ``metrics``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional, Sequence

# Shared default edges for millisecond-scale latency histograms: dense
# where serving latencies live (1-500ms), sparse above.
LATENCY_MS_EDGES = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                    500.0, 1000.0, 2000.0, 5000.0)


def hist_percentile(edges: Sequence[float], counts: Sequence[float],
                    q: float) -> Optional[float]:
    """Estimated q-th percentile (q in [0, 100]) from histogram bucket
    counts — the one shared implementation behind
    ``Histogram.percentile`` and the monitor/dashboard readouts.

    The rank is linearly interpolated *within* the winning bucket
    (``lo + frac * (hi - lo)``), never snapped to an edge. Degenerate
    inputs resolve instead of crashing or fabricating values: an empty
    histogram (or one with no finite edges) returns None, and a rank
    landing in the unbounded overflow bucket clamps to the last finite
    edge — a lower bound, which is the only honest answer there.
    """
    edges = list(edges)
    counts = list(counts)
    total = sum(counts)
    if total <= 0 or not edges:
        return None
    rank = q / 100.0 * total
    seen = 0.0
    for i, c in enumerate(counts):
        if c > 0 and seen + c >= rank:
            if i >= len(edges):  # unbounded overflow bucket
                return float(edges[-1])
            lo = 0.0 if i == 0 else float(edges[i - 1])
            hi = float(edges[i])
            frac = min(max((rank - seen) / c, 0.0), 1.0)
            return lo + frac * (hi - lo)
        seen += c
    return float(edges[-1])


class Counter:
    """Monotone accumulator. ``inc`` only ever adds a non-negative
    amount, so rates derived from successive snapshots are meaningful."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self.value += n

    def snapshot_value(self):
        return {"value": self.value}


class Gauge:
    """Last-write-wins instantaneous value (``set``), with a
    ``set_max`` convenience for high-water marks."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def set(self, v):
        with self._lock:
            self.value = v

    def set_max(self, v):
        with self._lock:
            if v > self.value:
                self.value = v

    def snapshot_value(self):
        return {"value": self.value}


class Histogram:
    """Fixed-bucket-edge histogram: ``observe(v)`` lands in the first
    bucket with ``v <= edge`` (one overflow bucket past the last edge).
    Fixed edges make snapshots mergeable and keep ``observe`` O(log E)
    with zero allocation — the registry never samples or decays.

    ``percentile(q)`` linearly interpolates inside the winning bucket —
    an estimate bounded by the bucket width, good enough for the
    monitor's p50/p95 readout (exact percentiles stay with the
    engines' raw-sample summaries)."""

    kind = "histogram"

    def __init__(self, edges: Sequence[float]):
        edges = tuple(float(e) for e in edges)
        if not edges or list(edges) != sorted(set(edges)):
            raise ValueError(
                f"histogram edges must be strictly increasing, got {edges}"
            )
        self.edges = edges
        self._lock = threading.Lock()
        self.bucket_counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float):
        lo, hi = 0, len(self.edges)
        while lo < hi:  # first edge >= v
            mid = (lo + hi) // 2
            if v <= self.edges[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.bucket_counts[lo] += 1
            self.count += 1
            self.sum += v

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]) from the bucket
        counts; None when empty. See ``hist_percentile`` for the
        interpolation and overflow-bucket semantics."""
        with self._lock:
            counts = list(self.bucket_counts)
        return hist_percentile(self.edges, counts, q)

    def snapshot_value(self):
        with self._lock:
            return {"count": self.count, "sum": round(self.sum, 6),
                    "le": list(self.edges),
                    "bucket_counts": list(self.bucket_counts)}


class MetricsRegistry:
    """Get-or-create metric families keyed by (name, sorted labels).

    ``counter``/``gauge``/``histogram`` return the live metric object;
    repeated calls with the same key return the same object, so call
    sites never cache handles unless they are hot. Requesting an
    existing name as a different type (or a histogram with different
    edges) raises — silently forked metrics are unfindable bugs."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))

    def _get(self, name, labels, factory, kind, check=None):
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = factory()
            elif m.kind != kind:
                raise ValueError(
                    f"metric {name!r}{labels} already registered as "
                    f"{m.kind}, requested as {kind}"
                )
            elif check is not None:
                check(m)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter, "counter")

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge, "gauge")

    def histogram(self, name: str, edges: Sequence[float] = LATENCY_MS_EDGES,
                  **labels) -> Histogram:
        want = tuple(float(e) for e in edges)

        def check(m):
            if m.edges != want:
                raise ValueError(
                    f"histogram {name!r}{labels} already registered with "
                    f"edges {m.edges}, requested {want}"
                )

        return self._get(name, labels, lambda: Histogram(want),
                         "histogram", check)

    def get(self, name: str, **labels):
        """The live metric, or None — read-side lookup for tests and
        the monitor (never creates)."""
        return self._metrics.get(self._key(name, labels))

    def snapshot(self) -> list[dict]:
        """Self-describing list of every registered metric's current
        value (the ``metrics`` field of one JSONL line)."""
        with self._lock:
            items = list(self._metrics.items())
        out = []
        for key, m in sorted(items, key=lambda kv: kv[0]):
            name, labels = key[0], dict(key[1:])
            out.append({"name": name, "type": m.kind, "labels": labels,
                        **m.snapshot_value()})
        return out

    def reset(self):
        """Drop every metric (tests; a fresh process state without a
        fresh process)."""
        with self._lock:
            self._metrics.clear()


class MetricsLogger:
    """JSONL sink over one registry: each ``flush`` appends one
    snapshot line. ``every_s`` adds a periodic daemon flusher on top of
    explicit flush calls (the trainer flushes at iteration boundaries,
    a serving fleet on the period). ``min_interval_s`` rate-limits
    explicit ``flush(force=False)`` calls so a tight caller loop cannot
    bloat the file.

    Every line carries a stable ``proc`` shard label (``proc`` arg,
    else ``$REPRO_METRICS_PROC``, else ``pid<pid>``) and a monotone
    ``seq`` number, which is what lets ``monitor.py --merge`` reduce a
    directory of per-process shard files correctly. The logger also
    accounts for its own behavior — ``flushes`` (lines written),
    ``suppressed`` (rate-limited ``flush(force=False)`` calls) and
    ``dropped`` (flush attempts after close, i.e. data that never
    reached the file) — surfaced by ``obs.finalize()``.
    """

    def __init__(self, registry: MetricsRegistry, path: str, *,
                 every_s: Optional[float] = None,
                 min_interval_s: float = 0.0,
                 proc: Optional[str] = None):
        self.registry = registry
        self.path = path
        self.min_interval_s = min_interval_s
        self.proc = (proc or os.environ.get("REPRO_METRICS_PROC")
                     or f"pid{os.getpid()}")
        self.seq = 0
        self.flushes = 0
        self.suppressed = 0
        self.dropped = 0
        self._f = open(path, "a")
        self._lock = threading.Lock()
        self._last_flush = 0.0
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        if every_s:
            self._thread = threading.Thread(
                target=self._loop, args=(every_s,), daemon=True,
                name="MetricsLogger",
            )
            self._thread.start()

    def _loop(self, every_s: float):
        while not self._stop.wait(every_s):
            self.flush(force=True)

    def flush(self, force: bool = True):
        """Append one snapshot line. ``force=False`` respects
        ``min_interval_s``; a flush after close counts as ``dropped``
        (late data that never reached the file)."""
        now = time.time()
        with self._lock:
            if self._closed:
                self.dropped += 1
                return
            if not force and now - self._last_flush < self.min_interval_s:
                self.suppressed += 1
                return
            self._last_flush = now
            line = json.dumps(
                {"ts": round(now, 3), "proc": self.proc, "seq": self.seq,
                 "metrics": self.registry.snapshot()}
            )
            self._f.write(line + "\n")
            self._f.flush()
            self.seq += 1
            self.flushes += 1

    def stats(self) -> dict:
        """The sink's own accounting (surfaced by ``obs.finalize()``)."""
        with self._lock:
            return {"proc": self.proc, "flushes": self.flushes,
                    "suppressed": self.suppressed, "dropped": self.dropped}

    def close(self):
        """Final snapshot + stop the periodic flusher (idempotent)."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
        self.flush(force=True)
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()
