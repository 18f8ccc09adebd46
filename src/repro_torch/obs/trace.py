"""Span tracer emitting Chrome trace-event JSON (Perfetto-loadable); the
port's copy of ``repro/obs/trace.py``, the same events and tracks.

The streaming hot loop is a four-thread pipeline — prefetcher pre-stage
(disk z read), H2D stager, the dispatching driver, and the D2H
write-back daemon — and its whole point is *overlap*. A serialized
profile (``repro_torch.perf.PhaseTimers``) can say which phase costs most,
but only a per-thread timeline shows whether the overlap actually
happens and where the bubbles are. ``SpanTracer`` records wall-time
spans from any thread and serializes them in the Chrome trace-event
format, one track per thread, so ``chrome://tracing`` / Perfetto
(https://ui.perfetto.dev) render the pipeline directly.

Event kinds used (see the trace-event format spec):

  * ``X`` complete events — a named span with ``ts``/``dur`` in
    microseconds, on the emitting thread's track (``span``).
  * ``b``/``e`` async events — request-scoped spans that start and end
    on different threads (a serve request's queue wait spans submit on
    the caller thread to slot-bind on a worker), grouped by
    ``(cat, id)`` (``async_begin``/``async_end``).
  * ``i`` instant events (``instant``) and ``M`` metadata (thread
    names, emitted automatically on a thread's first span).

Disabled (the default), every emit point is one attribute check
returning a shared no-op context manager — the hot loop's per-block
cost is a few hundred nanoseconds, far below the <3% budget the
acceptance bar sets, and the recorded computation is untouched either
way (tracing never syncs the device; spans around async dispatches
measure dispatch, while device-side work shows up in the write-back
thread's materialize span, which is where the pipeline waits on it).

Events buffer in memory (bounded by ``max_events``; overflow drops and
counts) and land on ``save()``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer, name, cat, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._emit_complete(
            self._name, self._cat, self._t0, t1 - self._t0, self._args
        )
        return False


class SpanTracer:
    """Collects trace events; disabled until ``start()``.

    All timestamps come from ``time.perf_counter`` relative to the
    tracer's epoch (set at ``start``), so spans recorded on different
    threads share one monotonic timeline.
    """

    def __init__(self, max_events: int = 2_000_000):
        self.enabled = False
        self.max_events = max_events
        self.dropped = 0
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._epoch = time.perf_counter()
        # thread ident -> (small tid, thread name). The name is part of
        # the entry because the OS reuses idents: a pipeline thread that
        # dies between iterations can hand its ident to a differently
        # named successor, which must get its OWN track, not the old one.
        self._tids: dict[int, tuple[int, str]] = {}
        self._next_tid = 0
        self._path: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, path: Optional[str] = None):
        """Begin recording; ``path`` (if given) is the default
        ``save()`` destination."""
        with self._lock:
            self._path = path or self._path
            self._epoch = time.perf_counter()
            self._events.clear()
            self._tids.clear()
            self._next_tid = 0
            self.dropped = 0
            self.enabled = True

    def stop(self):
        self.enabled = False

    # -- emit --------------------------------------------------------------
    def _now_us(self, t: Optional[float] = None) -> float:
        t = time.perf_counter() if t is None else t
        return (t - self._epoch) * 1e6

    def _tid_locked(self) -> int:
        th = threading.current_thread()
        ent = self._tids.get(th.ident)
        if ent is None or ent[1] != th.name:
            tid = self._next_tid
            self._next_tid += 1
            self._tids[th.ident] = (tid, th.name)
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": th.name},
            })
            return tid
        return ent[0]

    def _append(self, ev_fn):
        """Append under the lock unless the buffer is full. ``ev_fn``
        builds the event dict after the tid is known."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev_fn(self._tid_locked()))

    def _emit_complete(self, name, cat, t0, dur, args):
        ts, dur_us = self._now_us(t0), dur * 1e6
        self._append(lambda tid: {
            "ph": "X", "name": name, "cat": cat or "span", "pid": 1,
            "tid": tid, "ts": round(ts, 3), "dur": round(dur_us, 3),
            **({"args": args} if args else {}),
        })

    def span(self, name: str, cat: str = "", **args):
        """Context manager timing a same-thread span; the no-op
        singleton when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "", **args):
        if not self.enabled:
            return
        ts = self._now_us()
        self._append(lambda tid: {
            "ph": "i", "s": "t", "name": name, "cat": cat or "instant",
            "pid": 1, "tid": tid, "ts": round(ts, 3),
            **({"args": args} if args else {}),
        })

    def _emit_async(self, ph, name, cat, aid, args):
        if not self.enabled:
            return
        ts = self._now_us()
        self._append(lambda tid: {
            "ph": ph, "name": name, "cat": cat, "id": str(aid), "pid": 1,
            "tid": tid, "ts": round(ts, 3),
            **({"args": args} if args else {}),
        })

    def async_begin(self, name: str, aid, cat: str = "async", **args):
        """Start a span that may end on another thread (e.g. a serve
        request's lifecycle). Pair with ``async_end`` via (cat, id)."""
        self._emit_async("b", name, cat, aid, args)

    def async_end(self, name: str, aid, cat: str = "async", **args):
        self._emit_async("e", name, cat, aid, args)

    # -- output ------------------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace JSON (object form, ``traceEvents``
        key); returns the path, or None when there is nowhere to save.
        Callable repeatedly — each save serializes the current buffer."""
        path = path or self._path
        if path is None:
            return None
        with self._lock:
            events = list(self._events)
            dropped = self.dropped
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs", "dropped_events": dropped},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return path
