"""Unified observability: process-global metrics registry + span tracer
(the port's counterpart of ``repro/obs/__init__.py``, the same API).

Every subsystem publishes into the same two singletons:

  * ``metrics()`` — the always-on ``MetricsRegistry``. Counters, gauges
    and histograms are always safe and cheap to update; attaching a
    JSONL sink (``enable_metrics``) is what makes them *visible*, and
    gating expensive *derivations* (e.g. the trainer's per-iteration
    device reductions for K* / delta sparsity) on ``metrics_on()``
    keeps the disabled path bitwise-identical to an uninstrumented run.
  * ``tracer()`` — the ``SpanTracer``. Disabled by default (every span
    call is one attribute check); ``enable_tracing`` starts recording
    and fixes the output path, ``finalize`` writes the Chrome trace
    JSON.

CLIs call ``setup(trace=..., metrics=...)`` after argparse (the
``--trace`` / ``--metrics`` flags, or the ``REPRO_TRACE`` /
``REPRO_METRICS`` env vars via ``setup_from_env``) and ``finalize()``
on exit. ``flush_metrics()`` is the cheap call sites sprinkle at
natural boundaries (iteration end, run end): a no-op without a sink,
one rate-limited JSONL snapshot line with one.
"""

from __future__ import annotations

import os
from typing import Optional

from repro_torch.obs.metrics import (LATENCY_MS_EDGES, MetricsLogger,  # noqa: F401
                               MetricsRegistry)
from repro_torch.obs.trace import SpanTracer  # noqa: F401

_REGISTRY = MetricsRegistry()
_TRACER = SpanTracer()
_LOGGER: Optional[MetricsLogger] = None


def metrics() -> MetricsRegistry:
    """The process-global registry (always usable)."""
    return _REGISTRY


def tracer() -> SpanTracer:
    """The process-global span tracer (no-op until enabled)."""
    return _TRACER


def metrics_on() -> bool:
    """True when a JSONL sink is attached — the gate call sites use
    before computing anything *extra* just to publish it."""
    return _LOGGER is not None


def enable_metrics(path: str, *, every_s: Optional[float] = None,
                   min_interval_s: float = 0.0,
                   proc: Optional[str] = None) -> MetricsLogger:
    """Attach (or replace) the registry's JSONL sink. ``proc`` fixes
    the shard label stamped on every snapshot line (default: the
    ``REPRO_METRICS_PROC`` env var, else ``pid<pid>``)."""
    global _LOGGER
    if _LOGGER is not None:
        _LOGGER.close()
    _LOGGER = MetricsLogger(_REGISTRY, path, every_s=every_s,
                            min_interval_s=min_interval_s, proc=proc)
    return _LOGGER


def disable_metrics() -> Optional[dict]:
    """Close and detach the JSONL sink (no-op without one), returning
    its accounting ``stats()``. Metric *values* survive in the registry
    — only visibility changes, so an obs-off measurement pass can
    bracket a sink without touching anything else."""
    global _LOGGER
    if _LOGGER is None:
        return None
    stats = _LOGGER.stats()
    _LOGGER.close()
    _LOGGER = None
    return stats


def enable_tracing(path: Optional[str] = None) -> SpanTracer:
    """Start span recording; ``path`` fixes where ``finalize`` saves."""
    _TRACER.start(path)
    return _TRACER


def flush_metrics(force: bool = False):
    """One snapshot line if a sink is attached (rate-limited unless
    ``force``); no-op otherwise."""
    if _LOGGER is not None:
        _LOGGER.flush(force=force)


def setup(*, trace: Optional[str] = None, metrics_path: Optional[str] = None,
          metrics_every_s: Optional[float] = None):
    """CLI entry point: enable whatever was requested (None = leave
    disabled)."""
    if trace:
        enable_tracing(trace)
    if metrics_path:
        enable_metrics(metrics_path, every_s=metrics_every_s,
                       min_interval_s=0.0)


def setup_from_env():
    """Honor ``REPRO_TRACE`` / ``REPRO_METRICS`` (output paths) so any
    entry point — including tests and benches that never grew flags —
    can be observed without plumbing."""
    setup(trace=os.environ.get("REPRO_TRACE") or None,
          metrics_path=os.environ.get("REPRO_METRICS") or None)


def finalize() -> dict:
    """Flush + close the sinks: save the trace file (if tracing) and
    write a final metrics snapshot (if a sink is attached). Idempotent;
    CLIs call this in a ``finally``.

    Returns a summary of what each sink actually captured — including
    the tracer's bounded-buffer drop count and the logger's
    suppressed/dropped flush state — and publishes those as
    ``obs.trace_dropped_events`` / ``obs.metrics_suppressed_flushes``
    gauges *before* the final snapshot, so a truncated trace or a
    rate-limited sink is visible in the metrics file itself. Drops also
    warn on stderr here."""
    import sys

    global _LOGGER
    out: dict = {}
    if _TRACER.enabled:
        if _LOGGER is not None and _TRACER.dropped:
            _REGISTRY.gauge("obs.trace_dropped_events").set(_TRACER.dropped)
        path = _TRACER.save()
        out["trace"] = {"path": path, "events": len(_TRACER.events()),
                        "dropped_events": _TRACER.dropped}
        if _TRACER.dropped:
            print(f"WARNING: tracer dropped {_TRACER.dropped} events "
                  "(bounded buffer full) — the saved trace is truncated",
                  file=sys.stderr)
        _TRACER.stop()
    if _LOGGER is not None:
        if _LOGGER.suppressed:
            _REGISTRY.gauge("obs.metrics_suppressed_flushes").set(
                _LOGGER.suppressed)
        path = _LOGGER.path
        _LOGGER.close()  # final snapshot carries the gauges set above
        stats = _LOGGER.stats()
        _LOGGER = None
        out["metrics"] = {"path": path, **stats}
        if stats["dropped"]:
            print(f"WARNING: metrics logger dropped {stats['dropped']} "
                  "late flushes (sink already closed)", file=sys.stderr)
    return out


def reset_for_tests():
    """Fresh global state (tests only): drop all metrics, disable and
    clear the tracer, detach the sink."""
    global _LOGGER
    if _LOGGER is not None:
        _LOGGER.close()
        _LOGGER = None
    _REGISTRY.reset()
    _TRACER.stop()
    _TRACER.start()   # clears buffers...
    _TRACER.stop()    # ...and leaves it disabled
    _TRACER._path = None
