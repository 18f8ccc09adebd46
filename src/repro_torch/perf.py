"""Per-phase wall-time attribution for the streamed iteration
(counterpart of ``repro/perf.py``).

``PhaseTimers.phase(name)`` records one (name, start, duration) span per
entry; ``totals``, ``counts`` and ``fractions`` reduce over the spans.
With a CUDA ``device`` every phase boundary synchronizes the card, so a
span holds the device work its phase queued and the spans of a
serialized iteration (``StreamingHDP.iteration_profiled``) add up to its
wall time. Phases are strictly sequential: a nested phase would count
its time twice, so ``phase`` raises on re-entry. Times are
``time.perf_counter`` (monotonic). Each span also goes to the global
span tracer (``repro_torch.obs``) when tracing is on, so a ``--trace``
run shows the phases on the timeline that the totals sum.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.device import synchronize


class PhaseTimers:
    """Exclusive wall time per named phase, reduced over its spans."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.spans: list[tuple[str, float, float]] = []
        self._active: Optional[str] = None

    @contextmanager
    def phase(self, name: str):
        if self._active is not None:
            raise RuntimeError(
                f"phase {name!r} entered while phase {self._active!r} is "
                "still open: nested phases would double-count — keep "
                "phases strictly sequential"
            )
        self._active = name
        synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.spans.append((name, t0, dt))
            self._active = None
            tr = obs.tracer()
            if tr.enabled:
                tr._emit_complete(name, "phase", t0, dt, None)

    @property
    def totals(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, _, dt in self.spans:
            out[name] = out.get(name, 0.0) + dt
        return out

    @property
    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for name, _, _ in self.spans:
            out[name] = out.get(name, 0) + 1
        return out

    @property
    def total(self) -> float:
        return sum(dt for _, _, dt in self.spans)

    def fractions(self, ndigits: int = 3) -> dict[str, float]:
        totals = self.totals
        tot = sum(totals.values())
        if tot <= 0:
            return {k: 0.0 for k in totals}
        return {k: round(v / tot, ndigits) for k, v in totals.items()}
