"""Convergence observatory: online model-quality diagnostics (the port's
counterpart of ``repro/obs/diagnostics.py``: ``ess`` and ``geweke`` are
its numpy, the reductions are torch operations on the state's device).

The paper's claim is statistical as much as computational — the doubly
sparse sampler must still *mix* — so next to the systems metrics
(tok/s, span overlap, SLOs) the trainer publishes per-iteration
model-quality estimators computed from state that is already
device-resident. Everything here follows the same contract as the K*
and delta-sparsity health gauges in ``core/streaming.py``:

**Gauge contract.** Diagnostics are derived *reads* of the chain state
(``n``, the iteration's ``dh`` histogram accumulator, ``psi``): they
consume no randomness, mutate nothing, and are dispatched only when a
metrics sink is attached (``obs.metrics_on()``), so a diagnostics-off
run is bitwise-identical to a diagnostics-on run
(``chip_smoke.py`` phase 10 holds a metrics-on chain bitwise to a silent
one). Each estimator costs a few device reductions per iteration.

Metric name schema (all under the ``train.`` prefix):

  * ``train.log_lik`` (gauge) — joint log p(w, z | psi) up to a
    corpus constant: the exact collapsed-Phi token term
    ``sum_k [lgamma(V*beta) - lgamma(V*beta + n_k.)
    + sum_v (lgamma(beta + n_kv) - lgamma(beta))]`` plus the
    Polya-urn document term
    ``sum_{k,p} dh[k,p] * (lgamma(alpha*psi_k + p)
    - lgamma(alpha*psi_k))`` (the per-document
    ``lgamma(alpha) - lgamma(alpha + N_d)`` normalizer is constant
    given the corpus and dropped). Should trend upward as the chain
    converges.
  * ``train.log_lik_per_token`` (gauge) — the same, divided by the
    corpus token count: the per-token log-predictive scale that is
    comparable across corpus sizes.
  * ``train.topic_births`` / ``train.topic_deaths`` (counters) —
    lifecycle events from the topic-column occupancy of ``n``: a topic
    is live when any ``n[k, v] > 0``; a birth is a dead->live
    transition between consecutive iterations, a death the reverse.
  * ``train.topic_mass_entropy`` (gauge) — entropy (nats) of the
    per-topic token-mass distribution ``n_k. / n..``: near 0 when one
    topic holds everything (the init state), growing as mass spreads.
  * ``train.topic_mass_max_frac`` (gauge) — largest single topic's
    share of the token mass.
  * ``train.top_word_drift`` (gauge) — ``1 - mean Jaccard overlap`` of
    each topic's top-``W`` word set against the previous iteration
    (topics live in both); 0 = topics are stable, 1 = complete churn.
  * ``train.ess_log_lik`` / ``train.ess_k_star`` (gauges) — effective
    sample size of the log-likelihood / K* scalar chains (initial
    positive sequence autocorrelation estimator, over the trailing
    ``window`` samples). Published once ``min_chain`` samples exist.
  * ``train.geweke_log_lik`` / ``train.geweke_k_star`` (gauges) —
    Geweke convergence z-score of the same chains (first 10% vs last
    50% means; naive segment variance, not spectral density — a cheap
    screen, |z| >> 2 flags a drifting chain, not a hypothesis test).
  * ``train.phase_ms{phase=...}`` (counters) — cumulative driver-side
    wall milliseconds per pipeline phase (``PhaseClock``); the
    dashboard renders their relative fractions.

``launch/dashboard.py`` renders these live.
"""

from __future__ import annotations

import time

import numpy as np
import torch


# -- scalar-chain MCMC diagnostics (host-side, pure numpy) -------------------

def ess(x) -> float:
    """Effective sample size of a scalar chain.

    Initial-positive-sequence estimator (Geyer 1992): sum paired
    autocorrelations ``G_m = rho(2m) + rho(2m+1)`` while positive, then
    ``ESS = n / max(2 * sum G_m - 1, 1)`` — capped at n, so a white
    chain reports ~n and a sticky chain reports far less. Returns 0.0
    for chains too short to estimate (< 4 samples) or with zero
    variance (a constant chain carries no information).
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    n = x.size
    if n < 4:
        return 0.0
    xc = x - x.mean()
    var = float(np.dot(xc, xc)) / n
    if var <= 0.0:
        return 0.0
    max_lag = n - 2
    rho = np.empty(max_lag + 1)
    for t in range(max_lag + 1):
        rho[t] = float(np.dot(xc[: n - t], xc[t:])) / (n * var)
    tau_half = 0.0
    for m in range((max_lag + 1) // 2):
        g = rho[2 * m] + rho[2 * m + 1]
        if g <= 0.0:
            break
        tau_half += g
    tau = max(2.0 * tau_half - 1.0, 1.0)
    return float(min(n / tau, n))


def geweke(x, first: float = 0.1, last: float = 0.5) -> float:
    """Geweke convergence z-score of a scalar chain: difference of the
    first-``first`` and last-``last`` segment means over the root sum
    of their (naive, iid) variances. A stationary chain gives |z| ~ 1;
    a still-trending chain gives |z| >> 2. Returns 0.0 when the chain
    is too short for both segments or degenerate (zero variance)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    n = x.size
    na, nb = max(int(first * n), 2), max(int(last * n), 2)
    if na + nb > n:
        return 0.0
    a, b = x[:na], x[n - nb:]
    denom = np.sqrt(a.var(ddof=1) / na + b.var(ddof=1) / nb)
    if denom == 0.0 or not np.isfinite(denom):
        return 0.0
    return float((a.mean() - b.mean()) / denom)


# -- per-iteration reductions on the device -----------------------------------

def make_joint_loglik_fn(cfg):
    """``(n, dh, psi) -> scalar``: joint log p(w, z | psi) up to a corpus
    constant (see the module docstring for the exact expression), in
    float32 with ``torch.lgamma`` where the reference takes ``gammaln``.
    Zero rows/columns contribute exactly 0, so padded vocabulary and dead
    topics never perturb the value."""
    v_beta = float(cfg.V) * float(cfg.beta)
    beta = float(cfg.beta)
    alpha = float(cfg.alpha)

    def fn(n, dh, psi):
        f32 = dict(dtype=torch.float32, device=n.device)
        nf = n.to(torch.float32)
        nk = torch.sum(nf, dim=1)
        token = (
            torch.sum(torch.lgamma(beta + nf) - torch.lgamma(torch.tensor(beta, **f32)))
            + torch.sum(torch.lgamma(torch.tensor(v_beta, **f32))
                        - torch.lgamma(v_beta + nk))
        )
        p = torch.arange(dh.shape[1], **f32)[None, :]
        a = torch.clamp(alpha * psi.to(torch.float32), min=1e-30)[:, None]
        doc = torch.sum(torch.where(
            dh > 0,
            dh.to(torch.float32) * (torch.lgamma(a + p) - torch.lgamma(a)),
            torch.zeros((), **f32),
        ))
        return token + doc

    return fn


def make_topic_fn(top_words: int):
    """``n -> (live, entropy, max_frac, top_ids)``: the topic lifecycle
    reduction — per-topic occupancy mask, token-mass entropy and max
    share, and each topic's top-``top_words`` word ids, ties broken by
    index as ``lax.top_k`` breaks them (a stable descending sort, not
    ``torch.topk``), so the drift gauge is deterministic."""

    def fn(n):
        sizes = torch.sum(n, dim=1).to(torch.float32)
        live = sizes > 0
        mass = sizes / torch.clamp(torch.sum(sizes), min=1.0)
        entropy = -torch.sum(torch.where(mass > 0, mass * torch.log(mass),
                                         torch.zeros_like(mass)))
        top = torch.sort(n, dim=1, descending=True, stable=True)[1][:, :top_words]
        return live, entropy, torch.max(mass), top.to(torch.int32)

    return fn


# -- driver-side phase wall-clock (feeds the dashboard's fractions) ----------

class _ClockSpan:
    __slots__ = ("_acc", "_name", "_t0")

    def __init__(self, acc, name):
        self._acc = acc
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._acc[self._name] = (self._acc.get(self._name, 0.0)
                                 + time.perf_counter() - self._t0)
        return False


class _NullClockSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CLOCK_SPAN = _NullClockSpan()


class PhaseClock:
    """Accumulates driver-side wall seconds per pipeline phase into
    ``acc`` — published as ``train.phase_ms{phase=...}`` counters at
    iteration end. Unlike the tracer's spans this is a plain running
    sum, cheap enough to keep per-iteration; unlike ``PhaseTimers`` it
    measures the *overlapped* driver (dispatch + waits), which is what
    the dashboard's phase-fraction bar should show."""

    __slots__ = ("acc",)

    def __init__(self):
        self.acc: dict[str, float] = {}

    def time(self, name: str):
        return _ClockSpan(self.acc, name)


class _NullClock:
    """Shared no-op twin for the metrics-off path (same shape as
    ``PhaseClock`` so call sites never branch)."""

    __slots__ = ()

    @property
    def acc(self):
        return {}

    def time(self, name: str):
        return _NULL_CLOCK_SPAN


NULL_CLOCK = _NullClock()


# -- the per-chain observatory ------------------------------------------------

class ConvergenceDiagnostics:
    """Per-chain online estimator state: owns the device reductions and
    the host-side scalar chains / lifecycle memory, and publishes the
    ``train.*`` diagnostics gauges (schema in the module docstring)
    into a registry once per ``update``.

    Constructed lazily by ``StreamingHDP`` on the first metrics-on
    iteration, so a metrics-off run never runs any of this. The
    scalar chains are trimmed to the trailing ``window`` samples: the
    autocorrelation estimator is O(window^2), and a bounded window
    keeps a week-long run's per-iteration cost flat.
    """

    def __init__(self, cfg, num_tokens: int, *, top_words: int = 10,
                 min_chain: int = 8, window: int = 512):
        self.num_tokens = max(int(num_tokens), 1)
        self.min_chain = min_chain
        self.window = window
        self.top_words = max(1, min(top_words, cfg.V))
        self._ll_fn = make_joint_loglik_fn(cfg)
        self._topic_fn = make_topic_fn(self.top_words)
        self._prev_live = None
        self._prev_top = None
        self._ll_chain: list[float] = []
        self._kstar_chain: list[float] = []

    def update(self, registry, n, dh, psi) -> float:
        """One iteration's diagnostics: run the two reductions, pull the
        scalars, publish. Pure read of (n, dh, psi) — never consumes
        randomness or mutates state. Returns the joint log-likelihood."""
        ll = float(self._ll_fn(n, dh, psi))
        live_d, entropy_d, max_frac_d, top_d = self._topic_fn(n)
        live = live_d.cpu().numpy()
        top = top_d.cpu().numpy()
        g = registry.gauge
        g("train.log_lik").set(round(ll, 3))
        g("train.log_lik_per_token").set(round(ll / self.num_tokens, 6))
        g("train.topic_mass_entropy").set(round(float(entropy_d), 4))
        g("train.topic_mass_max_frac").set(round(float(max_frac_d), 6))
        # lifecycle: births/deaths vs the previous iteration's live set,
        # top-word drift over topics live in both.
        if self._prev_live is None:
            # materialize the counters at 0 so the very first snapshot
            # already carries them (merge/dashboard never special-case).
            registry.counter("train.topic_births")
            registry.counter("train.topic_deaths")
        else:
            births = int(np.sum(live & ~self._prev_live))
            deaths = int(np.sum(~live & self._prev_live))
            if births:
                registry.counter("train.topic_births").inc(births)
            if deaths:
                registry.counter("train.topic_deaths").inc(deaths)
            both = np.nonzero(live & self._prev_live)[0]
            if both.size:
                drift = 0.0
                for k in both:
                    cur = set(int(w) for w in top[k])
                    prev = set(int(w) for w in self._prev_top[k])
                    drift += 1.0 - len(cur & prev) / len(cur | prev)
                g("train.top_word_drift").set(round(drift / both.size, 4))
        self._prev_live, self._prev_top = live, top
        # scalar chains -> MCMC diagnostics
        self._ll_chain.append(ll)
        self._kstar_chain.append(float(np.sum(live)))
        if len(self._ll_chain) > self.window:
            del self._ll_chain[:-self.window]
            del self._kstar_chain[:-self.window]
        if len(self._ll_chain) >= self.min_chain:
            g("train.ess_log_lik").set(round(ess(self._ll_chain), 2))
            g("train.geweke_log_lik").set(round(geweke(self._ll_chain), 3))
            g("train.ess_k_star").set(round(ess(self._kstar_chain), 2))
            g("train.geweke_k_star").set(round(geweke(self._kstar_chain), 3))
        return ll
