"""The port's observability layer (``repro_torch/obs``, ``perf.py`` and the
serving hooks) against the reference's (tests/test_obs.py's cases), and
the same snapshot records from the same updates in both packages.

With observability off every hook is a no-op that cannot reach a
result; on, the artifacts are well formed and consistent: histogram
counts match completions, SLO ok + miss == completed, async spans pair,
threads have named tracks.
"""

import json
import os
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs.metrics import MetricsLogger as JLogger  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs.trace import SpanTracer as JTracer  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: E402
                                     MetricsLogger, MetricsRegistry,
                                     hist_percentile)
from repro_torch.obs.trace import _NULL_SPAN, SpanTracer  # noqa: E402
from repro_torch.perf import PhaseTimers  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


# -- metrics primitives ---------------------------------------------------------

def test_counter_and_gauge():
    c = Counter()
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge()
    g.set(3)
    g.set_max(2)
    assert g.value == 3
    g.set_max(7)
    assert g.value == 7


def test_histogram_buckets_and_percentiles():
    h = Histogram(edges=(1.0, 10.0, 100.0))
    for v in (0.5, 0.7, 5.0, 50.0, 500.0):
        h.observe(v)
    assert h.count == 5 and h.bucket_counts == [2, 1, 1, 1]
    assert h.percentile(50) == pytest.approx(5.5)
    assert h.percentile(99) == pytest.approx(100.0)  # clamped to the last edge
    assert Histogram(edges=(1.0,)).percentile(50) is None
    assert hist_percentile([], [], 50) is None
    assert hist_percentile([1.0], [0, 0], 50) is None
    assert hist_percentile([4.0], [2, 0], 50) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        Histogram(edges=(1.0, 1.0, 2.0))
    with pytest.raises(ValueError):
        Histogram(edges=())


def test_registry_identity_conflicts_and_schema():
    r = MetricsRegistry()
    assert r.counter("a") is r.counter("a")
    assert r.counter("a", k="1") is not r.counter("a", k="2")
    with pytest.raises(ValueError):
        r.gauge("a")
    r.histogram("h", edges=(1.0, 2.0))
    with pytest.raises(ValueError):
        r.histogram("h", edges=(1.0, 3.0))
    assert r.get("a") is r.counter("a") and r.get("nope") is None
    r = MetricsRegistry()
    r.counter("c", x="1").inc(2)
    r.gauge("g").set(1.5)
    r.histogram("h", edges=(1.0, 2.0)).observe(1.5)
    snap = {m["name"]: m for m in r.snapshot()}
    assert list(snap) == ["c", "g", "h"]
    assert snap["c"] == {"name": "c", "type": "counter", "labels": {"x": "1"}, "value": 2}
    assert snap["g"]["value"] == 1.5
    assert snap["h"]["count"] == 1
    assert len(snap["h"]["bucket_counts"]) == len(snap["h"]["le"]) + 1


def test_metrics_logger_lines_proc_and_rate_limit(tmp_path, monkeypatch):
    r = MetricsRegistry()
    r.counter("c").inc()
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(r, path, proc="w0")
    log.flush()
    r.counter("c").inc()
    log.close()
    lines = [json.loads(s) for s in open(path).read().splitlines()]
    assert [set(x) for x in lines] == [{"ts", "proc", "seq", "metrics"}] * 2
    assert [x["seq"] for x in lines] == [0, 1] and lines[1]["proc"] == "w0"
    assert [x["metrics"][0]["value"] for x in lines] == [1, 2]
    monkeypatch.delenv("REPRO_METRICS_PROC", raising=False)
    log = MetricsLogger(r, str(tmp_path / "a.jsonl"))
    assert log.proc == f"pid{os.getpid()}"
    log.close()
    path = str(tmp_path / "r.jsonl")
    log = MetricsLogger(r, path, min_interval_s=3600)
    log.flush(force=False)
    log.flush(force=False)  # rate-limited away
    log.flush(force=True)
    log.close()
    assert [json.loads(s)["seq"] for s in open(path).read().splitlines()] == [0, 1, 2]
    assert (log.stats()["flushes"], log.stats()["suppressed"]) == (3, 1)
    log.flush()  # after close: counted as dropped
    assert log.stats()["dropped"] == 1


def test_same_updates_give_the_references_snapshot_records(tmp_path):
    """One update sequence on both packages' registries and loggers: the
    same records (names, types, labels, values, edges, bucket counts) and
    the same JSONL lines but for the timestamp."""
    regs = (MetricsRegistry(), JRegistry())
    paths = [str(tmp_path / "ours.jsonl"), str(tmp_path / "ref.jsonl")]
    loggers = [MetricsLogger(regs[0], paths[0], proc="p"),
               JLogger(regs[1], paths[1], proc="p")]
    rng = np.random.default_rng(0)
    lat = rng.exponential(40.0, size=200)
    for step in range(3):
        for r, log in zip(regs, loggers):
            r.counter("train.iterations").inc()
            r.counter("train.phase_ms", phase="sweep", proc="d1").inc(1.25 * step)
            r.gauge("train.k_star").set(10 + step)
            r.gauge("serve.queue_depth", bucket=32).set_max(step)
            for v in lat[step::3]:
                r.histogram("serve.latency_ms", bucket=64).observe(float(v))
            r.histogram("h", edges=(0.5, 4.0)).observe(step)
            log.flush(force=True)
    for log in loggers:
        log.close()
    assert regs[0].snapshot() == regs[1].snapshot()
    ours, ref = ([json.loads(s) for s in open(p).read().splitlines()] for p in paths)
    for a, b in zip(ours, ref, strict=True):
        a.pop("ts"), b.pop("ts")
        assert a == b


# -- the span tracer -------------------------------------------------------------

def test_disabled_tracer_is_a_noop_singleton():
    tr = SpanTracer()
    assert tr.span("x") is _NULL_SPAN and tr.span("y", cat="c", block=1) is _NULL_SPAN
    tr.instant("i")
    tr.async_begin("a", 1)
    tr.async_end("a", 1)
    assert tr.events() == []


def test_tracer_events_match_the_references(tmp_path):
    ours, ref = SpanTracer(), JTracer()
    for tr in (ours, ref):
        tr.start()
        with tr.span("work", cat="test", block=3):
            pass
        tr.async_begin("req", 7, cat="serve", bucket=32)
        tr.async_end("req", 7, cat="serve")
        tr.instant("mark", cat="test")
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}  # noqa: E731
                         for e in evs]
    assert strip(ours.events()) == strip(ref.events())
    kinds = [e["ph"] for e in ours.events()]
    assert kinds[:2] == ["M", "X"] and ours.events()[1]["args"] == {"block": 3}
    b, e = [ev for ev in ours.events() if ev["ph"] in "be"]
    assert b["id"] == e["id"] == "7" and b["cat"] == e["cat"] == "serve"
    path = str(tmp_path / "t.json")
    ours.save(path)
    doc = json.load(open(path))
    assert doc["traceEvents"] == ours.events() and doc["displayTimeUnit"] == "ms"


def test_tracer_thread_tracks_and_drop_cap():
    tr = SpanTracer()
    tr.start()

    def work():
        with tr.span("child"):
            pass

    t = threading.Thread(target=work, name="worker-thread")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with tr.span("main"):
        pass
    meta = {e["tid"]: e["args"]["name"] for e in tr.events() if e["ph"] == "M"}
    by_span = {e["name"]: meta[e["tid"]] for e in tr.events() if e["ph"] == "X"}
    assert by_span == {"child": "worker-thread", "main": threading.current_thread().name}
    tr = SpanTracer(max_events=3)
    tr.start()
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.events()) == 3 and tr.dropped == 10 - 2


# -- PhaseTimers as a span reducer -----------------------------------------------------

def test_phase_timers_reduce_reject_nesting_and_forward_to_the_tracer():
    t = PhaseTimers()
    for name in ("a", "b", "a"):
        with t.phase(name):
            pass
    assert t.counts == {"a": 2, "b": 1}
    assert t.total == pytest.approx(sum(t.totals.values()))
    with pytest.raises(RuntimeError, match="nested"):
        with t.phase("outer"):
            with t.phase("inner"):
                pass
    with t.phase("after"):
        pass
    assert t.counts["after"] == 1
    tr = obs.enable_tracing()
    t = PhaseTimers()
    with t.phase("sweep"):
        pass
    assert [e["name"] for e in tr.events() if e["ph"] == "X"] == ["sweep"]


# -- setup, finalize, the silent default ----------------------------------------------

def test_setup_and_finalize(tmp_path):
    trace_path, metrics_path = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    obs.setup(trace=trace_path, metrics_path=metrics_path)
    assert obs.metrics_on()
    obs.metrics().counter("x").inc()
    with obs.tracer().span("s"):
        pass
    obs.flush_metrics(force=True)
    out = obs.finalize()
    assert not obs.metrics_on() and not obs.tracer().enabled
    assert out["trace"]["path"] == trace_path and out["trace"]["events"] >= 1
    assert out["metrics"]["flushes"] == 2 and out["metrics"]["dropped"] == 0
    assert obs.finalize() == {}  # idempotent
    assert any(e["ph"] == "X" for e in json.load(open(trace_path))["traceEvents"])
    lines = open(metrics_path).read().splitlines()
    assert json.loads(lines[-1])["metrics"][0]["value"] == 1


def test_finalize_surfaces_trace_drops(tmp_path):
    trace_path, metrics_path = str(tmp_path / "t.json"), str(tmp_path / "m.jsonl")
    obs.setup(trace=trace_path, metrics_path=metrics_path)
    obs.tracer().max_events = 2
    try:
        for i in range(6):
            with obs.tracer().span(f"s{i}"):
                pass
        out = obs.finalize()
    finally:
        obs.tracer().max_events = 2_000_000
    dropped = out["trace"]["dropped_events"]
    assert dropped > 0
    assert json.load(open(trace_path))["otherData"]["dropped_events"] == dropped
    last = json.loads(open(metrics_path).read().splitlines()[-1])
    assert {m["name"]: m["value"] for m in last["metrics"]}[
        "obs.trace_dropped_events"] == dropped


def test_disabled_by_default_and_setup_from_env(tmp_path, monkeypatch):
    assert not obs.metrics_on()
    assert obs.tracer().span("anything") is _NULL_SPAN
    obs.flush_metrics()  # no sink: a silent no-op
    obs.metrics().counter("c").inc()  # always legal
    trace_path = str(tmp_path / "t.json")
    monkeypatch.setenv("REPRO_TRACE", trace_path)
    monkeypatch.delenv("REPRO_METRICS", raising=False)
    obs.setup_from_env()
    assert obs.tracer().enabled and not obs.metrics_on()
    obs.finalize()
    assert os.path.exists(trace_path)


# -- the serving hooks --------------------------------------------------------------

@pytest.fixture(scope="module")
def trained_registry():
    """A registry with two published samples of the port's sampler, and
    held-out queries."""
    from repro_torch.core import hdp as H
    from repro_torch.data.synthetic import planted_topics_corpus
    from repro_torch.serve import snapshot as SNAP
    from repro_torch.serve.registry import SnapshotRegistry

    k, v = 12, 48
    corpus, _ = planted_topics_corpus(np.random.default_rng(0), D=40, V=v, K_true=3,
                                      doc_len=(10, 20))
    cfg = H.HDPConfig(K=k, V=v, bucket=k, hist_cap=32)
    tokens, mask = torch.from_numpy(corpus.tokens[:32]), torch.from_numpy(corpus.mask[:32])
    state = H.init_state(H.make_generator(0, "cpu"), tokens, mask, cfg)
    for _ in range(6):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    snap1 = SNAP.snapshot_from_state(state, cfg)
    for _ in range(3):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    reg = SnapshotRegistry(tempfile.mkdtemp())
    reg.publish(snap1)
    reg.publish(SNAP.snapshot_from_state(state, cfg))
    docs = [corpus.tokens[i][corpus.mask[i]] for i in range(32, 40)]
    return reg, docs


def _fleet(reg, **kw):
    from repro_torch.serve.fleet import ServeFleet

    return ServeFleet(reg, slots=3, burnin=4, buckets=(16, 32), base_seed=1,
                      device="cpu", **kw)


@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_metrics_under_ensemble(trained_registry, workers):
    reg, docs = trained_registry
    with _fleet(reg, workers=workers, ensemble=2, slo_ms=60_000.0) as fleet:
        for doc in docs:
            fleet.submit(doc)
        out = fleet.run(timeout=120)
    s = fleet.stats_summary()
    assert len(out) == len(docs) == s["completed"] == s["latency_window"]
    assert s["slo_ok"] + s["slo_miss"] == len(docs) == s["slo_ok"]
    assert sum(w["completed"] for w in s["per_worker"]) == 2 * len(docs)
    M = obs.metrics()
    by_bucket = lambda name: [M.get(name, bucket=b) for b in (16, 32)]  # noqa: E731
    assert sum(h.count for h in by_bucket("serve.latency_ms") if h) == len(docs)
    assert sum(c.value for c in by_bucket("serve.slo_ok") if c) == s["slo_ok"]
    # one queue-wait and one service observation an admitted subtask
    for name in ("serve.queue_wait_ms", "serve.service_ms"):
        assert sum(m.count for key, m in M._metrics.items() if key[0] == name) == 2 * len(docs)
    depth = [g for g in by_bucket("serve.queue_depth") if g is not None]
    assert depth and all(g.value == 0 for g in depth)  # drained back to empty


def test_mixtures_with_trace_and_metrics_on_are_the_silent_ones(trained_registry, tmp_path):
    reg, docs = trained_registry

    def serve():
        with _fleet(reg, workers=2) as fleet:
            rids = [fleet.submit(doc, seed=100 + i) for i, doc in enumerate(docs)]
            out = fleet.run(timeout=120)
        return [out[r] for r in rids]

    silent = serve()
    obs.setup(trace=str(tmp_path / "t.json"), metrics_path=str(tmp_path / "m.jsonl"))
    try:
        observed = serve()
    finally:
        obs.finalize()
    for a, b in zip(silent, observed, strict=True):
        np.testing.assert_array_equal(a, b)


def test_engine_latency_window_accounting():
    from repro_torch.serve.engine import EngineStats

    st = EngineStats()
    st._LAT_CAP = 8
    for i in range(10):
        st.record_latency(float(i))
    assert len(st.latencies_s) + st.latencies_dropped == 10
    assert st.latencies_dropped == 4
    s = st.summary()
    assert s["latency_window"] == len(st.latencies_s) and s["latencies_dropped"] == 4


def test_router_slo_accounting_survives_latency_eviction():
    from repro_torch.serve.router import AdmissionRouter

    n_req = 10
    r = AdmissionRouter(buckets=(16,), max_pending=64, slo_ms=60_000.0)
    r._LAT_CAP = 8
    for rid in range(n_req):
        r.submit(rid, np.arange(4), versions=(1, 2))
    while True:
        tasks = r.pull(64, timeout=0.0)
        if not tasks:
            break
        for t in tasks:
            r.post(t, np.full(3, 0.5, np.float32))
    assert len(r.drain(timeout=5.0)) == n_req
    s = r.latency_summary()
    assert s["latency_window"] + s["latencies_dropped"] == n_req
    assert s["latencies_dropped"] == 4
    assert s["slo_ok"] + s["slo_miss"] == n_req == s["slo_ok"] == r.completed_total()
    M = obs.metrics()
    assert M.get("serve.slo_ok", bucket=16).value == n_req
    assert M.get("serve.slo_miss", bucket=16) is None
    assert M.get("serve.latency_ms", bucket=16).count == n_req
    r.close()
    with pytest.raises(ValueError):
        AdmissionRouter(buckets=(16,), slo_ms=0)


def test_serve_request_trace_spans(trained_registry):
    reg, docs = trained_registry
    tr = obs.enable_tracing()
    with _fleet(reg, workers=1) as fleet:
        for doc in docs:
            fleet.submit(doc)
        fleet.run(timeout=120)
    evs = tr.events()
    begins = [e for e in evs if e["ph"] == "b"]
    ends = [e for e in evs if e["ph"] == "e"]
    key = lambda e: (e["name"], e["cat"], e["id"])  # noqa: E731
    assert sorted(map(key, begins)) == sorted(map(key, ends))
    router_reqs = [e for e in begins if e["name"] == "request" and e["cat"] == "router"]
    assert len(router_reqs) == len(docs) and all("bucket" in e["args"] for e in router_reqs)
    inflight = [e for e in begins if e["name"] == "request.inflight"]
    assert len(inflight) == len(docs)
    assert all(e["args"]["tag"].startswith("w0.v") for e in inflight)
    assert [e for e in evs if e["ph"] == "X" and e["name"] == "engine_step"]
