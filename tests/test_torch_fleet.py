"""The port's serving fleet (counterpart of tests/test_fleet.py), on the
CPU: registry publish and retention, fleet against the single engine
bitwise at any worker count, hot swap, ensembles, backpressure, and the
streamed trainer's publish hook.

A request's mixture depends only on (snapshot, base_seed, seed, tokens),
never on the worker count, the dispatch order, the admission time or a
concurrent publish: every test here is an instance of that. Every fleet
wait is bounded by ``run(timeout=...)`` and every fleet is closed on the
way out (the context manager).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import hdp as H  # noqa: E402
from repro_torch.core.streaming import StreamingHDP  # noqa: E402
from repro_torch.data.stream import ShardedCorpusStore  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402
from repro_torch.serve import snapshot as SNAP  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.fleet import ServeFleet  # noqa: E402
from repro_torch.serve.registry import SnapshotRegistry  # noqa: E402

K, V = 12, 48
BURNIN = 4
BUCKETS = (16, 32)
BASE_SEED = 11
TIMEOUT = 120
CPU = "cpu"


@pytest.fixture(scope="module")
def trained():
    """Two posterior samples of one chain of the port's sampler (for hot
    swap and ensembles) and held-out queries."""
    rng = np.random.default_rng(0)
    corpus, _ = planted_topics_corpus(rng, D=48, V=V, K_true=3, doc_len=(10, 20))
    cfg = H.HDPConfig(K=K, V=V, bucket=K, z_impl="cuda", hist_cap=32)
    tokens = torch.from_numpy(corpus.tokens[:40])
    mask = torch.from_numpy(corpus.mask[:40])
    state = H.init_state(H.make_generator(0, CPU), tokens, mask, cfg)
    for _ in range(10):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    snap1 = SNAP.snapshot_from_state(state, cfg)
    for _ in range(5):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    snap2 = SNAP.snapshot_from_state(state, cfg)
    docs = [corpus.tokens[i][corpus.mask[i]] for i in range(40, 48)]
    return snap1, snap2, docs


def _single_engine(snap, docs, seeds):
    """The single-engine reference that the fleet must match bitwise."""
    eng = ServeEngine(snap, slots=3, burnin=BURNIN, buckets=BUCKETS,
                      base_seed=BASE_SEED)
    for doc, s in zip(docs, seeds):
        eng.submit(doc, seed=s)
    return eng.run()


def _fleet(source, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("burnin", BURNIN)
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("base_seed", BASE_SEED)
    kw.setdefault("device", CPU)
    return ServeFleet(source, **kw)


def _equal(a, b, key):
    np.testing.assert_array_equal(a, b, err_msg=str(key))


# -- registry -----------------------------------------------------------------

def test_registry_publish_load_roundtrip(trained, tmp_path):
    snap1, snap2, _ = trained
    reg = SnapshotRegistry(str(tmp_path))
    assert reg.latest_version() is None and reg.versions() == []
    with pytest.raises(FileNotFoundError):
        reg.load(device=CPU)
    assert (reg.publish(snap1), reg.publish(snap2)) == (1, 2)
    assert reg.versions() == [1, 2] and reg.latest_version() == 2
    assert torch.equal(reg.load(1, device=CPU).phi, snap1.phi)
    assert torch.equal(reg.load(device=CPU).phi, snap2.phi)
    meta = reg.manifest()["versions"]["2"]
    assert meta["K"] == K and meta["V"] == V and meta["it"] == int(snap2.it)
    assert meta["nbytes"] == snap2.nbytes() and meta["compact"] is False


def test_registry_ignores_uncommitted_dirs(trained, tmp_path):
    """Readers trust only the manifest: a crash mid-publish leaves orphan
    directories that stay invisible and whose numbers are never reused."""
    snap1, _, _ = trained
    d = str(tmp_path)
    reg = SnapshotRegistry(d)
    reg.publish(snap1)
    os.makedirs(os.path.join(d, ".tmp-v7"))   # crashed mid-save
    os.makedirs(os.path.join(d, "v9"))        # crashed before the commit
    assert reg.versions() == [1]
    with pytest.raises(FileNotFoundError):
        reg.load(9, device=CPU)
    assert reg.publish(snap1) == 10  # past every orphan
    assert reg.versions() == [1, 10]


def test_registry_retention(trained, tmp_path):
    snap1, _, _ = trained
    reg = SnapshotRegistry(str(tmp_path))
    for _ in range(4):
        reg.publish(snap1, keep=2)
    assert reg.versions() == [3, 4]
    assert not os.path.exists(os.path.join(str(tmp_path), "v1"))
    reg.load(4, device=CPU)
    with pytest.raises(FileNotFoundError):
        reg.load(1, device=CPU)


def test_registry_latest_versions_for_ensemble(trained, tmp_path):
    snap1, _, _ = trained
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    reg.publish(snap1)
    assert reg.latest_versions(2) == [1, 2]
    with pytest.raises(ValueError, match="ensemble needs 3"):
        reg.latest_versions(3)


# -- the fleet against the single engine --------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_matches_single_engine_bitwise(trained, workers):
    snap1, _, docs = trained
    ref = _single_engine(snap1, docs, range(len(docs)))
    with _fleet(snap1, workers=workers) as fl:
        for i, doc in enumerate(docs):
            fl.submit(doc, seed=i)
        out = fl.run(timeout=TIMEOUT)
        s = fl.stats_summary()
    assert sorted(out) == sorted(ref)
    for rid in ref:
        _equal(out[rid], ref[rid], rid)
    assert s["workers"] == workers and s["completed"] == len(docs)
    assert all(w["device"] == CPU for w in s["per_worker"])


def test_fleet_submission_order_irrelevant(trained):
    snap1, _, docs = trained
    ref = _single_engine(snap1, docs, range(len(docs)))
    with _fleet(snap1, workers=2) as fl:
        for i in reversed(range(len(docs))):
            fl.submit(docs[i], seed=i)
        out = fl.run(timeout=TIMEOUT)
    for rid in ref:
        _equal(out[rid], ref[rid], rid)


def test_fleet_defaults_and_refusals(trained):
    snap1, _, _ = trained
    with _fleet(snap1) as fl:  # the CPU: one worker by default
        assert len(fl.workers) == 1
    with pytest.raises(ValueError, match="workers"):
        _fleet(snap1, workers=0)
    with pytest.raises(ValueError, match="watch_registry needs"):
        _fleet(snap1, watch_registry=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeFleet(snap1, workers=1)


def test_fleet_stress_more_workers_than_cores(trained):
    """Ten workers (more than this host's cores) with a short thread
    switch interval: no request is lost or duplicated, every count adds
    up, and every mixture is still the single engine's."""
    snap1, _, docs = trained
    n = 4 * len(docs)
    all_docs = [docs[i % len(docs)] for i in range(n)]
    ref = _single_engine(snap1, all_docs, range(n))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _fleet(snap1, workers=10, slots=2, max_pending=16) as fl:
            for i, doc in enumerate(all_docs):
                fl.submit(doc, seed=i, timeout=TIMEOUT)
            out = fl.run(timeout=TIMEOUT)
            s = fl.stats_summary()
    finally:
        sys.setswitchinterval(old)
    assert sorted(out) == list(range(n))
    for i in range(n):
        _equal(out[i], ref[i], i)
    assert s["completed"] == n
    assert sum(w["completed"] for w in s["per_worker"]) == n
    assert not any(w.is_alive() for w in fl.workers)


# -- hot swap -----------------------------------------------------------------

def test_fleet_hot_swap_redirects_new_admissions(trained, tmp_path):
    """Before a publish every request serves on v1; after a refresh every
    new request serves on v2, and the v1 mixtures stay as they were."""
    snap1, snap2, docs = trained
    n = len(docs)
    ref1 = _single_engine(snap1, docs, range(n))
    ref2 = _single_engine(snap2, docs, range(100, 100 + n))
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    with _fleet(reg, workers=2, watch_registry=True) as fl:
        for i, doc in enumerate(docs):
            fl.submit(doc, seed=i)
        a = fl.run(timeout=TIMEOUT)
        a_before = {i: a[i].copy() for i in a}
        reg.publish(snap2)
        fl.refresh_registry()
        for i, doc in enumerate(docs):
            fl.submit(doc, seed=100 + i)
        b = fl.run(timeout=TIMEOUT)
        s = fl.stats_summary()
    for i in range(n):
        _equal(a[i], ref1[i], i)
        _equal(a[i], a_before[i], i)
        _equal(b[100 + i], ref2[100 + i], i)
    assert s["completed"] == 2 * n
    assert s["snapshot_swaps"] >= 1  # a worker really swapped engines


def test_fleet_concurrent_publish_never_corrupts_mixtures(trained, tmp_path):
    """A publish that lands while requests are queued or in flight: every
    mixture is bitwise the single engine's on one of the two snapshots
    (in-flight slots finish on theirs, queued ones bind to either)."""
    snap1, snap2, docs = trained
    all_docs = [docs[i % len(docs)] for i in range(6 * len(docs))]
    seeds = list(range(len(all_docs)))
    ref1 = _single_engine(snap1, all_docs, seeds)
    ref2 = _single_engine(snap2, all_docs, seeds)
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    with _fleet(reg, workers=2, watch_registry=True, poll_registry_s=0.0) as fl:
        for i, doc in enumerate(all_docs):
            fl.submit(doc, seed=i)
            if i == len(all_docs) // 2:
                reg.publish(snap2)  # no synchronous refresh: racy on purpose
        out = fl.run(timeout=TIMEOUT)
        # then every later request serves on v2
        fl.refresh_registry()
        fl.submit(all_docs[0], seed=10_000)
        late = fl.run(timeout=TIMEOUT)
    for i in seeds:
        assert np.array_equal(out[i], ref1[i]) or np.array_equal(out[i], ref2[i]), i
    _equal(late[10_000], _single_engine(snap2, all_docs[:1], [10_000])[10_000], "late")


# -- ensembles ----------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_fleet_ensemble_is_mean_over_versions(trained, tmp_path, workers):
    """ensemble=E: the mean of the E newest versions' mixtures in
    ascending version order, the per-version single engines' mean."""
    snap1, snap2, docs = trained
    ref1 = _single_engine(snap1, docs, range(len(docs)))
    ref2 = _single_engine(snap2, docs, range(len(docs)))
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    reg.publish(snap2)
    with _fleet(reg, workers=workers, ensemble=2) as fl:
        for i, doc in enumerate(docs):
            fl.submit(doc, seed=i)
        out = fl.run(timeout=TIMEOUT)
        s = fl.stats_summary()
    for i in range(len(docs)):
        want = np.mean(np.stack([ref1[i], ref2[i]]), axis=0, dtype=np.float32)
        _equal(out[i], want, i)
        np.testing.assert_allclose(want.sum(), 1.0, rtol=1e-5)
    assert s["completed"] == len(docs) and s["ensemble"] == 2
    assert sum(w["completed"] for w in s["per_worker"]) == 2 * len(docs)


def test_fleet_ensemble_requires_registry_depth(trained, tmp_path):
    snap1, _, _ = trained
    with pytest.raises(ValueError, match="needs a SnapshotRegistry"):
        _fleet(snap1, workers=1, ensemble=2)
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    with _fleet(reg, workers=1, ensemble=2) as fl:
        with pytest.raises(ValueError, match="ensemble needs 2"):
            fl.submit(np.arange(5, dtype=np.int32), seed=0)


# -- admission ----------------------------------------------------------------

def test_fleet_backpressure_and_stats(trained):
    """max_pending far below the workload: submit blocks and releases,
    every request completes bitwise, and the stats roll up by worker."""
    snap1, _, docs = trained
    n = 4 * len(docs)
    ref = _single_engine(snap1, [docs[i % len(docs)] for i in range(n)], range(n))
    with _fleet(snap1, workers=2, max_pending=3, slo_ms=60_000.0) as fl:
        for i in range(n):
            fl.submit(docs[i % len(docs)], seed=i, timeout=TIMEOUT)
            assert fl.router.queued() <= 3
        out = fl.run(timeout=TIMEOUT)
        s = fl.stats_summary()
    assert sorted(out) == list(range(n))
    for i in range(n):
        _equal(out[i], ref[i], i)
    assert s["completed"] == n and s["docs_per_s"] > 0
    assert s["p95_latency_ms"] >= s["p50_latency_ms"]
    assert sum(w["completed"] for w in s["per_worker"]) == n
    assert len(s["per_worker"]) == 2
    assert s["slo_ok"] + s["slo_miss"] == n


def test_fleet_ensemble_backpressure_bounded(trained, tmp_path):
    """A worker's capacity is `slots` across all its engines: version-
    pinned ensemble subtasks are not pulled past it."""
    snap1, snap2, docs = trained
    n = 3 * len(docs)
    all_docs = [docs[i % len(docs)] for i in range(n)]
    ref1 = _single_engine(snap1, all_docs, range(n))
    ref2 = _single_engine(snap2, all_docs, range(n))
    reg = SnapshotRegistry(str(tmp_path))
    reg.publish(snap1)
    reg.publish(snap2)
    with _fleet(reg, workers=1, ensemble=2, max_pending=2) as fl:
        for i, doc in enumerate(all_docs):
            fl.submit(doc, seed=i, timeout=TIMEOUT)
            assert fl.router.queued() <= 2
            inflight = sum(e.in_flight() for e in list(fl.workers[0].engines.values()))
            assert inflight <= fl.slots + 2, inflight
        out = fl.run(timeout=TIMEOUT)
    for i in range(n):
        want = np.mean(np.stack([ref1[i], ref2[i]]), axis=0, dtype=np.float32)
        _equal(out[i], want, i)


def test_fleet_rejects_duplicate_inflight_seed(trained):
    snap1, _, docs = trained
    with _fleet(snap1, workers=1, max_pending=64) as fl:
        fl.submit(docs[0], seed=5)
        with pytest.raises(ValueError, match="already in flight"):
            fl.submit(docs[1], seed=5)
        assert sorted(fl.run(timeout=TIMEOUT)) == [5]
        fl.submit(docs[1], seed=5)  # a drained id is free again
        assert sorted(fl.run(timeout=TIMEOUT)) == [5]


# -- the streamed trainer's publish hook -------------------------------------

def test_streaming_run_publishes_to_registry(rng, tmp_path):
    corpus, _ = planted_topics_corpus(rng, D=16, V=V, K_true=3)
    cfg = H.HDPConfig(K=K, V=V, bucket=K, z_impl="cuda", hist_cap=32)
    stream = StreamingHDP(cfg, ShardedCorpusStore.from_corpus(corpus, 8), device=CPU)
    reg = SnapshotRegistry(str(tmp_path / "reg"))
    st = stream.run(stream.init_state(0), 4, registry=reg, publish_every_iters=2,
                    publish_keep=2)
    assert reg.versions() == [1, 2]
    newest = reg.load(device=CPU)
    assert int(newest.it) == st.it == 4 and torch.equal(newest.phi, st.phi)
    # publishing never perturbs the chain
    plain = stream.run(stream.init_state(0), 4)
    for f in ("n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(plain, f), getattr(st, f)), f
    assert np.array_equal(plain.z_blocks.materialize(), st.z_blocks.materialize())
    # every iteration publishes at publish_every_iters=1
    reg1 = SnapshotRegistry(str(tmp_path / "reg1"))
    stream.run(stream.init_state(0), 2, registry=reg1, publish_every_iters=1)
    assert reg1.versions() == [1, 2]
    assert [reg1.manifest()["versions"][v]["it"] for v in ("1", "2")] == [1, 2]
    # the published artifact serves at once
    with _fleet(reg, workers=1) as fl:
        fl.submit(corpus.tokens[0][corpus.mask[0]], seed=0)
        out = fl.run(timeout=TIMEOUT)
    np.testing.assert_allclose(out[0].sum(), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="go together"):
        stream.run(st, 1, publish_every_iters=1)
    with pytest.raises(ValueError, match="go together"):
        stream.run(st, 1, registry=reg)
