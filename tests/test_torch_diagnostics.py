"""The port's convergence diagnostics (``repro_torch/obs/diagnostics.py``)
against the reference's ``repro/obs/diagnostics.py`` on the same inputs,
and the observatory's contract on the port's streamed chain: gauges
published with a sink attached, the chain bitwise the silent one.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hdp as JH  # noqa: E402
from repro.obs import diagnostics as JD  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.core.streaming import StreamingHDP  # noqa: E402
from repro_torch.data import stream as TS  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402
from repro_torch.obs import diagnostics as TD  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_obs():
    obs.reset_for_tests()
    yield
    obs.reset_for_tests()


# -- ESS and Geweke: the reference's numpy --------------------------------------

def _chains():
    rng = np.random.default_rng(0)
    ar = np.empty(300)
    ar[0] = 0.0
    for i in range(1, 300):
        ar[i] = 0.9 * ar[i - 1] + rng.normal()
    return [rng.normal(size=400), ar, np.linspace(0, 50, 200) + rng.normal(size=200),
            np.ones(50), [1.0, 2.0, 3.0], [], rng.normal(size=7)]


@pytest.mark.parametrize("i", range(7))
def test_ess_and_geweke_equal_the_reference(i):
    x = _chains()[i]
    assert TD.ess(x) == JD.ess(x)
    assert TD.geweke(x) == JD.geweke(x)


def test_ess_and_geweke_behave_as_documented():
    rng = np.random.default_rng(2)
    assert TD.ess(rng.normal(size=400)) > 200
    assert TD.ess(np.ones(100)) == 0.0 and TD.ess([1.0, 2.0, 3.0]) == 0.0
    assert abs(TD.geweke(rng.normal(size=500))) < 3.0
    assert abs(TD.geweke(np.linspace(0, 50, 500) + rng.normal(size=500))) > 5.0
    assert TD.geweke([1.0, 2.0]) == 0.0


# -- the reductions ----------------------------------------------------------------

def _ll_reference(n, dh, psi, alpha, beta):
    """The documented expression in Python floats."""
    k_n, v_n = n.shape
    out = 0.0
    for k in range(k_n):
        out += math.lgamma(v_n * beta) - math.lgamma(v_n * beta + int(n[k].sum()))
        for v in range(v_n):
            out += math.lgamma(beta + int(n[k, v])) - math.lgamma(beta)
        a = max(alpha * float(psi[k]), 1e-30)
        for p in range(dh.shape[1]):
            if dh[k, p] > 0:
                out += dh[k, p] * (math.lgamma(a + p) - math.lgamma(a))
    return out


@pytest.mark.parametrize("seed", [3, 4])
def test_joint_loglik_within_1e5_of_the_reference(seed):
    rng = np.random.default_rng(seed)
    k, v, cap = 20, 50, 16
    n = rng.integers(0, 30, size=(k, v)).astype(np.int32)
    n[3] = 0  # a dead topic contributes exactly 0
    dh = rng.integers(0, 5, size=(k, cap + 1)).astype(np.int32)
    dh[:, 0] = 0
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    psi[5] = 0.0  # psi -> 0 must not give inf - inf
    jcfg = JH.HDPConfig(K=k, V=v, bucket=k, hist_cap=cap)
    tcfg = TH.HDPConfig(K=k, V=v, bucket=k, hist_cap=cap)
    want = float(JD.make_joint_loglik_fn(jcfg)(jnp.asarray(n), jnp.asarray(dh),
                                                jnp.asarray(psi)))
    got = float(TD.make_joint_loglik_fn(tcfg)(torch.from_numpy(n), torch.from_numpy(dh),
                                              torch.from_numpy(psi)))
    assert np.isfinite(got)
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(_ll_reference(n, dh, psi, tcfg.alpha, tcfg.beta), rel=1e-4)


def test_topic_fn_breaks_ties_as_the_reference():
    rng = np.random.default_rng(5)
    n = rng.integers(0, 3, size=(30, 40)).astype(np.int32)  # many ties
    n[7] = 0
    for top in (1, 4, 10):
        lj, ej, mj, tj = JD.make_topic_fn(top)(jnp.asarray(n))
        lt, et, mt, tt = TD.make_topic_fn(top)(torch.from_numpy(n))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        assert float(et) == pytest.approx(float(ej), rel=1e-6)
        assert float(mt) == pytest.approx(float(mj), rel=1e-6)
    live, entropy, max_frac, top = TD.make_topic_fn(2)(
        torch.tensor([[5, 0, 0], [0, 0, 0], [3, 2, 0]], dtype=torch.int32))
    assert live.tolist() == [True, False, True]
    assert float(max_frac) == pytest.approx(0.5)
    assert float(entropy) == pytest.approx(math.log(2), rel=1e-5)
    assert top.tolist()[0] == [0, 1]  # ties break by index


# -- the observatory ---------------------------------------------------------------

def _mini_cfgs():
    return (TH.HDPConfig(K=4, V=8, bucket=4, hist_cap=6),
            JH.HDPConfig(K=4, V=8, bucket=4, hist_cap=6))


def test_births_deaths_and_drift_as_the_reference():
    tcfg, jcfg = _mini_cfgs()
    ours = TD.ConvergenceDiagnostics(tcfg, num_tokens=100, top_words=2, min_chain=3)
    ref = JD.ConvergenceDiagnostics(jcfg, num_tokens=100, top_words=2, min_chain=3)
    reg, jreg = MetricsRegistry(), JRegistry()
    dh = np.zeros((4, 7), np.int32)
    psi = np.full(4, 0.25, np.float32)
    n0 = np.zeros((4, 8), np.int32)
    n0[0, :2] = 5
    n0[1, 2:4] = 5
    n1 = np.zeros((4, 8), np.int32)
    n1[1, 2:4] = 5   # topic 1 survives with the same top words
    n1[2, 6:8] = 5   # topic 2 born, topic 0 died
    n2 = np.array(n1)
    n2[1, 2:4] = 0
    n2[1, 4:6] = 5   # topic 1's top words churn
    for i, n in enumerate((n0, n1, n2)):
        ll = ours.update(reg, torch.from_numpy(n), torch.from_numpy(dh),
                         torch.from_numpy(psi))
        jll = ref.update(jreg, n, dh, psi)
        assert ll == pytest.approx(jll, rel=1e-5)
        if i == 0:
            assert reg.get("train.topic_births").value == 0
        if i == 1:
            assert reg.get("train.topic_births").value == 1
            assert reg.get("train.topic_deaths").value == 1
            assert reg.get("train.top_word_drift").value == 0.0
    assert reg.get("train.top_word_drift").value == pytest.approx(0.5)
    for name in ("train.topic_births", "train.topic_deaths", "train.top_word_drift",
                 "train.topic_mass_entropy", "train.topic_mass_max_frac",
                 "train.ess_log_lik", "train.ess_k_star", "train.geweke_k_star"):
        assert reg.get(name).value == jreg.get(name).value, name
    assert reg.get("train.k_star") is None  # K* belongs to the streamed trainer


def test_window_bounds_the_chains():
    tcfg, _ = _mini_cfgs()
    diag = TD.ConvergenceDiagnostics(tcfg, num_tokens=10, min_chain=2, window=5)
    reg = MetricsRegistry()
    rng = np.random.default_rng(0)
    for _ in range(12):
        n = torch.from_numpy(rng.integers(0, 4, size=(4, 8)).astype(np.int32))
        diag.update(reg, n, torch.zeros((4, 7), dtype=torch.int32),
                    torch.full((4,), 0.25))
    assert len(diag._ll_chain) == 5 and len(diag._kstar_chain) == 5


def test_phase_clock_accumulates_and_null_is_empty():
    clock = TD.PhaseClock()
    for name in ("sweep", "sweep", "tail"):
        with clock.time(name):
            pass
    assert set(clock.acc) == {"sweep", "tail"}
    with TD.NULL_CLOCK.time("anything"):
        pass
    assert TD.NULL_CLOCK.acc == {}


# -- end to end: the streamed chain ------------------------------------------------

def _stream(n_lanes):
    corpus, _ = planted_topics_corpus(np.random.default_rng(0), D=32, V=32, K_true=3,
                                      doc_len=(8, 16))
    store = TS.ShardedCorpusStore.from_corpus(corpus, 8)
    cfg = TH.HDPConfig(K=8, V=corpus.V, bucket=8, hist_cap=store.max_len,
                       alpha=2.0, gamma=2.0)
    return StreamingHDP(cfg, store, device="cpu", n_lanes=n_lanes)


def _run(stream, iters):
    state = stream.init_state(0)
    for _ in range(iters):
        state = stream.iteration(state)
    return state


@pytest.mark.parametrize("n_lanes", [1, 2])
def test_streamed_chain_with_metrics_and_trace_is_bitwise_the_silent_one(
        tmp_path, n_lanes):
    metrics, trace = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    obs.setup(trace=trace, metrics_path=metrics)
    try:
        on = _run(_stream(n_lanes), 9)
        M = obs.metrics()
        assert M.get("train.log_lik_per_token").value < 0
        assert M.get("train.k_star").value >= 1
        assert M.get("train.ess_log_lik") is not None  # 9 >= min_chain samples
        assert M.get("train.phase_ms", phase="tail").value > 0
        if n_lanes > 1:
            assert M.get("train.delta_reduce_mb") is not None
            assert M.get("train.phase_ms", phase="sweep", proc="d1").value > 0
    finally:
        obs.finalize()
    last = json.loads(open(metrics).read().splitlines()[-1])
    names = {m["name"] for m in last["metrics"]}
    assert {"train.k_star", "train.delta_nnz_frac", "train.log_lik",
            "train.iterations", "train.n_devices"} <= names
    spans = {e["name"] for e in json.load(open(trace))["traceEvents"] if e["ph"] == "X"}
    assert {"tables.build", "stage_wait", "corpus_read", "z_read", "h2d", "writeback",
            "tail"} <= spans
    assert ({"sweep.d0", "sweep.d1", "delta_reduce"} if n_lanes > 1 else {"sweep"}) <= spans

    obs.reset_for_tests()
    off = _run(_stream(n_lanes), 9)
    assert obs.metrics().get("train.log_lik") is None  # nothing computed without a sink
    for f in ("n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    np.testing.assert_array_equal(on.z_blocks.materialize(), off.z_blocks.materialize())
    assert torch.equal(on.gen.get_state(), off.gen.get_state())
