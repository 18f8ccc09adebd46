"""The port's serving stack against the reference (``repro/serve``).

On this CPU the fold-in's "cuda" strategy runs the hdp_z wrapper's plain
version; the kernel is held bitwise against it on the card by
``chip_smoke.py`` phase 9. Cross-framework checks feed the port the
reference's own tables (``snapshot_from_numpy``) and uniforms
(``foldin_from_uniforms``): z and m are then held bitwise, and theta and
perplexity, float sums in two frameworks, within a stated tolerance.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.core import hdp as JH  # noqa: E402
from repro.kernels.hdp_z import ops as JZ  # noqa: E402
from repro.serve import eval as JEV  # noqa: E402
from repro.serve import foldin as JF  # noqa: E402
from repro.serve import snapshot as JSNAP  # noqa: E402
from repro_torch.core import hdp as H  # noqa: E402
from repro_torch.core.polya_urn import ppu_sample  # noqa: E402
from repro_torch.core.stick import gem_prior_sample  # noqa: E402
from repro_torch.core.convert import snapshot_from_numpy  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402
from repro_torch.kernels.hdp_z import ops as TZ  # noqa: E402
from repro_torch.serve import eval as EV  # noqa: E402
from repro_torch.serve import foldin as F  # noqa: E402
from repro_torch.serve import snapshot as SNAP  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K, V = 12, 48
BURNIN = 4
THETA_ATOL = 1e-6    # theta's normalizer is a float sum in each framework
PPL_RTOL = 1e-5
CPU = "cpu"


@pytest.fixture(scope="module")
def trained():
    """A small model trained by the port's sampler on planted topics and a
    held-out query batch (trained once for the file)."""
    rng = np.random.default_rng(0)
    corpus, _ = planted_topics_corpus(rng, D=48, V=V, K_true=3, doc_len=(10, 20))
    cfg = H.HDPConfig(K=K, V=V, bucket=K, z_impl="cuda", hist_cap=32)
    tokens = torch.from_numpy(corpus.tokens[:40])
    mask = torch.from_numpy(corpus.mask[:40])
    state = H.init_state(H.make_generator(0, CPU), tokens, mask, cfg)
    for _ in range(15):
        state = H.gibbs_iteration(state, tokens, mask, cfg)
    heldout = (corpus.tokens[40:], corpus.mask[40:])
    return state, cfg, heldout


@pytest.fixture(scope="module")
def snap(trained):
    state, cfg, _ = trained
    return SNAP.snapshot_from_state(state, cfg)


def jax_snapshot(state, cfg, compact=False):
    """The reference's snapshot of the same (Phi, Psi)."""
    return JSNAP.build_snapshot(jnp.asarray(state.phi.numpy()),
                                jnp.asarray(state.psi.numpy()), cfg.alpha,
                                compact=compact, it=state.it)


def jax_uniforms(key, seeds, length, burnin):
    """The reference's uniforms of sweeps 0..burnin: (u_init, (S, D, L, 3))."""
    seeds = jnp.asarray(seeds, jnp.int32)
    u = [np.array(JF.sweep_uniforms(key, seeds, jnp.full_like(seeds, s), length))
         for s in range(burnin + 1)]
    return torch.from_numpy(u[0]), torch.from_numpy(np.stack(u[1:]))


def _docs_from(tokens, mask):
    return [tokens[i][mask[i]] for i in range(tokens.shape[0])]


def _pair(tokens, mask):
    return torch.from_numpy(np.asarray(tokens)), torch.from_numpy(np.asarray(mask))


# -- the port against the reference ---------------------------------------------

@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("impl", ["dense", "sparse", "cuda"])
def test_foldin_on_reference_uniforms_and_tables_equals_reference(trained, compact, impl):
    """The reference's snapshot carried across and its uniforms fed in:
    every port strategy's z and m bitwise the reference's sparse fold-in;
    theta within THETA_ATOL."""
    state, cfg, (q_tokens, q_mask) = trained
    jsnap = jax_snapshot(state, cfg, compact)
    tsnap = snapshot_from_numpy(jsnap, device=CPU)
    assert tsnap.compact == compact and tsnap.W == jsnap.W
    seeds = np.arange(q_tokens.shape[0], dtype=np.int32)
    key = jax.random.key(7)
    theta_j, z_j = JF.foldin_docs(jsnap, jnp.asarray(q_tokens), jnp.asarray(q_mask),
                                  jnp.asarray(seeds), key, burnin=BURNIN,
                                  impl="sparse", return_z=True)
    u0, us = jax_uniforms(key, seeds, q_tokens.shape[1], BURNIN)
    tokens, mask = _pair(q_tokens, q_mask)
    theta_t, z_t = F.foldin_from_uniforms(tsnap, tokens, mask, u0, us, impl=impl)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    m_j = np.asarray(JH.doc_topic_counts(z_j, jnp.asarray(q_mask), K))
    np.testing.assert_array_equal(H.doc_topic_counts(z_t, mask, K).numpy(), m_j)
    np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=0,
                               atol=THETA_ATOL)
    assert ((z_t.numpy() != np.asarray(JF.init_z(
        jnp.asarray(q_tokens), jnp.asarray(q_mask), jnp.asarray(u0.numpy()),
        jsnap.fpack, jsnap.ipack))) & q_mask).any()  # burn-in moved tokens


def test_foldin_equals_reference_pallas_interpret(trained):
    """One case against the reference's Pallas kernel in interpret mode."""
    state, cfg, (q_tokens, q_mask) = trained
    jsnap = jax_snapshot(state, cfg)
    seeds = np.arange(q_tokens.shape[0], dtype=np.int32) + 3
    key = jax.random.key(9)
    theta_j, z_j = JF.foldin_docs(jsnap, jnp.asarray(q_tokens), jnp.asarray(q_mask),
                                  jnp.asarray(seeds), key, burnin=2, impl="pallas",
                                  return_z=True)
    u0, us = jax_uniforms(key, seeds, q_tokens.shape[1], 2)
    theta_t, z_t = F.foldin_from_uniforms(snapshot_from_numpy(jsnap, device=CPU),
                                          *_pair(q_tokens, q_mask), u0, us)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=0,
                               atol=THETA_ATOL)


@pytest.mark.parametrize("compact", [False, True])
def test_build_snapshot_tables_match_reference(trained, compact):
    """``build_snapshot`` against the reference's on the same (Phi, Psi),
    held as tests/test_torch_hdp_z.py holds the tables: supports bitwise,
    q_a within 1e-6, the same exact width."""
    state, cfg, _ = trained
    j = jax_snapshot(state, cfg, compact)
    t = SNAP.snapshot_from_state(state, cfg, compact=compact)
    assert (t.K, t.V, t.W, t.compact) == (j.K, j.V, j.W, compact)
    assert t.W == min(max(-(-TZ.max_column_nnz(state.phi) // 8) * 8, 8), K)
    wide = snapshot_from_numpy(j, device=CPU)
    np.testing.assert_array_equal(t.fpack[:, 0].float().numpy(),
                                  wide.fpack[:, 0].float().numpy())
    np.testing.assert_array_equal(t.ipack[:, 0].numpy(), wide.ipack[:, 0].numpy())
    np.testing.assert_allclose(t.q_a.numpy(), wide.q_a.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(t.phi.float().numpy(), wide.phi.float().numpy())
    np.testing.assert_array_equal(t.psi.numpy(), wide.psi.numpy())
    assert int(t.it) == int(j.it) == state.it and float(t.alpha) == float(j.alpha)


def test_heldout_perplexity_on_reference_uniforms_matches(trained):
    state, cfg, (ho_tokens, ho_mask) = trained
    jsnap = jax_snapshot(state, cfg)
    key = jax.random.key(5)
    want = JEV.heldout_perplexity(jsnap, ho_tokens, ho_mask, key, burnin=BURNIN,
                                  impl="sparse")
    u0, us = jax_uniforms(key, np.arange(ho_tokens.shape[0]), ho_tokens.shape[1],
                          BURNIN)
    ll, n = EV.heldout_scores_from_uniforms(snapshot_from_numpy(jsnap, device=CPU),
                                            *_pair(ho_tokens, ho_mask), u0, us)
    got = float(np.exp(-float(ll) / int(n)))
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


# -- the uniforms -------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def philox_numpy(ctr, key):
    """Philox-4x32-10 in numpy uint64, written apart from the port's: the
    32 x 32-bit products are exact in uint64."""
    c = [np.asarray(x, np.uint64) for x in ctr]
    k = [np.uint64(x) for x in key]
    for _ in range(10):
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & M32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & M32]
        k = [(k[0] + np.uint64(0x9E3779B9)) & M32, (k[1] + np.uint64(0xBB67AE85)) & M32]
    return c


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox-4x32-10."""
    kats = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
            ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
            ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
             (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in kats:
        got = F.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
        assert [int(g) for g in got] == list(want)
        assert [int(g) for g in philox_numpy(ctr, key)] == list(want)


def test_sweep_uniforms_match_an_independent_numpy_generator():
    seeds = np.array([0, 1, 7, 2**31 - 1, 2**40 + 5], np.int64)
    sweeps = np.array([0, 3, 1, 16, 2], np.int64)
    base, length = 2**33 + 123, 9
    got = F.sweep_uniforms(base, torch.from_numpy(seeds), torch.from_numpy(sweeps),
                           length).numpy()
    pos = np.arange(length, dtype=np.uint64)[None, :]
    ctr = (pos, sweeps.astype(np.uint64)[:, None], (seeds.astype(np.uint64) & M32)[:, None],
           (seeds.astype(np.uint64) >> np.uint64(32))[:, None])
    ctr = np.broadcast_arrays(*ctr)
    words = philox_numpy(ctr, (base & 0xFFFFFFFF, base >> 32))
    want = np.stack([(w >> np.uint64(8)).astype(np.float64) / 2**24 for w in words[:3]], -1)
    assert got.dtype == np.float32 and got.shape == (5, length, 3)
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (got >= 0).all() and (got < 1).all()


def test_sweep_uniforms_row_does_not_depend_on_its_batch():
    seeds = torch.tensor([5, 9, 11, 40], dtype=torch.int32)
    sweeps = torch.tensor([0, 2, 2, 7], dtype=torch.int32)
    full = F.sweep_uniforms(3, seeds, sweeps, 16)
    for d in range(4):
        alone = F.sweep_uniforms(3, seeds[d:d + 1], sweeps[d:d + 1], 16)
        assert torch.equal(alone[0], full[d])
    perm = torch.tensor([2, 0, 3, 1])
    assert torch.equal(F.sweep_uniforms(3, seeds[perm], sweeps[perm], 16), full[perm])
    # a longer row starts with the shorter one; other seeds, sweeps or
    # base seeds give other rows
    assert torch.equal(F.sweep_uniforms(3, seeds, sweeps, 40)[:, :16], full)
    assert not torch.equal(F.sweep_uniforms(4, seeds, sweeps, 16), full)
    assert not torch.equal(F.sweep_uniforms(3, seeds + 1, sweeps, 16), full)
    assert not torch.equal(F.sweep_uniforms(3, seeds, sweeps + 1, 16), full)


def test_sweep_uniforms_pass_a_kolmogorov_smirnov_test():
    u = F.sweep_uniforms(0, torch.arange(256), torch.arange(256) % 17, 64).numpy()
    for col in range(3):
        p = stats.kstest(u[..., col].ravel(), "uniform").pvalue
        assert p > 1e-3, (col, p)
    # columns and neighbouring positions are not correlated
    flat = u.reshape(-1, 3)
    assert abs(np.corrcoef(flat.T)[np.triu_indices(3, 1)]).max() < 0.02
    assert abs(np.corrcoef(u[:, :-1, 0].ravel(), u[:, 1:, 0].ravel())[0, 1]) < 0.02


# -- snapshot ---------------------------------------------------------------------

def test_snapshot_exact_tables_cover_support(snap, trained):
    state, _, _ = trained
    assert snap.W >= TZ.max_column_nnz(state.phi)
    assert snap.K == K and snap.V == V and not snap.compact
    ids, vals = snap.ipack[:, 0].numpy(), snap.fpack[:, 0].numpy()
    for v in range(V):
        assert (np.diff(ids[v][vals[v] > 0]) > 0).all(), v


def test_snapshot_save_load_roundtrip(snap, tmp_path):
    SNAP.save(str(tmp_path), snap)
    s2 = SNAP.load(str(tmp_path), device=CPU)
    for f in snap._fields:
        a, b = getattr(snap, f), getattr(s2, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f


def test_snapshot_load_runs_on_the_card_unless_asked_for_the_cpu(snap, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    SNAP.save(str(tmp_path), snap)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SNAP.load(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        SNAP.load(str(tmp_path / "nothing"), device=CPU)


def test_compact_snapshot_halves_tables(trained, tmp_path):
    state, cfg, _ = trained
    full = SNAP.snapshot_from_state(state, cfg)
    compact = SNAP.snapshot_from_state(state, cfg, compact=True)
    assert compact.compact
    assert compact.nbytes() < 0.6 * full.nbytes()
    SNAP.save(str(tmp_path), compact)
    s2 = SNAP.load(str(tmp_path), device=CPU)
    assert s2.fpack.dtype == torch.bfloat16 and s2.ipack.dtype == torch.int16
    assert s2.phi.dtype == torch.bfloat16
    assert torch.equal(compact.fpack.float(), s2.fpack.float())


def test_snapshot_save_replaces_previous(trained, tmp_path):
    """A snapshot dir holds the last artifact written, even one of a lower
    source iteration."""
    state, cfg, _ = trained
    hi = SNAP.build_snapshot(state.phi, state.psi, cfg.alpha, it=25)
    lo = SNAP.build_snapshot(state.phi * 0 + 1.0 / V, state.psi, cfg.alpha, it=5)
    SNAP.save(str(tmp_path), hi)
    SNAP.save(str(tmp_path), lo)
    got = SNAP.load(str(tmp_path), device=CPU)
    assert int(got.it) == 5 and torch.equal(got.phi, lo.phi)


def test_streaming_export_snapshot_hook(rng, tmp_path):
    from repro_torch.core.streaming import StreamingHDP
    from repro_torch.data.stream import ShardedCorpusStore

    corpus, _ = planted_topics_corpus(rng, D=16, V=V, K_true=3)
    cfg = H.HDPConfig(K=K, V=V, bucket=K, z_impl="cuda", hist_cap=32)
    stream = StreamingHDP(cfg, ShardedCorpusStore.from_corpus(corpus, 8), device=CPU)
    st = stream.iteration(stream.init_state(0))
    exported = stream.export_snapshot(str(tmp_path), st)
    loaded = SNAP.load(str(tmp_path), device=CPU)
    assert int(loaded.it) == st.it == 1
    assert torch.equal(exported.phi, st.phi) and torch.equal(loaded.phi, st.phi)


def test_compact_precondition_enforced_at_build():
    k_bad = 2**15 + 1  # the first K whose ids overflow int16
    phi = torch.full((k_bad, 4), 0.25)
    psi = torch.full((k_bad,), 1.0 / k_bad)
    with pytest.raises(ValueError, match="32768"):
        SNAP.build_snapshot(phi, psi, 0.3, w=8, compact=True)
    ok = SNAP.build_snapshot(phi[:-1], psi[:-1], 0.3, w=8, compact=True)
    assert ok.ipack.dtype == torch.int16 and ok.K == 2**15


def test_compact_precondition_enforced_at_load(tmp_path):
    """A compact artifact claiming more topics than int16 addresses is
    refused at load, and when carried across, before any sweep."""
    k_bad = 2**15 + 1
    legal = SNAP.build_snapshot(torch.full((16, 4), 0.25), torch.full((16,), 1 / 16),
                                0.3, compact=True)
    forged = legal._replace(phi=torch.zeros((k_bad, 4), dtype=torch.bfloat16),
                            psi=torch.zeros((k_bad,)))
    SNAP.save(str(tmp_path / "forged"), forged)
    with pytest.raises(ValueError, match="32768"):
        SNAP.load(str(tmp_path / "forged"), device=CPU)
    j_legal = JSNAP.build_snapshot(jnp.full((16, 4), 0.25), jnp.full((16,), 1 / 16),
                                   0.3, compact=True)
    j_forged = j_legal._replace(phi=jnp.zeros((k_bad, 4), jnp.bfloat16),
                                psi=jnp.zeros((k_bad,), jnp.float32))
    with pytest.raises(ValueError, match="32768"):
        snapshot_from_numpy(j_forged, device=CPU)


# -- fold-in --------------------------------------------------------------------

@pytest.mark.parametrize("compact", [False, True])
def test_foldin_impls_bitwise_equal(trained, compact):
    state, cfg, (q_tokens, q_mask) = trained
    s = SNAP.snapshot_from_state(state, cfg, compact=compact)
    tokens, mask = _pair(q_tokens, q_mask)
    seeds = torch.arange(tokens.shape[0])
    out = {impl: F.foldin_docs(s, tokens, mask, seeds, 7, burnin=BURNIN, impl=impl,
                               return_z=True)
           for impl in F.IMPLS}
    for impl in ("sparse", "cuda"):
        assert torch.equal(out["dense"][0], out[impl][0]), impl
        assert torch.equal(out["dense"][1], out[impl][1]), impl
    theta = out["dense"][0].numpy()
    assert theta.shape == (tokens.shape[0], K) and (theta >= 0).all()
    np.testing.assert_allclose(theta.sum(1), 1.0, rtol=1e-5)
    z0 = F.init_z(tokens, mask, F.sweep_uniforms(7, seeds, torch.zeros_like(seeds),
                                                 tokens.shape[1]), s.fpack, s.ipack)
    assert ((out["dense"][1] != z0) & mask).any()  # burn-in moved tokens


def test_foldin_mixture_tracks_document_topic(snap, trained):
    """Mixtures concentrate on few topics: the document sparsity that
    serving exploits."""
    _, _, (q_tokens, q_mask) = trained
    tokens, mask = _pair(q_tokens, q_mask)
    th = F.foldin_docs(snap, tokens, mask, torch.arange(tokens.shape[0]), 3,
                       burnin=8).numpy()
    top3 = np.sort(th, axis=1)[:, -3:].sum(1)
    assert (top3 > 0.5).all(), top3


def test_topic_mixture_recount_equals_sweep_m(snap, trained):
    _, _, (q_tokens, q_mask) = trained
    tokens, mask = _pair(q_tokens, q_mask)
    theta, z = F.foldin_docs(snap, tokens, mask, torch.arange(tokens.shape[0]), 2,
                             burnin=BURNIN, return_z=True)
    assert torch.equal(F.topic_mixture(z, mask, snap.psi, snap.alpha), theta)
    with pytest.raises(ValueError, match="unknown fold-in impl"):
        F.foldin_docs(snap, tokens, mask, torch.arange(tokens.shape[0]), 2,
                      impl="pallas")


@pytest.mark.parametrize("impl", ["dense", "sparse", "cuda"])
def test_restricted_snapshot_foldin_bitwise(snap, trained, impl):
    """A snapshot restricted to the batch's vocabulary (tokens remapped)
    folds in bitwise like the full one."""
    _, _, (q_tokens, q_mask) = trained
    tokens, mask = _pair(q_tokens, q_mask)
    seeds = torch.arange(tokens.shape[0])
    theta_full, z_full = F.foldin_docs(snap, tokens, mask, seeds, 13, burnin=BURNIN,
                                       impl=impl, return_z=True)
    sub, remapped = F.restrict_snapshot(snap, q_tokens, bucket=16)
    assert sub.V < snap.V and sub.V % 16 == 0
    assert sub.W == snap.W and sub.K == snap.K
    assert remapped.dtype == torch.int32
    assert all(t.is_contiguous() for t in sub)
    theta_sub, z_sub = F.foldin_docs(sub, remapped, mask, seeds, 13, burnin=BURNIN,
                                     impl=impl, return_z=True)
    assert torch.equal(theta_full, theta_sub) and torch.equal(z_full, z_sub)


def test_restricted_snapshot_bucket_bounds_shapes(snap, trained):
    _, _, (q_tokens, _) = trained
    sub_a, _ = F.restrict_snapshot(snap, q_tokens[:2], bucket=16)
    sub_b, _ = F.restrict_snapshot(snap, torch.from_numpy(q_tokens[2:5]), bucket=16)
    assert sub_a.V % 16 == 0 and sub_b.V % 16 == 0
    # padding rows copy the first id's row
    first = int(np.unique(q_tokens[:2])[0])
    assert torch.equal(sub_a.fpack[-1], snap.fpack[first])
    sub_e, rem_e = F.restrict_snapshot(snap, np.zeros((0, 4), np.int32), bucket=16)
    assert sub_e.V == 16 and tuple(rem_e.shape) == (0, 4)


# -- the engine ------------------------------------------------------------------

def _engine(snap, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("burnin", BURNIN)
    kw.setdefault("buckets", (16, 32))
    return ServeEngine(snap, **kw)


def test_engine_matches_direct_foldin_bitwise(snap, trained):
    _, _, (q_tokens, q_mask) = trained
    docs = _docs_from(q_tokens, q_mask)
    eng = _engine(snap, base_seed=11)
    rids = [eng.submit(doc, seed=i) for i, doc in enumerate(docs)]
    out = eng.run()
    assert sorted(out) == sorted(rids)
    for i, doc in enumerate(docs):
        bucket = 16 if len(doc) <= 16 else 32
        t = torch.zeros((1, bucket), dtype=torch.int32)
        m = torch.zeros((1, bucket), dtype=torch.bool)
        t[0, :len(doc)] = torch.from_numpy(doc)
        m[0, :len(doc)] = True
        direct = F.foldin_docs(snap, t, m, torch.tensor([i]), 11, burnin=BURNIN)[0]
        np.testing.assert_array_equal(out[i], direct.numpy(), i)


def test_engine_mixture_independent_of_batching(snap, trained):
    """One slot (sequential) against many, submission order reversed:
    bitwise the same mixture per document."""
    _, _, (q_tokens, q_mask) = trained
    docs = _docs_from(q_tokens, q_mask)

    def run(slots, order):
        eng = _engine(snap, slots=slots, base_seed=13)
        for i in order:
            eng.submit(docs[i], seed=i)
        return eng.run()

    a = run(1, range(len(docs)))
    b = run(5, reversed(range(len(docs))))
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid], b[rid], rid)


def test_engine_stats_and_continuous_admission(snap, trained):
    _, _, (q_tokens, q_mask) = trained
    docs = _docs_from(q_tokens, q_mask)
    eng = _engine(snap, slots=2, buckets=(32,))
    for i, doc in enumerate(docs):
        eng.submit(doc, seed=i)
    out = eng.run()
    s = eng.stats.summary()
    assert s["completed"] == len(docs) == len(out)
    # 2 slots, 8 documents: admissions interleave with sweeps
    assert BURNIN * (len(docs) // 2) <= s["steps"] < BURNIN * len(docs)
    assert s["docs_per_s"] > 0 and s["p50_latency_ms"] is not None
    assert s["p95_latency_ms"] >= s["p50_latency_ms"]
    assert s["compiled_shapes"] == [(2, 32)]
    assert s["latency_window"] == len(docs) and s["latencies_dropped"] == 0


def test_engine_rejects_duplicate_seed_and_drains_results(snap, trained):
    _, _, (q_tokens, q_mask) = trained
    docs = _docs_from(q_tokens, q_mask)
    eng = _engine(snap, slots=2, burnin=2, buckets=(32,))
    with pytest.raises(ValueError, match="burnin"):
        ServeEngine(snap, slots=1, burnin=0)
    with pytest.raises(ValueError, match="empty document"):
        eng.submit(np.zeros(0, np.int32))
    eng.submit(docs[0], seed=7)
    with pytest.raises(ValueError, match="already in flight"):
        eng.submit(docs[1], seed=7)
    assert eng.in_flight() == 1
    assert sorted(eng.run()) == [7]
    # results are drained, and the engine keeps no per-request state
    rid2 = eng.submit(docs[1], seed=7)
    assert sorted(eng.run()) == [rid2] and eng.in_flight() == 0


def test_engine_async_admit_bitwise_equal(snap, trained):
    """Packing on the daemon stage (the fleet's configuration) is value-
    identical to packing inline."""
    _, _, (q_tokens, q_mask) = trained
    docs = _docs_from(q_tokens, q_mask)

    def run(async_admit):
        eng = _engine(snap, base_seed=17, async_admit=async_admit)
        try:
            for i, doc in enumerate(docs):
                eng.submit(doc, seed=i)
            return eng.run()
        finally:
            eng.close()

    sync, packed = run(False), run(True)
    assert sorted(sync) == sorted(packed)
    for rid in sync:
        np.testing.assert_array_equal(sync[rid], packed[rid], rid)


def test_engine_truncates_overlong_docs(snap):
    eng = _engine(snap, slots=1, burnin=2, buckets=(8,))
    doc = np.arange(50, dtype=np.int32) % V
    rid = eng.submit(doc)
    out = eng.run()
    assert out[rid].shape == (K,)
    np.testing.assert_allclose(out[rid].sum(), 1.0, rtol=1e-5)
    # fold-in over the 8-token prefix
    direct = F.foldin_docs(snap, torch.from_numpy(doc[None, :8]),
                           torch.ones((1, 8), dtype=torch.bool), torch.tensor([rid]),
                           0, burnin=2)[0]
    np.testing.assert_array_equal(out[rid], direct.numpy())


# -- held-out evaluation --------------------------------------------------------

def test_completion_split_partitions_live_tokens():
    mask = torch.tensor([[1, 1, 0, 1, 1, 1, 0], [0, 1, 1, 1, 0, 0, 1]], dtype=torch.bool)
    est, pred = EV.completion_split(mask)
    assert not (est & pred).any() and torch.equal(est | pred, mask)
    assert est[0].tolist() == [1, 0, 0, 1, 0, 1, 0]
    assert est[1].tolist() == [0, 1, 0, 1, 0, 0, 0]
    j_est, j_pred = JEV.completion_split(jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(est.numpy(), np.asarray(j_est))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(j_pred))


def _random_z_state(gen, tokens, mask, cfg):
    """An HDP state whose z is uniform over K, with Phi and Psi drawn from
    it (the start of ``chip_smoke.py`` phase 9's served model)."""
    z = torch.where(mask, torch.randint(0, cfg.K, tokens.shape, generator=gen,
                                        dtype=torch.int32), 0)
    n = H.count_n(z, tokens, mask, cfg.K, cfg.V)
    phi, varphi = ppu_sample(gen, n, cfg.beta)
    return H.HDPState(z=z, n=n, phi=phi, varphi=varphi,
                      psi=gem_prior_sample(gen, cfg.K, cfg.gamma),
                      l=torch.zeros((cfg.K,), dtype=torch.int32), gen=gen, it=0)


def test_heldout_perplexity_trained_beats_untrained(trained, snap):
    """Perplexity ranks models: the port's sampler, trained 15 iterations
    on planted topics, scores below 0.9x the untrained model (the paper's
    single-topic init on the training documents: the training unigram),
    as does the planted truth; the file's trained snapshot scores in the
    sane range.

    The reference's test ranks a 15-iteration snapshot of 40 documents of
    10-20 tokens. At that size the ranking is noise in both packages, and
    from the single-topic init neither package's sampler leaves the one
    topic within tens of iterations on these planted topics. So the
    ranking is held where there is something to learn and data to learn
    it from: 500 training documents of 40-60 tokens, 200 held out, the
    chain started from z uniform over K, as ``chip_smoke.py`` phase 9
    trains its models."""
    state, cfg, (ho_tokens, ho_mask) = trained
    p_trained = EV.heldout_perplexity(snap, ho_tokens, ho_mask, 5, burnin=BURNIN)
    assert 1.0 < p_trained < V, p_trained
    corpus, truth = planted_topics_corpus(np.random.default_rng(0), D=700, V=V,
                                          K_true=3, doc_len=(40, 60))
    pcfg = cfg._replace(hist_cap=64)
    tokens, mask = _pair(corpus.tokens[:500], corpus.mask[:500])
    untrained = H.init_state(H.make_generator(0, CPU), tokens, mask, pcfg)
    chain = _random_z_state(H.make_generator(1, CPU), tokens, mask, pcfg)
    for _ in range(15):
        chain = H.gibbs_iteration(chain, tokens, mask, pcfg)
    phi = torch.zeros((K, V))
    phi[:3] = torch.from_numpy(truth.phi.astype(np.float32))
    psi = torch.full((K,), 1e-6)
    psi[:3] = torch.from_numpy(truth.psi.astype(np.float32))
    ho = (corpus.tokens[500:], corpus.mask[500:])
    p_truth, p_untrained, p_chain = (
        EV.heldout_perplexity(s_, *ho, 5, burnin=BURNIN) for s_ in (
            SNAP.build_snapshot(phi, psi / psi.sum(), cfg.alpha),
            SNAP.snapshot_from_state(untrained, pcfg),
            SNAP.snapshot_from_state(chain, pcfg)))
    assert p_truth < 0.9 * p_untrained, (p_truth, p_untrained)
    assert p_chain < 0.9 * p_untrained, (p_chain, p_untrained, p_truth)


# -- the CLI ---------------------------------------------------------------------

def _cli(*extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_hdp",
                           "--smoke", *extra], env=env, capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)


def test_serve_hdp_cli_runs_on_cpu_and_prints_its_json_line():
    out = _cli("--device", "cpu")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["mode"] == "serve_hdp" and summary["device"] == "cpu"
    assert summary["completed"] == summary["requests"] == 16
    assert summary["docs_per_s"] > 0 and summary["steps"] > 0
    assert summary["p95_latency_ms"] >= summary["p50_latency_ms"] > 0
    assert 1.0 < summary["heldout_perplexity"] < 64
    assert not summary["eval_synthetic"]


def test_serve_hdp_cli_without_card_exits_1_with_message():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    out = _cli(timeout=120)
    assert out.returncode == 1
    assert "no CUDA device is present" in out.stderr
    assert "{" not in out.stdout  # no result was printed
