"""The slice as a whole: one HDP Gibbs iteration of the port against the
reference, and the port's own chain on the reference's planted corpus."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hdp as JH  # noqa: E402
from repro.data.synthetic import planted_topics_corpus as j_planted  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.core.convert import state_from_numpy, state_to_numpy  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402

K = 24


@pytest.fixture(scope="module")
def corpus():
    c, _ = planted_topics_corpus(np.random.default_rng(7), D=60, V=64,
                                 K_true=4, doc_len=(15, 30))
    return c


@pytest.fixture(scope="module")
def jax_state(corpus):
    """A reference state three dense iterations from random topics (the
    single-topic init barely moves in three iterations)."""
    cfg = JH.HDPConfig(K=K, V=corpus.V, bucket=32, z_impl="dense", hist_cap=32)
    tokens, mask = jnp.asarray(corpus.tokens), jnp.asarray(corpus.mask)
    state = JH.init_state(jax.random.key(0), tokens, mask, cfg)
    z = jnp.asarray(np.random.default_rng(1).integers(
        0, K - 1, corpus.tokens.shape).astype(np.int32))
    state = state._replace(z=z, n=JH.count_n(z, tokens, mask, K, corpus.V))
    step = jax.jit(lambda s: JH.gibbs_iteration(s, tokens, mask, cfg))
    for _ in range(3):
        state = step(state)
    return state, cfg, tokens, mask


def test_planted_corpus_is_the_reference_corpus(corpus):
    ref, _ = j_planted(np.random.default_rng(7), D=60, V=64, K_true=4,
                       doc_len=(15, 30))
    np.testing.assert_array_equal(corpus.tokens, ref.tokens)


def test_state_round_trip(jax_state):
    js = jax_state[0]
    st = state_from_numpy(js, seed=3, device="cpu")
    back = state_to_numpy(st)
    for f in ("z", "n", "phi", "varphi", "psi", "l"):
        np.testing.assert_array_equal(back[f], np.asarray(getattr(js, f)))
    assert back["it"] == 3 and st.it == 3
    assert st.z.dtype == torch.int32 and st.phi.dtype == torch.float32
    st2 = state_from_numpy(back, seed=3, device="cpu")
    assert torch.equal(st2.n, st.n)


def test_diagnostics_match_reference_on_a_carried_state(corpus, jax_state):
    js, jcfg, tokens, mask = jax_state
    cfg = TH.HDPConfig(K=K, V=corpus.V, bucket=32, z_impl="dense", hist_cap=32)
    st = state_from_numpy(js, seed=0, device="cpu")
    tt, mm = torch.from_numpy(corpus.tokens), torch.from_numpy(corpus.mask)
    for port_fn, ref_fn in (
        (TH.log_marginal_likelihood, JH.log_marginal_likelihood),
        (TH.posterior_predictive_ll, JH.posterior_predictive_ll),
    ):
        got = float(port_fn(st, tt, mm, cfg))
        want = float(ref_fn(js, tokens, mask, jcfg))
        assert got == pytest.approx(want, rel=1e-5), port_fn.__name__
    assert int(TH.active_topics(st)) == int(JH.active_topics(js))
    assert int(TH.flag_topic_tokens(st)) == int(JH.flag_topic_tokens(js))
    np.testing.assert_array_equal(TH.topic_sizes(st).numpy(),
                                  np.asarray(JH.topic_sizes(js)))
    m = TH.doc_topic_counts(st.z, mm, K)
    np.testing.assert_array_equal(
        m.numpy(), np.asarray(JH.doc_topic_counts(js.z, mask, K)))
    np.testing.assert_array_equal(
        TH.d_histogram(m, 32).numpy(),
        np.asarray(JH.d_histogram(JH.doc_topic_counts(js.z, mask, K), 32)))


@pytest.mark.parametrize("z_impl", ["dense", "cuda"])
def test_hybrid_z_step_matches_reference(corpus, jax_state, z_impl):
    """From the carried state, one z-step plus delta with the reference's
    phi and psi and shared uniforms: the same z, m and n. The port's cuda
    z-step (the plain sweep here) is fed the reference's tables; the
    dense z-step needs nothing but phi and psi."""
    from repro.kernels.hdp_z import ops as JZ
    from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda

    js, jcfg, tokens, mask = jax_state
    st = state_from_numpy(js, seed=0, device="cpu")
    rng = np.random.default_rng(11)
    u = rng.random(corpus.tokens.shape + (3,)).astype(np.float32)
    tt, mm = torch.from_numpy(corpus.tokens), torch.from_numpy(corpus.mask)
    if z_impl == "dense":
        zj, mj = JH.z_step_dense(tokens, mask, js.z, js.phi, js.psi,
                                 jcfg.alpha, jnp.asarray(u))
        zt, mt = TH.z_step_dense(tt, mm, st.z, st.phi, st.psi, jcfg.alpha,
                                 torch.from_numpy(u))
        dn = TH.delta_n(st.z, zt, tt, mm, K, corpus.V)
    else:
        qa, fp, ip = JZ.build_word_sparse_tables(js.phi, js.psi, jcfg.alpha, 16)
        zj, mj = JZ.hdp_z_pallas(tokens, mask, js.z, jnp.asarray(u), qa, fp, ip,
                                 kk=K, interpret=True)
        zt, mt, dn = hdp_z_cuda(tt, mm, st.z, torch.from_numpy(u), kk=K,
                                q_a=torch.from_numpy(np.array(qa)),
                                fpack=torch.from_numpy(np.array(fp)),
                                ipack=torch.from_numpy(np.array(ip)),
                                emit_delta=True)
    nj = np.asarray(js.n + JH.delta_n(js.z, zj, tokens, mask, K, corpus.V))
    live = int(corpus.mask.sum())
    diff = (zt.numpy() != np.asarray(zj)) & corpus.mask
    print(f"{z_impl}: {int(diff.sum())} of {live} live tokens differ")
    assert diff.sum() <= live / 10_000
    assert ((zt.numpy() != np.asarray(js.z)) & corpus.mask).any()
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal((st.n + dn).numpy(), nj)


def run_chain(corpus, iters, evals=3, seed=0):
    cfg = TH.HDPConfig(K=K, V=corpus.V, bucket=32, z_impl="cuda", hist_cap=32)
    tokens = torch.from_numpy(corpus.tokens)
    mask = torch.from_numpy(corpus.mask)
    state = TH.init_state(TH.make_generator(seed, "cpu"), tokens, mask, cfg)
    lls = [float(TH.posterior_predictive_ll(state, tokens, mask, cfg))]
    for _ in range(evals):
        for _ in range(iters // evals):
            state = TH.gibbs_iteration(state, tokens, mask, cfg)
        lls.append(float(TH.posterior_predictive_ll(state, tokens, mask, cfg)))
    return state, lls, cfg, tokens, mask


def test_port_chain_meets_the_reference_system_assertions(corpus):
    """tests/test_hdp_system.py::test_loglik_improves_and_stats_consistent,
    on the port's own chain (z_impl="cuda", plain sweep on CPU tensors)."""
    state, lls, cfg, tokens, mask = run_chain(corpus, iters=45)
    assert state.it == 45
    assert np.mean(lls[-2:]) > lls[0], lls
    n_re = TH.count_n(state.z, tokens, mask, cfg.K, cfg.V)
    assert torch.equal(n_re, state.n)
    assert int(state.n.sum()) == corpus.num_tokens
    assert abs(float(state.psi.sum()) - 1.0) < 1e-4
    assert int(TH.flag_topic_tokens(state)) <= max(2, corpus.num_tokens // 500)
    assert int(TH.active_topics(state)) > 1
    z = state.z.numpy()
    assert ((z >= 0) & (z < cfg.K))[corpus.mask].all()


def test_port_chain_is_determined_by_its_seed(corpus):
    a = run_chain(corpus, iters=3, evals=1, seed=5)[0]
    b = run_chain(corpus, iters=3, evals=1, seed=5)[0]
    assert torch.equal(a.z, b.z) and torch.equal(a.psi, b.psi)


def test_dense_z_impl_chain_and_config_guard(corpus):
    cfg = TH.HDPConfig(K=K, V=corpus.V, z_impl="dense", hist_cap=32)
    tokens = torch.from_numpy(corpus.tokens)
    mask = torch.from_numpy(corpus.mask)
    state = TH.init_state(TH.make_generator(1, "cpu"), tokens, mask, cfg)
    for _ in range(3):
        state = TH.gibbs_iteration(state, tokens, mask, cfg)
    assert torch.equal(state.n, TH.count_n(state.z, tokens, mask, K, corpus.V))
    with pytest.raises(ValueError, match="z_impl"):
        TH.init_state(TH.make_generator(1, "cpu"), tokens, mask,
                      cfg._replace(z_impl="sparse"))
