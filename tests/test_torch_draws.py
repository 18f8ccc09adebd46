"""The port's random draws, held to the reference in distribution (the
two frameworks never give the same bits) and its deterministic parts
bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import polya_urn as JP  # noqa: E402
from repro.core.stick import sample_l_via_b_np  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.core import polya_urn as TP  # noqa: E402
from repro_torch.core import stick as TS  # noqa: E402


def gen(seed):
    return TH.make_generator(seed, "cpu")


def _check_poisson_moments(draws, rate):
    """draws (R, C) of Poisson(rate (C,)): per-cell mean within 5 standard
    errors, variance within 5 standard errors of the sample variance
    (Var(s^2) ~= (mu + 2 mu^2) / R for a Poisson(mu))."""
    r = draws.shape[0]
    mean = draws.mean(0)
    var = draws.var(0, ddof=1)
    se_mean = np.sqrt(rate / r)
    se_var = np.sqrt((rate + 2 * rate**2) / r)
    assert (np.abs(mean - rate) < 5 * se_mean + 1e-3).all(), (mean, rate)
    assert (np.abs(var - rate) < 5 * se_var + 1e-3).all(), (var, rate)


N_CELLS = np.array([0, 0, 1, 2, 5, 9, 0, 3], np.int32)


@pytest.mark.parametrize("beta", [0.01, 0.3])
def test_ppu_counts_match_poisson_moments(beta):
    reps = 20000
    n = torch.from_numpy(np.tile(N_CELLS, (reps, 1)))
    draws = TP.ppu_counts(gen(0), n, beta)
    assert draws.dtype == torch.int32 and (draws >= 0).all()
    _check_poisson_moments(draws.numpy().astype(np.float64), N_CELLS + beta)


@pytest.mark.parametrize("beta", [0.01, 0.3, 0.7])
def test_ppu_counts_budgeted_match_poisson_moments(beta):
    """Sparse draw: background by truncated inversion plus the non-zero
    cells' Poisson(n); beta > 0.5 falls back to the dense draw."""
    reps = 20000
    n = torch.from_numpy(np.tile(N_CELLS, (reps, 1)))
    budget = int((n > 0).sum())
    draws = TP.ppu_counts_budgeted(gen(1), n, beta, budget)
    assert draws.dtype == torch.int32 and draws.shape == n.shape
    _check_poisson_moments(draws.numpy().astype(np.float64), N_CELLS + beta)


def test_ppu_normalize_bitwise_equals_reference():
    rng = np.random.default_rng(0)
    varphi = rng.poisson(0.7, size=(12, 40)).astype(np.int32)
    varphi[3] = 0  # an empty topic stays zero
    a = TP.ppu_normalize(torch.from_numpy(varphi)).numpy()
    b = np.asarray(JP.ppu_normalize(jnp.asarray(varphi)))
    np.testing.assert_array_equal(a, b)
    assert (a[3] == 0).all()


def test_dirichlet_sample_mean():
    n = torch.tensor([[8, 0, 2, 0]] * 4000, dtype=torch.int32)
    phi = TP.dirichlet_sample(gen(2), n, 0.5)
    torch.testing.assert_close(phi.sum(1), torch.ones(4000))
    want = (np.array([8, 0, 2, 0]) + 0.5) / 12.0
    np.testing.assert_allclose(phi.mean(0).numpy(), want, atol=0.01)


def test_sample_l_matches_explicit_bernoullis():
    """Binomial trick == per-token Bernoullis (the reference's numpy
    oracle ``sample_l_via_b_np``), in mean and spread over repetitions."""
    rng = np.random.default_rng(0)
    d_docs, k = 30, 5
    m = rng.poisson(2.0, size=(d_docs, k)).astype(np.int32)
    psi = rng.dirichlet(np.ones(k))
    alpha = 0.8
    dh = TH.d_histogram(torch.from_numpy(m), 32)
    g = gen(3)
    trick = np.stack([
        TS.sample_l(g, dh, torch.tensor(psi, dtype=torch.float32), alpha).numpy()
        for _ in range(400)])
    explicit = np.stack([
        sample_l_via_b_np(np.random.default_rng(i), m, psi, alpha)
        for i in range(400)])
    np.testing.assert_allclose(trick.mean(0), explicit.mean(0), rtol=0.1, atol=0.6)
    np.testing.assert_allclose(trick.std(0), explicit.std(0), rtol=0.35, atol=0.6)


def test_sample_l_first_token_always_global():
    rng = np.random.default_rng(1)
    m = (rng.random((20, 4)) < 0.5).astype(np.int32)
    dh = TH.d_histogram(torch.from_numpy(m), 8)
    l = TS.sample_l(gen(4), dh, torch.full((4,), 0.25), alpha=0.5)
    np.testing.assert_array_equal(l.numpy(), m.sum(0))
    # a topic with psi == 0 still counts its first tokens (0/0 guarded)
    l0 = TS.sample_l(gen(4), dh, torch.zeros(4), alpha=0.5)
    np.testing.assert_array_equal(l0.numpy(), m.sum(0))


@pytest.mark.parametrize("gamma", [0.5, 1.0, 5.0])
def test_sample_psi_on_simplex_with_flag_truncation(gamma):
    rng = np.random.default_rng(2)
    l = torch.from_numpy(rng.poisson(5, 16).astype(np.int32))
    g = gen(5)
    for _ in range(20):
        psi = TS.sample_psi(g, l, gamma)
        assert abs(float(psi.sum()) - 1.0) < 1e-5
        assert (psi >= 0).all() and psi.shape == (16,)


def test_sample_psi_posterior_beta_moments():
    """K=2 collapse: the flag topic takes the whole remaining stick, so
    Psi_1 | l ~ Beta(1 + l_1, gamma + l_2) exactly."""
    l = torch.tensor([7, 3], dtype=torch.int32)
    gamma = 2.0
    g = gen(6)
    draws = np.stack([TS.sample_psi(g, l, gamma).numpy() for _ in range(4000)])
    np.testing.assert_allclose(draws.sum(1), 1.0, atol=1e-6)
    a, b = 1.0 + 7, gamma + 3
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1))
    assert abs(draws[:, 0].mean() - mean) < 4 * np.sqrt(var / 4000) + 1e-3
    np.testing.assert_allclose(draws[:, 0].var(), var, rtol=0.15)


def test_gem_prior_decays_and_matches_reference_mean():
    g = gen(7)
    assert TS.gem_prior_sample(g, 8, 1.0).device == g.device
    port = np.stack([TS.gem_prior_sample(g, 64, 1.0).numpy() for _ in range(300)])
    assert np.allclose(port.sum(1), 1.0, atol=1e-5)
    mean = port.mean(0)
    assert mean[0] > mean[10] > mean[40]
    from repro.core.stick import gem_prior_sample as jgem
    keys = jax.random.split(jax.random.key(5), 300)
    ref = np.asarray(jax.vmap(lambda k: jgem(k, 64, 1.0))(keys)).mean(0)
    # E[psi_0] = 1 / (1 + gamma) = 0.5; both within Monte Carlo error
    assert abs(mean[0] - 0.5) < 0.06 and abs(ref[0] - 0.5) < 0.06
