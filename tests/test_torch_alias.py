"""Alias tables of the port: reconstructed pmf against the reference's,
the one-hot per-token build bitwise equal to the batched build, and the
normalisation guards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import alias as JA  # noqa: E402
from repro_torch.core import alias as TA  # noqa: E402


def reconstruct_pmf(prob, alias):
    """(R, K) tables -> (R, K) float64 pmfs."""
    prob = np.asarray(prob, np.float64)
    r, k = prob.shape
    ph = prob / k
    np.add.at(ph, (np.repeat(np.arange(r), k), np.asarray(alias).reshape(-1)),
              ((1 - prob) / k).reshape(-1))
    return ph


def pmf_errors(p, prob, alias):
    p = p.astype(np.float64)
    tgt = p / p.sum(1, keepdims=True)
    return np.abs(reconstruct_pmf(prob, alias) - tgt).max(1)


@pytest.mark.parametrize("w", [32, 128])
def test_pmf_error_no_worse_than_reference_on_tie_heavy_rows(w):
    """Poisson(0.7)-weighted rows are full of exact ties and exact
    ratios (0, 1/3, 2/3, 1), where pairings are most fragile. Per row the
    port's pmf error must not exceed the reference's by more than float32
    rounding (1e-6): the two frameworks sum in different orders, so on
    clean rows either may be a few ulps ahead."""
    rng = np.random.default_rng(w)
    p = rng.poisson(0.7, size=(2000, w)).astype(np.float32)
    p[p.sum(1) == 0, 0] = 1.0
    pj, aj = jax.tree.map(np.asarray, JA.alias_build(jnp.asarray(p)))
    pt, at = TA.alias_build(torch.from_numpy(p))
    err_t = pmf_errors(p, pt.numpy(), at.numpy())
    err_j = pmf_errors(p, pj, aj)
    worse = err_t > np.maximum(err_j, 1e-6)
    print(f"W={w}: max pmf error port {err_t.max():.3g}, reference "
          f"{err_j.max():.3g}; rows worse than the reference: {worse.sum()}")
    assert not worse.any(), np.flatnonzero(worse)[:10]
    assert ((pt >= 0) & (pt <= 1)).all()
    assert ((at >= 0) & (at < w)).all()


@pytest.mark.parametrize("k", [5, 33, 64, 256])
def test_pmf_exact_on_rows_without_ties(k):
    """Continuous weights at the table widths the sweep uses (W <= 256;
    the left-to-right float32 sums' error grows with the width)."""
    rng = np.random.default_rng(k)
    p = rng.gamma(0.3, size=(200, k)).astype(np.float32)
    p[rng.random((200, k)) < 0.4] = 0.0
    p[p.sum(1) == 0, 0] = 1.0
    pt, at = TA.alias_build(torch.from_numpy(p))
    assert pmf_errors(p, pt.numpy(), at.numpy()).max() < 1e-6


def _row_kinds(rng, k):
    """The row kinds of tests/test_alias.py::test_onehot_twin_..."""
    rows = [
        rng.gamma(0.3, size=k).astype(np.float32),        # generic
        np.full(k, 1.0 / (2 * k), np.float32),            # all small
        np.full(k, 2.0, np.float32),                      # all large (tied)
        np.full(k, 1.0 / k, np.float32),                  # exact mean tie
        np.zeros(k, np.float32),                          # zero (padded word)
    ]
    hot = np.zeros(k, np.float32)
    hot[k // 2] = 3.0
    rows.append(hot)                                      # single winner
    mixed = rng.gamma(0.3, size=k).astype(np.float32)
    mixed[rng.random(k) < 0.5] = 0.0
    rows.append(mixed)                                    # sparse support
    return np.stack(rows)


@pytest.mark.parametrize("k", [2, 3, 255, 256, 257])
def test_onehot_bitwise_equals_batched_build(k):
    p = torch.from_numpy(_row_kinds(np.random.default_rng(k), k))
    prob_f, alias_f = TA.alias_build(p)
    prob_o, alias_o = TA.alias_build_row_onehot(p)
    assert torch.equal(prob_f, prob_o)
    assert torch.equal(alias_f, alias_o)
    # one row at a time too (the per-token shape of the kernel prologue)
    for i in range(p.shape[0]):
        po, ao = TA.alias_build_row_onehot(p[i])
        assert torch.equal(po, prob_f[i]) and torch.equal(ao, alias_f[i])


def test_normalized_guards_nan_inf_zero_and_negative_rows():
    nan, inf = float("nan"), float("inf")
    p = torch.tensor([
        [1.0, nan, 3.0, 0.0],     # NaN cleared
        [inf, 1.0, 1.0, 2.0],     # Inf cleared, not a NaN row
        [0.0, 0.0, 0.0, 0.0],     # zero row -> uniform
        [nan, inf, -inf, -1.0],   # nothing finite and positive -> uniform
        [-2.0, 1.0, 0.0, 1.0],    # negative cleared
    ])
    q = TA._normalized(p)
    assert torch.isfinite(q).all()
    torch.testing.assert_close(q[0], torch.tensor([1.0, 0.0, 3.0, 0.0]))
    torch.testing.assert_close(q[1], torch.tensor([0.0, 1.0, 1.0, 2.0]))
    torch.testing.assert_close(q[2], torch.ones(4))
    torch.testing.assert_close(q[3], torch.ones(4))
    torch.testing.assert_close(q[4], torch.tensor([0.0, 2.0, 0.0, 2.0]))
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jax.vmap(JA._normalized)(jnp.asarray(p.numpy()))))
    prob, alias = TA.alias_build(p)
    assert torch.isfinite(prob).all()
    pmf = reconstruct_pmf(prob.numpy(), alias.numpy())
    np.testing.assert_allclose(pmf[2], 0.25, atol=1e-7)
    assert pmf[0][1] == 0.0 and pmf[1][0] == 0.0  # cleared entries never drawn


def test_ordered_sums_are_left_to_right_float32():
    x = torch.tensor([[1e8, 1.0, -1e8, 3.0]])
    # float32 left to right: 1e8 + 1 rounds to 1e8, so the 1 is lost
    assert TA.ordered_cumsum(x).tolist() == [[1e8, 1e8, 0.0, 3.0]]
    assert TA.ordered_sum(x).tolist() == [3.0]


def test_alias_sample_matches_target():
    rng = np.random.default_rng(0)
    p = torch.tensor([0.5, 0.1, 0.0, 0.3, 0.1])
    prob, alias = TA.alias_build(p)
    u = torch.from_numpy(rng.random((100_000, 2)).astype(np.float32))
    idx = TA.alias_sample(prob, alias, u[:, 0], u[:, 1])
    freq = np.bincount(idx.numpy(), minlength=5) / len(u)
    np.testing.assert_allclose(freq, (p / p.sum()).numpy(), atol=7e-3)
    assert freq[2] == 0.0
