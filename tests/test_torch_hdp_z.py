"""The port's hdp_z sweep against the reference.

On this CPU the wrapper ``hdp_z_cuda`` runs its plain version; the CUDA
kernel is held bitwise against that plain version on the card by
``chip_smoke.py``. Inputs come from numpy seeds and reach both
frameworks as the same arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conformance as JC  # noqa: E402
from repro.kernels.hdp_z import hdp_z as JK  # noqa: E402
from repro.kernels.hdp_z import ops as JZ  # noqa: E402
from repro.kernels.hdp_z import ref as JR  # noqa: E402
from repro_torch.core import conformance as TC  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.kernels.hdp_z import ops as TZ  # noqa: E402
from repro_torch.kernels.hdp_z import ref as TR  # noqa: E402
from repro_torch.kernels.hdp_z.hdp_z import hdp_z_cuda  # noqa: E402


def T(x):
    return torch.from_numpy(np.array(x))


def ppu_phi(rng, k, v, rate=0.8):
    """A PPU-like phi: integer Poisson counts normalized per topic (ties
    are everywhere, as in the sampler)."""
    varphi = rng.poisson(rate, size=(k, v)).astype(np.float32)
    varphi += rng.poisson(0.01, size=(k, v))
    return (varphi / np.maximum(varphi.sum(1, keepdims=True), 1.0)).astype(
        np.float32)


def problem(seed, k, v, d, l, rate=0.8):
    rng = np.random.default_rng(seed)
    phi = ppu_phi(rng, k, v, rate)
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    tokens = rng.integers(0, v, (d, l)).astype(np.int32)
    lens = rng.integers(l // 2, l + 1, d)
    mask = (np.arange(l)[None, :] < lens[:, None]) & (rng.random((d, l)) > 0.1)
    z0 = rng.integers(0, k, (d, l)).astype(np.int32)
    u = rng.random((d, l, 3)).astype(np.float32)
    return phi, psi, tokens, mask, z0, u


# -- 4. tables ---------------------------------------------------------------

@pytest.mark.parametrize("order", ["value", "topic"])
@pytest.mark.parametrize("k,v,w", [(16, 40, 4), (64, 30, 8), (256, 20, 32),
                                   (24, 50, 24)])
def test_tables_bitwise_equal_reference_on_tie_heavy_phi(order, k, v, w):
    rng = np.random.default_rng(k + w)
    phi = (rng.integers(0, 4, size=(k, v)) / 7.0).astype(np.float32)
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    vj, ij = JZ.build_word_sparse_supports(jnp.asarray(phi), w, order=order)
    vt, it = TZ.build_word_sparse_supports(T(phi), w, order=order)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    qj, fj, pj = JZ.build_word_sparse_tables(jnp.asarray(phi), jnp.asarray(psi),
                                             0.3, w, order=order)
    qt, ft, pt = TZ.build_word_sparse_tables(T(phi), T(psi), 0.3, w, order=order)
    np.testing.assert_array_equal(ft[:, 0].numpy(), np.asarray(fj)[:, 0])
    np.testing.assert_array_equal(pt[:, 0].numpy(), np.asarray(pj)[:, 0])
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-6)
    assert TZ.max_column_nnz(T(phi)) == int(JZ.max_column_nnz(jnp.asarray(phi)))


def test_compact_tables_and_their_guard():
    phi, psi, *_ = problem(0, 16, 30, 2, 2)
    q, f, i = TZ.build_word_sparse_tables(T(phi), T(psi), 0.3, 8, compact=True)
    assert f.dtype == torch.bfloat16 and i.dtype == torch.int16
    q32, f32, i32 = TZ.build_word_sparse_tables(T(phi), T(psi), 0.3, 8)
    assert torch.equal(i.to(torch.int32), i32)
    big = torch.zeros((2**15 + 1, 4))
    with pytest.raises(ValueError, match="K <= 32768"):
        TZ.build_word_sparse_tables(big, torch.ones(2**15 + 1), 0.3, 2,
                                    compact=True)


# -- 5. the sweep against the reference, table mode ---------------------------

SWEEP_SIZES = [  # (K, V, D, L, W): D with no factor in common with 8,
    (8, 24, 7, 16, 8),       # masked padding everywhere, W in {8, 16, 33}
    (24, 60, 13, 32, 16),
    (50, 100, 9, 40, 33),
    (16, 40, 11, 24, 16),    # W == K
]


@pytest.mark.parametrize("k,v,d,l,w", SWEEP_SIZES)
def test_sweep_table_mode_matches_reference(k, v, d, l, w):
    phi, psi, tokens, mask, z0, u = problem(k * 7 + d, k, v, d, l)
    jx = [jnp.asarray(a) for a in (tokens, mask, z0, u)]
    qa, fp, ip = JZ.build_word_sparse_tables(jnp.asarray(phi), jnp.asarray(psi),
                                             0.3, w)
    z_r, m_r, dn_r = JR.hdp_z_ref(*jx, qa, fp, ip, kk=k, emit_delta=True)
    z_p, m_p, dn_p = JK.hdp_z_pallas(*jx, qa, fp, ip, kk=k, interpret=True,
                                     emit_delta=True)
    tt = [T(a) for a in (tokens, mask, z0, u)]
    z_t, m_t, dn_t = TR.hdp_z_ref(*tt, T(qa), T(fp), T(ip), kk=k,
                                  emit_delta=True)
    z_t, m_t, dn_t = z_t.numpy(), m_t.numpy(), dn_t.numpy()
    live = int(mask.sum())
    for name, zr in (("ref", np.asarray(z_r)), ("pallas", np.asarray(z_p))):
        diff = (z_t != zr) & mask
        print(f"K={k} W={w}: {int(diff.sum())} of {live} live tokens differ "
              f"from the reference {name}")
        assert diff.sum() <= live / 10_000
        # dn agrees wherever no differing token touches the cell
        touched = np.zeros((k, v), bool)
        rows, cols = np.nonzero(diff)
        touched[z_t[rows, cols], tokens[rows, cols]] = True
        touched[zr[rows, cols], tokens[rows, cols]] = True
        touched[z0[rows, cols], tokens[rows, cols]] = True
        dn_ref = np.asarray(dn_r if name == "ref" else dn_p)
        np.testing.assert_array_equal(dn_t[~touched], dn_ref[~touched])
        doc_ok = ~diff.any(1)
        m_ref = np.asarray(m_r if name == "ref" else m_p)
        np.testing.assert_array_equal(m_t[doc_ok], m_ref[doc_ok])
    assert ((z_t != z0) & mask).any()  # the sweep moved tokens
    np.testing.assert_array_equal(z_t[~mask], z0[~mask])
    # exact invariants of the port's own outputs
    n0 = TH.count_n(T(z0), T(tokens), T(mask), k, v)
    assert torch.equal(n0 + T(dn_t), TH.count_n(T(z_t), T(tokens), T(mask), k, v))
    assert torch.equal(T(m_t), TH.doc_topic_counts(T(z_t), T(mask), k))


# -- 6. prologue mode against the port's own table mode -----------------------

@pytest.mark.parametrize("order", ["value", "topic"])
@pytest.mark.parametrize("k,w", [(2, 2), (3, 3), (24, 16), (255, 64),
                                 (256, 33), (257, 8)])
def test_prologue_bitwise_equals_table_mode(order, k, w):
    phi, psi, tokens, mask, z0, u = problem(k + w, k, 40, 9, 24, rate=0.3)
    args = [T(a) for a in (tokens, mask, z0)] + [T(phi), T(psi), 0.3, T(u), w]
    on = TZ.z_step_ref(*args, order=order, emit_delta=True,
                       alias_in_kernel="on")
    off = TZ.z_step_ref(*args, order=order, emit_delta=True,
                        alias_in_kernel="off")
    for x, y in zip(on, off):
        assert torch.equal(x, y)
    assert ((on[0].numpy() != z0) & mask).any()


# -- 7. conformance ------------------------------------------------------------

@pytest.mark.parametrize("k,v,w", [(8, 24, 8), (16, 48, 16), (24, 64, 24),
                                   (48, 100, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_conformant_impls_bitwise_equal(k, v, w, seed):
    rng = np.random.default_rng(seed)
    phi = ppu_phi(rng, k, v, rate=0.6)
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    d, l = 6, 24
    tokens = T(rng.integers(0, v, (d, l)).astype(np.int32))
    mask = T(rng.random((d, l)) > 0.2)
    z0 = T(rng.integers(0, k, (d, l)).astype(np.int32))
    u = T(rng.random((d, l, 3)).astype(np.float32))
    assert TZ.max_column_nnz(T(phi)) <= w
    q_a, fpack, ipack = TC.build_tables(T(phi), T(psi), 0.3, w)
    out = {impl: TC.z_step_conformant(impl, tokens, mask, z0, u, q_a, fpack,
                                      ipack, kk=k)
           for impl in ("dense", "sparse", "cuda")}
    for impl in ("sparse", "cuda"):
        assert torch.equal(out["dense"][0], out[impl][0]), impl
        assert torch.equal(out["dense"][1], out[impl][1]), impl
    assert torch.equal(out["dense"][1], TH.doc_topic_counts(out["dense"][0], mask, k))
    assert ((out["dense"][0] != z0) & mask).any()
    # and with the reference's conformance tables, the same map as JAX's
    qj, fj, ij = JC.build_tables(jnp.asarray(phi), jnp.asarray(psi), 0.3, w)
    zj, _ = JC.z_step_conformant("sparse", *(jnp.asarray(x.numpy()) for x in
                                             (tokens, mask, z0, u)),
                                 qj, fj, ij, kk=k)
    zt, _ = TC.z_step_conformant("dense", tokens, mask, z0, u, T(qj), T(fj),
                                 T(ij), kk=k)
    assert ((zt.numpy() != np.asarray(zj)) & mask.numpy()).sum() <= 1


# -- the wrapper ----------------------------------------------------------------

def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    phi, psi, tokens, mask, z0, u = problem(5, 12, 30, 5, 16)
    args = [T(a) for a in (tokens, mask, z0, u)]
    q_a, fpack, ipack = TZ.build_word_sparse_tables(T(phi), T(psi), 0.3, 8)
    vals, ids = TZ.build_word_sparse_supports(T(phi), 8)
    apsi = torch.tensor(0.3) * T(psi)
    before = hdp_z_cuda.launches
    for emit in (False, True):
        got = hdp_z_cuda(*args, kk=12, q_a=q_a, fpack=fpack, ipack=ipack,
                         emit_delta=emit)
        want = TR.hdp_z_ref(*args, q_a, fpack, ipack, kk=12, emit_delta=emit)
        assert len(got) == (3 if emit else 2)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        got = hdp_z_cuda(*args, kk=12, apsi=apsi, vals=vals, ids=ids,
                         emit_delta=emit)
        want = TR.hdp_z_ref_prologue(*args, apsi, vals, ids, kk=12,
                                     emit_delta=emit)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert hdp_z_cuda.launches == before
    with pytest.raises(ValueError, match="exactly one"):
        hdp_z_cuda(*args, kk=12, q_a=q_a, fpack=fpack, ipack=ipack, apsi=apsi,
                   vals=vals, ids=ids)
    with pytest.raises(ValueError, match="exactly one"):
        hdp_z_cuda(*args, kk=12, q_a=q_a)


def test_resolve_alias_in_kernel():
    r = TZ.resolve_alias_in_kernel
    assert r("on", on_cuda=False) is True
    assert r("off", on_cuda=True) is False
    assert r(True, on_cuda=False) is True
    assert r(False, on_cuda=True) is False
    assert r("auto", on_cuda=True) is True
    assert r("auto", on_cuda=False) is False
    assert r("auto", on_cuda=True, compact=True) is False
    with pytest.raises(ValueError, match="compact"):
        r("on", on_cuda=True, compact=True)
    with pytest.raises(ValueError, match="alias_in_kernel"):
        r("sometimes", on_cuda=True)


def test_z_step_cuda_on_cpu_equals_reference_z_step():
    """``z_step_cuda`` (auto resolves to table mode on CPU tensors)
    against the reference's ``z_step_ref`` on the same phi and uniforms:
    the port builds its own tables, whose alias pairings may differ from
    the reference's, so only the doc-branch share is exact; the law is."""
    phi, psi, tokens, mask, z0, u = problem(9, 16, 40, 8, 24)
    got = TZ.z_step_cuda(*(T(a) for a in (tokens, mask, z0)), T(phi), T(psi),
                         0.3, T(u), 16, emit_delta=True)
    want = TZ.z_step_ref(*(T(a) for a in (tokens, mask, z0)), T(phi), T(psi),
                         0.3, T(u), 16, emit_delta=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    zj = np.asarray(JZ.z_step_ref(*(jnp.asarray(a) for a in (tokens, mask, z0)),
                                  jnp.asarray(phi), jnp.asarray(psi), 0.3,
                                  jnp.asarray(u), 16)[0])
    agree = ((got[0].numpy() == zj) | ~mask).mean()
    assert agree > 0.9
