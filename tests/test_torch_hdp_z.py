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
from repro_torch.kernels.hdp_z import hdp_z as HZ  # noqa: E402
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


def bf16_to_torch(x):
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("k,v,d,l,w", SWEEP_SIZES[:3])
def test_compact_sweep_bitwise_equals_reference_pallas(k, v, d, l, w):
    """Compact tables (bf16 fpack, int16 ipack) built by the reference,
    fed to JAX's Pallas kernel in interpret mode and to the port's
    wrapper (its plain sweep on the CPU), with shared uniforms: z, m and
    dn bitwise equal."""
    phi, psi, tokens, mask, z0, u = problem(k * 5 + d, k, v, d, l)
    jx = [jnp.asarray(a) for a in (tokens, mask, z0, u)]
    qa, fp, ip = JZ.build_word_sparse_tables(jnp.asarray(phi), jnp.asarray(psi),
                                             0.3, w, compact=True)
    assert fp.dtype == jnp.bfloat16 and ip.dtype == jnp.int16
    z_p, m_p, dn_p = (np.asarray(a) for a in JK.hdp_z_pallas(
        *jx, qa, fp, ip, kk=k, interpret=True, emit_delta=True))
    fpt, ipt = bf16_to_torch(fp), T(ip)
    assert fpt.dtype == torch.bfloat16 and ipt.dtype == torch.int16
    tt = [T(a) for a in (tokens, mask, z0, u)]
    z_t, m_t, dn_t = (a.numpy() for a in hdp_z_cuda(
        *tt, kk=k, q_a=T(qa), fpack=fpt, ipack=ipt, emit_delta=True))
    np.testing.assert_array_equal(z_t, z_p)
    np.testing.assert_array_equal(m_t, m_p)
    np.testing.assert_array_equal(dn_t, dn_p)
    assert ((z_t != z0) & mask).any()
    # the widened tables give bitwise the same sweep
    wide = hdp_z_cuda(*tt, kk=k, q_a=T(qa), fpack=fpt.float(), ipack=ipt.int(),
                      emit_delta=True)
    for a, b in zip((z_t, m_t, dn_t), wide):
        np.testing.assert_array_equal(a, b.numpy())


def test_wrapper_takes_compact_tables_and_refuses_k_above_32768():
    phi, psi, tokens, mask, z0, u = problem(6, 12, 30, 5, 16)
    args = [T(a) for a in (tokens, mask, z0, u)]
    q_a, fpack, ipack = TZ.build_word_sparse_tables(T(phi), T(psi), 0.3, 8,
                                                    compact=True)
    before = hdp_z_cuda.launches
    got = hdp_z_cuda(*args, kk=12, q_a=q_a, fpack=fpack, ipack=ipack,
                     emit_delta=True)
    want = TR.hdp_z_ref(*args, q_a, fpack.float(), ipack.int(), kk=12,
                        emit_delta=True)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert hdp_z_cuda.launches == before
    with pytest.raises(ValueError, match="int16 topic ids: K=32769"):
        hdp_z_cuda(*args, kk=2**15 + 1, q_a=q_a, fpack=fpack, ipack=ipack)


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
    before_routes = dict(hdp_z_cuda.launches_by_route)
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
    assert hdp_z_cuda.launches_by_route == before_routes
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


# -- the lanes route: its choice, its live slots and its walks -----------------

H100_SMEM_OPTIN = 232_448  # bytes a block may opt in to on an H100


def test_route_takes_lanes_where_32_documents_fit():
    r = HZ.route
    for in_kernel in (True, False):
        assert r(1000, 256, in_kernel, H100_SMEM_OPTIN) == "lanes"
        assert r(1000, 2**15 - 1, in_kernel, H100_SMEM_OPTIN) == "lanes"
        assert r(1000, 2**15, in_kernel, H100_SMEM_OPTIN) == "warp"
        assert r(20_000, 256, in_kernel, H100_SMEM_OPTIN) == "warp"
    # three warps a block at K=1000: each warp's 32 documents' uint16 m
    # and its 32 x 33 int32 tile that stages m out, and apsi once
    assert HZ.lanes_warps(1000, True, H100_SMEM_OPTIN) == 3
    assert HZ.lanes_smem_bytes(1000, True, 3) == 3 * (64_000 + 4_224) + 4_000
    kmax = max(k for k in range(1, 5000)
               if HZ.lanes_smem_bytes(k, True) <= H100_SMEM_OPTIN)
    assert kmax == 3356
    assert r(kmax, 256, True, H100_SMEM_OPTIN) == "lanes"
    assert r(kmax + 1, 256, True, H100_SMEM_OPTIN) == "warp"
    assert r(kmax + 1, 256, False, H100_SMEM_OPTIN) == "lanes"


@pytest.mark.parametrize("order", ["value", "topic"])
def test_live_slots_of_word_sparse_supports(order):
    k, w = 12, 6
    phi = np.zeros((k, 5), np.float32)
    phi[[1, 7], 1] = 0.5          # word 1: two topics
    phi[[0, 3, 4, 9, 11], 2] = 0.1  # word 2: five topics
    phi[:, 3] = 0.05              # word 3: every topic, W slots live
    phi[5, 4] = 1.0               # word 4: one topic
    vals, ids = TZ.build_word_sparse_supports(T(phi), w, order=order)
    live = HZ.live_slots(vals)
    assert live.dtype == torch.int32
    nz = (vals != 0).numpy()
    want = [int(np.nonzero(r)[0].max()) + 1 if r.any() else 0 for r in nz]
    assert live.tolist() == want
    assert live[0] == 0 and live[3] == w
    if order == "value":
        assert live.tolist() == [0, 2, 5, 6, 1]
    else:  # zeros interleave before the last live slot
        assert live[1] == 1 + int(np.searchsorted(ids[1].numpy(), 7))
    # a NaN or inf value is live, wherever it sits
    bad = vals.clone()
    bad[0, 3] = float("nan")
    bad[4, 5] = float("inf")
    assert HZ.live_slots(bad)[[0, 4]].tolist() == [4, 6]
    # prologue mode: a slot whose apsi[id] is not finite is live too
    apsi = torch.ones(k)
    assert torch.equal(HZ.live_slots(vals, apsi, ids), live)
    apsi[int(ids[0, 2])] = float("inf")
    got = HZ.live_slots(vals, apsi, ids)
    assert got[0] == 3
    apsi[int(ids[0, 2])] = float("nan")
    assert HZ.live_slots(vals, apsi, ids)[0] == 3


def _graded_phi(rng, k, v, w):
    """A phi in which word j has j % (min(K, W) + 1) topics, so the words'
    supports hold every count of live slots from 0 to W."""
    phi = np.zeros((k, v), np.float32)
    for j in range(v):
        nnz = j % (min(k, w) + 1)
        top = rng.choice(k, size=nnz, replace=False)
        phi[top, j] = rng.integers(1, 5, nnz)
    return (phi / np.maximum(phi.sum(1, keepdims=True), 1.0)).astype(np.float32)


class _Walks:
    """The lanes kernel (``csrc/hdp_z_lanes.cu``) one document and one
    token at a time, every float op one float32 op in the kernel's order:
    the walks stop at the word's live slots, the second term-(b) walk at
    the first c >= t (while c is nondecreasing), and only the prologue's
    global branch reaches past live, through the slots whose q is 0.
    ``seen`` counts the paths taken."""

    def __init__(self, w, live, vals, ids, apsi=None, aprob=None, aalias=None):
        self.w, self.live, self.vals, self.ids = w, live, vals, ids
        self.apsi, self.aprob, self.aalias = apsi, aprob, aalias
        self.seen = dict.fromkeys(
            ("doc", "early_stop", "global", "small_past_live", "small_live",
             "large", "demote_past_live", "slots_read"), 0)

    def q(self, v, j, total):
        wa = self.vals[v, j] * self.apsi[self.ids[v, j]]
        p = wa if (np.isfinite(wa) and wa > 0) else np.float32(0)
        return p / max(total, np.float32(1e-30)) * np.float32(self.w)

    def alias_entry(self, v, n, s, total):
        f32, w = np.float32, self.w
        if not total > 0:
            return f32(1), s
        dcum = ucum = qs = ds = us = f32(0)
        next_large = -1
        for j in range(n):
            qj = self.q(v, j, total)
            sm = qj < 1
            dj, uj = (f32(1) - qj, f32(0)) if sm else (f32(0), qj - f32(1))
            dcum = dj if j == 0 else dcum + dj
            ucum = uj if j == 0 else ucum + uj
            if j == s:
                qs, ds, us = qj, dcum, ucum
                if sm:
                    break
            elif j > s and not sm:
                next_large = j
                break
        if s >= n:
            ds = dcum
            for j in range(n, s + 1):
                ds = f32(1) if j == 0 else ds + f32(1)
            qs = f32(0)
            self.seen["small_past_live"] += 1
        alias = s
        if qs < 1:
            self.seen["small_live"] += s < n
            prob = qs
            dprev = ds - (f32(1) - qs)
            uc = f32(0)
            for j in range(n):
                qj = self.q(v, j, total)
                uj = f32(0) if qj < 1 else qj - f32(1)
                uc = uj if j == 0 else uc + uj
                if not qj < 1 and not uc < dprev:
                    alias = j
                    break
        else:
            self.seen["large"] += 1
            prob, dc, p2 = f32(1), f32(0), n
            for j in range(n):
                qj = self.q(v, j, total)
                dj = f32(1) - qj if qj < 1 else f32(0)
                dc = dj if j == 0 else dc + dj
                if qj < 1 and not dc <= us:
                    p2 = j
                    break
            if p2 == n:
                while p2 < w:
                    dc = f32(1) if p2 == 0 else dc + f32(1)
                    if not dc <= us:
                        self.seen["demote_past_live"] += 1
                        break
                    p2 += 1
            if p2 < w:
                prob = (f32(1) + us) - dc
                if next_large >= 0:
                    alias = next_large
        return min(max(prob, f32(0)), f32(1)), alias

    def sweep(self, tokens, mask, z, uniforms, kk, q_a=None):
        f32, w = np.float32, self.w
        prologue = self.apsi is not None
        d, l = tokens.shape
        z_new = z.copy()
        m = np.zeros((d, kk), np.int64)
        for doc in range(d):
            np.add.at(m[doc], z[doc][mask[doc]], 1)
            for i in range(l):
                if not mask[doc, i]:
                    continue
                v, z_old = tokens[doc, i], z_new[doc, i]
                n = int(self.live[v])
                u1, u2, u3 = uniforms[doc, i]
                m[doc, z_old] -= 1
                md = m[doc]
                qb, total, mono = f32(0), f32(0), True
                qa = f32(0) if prologue else q_a[v]
                for j in range(n):
                    wb = self.vals[v, j] * f32(md[self.ids[v, j]])
                    mono = mono and not wb < 0
                    qb = wb if j == 0 else qb + wb
                    if prologue:
                        wa = self.vals[v, j] * self.apsi[self.ids[v, j]]
                        p = wa if (np.isfinite(wa) and wa > 0) else f32(0)
                        qa = wa if j == 0 else qa + wa
                        total = p if j == 0 else total + p
                self.seen["slots_read"] += n
                tot = qa + qb
                t = u1 * tot
                k_new = z_old
                if tot > 0:
                    if t < qb or qa <= 0:
                        self.seen["doc"] += 1
                        c, cnt = f32(0), 0
                        for j in range(n):
                            wb = self.vals[v, j] * f32(md[self.ids[v, j]])
                            c = wb if j == 0 else c + wb
                            if c < t:
                                cnt += 1
                            elif mono:
                                self.seen["early_stop"] += j < n - 1
                                break
                        k_new = self.ids[v, min(cnt, w - 1)]
                    else:
                        self.seen["global"] += 1
                        s = min(int(u2 * f32(w)), w - 1)
                        if prologue:
                            prob, alias = self.alias_entry(v, n, s, total)
                        else:
                            prob, alias = self.aprob[v, s], self.aalias[v, s]
                        k_new = self.ids[v, s if u3 < prob else alias]
                m[doc, k_new] += 1
                z_new[doc, i] = k_new
        return z_new, m


@pytest.mark.parametrize("order", ["value", "topic"])
@pytest.mark.parametrize("k,w,alpha,inf_apsi", [
    (8, 8, 2.0, False), (24, 16, 5.0, False), (257, 33, 1.0, False),
    (64, 64, 2.0, True)])
def test_lane_walks_bitwise_equal_plain_version(order, k, w, alpha, inf_apsi):
    """The argument that makes the live-slot bound exact, checked on the
    CPU: an emulation of the lanes kernel's walks, bounded by
    ``live_slots``, against ``hdp_z_ref`` and ``hdp_z_ref_prologue``,
    bitwise in z, m and dn, with words of every live count from 0 to W."""
    rng = np.random.default_rng(k + w)
    v, d, l = 2 * (min(k, w) + 1), 7, 20
    phi = _graded_phi(rng, k, v, w)
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    tokens = rng.integers(0, v, (d, l)).astype(np.int32)
    mask = rng.random((d, l)) > 0.15
    z0 = rng.integers(0, k, (d, l)).astype(np.int32)
    u = rng.random((d, l, 3)).astype(np.float32)
    tt = [T(a) for a in (tokens, mask, z0, u)]
    apsi = torch.tensor(alpha, dtype=torch.float32) * T(psi)
    if inf_apsi:  # a zero slot meets it: 0 * inf is NaN
        apsi[int(np.nonzero(phi[:, 1] == 0)[0][0])] = float("inf")
    vals, ids = TZ.build_word_sparse_supports(T(phi), w, order=order)
    q_a, fpack, ipack = TZ.build_word_sparse_tables(T(phi), T(psi), alpha, w,
                                                    order=order)
    plain = {
        "prologue": TR.hdp_z_ref_prologue(*tt, apsi, vals, ids, kk=k,
                                          emit_delta=True),
        "table": TR.hdp_z_ref(*tt, q_a, fpack, ipack, kk=k, emit_delta=True),
    }
    walks = {
        "prologue": _Walks(w, HZ.live_slots(vals, apsi, ids).numpy(),
                           vals.numpy(), ids.numpy(), apsi=apsi.numpy()),
        "table": _Walks(w, HZ.live_slots(fpack[:, 0]).numpy(),
                        fpack[:, 0].numpy(), ipack[:, 0].numpy(),
                        aprob=fpack[:, 1].numpy(), aalias=ipack[:, 1].numpy()),
    }
    live = walks["table"].live
    nnz = (vals != 0).sum(1).numpy()
    assert set(nnz.tolist()) == set(range(min(k, w) + 1))
    if order == "value":  # zeros trail: live is the support's size
        assert np.array_equal(live, nnz)
    else:  # zeros interleave before the last live slot
        assert (live >= nnz).all() and (live > nnz).any()
    with np.errstate(all="ignore"):
        for mode, em in walks.items():
            z_e, m_e = em.sweep(tokens, mask, z0, u, k,
                                q_a=q_a.numpy() if mode == "table" else None)
            z_p, m_p, dn_p = plain[mode]
            assert np.array_equal(z_e, z_p.numpy()), mode
            assert np.array_equal(m_e, m_p.numpy()), mode
            dn_e = TH.delta_n(T(z0), T(z_e.astype(np.int32)), T(tokens),
                              T(mask), k, v)
            assert torch.equal(dn_e, dn_p), mode
            assert em.seen["global"], (mode, em.seen)
            assert em.seen["slots_read"] < int(mask.sum()) * w, (mode, em.seen)
    seen = walks["prologue"].seen
    assert walks["table"].seen["early_stop"] and seen["large"], seen
    if not inf_apsi:  # else every word meeting the inf topic has q_a NaN or inf
        assert seen["early_stop"] and seen["small_live"], seen
    if order == "value":
        assert seen["small_past_live"], seen
    assert ((z_e != z0) & mask).any()
