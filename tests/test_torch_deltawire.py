"""The port's sparse bit-packed delta_n wire format
(``repro_torch/data/deltawire.py``) and its device half
(``kernels/hdp_z/ops.py::delta_sparsify``), against the reference's.

The cases of tests/test_deltawire.py run on the port's copy; the packs
of seeded deltas are byte for byte the reference's, and
``delta_sparsify`` is bitwise JAX's on the same delta.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.data import deltawire as JDW  # noqa: E402
from repro.kernels.hdp_z import ops as JZ  # noqa: E402
from repro_torch.data import deltawire as DW  # noqa: E402
from repro_torch.kernels.hdp_z import ops as TZ  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on slim images
    HAVE_HYPOTHESIS = False


# -- the reference's cases on the port's copy ------------------------------------

def test_idx_dtype_thresholds():
    assert DW.idx_dtype_for(0) == np.uint8
    assert DW.idx_dtype_for(255) == np.uint8
    assert DW.idx_dtype_for(256) == np.uint16
    assert DW.idx_dtype_for(65535) == np.uint16
    assert DW.idx_dtype_for(65536) == np.int32


def test_val_dtype_thresholds():
    assert DW.val_dtype_for(-128, 127) == np.int8
    assert DW.val_dtype_for(-129, 0) == np.int16
    assert DW.val_dtype_for(0, 128) == np.int16
    assert DW.val_dtype_for(-32768, 32767) == np.int16
    assert DW.val_dtype_for(0, 32768) == np.int32
    assert DW.val_dtype_for(-32769, 0) == np.int32


def test_pack_lands_on_narrowest_dtypes():
    p = DW.pack_delta(np.eye(16, 16, dtype=np.int32) * -3)
    assert p.kind == "coo"
    assert p.idx.dtype == np.uint8 and p.val.dtype == np.int8
    dn = np.zeros((16, 17), np.int32)
    dn[15, 16] = 1  # flat index 271
    p = DW.pack_delta(dn)
    assert p.idx.dtype == np.uint16 and p.val.dtype == np.int8
    dn = np.zeros((4, 4), np.int32)
    dn[0, 0] = 200
    p = DW.pack_delta(dn)
    assert p.idx.dtype == np.uint8 and p.val.dtype == np.int16


def test_roundtrip_empty_and_boundary_values():
    zero = np.zeros((8, 8), np.int32)
    p = DW.pack_delta(zero)
    assert p.kind == "coo" and p.nbytes == 0
    np.testing.assert_array_equal(DW.unpack_delta(p), zero)
    dn = np.zeros((8, 8), np.int32)
    dn[0, 0], dn[7, 7] = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    np.testing.assert_array_equal(DW.unpack_delta(DW.pack_delta(dn)), dn)


def test_dense_fallback_crossover():
    dn = np.zeros((10, 10), np.int32)
    flat = dn.reshape(-1)
    flat[:24] = 1  # 24% nnz, below the 25% threshold
    assert DW.pack_delta(dn).kind == "coo"
    flat[:26] = 1
    p = DW.pack_delta(dn)
    assert p.kind == "dense" and p.val.dtype == np.int8 and p.nbytes == 100
    np.testing.assert_array_equal(DW.unpack_delta(p), dn)
    assert DW.pack_delta(dn, dense_threshold=1.0).kind == "coo"  # 52 B < 100 B
    flat[:50] = 1
    assert DW.pack_delta(dn, dense_threshold=1.0).kind == "dense"


def test_reduce_matches_dense_sum_and_counts_bytes():
    rng = np.random.default_rng(0)
    shards = [rng.integers(-4, 5, (12, 30)).astype(np.int32)
              * (rng.random((12, 30)) < f) for f in (0.001, 0.05, 0.4)]
    packs = [DW.pack_delta(s) for s in shards]
    assert {p.kind for p in packs} == {"coo", "dense"}
    np.testing.assert_array_equal(DW.reduce_packed(packs),
                                  np.sum(shards, axis=0, dtype=np.int32))
    assert DW.packed_nbytes(packs) == sum(p.nbytes for p in packs)
    np.testing.assert_array_equal(DW.reduce_packed([], shape=(3, 4)),
                                  np.zeros((3, 4), np.int32))
    with pytest.raises(ValueError, match="shape"):
        DW.reduce_packed([])


def test_pack_coo_validates_inputs():
    with pytest.raises(ValueError, match="mismatch"):
        DW.pack_coo(np.array([0, 1]), np.array([5]), (4, 4))
    with pytest.raises(ValueError, match="out of range"):
        DW.pack_coo(np.array([16]), np.array([1]), (4, 4))


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(
        k=st.integers(1, 20), v=st.integers(1, 40), nnz_frac=st.floats(0.0, 1.0),
        lo=st.sampled_from([-1, -127, -128, -129, -40000]),
        hi=st.sampled_from([1, 127, 128, 129, 40000]),
        nshards=st.integers(1, 4), seed=st.integers(0, 2**31 - 1),
    )
    def test_packed_reduce_equals_dense_reduce(k, v, nnz_frac, lo, hi, nshards, seed):
        rng = np.random.default_rng(seed)
        shards = []
        for _ in range(nshards):
            dn = rng.integers(lo, hi + 1, (k, v)).astype(np.int32)
            dn *= rng.random((k, v)) < nnz_frac
            shards.append(dn)
        packs = [DW.pack_delta(s) for s in shards]
        np.testing.assert_array_equal(DW.reduce_packed(packs, shape=(k, v)),
                                      np.sum(shards, axis=0, dtype=np.int32))
        for s, p in zip(shards, packs):
            np.testing.assert_array_equal(DW.unpack_delta(p), s)
            assert p.nbytes <= s.size * 4


# -- byte for byte the reference's wire --------------------------------------------

def _seeded_deltas(seed):
    rng = np.random.default_rng(seed)
    out = []
    for k, v, frac, lo, hi in ((12, 30, 0.01, -3, 3), (40, 300, 0.05, -200, 200),
                               (300, 300, 0.002, -40000, 40000), (10, 10, 0.6, -1, 1)):
        dn = rng.integers(lo, hi + 1, (k, v)).astype(np.int32)
        out.append(dn * (rng.random((k, v)) < frac))
    return out


def assert_same_wire(ours, ref):
    assert (ours.kind, ours.shape, ours.nbytes) == (ref.kind, ref.shape, ref.nbytes)
    for a, b in ((ours.idx, ref.idx), (ours.val, ref.val)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_packs_are_byte_equal_to_the_reference(seed):
    deltas = _seeded_deltas(seed)
    kinds = set()
    for dn in deltas:
        assert_same_wire(DW.pack_delta(dn), JDW.pack_delta(dn))
        flat = dn.reshape(-1)
        idx = np.flatnonzero(flat)
        coo = DW.pack_coo(idx, flat[idx], dn.shape)
        assert_same_wire(coo, JDW.pack_coo(idx, flat[idx], dn.shape))
        kinds.add(coo.kind)
    assert kinds == {"coo", "dense"}
    same = [d[:10, :10] for d in deltas]
    np.testing.assert_array_equal(
        DW.reduce_packed([DW.pack_delta(d) for d in same]),
        JDW.reduce_packed([JDW.pack_delta(d) for d in same]))


# -- the device half ---------------------------------------------------------------

@pytest.mark.parametrize("cap_of", ["tight", "loose", "short"])
@pytest.mark.parametrize("seed", [0, 3])
def test_delta_sparsify_is_bitwise_the_reference(seed, cap_of):
    rng = np.random.default_rng(seed)
    dn = rng.integers(-5, 6, (40, 70)).astype(np.int32) * (rng.random((40, 70)) < 0.03)
    dn[0, 0] = 7  # the padding gathers position 0
    nnz = int(np.count_nonzero(dn))
    cap = {"tight": nnz, "loose": 2 * nnz + 9, "short": nnz // 2}[cap_of]
    ji, jv, jn = JZ.delta_sparsify(jnp.asarray(dn), cap)
    ti, tv, tn = TZ.delta_sparsify(torch.from_numpy(dn), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32 and tn == int(jn) == nnz
    if cap >= nnz:  # the first nnz entries are the whole delta on the wire
        back = DW.unpack_delta(DW.pack_coo(ti[:tn].numpy(), tv[:tn].numpy(), dn.shape))
        np.testing.assert_array_equal(back, dn)
