"""The port's SSD against the reference's.

On this CPU the wrapper ``ssd_intra_chunk`` runs its plain version
(``ssd_intra_chunk_ref``); the CUDA kernel is held against that plain
version on the card by ``chip_smoke.py``. Inputs come from numpy seeds
and reach both frameworks as the same float32 arrays. The tolerance is
that of ``tests/test_ssd.py``: atol 2e-4 (1e-4 for the decode step).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd.ops import ssd as jax_ssd  # noqa: E402
from repro.kernels.ssd.ops import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro.kernels.ssd.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.kernels.ssd.ssd import ssd_intra_chunk as jax_intra  # noqa: E402
from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step  # noqa: E402
from repro_torch.kernels.ssd.ref import (  # noqa: E402
    ssd_chunked, ssd_intra_chunk_ref, ssd_ref)
from repro_torch.kernels.ssd.ssd import ssd_intra_chunk  # noqa: E402

ATOL = 2e-4
SHAPES = [  # the parameter sets of tests/test_ssd.py: b, s, h, p, n, chunk
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 32, 4, 8, 4, 32),   # single chunk
    (1, 96, 1, 64, 32, 24),
]


def mk(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.standard_normal((b, s, h, p)).astype(np.float32),
        rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
        -rng.uniform(0.5, 2.0, (h,)).astype(np.float32),
        rng.standard_normal((b, s, h, n)).astype(np.float32),
        rng.standard_normal((b, s, h, n)).astype(np.float32),
    )
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_intra_chunk_matches_reference_kernel(b, s, h, p, n, chunk):
    jx, tx = mk(s + h, b, s, h, p, n)
    want = jax_intra(*jx, chunk=chunk, interpret=True)
    got = ssd_intra_chunk(*tx, chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        close(g, w)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_matches_reference_and_sequential(b, s, h, p, n, chunk):
    jx, tx = mk(s + p, b, s, h, p, n)
    y, hf = ssd(*tx, chunk=chunk)
    y_k, hf_k = jax_ssd(*jx, chunk=chunk, use_kernel=True, interpret=True)
    y_r, hf_r = jax_ssd_ref(*jx)
    close(y, y_k)
    close(hf, hf_k)
    close(y, y_r)
    close(hf, hf_r)
    y_p, hf_p = ssd_ref(*tx)
    close(y_p, y_r)
    close(hf_p, hf_r)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 50, 2, 8, 4, 16),
    (2, 37, 3, 16, 8, 8),
    (1, 5, 2, 8, 4, 8),    # shorter than one chunk
])
def test_ragged_length_matches_reference_chunked(b, s, h, p, n, chunk):
    """S not a multiple of the chunk: padded with dt = 0 steps, as the
    reference's ssd_chunked does."""
    jx, tx = mk(s, b, s, h, p, n)
    y_c, hf_c = jax_ssd_chunked(*jx, chunk=chunk)
    for y, hf in (ssd(*tx, chunk=chunk), ssd_chunked(*tx, chunk=chunk)):
        assert y.shape == (b, s, h, p)
        close(y, y_c)
        close(hf, hf_c)


def test_initial_state_carried():
    """Splitting a sequence across two calls == one call."""
    jx, tx = mk(11, 1, 64, 2, 8, 4)
    x, dt, a, bm, cm = tx
    y_full, hf_full = ssd(*tx, chunk=16)
    y1, h1 = ssd(x[:, :32], dt[:, :32], a, bm[:, :32], cm[:, :32], chunk=16)
    y2, h2 = ssd(x[:, 32:], dt[:, 32:], a, bm[:, 32:], cm[:, 32:], h1, chunk=16)
    close(y2, y_full[:, 32:].numpy())
    close(h2, hf_full.numpy())
    y_r, hf_r = jax_ssd_ref(*jx)
    close(y2, y_r[:, 32:])
    close(h2, hf_r)


def test_decode_step_equals_scan():
    jx, tx = mk(13, 2, 16, 2, 8, 4)
    x, dt, a, bm, cm = tx
    h = torch.zeros((2, 2, 4, 8))
    outs = []
    for t in range(16):
        y, h = ssd_decode_step(x[:, t], dt[:, t], a, bm[:, t], cm[:, t], h)
        outs.append(y)
    y_r, hf_r = jax_ssd_ref(*jx)
    close(torch.stack(outs, dim=1), y_r, atol=1e-4)
    close(h, hf_r, atol=1e-4)


def test_heads_sharing_b_and_c_as_a_stride_0_view():
    """The model passes B and C, shared by all heads, as an expand."""
    rng = np.random.default_rng(17)
    b, s, h, p, n = 2, 32, 3, 8, 4
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (h,)).astype(np.float32))
    b1 = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    c1 = torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
    bv, cv = (t[:, :, None, :].expand(b, s, h, n) for t in (b1, c1))
    assert bv.stride(2) == 0
    got = ssd_intra_chunk(x, dt, a, bv, cv, chunk=8)
    want = jax_intra(*(jnp.asarray(t.contiguous().numpy())
                       for t in (x, dt, a, bv, cv)), chunk=8, interpret=True)
    for g, w in zip(got, want):
        close(g, w)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, tx = mk(19, 1, 32, 2, 8, 4)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(*tx, chunk=8)
    for g, w in zip(got, ssd_intra_chunk_ref(*tx, chunk=8)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ssd_intra_chunk.launches == before == 0
    with pytest.raises(ValueError, match="must divide"):
        ssd_intra_chunk(*tx, chunk=5)
