"""The port's SSD against the reference's.

On this CPU the wrapper ``ssd_intra_chunk`` runs its plain version
(``ssd_intra_chunk_ref``); the CUDA kernels are held against that plain
version on the card by ``chip_smoke.py``. Here the tensor-core kernel's
arithmetic (three TF32 passes, the masked scaling in registers) is
emulated and held to JAX, and its route and operand checks are tested.
Inputs come from numpy seeds and reach both frameworks as the same
float32 arrays. The tolerance is that of ``tests/test_ssd.py``: atol
2e-4 (1e-4 for the decode step).
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
    decay_to_end, segsum, ssd_chunked, ssd_intra_chunk_ref, ssd_ref)
from repro_torch.kernels.ssd.ssd import (  # noqa: E402
    check_operands, route, sm90_smem_bytes, ssd_intra_chunk, wide_smem_bytes)

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


def test_mamba2_shape_matches_the_reference():
    """mamba2-780m's state, head dim and chunk (N=128, P=64, chunk 128;
    the wide tensor-core route on the card) at B=1, S=256, H=2: the plain
    intra-chunk pass against the Pallas kernel in interpret mode, and
    the whole SSD against the reference's kernel path and its
    sequential scan."""
    b, s, h, p, n, chunk = 1, 256, 2, 64, 128, 128
    assert route(chunk, n, p) == "tensor_cores_wide"
    jx, tx = mk(128, b, s, h, p, n)
    for g, w in zip(ssd_intra_chunk(*tx, chunk=chunk),
                    jax_intra(*jx, chunk=chunk, interpret=True)):
        assert tuple(g.shape) == w.shape
        close(g, w)
    y, hf = ssd(*tx, chunk=chunk)
    y_k, hf_k = jax_ssd(*jx, chunk=chunk, use_kernel=True, interpret=True)
    y_r, hf_r = jax_ssd_ref(*jx)
    for got, want in ((y, y_k), (hf, hf_k), (y, y_r), (hf, hf_r)):
        close(got, want)


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
    assert sum(ssd_intra_chunk.launches_by_route.values()) == 0
    with pytest.raises(ValueError, match="must divide"):
        ssd_intra_chunk(*tx, chunk=5)


# -- the tensor-core kernel's arithmetic, its route and its operands ----------
#
# ``csrc/ssd_chunk_sm90.cu`` cannot run here; what it computes can. Each
# operand v of its three products is split into hi, v rounded to tf32 as
# cvt.rna.tf32.f32 rounds it, and lo = v - hi, of which the tensor core
# reads all but the low 13 bits; a product is lo.hi + hi.lo + hi.hi
# (summed here in float64). The scores are G * (2^(seg_ij log2 e) * dt_j),
# masked to 0 for j > i before the exp, with seg built from 16-row
# sub-blocks as the kernel builds it (``kernel_segsum``).

LOG2E = 1.4426950408889634
TF32_DROPPED = 0x1FFF  # the 13 low mantissa bits TF32 does not hold


def tf32_split(v: torch.Tensor):
    """(hi, lo) of float32 ``v``: hi rounded to tf32 to nearest, ties away
    from zero (cvt.rna.tf32.f32), and lo = v - hi exactly."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~TF32_DROPPED).view(torch.float32)
    return hi, v - hi


def tensor_core_reads(v: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor core reads from a float32 register."""
    return (v.contiguous().view(torch.int32) & ~TF32_DROPPED).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b in three TF32 passes, as the kernel's products take it (or,
    with ``passes=1``, hi.hi alone)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)

    def mm(u, v):
        return torch.matmul(tensor_core_reads(u).double(), tensor_core_reads(v).double())

    out = mm(ah, bh) if passes == 1 else mm(al, bh) + mm(ah, bl) + mm(ah, bh)
    return out.float()


def kernel_segsum(steps: torch.Tensor) -> torch.Tensor:
    """seg (..., CL, CL) of float32 ``steps`` (..., CL) as the kernel
    builds it: the chunk padded to 16-row sub-blocks; for j in block J
    below i's block I, (sfx_j + mid_JI) + pre_i, with pre the sums from
    a block's first row, sfx the sums from j + 1 to a block's last row
    and mid_JI the totals of the blocks between, each summed in order;
    within a diagonal block the masked cumsum of ``ref.segsum``."""
    cl = steps.shape[-1]
    clp = -(-cl // 16) * 16
    a = torch.cat([steps, steps.new_zeros(steps.shape[:-1] + (clp - cl,))], -1)
    nb = clp // 16
    blocks = a.reshape(a.shape[:-1] + (nb, 16))
    pre = torch.cumsum(blocks, -1)
    sfx = decay_to_end(blocks, blocks.dim() - 1)
    seg = a.new_full(a.shape + (clp,), float("-inf"))
    for bi in range(nb):
        ri = slice(16 * bi, 16 * bi + 16)
        seg[..., ri, ri] = segsum(blocks[..., bi, :], blocks.dim() - 2)
        mid = torch.zeros_like(pre[..., 0, 0])
        for bj in range(bi - 1, -1, -1):
            rj = slice(16 * bj, 16 * bj + 16)
            seg[..., ri, rj] = ((sfx[..., bj, None, :] + mid[..., None, None])
                                + pre[..., bi, :, None])
            mid = mid + pre[..., bj, -1]
    return seg[..., :cl, :cl]


def toward_zero(v: torch.Tensor) -> torch.Tensor:
    """float64 ``v`` to float32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def mm_3xtf32_ksteps(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the wide kernel takes it: each operand split as
    ``tf32_split`` splits it, the tensor core reading lo truncated; each
    k-step (8 of the inner dim) its passes lo.hi, hi.lo, hi.hi into a
    zeroed accumulator, each pass's sum exact and then truncated to
    float32 as the tensor core's adds truncate; each k-step added to a
    float32 running sum in k order."""
    ah, al = (tensor_core_reads(t).double() for t in tf32_split(a))
    bh, bl = (tensor_core_reads(t).double() for t in tf32_split(b))
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        part = torch.zeros_like(acc)
        terms = ((ah, bh),) if passes == 1 else ((al, bh), (ah, bl), (ah, bh))
        for u, v in terms:
            part = toward_zero(part.double() + torch.matmul(u[..., k], v[..., k, :]))
        acc = acc + part
    return acc


def wide_kernel_lines(steps: torch.Tensor):
    """The wide kernel's segment sums of float32 ``steps`` (..., CL), each
    a float32 sum in its own order: per 16-row sub-block the lines pre
    (from the block's first row) and sfx (from j + 1 to its last row)
    and its total; mid_JI the totals of J+1..I-1, before_I those of
    0..I-1 and after_J those of J+1..end, each summed upward; the
    diagonal block's column c summed from row c + 1 down. Returns (seg
    (..., CL, CL), -inf above the diagonal; the exponent of dec, before +
    pre; the exponent of the decay to the chunk's end, sfx + after)."""
    cl = steps.shape[-1]
    clp = -(-cl // 16) * 16
    a = torch.cat([steps, steps.new_zeros(steps.shape[:-1] + (clp - cl,))], -1)
    nb = clp // 16
    blocks = a.reshape(a.shape[:-1] + (nb, 16))
    pre, sfx = torch.empty_like(blocks), torch.empty_like(blocks)
    p = blocks[..., 0]
    s = torch.zeros_like(p)
    pre[..., 0] = p
    for k in range(16):
        if k:
            p = p + blocks[..., k]
            pre[..., k] = p
        sfx[..., 15 - k] = s
        s = s + blocks[..., 15 - k]
    tot = pre[..., 15]
    zero = torch.zeros_like(tot[..., 0])
    before, after, mid = [], [], {}
    for jb in range(nb):
        run = zero
        for ib in range(jb):
            run = run + tot[..., ib]
        before.append(run)
        run = zero
        for ib in range(jb + 1, nb):
            mid[jb, ib] = run
            run = run + tot[..., ib]
        after.append(run)
    seg = a.new_full(a.shape + (clp,), float("-inf"))
    for ib in range(nb):
        ri = slice(16 * ib, 16 * ib + 16)
        diag = a.new_full(a.shape[:-1] + (16, 16), float("-inf"))
        for c in range(16):
            run = torch.zeros_like(blocks[..., ib, 0])
            diag[..., c, c] = run
            for rw in range(c + 1, 16):
                run = run + blocks[..., ib, rw]
                diag[..., rw, c] = run
        seg[..., ri, ri] = diag
        for jb in range(ib):
            rj = slice(16 * jb, 16 * jb + 16)
            seg[..., ri, rj] = ((sfx[..., jb, None, :] + mid[jb, ib][..., None, None])
                                + pre[..., ib, :, None])
    cum = (torch.stack(before, -1)[..., None] + pre).reshape(a.shape)
    end = (sfx + torch.stack(after, -1)[..., None]).reshape(a.shape)
    return seg[..., :cl, :cl], cum[..., :cl], end[..., :cl]


def emulate_tensor_core_kernel(x, dt, a, bmat, cmat, *, chunk, passes=3, wide=False):
    """The kernel's arithmetic on the CPU: cum and the decays to the end
    sequential float32 sums, seg as ``kernel_segsum``, then G, y and st in
    three TF32 passes (or ``passes``) with the masked in-register
    scaling. Returns (y, st, dec) as ``ssd_intra_chunk``. With ``wide``
    the wide kernel's (``csrc/ssd_chunk_sm90_wide.cu``) order: the
    segment sums of ``wide_kernel_lines`` and each product as
    ``mm_3xtf32_ksteps`` takes it: the passes' sums
    truncated, 16 k-steps over N = 128 in G, over j in y and the state,
    added in float32."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc, cl = s // chunk, chunk
    xr = x.reshape(b, nc, cl, h, p).permute(0, 1, 3, 2, 4)
    dtr = dt.reshape(b, nc, cl, h).permute(0, 1, 3, 2)
    br = bmat.reshape(b, nc, cl, h, n).permute(0, 1, 3, 2, 4)
    cr = cmat.reshape(b, nc, cl, h, n).permute(0, 1, 3, 2, 4)
    steps = dtr * a[None, None, :, None]
    if wide:
        mm = mm_3xtf32_ksteps
        seg, cum, end = wide_kernel_lines(steps)
    else:
        mm = mm_3xtf32
        seg, cum, end = kernel_segsum(steps), torch.cumsum(steps, 3), decay_to_end(steps, 3)
    g = mm(cr, br.transpose(-1, -2), passes)
    if wide:  # the kernel's order: (G * L) * dt
        scores = (g * torch.exp2(seg * LOG2E)) * dtr[..., None, :]
    else:
        scores = g * (torch.exp2(seg * LOG2E) * dtr[..., None, :])
    y = mm(scores, xr, passes)
    wdt = torch.exp(end) * dtr
    st = mm((br * wdt[..., None]).transpose(-1, -2), xr, passes)
    return (y.permute(0, 1, 3, 2, 4).reshape(b, s, h, p), st,
            torch.exp(cum).permute(0, 1, 3, 2).reshape(b, s, h))


def oracle_intra_chunk(x, dt, a, bmat, cmat, *, chunk):
    """The intra-chunk pass in float64 from the float32 inputs, its
    decays from float64 segment sums of the exact products dt * A."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc, cl = s // chunk, chunk
    xr = x.double().reshape(b, nc, cl, h, p)
    dtr = dt.double().reshape(b, nc, cl, h)
    br = bmat.double().reshape(b, nc, cl, h, n)
    cr = cmat.double().reshape(b, nc, cl, h, n)
    steps = dtr * a.double()
    cum = torch.cumsum(steps, 2)
    ldec = torch.exp(segsum(steps, 2))
    xdt = xr * dtr[..., None]
    scores = torch.einsum("bcihn,bcjhn->bcijh", cr, br) * ldec
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)
    wend = torch.exp(decay_to_end(steps, 2))
    st = torch.einsum("bcjhn,bcjhp->bchnp", br * wend[..., None], xdt)
    return y.reshape(b, s, h, p), st, torch.exp(cum).reshape(b, s, h)


def models_dt_and_a(heads=None, seed=23, n=16, of_heads=50, shared=True):
    """x, dt, a, B, C (numpy, float32) at the serving width with dt and
    A as the model at init feeds them (dt = softplus(normal), A =
    -linspace(1, 16, of_heads)): B=1, S=256, P=64, N=16 (hymba's 50
    heads; mamba2-780m's are N=128 and 48 heads), B and C shared by the
    heads (or, without ``shared``, drawn per head); cum reaches about
    -1900 within a chunk of 128."""
    rng = np.random.default_rng(seed)
    b, s, p = 1, 256, 64
    a = -np.linspace(1.0, 16.0, of_heads).astype(np.float32)
    if heads is not None:
        a = a[heads]
    h = len(a)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0).astype(np.float32)
    if not shared:
        bm, cm = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(2))
        return x, dt, a, bm, cm
    b1, c1 = (rng.standard_normal((b, s, 1, n)).astype(np.float32) for _ in range(2))
    bm, cm = (np.ascontiguousarray(np.broadcast_to(t, (b, s, h, n))) for t in (b1, c1))
    return x, dt, a, bm, cm


@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_tensor_core_arithmetic_matches_reference_kernel(b, s, h, p, n, chunk):
    jx, tx = mk(s + 3 * h, b, s, h, p, n)
    want = jax_intra(*jx, chunk=chunk, interpret=True)
    for g, w in zip(emulate_tensor_core_kernel(*tx, chunk=chunk), want):
        close(g, w)


def test_tensor_core_arithmetic_on_the_models_dt_and_a():
    """A few heads of the serving shape (P=64, N=16, chunk 128) with dt
    and A as the model at init feeds them: cum reaches about -1900
    within a chunk. The kernel's arithmetic (seg from 16-row sub-blocks,
    three TF32 passes) is held to the float64 oracle and to the plain
    version at the unchanged atol."""
    arrs = models_dt_and_a(heads=[0, 16, 33, 49])
    tx = [torch.from_numpy(t) for t in arrs]
    chunk = 128
    oracle = oracle_intra_chunk(*tx, chunk=chunk)
    got = emulate_tensor_core_kernel(*tx, chunk=chunk)
    plain = ssd_intra_chunk_ref(*tx, chunk=chunk)
    assert float(oracle[0].abs().max()) > 20.0
    for g, w, pl in zip(got, oracle, plain):
        close(g, w.numpy())
        close(g, pl.numpy())


def test_cumsum_order_moves_y_on_the_models_dt_and_a():
    """Why the decays come from segment sums: on the model's inputs cum
    passes -1000 within a chunk, and with L = exp(cum_i - cum_j) two
    float32 cumsum orders (sequential, JAX's) move y by more than half
    the tolerance. With segment sums, two orders (the kernel's
    sub-blocks, the plain version's columns) move it by a small fraction
    of the three TF32 passes' own error."""
    arrs = models_dt_and_a(heads=[0, 16, 33, 49])
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in arrs)
    b, s, h, _ = x.shape
    chunk = 128
    steps = (dt.reshape(b, s // chunk, chunk, h) * a).permute(0, 1, 3, 2)
    cum_jax = torch.from_numpy(np.array(jnp.cumsum(
        jnp.asarray(steps.numpy()), axis=3)))
    cum_seq = torch.cumsum(steps, 3)
    assert float(cum_seq.min()) < -1000.0
    ii = torch.arange(chunk)
    tri = ii[:, None] >= ii[None, :]

    def ldec(seg):
        return torch.exp(torch.where(tri, seg, float("-inf"))).double()

    def diff(c):
        return c[..., :, None] - c[..., None, :]

    xdt = (x * dt[..., None]).double().reshape(b, s // chunk, chunk, h, -1)
    g = torch.einsum("bcihn,bcjhn->bchij",
                     *(t.double().reshape(b, s // chunk, chunk, h, -1) for t in (cm, bm)))

    def y_of(seg):
        return torch.einsum("bchij,bcjhp->bcihp", g * ldec(seg), xdt)

    cancelling = float((y_of(diff(cum_seq)) - y_of(diff(cum_jax))).abs().max())
    by_segments = float((y_of(kernel_segsum(steps))
                         - y_of(segsum(steps, 3))).abs().max())
    passes = float((emulate_tensor_core_kernel(x, dt, a, bm, cm, chunk=chunk)[0]
                    - oracle_intra_chunk(x, dt, a, bm, cm, chunk=chunk)[0]).abs().max())
    print(f"y moved by the cum order {cancelling:.3g}, by the segment-sum order "
          f"{by_segments:.3g}; three TF32 passes against the oracle {passes:.3g}")
    assert cancelling > ATOL / 2
    assert by_segments < passes / 5 and by_segments < ATOL / 20


def test_plain_version_meets_the_oracle_on_the_models_dt_and_a():
    """All 50 of hymba's heads at the serving width, the model's dt and
    A: the plain version's y, st and dec stay within atol of the float64
    oracle. JAX's kernel, which takes L = exp(cum_i - cum_j), is printed
    beside it: it misses atol on these inputs (a fault of the reference,
    which stays as it is)."""
    arrs = models_dt_and_a()
    tx = [torch.from_numpy(t) for t in arrs]
    oracle = oracle_intra_chunk(*tx, chunk=128)
    got = ssd_intra_chunk(*tx, chunk=128)
    errs = [float((g.double() - w).abs().max()) for g, w in zip(got, oracle)]
    want = jax_intra(*(jnp.asarray(t) for t in arrs), chunk=128, interpret=True)
    jax_err = float((torch.from_numpy(np.array(want[0])).double() - oracle[0]).abs().max())
    print(f"max |y - oracle|: plain {errs[0]:.3g}, JAX {jax_err:.3g} "
          f"(|y| up to {float(oracle[0].abs().max()):.1f}); st {errs[1]:.3g}, "
          f"dec {errs[2]:.3g}")
    assert float(oracle[0].abs().max()) > 50.0
    assert max(errs) <= ATOL


def test_one_tf32_pass_would_miss_the_tolerance():
    """Why three passes: hi.hi alone misses 2e-4 at the serving width."""
    jx, tx = mk(29, 1, 128, 2, 64, 16)
    want = torch.from_numpy(np.array(jax_intra(*jx, chunk=128, interpret=True)[0]))
    err = {passes: float((emulate_tensor_core_kernel(*tx, chunk=128, passes=passes)[0]
                          - want).abs().max()) for passes in (1, 3)}
    assert err[3] <= ATOL < err[1]


MAMBA2_HEADS = [0, 15, 31, 47]  # 4 of mamba2-780m's 48, A from -1 to -16


@pytest.mark.parametrize("seed,shared", [(23, True), (5, True), (23, False)])
def test_wide_kernel_arithmetic_on_mamba2s_dt_and_a(seed, shared):
    """mamba2-780m's state, head dim and chunk (N=128, P=64, chunk 128)
    with dt and A as the model at init feeds them, on 4 of its heads: the
    wide kernel's arithmetic (its segment sums, three TF32 passes, every
    product's 16 k-steps added in float32) against the float64 oracle and
    the plain version at the unchanged atol. With B and C shared by the
    heads, as the model passes them, the kernel computes C B^T once for
    its heads; given per head, once a head: the arithmetic is the same."""
    arrs = models_dt_and_a(heads=MAMBA2_HEADS, seed=seed, n=128, of_heads=48,
                           shared=shared)
    tx = [torch.from_numpy(t) for t in arrs]
    assert route(128, 128, 64) == "tensor_cores_wide"
    oracle = oracle_intra_chunk(*tx, chunk=128)
    got = emulate_tensor_core_kernel(*tx, chunk=128, wide=True)
    plain = ssd_intra_chunk_ref(*tx, chunk=128)
    errs = [float((g.double() - w).abs().max()) for g, w in zip(got, oracle)]
    print(f"wide kernel's arithmetic against the oracle: y {errs[0]:.3g}, st "
          f"{errs[1]:.3g}, dec {errs[2]:.3g} (|y| up to {float(oracle[0].abs().max()):.1f})")
    assert float(oracle[0].abs().max()) > 100.0
    for g, w, pl in zip(got, oracle, plain):
        close(g, w.numpy())
        close(g, pl.numpy())


def test_wide_kernel_sums_its_k_steps_in_float32():
    """The wide order (truncated passes, float32 sums of
    k-steps) moves y by less than half the tolerance from the N <= 32
    kernel's passes summed exactly, and one TF32 pass misses the
    tolerance at N=128 by far (a few hundred times), so the three stay."""
    arrs = models_dt_and_a(heads=MAMBA2_HEADS, seed=5, n=128, of_heads=48)
    tx = [torch.from_numpy(t) for t in arrs]
    oracle = oracle_intra_chunk(*tx, chunk=128)[0]
    wide = emulate_tensor_core_kernel(*tx, chunk=128, wide=True)[0]
    exact = emulate_tensor_core_kernel(*tx, chunk=128)[0]
    one = emulate_tensor_core_kernel(*tx, chunk=128, wide=True, passes=1)[0]
    moved = float((wide - exact).abs().max())
    one_err = float((one.double() - oracle).abs().max())
    print(f"float32 k-step sums move y by {moved:.3g}; one pass misses the "
          f"oracle by {one_err:.3g}")
    assert moved < ATOL / 2
    assert one_err > 100 * ATOL


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 128, 2, 64, 128, 128),
    (2, 96, 2, 32, 48, 48),    # a partial last slice of 32 state columns
    (1, 80, 3, 12, 36, 40),    # chunk not a multiple of 16
])
def test_wide_kernel_arithmetic_matches_reference_kernel(b, s, h, p, n, chunk):
    jx, tx = mk(s + 5 * h + n, b, s, h, p, n)
    assert route(chunk, n, p) == "tensor_cores_wide"
    want = jax_intra(*jx, chunk=chunk, interpret=True)
    for g, w in zip(emulate_tensor_core_kernel(*tx, chunk=chunk, wide=True), want):
        close(g, w)


def test_wide_kernel_lines_are_the_segment_sums():
    """The wide kernel's sub-block sums give the plain version's seg, cum
    and decays to the chunk's end to float32's rounding, at a chunk that
    is not a multiple of 16 too."""
    rng = np.random.default_rng(41)
    for cl in (128, 40):
        steps = torch.from_numpy(-rng.uniform(0.0, 16.0, (3, cl)).astype(np.float32))
        seg, cum, end = wide_kernel_lines(steps)
        want = segsum(steps.double(), 1)
        tri = torch.isfinite(want)
        assert torch.equal(torch.isfinite(seg), tri)
        torch.testing.assert_close(seg[tri].double(), want[tri], rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(cum.double(), torch.cumsum(steps.double(), 1),
                                   rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(end.double(), decay_to_end(steps.double(), 1),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("v,hi", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),        # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),        # below the tie rounds down
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),     # the odd tie also goes away
    (2.0 - 2.0**-12, 2.0),                   # carries into the exponent
    (3.0, 3.0),
])
def test_tf32_split_rounds_as_cvt_rna(v, hi):
    got_hi, got_lo = tf32_split(torch.tensor([v], dtype=torch.float32))
    assert float(got_hi) == hi
    assert int(got_hi.view(torch.int32)) & TF32_DROPPED == 0
    assert float(got_lo) == np.float32(v) - np.float32(hi)


def test_tf32_split_reconstructs_v():
    """hi + lo is v to float32's rounding (exactly, since lo = v - hi is
    exact); what the tensor core reads of them is v to 2^-21 of |v|."""
    rng = np.random.default_rng(31)
    v = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096), rng.standard_normal(1024) * 1e30,
        rng.standard_normal(1024) * 1e-30]).astype(np.float32))
    hi, lo = tf32_split(v)
    assert torch.equal(hi + lo, v)
    read = tensor_core_reads(hi).double() + tensor_core_reads(lo).double()
    assert torch.equal(tensor_core_reads(hi), hi)
    assert bool(((read - v.double()).abs() <= 2.0**-21 * v.double().abs()).all())


@pytest.mark.parametrize("chunk,n,p,want", [
    (128, 16, 64, "tensor_cores"),   # hymba-1.5b's serving shape
    (64, 16, 64, "tensor_cores"),
    (40, 12, 24, "tensor_cores"),
    (128, 32, 64, "tensor_cores"),
    (16, 4, 4, "tensor_cores"),
    (256, 16, 64, "cuda_cores"),     # chunk above 128
    (128, 16, 128, "cuda_cores"),    # P above 64
    (128, 64, 64, "tensor_cores_wide"),   # N above 32
    (128, 128, 64, "tensor_cores_wide"),  # mamba2-780m's state, N=128
    (128, 36, 64, "tensor_cores_wide"),
    (40, 44, 12, "tensor_cores_wide"),
    (128, 256, 64, "cuda_cores"),    # N above 128
    (128, 132, 64, "cuda_cores"),
    (256, 128, 64, "cuda_cores"),    # chunk above 128 at N=128
    (128, 128, 128, "cuda_cores"),   # P above 64 at N=128
    (128, 126, 64, "cuda_cores"),    # N not a multiple of 4
    (20, 6, 10, "cuda_cores"),       # P and N not multiples of 4
    (32, 16, 10, "cuda_cores"),
    (32, 6, 16, "cuda_cores"),
])
def test_route_by_shape(chunk, n, p, want):
    assert route(chunk, n, p) == want


def test_every_tensor_core_shape_fits_a_block():
    """The wrapper's count of the kernel's shared memory: 115,584 B at the
    serving shape, so two CTAs share an H100 SM (233,472 B, 1,024 B of it
    reserved a CTA), at most 148,352 B, below an H100 block's 232,448."""
    assert sm90_smem_bytes(128, 16, 64) == 115_584
    assert 2 * (sm90_smem_bytes(128, 16, 64) + 1024) <= 233_472
    assert max(sm90_smem_bytes(c, n, p) for c in range(1, 129)
               for n in range(4, 33, 4) for p in range(4, 65, 4)) == 148_352


def test_every_wide_shape_fits_a_block():
    """The wrapper's count of the wide kernel's shared memory: 218,176 B at
    mamba2-780m's shape (chunk 128, N=128, P=64), the most of any shape
    it takes, below an H100 block's 232,448 B; one CTA an SM (two would
    need 233,472 B and more)."""
    assert wide_smem_bytes(128, 128, 64) == 218_176
    sizes = [wide_smem_bytes(c, n, p) for c in range(1, 129)
             for n in range(36, 129, 4) for p in range(4, 65, 4)]
    assert max(sizes) == 218_176 <= 232_448
    assert 2 * (218_176 + 1024) > 233_472
    # B whole, two C slices, two x stages and dt, G's 36 blocks, the lines
    floats = (128 * 132 + 2 * 128 * 36 + 2 * 128 * 68 + 2 * 128 + 36 * 256
              + 3 * 128 + 64 + 16 + 8 * 136)
    assert wide_smem_bytes(128, 128, 64) == 4 * floats
    # N pads to a slice of 32: N = 100 takes what N = 128 does
    assert wide_smem_bytes(128, 100, 64) == wide_smem_bytes(128, 128, 64)


def _serving_operands():
    rng = np.random.default_rng(37)
    x = torch.from_numpy(rng.standard_normal((2, 128, 3, 64)).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (2, 128, 3)).astype(np.float32))
    a = torch.from_numpy(-rng.uniform(0.5, 2.0, (3,)).astype(np.float32))
    bm, cm = (torch.from_numpy(rng.standard_normal((2, 128, 1, 16)).astype(np.float32))
              .expand(2, 128, 3, 16) for _ in range(2))
    return dict(x=x, dt=dt, a=a, bmat=bm, cmat=cm)


def test_operands_as_the_model_passes_them_are_accepted():
    ops = _serving_operands()
    assert ops["bmat"].stride(2) == 0
    check_operands("tensor_cores", **ops)
    check_operands("cuda_cores", **ops)


@pytest.mark.parametrize("bad,match", [
    (None, None),
    ("misaligned_row", "stride 130 of dim 1 is 520 bytes, not a multiple of 16"),
    ("misaligned_base", "base pointer .* not 16-byte aligned"),
    ("last_dim", "the last dim of bmat must be contiguous"),
    ("dtype", "cmat has dtype torch.float64"),
])
def test_the_wide_route_checks_operands_as_the_other(bad, match):
    """mamba2-780m's operands (N=128, B and C stride-0 over the heads)
    pass the wide route's checks; what its 16-byte copies cannot take is
    refused as on the other tensor-core route."""
    ops = _serving_operands()
    bm = torch.zeros((2, 128, 128))
    if bad == "misaligned_row":      # rows of 130 floats, 520 bytes apart
        bm = torch.zeros((2, 128, 130))[:, :, :128]
    elif bad == "misaligned_base":
        bm = torch.zeros(bm.numel() + 1)[1:].view(bm.shape)
    elif bad == "last_dim":
        bm = bm.transpose(1, 2).contiguous().transpose(1, 2)
    ops["bmat"] = bm[:, :, None, :].expand(2, 128, 3, 128)
    ops["cmat"] = torch.zeros((2, 128, 3, 128), dtype=torch.float64 if bad == "dtype"
                              else torch.float32)
    assert route(128, 128, 64) == "tensor_cores_wide"
    if bad is None:
        check_operands("tensor_cores_wide", **ops)
        return
    with pytest.raises(TypeError if bad == "dtype" else ValueError, match=match):
        check_operands("tensor_cores_wide", **ops)


@pytest.mark.parametrize("bad,match", [
    ("misaligned_row", "stride 66 of dim 1 is 264 bytes, not a multiple of 16"),
    ("misaligned_base", "base pointer .* not 16-byte aligned"),
    ("last_dim", "the last dim of x must be contiguous"),
])
def test_wrapper_refuses_what_the_copies_cannot_take(bad, match):
    ops = _serving_operands()
    x = ops["x"]
    if bad == "misaligned_row":      # rows of 66 floats, 264 bytes apart
        x = torch.zeros((2, 128, 66))[:, :, None, :64].expand(2, 128, 3, 64)
    elif bad == "misaligned_base":   # one float into its storage
        x = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    else:                            # p not the contiguous dim
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    ops["x"] = x
    with pytest.raises(ValueError, match=match):
        check_operands("tensor_cores", **ops)
    if bad != "last_dim":            # the CUDA-core kernel reads any stride
        check_operands("cuda_cores", **ops)


def test_wrapper_refuses_a_dtype_it_does_not_take():
    ops = _serving_operands()
    ops["dt"] = ops["dt"].double()
    with pytest.raises(TypeError, match="dt has dtype torch.float64"):
        check_operands("tensor_cores", **ops)
