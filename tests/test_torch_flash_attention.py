"""The port's attention against the reference's flash attention.

On this CPU the wrapper ``flash_attention`` runs its plain version
(``attention_ref``); the CUDA kernel is held against that plain version
on the card by ``chip_smoke.py``. Inputs come from numpy seeds and reach
both frameworks as the same arrays (bf16 inputs are rounded from the
same float32 values on both sides). Tolerances are those of
``tests/test_flash_attention.py``: 2e-5 in float32, 3e-2 in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention as jax_flash)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_chunked as jax_chunked, attention_ref as jax_ref)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS, TENSOR_CORE_HEAD_DIMS, flash_attention, route, tma_check)
from repro_torch.kernels.flash_attention.ops import mha  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_chunked, attention_ref)

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def mk(seed, b, hq, hkv, s, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=0)


# -- against the reference's Pallas kernel (interpret mode) --------------------

@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk,causal,window,dtype", [
    # the parameter sets of tests/test_flash_attention.py
    (2, 4, 2, 64, 32, 32, 32, True, None, "float32"),
    (1, 8, 1, 128, 64, 64, 32, True, None, "float32"),
    (2, 4, 4, 64, 32, 16, 64, True, None, "float32"),
    (1, 2, 2, 96, 16, 32, 32, True, None, "float32"),
    (1, 4, 2, 64, 32, 32, 32, True, None, "bfloat16"),
    (1, 4, 2, 128, 32, 32, 32, True, 16, "float32"),
    (1, 4, 2, 128, 32, 32, 32, True, 48, "float32"),
    (1, 4, 2, 128, 32, 32, 32, True, 128, "float32"),
    (1, 2, 2, 64, 32, 32, 32, False, None, "float32"),
    # hymba's grouping (group 5) with a window, both dtypes
    (1, 10, 2, 64, 64, 32, 32, True, 48, "float32"),
    (1, 10, 2, 64, 64, 32, 32, True, 48, "bfloat16"),
])
def test_plain_version_matches_reference_kernel(b, hq, hkv, s, d, bq, bk,
                                                causal, window, dtype):
    jx, tx = mk(s + d + hq, b, hq, hkv, s, d, dtype)
    want = jax_flash(*jx, causal=causal, window=window, block_q=bq,
                     block_k=bk, interpret=True)
    got = flash_attention(*tx, causal=causal, window=window)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    close(got, want, dtype)


@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [192, 256])
def test_head_dims_192_and_256_match_reference_kernel(d, dtype, window):
    """nemotron's and paligemma's head dims, one kv head for two query
    heads, two kv blocks."""
    jx, tx = mk(d + 1, 1, 2, 1, 128, d, dtype)
    want = jax_flash(*jx, causal=True, window=window, block_q=64, block_k=64,
                     interpret=True)
    got = flash_attention(*tx, causal=True, window=window)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    close(got, want, dtype)
    close(got, jax_ref(*jx, causal=True, window=window), dtype)


# -- against the reference's dense oracle: shapes the Pallas kernel refuses ----

@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window,dtype", [
    (1, 10, 2, 37, 16, True, None, "float32"),    # ragged S, group 5
    (2, 25, 5, 50, 64, True, 16, "bfloat16"),     # hymba heads, window
    (1, 4, 2, 77, 32, True, 300, "float32"),      # window larger than S
    (1, 4, 4, 45, 32, False, None, "float32"),    # non-causal, group 1
    (1, 4, 2, 45, 32, False, 8, "float32"),       # non-causal window
    (1, 6, 3, 1, 16, True, None, "bfloat16"),     # a single position
])
def test_plain_version_matches_reference_oracle(b, hq, hkv, s, d, causal,
                                                window, dtype):
    jx, tx = mk(s * 7 + d, b, hq, hkv, s, d, dtype)
    want = jax_ref(*jx, causal=causal, window=window)
    close(attention_ref(*tx, causal=causal, window=window), want, dtype)
    close(mha(*tx, causal=causal, window=window), want, dtype)


@pytest.mark.parametrize("window", [None, 100])
def test_chunked_matches_reference(window):
    jx, tx = mk(3, 2, 4, 2, 256, 32)
    want = jax_chunked(*jx, causal=True, window=window, q_chunk=64)
    close(attention_chunked(*tx, causal=True, window=window, q_chunk=64),
          want, "float32")
    close(attention_chunked(*tx, causal=True, window=window, q_chunk=64),
          jax_ref(*jx, causal=True, window=window), "float32")


def test_strided_views_give_the_same_result():
    """The model hands (B, S, H, D) projections over as transposed views."""
    _, (q, k, v) = mk(5, 2, 6, 3, 40, 16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views, window=9),
                               flash_attention(q, k, v, window=9), rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    _, tx = mk(7, 1, 4, 2, 33, 16)
    before = flash_attention.launches
    out = mha(*tx, causal=True, window=None)
    torch.testing.assert_close(out, attention_ref(*tx), rtol=0, atol=0)
    assert flash_attention.launches == before == 0
    assert sum(flash_attention.launches_by_route.values()) == 0


@pytest.mark.parametrize("bad", ["heads", "dtype", "window"])
def test_wrapper_refuses_malformed_inputs(bad):
    _, (q, k, v) = mk(9, 1, 4, 2, 16, 16)
    kwargs = {}
    if bad == "heads":
        q = q[:, :3]
    elif bad == "dtype":
        k = k.double()
    else:
        kwargs["window"] = 0
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, **kwargs)


# -- routing on the card, and TMA's preconditions (no card needed) -------------

@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.bfloat16, 16, "cuda_cores"),
    (torch.bfloat16, 32, "cuda_cores"),
    (torch.float32, 16, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"),
    (torch.float32, 128, "cuda_cores"),
    (torch.bfloat16, 192, "tensor_cores"),
    (torch.bfloat16, 256, "tensor_cores"),
    (torch.float32, 192, "cuda_cores"),
    (torch.float32, 256, "cuda_cores"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert route(dtype, d) == want


@pytest.mark.parametrize("d", [8, 48, 96, 320])
def test_route_refuses_head_dims_no_kernel_takes(d):
    """The kernels take (16, 32, 64, 128, 192, 256), the tensor cores
    the four from 64 up; any other D raises, on either dtype."""
    assert HEAD_DIMS == (16, 32, 64, 128, 192, 256)
    assert TENSOR_CORE_HEAD_DIMS == (64, 128, 192, 256)
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=f"head dim {d} not supported"):
            route(dtype, d)


@pytest.mark.parametrize("shape,strides,ptr", [
    # the model's (B, S, H, D) projection seen as (B, H, S, D)
    ((4, 25, 512, 64), (512 * 25 * 64, 64, 25 * 64, 1), 0x7f0000000000),
    ((1, 5, 300, 128), (7, 128, 5 * 128, 1), 0x7f0000000010),  # B=1: stride unused
    ((2, 1, 64, 64), (64 * 64, 3, 64, 1), 0x100),               # H=1: stride unused
])
def test_tma_check_accepts_aligned_inputs(shape, strides, ptr):
    tma_check("q", shape, strides, ptr, 2)


@pytest.mark.parametrize("shape,strides,ptr,match", [
    ((4, 25, 512, 64), (512 * 25 * 64, 64, 25 * 64, 1), 0x7f0000000008,
     "base pointer .* not 16-byte aligned"),
    ((4, 25, 512, 64), (512 * 25 * 64, 64, 25 * 64 + 4, 1), 0x7f0000000000,
     "stride 1604 of dim 2 is 3208 bytes, not a multiple of 16"),
    ((2, 4, 64, 64), (4 * 64 * 68 + 2, 64 * 68, 68, 1), 0x100,
     "stride 17410 of dim 0"),
])
def test_tma_check_refuses_misaligned_inputs(shape, strides, ptr, match):
    with pytest.raises(ValueError, match=match):
        tma_check("q", shape, strides, ptr, 2)


# -- the tensor-core kernel's rounding budget -----------------------------------

def emulate_tensor_core_kernel(q, k, v, *, causal, window, bk=64):
    """The arithmetic of ``csrc/flash_fwd_sm90.cu`` in float32 on the CPU:
    per kv tile of ``bk`` keys, float32 scores from bf16 q and k in log2
    units (scale * log2(e) in one multiply), masked ones -1e30 with
    weight 0, the online softmax with float32 (m, l, acc), and P rounded
    to bf16 before P.V with float32 accumulation; the output rounded to
    bf16."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scale_log2 = d ** -0.5 * 1.4426950408889634
    m = torch.full((b, hq, s), -1e30)
    l = torch.zeros((b, hq, s))
    acc = torch.zeros((b, hq, s, d))
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kpos = torch.arange(k0, min(k0 + bk, s))[None, :]
        keep = torch.ones((s, kpos.shape[1]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bk])
        t = torch.where(keep, x * scale_log2, -1e30)
        m_cur = torch.maximum(m, t.amax(dim=-1))
        corr = torch.exp2(m - m_cur)
        p = torch.where(keep, torch.exp2(t - m_cur[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(), vf[:, :, k0:k0 + bk])
        m = m_cur
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bk,causal,window", [
    # the bf16 parameter sets above
    (1, 4, 2, 64, 32, 32, 32, True, None),
    (1, 10, 2, 64, 64, 32, 32, True, 48),
    # the kernel's other head dim, several kv tiles, a window and no mask
    (1, 4, 2, 192, 128, 64, 64, True, 80),
    (1, 4, 4, 128, 64, 64, 64, False, None),
    # the head dims of nemotron (192) and paligemma (256, one kv head)
    (1, 2, 1, 128, 192, 64, 64, True, None),
    (1, 2, 1, 128, 256, 64, 64, True, 48),
])
def test_rounding_p_to_bf16_fits_the_bf16_tolerance(b, hq, hkv, s, d, bq, bk,
                                                    causal, window):
    jx, tx = mk(s + d + hq, b, hq, hkv, s, d, "bfloat16")
    want = jax_flash(*jx, causal=causal, window=window, block_q=bq,
                     block_k=bk, interpret=True)
    got = emulate_tensor_core_kernel(*tx, causal=causal, window=window)
    close(got, want, "bfloat16")


def test_rounding_budget_at_hymbas_heads_against_the_oracle():
    jx, tx = mk(11, 2, 25, 5, 150, 64, "bfloat16")
    want = jax_ref(*jx, causal=True, window=100)
    close(emulate_tensor_core_kernel(*tx, causal=True, window=100), want,
          "bfloat16")
