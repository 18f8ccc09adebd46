"""The port's LM training path (hymba at smoke size) against the
reference: the loss and its gradients, AdamW, the synthetic LM stream,
the train step and the loop, with the reference's weights and state
carried across by ``models/convert.py``. The reference runs with its
defaults (``use_kernels=False``): its trainer differentiates the plain
attention and chunked SSD, as the port's backward does.

Tolerances: float32, 1e-5 on the loss and 1e-4 of each leaf's largest
magnitude on gradients and trained parameters (measured: loss bitwise,
gradients within 3.6e-6, parameters after 4 steps within 5.2e-6). In
bf16 the port is held to the reference's op-by-op layer loop
(``scan_layers=False``; compiled under ``lax.scan`` XLA rounds bf16
chains elsewhere, see tests/test_torch_lm.py): 1e-2 on a loss of about
32, and 5e-2 of each leaf's largest magnitude on the gradients
(measured 1.1e-3 and 1.9e-2). AdamW: moments and float32 parameters
within 1e-6 relative; a bf16 parameter within one bf16 ulp.
"""

import dataclasses
import functools
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import lm_data as JD  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models.config import LMConfig as JaxLMConfig  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_data as TD  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn, mha  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd.ops import SSDIntraChunkFn, ssd  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_intra_chunk_ref  # noqa: E402
from repro_torch.models import blocks as BLK  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.config import LMConfig  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    lm_params_from_numpy, train_state_from_numpy)
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402

ARCH = "hymba-1.5b"
B, S = 2, 64  # two loss chunks of 32, eight SSD chunks, window 16 < S
CPU = torch.device("cpu")
F32_LOSS_ATOL, F32_LEAF_REL = 1e-5, 1e-4
BF16_LOSS_ATOL, BF16_LEAF_REL = 1e-2, 5e-2

# the reference's tests/test_train_infra.py config, a dense block
SMALL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=1,
             head_dim=16, d_ff=64, vocab_size=64, loss_chunk=16)


def configs(dtype="float32", **kw):
    jc = dataclasses.replace(jax_config(ARCH, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **kw)
    tc = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **kw)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, scan_layers=False)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jit_init(jc):
    return jax.jit(lambda k: JLM.init_lm(k, jc)[0])


def batch(vocab, seed=5, step=0, b=B, s=S):
    return JD.SyntheticLMStream(vocab, b, s, seed=seed).batch(step)


def as_jax(bt):
    return {k: jnp.asarray(v) for k, v in bt.items()}


def flat_leaves(tree, prefix=""):
    """{dotted name: float32 numpy} of a reference tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def reference_leaf(flat, name):
    """The reference's leaf for the port's parameter ``name``: block
    leaves are stacked on a leading layer axis."""
    if name.startswith("blocks."):
        _, i, rest = name.split(".", 2)
        return flat["blocks." + rest][int(i)]
    return flat[name]


def port_names(flat):
    """The port's parameter names of a reference tree's leaves."""
    out = set()
    for name, a in flat.items():
        if name.startswith("blocks."):
            out |= {f"blocks.{i}.{name[7:]}" for i in range(a.shape[0])}
        else:
            out.add(name)
    return out


def assert_leaves_close(got: dict, want_tree, rel: float):
    flat = flat_leaves(want_tree)
    assert got and set(got) == port_names(flat)
    for name, t in got.items():
        want = reference_leaf(flat, name)
        g = t.detach().float().numpy()
        assert g.shape == want.shape, name
        err = np.abs(g - want).max()
        assert err <= rel * np.abs(want).max(), (name, err, np.abs(want).max())


def port_loss_and_grads(model, bt):
    params = dict(model.named_parameters())
    loss = TLM.lm_loss(model, *(torch.from_numpy(bt[k])
                                for k in ("tokens", "targets", "mask")))
    return loss.detach(), dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def reference_loss_and_grads(jc, params, bt):
    fn = jax.jit(jax.value_and_grad(lambda p, b: JLM.lm_loss(
        p, jc, b["tokens"], b["targets"], b["mask"])))
    return fn(params, as_jax(bt))


# -- the loss and its gradients ------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference_f32(remat):
    jc, tc = configs(remat=remat)
    params = _jit_init(jc)(jax.random.key(3))
    bt = batch(jc.vocab_size)
    jl, jg = reference_loss_and_grads(jc, params, bt)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    model.requires_grad_(True)
    loss, grads = port_loss_and_grads(model, bt)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=F32_LOSS_ATOL)
    assert_leaves_close(grads, jg, F32_LEAF_REL)


def test_bf16_loss_and_gradients_match_the_reference():
    jc, tc = configs("bfloat16")
    params = _jit_init(jc)(jax.random.key(3))
    bt = batch(jc.vocab_size)
    jl, jg = reference_loss_and_grads(jc, params, bt)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    model.requires_grad_(True)
    loss, grads = port_loss_and_grads(model, bt)
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=BF16_LOSS_ATOL)
    assert all(g.dtype == torch.bfloat16 for n, g in grads.items()
               if n.split(".")[-1] not in ("a_log", "dt_bias", "d_skip"))
    assert_leaves_close(grads, jg, BF16_LEAF_REL)


def test_remat_changes_no_value_and_recomputes_the_blocks(monkeypatch):
    """remat on and off give the same loss and gradients (bitwise on the
    CPU); with it on, each block's forward runs again in the backward."""
    _, tc = configs()
    bt = batch(tc.vocab_size, seed=6)
    calls = []
    block_train = BLK.block_train
    monkeypatch.setattr(BLK, "block_train",
                        lambda *a: calls.append(1) or block_train(*a))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        model = TLM.CausalLM(cfg, torch.Generator().manual_seed(4)).requires_grad_(True)
        calls.clear()
        loss, grads = port_loss_and_grads(model, bt)
        out[remat] = (loss, grads, len(calls))
    assert out[True][2] == 2 * tc.num_layers and out[False][2] == tc.num_layers
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], rtol=0, atol=0)


def test_loss_chunks_divide_the_sequence_as_the_reference():
    assert TLM._largest_divisor_leq(64, 32) == JLM._largest_divisor_leq(64, 32) == 32
    assert TLM._largest_divisor_leq(60, 32) == JLM._largest_divisor_leq(60, 32) == 30
    assert TLM._largest_divisor_leq(7, 32) == 7
    assert TLM._largest_divisor_leq(31, 8) == JLM._largest_divisor_leq(31, 8) == 1


def test_masked_positions_leave_the_loss():
    """A masked position changes neither the loss nor the count, as in
    the reference (one loss chunk and several)."""
    jc, tc = configs()
    params = _jit_init(jc)(jax.random.key(3))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    bt = batch(jc.vocab_size, seed=8)
    bt["mask"] = bt["mask"].copy()
    bt["mask"][0, 40:] = False
    bt["mask"][1, :3] = False
    with torch.no_grad():
        got = TLM.lm_loss(model, *(torch.from_numpy(bt[k])
                                   for k in ("tokens", "targets", "mask")))
    want = JLM.lm_loss(params, jc, *(jnp.asarray(bt[k])
                                     for k in ("tokens", "targets", "mask")))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=F32_LOSS_ATOL)


# -- the backward Functions -------------------------------------------------------

def _grads(out, ins, g):
    return torch.autograd.grad(out, ins, g)


@pytest.mark.parametrize("window", [None, 9])
def test_flash_attention_fn_backward_equals_plain_autograd(window):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .requires_grad_(True)
               for shape in ((2, 6, 33, 16), (2, 3, 33, 16), (2, 3, 33, 16)))
    g = torch.from_numpy(rng.standard_normal((2, 6, 33, 16)).astype(np.float32))
    out = FlashAttentionFn.apply(q, k, v, True, window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for a, b in zip(_grads(out, (q, k, v), g), _grads(want, (q, k, v), g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("window", [None, 40])
def test_flash_attention_fn_backward_at_head_dim_256(window):
    """paligemma's head dim and one kv head: the Function's forward and
    input gradients equal plain autograd."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .requires_grad_(True)
               for shape in ((1, 4, 70, 256), (1, 1, 70, 256), (1, 1, 70, 256)))
    g = torch.from_numpy(rng.standard_normal((1, 4, 70, 256)).astype(np.float32))
    out = FlashAttentionFn.apply(q, k, v, True, window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for a, b in zip(_grads(out, (q, k, v), g), _grads(want, (q, k, v), g)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_mha_takes_the_function_only_when_a_gradient_is_needed():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(np.float32))
               for _ in range(3))
    assert mha(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    assert type(mha(qg, k, v).grad_fn).__name__ == "FlashAttentionFnBackward"
    with torch.no_grad():
        torch.testing.assert_close(mha(qg, k, v), mha(q, k, v), rtol=0, atol=0)


def ssd_inputs(rng, b, s, h, p, n, model=False):
    """x, dt, a and B, C shared by the heads (stride-0 views, as the
    model passes them). ``model``: dt and A as the model at init feeds
    them (dt = softplus of N(0, 1) plus a zero bias, A = -exp(log(1..16)))."""
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    if model:
        dt = torch.nn.functional.softplus(torch.from_numpy(
            rng.standard_normal((b, s, h)).astype(np.float32)))
        a = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h)))
    else:
        dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
        a = -torch.from_numpy(rng.uniform(0.5, 2.0, h).astype(np.float32))
    bc = [torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
          .requires_grad_(True) for _ in range(2)]
    leaves = [x.requires_grad_(True), dt.requires_grad_(True),
              a.requires_grad_(True), *bc]
    views = [t[:, :, None, :].expand(b, s, h, n) for t in bc]
    return leaves, (x, dt, a, *views)


def test_ssd_intra_chunk_fn_backward_equals_plain_autograd():
    rng = np.random.default_rng(2)
    leaves, args = ssd_inputs(rng, 2, 32, 3, 8, 4)
    outs = SSDIntraChunkFn.apply(*args, 8)
    want = ssd_intra_chunk_ref(*args, chunk=8)
    gs = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
          for o in want]
    for o, w in zip(outs, want):
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    got = torch.autograd.grad(outs, leaves, gs)
    ref = torch.autograd.grad(want, leaves, gs)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # only some outputs used: the unused ones' gradients are None
    got = torch.autograd.grad(SSDIntraChunkFn.apply(*args, 8)[0], leaves, gs[0])
    ref = torch.autograd.grad(ssd_intra_chunk_ref(*args, chunk=8)[0], leaves, gs[0])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("s,chunk,lowest", [(64, 8, -50), (256, 128, -1000)])
def test_ssd_gradients_are_finite_on_the_models_dt_and_a(s, chunk, lowest):
    """On the model's dt and A a chunk's decays reach exp(``lowest``)
    and below: masked before the exp (segment sums, -inf above the
    diagonal), every gradient stays finite, and the chunked SSD
    through the Function differentiates as the plain chunked SSD."""
    rng = np.random.default_rng(3)
    leaves, args = ssd_inputs(rng, 2, s, 16, 8, 4, model=True)
    with torch.no_grad():
        steps = (args[1] * args[2]).unflatten(1, (s // chunk, chunk))
        assert float(steps.sum(2).min()) < lowest
    y, hf = ssd(*args, chunk=chunk)
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal(hf.shape).astype(np.float32))
    got = torch.autograd.grad((y, hf), leaves, (gy, gh))
    yw, hw = ssd_chunked(*args, chunk=chunk)
    torch.testing.assert_close(y, yw, rtol=0, atol=1e-5)
    want = torch.autograd.grad((yw, hw), leaves, (gy, gh))
    for name, a, b in zip(("x", "dt", "a", "B", "C"), got, want):
        assert torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * max(scale, 1.0), name


# -- AdamW ----------------------------------------------------------------------------

def adam_trees(rng):
    """Grads, moments and params: float32 leaves and one bf16 parameter
    (whose moments stay float32), grads large enough to be clipped."""
    shapes = {"a": (37, 5), "b": (64,), "c": (3, 4, 5)}
    mk = lambda sh, sc=1.0: (rng.standard_normal(sh) * sc).astype(np.float32)  # noqa: E731
    grads = {k: mk(sh, 3.0) for k, sh in shapes.items()}
    mu = {k: mk(sh, 0.1) for k, sh in shapes.items()}
    nu = {k: np.abs(mk(sh, 0.1)) for k, sh in shapes.items()}
    params = {k: mk(sh) for k, sh in shapes.items()}
    return grads, mu, nu, params


@pytest.mark.parametrize("step", [0, 3, 250])
def test_adamw_update_matches_the_reference(step):
    rng = np.random.default_rng(step)
    grads, mu, nu, params = adam_trees(rng)
    cfg = dict(lr=1e-2, warmup=10, weight_decay=0.1, clip_norm=1.0)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "c" else jnp.float32)
          for k, v in params.items()}
    jmu, jnu, jparams, jn = JO.adamw_update(
        JO.AdamWConfig(**cfg), {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in mu.items()},
        {k: jnp.asarray(v) for k, v in nu.items()}, jp, jnp.asarray(step, jnp.int32))
    assert float(jn) > cfg["clip_norm"]  # the clip is exercised
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "c" else torch.float32)
          for k, v in params.items()}
    tmu = {k: torch.from_numpy(v.copy()) for k, v in mu.items()}
    tnu = {k: torch.from_numpy(v.copy()) for k, v in nu.items()}
    tn = TO.adamw_update(TO.AdamWConfig(**cfg),
                         {k: torch.from_numpy(v) for k, v in grads.items()},
                         tmu, tnu, tp, step)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(tmu[k].numpy(), np.asarray(jmu[k]), rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(tnu[k].numpy(), np.asarray(jnu[k]), rtol=1e-6, atol=1e-12)
        want = np.asarray(jparams[k], np.float32)
        got = tp[k].float().numpy()
        assert tp[k].dtype == (torch.bfloat16 if k == "c" else torch.float32)
        if k == "c":  # one bf16 ulp (8 bits of mantissa)
            assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_keeps_parameters_where_not_ok_and_still_moves_the_moments():
    rng = np.random.default_rng(9)
    grads, mu, nu, params = adam_trees(rng)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tmu = {k: torch.from_numpy(v.copy()) for k, v in mu.items()}
    tnu = {k: torch.from_numpy(v.copy()) for k, v in nu.items()}
    zeros = {k: torch.zeros_like(torch.from_numpy(v)) for k, v in grads.items()}
    TO.adamw_update(TO.AdamWConfig(), zeros, tmu, tnu, tp, 0, torch.tensor(False))
    for k in params:
        np.testing.assert_array_equal(tp[k].numpy(), params[k])
        np.testing.assert_allclose(tmu[k].numpy(), 0.9 * mu[k], rtol=1e-6)


def test_global_norm_and_lr_schedule():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0], dtype=torch.bfloat16)}
    assert abs(float(TO.global_norm(t)) - 5.0) < 1e-6
    cfg = TO.AdamWConfig(lr=1e-3, warmup=20)
    for step in (0, 5, 19, 20, 400):
        got = float(TO.lr_schedule(cfg, step))
        want = float(JO.lr_schedule(JO.AdamWConfig(lr=1e-3, warmup=20),
                                    jnp.asarray(step, jnp.int32)))
        assert got == want


# -- the synthetic LM stream -------------------------------------------------------------

@pytest.mark.parametrize("seed,prefix", [(0, 0), (7, 3)])
def test_batches_are_bitwise_the_reference(seed, prefix):
    kw = dict(seed=seed, prefix_len=prefix, d_model=8)
    ours = TD.SyntheticLMStream(50, 3, 17, **kw)
    theirs = JD.SyntheticLMStream(50, 3, 17, **kw)
    for step in (0, 1, 5, 123):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    got = [b["tokens"] for b in TD.batches(ours, 3, start=4)]
    want = [b["tokens"] for b in JD.batches(theirs, 3, start=4)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- the train step and the loop -------------------------------------------------------------

def test_train_steps_match_the_reference_trainer():
    """Four steps of ``make_train_step`` from the reference's own initial
    state: each step's loss and grad norm, and the trained parameters
    and moments."""
    jc, tc = configs()
    opt = dict(lr=1e-3, warmup=20)
    js = JT.init_train_state(jax.random.key(2), jc)
    ts = train_state_from_numpy(*(jax.tree.map(np.asarray, t)
                                  for t in (js.params, js.mu, js.nu)),
                                int(js.step), tc, device="cpu")
    jstep = jax.jit(JT.make_train_step(jc, JO.AdamWConfig(**opt)))
    tstep = TT.make_train_step(tc, TO.AdamWConfig(**opt))
    stream = TD.SyntheticLMStream(tc.vocab_size, B, S, seed=5)
    for i in range(4):
        bt = stream.batch(i)
        js, jm = jstep(js, as_jax(bt))
        ts, tm = tstep(ts, TT.batch_tensors(bt, CPU))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=F32_LOSS_ATOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
        assert int(tm["skipped"]) == int(jm["skipped"]) == 0
    assert ts.step == int(js.step) == 4
    assert_leaves_close(ts.params, js.params, F32_LEAF_REL)
    assert_leaves_close(ts.mu, js.mu, F32_LEAF_REL)
    assert_leaves_close(ts.nu, js.nu, F32_LEAF_REL)


def small_cfg():
    return LMConfig(**SMALL)


def test_small_config_is_the_references():
    jc, tc = JaxLMConfig(**SMALL), small_cfg()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name


def test_loss_decreases_on_learnable_data():
    cfg = small_cfg()
    stream = TD.SyntheticLMStream(cfg.vocab_size, 8, 32, seed=1)
    step = TT.make_train_step(cfg, TO.AdamWConfig(lr=3e-3, warmup=5))
    state = TT.init_train_state(0, cfg, CPU)
    losses = []
    for i in range(40):
        state, m = step(state, TT.batch_tensors(stream.batch(i), CPU))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[::8]


def test_bigram_learning_beats_unigram_entropy():
    """End-to-end: the model learns the planted bigram structure."""
    cfg = small_cfg()
    stream = TD.SyntheticLMStream(cfg.vocab_size, 8, 32, seed=4)
    step = TT.make_train_step(cfg, TO.AdamWConfig(lr=3e-3, warmup=5))
    state = TT.init_train_state(1, cfg, CPU)
    losses = []
    for i in range(120):
        state, m = step(state, TT.batch_tensors(stream.batch(i), CPU))
        losses.append(float(m["loss"]))
    final = float(np.mean(losses[-10:]))
    h_unigram = -np.sum(stream.p * np.log(stream.p))
    assert final < h_unigram, (final, h_unigram)


def test_nan_batch_skipped_not_poisoning():
    cfg = small_cfg()
    step = TT.make_train_step(cfg, TO.AdamWConfig(lr=1e-3))
    state = TT.init_train_state(0, cfg, CPU)
    with torch.no_grad():  # an inf scale makes the loss non-finite
        state.model.final_norm.scale.mul_(float("inf"))
    before = {k: p.detach().clone() for k, p in state.params.items()}
    mu_before = {k: m.clone() for k, m in state.mu.items()}
    stream = TD.SyntheticLMStream(cfg.vocab_size, 4, 16, seed=2)
    new, m = step(state, TT.batch_tensors(stream.batch(0), CPU))
    assert int(m["skipped"]) == 1 and new.step == 1
    assert not np.isfinite(float(m["loss"]))
    for k, p in new.params.items():
        a, c = p.detach().numpy(), before[k].numpy()
        assert ((a == c) | (np.isnan(a) & np.isnan(c))).all(), k
    for k, mm in new.mu.items():  # zeroed gradients: the moments only decay
        assert torch.isfinite(mm).all()
        torch.testing.assert_close(mm, 0.9 * mu_before[k], rtol=0, atol=0)


def run_trainer(cfg, opt, d, steps, start_seed=0, every=5, log_every=1):
    tr = TT.Trainer(cfg, opt, TT.make_train_step(cfg, opt), checkpoint_dir=d,
                    checkpoint_every=every, device="cpu")
    state = tr.restore_or_init(start_seed)
    stream = TD.SyntheticLMStream(cfg.vocab_size, 4, 16, seed=0)
    data = (TT.batch_tensors(b, CPU)
            for b in TD.batches(stream, steps, start=state.step))
    return tr.run(state, data, log_every=log_every)


def test_trainer_resume_from_checkpoint():
    cfg, opt = small_cfg(), TO.AdamWConfig(lr=1e-3)
    with tempfile.TemporaryDirectory() as d:
        state, hist = run_trainer(cfg, opt, d, 10, log_every=5)
        assert CKPT.latest_step(d) == 10 and CKPT.all_steps(d) == [5, 10]
        assert [h["step"] for h in hist] == [1, 6]
        resumed = TT.Trainer(cfg, opt, None, checkpoint_dir=d,
                             device="cpu").restore_or_init(0)
        assert resumed.step == 10
        for k, p in resumed.params.items():
            assert p.requires_grad and p.dtype == state.params[k].dtype
            torch.testing.assert_close(p, state.params[k], rtol=0, atol=0)
        for k in state.mu:
            torch.testing.assert_close(resumed.mu[k], state.mu[k], rtol=0, atol=0)
            torch.testing.assert_close(resumed.nu[k], state.nu[k], rtol=0, atol=0)


def test_resumed_run_equals_the_uninterrupted_one():
    """4 steps, a checkpoint, 4 more from it: the same losses and state
    as 8 steps in one run (bitwise on the CPU)."""
    cfg, opt = small_cfg(), TO.AdamWConfig(lr=1e-3, warmup=3)
    with tempfile.TemporaryDirectory() as d:
        whole, hist = run_trainer(cfg, opt, None, 8)
        run_trainer(cfg, opt, d, 4, every=4)
        part, hist2 = run_trainer(cfg, opt, d, 4, every=4)
    assert part.step == 8 and [h["step"] for h in hist2] == [5, 6, 7, 8]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[4:]]
    for k, p in part.params.items():
        torch.testing.assert_close(p, whole.params[k], rtol=0, atol=0)


def test_train_state_from_numpy_refuses_foreign_moments():
    jc, tc = configs()
    js = JT.init_train_state(jax.random.key(0), jc)
    p, mu, nu = (jax.tree.map(np.asarray, t) for t in (js.params, js.mu, js.nu))
    mu = dict(mu, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="moments"):
        train_state_from_numpy(p, mu, nu, 0, tc, device="cpu")


# -- paligemma-3b: the loss over a prefix ---------------------------------------------

PALI = "paligemma-3b"


def pali_configs(**kw):
    return (dataclasses.replace(jax_config(PALI, smoke=True), param_dtype="float32",
                                compute_dtype="float32", **kw),
            dataclasses.replace(get_config(PALI, smoke=True), param_dtype="float32",
                                compute_dtype="float32", **kw))


def pali_batch(cfg, step=0):
    return JD.SyntheticLMStream(cfg.vocab_size, B, S, seed=9, prefix_len=cfg.prefix_len,
                                d_model=cfg.d_model).batch(step)


def test_paligemma_loss_gradients_and_the_embeds_gradient():
    """lm_loss with embeds (float32): the loss, every parameter's
    gradient and the embeds' gradient against jax.value_and_grad; the
    prefix positions take no loss (two chunks of 32 token positions)."""
    jc, tc = pali_configs()
    params = _jit_init(jc)(jax.random.key(6))
    bt = pali_batch(jc)
    assert bt["embeds"].shape == (B, jc.prefix_len, jc.d_model)
    fn = jax.jit(jax.value_and_grad(lambda p, e, b: JLM.lm_loss(
        p, jc, b["tokens"], b["targets"], b["mask"], e), argnums=(0, 1)))
    jl, (jg, jge) = fn(params, jnp.asarray(bt["embeds"]), as_jax(bt))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    model.requires_grad_(True)
    emb = torch.from_numpy(bt["embeds"]).requires_grad_(True)
    ps = dict(model.named_parameters())
    loss = TLM.lm_loss(model, *(torch.from_numpy(bt[k]) for k in ("tokens", "targets", "mask")),
                       emb)
    *pg, eg = torch.autograd.grad(loss, [*ps.values(), emb])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0, atol=F32_LOSS_ATOL)
    assert_leaves_close(dict(zip(ps, pg)), jg, F32_LEAF_REL)
    want = np.asarray(jge)
    assert eg.shape == want.shape and np.abs(want).max() > 0
    assert np.abs(eg.numpy() - want).max() <= F32_LEAF_REL * np.abs(want).max()


def test_paligemma_train_steps_match_the_reference_trainer():
    """Three steps of make_train_step on batches with embeds (the
    trainer passes ``batch.get("embeds")``), from the reference's own
    state."""
    jc, tc = pali_configs()
    opt = dict(lr=1e-3, warmup=20)
    js = JT.init_train_state(jax.random.key(7), jc)
    ts = train_state_from_numpy(*(jax.tree.map(np.asarray, t)
                                  for t in (js.params, js.mu, js.nu)),
                                int(js.step), tc, device="cpu")
    jstep = jax.jit(JT.make_train_step(jc, JO.AdamWConfig(**opt)))
    tstep = TT.make_train_step(tc, TO.AdamWConfig(**opt))
    for i in range(3):
        bt = pali_batch(jc, i)
        js, jm = jstep(js, as_jax(bt))
        ts, tm = tstep(ts, TT.batch_tensors(bt, CPU))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=F32_LOSS_ATOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-5)
    assert_leaves_close(ts.params, js.params, F32_LEAF_REL)
    assert_leaves_close(ts.mu, js.mu, F32_LEAF_REL)


# -- starcoder2-3b (gelu, qkv biases, GQA) and musicgen-medium (a prefix) -----------

def arch_configs(arch, dtype):
    jc = dataclasses.replace(jax_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, scan_layers=False)
    return jc, tc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-medium"])
def test_loss_and_every_gradient_of_starcoder2_and_musicgen(arch, dtype):
    """The loss, every parameter's gradient (starcoder2's qkv biases
    among them) and, for musicgen, the prefix embeds' gradient: float32
    against the jitted ``jax.value_and_grad``, bf16 against the un-jitted
    one over the reference's op-by-op layer loop (ROADMAP C5)."""
    jc, tc = arch_configs(arch, dtype)
    params = _jit_init(jc)(jax.random.key(8))
    bt = JD.SyntheticLMStream(jc.vocab_size, B, S, seed=10, prefix_len=jc.prefix_len,
                              d_model=jc.d_model).batch(0)
    cast = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    emb = jnp.asarray(bt["embeds"], cast) if jc.prefix_len else None
    fn = jax.value_and_grad(lambda p, e, b: JLM.lm_loss(
        p, jc, b["tokens"], b["targets"], b["mask"], e), argnums=(0, 1))
    if dtype == "float32":
        fn = jax.jit(fn)
    jl, (jg, jge) = fn(params, emb, as_jax(bt))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    model.requires_grad_(True)
    ps = dict(model.named_parameters())
    args = [torch.from_numpy(bt[k]) for k in ("tokens", "targets", "mask")]
    temb = None
    if jc.prefix_len:
        temb = torch.from_numpy(np.array(emb, np.float32)).to(tc.cdtype).requires_grad_(True)
    loss = TLM.lm_loss(model, *args, temb)
    got = torch.autograd.grad(loss, [*ps.values()] + ([temb] if jc.prefix_len else []))
    grads = dict(zip(ps, got))
    loss_atol, rel = ((F32_LOSS_ATOL, F32_LEAF_REL) if dtype == "float32"
                      else (BF16_LOSS_ATOL, BF16_LEAF_REL))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0, atol=loss_atol)
    assert_leaves_close(grads, jg, rel)
    if tc.qkv_bias:
        for name in ("bq", "bk", "bv"):
            g = grads[f"blocks.0.attn.{name}"]
            assert g is not None and bool(g.abs().max() > 0), name
    if jc.prefix_len:
        want = np.asarray(jge, np.float32)
        eg = got[-1].float().numpy()
        assert eg.shape == want.shape and np.abs(want).max() > 0
        assert np.abs(eg - want).max() <= rel * np.abs(want).max()
