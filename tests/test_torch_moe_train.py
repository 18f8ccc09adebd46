"""The port's LM training path with mixture-of-experts blocks against the
reference, at the smoke sizes of deepseek-moe-16b (softmax router
renormalised over the top 2 of 8 experts, one shared) and
llama4-scout-17b-a16e (sigmoid router, top 1 of 8, one shared): the loss
and every gradient, the layer's gradient where slots drop, the
recompute's routing, the train step against the reference's trainer and
a resumed run. The reference's weights and state are carried across by
``models/convert.py``; it runs with its defaults (``use_kernels=False``).

float32, against the jitted ``jax.value_and_grad`` of ``lm_loss``, both
dispatches, capacity factors 0.5 (slots drop), 1.25 (the reference's)
and E/K (nothing can drop), the port's remat on and off: the loss within
1e-5, every leaf within 1e-4 of its largest magnitude (measured: the
loss within 3.9e-6, the leaves within 3.5e-6). The reference runs with
its default remat: ``jax.checkpoint`` recomputes the same operations,
and at these sizes its compiled loss and gradients are the same with
remat on and off (``test_reference_gradients_do_not_depend_on_its_remat``).

bf16, against the reference's op-by-op layer loop (``scan_layers=False``)
called without ``jax.jit``: the loss within 1e-2, every leaf within 5e-2
(measured 9.5e-4 and 1.05e-2). Not against the jitted call, as
tests/test_torch_train.py holds hymba: XLA fuses bf16 chains and rounds
them elsewhere than the op-by-op run does (ROADMAP C5), and routing is
discontinuous, so where the fused rounding flips an expert choice the
jitted reference differs from its own un-jitted run by 0.21-0.40 of the
largest magnitude on the MoE leaves (deepseek at capacity factors 0.5
and 1.25, llama4 at 0.5). The port rounds as the op-by-op run does.
``jax.disable_jit()`` would take about 25 s a call; the un-jitted call
takes about 20 s once and a second or two after that, so each bf16
reference is computed once per module.

A dropped slot's gate is zeroed after the renormalisation, so the
router's gradient still reaches a dropped expert's score through the
renormalisation's denominator, in the reference as in the port: the
tests hold the router's gradient to JAX's and assert nothing about its
zeros.
"""

import dataclasses
import functools
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_data as TD  # noqa: E402
from repro_torch.launch import train as LT  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    lm_params_from_numpy, train_state_from_numpy)
from repro_torch.train import checkpoint as CKPT  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from test_torch_train import (  # noqa: E402
    B, BF16_LEAF_REL, BF16_LOSS_ATOL, CPU, F32_LEAF_REL, F32_LOSS_ATOL,
    as_jax, assert_leaves_close, batch, flat_leaves, port_loss_and_grads,
    reference_leaf, run_trainer)

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
DEEPSEEK = ARCHS[0]
S = 64  # two loss chunks of 32; T = 128 tokens a dispatch
DROP, REFERENCE = 0.5, 1.25  # capacity factors; the third is E/K
MOE_LEAVES = ("moe.router", "moe.wi", "moe.wo")


def nodrop(arch) -> float:
    c = get_config(arch, smoke=True)
    return c.num_experts / c.top_k


def capacity_factors(arch):
    return [DROP, REFERENCE, nodrop(arch)]


def configs(arch, dtype="float32", **kw):
    jc = dataclasses.replace(jax_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **kw)
    tc = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **kw)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, scan_layers=False)
    return jc, tc


@functools.lru_cache(maxsize=None)
def reference_params(arch, dtype="float32"):
    """The reference's ``init_lm`` weights (seed 3) as jax arrays."""
    jc, _ = configs(arch, dtype)
    return jax.jit(lambda k: JLM.init_lm(k, jc)[0])(jax.random.key(3))


def port_model(arch, tc, dtype="float32"):
    params = reference_params(arch, dtype)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return model.requires_grad_(True)


def value_and_grad(jc):
    return jax.value_and_grad(lambda p, b: JLM.lm_loss(
        p, jc, b["tokens"], b["targets"], b["mask"]))


@functools.lru_cache(maxsize=None)
def reference_f32(arch):
    """The jitted reference's loss and gradients at every float32 case of
    ``arch``, keyed by (dispatch, capacity factor, remat): one compile for
    all of them, which takes a good deal less than one a case."""
    keys = [(mode, cf, True) for mode in TM.DISPATCHES for cf in capacity_factors(arch)]
    if arch == DEEPSEEK:
        keys.append(("scatter", DROP, False))
    cfgs = [configs(arch, moe_dispatch=m, capacity_factor=cf, remat=r)[0]
            for m, cf, r in keys]
    bt = as_jax(batch(cfgs[0].vocab_size, s=S))
    fn = jax.jit(lambda p, b: [value_and_grad(jc)(p, b) for jc in cfgs])
    return dict(zip(keys, fn(reference_params(arch), bt)))


# -- float32 against the jitted reference ---------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("cf", ["drop", "reference", "nodrop"])
@pytest.mark.parametrize("mode", TM.DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference_f32(arch, mode, cf, remat):
    cf = {"drop": DROP, "reference": REFERENCE, "nodrop": nodrop(arch)}[cf]
    jl, jg = reference_f32(arch)[mode, cf, True]
    _, tc = configs(arch, moe_dispatch=mode, capacity_factor=cf, remat=remat)
    loss, grads = port_loss_and_grads(port_model(arch, tc), batch(tc.vocab_size, s=S))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=F32_LOSS_ATOL)
    assert_leaves_close(grads, jg, F32_LEAF_REL)
    for i in range(tc.num_layers):
        for leaf in MOE_LEAVES:
            assert float(grads[f"blocks.{i}.{leaf}"].abs().max()) > 0, (i, leaf)


def test_reference_gradients_do_not_depend_on_its_remat():
    """The jitted reference with remat off equals its remat-on run, which
    the float32 cases above hold the port to with its remat on and off."""
    ref = reference_f32(DEEPSEEK)
    jl, jg = ref["scatter", DROP, True]
    jl_off, jg_off = ref["scatter", DROP, False]
    assert float(jl_off) == float(jl)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(jg_off)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the layer's gradient where slots drop ------------------------------------------------

@pytest.mark.parametrize("mode", TM.DISPATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_gradients_match_the_reference_where_slots_drop(arch, mode):
    """One layer's experts at capacity factor 0.5, float32: the gradient of
    <out, g> for the router, the experts, the shared expert and x against
    ``jax.grad`` of the reference's ``moe`` on random inputs, whose
    top-k scores lie apart (so the port routes as JAX does). Half the
    slots or more drop."""
    jc, tc = configs(arch, moe_dispatch=mode, capacity_factor=DROP)
    jp = jax.tree.map(lambda a: a[0], reference_params(arch)["blocks"]["moe"])
    tp = port_model(arch, tc).blocks[0].moe
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, tc.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, _ = JM.moe(p, jc, xx, dispatch=mode)
        return jnp.sum(out * g)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = TM.moe(tp, tc, xt, mode=mode)
    assert float(aux["dropped"]) >= 0.5
    names = [n for n, _ in tp.named_parameters()]
    grads = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)),
                                [*tp.parameters(), xt])
    want = {"router": jgp["router"], "wi": jgp["wi"], "wo": jgp["wo"],
            "shared.wi": jgp["shared"]["wi"], "shared.wo": jgp["shared"]["wo"]}
    assert sorted(names) == sorted(want)
    for name, got in zip([*names, "x"], grads):
        w = np.asarray(jgx if name == "x" else want[name])
        assert np.abs(w).max() > 0, name
        err = np.abs(got.numpy() - w).max()
        assert err <= F32_LEAF_REL * np.abs(w).max(), (name, err, np.abs(w).max())


# -- bf16 against the un-jitted reference ------------------------------------------------

def reference_bf16():
    """The reference's bf16 loss and gradients, op by op and un-jitted,
    for deepseek smoke at its own capacity factor and dispatch."""
    jc, _ = configs(DEEPSEEK, "bfloat16")
    bt = batch(jc.vocab_size, s=S)
    return value_and_grad(jc)(reference_params(DEEPSEEK, "bfloat16"), as_jax(bt))


@pytest.fixture(scope="module", autouse=True)
def references_in_background(request):
    """Where the module's selected cases run in one process, the bf16
    reference's op-by-op compiles (about 20 s) and llama4's float32
    compile run in threads while deepseek's float32 cases compile theirs:
    XLA compiles without the GIL. Under xdist a worker computes only what
    its cases need."""
    items = [i for i in request.session.items if i.module is request.module]
    if (os.environ.get("PYTEST_XDIST_WORKER")
            or not any("deepseek_bf16" in i.fixturenames for i in items)):
        yield None
        return
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(reference_bf16)]
        if any(ARCHS[1] in i.name for i in items):
            futures.append(pool.submit(reference_f32, ARCHS[1]))
        yield futures[0]
        for f in futures:  # raise what a thread raised
            f.result()


@pytest.fixture(scope="module")
def deepseek_bf16(references_in_background):
    if references_in_background is None:
        return reference_bf16()
    return references_in_background.result()


@pytest.mark.parametrize("remat", [True, False])
def test_bf16_loss_and_gradients_match_the_unjitted_reference(deepseek_bf16, remat):
    jl, jg = deepseek_bf16
    _, tc = configs(DEEPSEEK, "bfloat16", remat=remat)
    loss, grads = port_loss_and_grads(port_model(DEEPSEEK, tc, "bfloat16"),
                                      batch(tc.vocab_size, s=S))
    flat = flat_leaves(jg)
    worst = max(np.abs(g.float().numpy() - reference_leaf(flat, n)).max()
                / np.abs(reference_leaf(flat, n)).max() for n, g in grads.items())
    print(f"bf16, remat {remat}: |loss - reference| {abs(float(loss) - float(jl)):.3g}, "
          f"leaves within {worst:.3g} of their largest magnitude")
    np.testing.assert_allclose(float(loss), float(jl), rtol=0, atol=BF16_LOSS_ATOL)
    for name, g in grads.items():  # the router and its gradient stay float32
        want = torch.float32 if name.endswith("moe.router") else torch.bfloat16
        assert g.dtype == want, (name, g.dtype)
    assert_leaves_close(grads, jg, BF16_LEAF_REL)


# -- the recompute routes as the forward did -----------------------------------------------

def test_remat_recompute_routes_as_the_forward(monkeypatch):
    """With remat on, each block's experts route twice, in the forward
    and in the backward's recompute: the same experts and gates each time
    (the block draws no random numbers), and the gradients bitwise those
    of remat off."""
    seen = []
    routing = TM.routing

    def recorded(p, cfg, xf):
        idx, gates = routing(p, cfg, xf)
        seen.append((id(p), idx.clone(), gates.detach().clone()))
        return idx, gates

    monkeypatch.setattr(TM, "routing", recorded)
    bt = batch(128, s=S)
    out, calls = {}, {}
    for remat in (True, False):
        _, tc = configs(DEEPSEEK, "bfloat16", capacity_factor=DROP, remat=remat)
        seen.clear()
        out[remat] = port_loss_and_grads(port_model(DEEPSEEK, tc, "bfloat16"), bt)
        calls[remat] = {}
        for key, idx, gates in seen:
            calls[remat].setdefault(key, []).append((idx, gates))
    layers = tc.num_layers
    assert [len(v) for v in calls[False].values()] == [1] * layers
    assert [len(v) for v in calls[True].values()] == [2] * layers
    for (i0, g0), (i1, g1) in calls[True].values():
        assert torch.equal(i0, i1) and torch.equal(g0, g1)
    torch.testing.assert_close(out[True][0], out[False][0], rtol=0, atol=0)
    for name, g in out[True][1].items():
        torch.testing.assert_close(g, out[False][1][name], rtol=0, atol=0)


# -- the train step, the loop and the driver ----------------------------------------------

def test_train_steps_match_the_reference_trainer():
    """Four AdamW steps of ``make_train_step`` on deepseek smoke (float32)
    from the reference's own initial state: each step's loss and grad
    norm, and the trained parameters and moments."""
    jc, tc = configs(DEEPSEEK)
    opt = dict(lr=1e-3, warmup=20)
    params = reference_params(DEEPSEEK)
    js = JT.TrainState(params, *JO.adamw_init(params), jnp.zeros((), jnp.int32))
    ts = train_state_from_numpy(*(jax.tree.map(np.asarray, t)
                                  for t in (js.params, js.mu, js.nu)),
                                int(js.step), tc, device="cpu")
    assert ts.params["blocks.0.moe.router"].dtype == torch.float32
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


def test_resumed_moe_run_equals_the_uninterrupted_one():
    """deepseek smoke in its own dtypes (bf16 experts, float32 router): 4
    Trainer steps, a checkpoint, 4 more restored from it give the losses
    and the state of 8 steps in one run, bitwise; the checkpoint keeps
    each leaf's dtype."""
    cfg, opt = get_config(DEEPSEEK, smoke=True), TO.AdamWConfig(lr=1e-3, warmup=3)
    with tempfile.TemporaryDirectory() as d:
        whole, hist = run_trainer(cfg, opt, None, 8)
        run_trainer(cfg, opt, d, 4, every=4)
        restored = TT.Trainer(cfg, opt, None, checkpoint_dir=d,
                              device="cpu").restore_or_init(0)
        part, hist2 = run_trainer(cfg, opt, d, 4, every=4)
    assert restored.params["blocks.0.moe.router"].dtype == torch.float32
    assert restored.params["blocks.0.moe.wi"].dtype == torch.bfloat16
    assert part.step == 8 and [h["step"] for h in hist2] == [5, 6, 7, 8]
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[4:]]
    for k, p in part.params.items():
        assert p.dtype == whole.params[k].dtype
        torch.testing.assert_close(p, whole.params[k], rtol=0, atol=0)
    for k in whole.mu:
        torch.testing.assert_close(part.mu[k], whole.mu[k], rtol=0, atol=0)
        torch.testing.assert_close(part.nu[k], whole.nu[k], rtol=0, atol=0)


def test_train_lm_trains_the_callers_config():
    """``launch/train.py::train_lm`` takes the config from its caller (a
    depth cut), as chip_smoke.py's phase 14 drives it; without one it
    builds ``--arch``'s."""
    args = LT.build_parser().parse_args([
        "--arch", DEEPSEEK, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "32", "--log-every", "1"])
    cfg = dataclasses.replace(get_config(DEEPSEEK, smoke=True), num_layers=1)
    state, hist, summary = LT.train_lm(args, cfg)
    assert len(state.model.blocks) == 1 and summary["arch"] == DEEPSEEK
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) and h["skipped"] == 0
                                  for h in hist)
    state, _, _ = LT.train_lm(args)
    assert len(state.model.blocks) == get_config(DEEPSEEK, smoke=True).num_layers
