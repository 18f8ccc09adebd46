"""The port's mixture of experts (``repro_torch/models/moe.py``) against
the reference's ``repro/models/moe.py``, at the smoke sizes of
deepseek-moe-16b (softmax router, top 2 of 8 experts, one shared) and
llama4-scout-17b-a16e (sigmoid router, top 1 of 8, one shared), with the
reference's ``init_lm`` weights carried across by
``lm_params_from_numpy``.

Routing is discontinuous: one float32 ulp in a router logit can swap an
expert, and float sums are never bitwise across the frameworks. So the
router's choices are held to JAX's on the rows whose k-th and (k+1)-th
scores lie more than ``SEPARATION`` apart; ties follow
``jax.lax.top_k`` (the lower expert first) exactly. The dispatch is
held to JAX's given JAX's own expert choices and gates: positions in
expert, kept slots and the dropped share bitwise, the outputs within
``TOL`` (float32 1e-5; bf16 atol 5e-2, rtol 1e-2, the bars of
``tests/test_torch_lm.py``). Capacity factors: the reference's 1.25 and
0.5, at which a good share of the slots is dropped.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import RequestQueue, cache_length, serve_queue  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy  # noqa: E402

ARCHS = ["deepseek-moe-16b", "llama4-scout-17b-a16e"]
DEEPSEEK = ARCHS[0]
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=5e-2, rtol=1e-2)}
CAPACITY = [1.25, 0.5]
SEPARATION = 1e-6
B, S = 4, 16  # T = 64 tokens a dispatch


def configs(arch, dtype="float32", **over):
    jc = dataclasses.replace(jax_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **over)
    tc = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype, **over)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype, mlp_type):
    jc, tc = configs(arch, dtype, mlp_type=mlp_type)
    params = jax.jit(lambda k: JLM.init_lm(k, jc)[0])(jax.random.key(3))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jax.tree.map(lambda a: a[0], params["blocks"]["moe"]), model.blocks[0].moe


def pair(arch, dtype="float32", capacity_factor=1.25, mlp_type="swiglu"):
    """(jc, tc, JAX layer-0 moe params, the port's layer-0 ``moe``); the
    weights do not depend on the capacity factor."""
    jc, tc = configs(arch, dtype, capacity_factor=capacity_factor, mlp_type=mlp_type)
    return (jc, tc, *_weights(arch, dtype, mlp_type))


def inputs(dtype, seed=0, b=B, s=S, d=64):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def jax_choice(jp, jc, xj):
    """The reference's router on x's tokens: idx (T, K), gates (T, K)."""
    return JM._routing(jp, jc, xj.reshape(-1, xj.shape[-1]).astype(jnp.float32))


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# -- routing -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_the_reference_on_separated_scores(arch):
    """512 tokens: the expert indices equal JAX's on every row whose
    k-th and (k+1)-th scores are more than SEPARATION apart (at least 95%
    of them), the gates within 1e-6 there."""
    jc, tc, jp, tp = pair(arch)
    x = (np.random.default_rng(1).standard_normal((512, 64)) * 2).astype(np.float32)
    want_idx, want_gates = jax_choice(jp, jc, jnp.asarray(x))
    got_idx, got_gates = TM.routing(tp, tc, torch.from_numpy(x))
    assert got_idx.dtype == torch.int32 and got_gates.dtype == torch.float32
    logits = jnp.asarray(x) @ jp["router"]
    scores = jax.nn.sigmoid(logits) if jc.router_type == "sigmoid" else jax.nn.softmax(logits)
    ranked = -np.sort(-np.asarray(scores), axis=-1)
    k = jc.top_k
    rows = ranked[:, k - 1] - ranked[:, k] > SEPARATION
    print(f"{arch}: {int(rows.sum())} of {len(rows)} rows separated by > {SEPARATION}")
    assert rows.mean() >= 0.95
    np.testing.assert_array_equal(got_idx.numpy()[rows], np.asarray(want_idx)[rows])
    np.testing.assert_allclose(got_gates.numpy()[rows], np.asarray(want_gates)[rows],
                               atol=1e-6, rtol=0)
    if jc.router_type == "softmax":  # renormalised over the top k
        np.testing.assert_allclose(got_gates.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_breaks_ties_as_the_reference(k):
    """500 tie-heavy rows (16 scores drawn from 3 values): the indices and
    values of ``jax.lax.top_k``, the lower index first among equals."""
    scores = np.random.default_rng(k).integers(0, 3, (500, 16)).astype(np.float32)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(scores), k)
    got_vals, got_idx = TM.top_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))


# -- positions, capacity, drops ----------------------------------------------------

def reference_positions(idx, e, cap):
    """``repro/models/moe.py``'s position in expert and keep, as its own
    lines compute them."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos_in_e = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return pos_in_e, pos_in_e < cap


@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("arch", ARCHS)
def test_positions_and_drops_bitwise_given_the_references_idx(arch, cf):
    jc, tc, jp, tp = pair(arch, capacity_factor=cf)
    xj, xt = inputs("float32", seed=2)
    t = B * S
    cap = TM.capacity(tc, t)
    assert cap == max(int(math.ceil(t * jc.top_k / jc.num_experts * cf)), 1)
    idx, gates = jax_choice(jp, jc, xj)
    want_pos, want_keep = reference_positions(idx, jc.num_experts, cap)
    _, onehot, pos, keep = TM.positions(*as_torch(idx), tc.num_experts, cap)
    assert pos.dtype == torch.int32 and onehot.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    _, want_aux = JM.moe(jp, jc, xj)
    _, aux = TM.dispatch(tp, tc, xt, *as_torch(idx, gates))
    for key in ("dropped", "expert_load"):
        np.testing.assert_array_equal(aux[key].numpy(), np.asarray(want_aux[key]))
    if cf < 1:
        assert float(aux["dropped"]) > 0.2


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_load_sums_to_one(arch):
    _, tc, _, tp = pair(arch)
    _, xt = inputs("float32", seed=4)
    _, aux = TM.moe(tp, tc, xt)
    assert aux["expert_load"].shape == (tc.num_experts,)
    assert abs(float(aux["expert_load"].sum()) - 1.0) <= 1e-6
    assert 0.0 <= float(aux["dropped"]) < 1.0


# -- the experts' output -----------------------------------------------------------

@pytest.mark.parametrize("cf", CAPACITY)
@pytest.mark.parametrize("mode", TM.DISPATCHES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_the_reference(arch, dtype, mode, cf):
    """Both dispatches against the reference's ``moe`` in the same
    dispatch: given JAX's expert choices, and with the port's own
    router."""
    jc, tc, jp, tp = pair(arch, dtype, capacity_factor=cf)
    xj, xt = inputs(dtype, seed=5)
    want, _ = JM.moe(jp, jc, xj, dispatch=mode)
    got, _ = TM.dispatch(tp, tc, xt, *as_torch(*jax_choice(jp, jc, xj)), mode)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    close(got, want, TOL[dtype])
    own, _ = TM.moe(tp, tc, xt, mode=mode)
    close(own, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["geglu", "gelu", "squared_relu"])
def test_expert_activations_match_the_reference(mlp_type, dtype):
    """The experts' other MLP types (the reference's ``_expert_ffn``),
    deepseek's router, scatter dispatch."""
    jc, tc, jp, tp = pair(DEEPSEEK, dtype, mlp_type=mlp_type)
    xj, xt = inputs(dtype, seed=6)
    want, _ = JM.moe(jp, jc, xj)
    got, _ = TM.dispatch(tp, tc, xt, *as_torch(*jax_choice(jp, jc, xj)))
    close(got, want, TOL[dtype])


def test_scatter_and_dense_agree_where_slots_drop():
    """The two dispatches compute one function: bitwise in bf16, where
    each expert slot holds one row and the products are the same calls."""
    _, tc, _, tp = pair(DEEPSEEK, "bfloat16", capacity_factor=0.5)
    _, xt = inputs("bfloat16", seed=7)
    a, aux = TM.moe(tp, tc, xt, mode="scatter")
    b, _ = TM.moe(tp, tc, xt, mode="dense")
    assert float(aux["dropped"]) > 0
    assert torch.equal(a, b)


def test_unknown_dispatch_raises():
    _, tc, _, tp = pair(DEEPSEEK)
    with pytest.raises(ValueError, match="dispatch"):
        TM.moe(tp, tc, inputs("float32")[1], mode="sparse")


def test_moe_block_keeps_the_reference_names_and_a_float32_router():
    """bf16 weights load with the router in float32, as the reference
    keeps it, under the reference's names."""
    _, tc, jp, tp = pair(DEEPSEEK, "bfloat16")
    names = {n: p.dtype for n, p in tp.named_parameters()}
    assert names == {"router": torch.float32, "wi": torch.bfloat16, "wo": torch.bfloat16,
                     "shared.wi": torch.bfloat16, "shared.wo": torch.bfloat16}
    assert tuple(tp.wi.shape) == (8, 64, 2 * 32) and tuple(tp.wo.shape) == (8, 32, 64)
    assert tuple(tp.shared.wi.shape) == (64, 2 * 32)
    np.testing.assert_array_equal(tp.router.numpy(), np.asarray(jp["router"]))


# -- deepseek-moe-16b's serving path -------------------------------------------------

@pytest.fixture(scope="module")
def deepseek_f32():
    jc, tc = configs(DEEPSEEK)
    params = jax.jit(lambda k: JLM.init_lm(k, jc)[0])(jax.random.key(4))
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    prefill = jax.jit(lambda p, t, c: JLM.prefill(p, jc, t, c), static_argnums=2)
    decode = jax.jit(lambda p, t, c, f: JLM.decode_step(p, jc, t, c, f))
    return jc, tc, params, model, prefill, decode


def test_deepseek_serve_loop_emits_the_reference_greedy_tokens(deepseek_f32):
    """The port's serve loop in float32 against a prefill and greedy
    decode loop over the reference (3 requests in batches of 2): the
    decode steps route 2 tokens at capacity 1, so they drop slots as the
    reference's do."""
    jc, tc, params, model, prefill, decode = deepseek_f32
    prompt_len, gen, batch = 6, 7, 2
    got, stats = serve_queue(model, RequestQueue(np.random.default_rng(9), 3,
                                                 tc.vocab_size, prompt_len),
                             batch, prompt_len, gen)
    assert stats["logits_finite"] and stats["batches"] == 2
    assert TM.capacity(tc, batch) == 1

    queue = RequestQueue(np.random.default_rng(9), 3, jc.vocab_size, prompt_len)
    cache_len = cache_length(tc, prompt_len, gen)
    want = []
    while reqs := queue.drain(batch):
        toks = np.stack(reqs + [reqs[-1]] * (batch - len(reqs)))
        logits, cache = prefill(params, jnp.asarray(toks), cache_len)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out = []
        for i in range(gen):
            out.append(np.asarray(token))
            logits, cache = decode(params, token, cache, jnp.int32(prompt_len + i))
            token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.extend(np.stack(out, 1)[: len(reqs)].tolist())
    assert got == want


def test_decode_matches_a_longer_prefill_when_nothing_drops(deepseek_f32):
    """At capacity_factor E/K the capacity is T, so no slot drops and a
    decode step computes what a prefill one token longer computes at its
    last position (float32, 1e-4). At the reference's 1.25 a decode
    step's capacity is 1: two equal tokens, which choose the same
    experts, keep the first token's slots only."""
    jc, tc, params, _, _, _ = deepseek_f32
    nodrop = dataclasses.replace(tc, capacity_factor=tc.num_experts / tc.top_k)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), nodrop, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tc.vocab_size, (2, 9)).astype(np.int32))
    with torch.inference_mode():
        _, cache = model.prefill(toks[:, :8], 9)
        dec, _ = model.decode_step(toks[:, 8], cache, 8)
        full, _ = model.prefill(toks, 9)
        x = torch.randn((1, 1, tc.d_model),
                        generator=torch.Generator().manual_seed(0)).expand(2, 1, -1)
        _, aux_nodrop = TM.moe(model.blocks[0].moe, nodrop, x)
        _, aux = TM.moe(model.blocks[0].moe, tc, x)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=1e-4, rtol=0)
    assert float(aux_nodrop["dropped"]) == 0.0 and float(aux["dropped"]) == 0.5
