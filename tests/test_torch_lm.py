"""The port's LM serving stack (hymba at smoke size) against the
reference, with the reference's ``init_lm`` weights carried across by
``lm_params_from_numpy``.

Tolerances: float32, 1e-5 for a single module and 1e-4 for logits and
caches after the whole stack; bf16, atol 5e-2 and rtol 1e-2, the bar of
``tests/test_models.py``. Decode and the serve loop are compared in
float32. In bf16 the port is held to the reference's
layer loop run op by op (``scan_layers=False``), where every bf16
operation rounds as it does in PyTorch: compiled under ``lax.scan``, XLA
fuses the bf16 elementwise chains and rounds them elsewhere, and its
logits then differ from its own op-by-op run by about 0.12 at this size,
more than the bar. In float32 both of the reference's paths agree and
the port is held to the scanned one.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    RequestQueue, cache_length, serve_queue)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mlp as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models.lm import CausalLM  # noqa: E402

ARCH = "hymba-1.5b"
MODULE_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
              "bfloat16": dict(atol=5e-2, rtol=1e-2)}
STACK_TOL = {"float32": dict(atol=1e-4, rtol=0),
             "bfloat16": dict(atol=5e-2, rtol=1e-2)}
B, S = 2, 8


def configs(dtype):
    jc = dataclasses.replace(jax_config(ARCH, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    tc = dataclasses.replace(get_config(ARCH, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, scan_layers=False)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jit_init(jc):
    return jax.jit(lambda k: JLM.init_lm(k, jc)[0])


def init_params(jc, seed):
    """The reference's ``init_lm`` parameters, jitted (op by op it takes
    seconds at this size)."""
    return _jit_init(jc)(jax.random.key(seed))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jc, tc = configs(dtype)
    params = init_params(jc, 1)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return dtype, jc, tc, params, model


def layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"])


def both(x, dtype):
    """The same float32 numpy values as a JAX and a torch array of dtype."""
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol)


def positions(b, s):
    p = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return jnp.asarray(p), torch.from_numpy(p)


# -- single modules --------------------------------------------------------------

def test_rmsnorm(pair):
    dtype, jc, tc, params, model = pair
    xj, xt = both(np.random.default_rng(0).standard_normal((B, S, 64)) * 3, dtype)
    with torch.inference_mode():
        got = TL.rmsnorm(model.blocks[0].norm1, xt, tc.norm_eps)
    assert got.dtype == xt.dtype
    close(got, JL.rmsnorm(layer0(params)["norm1"], xj, jc.norm_eps), MODULE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope(dtype, fraction):
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 11, 3, 16)), dtype)
    pos = rng.integers(0, 5000, (2, 11)).astype(np.int32)
    got = TL.apply_rope(xt, torch.from_numpy(pos), 10000.0, fraction)
    assert got.dtype == xt.dtype
    close(got, JL.apply_rope(xj, jnp.asarray(pos), 10000.0, fraction),
          MODULE_TOL[dtype])


def test_swiglu(pair):
    dtype, jc, tc, params, model = pair
    xj, xt = both(np.random.default_rng(2).standard_normal((B, S, 64)), dtype)
    with torch.inference_mode():
        got = TM.mlp(model.blocks[0].mlp, xt)
    close(got, JM.mlp(layer0(params)["mlp"], xj, "swiglu"), MODULE_TOL[dtype])


@pytest.mark.parametrize("mlp_type", ["geglu", "gelu", "squared_relu"])
def test_unported_mlp_types_raise(mlp_type):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), mlp_type=mlp_type)
    with pytest.raises(NotImplementedError, match="not ported"):
        CausalLM(cfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(pair, with_state):
    dtype, jc, tc, params, model = pair
    rng = np.random.default_rng(3)
    c = model.blocks[0].ssm.conv_w.shape[1]
    xj, xt = both(rng.standard_normal((B, S, c)), dtype)
    sj = st = None
    if with_state:
        sj, st = both(rng.standard_normal((B, 3, c)), "float32")
    with torch.inference_mode():
        out, state = TS._causal_conv(model.blocks[0].ssm, xt, st)
    want, wstate = JS._causal_conv(layer0(params)["ssm"], xj, sj)
    close(out, want, MODULE_TOL[dtype])
    close(state, wstate, MODULE_TOL[dtype])


def test_ssm_mixer(pair):
    dtype, jc, tc, params, model = pair
    xj, xt = both(np.random.default_rng(4).standard_normal((B, 13, 64)), dtype)
    with torch.inference_mode():
        out, (conv, hf) = TS.ssm_mixer(model.blocks[0].ssm, tc, xt, chunk=tc.ssd_chunk)
    want, (wconv, whf) = JS.ssm_mixer(layer0(params)["ssm"], jc, xj, chunk=jc.ssd_chunk)
    close(out, want, MODULE_TOL[dtype])
    close(conv, wconv, MODULE_TOL[dtype])
    close(hf, whf, MODULE_TOL[dtype])


@pytest.mark.parametrize("cache_len", [12, 5])
def test_attention_prefill(pair, cache_len):
    dtype, jc, tc, params, model = pair
    xj, xt = both(np.random.default_rng(5).standard_normal((B, S, 64)), dtype)
    pj, pt = positions(B, S)
    with torch.inference_mode():
        out, (kc, vc) = TA.attention_prefill(model.blocks[0].attn, tc, xt, pt, cache_len)
    want, (wk, wv) = JA.attention_prefill(layer0(params)["attn"], jc, xj, pj, cache_len)
    close(out, want, MODULE_TOL[dtype])
    close(kc, wk, MODULE_TOL[dtype])
    close(vc, wv, MODULE_TOL[dtype])


# -- the whole stack ------------------------------------------------------------

def stacked(caches, key):
    return np.stack([c[key].float().numpy() for c in caches])


def test_prefill_logits_and_caches(pair):
    dtype, jc, tc, params, model = pair
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    want, wcache = JLM.prefill(params, jc, jnp.asarray(toks), S + 4)
    with torch.inference_mode():
        got, cache = model.prefill(torch.from_numpy(toks), S + 4)
    assert got.dtype == torch.float32 and got.shape == (B, jc.vocab_size)
    close(got, want, STACK_TOL[dtype])
    for key in ("k", "v", "conv", "ssm"):
        close(stacked(cache, key), wcache[key], STACK_TOL[dtype])


def test_forward_hidden_and_prefill_agree(pair):
    """The full-sequence forward (block_train) and prefill give the same
    last-position logits, and the forward matches the reference's."""
    dtype, jc, tc, params, model = pair
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    with torch.inference_mode():
        h = model.forward_hidden(torch.from_numpy(toks))
        logits, _ = model.prefill(torch.from_numpy(toks), S)
    close(TL.unembed(model.embed, h[:, -1]), logits.numpy(), STACK_TOL[dtype])
    if dtype == "float32":
        close(h, JLM.forward_hidden(params, jc, jnp.asarray(toks)), STACK_TOL[dtype])


@pytest.fixture(scope="module")
def f32_jit():
    """The float32 pair with the reference's prefill and decode jitted."""
    jc, tc = configs("float32")
    params = init_params(jc, 2)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    prefill = jax.jit(lambda p, t, c: JLM.prefill(p, jc, t, c), static_argnums=2)
    decode = jax.jit(lambda p, t, c, f: JLM.decode_step(p, jc, t, c, f))
    return jc, tc, params, model, prefill, decode


def test_teacher_forced_decode_steps(f32_jit):
    """8 decode steps in float32 fill the smoke window (16) exactly; one
    more raises."""
    jc, tc, params, model, prefill, decode = f32_jit
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (8, B)).astype(np.int32)
    cache_len = S + 8
    _, wcache = prefill(params, jnp.asarray(toks), cache_len)
    with torch.inference_mode():
        _, cache = model.prefill(torch.from_numpy(toks), cache_len)
        for i in range(8):
            want, wcache = decode(params, jnp.asarray(forced[i]), wcache,
                                  jnp.int32(S + i))
            got, cache = model.decode_step(torch.from_numpy(forced[i]), cache, S + i)
            close(got, want, STACK_TOL["float32"])
        with pytest.raises(ValueError, match="free cache slot"):
            model.decode_step(torch.from_numpy(forced[0]), cache, cache_len)


def test_serve_loop_emits_the_reference_greedy_tokens(f32_jit):
    """The port's serve loop in float32 on the CPU against a prefill and
    greedy-decode loop over the reference, on the same numpy prompts (3
    requests in batches of 2, the last one padded)."""
    jc, tc, params, model, prefill, decode = f32_jit
    prompt_len, gen, batch = 6, 7, 2
    got, stats = serve_queue(model, RequestQueue(np.random.default_rng(9), 3,
                                                 tc.vocab_size, prompt_len),
                             batch, prompt_len, gen)
    assert stats["logits_finite"] and stats["batches"] == 2

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


def test_serve_warmup_batches_are_served_off_the_clock(f32_jit):
    """Warm-up batches emit the same tokens but are neither timed nor
    counted; a partial last batch counts its real requests only."""
    _, tc, _, model, _, _ = f32_jit

    def run(warmup):
        return serve_queue(model, RequestQueue(np.random.default_rng(3), 5,
                                               tc.vocab_size, 6), 2, 6, 3,
                           warmup=warmup)

    cold, cold_stats = run(0)
    warm, stats = run(1)
    assert warm == cold and stats["batches"] == cold_stats["batches"] == 3
    assert len(stats["prefill_s"]) == len(stats["decode_s"]) == 2
    assert stats["batch_tokens"] == [2, 1]
    assert (stats["prefill_tokens"], stats["decode_tokens"]) == (6 * 3, 3 * 3)
    assert cold_stats["batch_tokens"] == [2, 2, 1]


def test_init_cache_matches_the_reference(pair):
    dtype, jc, tc, params, model = pair
    want = JLM.init_cache(jc, 3, 10)
    got = model.init_cache(3, 10)
    assert len(got) == jc.num_layers
    for key in ("k", "v", "conv", "ssm"):
        assert stacked(got, key).shape == want[key].shape
        assert got[0][key].dtype == getattr(torch, str(want[key].dtype))
        assert not stacked(got, key).any()


def test_serve_refuses_what_the_cache_cannot_hold():
    _, tc = configs("float32")
    assert cache_length(tc, 10, 6) == 16
    with pytest.raises(ValueError, match="exceeds the cache"):
        cache_length(tc, 10, 7)


# -- registry and conversion -----------------------------------------------------

def test_registry_holds_the_ported_archs_only():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.window, cfg.ssm_state, cfg.ssd_chunk) == (
        32, 1600, 25, 5, 64, 2048, 16, 128)
    assert cfg.pdtype == torch.bfloat16
    for name in ARCHS:
        if name != ARCH:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                get_config(name)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    moe = dataclasses.replace(get_config(ARCH, smoke=True), block_type="moe")
    with pytest.raises(NotImplementedError):
        CausalLM(moe, torch.Generator().manual_seed(0))


def test_smoke_config_matches_the_reference():
    jc = jax_config(ARCH, smoke=True)
    tc = get_config(ARCH, smoke=True)
    for f in dataclasses.fields(tc):
        want = getattr(jc, f.name)
        assert getattr(tc, f.name) == want, f.name


def test_conversion_refuses_a_dtype_mismatch():
    jc, _ = configs("float32")
    _, tc = configs("bfloat16")
    params = init_params(jc, 2)
    with pytest.raises(TypeError, match="dtype"):
        lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")


def test_conversion_runs_on_the_card_unless_asked_for_the_cpu():
    jc, tc = configs("float32")
    params = jax.tree.map(np.asarray, init_params(jc, 1))
    if torch.cuda.is_available():
        assert lm_params_from_numpy(params, tc).embed.table.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_params_from_numpy(params, tc)
