"""The port's LM serving stack (hymba at smoke size; paligemma-3b's
prefix embeddings, GeGLU and one kv head; the other archs' prefill)
against the reference, with the reference's ``init_lm`` weights carried
across by ``lm_params_from_numpy``.

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
from repro_torch.configs import ARCHS, PORTED, get_config  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    RequestQueue, cache_length, serve_queue)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mlp as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models.lm import CausalLM  # noqa: E402
from repro_torch.models.module import Params  # noqa: E402

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
        got = TM.mlp(model.blocks[0].mlp, xt, "swiglu")
    close(got, JM.mlp(layer0(params)["mlp"], xj, "swiglu"), MODULE_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_types_match_the_reference(mlp_type, dtype):
    """Every MLP type on the reference's own weights: wi (64, 2 x 128)
    split gate | up where gated, (64, 128) where not."""
    jp, _ = JM.init_mlp(jax.random.key(4), 64, 128, mlp_type, getattr(jnp, dtype))
    p = Params(**{k: torch.from_numpy(np.array(v, np.float32)).to(getattr(torch, dtype))
                  for k, v in jp.items()})
    assert p.wi.shape == ((64, 256) if mlp_type in TM.GATED else (64, 128))
    xj, xt = both(np.random.default_rng(12).standard_normal((B, S, 64)) * 2, dtype)
    with torch.inference_mode():
        got = TM.mlp(p, xt, mlp_type)
    assert got.dtype == xt.dtype
    close(got, JM.mlp(jp, xj, mlp_type), MODULE_TOL[dtype])


def test_gelu_rounds_as_the_reference_in_bf16():
    """Every finite bf16 input but those whose x or gelu(x) ~ x / 2 is
    subnormal, which XLA's CPU flushes to zero: bitwise jax.nn.gelu."""
    x = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    x = x[torch.isfinite(x) & ((x.float().abs() >= 2.0**-124) | (x == 0))]
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.float().numpy(), jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(TL.gelu(x).float().numpy(), want)


def test_unknown_mlp_type_raises():
    with pytest.raises(ValueError, match="unknown mlp_type"):
        TM.init_mlp(torch.Generator().manual_seed(0), 8, 16, "relu", torch.float32)


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
    """Every arch of the reference resolves, full and smoke, and a model
    of each block type builds (moe included); an unknown name raises."""
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.window, cfg.ssm_state, cfg.ssd_chunk) == (
        32, 1600, 25, 5, 64, 2048, 16, 128)
    assert cfg.pdtype == torch.bfloat16
    pali = get_config("paligemma-3b")
    assert (pali.num_layers, pali.d_model, pali.num_heads, pali.num_kv_heads,
            pali.head_dim, pali.d_ff, pali.vocab_size, pali.prefix_len,
            pali.mlp_type) == (18, 2048, 8, 1, 256, 16384, 257216, 256, "geglu")
    ds = get_config("deepseek-moe-16b")
    assert (ds.block_type, ds.num_experts, ds.top_k, ds.expert_d_ff,
            ds.shared_experts, ds.router_type, ds.capacity_factor,
            ds.moe_dispatch) == ("moe", 64, 6, 1408, 2, "softmax", 1.25, "scatter")
    assert set(PORTED) == set(ARCHS) and len(ARCHS) == 10
    for name in ARCHS:
        assert get_config(name).name == get_config(name, smoke=True).name == name
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    for name in ("deepseek-moe-16b", "mamba2-780m", "chatglm3-6b"):
        model = CausalLM(get_config(name, smoke=True), torch.Generator().manual_seed(0))
        assert len(model.blocks) == 2
    assert hasattr(model.blocks[0], "attn") and not hasattr(model.blocks[0], "moe")


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


def test_conversion_refuses_a_shape_mismatch():
    """paligemma's GeGLU wi (d, 2 d_ff) into a model whose MLP is not
    gated."""
    jc, tc = pali_configs("float32")
    params = jax.tree.map(np.asarray, init_params(jc, 3))
    with pytest.raises(RuntimeError, match="size mismatch for blocks.0.mlp.wi"):
        lm_params_from_numpy(params, dataclasses.replace(tc, mlp_type="gelu"),
                             device="cpu")


def test_conversion_runs_on_the_card_unless_asked_for_the_cpu():
    jc, tc = configs("float32")
    params = jax.tree.map(np.asarray, init_params(jc, 1))
    if torch.cuda.is_available():
        assert lm_params_from_numpy(params, tc).embed.table.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lm_params_from_numpy(params, tc)


# -- paligemma-3b: prefix embeddings, GeGLU, one kv head -------------------------

PALI = "paligemma-3b"


def pali_configs(dtype):
    jc = dataclasses.replace(jax_config(PALI, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    tc = dataclasses.replace(get_config(PALI, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    if dtype == "bfloat16":
        jc = dataclasses.replace(jc, scan_layers=False)
    return jc, tc


def embeds_of(seed, b, cfg):
    e = np.random.default_rng(seed).standard_normal(
        (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return jnp.asarray(e), torch.from_numpy(e)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pali_pair(request):
    dtype = request.param
    jc, tc = pali_configs(dtype)
    params = init_params(jc, 3)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    return dtype, jc, tc, params, model


def test_paligemma_conversion_keeps_the_references_weights(pali_pair):
    """GeGLU's wi (d, 2 d_ff) and the one-head wk, wv carried across
    bit for bit, in the reference's dtype."""
    dtype, jc, tc, params, model = pali_pair
    blk = model.blocks[1]
    assert blk.mlp.wi.shape == (tc.d_model, 2 * tc.d_ff)
    assert blk.attn.wk.shape == blk.attn.wv.shape == (tc.d_model, 1, tc.head_dim)
    for name, got in (("mlp.wi", blk.mlp.wi), ("attn.wk", blk.attn.wk),
                      ("attn.wv", blk.attn.wv)):
        group, leaf = name.split(".")
        want = np.asarray(params["blocks"][group][leaf][1], np.float32)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_paligemma_prefill_with_embeds(pali_pair):
    """Prefill over prefix + tokens: last logits and every layer's cache
    (prefix positions first)."""
    dtype, jc, tc, params, model = pali_pair
    toks = np.random.default_rng(13).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    ej, et = embeds_of(14, B, jc)
    cache_len = jc.prefix_len + S + 4
    want, wcache = JLM.prefill(params, jc, jnp.asarray(toks), cache_len, ej)
    with torch.inference_mode():
        got, cache = model.prefill(torch.from_numpy(toks), cache_len, et)
    assert got.shape == (B, jc.vocab_size)
    close(got, want, STACK_TOL[dtype])
    for key in ("k", "v"):
        assert stacked(cache, key).shape == wcache[key].shape
        close(stacked(cache, key), wcache[key], STACK_TOL[dtype])
    with torch.inference_mode():
        h = model.forward_hidden(torch.from_numpy(toks), et)
    assert h.shape == (B, jc.prefix_len + S, jc.d_model)
    close(TL.unembed(model.embed, h[:, -1]), got.numpy(), STACK_TOL[dtype])


@pytest.fixture(scope="module")
def pali_f32():
    jc, tc = pali_configs("float32")
    params = init_params(jc, 4)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    prefill = jax.jit(lambda p, t, c, e: JLM.prefill(p, jc, t, c, e), static_argnums=2)
    decode = jax.jit(lambda p, t, c, f: JLM.decode_step(p, jc, t, c, f))
    return jc, tc, params, model, prefill, decode


def test_paligemma_teacher_forced_decode_after_the_prefix(pali_f32):
    """The reference's prefill with cache_len = prefix + prompt + gen and
    its decode_step from fill = prefix + prompt, 6 forced tokens."""
    jc, tc, params, model, prefill, decode = pali_f32
    rng = np.random.default_rng(15)
    toks = rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, jc.vocab_size, (6, B)).astype(np.int32)
    ej, et = embeds_of(16, B, jc)
    cache_len = cache_length(tc, S, 6)
    assert cache_len == jc.prefix_len + S + 6
    _, wcache = prefill(params, jnp.asarray(toks), cache_len, ej)
    fill = jc.prefix_len + S
    with torch.inference_mode():
        _, cache = model.prefill(torch.from_numpy(toks), cache_len, et)
        for i in range(6):
            want, wcache = decode(params, jnp.asarray(forced[i]), wcache,
                                  jnp.int32(fill + i))
            got, cache = model.decode_step(torch.from_numpy(forced[i]), cache, fill + i)
            close(got, want, STACK_TOL["float32"])


def test_paligemma_serve_loop_emits_the_reference_greedy_tokens(pali_f32):
    """The serve loop draws each batch's embeddings from the queue's
    generator after its prompts, as the reference's CLI does; its greedy
    tokens against the reference's model functions given the same draws
    and a cache that holds prefix + prompt + gen."""
    jc, tc, params, model, prefill, decode = pali_f32
    prompt_len, gen, batch = 6, 5, 2
    rng = np.random.default_rng(17)
    got, stats = serve_queue(model, RequestQueue(rng, 3, tc.vocab_size, prompt_len),
                             batch, prompt_len, gen, rng=rng)
    assert stats["logits_finite"] and stats["batches"] == 2
    assert stats["prefill_tokens"] == 3 * prompt_len  # the prefix is not tokens

    rng = np.random.default_rng(17)
    queue = RequestQueue(rng, 3, jc.vocab_size, prompt_len)
    cache_len = jc.prefix_len + prompt_len + gen
    want = []
    while reqs := queue.drain(batch):
        toks = np.stack(reqs + [reqs[-1]] * (batch - len(reqs)))
        embeds = jnp.asarray(rng.standard_normal(
            (batch, jc.prefix_len, jc.d_model)).astype(np.float32))
        logits, cache = prefill(params, jnp.asarray(toks), cache_len, embeds)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out = []
        for i in range(gen):
            out.append(np.asarray(token))
            logits, cache = decode(params, token, cache,
                                   jnp.int32(jc.prefix_len + prompt_len + i))
            token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        want.extend(np.stack(out, 1)[: len(reqs)].tolist())
    assert got == want


def test_serve_needs_the_generator_of_a_prefix(pali_f32):
    _, tc, _, model, _, _ = pali_f32
    with pytest.raises(ValueError, match="prefix"):
        serve_queue(model, RequestQueue(np.random.default_rng(0), 2, tc.vocab_size, 4),
                    2, 4, 2)


def test_cache_length_counts_the_prefix():
    """Full paligemma: 256 + 512 + 32 positions (the reference's CLI
    would size 544 and drop 224 of them); a window still refuses what it
    cannot hold."""
    cfg = get_config(PALI)
    assert cache_length(cfg, 512, 32) == 800
    windowed = dataclasses.replace(cfg, window=700)
    with pytest.raises(ValueError, match="prefix 256"):
        cache_length(windowed, 512, 32)


# -- the archs registered after hymba ------------------------------------------------

NEW_ARCHS = ["paligemma-3b", "starcoder2-3b", "musicgen-medium", "deepseek-moe-16b",
             "llama4-scout-17b-a16e", "chatglm3-6b", "qwen1.5-32b", "mamba2-780m",
             "nemotron-4-340b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_ported_configs_are_the_references(arch):
    for smoke in (False, True):
        jc, tc = jax_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), (arch, smoke, f.name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_prefill_logits_match_the_reference(arch, dtype):
    """starcoder2 (gelu, qkv bias, rope theta 1e5), musicgen (gelu, a
    prefix), paligemma (geglu, a prefix, one kv head), deepseek (moe,
    softmax top 2 of 8, a shared expert), llama4 (moe, sigmoid top 1,
    rope theta 5e5), chatglm3 (qkv bias, half rotary), qwen1.5 (qkv bias,
    rope theta 1e6), mamba2 (ssm, no MLP) and nemotron (squared ReLU, half
    rotary) at smoke size."""
    jc = dataclasses.replace(jax_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype,
                             scan_layers=dtype == "float32")
    tc = dataclasses.replace(get_config(arch, smoke=True), param_dtype=dtype,
                             compute_dtype=dtype)
    params = init_params(jc, 5)
    if jc.qkv_bias:  # the reference inits biases to zero: give them values
        rng = np.random.default_rng(18)
        attn = dict(params["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.standard_normal(attn[name].shape) * 0.5,
                                     attn[name].dtype)
        params = {**params, "blocks": {**params["blocks"], "attn": attn}}
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, device="cpu")
    toks = np.random.default_rng(19).integers(0, jc.vocab_size, (B, S)).astype(np.int32)
    ej = et = None
    if jc.prefix_len:
        ej, et = embeds_of(20, B, jc)
    want, _ = JLM.prefill(params, jc, jnp.asarray(toks), jc.prefix_len + S, ej)
    with torch.inference_mode():
        got, _ = model.prefill(torch.from_numpy(toks), tc.prefix_len + S, et)
    close(got, want, STACK_TOL[dtype])
