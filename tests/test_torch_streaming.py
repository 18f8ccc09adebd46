"""The block-streamed trainer of the port against the reference's
single-device streaming path, and its own invariants.

Reference values come from ``ShardedHDP`` on
``compat.single_device_mesh()`` only. The port runs on the CPU here (the
plain sweep for ``z_impl="cuda"``); ``chip_smoke.py`` phase 8 runs the
streamed main path on the card. Inputs come from numpy seeds.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import hdp as JH  # noqa: E402
from repro.core.sharded import ShardedHDP  # noqa: E402
from repro.data import stream as JS  # noqa: E402
from repro.data import zstore as JZS  # noqa: E402
from repro.kernels.hdp_z import ops as JZ  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.core import sharded as SH  # noqa: E402
from repro_torch.core.convert import streaming_state_from_numpy  # noqa: E402
from repro_torch.core.streaming import StreamingHDP  # noqa: E402
from repro_torch.data import stream as TS  # noqa: E402
from repro_torch.data import zstore as TZS  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402
from repro_torch.kernels.hdp_z import ops as TZ  # noqa: E402
from repro_torch.kernels.hdp_z.ref import hdp_z_ref, hdp_z_ref_prologue  # noqa: E402
from repro_torch.train import checkpoint as CKPT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 12


def corpus_of(seed, d, v=48, doc_len=(10, 20)):
    c, _ = planted_topics_corpus(np.random.default_rng(seed), D=d, V=v,
                                 K_true=3, doc_len=doc_len)
    return c


def cfg_of(corpus, z_impl="cuda", **kw):
    return TH.HDPConfig(K=K, V=corpus.V, bucket=K, z_impl=z_impl, hist_cap=32, **kw)


def stream_of(corpus, block_docs, z_impl="cuda", **kw):
    store = TS.ShardedCorpusStore.from_corpus(corpus, block_docs)
    return StreamingHDP(cfg_of(corpus, z_impl), store, device="cpu", **kw)


def chain(stream, iters, seed=0):
    st = stream.init_state(seed)
    for _ in range(iters):
        st = stream.iteration(st)
    return st


def assert_states_equal(a, b):
    for f in ("n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_array_equal(a.z_blocks.materialize(), b.z_blocks.materialize())
    assert torch.equal(a.gen.get_state(), b.gen.get_state())
    assert a.it == b.it


# -- the stores ---------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 255, 256, 257, 65536, 65537])
def test_pack_dtype_for_equals_reference(k):
    assert TZS.pack_dtype_for(k) == JZS.pack_dtype_for(k)


def test_corpus_store_gives_the_reference_blocks(tmp_path):
    corpus = corpus_of(1, 37, v=200)
    ours = TS.ShardedCorpusStore.from_corpus(corpus, 8)
    ref = JS.ShardedCorpusStore.from_corpus(corpus, 8)
    assert (ours.num_blocks, ours.block_docs, ours.num_tokens) == (
        ref.num_blocks, ref.block_docs, ref.num_tokens) == (5, 8, corpus.num_tokens)
    for a, b in zip(ours.blocks(), ref.blocks()):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.mask, b.mask)
        assert a.doc_start == b.doc_start
    assert not ours.block(4).mask[37 - 32:].any()  # padded rows carry nothing
    np.testing.assert_array_equal(ours.vocab_ids(), ref.vocab_ids())
    assert ours.vocab_coverage == ref.vocab_coverage < 1.0
    ours.save(str(tmp_path))
    back = TS.ShardedCorpusStore.open(str(tmp_path))
    assert isinstance(back.tokens, np.memmap) and back.num_blocks == 5
    for a, b in zip(back.blocks(), ours.blocks()):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.mask, b.mask)


def test_corpus_store_fills_a_used_buffer_with_its_blocks(tmp_path):
    corpus = corpus_of(1, 37, v=200)
    store = TS.ShardedCorpusStore.from_corpus(corpus, 8)
    store.save(str(tmp_path))
    for s in (store, TS.ShardedCorpusStore.open(str(tmp_path))):
        # one buffer reused across blocks, as the driver's pinned ring is,
        # so the padded rows of the last block hold an earlier block's words
        tokens = np.full((8, corpus.max_len), 7, np.int32)
        mask = np.ones((8, corpus.max_len), bool)
        for b in range(s.num_blocks):
            s.fill(b, tokens, mask)
            want = s.block(b)
            np.testing.assert_array_equal(tokens, want.tokens)
            np.testing.assert_array_equal(mask, want.mask)
        assert not tokens[37 - 32:].any() and not mask[37 - 32:].any()
    with pytest.raises(IndexError):
        store.fill(5, tokens, mask)


def test_prefetcher_order_errors_and_shared_budget():
    assert list(TS.BlockPrefetcher(iter(range(10)), lambda x: x * x, depth=2)) == [
        x * x for x in range(10)]
    lock, seen = threading.Lock(), {"in": 0, "peak": 0}

    def pre(x):
        with lock:
            seen["in"] += 1
            seen["peak"] = max(seen["peak"], seen["in"])
        return x

    out = []
    for item in TS.BlockPrefetcher(iter(range(20)), lambda x: x + 1, depth=2, pre=pre):
        with lock:
            seen["in"] -= 1
        out.append(item)
    assert out == [x + 1 for x in range(20)]
    # depth items between pre and consumption (+1: the consumer's decrement
    # runs just after its permit frees)
    assert seen["peak"] <= 3, seen

    def fails_at(n, msg):
        def fn(x):
            if x == n:
                raise RuntimeError(msg)
            return x
        return fn

    with pytest.raises(RuntimeError, match="stage failed"):
        list(TS.BlockPrefetcher(iter(range(10)), fails_at(3, "stage failed"), depth=2))
    with pytest.raises(RuntimeError, match="pre failed"):
        list(TS.BlockPrefetcher(iter(range(10)), lambda x: x, depth=2,
                                pre=fails_at(5, "pre failed")))
    with pytest.raises(RuntimeError, match="stage failed"):
        list(TS.BlockPrefetcher(iter(range(10)), fails_at(5, "stage failed"),
                                depth=2, pre=lambda x: x))


def test_masked_tables_bitwise_equal_reference_on_tie_heavy_phi():
    rng = np.random.default_rng(3)
    k, v, w = 24, 60, 8
    phi = (rng.integers(0, 4, size=(k, v)) / 7.0).astype(np.float32)
    psi = rng.dirichlet(np.ones(k)).astype(np.float32)
    u_mask = rng.random(v) < 0.4
    u_mask[0] = False  # the reference's fill slots would alias row 0
    qj, fj, ij = (np.asarray(a) for a in JZ.build_word_sparse_tables_masked(
        jnp.asarray(phi), jnp.asarray(psi), 0.3, w, jnp.asarray(u_mask),
        int(u_mask.sum())))
    qt, ft, it = TZ.build_word_sparse_tables_masked(
        torch.from_numpy(phi), torch.from_numpy(psi), 0.3, w,
        torch.from_numpy(u_mask))
    np.testing.assert_array_equal(ft[:, 0].numpy(), fj[:, 0])
    np.testing.assert_array_equal(it[:, 0].numpy(), ij[:, 0])
    np.testing.assert_allclose(qt.numpy(), qj, rtol=1e-6)
    for x in (qt, ft, it):  # unflagged rows are zero
        assert not x[torch.from_numpy(~u_mask)].any()
    dense = TZ.build_word_sparse_tables(torch.from_numpy(phi), torch.from_numpy(psi),
                                        0.3, w)
    rows = torch.from_numpy(u_mask)
    for x, y in zip((qt, ft, it), dense):  # flagged rows: the dense build's
        assert torch.equal(x[rows], y[rows])


# -- the sub-steps against the reference's --------------------------------------

@pytest.mark.parametrize("z_impl", ["dense", "cuda"])
def test_block_sweep_from_a_carried_state_matches_reference(z_impl):
    """One block from a reference state carried across (n, phi, psi and
    z), fed the reference's z-step operands and its uniforms: z, dh and
    n + dn as the reference's ``z_block_fn`` (``_z_sweep_u`` and
    ``_block_stats``) gives them, at the bar of
    tests/test_torch_hdp.py::test_hybrid_z_step_matches_reference."""
    corpus = corpus_of(5, 24)
    jcfg = JH.HDPConfig(K=K, V=corpus.V, bucket=K, hist_cap=32,
                        z_impl="dense" if z_impl == "dense" else "pallas")
    sh = ShardedHDP(compat.single_device_mesh(), jcfg)
    tokens, mask = jnp.asarray(corpus.tokens), jnp.asarray(corpus.mask)
    js = sh.init_state(jax.random.key(0), tokens, mask)
    z = jnp.asarray(np.random.default_rng(1).integers(
        0, K - 1, corpus.tokens.shape).astype(np.int32))
    js = js._replace(z=z, n=JH.count_n(z, tokens, mask, K, corpus.V))
    key = jax.random.key(7)
    _, _, jtables = jax.jit(sh.phi_tables_fn())(js.n, js.psi, key)
    k_ub = jax.random.key(9)
    zj, dnj, dhj = jax.jit(sh.z_block_fn())(jtables, js.z, tokens, mask, js.psi, k_ub)
    u = np.array(jax.random.uniform(jax.random.fold_in(k_ub, 0),
                                    corpus.tokens.shape + (3,), jnp.float32))

    stream = stream_of(corpus, corpus.num_docs, z_impl)
    st = streaming_state_from_numpy(js, np.asarray(js.z)[None], stream, seed=0)
    tables = tuple(torch.from_numpy(np.array(t)) for t in jtables)
    zt, dnt, dht = SH.z_block(stream.cfg, tables, torch.from_numpy(np.array(js.z)),
                              torch.from_numpy(corpus.tokens),
                              torch.from_numpy(corpus.mask), st.psi,
                              torch.from_numpy(u), in_kernel=False)
    live = int(corpus.mask.sum())
    diff = (zt.numpy() != np.asarray(zj)) & corpus.mask
    print(f"{z_impl}: {int(diff.sum())} of {live} live tokens differ")
    assert diff.sum() <= live / 10_000
    assert ((zt.numpy() != np.asarray(js.z)) & corpus.mask).any()
    np.testing.assert_array_equal(dht.numpy(), np.asarray(dhj))
    np.testing.assert_array_equal((st.n + dnt).numpy(), np.asarray(js.n + dnj))


# -- the port's own chains ---------------------------------------------------------

@pytest.mark.parametrize("z_impl", ["dense", "cuda"])
def test_one_block_stream_is_bitwise_the_monolithic_chain(z_impl):
    corpus = corpus_of(0, 24)
    stream = stream_of(corpus, corpus.num_docs, z_impl)
    assert stream.store.num_blocks == 1
    tokens, mask = torch.from_numpy(corpus.tokens), torch.from_numpy(corpus.mask)
    mono = TH.init_state(TH.make_generator(0, "cpu"), tokens, mask, stream.cfg)
    st = stream.init_state(0)
    for _ in range(3):
        mono = TH.gibbs_iteration(mono, tokens, mask, stream.cfg)
        st = stream.iteration(st)
    assert torch.equal(mono.z, torch.from_numpy(st.z_blocks[0]))
    for f in ("n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(mono, f), getattr(st, f)), f
    assert torch.equal(mono.gen.get_state(), st.gen.get_state())
    assert mono.it == st.it == 3


@pytest.mark.parametrize("alias_in_kernel", ["on", "off"])
def test_block_uniforms_redrawn_from_the_state_give_the_streams_sweeps(alias_in_kernel):
    """Block b's uniforms are fixed by the iteration's starting state and
    b: redrawn on a copy of the generator in the driver's order (tables,
    then one draw a block), the plain sweep of each staged block,
    the padded last one included, is the stream's next z for it."""
    corpus = corpus_of(9, 45)
    stream = StreamingHDP(cfg_of(corpus, alias_in_kernel=alias_in_kernel),
                          TS.ShardedCorpusStore.from_corpus(corpus, 8), device="cpu")
    assert stream.store.num_blocks == 6 and stream.in_kernel == (alias_in_kernel == "on")
    st = chain(stream, 1)
    z_next = chain(stream, 2).z_blocks.materialize()
    gen = torch.Generator()
    gen.set_state(st.gen.get_state())
    _, _, ztables = stream._phi_tables(gen, st.n, st.varphi, st.psi)
    plain = hdp_z_ref_prologue if stream.in_kernel else hdp_z_ref
    for b in range(stream.store.num_blocks):
        u = stream._uniforms(gen)
        _, tokens, mask, z = stream._take(stream._to_device(
            stream._host_z(stream._host_block(b), st.z_blocks)))
        z_new, m, dn = plain(tokens, mask, z, u, *ztables, kk=K, emit_delta=True)
        np.testing.assert_array_equal(z_new.numpy(), z_next[b])
        assert torch.equal(m, TH.doc_topic_counts(z_new, mask, K))
        assert torch.equal(dn, TH.delta_n(z, z_new, tokens, mask, K, corpus.V))
    assert not mask[45 - 40:].any() and not z_new[45 - 40:].any()


def test_block_streamed_chain_meets_the_reference_system_assertions():
    """tests/test_hdp_system.py's assertions on a 4-block stream with a
    padded last block: n is the recount of z after every iteration, the
    posterior predictive likelihood improves."""
    corpus = corpus_of(7, 60, v=64, doc_len=(15, 30))
    stream = stream_of(corpus, 16)
    assert stream.store.num_blocks == 4
    tokens, mask = torch.from_numpy(corpus.tokens), torch.from_numpy(corpus.mask)
    cfg = stream.cfg
    st = stream.init_state(0)

    def as_mono(s):
        z = torch.from_numpy(s.z_blocks.materialize().reshape(-1, corpus.max_len))
        return TH.HDPState(z=z[:corpus.num_docs], n=s.n, phi=s.phi, varphi=s.varphi,
                           psi=s.psi, l=s.l, gen=s.gen, it=s.it)

    lls = [float(TH.posterior_predictive_ll(as_mono(st), tokens, mask, cfg))]
    for i in range(30):
        st = stream.iteration(st)
        mono = as_mono(st)
        assert torch.equal(TH.count_n(mono.z, tokens, mask, K, corpus.V), st.n)
        if (i + 1) % 10 == 0:
            lls.append(float(TH.posterior_predictive_ll(mono, tokens, mask, cfg)))
    assert np.mean(lls[-2:]) > lls[0], lls
    assert int(st.n.sum()) == corpus.num_tokens
    assert abs(float(st.psi.sum()) - 1.0) < 1e-4
    assert int(st.n[-1].sum()) <= max(2, corpus.num_tokens // 500)
    assert int((st.n.sum(1) > 0).sum()) > 1
    z = st.z_blocks.materialize()
    assert ((z >= 0) & (z < K)).all()
    assert not z.reshape(-1, corpus.max_len)[corpus.num_docs:].any()  # padding


@pytest.mark.parametrize("base,other", [
    ({}, {"z_store": "disk"}),
    ({}, {"z_pack": "off"}),
    ({"block_sparse_tables": "off"}, {"block_sparse_tables": "on"}),
])
def test_stream_options_give_bitwise_the_same_chain(base, other):
    corpus = corpus_of(2, 40, v=200)
    a, b = stream_of(corpus, 8, **base), stream_of(corpus, 8, **other)
    if "block_sparse_tables" in other:
        assert b.block_sparse_tables and not a.block_sparse_tables
        # "auto" takes them below half the vocabulary
        assert stream_of(corpus, 8).block_sparse_tables
        assert stream_of(corpus, 8).store.vocab_coverage < 0.5
    assert_states_equal(chain(a, 3), chain(b, 3))


def test_stream_option_guards():
    corpus = corpus_of(2, 16)
    with pytest.raises(ValueError, match="per-word alias tables"):
        stream_of(corpus, 8, "dense", block_sparse_tables="on")
    with pytest.raises(ValueError, match="z_store"):
        stream_of(corpus, 8, z_store="tape")
    with pytest.raises(ValueError, match="z_pack"):
        stream_of(corpus, 8, z_pack="sometimes")


def test_kill_and_resume_is_bitwise_the_uninterrupted_chain(tmp_path):
    corpus = corpus_of(4, 40)
    for z_store in ("ram", "disk"):
        stream = stream_of(corpus, 8, z_store=z_store)
        a = chain(stream, 4)
        d = str(tmp_path / z_store)
        b = chain(stream, 2)
        r = stream.iteration(b, ckpt_dir=d, ckpt_every_blocks=1, stop_after_blocks=2)
        assert r is None
        b, resume_kw = stream.restore(d)
        assert resume_kw["start_block"] == 2 and b.it == 2
        b = stream.iteration(b, **resume_kw)
        b = stream.iteration(b)
        assert_states_equal(a, b)


def test_saves_are_incremental_and_boundary_checkpoints_round_trip(tmp_path):
    corpus = corpus_of(4, 40)
    stream = stream_of(corpus, 8)
    st = stream.init_state(0)
    d = str(tmp_path)
    zdir = tmp_path / "zstore"
    stream.save(d, st)
    first = set(os.listdir(zdir))
    assert len(first) == stream.store.num_blocks  # the first save writes all
    assert stream.iteration(st, ckpt_dir=d, stop_after_blocks=2) is None
    assert len(set(os.listdir(zdir)) - first) == 2  # only the swept slabs
    for s in CKPT.all_steps(d):  # every pinned version is on disk
        for b, v in enumerate(CKPT.load_array(d, s, "z_versions")):
            assert (zdir / f"block_{b}.v{int(v)}.npy").exists(), (s, b)
    st2, kw = stream.restore(d)
    assert kw["start_block"] == 2
    st = chain(stream, 1)
    with_boundary = str(tmp_path / "boundary")
    stream.save(with_boundary, st)
    back, kw = stream.restore(with_boundary)
    assert kw == {}
    assert_states_equal(st, back)
    assert_states_equal(stream.iteration(st), stream.iteration(back))


def test_disk_store_bounds_resident_slabs_and_releases_them_on_errors():
    corpus = corpus_of(6, 80)
    stream = stream_of(corpus, 8, z_store="disk")
    assert stream.store.num_blocks == 10
    st = chain(stream, 2)
    bound = stream.prefetch_depth + stream.writeback_depth + 1
    slab = st.z_blocks
    assert 0 < slab.high_water <= bound < stream.store.num_blocks
    real_read, calls = slab.read, {"n": 0}

    def dying_read(b):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("injected z-read failure")
        return real_read(b)

    slab.read = dying_read
    try:
        with pytest.raises(RuntimeError, match="injected"):
            stream.iteration(st)
    finally:
        slab.read = real_read
    assert slab.resident_slabs == 0, slab._resident
    st = stream.iteration(st)  # a full sweep completes inside the bound
    assert 0 < st.z_blocks.high_water <= bound


def test_profiled_iteration_is_bitwise_and_splits_the_phases():
    corpus = corpus_of(8, 40)
    stream = stream_of(corpus, 8)
    a = chain(stream, 2)
    b = chain(stream, 1)
    b, timers = stream.iteration_profiled(b)
    assert_states_equal(a, b)
    assert set(timers.totals) == {"tables.build", "corpus_read", "z_read", "h2d",
                                  "sweep", "merge", "writeback", "tail"}
    assert timers.counts["sweep"] == stream.store.num_blocks


# -- the CLI ---------------------------------------------------------------------

def _cli(*extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--hdp", "ap",
         "--scale", "0.01", "--topics", "20", "--max-len", "64", "--stream",
         "--block-docs", "16", *extra],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_stream_cli_runs_on_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    out = _cli("--iters", "2", "--device", "cpu", "--ckpt", ck,
               "--ckpt-every-blocks", "2", "--z-store", "disk")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["mode"] == "streaming" and summary["iters"] == 2
    assert summary["blocks"] == 5 and summary["z_store"] == "disk"
    assert summary["z_dtype"] == "uint8" and summary["tokens_per_s"] > 0
    out = _cli("--iters", "1", "--device", "cpu", "--ckpt", ck)
    assert out.returncode == 0, out.stderr
    assert "restored streaming state: iteration 2, block cursor 0" in out.stdout


def test_stream_cli_without_card_exits_1_with_message():
    out = _cli("--iters", "1", timeout=120)
    assert out.returncode == 1
    assert "no CUDA device is present" in out.stderr
