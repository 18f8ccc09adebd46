"""Sweep lanes of the port's block-streamed trainer (``StreamingHDP(n_lanes=N)``)
against the reference's lane sweep and against the port's one-lane and
monolithic chains.

Reference values come from ``ShardedHDP`` on
``compat.single_device_mesh()`` only: its ``z_lane_fn`` is a plain
single-device function, so no forced host devices are needed. The port
runs on the CPU here, each lane a thread; ``chip_smoke.py`` phase 10 runs
the lanes on the card. Inputs come from numpy seeds.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.core import hdp as JH  # noqa: E402
from repro.core.sharded import ShardedHDP  # noqa: E402
from repro_torch.core import hdp as TH  # noqa: E402
from repro_torch.core import sharded as SH  # noqa: E402
from repro_torch.core.streaming import StreamingHDP  # noqa: E402
from repro_torch.data import stream as TS  # noqa: E402
from repro_torch.data.synthetic import planted_topics_corpus  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 12


def corpus_of(seed=0, d=32, v=48):
    c, _ = planted_topics_corpus(np.random.default_rng(seed), D=d, V=v,
                                 K_true=3, doc_len=(10, 20))
    return c


def cfg_of(corpus, z_impl="cuda"):
    # alpha and gamma high enough that the small chain moves topics
    return TH.HDPConfig(K=K, V=corpus.V, bucket=K, z_impl=z_impl, hist_cap=32,
                        alpha=2.0, gamma=2.0)


def stream_of(corpus, n_lanes, block_docs=8, z_impl="cuda", **kw):
    store = TS.ShardedCorpusStore.from_corpus(corpus, block_docs)
    return StreamingHDP(cfg_of(corpus, z_impl), store, device="cpu",
                        n_lanes=n_lanes, **kw)


def random_start(stream, seed=7):
    """The stream's init state with z drawn uniformly over K at the live
    tokens and n recounted, so that a short chain moves many tokens.
    The generator is where the init left it, as for ``TH.init_state``."""
    st = stream.init_state(seed)
    rng = np.random.default_rng(seed)
    n = torch.zeros_like(st.n)
    for blk in stream.store.blocks():
        z = rng.integers(0, K, blk.tokens.shape).astype(np.int32) * blk.mask
        st.z_blocks.write(blk.index, z.astype(st.z_blocks.dtype))
        n += TH.count_n(torch.from_numpy(z), torch.from_numpy(blk.tokens),
                        torch.from_numpy(blk.mask), K, stream.cfg.V)
    return st._replace(n=n)


def chain(stream, iters=3, profiled=False):
    st = random_start(stream)
    for _ in range(iters):
        st = stream.iteration_profiled(st)[0] if profiled else stream.iteration(st)
    return st


def assert_states_equal(a, b, tag=""):
    for f in ("n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(a, f), getattr(b, f)), (tag, f)
    np.testing.assert_array_equal(a.z_blocks.materialize(), b.z_blocks.materialize(),
                                  err_msg=str(tag))
    assert torch.equal(a.gen.get_state(), b.gen.get_state()), tag
    assert a.it == b.it


# -- one lane's rows against the reference's z_lane_fn ---------------------------

@pytest.fixture(scope="module")
def reference_lane_inputs():
    """A reference state with z drawn uniformly over K, its z-step tables
    and one block key: what ``z_lane_fn`` sweeps."""
    corpus = corpus_of(5, 24)
    jcfg = JH.HDPConfig(K=K, V=corpus.V, bucket=K, hist_cap=32, z_impl="pallas",
                        alpha=2.0, gamma=2.0)
    sh = ShardedHDP(compat.single_device_mesh(), jcfg)
    tokens, mask = jnp.asarray(corpus.tokens), jnp.asarray(corpus.mask)
    js = sh.init_state(jax.random.key(0), tokens, mask)
    z = jnp.asarray(np.random.default_rng(1).integers(
        0, K, corpus.tokens.shape).astype(np.int32) * corpus.mask)
    js = js._replace(z=z, n=JH.count_n(z, tokens, mask, K, corpus.V))
    _, _, jtables = jax.jit(sh.phi_tables_fn())(js.n, js.psi, jax.random.key(7))
    return corpus, sh, js, jtables, jax.random.key(9)


@pytest.mark.parametrize("n_lanes", [1, 2, 4])
def test_z_lane_is_bitwise_the_references_lane(reference_lane_inputs, n_lanes):
    """Every lane's (z_rows', dn, dh) on the reference's tables and its
    block-global uniforms (``fold_in(k_ub, 0)``), as ``z_lane_fn`` gives
    them; the lanes' deltas sum to the whole block's."""
    corpus, sh, js, jtables, k_ub = reference_lane_inputs
    block_docs = corpus.num_docs
    rows = block_docs // n_lanes
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k_ub, 0), corpus.tokens.shape + (3,), jnp.float32)))
    tables = tuple(torch.from_numpy(np.array(t)) for t in jtables)
    cfg = cfg_of(corpus)
    psi = torch.from_numpy(np.array(js.psi))
    z_all, tok_all, mask_all = (np.array(js.z), corpus.tokens, corpus.mask)
    dn_sum = 0
    for d in range(n_lanes):
        sl = slice(d * rows, (d + 1) * rows)
        zj, dnj, dhj = jax.jit(sh.z_lane_fn(n_lanes, d, block_docs))(
            jtables, jnp.asarray(z_all[sl]), jnp.asarray(tok_all[sl]),
            jnp.asarray(mask_all[sl]), js.psi, k_ub)
        zt, dnt, dht = SH.z_lane(cfg, tables, torch.from_numpy(z_all[sl]),
                                 torch.from_numpy(tok_all[sl]),
                                 torch.from_numpy(mask_all[sl]), psi, u,
                                 n_lanes=n_lanes, lane=d, in_kernel=False)
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
        np.testing.assert_array_equal(dnt.numpy(), np.asarray(dnj))
        np.testing.assert_array_equal(dht.numpy(), np.asarray(dhj))
        assert ((zt.numpy() != z_all[sl]) & mask_all[sl]).any()  # the sweep moved
        dn_sum = dn_sum + dnt
    _, dn_block, _ = SH.z_block(cfg, tables, torch.from_numpy(z_all),
                                torch.from_numpy(tok_all), torch.from_numpy(mask_all),
                                psi, u, in_kernel=False)
    assert torch.equal(dn_sum, dn_block)


def test_z_lane_validates_its_rows():
    corpus = corpus_of(5, 24)
    cfg = cfg_of(corpus)
    z = torch.zeros((5, corpus.max_len), dtype=torch.int32)
    u = torch.zeros((24, corpus.max_len, 3))
    with pytest.raises(ValueError, match="not divisible"):
        SH.z_lane(cfg, (), z, z, z.bool(), None, u, n_lanes=5, lane=0, in_kernel=False)
    with pytest.raises(ValueError, match="takes 6 rows"):
        SH.z_lane(cfg, (), z, z, z.bool(), None, u, n_lanes=4, lane=0, in_kernel=False)


# -- the port's chains ----------------------------------------------------------

@pytest.mark.parametrize("z_impl", ["cuda", "dense"])
def test_lanes_on_one_block_are_bitwise_the_monolithic_chain(z_impl):
    corpus = corpus_of()
    tokens, mask = torch.from_numpy(corpus.tokens), torch.from_numpy(corpus.mask)
    one = stream_of(corpus, 1, corpus.num_docs, z_impl)
    start = random_start(one)
    z0 = torch.from_numpy(start.z_blocks[0].astype(np.int32))
    mono = TH.init_state(TH.make_generator(7, "cpu"), tokens, mask, one.cfg)
    mono = mono._replace(z=z0, n=start.n.clone())
    for _ in range(3):
        mono = TH.gibbs_iteration(mono, tokens, mask, one.cfg)
    for n_lanes in (2, 4):
        st = chain(stream_of(corpus, n_lanes, corpus.num_docs, z_impl))
        assert torch.equal(mono.z, torch.from_numpy(st.z_blocks[0].astype(np.int32)))
        for f in ("n", "phi", "varphi", "psi", "l"):
            assert torch.equal(getattr(mono, f), getattr(st, f)), (n_lanes, f)
        assert torch.equal(mono.gen.get_state(), st.gen.get_state())


@pytest.mark.parametrize("z_impl", ["cuda", "dense"])
@pytest.mark.parametrize("z_store", ["ram", "disk"])
def test_lane_chain_is_bitwise_one_lane(z_impl, z_store, tmp_path):
    """n_lanes in {2, 4} == n_lanes 1 over 4 blocks and 3 iterations, with
    real packed delta traffic, sparser than the dense exchange."""
    corpus = corpus_of()
    ref = chain(stream_of(corpus, 1, z_impl=z_impl, z_store=z_store,
                          z_dir=str(tmp_path / "r")))
    for n_lanes in (2, 4):
        drv = stream_of(corpus, n_lanes, z_impl=z_impl, z_store=z_store,
                        z_dir=str(tmp_path / str(n_lanes)))
        assert_states_equal(ref, chain(drv), (z_impl, z_store, n_lanes))
        assert drv.delta_reduce_bytes > 0
        dense = 3 * drv.store.num_blocks * n_lanes * K * corpus.V * 4
        assert drv.delta_reduce_bytes < dense


def test_lane_chain_with_int32_slabs_and_the_profiled_twin():
    corpus = corpus_of()
    ref = chain(stream_of(corpus, 1))
    assert_states_equal(ref, chain(stream_of(corpus, 2, z_pack="off")), "z_pack=off")
    drv = stream_of(corpus, 4)
    assert_states_equal(ref, chain(drv, profiled=True), "profiled")
    assert drv.delta_reduce_bytes > 0
    st, timers = drv.iteration_profiled(random_start(drv))
    assert set(timers.totals) == {"tables.build", "corpus_read", "z_read", "h2d",
                                  "sweep", "merge", "writeback", "tail"}
    assert timers.counts["sweep"] == drv.store.num_blocks


@pytest.mark.parametrize("z_store", ["ram", "disk"])
def test_lane_mode_mid_epoch_checkpoint_resumes_bitwise(z_store, tmp_path):
    """A 2-lane sweep stopped mid-iteration (the reducer flushed before the
    save) resumes from its checkpoint to the uninterrupted one-lane chain."""
    corpus = corpus_of()
    ref = chain(stream_of(corpus, 1), iters=2)
    d = str(tmp_path / "ck")
    drv = stream_of(corpus, 2, z_store=z_store, z_dir=d)
    st = drv.iteration(random_start(drv))
    assert drv.iteration(st, ckpt_dir=d, ckpt_every_blocks=1,
                         stop_after_blocks=2) is None
    restored, kw = drv.restore(d)
    assert kw["start_block"] == 2 and restored.it == 1
    assert_states_equal(ref, drv.iteration(restored, **kw), "resume")


def test_lanes_share_the_devices_they_are_given():
    corpus = corpus_of()
    drv = stream_of(corpus, 4, devices=["cpu", "cpu"])
    assert [str(d) for d in drv.lane_devices] == ["cpu"] * 4
    assert drv.n_lanes == 4 and drv._lane_rows == 2
    assert_states_equal(chain(stream_of(corpus, 1), 1), chain(drv, 1), "devices")


def test_lane_mode_validation():
    corpus = corpus_of()
    with pytest.raises(ValueError, match="block_docs=8 must divide evenly"):
        stream_of(corpus, 3)
    with pytest.raises(ValueError, match="n_lanes must be >= 1"):
        stream_of(corpus, 0)
    with pytest.raises(ValueError, match="sweep lanes run on cpu devices"):
        stream_of(corpus, 2, devices=["meta"])


def test_a_failing_lane_surfaces_its_error_and_stops_every_thread():
    corpus = corpus_of()
    drv = stream_of(corpus, 2)
    st = random_start(drv)
    real = drv._lane_sweep

    def dying(lane, work):
        if lane.d == 1:
            raise RuntimeError("injected lane failure")
        return real(lane, work)

    drv._lane_sweep = dying
    before = {t.name for t in __import__("threading").enumerate()}
    with pytest.raises(RuntimeError, match="injected lane failure"):
        drv.iteration(st)
    left = {t.name for t in __import__("threading").enumerate()} - before
    assert not {n for n in left if n.startswith("sweep.d")}, left


def test_stream_cli_runs_sweep_lanes_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--hdp", "ap",
            "--scale", "0.01", "--topics", "20", "--max-len", "64", "--iters", "1",
            "--device", "cpu"]
    out = subprocess.run(base + ["--stream", "--block-docs", "16", "--devices", "2"],
                         env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "2 sweep lane(s)" in out.stdout
    import json
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["sweep_lanes"] == 2 and summary["delta_reduce_mb"] > 0
    out = subprocess.run(base + ["--devices", "2"], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 2 and "pass --stream" in out.stderr
