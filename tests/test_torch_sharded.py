"""The data-parallel sampler (``core/sharded.py::ShardedHDP``) on grids of
ranks over ``torch.distributed``, on the CPU.

Every process group lives in a child process: the ranks are this file
run as a script (``python tests/test_torch_sharded.py SPEC NAME RANK
WORLD``), each on gloo with a ``file://`` rendezvous under the test's
``tmp_path`` (no TCP port) and one thread, joined with a timeout. One
spawn runs every check of its grids and writes each rank's findings as
JSON; the test asserts on them. The reference's multi-device values come
from one child process with 8 host devices (``XLA_FLAGS`` in that
child's environment only), which writes an ``.npz``. The pytest process
sets no environment variable, starts no process group and builds no
multi-device mesh; the spawns of this file take a lock, so under xdist
one runs at a time; the ranks run at a lower priority (``nice``).

What the ranks hold (the reference's ``tests/test_multidevice.py``
corpus: ``planted_topics_corpus(D=60, V=64, K_true=4)``, K=16, W=16,
hist_cap 32, ``shard_balanced`` over 8):

  1. on (data, model) = (4, 2) and (pod, data, model) = (2, 2, 2), the
     reference's own sharded sub-steps, fed its PPU draws and uniforms:
     phi bitwise, the gathered supports bitwise, the port's own tables by
     their reconstructed pmf, and z, m, dn_shard, dh and the next n
     bitwise on the reference's tables;
  2. on (1, 1), (2, 1), (1, 2), (2, 2) and (2, 2, 2), one iteration
     given the one-process chain's draws is bitwise
     ``core/hdp.py::gibbs_iteration`` (z, n, phi, varphi, dh, l and Psi)
     in prologue mode, table mode and on the dense z-step (on compact
     tables and a bf16 phi, which it does not take, its sub-steps); Psi
     and l are the same on every rank, the collectives' bytes those the
     shapes give, and the block-sparse (``u_mask``) table build bitwise
     the one-process one;
  3. on the same grids, 8 iterations of the grid's own chain keep n the
     recount of z and the token count, and raise the
     posterior-predictive log-likelihood. The flag topic's tokens are
     reported, not held to 0: at K=16 a word that no real topic's PPU
     draw covers goes to the flag topic whenever the flag's Poisson(beta)
     background covers it, and the one-process chain of
     ``gibbs_iteration`` takes that path in some seeds too; at K=1000
     the card's runs hold it empty;
  4. on the same grids, the collectives on gloo: the psum-scatter
     composition against gloo's own reduce-scatter, psum and all_gather
     against their values, in integers and floats;
  6. the reference's ``V % model`` check, on every grid whose model axis
     is 2.

5 (``torchrun`` on two ranks) and the pure functions run in this
process.
"""

from __future__ import annotations

import contextlib
import fcntl
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
K, V, BUCKET, HIST_CAP, SHARDS = 16, 64, 16, 32, 8
ITERS = 8
SPAWN_TIMEOUT_S = 300
# z-step variants: (z_impl, alias_in_kernel, compact tables, phi dtype)
F32, BF16 = torch.float32, torch.bfloat16
VARIANTS = {"table": ("cuda", "off", False, F32), "prologue": ("cuda", "on", False, F32),
            "compact": ("cuda", "off", True, F32), "dense": ("dense", "auto", False, F32),
            "dense_bf16": ("dense", "auto", False, BF16)}
# the reference's: its pallas impl in interpret mode, in prologue mode
# (supports gathered) and in table mode, and its dense z-step
REF_VARIANTS = {"prologue": ("pallas", "on"), "table": ("pallas", "off"),
                "dense": ("dense", "auto")}
REF_GRIDS = {"4x2": ((4, 2), ("data", "model")),
             "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.compat import AxisType
from repro.core import hdp as H
from repro.core.sharded import ShardedHDP
from repro.data.corpus import shard_balanced
from repro.data.synthetic import planted_topics_corpus

K, V, W, CAP, SHARDS = {consts}
VARIANTS = {variants}
GRIDS = {grids}
corpus, _ = planted_topics_corpus(np.random.default_rng(0), D=60, V=V,
                                  K_true=4, doc_len=(15, 30))
corpus = shard_balanced(corpus, SHARDS)
tokens, mask = jnp.asarray(corpus.tokens), jnp.asarray(corpus.mask)
z = np.where(corpus.mask, np.random.default_rng(1).integers(
    0, K - 1, corpus.tokens.shape), 0).astype(np.int32)
n = np.zeros((K, V), np.int32)
np.add.at(n, (z[corpus.mask], corpus.tokens[corpus.mask]), 1)
psi = np.random.default_rng(2).dirichlet(np.ones(K)).astype(np.float32)
out = dict(tokens=corpus.tokens, mask=corpus.mask, z=z, n=n, psi=psi)
for gname, (shape, axes) in GRIDS.items():
    mesh = compat.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    shs = {{vname: ShardedHDP(mesh, H.HDPConfig(
        K=K, V=V, bucket=W, z_impl=impl, hist_cap=CAP, alias_in_kernel=aik,
        pallas_interpret=True)) for vname, (impl, aik) in VARIANTS.items()}}
    names = [f"{{gname}}/{{vname}}/{{name}}" for vname, sh in shs.items() for name in (
        "varphi", "varphi_t", "phi",
        *[f"zt{{i}}" for i in range(1 if sh.cfg.z_impl == "dense" else 3)],
        "u", "z_new", "m", "dn_shard", "dh", "n_next")]

    def local(z, tokens, mask, n_shard, psi, key):
        # every variant in one program (one compile a mesh), each on the
        # draws of the same key, as its own ShardedHDP.iteration_fn would
        outs = []
        for sh in shs.values():
            _, k_phi, k_u, _, _ = jax.random.split(key, 5)
            varphi = sh._ppu_shard(n_shard, k_phi, jax.lax.axis_index("model"))
            phi, varphi_t, zt = sh._phi_tables(n_shard, psi, k_phi)
            u = jax.random.uniform(jax.random.fold_in(k_u, jax.lax.axis_index(axes)),
                                   tokens.shape + (3,), jnp.float32)
            z_new, m, dn = sh._z_sweep_u(zt, z, tokens, mask, psi, u)
            dn_shard, dh = sh._block_stats(z, z_new, m, tokens, mask, dn=dn)
            outs += [varphi, varphi_t, phi, *zt, u, z_new, m, dn_shard, dh,
                     n_shard + dn_shard]
        return tuple(o[None] for o in outs)

    s = shs["dense"].specs()
    fn = jax.jit(compat.shard_map(
        local, mesh=mesh,
        in_specs=(s["z"], s["tokens"], s["mask"], s["n"], P(), P()),
        out_specs=tuple(P(axes) for _ in names), check_vma=False))
    res = fn(jnp.asarray(z), tokens, mask, jnp.asarray(n), jnp.asarray(psi),
             jax.random.key(5))
    out.update((name, np.asarray(a)) for name, a in zip(names, res))
np.savez(sys.argv[1], **out)
print("OK")
"""


# the ranks and torchrun run at a lower priority, so that the suite's
# timing-sensitive tests in the other xdist workers (the reference's
# 512-device rendezvous, the fleet's races) keep the cores when they
# contend; the reference's child does not: its 8 host devices meet in
# XLA's own rendezvous, which aborts when a device thread starves
NICE = ["nice", "-n", "10"]


def child_env(**extra: str) -> dict:
    """A copy of this process's environment for a child, with the
    sources on its path and one thread."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


@contextlib.contextmanager
def one_spawn_at_a_time(tmp_path_factory):
    """A lock shared by the xdist workers of this session (their temp
    directories share a parent), so this file's spawns run one at a time."""
    path = tmp_path_factory.getbasetemp().parent / "test_torch_sharded.lock"
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def spawn(tmp_path, tmp_path_factory, name: str, world: int, spec: dict,
          script: str = __file__) -> list:
    """Run ``world`` ranks of ``script`` (this file unless another test
    file's ranks) on ``spec``; each rank's findings."""
    spec_path = tmp_path / f"{name}.json"
    spec_path.write_text(json.dumps(spec))
    with one_spawn_at_a_time(tmp_path_factory):
        procs, logs = [], []
        try:
            for r in range(world):
                log = open(tmp_path / f"{name}.rank{r}.log", "w")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [*NICE, sys.executable, script, str(spec_path), name, str(r),
                     str(world)], env=child_env(), stdout=log,
                    stderr=subprocess.STDOUT, cwd=ROOT))
            deadline = time.monotonic() + SPAWN_TIMEOUT_S
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pytest.fail(f"{name}: ranks still running after "
                                f"{SPAWN_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    for r, p in enumerate(procs):
        text = (tmp_path / f"{name}.rank{r}.log").read_text()
        assert p.returncode == 0, f"{name} rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return [json.loads((tmp_path / f"{name}.rank{r}.out.json").read_text())
            for r in range(world)]


def assert_no_failures(results: list) -> None:
    bad = [f"rank {r}: {f}" for r, res in enumerate(results) for f in res["failures"]]
    assert not bad, "\n".join(bad)
    assert all(res["checks"] > 0 for res in results)


# -- in this process: the pure functions ------------------------------------------

def test_balanced_shards_is_the_references():
    from repro.data import corpus as JC
    from repro_torch.data import corpus as TC
    from repro_torch.data.synthetic import planted_topics_corpus

    c, _ = planted_topics_corpus(np.random.default_rng(0), D=61, V=64,
                                 K_true=4, doc_len=(3, 30))
    ref = JC.Corpus(c.tokens, c.mask, c.V)
    even = TC.Corpus(c.tokens[:48], c.mask[:48], c.V)
    for shards in (1, 2, 3, 4, 8):
        assert np.array_equal(TC.balanced_shards(even, shards),
                              JC.balanced_shards(JC.Corpus(*even), shards))
        got, want = TC.shard_balanced(c, shards), JC.shard_balanced(ref, shards)
        assert np.array_equal(got.tokens, want.tokens)
        assert np.array_equal(got.mask, want.mask)
        assert got.num_docs % shards == 0 and got.num_tokens == c.num_tokens


def test_grid_geometry():
    from repro_torch.launch.mesh import Grid, host_grid_shape

    # make_host_mesh's shapes (repro/launch/mesh.py:37-45)
    assert [host_grid_shape(n) for n in (1, 2, 4, 8, 16, 32)] == [
        (1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (8, 4)]
    g = Grid((2, 2, 2), ("pod", "data", "model"), 5)
    assert g.coords() == (1, 0, 1) and g.index("model") == 1
    assert g.index(("pod", "data")) == 2 and g.index(g.axes) == 5
    assert g.lines("model") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert g.lines(("pod", "data")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert g.lines(g.axes) == [list(range(8))]
    assert Grid.for_world(8, 3).shape == (4, 2)
    with pytest.raises(ValueError, match="holds 4 ranks"):
        Grid.for_world(8, 0, shape=(2, 2))


def test_nccl_refuses_two_ranks_on_one_card():
    from repro_torch.launch.mesh import check_backend

    cuda0 = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        check_backend("nccl", cuda0, local_rank=0, local_world_size=2,
                      device_count=1)
    with pytest.raises(ValueError, match="runs on cuda:1"):
        check_backend("nccl", cuda0, local_rank=1, local_world_size=2,
                      device_count=2)
    with pytest.raises(ValueError, match="NCCL runs on CUDA tensors"):
        check_backend("nccl", torch.device("cpu"), local_rank=0,
                      local_world_size=1, device_count=0)
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", cuda0, local_rank=0, local_world_size=1,
                      device_count=1)
    check_backend("nccl", cuda0, local_rank=0, local_world_size=1, device_count=1)
    check_backend("gloo", cuda0, local_rank=1, local_world_size=4, device_count=1)
    check_backend("gloo", torch.device("cpu"), local_rank=0, local_world_size=2,
                  device_count=0)


def test_streams_are_pure_and_distinct():
    from repro_torch.core.sharded import stream

    def draw(*args):
        return torch.rand(4, generator=stream(*args, "cpu"))

    assert torch.equal(draw(0, 3, "u", 1), draw(0, 3, "u", 1))
    seen = [draw(*a) for a in ((0, 3, "u", 1), (0, 3, "u", 2), (0, 4, "u", 1),
                               (0, 3, "phi", 1), (1, 3, "u", 1))]
    assert all(not torch.equal(a, b) for i, a in enumerate(seen) for b in seen[i + 1:])


# -- in child processes: the grids ---------------------------------------------------

@pytest.mark.parametrize("world,grids", [
    (1, [[(1, 1), ("data", "model"), True]]),
    (2, [[(2, 1), ("data", "model"), True], [(1, 2), ("data", "model"), True]]),
    (4, [[(2, 2), ("data", "model"), True]]),
], ids=["1x1", "2x1+1x2", "2x2"])
def test_grid_is_the_one_process_chain_and_keeps_its_invariants(
        tmp_path, tmp_path_factory, world, grids):
    results = spawn(tmp_path, tmp_path_factory, f"grids{world}", world,
                    {"grids": grids, "reference": None})
    assert_no_failures(results)
    for name, info in results[0]["info"].items():
        print(name, info)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ShardedHDP sub-steps on (4, 2) and (2, 2, 2), per
    device, from one child process with 8 host devices."""
    out = tmp_path_factory.mktemp("sharded_reference") / "reference.npz"
    code = REFERENCE.format(consts=(K, V, BUCKET, HIST_CAP, SHARDS),
                            variants=REF_VARIANTS, grids=REF_GRIDS)
    with one_spawn_at_a_time(tmp_path_factory):
        p = subprocess.run(
            [sys.executable, "-c", code, str(out)], capture_output=True,
            text=True, timeout=SPAWN_TIMEOUT_S, cwd=ROOT,
            env=child_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                          JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stdout + p.stderr
    return out


def test_reference_sub_steps_on_4x2_and_2x2x2(tmp_path, tmp_path_factory,
                                              reference):
    # (4, 2) against the reference only; (2, 2, 2) also as the other grids
    grids = [[shape, axes, len(shape) == 3] for shape, axes in REF_GRIDS.values()]
    results = spawn(tmp_path, tmp_path_factory, "grids8", 8,
                    {"grids": grids, "reference": str(reference)})
    assert_no_failures(results)
    for name, info in results[0]["info"].items():
        print(name, info)


def test_torchrun_two_ranks_print_one_summary():
    args = ["--hdp", "ap", "--scale", "0.01", "--iters", "2", "--topics", "20",
            "--max-len", "64", "--device", "cpu", "--log-every", "1"]
    out = subprocess.run(
        [*NICE, sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args],
        env=child_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    summaries = [json.loads(x) for x in lines if x.startswith("{\"")]
    assert len(summaries) == 1, lines
    s = summaries[0]
    assert s["ranks"] == 2 and s["backend"] == "gloo" and s["iters"] == 2
    assert s["grid"] == {"data": 2, "model": 1} and s["device"] == "cpu"
    assert s["tokens"] == 3962 and s["tokens_per_s"] > 0
    assert sum(x.startswith("{'iter'") for x in lines) == 2


# -- the ranks ------------------------------------------------------------------------

class Findings:
    """What a rank found: each failed check, and numbers to print."""

    def __init__(self):
        self.failures: list[str] = []
        self.checks = 0
        self.info: dict = {}

    def true(self, cond, what: str) -> None:
        self.checks += 1
        if not bool(cond):
            self.failures.append(what)

    def equal(self, got, want, what: str) -> None:
        got, want = (torch.as_tensor(x).cpu() for x in (got, want))
        same = got.shape == want.shape and got.dtype == want.dtype
        ok = same and torch.equal(got, want)
        self.true(ok, f"{what}: {got.dtype}{tuple(got.shape)} != "
                      f"{want.dtype}{tuple(want.shape)}"
                      + (f", {int((got != want).sum())} entries differ" if same else ""))


def _reconstruct_pmf(prob, alias):
    prob = np.asarray(prob, np.float64)
    r, k = prob.shape
    ph = prob / k
    np.add.at(ph, (np.repeat(np.arange(r), k), np.asarray(alias).reshape(-1)),
              ((1 - prob) / k).reshape(-1))
    return ph


def _pmf_errors(w, prob, alias):
    """Per word with mass, |alias pmf - w / sum(w)| at its worst slot."""
    w = np.asarray(w, np.float64)
    live = w.sum(1) > 0
    tgt = w[live] / w[live].sum(1, keepdims=True)
    return np.abs(_reconstruct_pmf(prob, alias)[live] - tgt).max(1)


def _table_pmf_errors(q_a, fpack, ipack, apsi):
    vals = fpack[:, 0].to(torch.float32).numpy()
    ids = ipack[:, 0].to(torch.int64).numpy()
    w = vals * apsi.numpy()[ids]
    return _pmf_errors(w, fpack[:, 1].to(torch.float32).numpy(),
                       ipack[:, 1].to(torch.int64).numpy())


def _rank_main(spec_path: str, name: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    tmp = Path(spec_path).parent
    spec = json.loads(Path(spec_path).read_text())
    dist.init_process_group("gloo", init_method=f"file://{tmp / (name + '.pg')}",
                            rank=rank, world_size=world)
    found = Findings()
    try:
        _run_grids(spec, rank, world, found)
    finally:
        dist.destroy_process_group()
    (tmp / f"{name}.rank{rank}.out.json").write_text(json.dumps(
        {"failures": found.failures, "checks": found.checks, "info": found.info}))


@functools.lru_cache(maxsize=1)
def _corpus():
    from repro_torch.data.corpus import shard_balanced
    from repro_torch.data.synthetic import planted_topics_corpus

    c, _ = planted_topics_corpus(np.random.default_rng(0), D=60, V=V, K_true=4,
                                 doc_len=(15, 30))
    c = shard_balanced(c, SHARDS)
    return torch.from_numpy(c.tokens), torch.from_numpy(c.mask)


def _run_grids(spec, rank, world, found: Findings) -> None:
    from repro_torch.core import hdp as H
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.sharded import ShardedHDP
    from repro_torch.launch.mesh import Grid

    tokens, mask = _corpus()
    cpu = torch.device("cpu")
    for shape, axes, chain in spec["grids"]:
        grid = Grid(tuple(shape), tuple(axes), rank)
        tag = "x".join(map(str, shape))
        comm = Collectives(grid, "gloo", cpu)
        if chain:
            _check_collectives(comm, tag, found)
        m = grid.size("model")
        if m > 1:
            try:
                ShardedHDP(comm, H.HDPConfig(K=K, V=V - 1, bucket=BUCKET))
                found.true(False, f"{tag}: V={V - 1} on model {m} did not raise")
            except ValueError as e:
                found.true("must divide model axis" in str(e), f"{tag}: {e}")
        for vname, (impl, aik, compact, phi_dtype) in VARIANTS.items():
            cfg = H.HDPConfig(K=K, V=V, bucket=BUCKET, z_impl=impl,
                              hist_cap=HIST_CAP, alias_in_kernel=aik)
            sh = ShardedHDP(comm, cfg, compact_tables=compact, phi_dtype=phi_dtype)
            rows = sh.doc_rows(tokens.shape[0])
            if chain:
                _check_one_process_chain(sh, tokens, mask, rows, f"{tag} {vname}", found)
            if chain and vname in ("table", "dense"):
                _check_invariants(sh, tokens, mask, rows, f"{tag} {vname}", found)
            if chain and vname in ("table", "compact"):
                _check_masked_tables(sh, f"{tag} {vname}", found)
            if spec["reference"] and vname in REF_VARIANTS:
                _check_reference(sh, np.load(spec["reference"]), tag, vname, found)


def _check_collectives(comm, tag: str, found: Findings) -> None:
    """psum, all_gather and the psum_scatter composition over each axis
    set, in integers and floats, against values every rank can compute."""
    grid = comm.grid
    world = grid.world_size

    def block(r, dtype):
        # dyadic values: every sum is exact, in any order
        g = torch.Generator().manual_seed(100 + r)
        x = torch.randint(-64, 64, (6, 8), generator=g).to(dtype)
        return x / 4 if dtype.is_floating_point else x

    for axes in (("model",), tuple(a for a in grid.axes if a != "model"), grid.axes):
        line = next(ranks for ranks in grid.lines(axes) if grid.rank in ranks)
        size, i = len(line), grid.index(axes)
        for dtype in (torch.int32, torch.int64, torch.float32):
            what = f"{tag} {axes} {dtype}"
            x = block(grid.rank, dtype)
            total = sum(block(r, dtype) for r in line).to(dtype)
            found.equal(comm.psum(x, axes), total, f"{what} psum")
            for dim in (0, 1):
                found.equal(comm.all_gather(x, axes, dim),
                            torch.cat([block(r, dtype) for r in line], dim),
                            f"{what} all_gather dim {dim}")
            if x.shape[1] % size == 0:
                got = comm.psum_scatter(x, axes, 1)
                found.equal(got, total.chunk(size, 1)[i].contiguous(),
                            f"{what} psum_scatter")
                found.equal(got, comm.reduce_scatter(x, axes, 1),
                            f"{what} psum_scatter == gloo's reduce_scatter")
        for dtype in (torch.int16, torch.bfloat16, torch.bool):
            x = block(grid.rank, torch.float32).to(dtype)
            found.equal(comm.all_gather(x, axes, 0).view(torch.uint8),
                        torch.cat([block(r, torch.float32).to(dtype)
                                   for r in line]).view(torch.uint8),
                        f"{tag} {axes} {dtype} all_gather")
    found.true(comm.sent == {}, f"{tag}: unlabelled calls counted {dict(comm.sent)}")
    found.info[f"{tag} collectives"] = f"checked on {world} ranks"


def _full_start(seed: int):
    """A whole state every rank builds alike: z random over K - 1, its
    counts, Psi from the prior."""
    from repro_torch.core import hdp as H
    from repro_torch.core.stick import gem_prior_sample

    tokens, mask = _corpus()
    z = torch.from_numpy(np.where(mask.numpy(), np.random.default_rng(seed).integers(
        0, K - 1, tuple(tokens.shape)), 0).astype(np.int32))
    n = H.count_n(z, tokens, mask, K, V)
    psi = gem_prior_sample(H.make_generator(seed, "cpu"), K, 1.0)
    return z, n, psi


def _check_one_process_chain(sh, tokens, mask, rows, tag: str, found: Findings):
    """Given the one-process chain's draws, one iteration on the grid is
    bitwise ``gibbs_iteration`` (compact tables and a bf16 phi, which it
    does not take: its sub-steps)."""
    from repro_torch.core import hdp as H
    from repro_torch.core import sharded as SH
    from repro_torch.core.polya_urn import ppu_counts, ppu_normalize
    from repro_torch.core.sharded import ShardState
    from repro_torch.core.stick import sample_l, sample_psi
    from repro_torch.kernels.hdp_z import ops as zops

    cfg, cols = sh.cfg, sh.vocab_cols
    z, n, psi = _full_start(1)
    l0 = torch.zeros(K, dtype=torch.int32)
    zero = torch.zeros((K, V))
    # gibbs_iteration's draws: varphi, then u, then l and Psi
    gen = H.make_generator(3, "cpu")
    varphi = ppu_counts(gen, n, cfg.beta)
    u = torch.rand(tuple(tokens.shape) + (3,), generator=gen)
    if not sh.compact_tables and sh.phi_dtype == torch.float32:
        want = H.gibbs_iteration(
            H.HDPState(z=z, n=n, phi=zero, varphi=zero.int(), psi=psi, l=l0,
                       gen=H.make_generator(3, "cpu"), it=0), tokens, mask, cfg)
        dh_want = H.d_histogram(H.doc_topic_counts(want.z, mask, K), cfg.hist_cap)
    else:
        phi = ppu_normalize(varphi).to(sh.phi_dtype)
        ztables = ((phi,) if cfg.z_impl == "dense" else
                   zops.build_word_sparse_tables(phi, psi, cfg.alpha, cfg.bucket,
                                                 compact=True))
        z_new, m, dn = SH.z_sweep_u(cfg, ztables, z, tokens, mask, psi, u,
                                    in_kernel=False)
        if dn is None:
            dn = H.delta_n(z, z_new, tokens, mask, K, V)
        g2 = H.make_generator(0, "cpu")
        g2.set_state(gen.get_state())
        dh_want = H.d_histogram(m, cfg.hist_cap)
        l = sample_l(g2, dh_want, psi, cfg.alpha)
        want = H.HDPState(z=z_new, n=n + dn, phi=phi, varphi=varphi,
                          psi=sample_psi(g2, l, cfg.gamma), l=l, gen=None, it=1)
    state = ShardState(z=z[rows], n=n[:, cols], phi=zero[:, cols],
                       varphi=zero[:, cols].int(), psi=psi, l=l0, seed=0, it=0)
    got = sh.iteration(state, tokens[rows], mask[rows], varphi=varphi[:, cols],
                       u=u[rows], gen=gen)
    z_all, n_all = _gathered(sh, got)
    if sh.grid.rank == 0:
        found.equal(z_all, want.z, f"{tag}: z")
        found.equal(n_all, want.n, f"{tag}: n")
    found.equal(got.phi, want.phi[:, cols], f"{tag}: phi shard")
    found.equal(got.varphi, want.varphi[:, cols], f"{tag}: varphi shard")
    found.equal(sh.last["dh"], dh_want, f"{tag}: dh")
    found.equal(got.l, want.l, f"{tag}: l")
    found.equal(got.psi, want.psi, f"{tag}: psi")
    everyone = sh.comm.all_gather(torch.cat([got.psi, got.l.float()])[None],
                                  sh.grid.axes, 0)
    found.true(bool((everyone == everyone[0]).all()), f"{tag}: psi, l differ across ranks")
    found.true(sh.last["bytes"] == sh.iteration_bytes(),
               f"{tag}: bytes {sh.last['bytes']} != {sh.iteration_bytes()}")
    found.info[f"{tag} bytes"] = sh.last["bytes"]


def _check_masked_tables(sh, tag: str, found: Findings) -> None:
    """The block-sparse table build (``u_mask``, the reference's
    ``phi_tables_masked_fn``) on the vocabulary shards, gathered, is
    bitwise the one-process masked build."""
    from repro_torch.core import hdp as H
    from repro_torch.core.polya_urn import ppu_counts, ppu_normalize
    from repro_torch.kernels.hdp_z import ops as zops

    cfg, cols = sh.cfg, sh.vocab_cols
    _, n, psi = _full_start(1)
    varphi = ppu_counts(H.make_generator(5, "cpu"), n, cfg.beta)
    u_mask = torch.from_numpy(np.random.default_rng(6).random(V) < 0.5)
    got = sh.ztables(sh.phi_step(varphi[:, cols]), psi, u_mask[cols])
    want = zops.build_word_sparse_tables_masked(
        ppu_normalize(varphi), psi, cfg.alpha, cfg.bucket, u_mask,
        compact=sh.compact_tables)
    for name, a, b in zip(("q_a", "fpack", "ipack"), got, want):
        found.equal(a, b, f"{tag}: masked {name}")
    found.true(bool((got[0][~u_mask] == 0).all()), f"{tag}: unflagged rows built")


def _gathered(sh, state):
    got = sh.gather_state(state)
    return got if got is not None else (None, None)


def _check_invariants(sh, tokens, mask, rows, tag: str, found: Findings):
    """8 iterations of the grid's own chain from the single-topic init,
    as tests/test_multidevice.py holds the reference's."""
    from repro_torch.core import hdp as H

    cfg = sh.cfg
    full = H.init_state(H.make_generator(4, "cpu"), tokens, mask, cfg)
    state = sh.init_state(4, tokens[rows], mask[rows])
    for f in ("z", "n", "phi", "varphi"):
        want = getattr(full, f)
        want = want[rows] if f == "z" else want[:, sh.vocab_cols]
        found.equal(getattr(state, f), want, f"{tag}: init {f}")
    found.equal(state.psi, full.psi, f"{tag}: init psi")

    def ppll(st):
        z, n = _gathered(sh, st)
        if z is None:
            return None
        return float(H.posterior_predictive_ll(
            H.HDPState(z=z, n=n, phi=None, varphi=None, psi=st.psi, l=None,
                       gen=None, it=st.it), tokens, mask, cfg))

    ll0 = ppll(state)
    for _ in range(ITERS):
        state = sh.iteration(state, tokens[rows], mask[rows])
        z, n = _gathered(sh, state)
        if z is not None:
            found.equal(n, H.count_n(z, tokens, mask, K, V), f"{tag}: it {state.it} n")
            found.true(int(n.sum()) == int(mask.sum()), f"{tag}: it {state.it} tokens")
            flag = int(n[-1].sum())
    ll1 = ppll(state)
    if ll0 is not None:
        found.true(ll1 > ll0, f"{tag}: ll {ll0} -> {ll1}")
        found.info[f"{tag} ppll, flag tokens"] = [ll0, ll1, flag]


def _check_reference(sh, ref, tag: str, vname: str, found: Findings):
    """Fed the reference's PPU draws and uniforms, the sub-steps against
    the reference's ``ShardedHDP`` on the same mesh, device by device."""
    r, cols, cfg = sh.grid.rank, sh.vocab_cols, sh.cfg
    key = f"{tag}/{vname}"

    def dev(field):
        a = ref[f"{key}/{field}"][r]
        return torch.from_numpy(a)

    tokens, mask = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["mask"])
    rows = sh.doc_rows(tokens.shape[0])
    z, n = torch.from_numpy(ref["z"])[rows], torch.from_numpy(ref["n"])[:, cols]
    psi = torch.from_numpy(ref["psi"])
    tokens, mask = tokens[rows], mask[rows]
    found.equal(dev("varphi"), dev("varphi_t"), f"{key}: the reference's two draws")
    phi = sh.phi_step(dev("varphi"))
    found.equal(phi, dev("phi"), f"{key}: phi shard")
    ztables = sh.ztables(phi, psi)
    ref_tables = tuple(dev(f"zt{i}") for i in range(len(ztables)))
    if vname in ("prologue", "dense"):
        for i, (a, b) in enumerate(zip(ztables, ref_tables)):
            found.equal(a, b, f"{key}: gathered operand {i}")
    else:
        q_a, fpack, ipack = ztables
        rq, rf, ri = ref_tables
        found.equal(fpack[:, 0], rf[:, 0], f"{key}: table supports")
        found.equal(ipack[:, 0], ri[:, 0], f"{key}: table ids")
        found.true(np.allclose(q_a.numpy(), rq.numpy(), rtol=1e-6, atol=0),
                   f"{key}: q_a")
        apsi = cfg.alpha * psi
        err_t = _table_pmf_errors(q_a, fpack, ipack, apsi)
        err_j = _table_pmf_errors(rq, rf, ri, apsi)
        found.true((err_t <= np.maximum(err_j, 1e-6)).all(),
                   f"{key}: pmf error {err_t.max()} against {err_j.max()}")
        found.info[f"{key} pmf error"] = [float(err_t.max()), float(err_j.max())]
    z_new, m, dn = sh.z_sweep_u(ref_tables, z, tokens, mask, psi, dev("u"))
    dn_shard, dh = sh.block_stats(z, z_new, m, tokens, mask, dn)
    for name, got in (("z_new", z_new), ("m", m), ("dn_shard", dn_shard),
                      ("dh", dh), ("n_next", n + dn_shard)):
        found.equal(got, dev(name), f"{key}: {name}")


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
