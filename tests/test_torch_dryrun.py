"""The port's dry run (``launch/dryrun.py``) and shape cells
(``configs/shapes.py``) on the CPU.

  * ``param_counts``, ``model_flops``, ``input_specs`` (shapes and
    dtypes), ``cell_applicable``, ``SHAPES``, ``SMOKE_SHAPES`` and
    ``HDP_CELLS`` for all ten archs x four shapes, smoke and full, equal
    the reference's exactly. The reference's values come from one child
    process for the module that imports ``repro.launch.dryrun`` (which
    sets a 512-device ``XLA_FLAGS`` at import) with ``XLA_FLAGS`` and
    ``JAX_PLATFORMS`` in that child's environment only, and writes JSON.
  * The fake trace's bytes a collective for the sharded LM step at smoke
    depth on (2, 2) and (2, 1, 2), and ``hdp_record``'s for the sampler,
    equal ``Collectives.sent`` of real ranks on gloo running the same
    step (one 4-rank spawn of this file run as a script, under
    ``tests/test_torch_sharded.py``'s lock, with its ``spawn``).
  * The fake trace's FLOPs equal ``FlopCounterMode`` over a real CPU step
    (the plain kernels) at smoke size, at world 1 and on (2, 2).
  * ``--all --smoke --mesh both`` ends with no ``error`` record.

The pytest process starts no process group and sets no environment
variable.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_sharded import (  # noqa: E402
    ROOT, SPAWN_TIMEOUT_S, Findings, assert_no_failures, child_env,
    one_spawn_at_a_time, spawn)

LM_ARCHS = ("deepseek-moe-16b", "hymba-1.5b")
GRIDS = {"2x2": ((2, 2), ("data", "model")), "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# the sampler's cell: D documents of L positions, split over 4 ranks
HDP_CELL = dict(name="tiny", V=64, D=32, max_len=16, K=16)
HDP_BUCKET = 16
B, S = 4, 64

REFERENCE = r"""
import json, sys
from repro.launch import dryrun as D
from repro.configs import ARCHS, get_config
from repro.configs.shapes import HDP_CELLS, SHAPES, SMOKE_SHAPES, cell_applicable

out = {"archs": list(ARCHS),
       "shapes": {k: list(v) for k, v in SHAPES.items()},
       "smoke_shapes": {k: list(v) for k, v in SMOKE_SHAPES.items()},
       "hdp_cells": {k: list(v) for k, v in HDP_CELLS.items()}, "cells": {}}
for smoke in (False, True):
    for arch in ARCHS:
        cfg = get_config(arch, smoke=smoke)
        for name, cell in (SMOKE_SHAPES if smoke else SHAPES).items():
            out["cells"][f"{arch}/{name}/{int(smoke)}"] = {
                "params": D.param_counts(cfg), "model_flops": D.model_flops(cfg, cell),
                "applicable": list(cell_applicable(cfg, cell)),
                "input_specs": {k: [list(v.shape), str(v.dtype)]
                                for k, v in D.input_specs(cfg, cell).items()}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_reference") / "reference.json"
    with one_spawn_at_a_time(tmp_path_factory):
        p = subprocess.run(
            [sys.executable, "-c", REFERENCE, str(out)], capture_output=True, text=True,
            timeout=SPAWN_TIMEOUT_S, cwd=ROOT,
            env=child_env(XLA_FLAGS="--xla_force_host_platform_device_count=512",
                          JAX_PLATFORMS="cpu"))
    assert p.returncode == 0, p.stdout + p.stderr
    return json.loads(out.read_text())


# -- in this process ------------------------------------------------------------------

def test_shape_cells_are_the_references(reference):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import HDP_CELLS, SHAPES, SMOKE_SHAPES

    assert list(ARCHS) == reference["archs"]
    assert {k: list(v) for k, v in SHAPES.items()} == reference["shapes"]
    assert {k: list(v) for k, v in SMOKE_SHAPES.items()} == reference["smoke_shapes"]
    assert {k: list(v) for k, v in HDP_CELLS.items()} == reference["hdp_cells"]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_counts_flops_specs_and_applicability_are_the_references(reference, smoke):
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.shapes import SHAPES, SMOKE_SHAPES, cell_applicable
    from repro_torch.launch import dryrun as DR

    for arch in ARCHS:
        cfg = get_config(arch, smoke=smoke)
        for name, cell in (SMOKE_SHAPES if smoke else SHAPES).items():
            want = reference["cells"][f"{arch}/{name}/{int(smoke)}"]
            got = {"params": DR.param_counts(cfg), "model_flops": DR.model_flops(cfg, cell),
                   "applicable": list(cell_applicable(cfg, cell)),
                   "input_specs": {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                                   for k, v in DR.input_specs(cfg, cell).items()}}
            assert got == want, (arch, name, got, want)


def _real_step_flops(cfg, grid):
    """FlopCounterMode over one real CPU step of rank ``grid.rank`` (the
    kernels' plain versions; a stand-in's collectives, whose values
    change no shape)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.collectives import TracingCollectives
    from repro_torch.data import lm_data as TD
    from repro_torch.train import sharding as SHD
    from repro_torch.train.optimizer import AdamWConfig

    cpu = torch.device("cpu")
    layout = SHD.Layout(cfg, TracingCollectives(grid, cpu, axis_sets=SHD.axis_sets(grid)))
    state = SHD.init_sharded_state(0, layout, cpu)
    bt = TD.SyntheticLMStream(cfg.vocab_size, B, S - cfg.prefix_len, seed=1,
                              prefix_len=cfg.prefix_len, d_model=cfg.d_model).batch(0)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in SHD.local_batch(grid, bt).items()}
    if "embeds" in batch:
        batch["embeds"] = batch["embeds"].to(cfg.cdtype)
    step = SHD.make_sharded_train_step(AdamWConfig(), layout, B)
    with FlopCounterMode(display=False) as fc:
        _, metrics = step(state, batch)
    assert bool(torch.isfinite(metrics["loss"])) or grid.world_size > 1
    return fc.get_total_flops()


@pytest.mark.parametrize("arch,grid", [
    ("hymba-1.5b", "1x1"), ("deepseek-moe-16b", "1x1"), ("starcoder2-3b", "1x1"),
    ("musicgen-medium", "1x1"), ("deepseek-moe-16b", "2x2")])
def test_fake_trace_flops_equal_a_real_cpu_step(arch, grid):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Grid

    cfg = get_config(arch, smoke=True)
    g = Grid((1, 1), ("data", "model"), 0) if grid == "1x1" else Grid(*GRIDS[grid], 0)
    traced = DR.trace_lm(cfg, "train", g, B, S)
    assert traced["flops"] == _real_step_flops(cfg, g) > 0


def test_fake_trace_state_bytes_and_peak():
    """The state's bytes from the specs are the shards' own; the peak
    holds the state and the gradients; world 1 makes no collective."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Grid

    cfg = get_config("deepseek-moe-16b", smoke=True)
    one = DR.trace_lm(cfg, "train", Grid((1, 1), ("data", "model"), 0), B, S)
    four = DR.trace_lm(cfg, "train", Grid(*GRIDS["2x2"], 0), B, S)
    n_params = sum(int(np.prod(s)) for s in DR.LM.param_shapes(cfg).values())
    st1, st4 = one["memory"]["state_bytes"], four["memory"]["state_bytes"]
    assert st1["mu"] == st1["nu"] == 4 * n_params
    assert st4["mu"] < st1["mu"] and st4["batch"] * 2 == st1["batch"]
    for rec in (one, four):
        mem = rec["memory"]
        assert mem["peak_bytes"] >= mem["state_total"] and rec["fits"]
    assert one["collectives"] == {} and four["collectives"]


def test_serve_cells_trace_the_whole_model():
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Grid

    cfg = get_config("hymba-1.5b", smoke=True)
    g = Grid(*GRIDS["2x2"], 0)
    model = DR.LM.CausalLM(cfg, torch.Generator().manual_seed(0))
    whole = sum(DR.alloc_bytes(p.nbytes) for p in model.parameters())
    for kind in ("prefill", "decode"):
        rec = DR.trace_lm(cfg, kind, g, B, S)
        assert rec["local_rows"] == B // 2 and rec["collectives"] == {}
        assert rec["memory"]["state_bytes"]["params"] < whole < rec["memory"]["peak_bytes"]
        assert rec["flops"] > 0


def test_all_smoke_cells_on_both_grids_end_without_an_error(tmp_path):
    out = tmp_path / "dryrun.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--smoke",
         "--mesh", "both", "--out", str(out)],
        env=child_env(), capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    records = json.loads(out.read_text())
    assert len(records) == 2 * (4 + 10 * 4)
    bad = [r for r in records if r["status"] not in ("ok", "skipped")]
    assert not bad, bad[:2]
    for r in records:
        if r["status"] == "skipped":
            assert r["shape"] == "long_500k" and "sub-quadratic" in r["reason"]
        else:
            assert r["left_out"] and "fits" in r and "memory" in r


# -- against real ranks ------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
    results = spawn(tmp, tmp_path_factory, "dryrun4", 4, {}, script=__file__)
    assert_no_failures(results)
    return results


@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("grid", list(GRIDS))
def test_traced_lm_bytes_equal_real_ranks(ranks, arch, grid):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Grid

    cfg = get_config(arch, smoke=True)
    for r, res in enumerate(ranks):
        traced = DR.trace_lm(cfg, "train", Grid(*GRIDS[grid], r), B, S)
        sent = res["info"][f"lm {arch} {grid}"]
        assert sent and traced["collectives"] == sent, (r, traced["collectives"], sent)


@pytest.mark.parametrize("z_impl", ["cuda", "dense"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_hdp_record_bytes_equal_real_ranks(ranks, z_impl, grid):
    from repro_torch.configs.shapes import HDPCell
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import Grid

    for r, res in enumerate(ranks):
        rec = DR.hdp_record(HDPCell(**HDP_CELL), Grid(*GRIDS[grid], r), z_impl=z_impl,
                            bucket=HDP_BUCKET, device=torch.device("cpu"))
        assert rec["collectives"] == res["info"][f"hdp {z_impl} {grid}"]


# -- the ranks ---------------------------------------------------------------------------

def _rank_main(spec_path: str, name: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    tmp = Path(spec_path).parent
    dist.init_process_group("gloo", init_method=f"file://{tmp / (name + '.pg')}",
                            rank=rank, world_size=world)
    found = Findings()
    try:
        _run(rank, found)
    finally:
        dist.destroy_process_group()
    (tmp / f"{name}.rank{rank}.out.json").write_text(json.dumps(
        {"failures": found.failures, "checks": found.checks, "info": found.info}))


def _run(rank: int, found: Findings) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core import hdp as H
    from repro_torch.core.collectives import Collectives
    from repro_torch.core.sharded import ShardedHDP
    from repro_torch.data import lm_data as TD
    from repro_torch.launch.mesh import Grid
    from repro_torch.train import sharding as SHD
    from repro_torch.train.optimizer import AdamWConfig

    cpu = torch.device("cpu")
    rng = np.random.default_rng(0)
    c = HDP_CELL
    tokens = torch.from_numpy(rng.integers(0, c["V"], (c["D"], c["max_len"])).astype(np.int32))
    mask = torch.from_numpy(rng.random((c["D"], c["max_len"])) < 0.8)
    for gname, (shape, axes) in GRIDS.items():
        grid = Grid(shape, axes, rank)
        comm = SHD.make_comm(grid, "gloo", cpu)
        for arch in LM_ARCHS:
            cfg = get_config(arch, smoke=True)
            layout = SHD.Layout(cfg, comm)
            state = SHD.init_sharded_state(0, layout, cpu)
            bt = TD.SyntheticLMStream(cfg.vocab_size, B, S, seed=1).batch(0)
            batch = {k: torch.from_numpy(np.asarray(v))
                     for k, v in SHD.local_batch(grid, bt).items()}
            step = SHD.make_sharded_train_step(AdamWConfig(), layout, B)
            comm.sent.clear()
            _, metrics = step(state, batch)
            found.true(bool(torch.isfinite(metrics["loss"])), f"{arch} {gname}: loss")
            found.info[f"lm {arch} {gname}"] = dict(comm.sent)
        for z_impl in ("cuda", "dense"):
            cfg = H.HDPConfig(K=c["K"], V=c["V"], bucket=HDP_BUCKET, z_impl=z_impl,
                              hist_cap=min(c["max_len"], 256))
            sh = ShardedHDP(Collectives(grid, "gloo", cpu), cfg)
            rows = sh.doc_rows(c["D"])
            st = sh.init_state(2, tokens[rows], mask[rows])
            sh.iteration(st, tokens[rows], mask[rows])
            found.true(bool(sh.last["bytes"]), f"hdp {z_impl} {gname}: bytes")
            found.info[f"hdp {z_impl} {gname}"] = sh.last["bytes"]


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
