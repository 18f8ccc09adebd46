"""The LM half of ``launch/mesh.py``, the parameter and cache axes of
``models/lm.py``, the MoE's global-batch places, the compression wire,
the elastic helpers and the HDP trainer's ``--ckpt`` without ``--stream``,
all in this process (no process group; the grids are specs on paper).

Specs are held to the reference leaf by leaf: each of the ten reference
configs at full size (shapes only, from ``jax.eval_shape``), on the grids
(2, 2), (4, 2), (16, 16) (data, model) and (2, 2, 2), (2, 16, 16) (pod,
data, model), through the reference's own ``spec_for``,
``kv_cache_shardings`` and ``batch_shardings`` on a
``jax.sharding.AbstractMesh`` (no devices; ``make_host_mesh`` is never
called here, and ``repro.launch.dryrun`` is never imported). A port
block leaf's spec is the reference's stacked leaf's without its leading
``layers`` entry, which the rules always leave unsharded.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.compat import AxisType  # noqa: E402
from repro.configs import ARCHS, get_config as jax_config  # noqa: E402
from repro.launch import mesh as JMESH  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.models import lm as LM  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.train import sharding as SHD  # noqa: E402

GRIDS = {"2x2": ((2, 2), MESH.AXES_2D), "4x2": ((4, 2), MESH.AXES_2D),
         "2x2x2": ((2, 2, 2), MESH.AXES_3D), "16x16": ((16, 16), MESH.AXES_2D),
         "2x16x16": ((2, 16, 16), MESH.AXES_3D)}
BATCHES = (1, 4, 6, 32, 64)  # divide none, some and all of the batch axes


def meshes(gname):
    shape, axes = GRIDS[gname]
    return (AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes)),
            MESH.Grid(shape, axes, 0))


def flat_by_name(tree, is_leaf=None):
    return {".".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


@functools.lru_cache(maxsize=None)
def reference_tree(arch):
    """The reference's full-size parameter shapes, flat by its dotted
    names; their axes, flat and as its nested tree; and the shapes of its
    float32 AdamW moments (``adamw_init``)."""
    from repro.train import optimizer as JO

    cfg = jax_config(arch)
    box = {}

    def f():
        params, axes = JLM.init_lm(jax.random.key(0), cfg)
        box["axes"] = axes
        return params, JO.adamw_init(params)

    shapes, moments = jax.eval_shape(f)
    flat_s = {k: v.shape for k, v in flat_by_name(shapes).items()}
    flat_a = flat_by_name(box["axes"], is_leaf=lambda x: isinstance(x, tuple))
    return flat_s, flat_a, box["axes"], moments


def reference_name(name):
    return "blocks." + name.split(".", 2)[2] if name.startswith("blocks.") else name


def as_tuple(pspec, ndim):
    t = tuple(pspec)
    return t + (None,) * (ndim - len(t))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_axes_are_the_references_without_layers(arch):
    cfg = get_config(arch)
    shapes, axes = LM.param_shapes(cfg), LM.param_axes(cfg)
    ref_s, ref_a, _, _ = reference_tree(arch)
    assert list(shapes) == list(axes)
    assert {reference_name(k) for k in shapes} == set(ref_s)
    for k, shape in shapes.items():
        rk = reference_name(k)
        if k.startswith("blocks."):
            assert ref_s[rk] == (cfg.num_layers,) + shape, k
            assert ref_a[rk] == ("layers",) + axes[k], k
        else:
            assert ref_s[rk] == shape and ref_a[rk] == axes[k], k
    # the smoke model's parameters, in named_parameters order
    small = get_config(arch, smoke=True)
    model = LM.CausalLM(small, torch.Generator().manual_seed(0))
    assert [(k, tuple(p.shape)) for k, p in model.named_parameters()] == list(
        LM.param_shapes(small).items())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_are_the_references_on_every_grid(arch):
    cfg = get_config(arch)
    ref_s, ref_a, ref_axes, moments = reference_tree(arch)
    shapes, axes = LM.param_shapes(cfg), LM.param_axes(cfg)
    for gname in GRIDS:
        mesh, grid = meshes(gname)
        rules, jrules = MESH.train_rules(grid), JMESH.train_rules(mesh)
        assert rules == jrules and MESH.batch_axes(grid) == JMESH.batch_axes(mesh)
        specs = MESH.shardings_for_tree(shapes, axes, rules, grid)
        for k, spec in specs.items():
            rk = reference_name(k)
            want = as_tuple(JMESH.spec_for(ref_s[rk], ref_a[rk], jrules, mesh),
                            len(ref_s[rk]))
            if k.startswith("blocks."):
                assert want[0] is None, (gname, k)
                want = want[1:]
            assert spec == want, (gname, k, spec, want)
            assert MESH.shard_shape(shapes[k], spec, grid) == tuple(
                d // (grid.size(e) if e else 1) for d, e in zip(shapes[k], spec))
        # the moments: the reference's shardings of its adamw_init trees
        # against the specs the sharded trainer places mu and nu by
        moment_specs = SHD.param_specs(cfg, grid)
        for moment in moments:
            ref_sh = flat_by_name(JMESH.shardings_for_tree(moment, ref_axes, jrules, mesh))
            for k, spec in moment_specs.items():
                want = as_tuple(ref_sh[reference_name(k)].spec, len(ref_s[reference_name(k)]))
                assert spec == (want[1:] if k.startswith("blocks.") else want), (gname, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_cache_and_batch_specs_are_the_references(arch):
    cfg, jc = get_config(arch), jax_config(arch)
    branches = set()
    for gname in GRIDS:
        mesh, grid = meshes(gname)
        for b in BATCHES:
            for rules, jrules in ((MESH.serve_rules(grid), JMESH.serve_rules(mesh)),
                                  (MESH.train_rules(grid), JMESH.train_rules(mesh))):
                jshapes = jax.eval_shape(lambda: JLM.init_cache(jc, b, 64))
                want = JMESH.kv_cache_shardings(mesh, jc, jshapes, jrules)
                shapes = {k: v.shape[1:] for k, v in jshapes.items()}
                got = MESH.kv_cache_shardings(grid, cfg, shapes, rules)
                assert set(got) == set(want) == set(LM.cache_axes(cfg))
                for k, spec in got.items():
                    w = as_tuple(want[k].spec, len(jshapes[k].shape))
                    assert w[0] is None and spec == w[1:], (gname, b, k, spec, w)
                if cfg.attn_active:
                    branches.add(cfg.num_kv_heads % grid.size("model") == 0)
                bshapes = {"tokens": (b, 16), "targets": (b, 16), "mask": (b, 16),
                           "embeds": (b, 4, 8)}
                jb = JMESH.batch_shardings(
                    mesh, {k: jax.ShapeDtypeStruct(v, jnp.float32)
                           for k, v in bshapes.items()}, jrules)
                got_b = MESH.batch_shardings(grid, bshapes, rules)
                for k, v in bshapes.items():
                    assert got_b[k] == as_tuple(jb[k].spec, len(v)), (gname, b, k)
    print(arch, "kv heads divide the model axis:", sorted(branches))


def test_both_kv_cache_branches_are_taken():
    """chatglm3's 2 kv heads do not divide a 16-way model axis (the cache
    shards its sequence); deepseek's 16 do (the cache shards its heads)."""
    _, grid = meshes("16x16")
    rules = MESH.serve_rules(grid)
    glm = MESH.kv_cache_shardings(grid, get_config("chatglm3-6b"),
                                  {"k": (4, 64, 2, 128), "v": (4, 64, 2, 128)}, rules)
    ds = MESH.kv_cache_shardings(grid, get_config("deepseek-moe-16b"),
                                 {"k": (32, 64, 16, 128), "v": (32, 64, 16, 128)}, rules)
    assert glm["k"] == (None, "model", None, None)
    assert ds["k"] == ("data", None, "model", None)


@pytest.mark.parametrize("gname", list(GRIDS))
def test_shard_slices_tile_every_array_once(gname):
    """The ranks' slices of a leaf split each sharded dim into equal
    blocks that tile it, and every block of the leaf is held by the same
    number of ranks (those that differ only along unused axes)."""
    _, grid = meshes(gname)
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), num_layers=1)
    shapes = LM.param_shapes(cfg)
    specs = MESH.shardings_for_tree(shapes, LM.param_axes(cfg),
                                    MESH.train_rules(grid), grid)
    for k, shape in shapes.items():
        spec = specs[k]
        held = collections.Counter(
            tuple((s.start, s.stop) for s in MESH.shard_slices(shape, spec, grid, r))
            for r in range(grid.world_size))
        blocks = math.prod(grid.size(e) for e in spec if e is not None)
        assert len(held) == blocks and set(held.values()) == {grid.world_size // blocks}
        for d, dim in enumerate(shape):
            edges = sorted({b[d] for b in held})
            assert edges[0][0] == 0 and edges[-1][1] == dim, (k, d)
            assert all(a[1] == b[0] for a, b in zip(edges, edges[1:])), (k, d)


# -- the MoE's places over a global batch ---------------------------------------------

@pytest.mark.parametrize("ranks", [2, 4])
def test_global_batch_places_drop_what_one_device_drops(ranks):
    """Split over ``ranks`` row blocks, each block's places and keep,
    given the per-expert counts of the blocks before it, are the
    one-device ones; the rank's buffer rows stay below min(C, T_rank)."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              capacity_factor=0.5)
    t = 64
    idx = torch.stack([torch.randperm(cfg.num_experts, generator=torch.Generator(
        ).manual_seed(i))[:cfg.top_k] for i in range(t)]).to(torch.int32)
    _, _, pos, keep, _, cap = MOE.places(idx, cfg, t)
    assert 0 < int(keep.sum()) < keep.numel()  # slots drop
    per = t // ranks
    blocks = idx.chunk(ranks)
    counts = [MOE.positions(b, cfg.num_experts, cap)[1].sum(0, dtype=torch.int32)
              for b in blocks]
    got_pos, got_keep = [], []
    for r, b in enumerate(blocks):
        before = torch.stack(counts[:r]).sum(0, dtype=torch.int32) if r else (
            torch.zeros(cfg.num_experts, dtype=torch.int32))
        with MOE.global_batch(ranks, lambda c, before=before: before):
            _, _, p, k, pb, cb = MOE.places(b, cfg, per)
        assert cb == min(cap, per) and bool((pb[k] < cb).all())
        got_pos.append(p)
        got_keep.append(k)
    assert torch.equal(torch.cat(got_pos), pos)
    assert torch.equal(torch.cat(got_keep), keep)


# -- compression, elastic ----------------------------------------------------------------

def test_quantize_is_the_references_and_the_lanes_sum_exactly():
    from repro.train import compression as JCOMP
    from repro_torch.train import compression as COMP

    rng = np.random.default_rng(0)
    x = rng.standard_normal((37, 5)).astype(np.float32)
    x[0, 0] = 0.5 * 3.0 / 127  # ties round to even in both
    scale = np.float32(3.0 / 127)
    want = np.asarray(JCOMP.quantize_int8(jnp.asarray(x), jnp.asarray(scale)))
    got = COMP.quantize_int8(torch.from_numpy(x), torch.tensor(scale))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    # the wire: any MAX_PODS pods' values, extremes too, sum exactly
    pods = COMP.MAX_PODS
    qs = torch.from_numpy(rng.integers(-127, 128, (pods, 4 * 9 + 3)).astype(np.int8))
    qs[:, 0], qs[:, 1] = 127, -127
    words = sum(COMP.pack_lanes(q) for q in qs)  # int64 addition wraps exactly
    assert words.dtype == torch.int64 and words.numel() * 8 == 2 * (4 * 10)
    got = COMP.unpack_lanes(words, qs.shape[1], pods)
    assert torch.equal(got, qs.to(torch.int32).sum(0))


def test_largest_mesh_and_straggler_monitor_are_the_references():
    from repro.train import elastic as JEL
    from repro_torch.train import elastic as EL

    for n in (1, 2, 3, 5, 8, 500, 512):
        for mp in (1, 2, 16):
            try:
                want = JEL.largest_mesh(n, model_parallel=mp)
            except ValueError:
                with pytest.raises(ValueError):
                    EL.largest_mesh(n, model_parallel=mp)
                continue
            assert EL.largest_mesh(n, model_parallel=mp) == want
    rng = np.random.default_rng(1)
    seqs = [[1.0] * 10 + [5.0, 5.0],  # tests/test_train_infra.py's
            list(rng.uniform(0.5, 1.5, 60)) + [4.0] * 5 + [1.0] * 3 + [9.0] * 4,
            list(rng.lognormal(0.0, 0.8, 200))]
    for seq in seqs:
        for kw in (dict(threshold=2.0, breaches_before_action=2),
                   dict(window=8, threshold=1.5, breaches_before_action=3)):
            fired = {"ref": 0, "port": 0}
            ref = JEL.StragglerMonitor(action=lambda: fired.__setitem__(
                "ref", fired["ref"] + 1), **kw)
            port = EL.StragglerMonitor(action=lambda: fired.__setitem__(
                "port", fired["port"] + 1), **kw)
            flags = [(ref.record(t), port.record(t)) for t in seq]
            assert all(a == b for a, b in flags)
            assert (ref.total_breaches, ref.actions_fired, ref.consecutive) == (
                port.total_breaches, port.actions_fired, port.consecutive)
            assert fired["ref"] == fired["port"] == port.actions_fired
    mon = EL.StragglerMonitor()
    assert mon.timed(lambda a, b=1: a + b, 2, b=3) == 5 and len(mon.times) == 1


# -- the HDP trainer's --ckpt without --stream -------------------------------------------

def test_train_hdp_resumes_bitwise_from_its_checkpoint(tmp_path):
    """2 iterations, a checkpoint, 2 more from it: bitwise 4 in one run
    (z, n, phi, varphi, psi, l and the generator's state)."""
    from repro_torch.launch import train as LT

    base = ["--hdp", "ap", "--scale", "0.01", "--topics", "20", "--max-len", "64",
            "--device", "cpu", "--log-every", "1"]
    whole, _, _ = LT.main([*base, "--iters", "4"])
    ck = str(tmp_path / "ck")
    first, _, _ = LT.main([*base, "--iters", "2", "--ckpt", ck])
    from repro_torch.train import checkpoint as CKPT
    assert CKPT.all_steps(ck) == [1, 2]
    part, hist, _ = LT.main([*base, "--iters", "2", "--ckpt", ck])
    assert part.it == whole.it == 4 and [h["iter"] for h in hist] == [3, 4]
    for f in ("z", "n", "phi", "varphi", "psi", "l"):
        assert torch.equal(getattr(part, f), getattr(whole, f)), f
    assert torch.equal(part.gen.get_state(), whole.gen.get_state())
    assert CKPT.all_steps(ck) == [2, 3, 4]
