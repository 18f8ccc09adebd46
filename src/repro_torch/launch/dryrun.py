"""The port's dry run: one rank's step of every (architecture x input
shape x grid) cell and every HDP cell, on the CPU, on fake tensors
(counterpart of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.json

Nothing is allocated on any device and no process group is made. The
grids are the production ones, ``(data, model) = (16, 16)`` (``--mesh
single``) and ``(pod, data, model) = (2, 16, 16)`` (``--mesh multi``),
each a ``launch/mesh.py::Grid`` for rank 0.

An LM cell traces the step the port runs, under
``torch._subclasses.fake_tensor.FakeTensorMode``:

  * ``train``: ``train/sharding.py::make_sharded_train_step`` on rank 0's
    shards of the parameters and moments and its rows of the batch. Its
    collectives go through ``core/collectives.py::TracingCollectives``,
    which allocates and counts (``Collectives.sent``) what the real ones
    do and moves nothing: the bytes come from the code that runs on the
    card.
  * ``prefill`` and ``decode``: ``CausalLM.prefill`` and ``decode_step``
    on rank 0's rows. The port serves a model whole on each card (its
    serving is not sharded), so the trace holds every parameter.

Inside the trace ``torch.utils.flop_counter.FlopCounterMode`` counts the
matrix products, and ``LiveBytes``, a dispatch mode of this module,
counts the bytes of live storages (each rounded up to the caching
allocator's 512-byte blocks): the peak is the prediction of
``torch.cuda.max_memory_allocated`` for the step. On the card the kernel
wrappers launch kernels; on fake CPU tensors they would run the plain
versions, whose (B, H, S, S) scores the flash kernel never allocates.
So within the trace the kernels' forwards are the custom operators
``repro_torch::flash_fwd`` and ``repro_torch::ssd_intra_chunk``, whose
fake implementations return the kernels' outputs and whose FLOP formulas
are those of the plain versions' products (``kernels_as_operators``);
the card's dispatch is left as it is. The backward passes are the plain
VJPs (``FlashAttentionFn``, ``SSDIntraChunkFn``), which do hold the
scores on the card, and the trace counts them. Every layer is traced.

An HDP cell is not traced: the iteration's table builds and draws have
data-dependent shapes. Its record gives rank 0's bytes of
``core/sharded.py::ShardState``, of its corpus rows and of the z-step's
operands, and one iteration's bytes a collective from
``core/sharded.py::iteration_bytes`` (what ``ShardedHDP.last["bytes"]``
holds).

Each record has the reference's keys where they mean the same thing
(``arch``, ``shape``, ``mesh``, ``model_flops``, ``params``, ``status``,
``reason``, ``memory``, ``collectives``, ``wall_s``), ``fits`` (the
predicted peak against the card's 80 GB; a cell that does not fit is a
finding, its status ``ok``) and ``left_out`` (what has no counterpart).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
import weakref
from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import (HDP_CELLS, SHAPES, SMOKE_SHAPES,
                                        HDPCell, cell_applicable)
from repro_torch.core import hdp as H
from repro_torch.core import sharded as SH
from repro_torch.core.collectives import TracingCollectives
from repro_torch.kernels.flash_attention import ops as FAO
from repro_torch.kernels.flash_attention.ops import _forward as _flash_forward
from repro_torch.kernels.ssd import ops as SSDO
from repro_torch.kernels.ssd.ssd import ssd_intra_chunk
from repro_torch.launch import mesh as MESH
from repro_torch.launch.mesh import AXES_2D, AXES_3D, Grid
from repro_torch.models import lm as LM
from repro_torch.train import sharding as SHD
from repro_torch.train.optimizer import AdamWConfig

# the card's memory: an NVIDIA H100 80GB HBM3
CARD_BYTES = 80 * 10**9
# the CUDA caching allocator rounds every block up to this
ALLOC_BLOCK = 512
GRIDS = {False: ((16, 16), AXES_2D), True: ((2, 16, 16), AXES_3D)}
TRACKER = "LiveBytes: the port's dispatch mode over live storages"
LEFT_OUT = [
    "compile and lower time: the port runs eagerly, nothing is compiled",
    "XLA's generated_code_size",
    "HLO bytes accessed and elementwise FLOPs: FlopCounterMode counts the "
    "matrix products only",
    "the HLO collective parser: the bytes are Collectives.sent of the traced step",
    "act_mode and rule_overrides: the port's step has no sequence- or "
    "tensor-parallel compute to steer (ROADMAP A1)",
]


def mesh_name(grid: Grid) -> str:
    return "x".join(map(str, grid.shape))


def production_grid(multi_pod: bool, rank: int = 0) -> Grid:
    shape, axes = GRIDS[multi_pod]
    return Grid(shape, axes, rank)


# ---------------------------------------------------------------------------
# model-FLOPs estimates (the reference's arithmetic)
# ---------------------------------------------------------------------------

def param_counts(cfg) -> dict:
    """Analytic parameter counts (total, active-per-token)."""
    d, l = cfg.d_model, cfg.num_layers
    emb = cfg.vocab_size * d
    attn = 0
    if cfg.attn_active:
        attn = d * cfg.head_dim * (cfg.num_heads * 2 + cfg.num_kv_heads * 2)
    mlp_tot = mlp_act = 0
    if cfg.block_type == "moe":
        gated = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        per_e = gated * d * cfg.expert_d_ff
        mlp_tot = cfg.num_experts * per_e + cfg.shared_experts * per_e
        mlp_act = cfg.top_k * per_e + cfg.shared_experts * per_e
        mlp_tot += d * cfg.num_experts
    elif cfg.d_ff:
        gated = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        mlp_tot = mlp_act = gated * d * cfg.d_ff
    ssm = 0
    if cfg.ssm_active:
        d_inner = cfg.ssm_expand * d
        heads = d_inner // cfg.ssm_head_dim
        ssm = d * (2 * d_inner + 2 * cfg.ssm_state + heads) + d_inner * d
    if mlp_act == 0:
        mlp_act = mlp_tot
    total = emb + l * (attn + mlp_tot + ssm)
    active = emb + l * (attn + mlp_act + ssm)
    return {"total": int(total), "active": int(active)}


def model_flops(cfg, cell) -> float:
    """6*N_active*D tokens for train; 2*N_active*tokens for inference."""
    pc = param_counts(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * pc["active"] * tokens


class TensorSpec(NamedTuple):
    """An input's shape and dtype (no memory)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg, cell) -> dict:
    """Abstract model inputs for one cell (the global batch)."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind in ("train", "prefill"):
        s_tok = s - cfg.prefix_len
        spec = {"tokens": TensorSpec((b, s_tok), torch.int32)}
        if cell.kind == "train":
            spec["targets"] = TensorSpec((b, s_tok), torch.int32)
            spec["mask"] = TensorSpec((b, s_tok), torch.bool)
        if cfg.prefix_len:
            spec["embeds"] = TensorSpec((b, cfg.prefix_len, cfg.d_model), cfg.cdtype)
        return spec
    # decode: one token against a cache of length s
    return {"token": TensorSpec((b,), torch.int32), "fill": TensorSpec((), torch.int32)}


# ---------------------------------------------------------------------------
# the kernels as operators, for tracing
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    """The flash forward as the wrapper dispatches it."""
    return _flash_forward(q, k, v, causal, window)


@flash_fwd.register_fake
def _(q, k, v, causal, window):
    # the kernel's output: a new contiguous (B, Hq, S, D) tensor
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    """The plain version's two products over every (query, key) pair of
    each query head: 2 * 2 * B * Hq * S * S * D."""
    b, h, s, d = q_shape
    return 4 * b * h * s * s * d


@torch.library.custom_op("repro_torch::ssd_intra_chunk", mutates_args=())
def ssd_intra_chunk_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SSD intra-chunk pass as the wrapper dispatches it."""
    return ssd_intra_chunk(x, dt, a, bmat, cmat, chunk=chunk)


@ssd_intra_chunk_op.register_fake
def _(x, dt, a, bmat, cmat, chunk):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.float32
    return (x.new_empty((b, s, h, p), dtype=f32),
            x.new_empty((b, s // chunk, h, n, p), dtype=f32),
            x.new_empty((b, s, h), dtype=f32))


@register_flop_formula(torch.ops.repro_torch.ssd_intra_chunk)
def _ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, *args, **kwargs) -> int:
    """The plain version's three products a chunk: C B^T (cl x cl x N),
    the scores by x dt (cl x cl x P) and the chunk state (N x P x cl)."""
    b, s, h, p = x_shape
    n = b_shape[-1]
    chunk = args[0] if args else kwargs["chunk"]
    nc = s // chunk
    return 2 * b * nc * h * chunk * (chunk * n + chunk * p + n * p)


@contextlib.contextmanager
def fake_init():
    """Within it, ``nn.init.trunc_normal_`` leaves its tensor as it is:
    its rejection loop reads values back (``mask.any()``), which fake
    tensors do not have. The parameters' shapes and dtypes are the
    model's own."""
    old = torch.nn.init.trunc_normal_
    torch.nn.init.trunc_normal_ = lambda t, *args, **kwargs: t
    try:
        yield
    finally:
        torch.nn.init.trunc_normal_ = old


@contextlib.contextmanager
def kernels_as_operators():
    """Within it, the flash and SSD forwards go through the custom
    operators above (the kernels' outputs on fake tensors)."""
    old = FAO._forward, SSDO.ssd_intra_chunk
    FAO._forward = lambda q, k, v, causal, window: flash_fwd(q, k, v, causal, window)
    SSDO.ssd_intra_chunk = lambda x, dt, a, b, c, *, chunk: ssd_intra_chunk_op(
        x, dt, a, b, c, chunk)
    try:
        yield
    finally:
        FAO._forward, SSDO.ssd_intra_chunk = old


# ---------------------------------------------------------------------------
# live bytes
# ---------------------------------------------------------------------------

def alloc_bytes(nbytes: int) -> int:
    """An allocation as the caching allocator counts it."""
    return -(-max(int(nbytes), 1) // ALLOC_BLOCK) * ALLOC_BLOCK


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive while it is active: every storage
    an op creates, and those ``hold`` registers, until freed. ``peak`` is
    the largest total it reached."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0

    def hold(self, *tensors) -> None:
        for t in tree_flatten(tensors)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = alloc_bytes(st.nbytes())
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.hold(out)
        return out


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _local_rows(grid: Grid, rules: dict, global_batch: int) -> int:
    spec = MESH.batch_shardings(grid, {"tokens": (global_batch, 1)}, rules)["tokens"]
    return MESH.shard_shape((global_batch, 1), spec, grid)[0]


def _fake_batch(cfg, kind: str, rows: int, seq_len: int) -> dict:
    s_tok = seq_len - cfg.prefix_len
    out = {"tokens": torch.zeros((rows, s_tok), dtype=torch.int32)}
    if kind == "train":
        out["targets"] = torch.zeros((rows, s_tok), dtype=torch.int32)
        out["mask"] = torch.ones((rows, s_tok), dtype=torch.bool)
    if cfg.prefix_len:
        out["embeds"] = torch.zeros((rows, cfg.prefix_len, cfg.d_model), dtype=cfg.cdtype)
    return out


def trace_train(cfg, grid: Grid, global_batch: int, seq_len: int) -> dict:
    """Rank ``grid.rank``'s ``make_sharded_train_step`` on a global batch
    of ``global_batch`` sequences of ``seq_len`` positions: its state's
    bytes, the traced peak, FLOPs and bytes a collective."""
    cpu = torch.device("cpu")
    comm = TracingCollectives(grid, cpu, axis_sets=SHD.axis_sets(grid))
    layout = SHD.Layout(cfg, comm)
    rows = _local_rows(grid, MESH.train_rules(grid), global_batch)
    with FakeTensorMode(), kernels_as_operators():
        with fake_init():
            state = SHD.init_sharded_state(0, layout, cpu)
        batch = _fake_batch(cfg, "train", rows, seq_len)
        step = SHD.make_sharded_train_step(AdamWConfig(), layout, global_batch)
        # the placement train_rules gives each leaf (param_specs), bf16 or
        # float32 as the leaf, its gradient alike, the moments float32
        shards = {k: MESH.shard_shape(layout.shapes[k], layout.specs[k], grid)
                  for k in state.params}
        params = sum(_nbytes(shards[k], p.dtype) for k, p in state.params.items())
        moments = sum(_nbytes(shape, torch.float32) for shape in shards.values())
        state_bytes = {"params": params, "grads": params, "mu": moments, "nu": moments,
                       "batch": sum(t.nbytes for t in batch.values())}
        mem = LiveBytes()
        mem.hold(state.params, state.mu, state.nu, batch)
        with mem, FlopCounterMode(display=False) as fc:
            _, metrics = step(state, batch)
            del metrics
        flops = fc.get_total_flops()
    return {"step": "train/sharding.py::make_sharded_train_step", "local_rows": rows,
            "state_bytes": state_bytes, "peak_bytes": mem.peak, "flops": int(flops),
            "collectives": dict(comm.sent)}


def trace_serve(cfg, kind: str, grid: Grid, global_batch: int, seq_len: int) -> dict:
    """Rank ``grid.rank``'s ``CausalLM.prefill`` (``kind`` "prefill") or
    ``decode_step`` (one token at the cache's last position) on its rows
    of the batch, the model whole. ``state_bytes`` is what the serving
    rules would place on the rank: the parameters' shards, and for decode
    the KV cache's shard; the batch's rows."""
    cpu = torch.device("cpu")
    rules = MESH.serve_rules(grid)
    rows = _local_rows(grid, rules, global_batch)
    cache_len = min(seq_len, cfg.window) if cfg.window else seq_len
    specs = MESH.shardings_for_tree(LM.param_shapes(cfg), LM.param_axes(cfg), rules, grid)
    with FakeTensorMode(), kernels_as_operators(), torch.inference_mode():
        with fake_init():
            model = LM.CausalLM(cfg, torch.Generator(device=cpu).manual_seed(0))
        params = dict(model.named_parameters())
        state_bytes = {"params": sum(
            _nbytes(MESH.shard_shape(p.shape, specs[k], grid), p.dtype)
            for k, p in params.items())}
        mem = LiveBytes()
        mem.hold(params)
        if kind == "prefill":
            batch = _fake_batch(cfg, "prefill", rows, seq_len)
            state_bytes["batch"] = sum(t.nbytes for t in batch.values())
            mem.hold(batch)
            with mem, FlopCounterMode(display=False) as fc:
                out = model.prefill(batch["tokens"], cache_len, batch.get("embeds"))
                del out
        else:
            cache = model.init_cache(rows, cache_len)
            shards = MESH.kv_cache_shardings(grid, cfg, {
                k: tuple(t.shape) for k, t in cache[0].items()}, rules)
            state_bytes["kv_cache"] = cfg.num_layers * sum(
                _nbytes(MESH.shard_shape(t.shape, shards[k], grid), t.dtype)
                for k, t in cache[0].items())
            token = torch.zeros((rows,), dtype=torch.int32)
            state_bytes["batch"] = token.nbytes
            mem.hold(cache, token)
            with mem, FlopCounterMode(display=False) as fc:
                out = model.decode_step(token, cache, cache_len - 1)
                del out
        flops = fc.get_total_flops()
    step = "models/lm.py::CausalLM." + ("prefill" if kind == "prefill" else "decode_step")
    return {"step": step, "local_rows": rows, "state_bytes": state_bytes,
            "peak_bytes": mem.peak, "flops": int(flops), "collectives": {}}


def _memory(traced: dict) -> dict:
    peak = traced["peak_bytes"]
    return {"state_bytes": traced["state_bytes"],
            "state_total": sum(traced["state_bytes"].values()),
            "peak_bytes": peak, "peak_gib": peak / 2**30, "tracker": TRACKER,
            "card_bytes": CARD_BYTES}


def trace_lm(cfg, kind: str, grid: Grid, global_batch: int, seq_len: int) -> dict:
    """One rank's step of ``kind`` as a record's ``memory``, ``flops``,
    ``collectives`` and ``fits``."""
    if kind == "train":
        traced = trace_train(cfg, grid, global_batch, seq_len)
    else:
        traced = trace_serve(cfg, kind, grid, global_batch, seq_len)
    return {"step": traced["step"], "rank": grid.rank,
            "grid": dict(zip(grid.axes, grid.shape)), "local_rows": traced["local_rows"],
            "memory": _memory(traced), "fits": traced["peak_bytes"] <= CARD_BYTES,
            "flops": traced["flops"], "collectives": traced["collectives"]}


def lm_cell(arch: str, shape_name: str, multi_pod: bool, smoke: bool = False) -> dict:
    cfg = get_config(arch, smoke=smoke)
    cell = (SMOKE_SHAPES if smoke else SHAPES)[shape_name]
    grid = production_grid(multi_pod)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name(grid),
              "model_flops": model_flops(cfg, cell), "params": param_counts(cfg)}
    ok, reason = cell_applicable(cfg, cell)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        return record
    record.update(trace_lm(cfg, cell.kind, grid, cell.global_batch, cell.seq_len))
    record["status"] = "ok"
    record["left_out"] = LEFT_OUT
    return record


# ---------------------------------------------------------------------------
# HDP cells
# ---------------------------------------------------------------------------

def hdp_cell(cell_name: str, multi_pod: bool, z_impl: str = "cuda", smoke: bool = False,
             **kw) -> dict:
    """One HDP cell of ``HDP_CELLS`` (at smoke size: V = D = 1024, L = 64,
    K = 32) on a production grid: ``hdp_record``'s fields."""
    cell = HDP_CELLS[cell_name]
    if smoke:
        cell = cell._replace(V=1024, D=1024, max_len=64, K=32)
    return hdp_record(cell, production_grid(multi_pod), z_impl=z_impl, **kw)


def hdp_record(cell: HDPCell, grid: Grid, *, z_impl: str = "cuda", bucket: int = 64,
               device: torch.device = torch.device("cuda")) -> dict:
    """Rank ``grid.rank``'s bytes of one Gibbs iteration of ``ShardedHDP``
    (float32 Phi and tables) with the reference's config of the cell
    (``hist_cap`` min(L, 256)), its z-step's mode as
    ``alias_in_kernel="auto"`` resolves on ``device`` (the card by
    default; nothing is allocated there)."""
    cfg = H.HDPConfig(K=cell.K, V=cell.V, bucket=bucket, z_impl=z_impl,
                      hist_cap=min(cell.max_len, 256))
    sh = SH.ShardedHDP(TracingCollectives(grid, torch.device(device)), cfg)
    record = {"arch": cell.name, "shape": "gibbs_iteration", "mesh": mesh_name(grid),
              "config": cfg._asdict(), "z_impl": z_impl, "alias_in_kernel": sh.in_kernel,
              # z-step work estimate: tokens * (alias O(1) + bucket scan)
              "model_flops": float(cell.D) * cell.max_len * 3 * 64}
    ranks, m = grid.world_size, grid.size(SH.MODEL)
    if cell.D % ranks:
        raise ValueError(f"{cell.D} documents do not split over {ranks} ranks")
    d, length, k, vm = cell.D // ranks, cell.max_len, cell.K, cell.V // m
    w = min(bucket, cell.K)
    i32 = 4
    state = {"z": d * length * i32, "n": k * vm * i32, "phi": k * vm * 4,
             "varphi": k * vm * i32, "psi": k * 4, "l": k * i32}
    if z_impl == "dense":
        tables = k * cell.V * 4
    elif sh.in_kernel:
        tables = k * 4 + cell.V * w * (4 + 4)
    else:
        tables = cell.V * 4 + 2 * cell.V * 2 * w * 4
    zstep = {"tables": tables, "uniforms": d * length * 3 * 4, "z_new": d * length * i32,
             "m": d * k * i32, "dn": k * cell.V * i32}
    corpus = d * length * (i32 + 1)
    total = sum(state.values()) + corpus + sum(zstep.values())
    record.update({
        "status": "ok", "rank": grid.rank, "grid": dict(zip(grid.axes, grid.shape)),
        "memory": {"state_bytes": state, "corpus_bytes": corpus, "zstep_bytes": zstep,
                   "total_bytes": total, "card_bytes": CARD_BYTES},
        "fits": total <= CARD_BYTES,
        "collectives": sh.iteration_bytes(), "collectives_exact": True,
        "traced": False,
        "reason": "not traced on fake tensors: the iteration's table builds and "
                  "draws have data-dependent shapes; the bytes are "
                  "core/sharded.py::iteration_bytes",
        "left_out": LEFT_OUT[:4]})
    return record


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _error(arch: str, shape: str, multi_pod: bool, e: Exception) -> dict:
    return {"arch": arch, "shape": shape, "mesh": mesh_name(production_grid(multi_pod)),
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "trace": traceback.format_exc()[-2000:]}


def run_cells(archs, shapes, meshes, out_path: Optional[str], smoke=False,
              hdp=(), z_impl="cuda") -> list:
    results = []

    def done(rec, t0):
        rec["wall_s"] = round(time.time() - t0, 1)
        results.append(rec)
        _report(rec)
        if out_path:
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)

    for multi_pod in meshes:
        for name in hdp:
            t0 = time.time()
            try:
                rec = hdp_cell(name, multi_pod, z_impl=z_impl, smoke=smoke)
            except Exception as e:
                rec = _error(name, "gibbs_iteration", multi_pod, e)
            done(rec, t0)
        for arch in archs:
            for shape in shapes:
                t0 = time.time()
                try:
                    rec = lm_cell(arch, shape, multi_pod, smoke=smoke)
                except Exception as e:
                    rec = _error(arch, shape, multi_pod, e)
                done(rec, t0)
    return results


def _report(rec: dict) -> None:
    s = rec.get("status")
    extra = ""
    if s == "ok":
        mem = rec["memory"]
        peak = mem.get("peak_bytes", mem.get("total_bytes", 0))
        cb = sum(rec.get("collectives", {}).values())
        fl = rec.get("flops")
        extra = (f"peak={peak / 2**30:.2f}GiB fits={rec['fits']} coll={cb / 1e6:.1f}MB"
                 + (f" flops={fl:.3g}" if fl is not None else ""))
    elif s == "error":
        extra = rec.get("error", "")[:160]
    elif s == "skipped":
        extra = rec.get("reason", "")[:80]
    print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {s} "
          f"({rec.get('wall_s', '?')}s) {extra}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--hdp", default=None, help="comma-separated HDP cells (or 'all')")
    ap.add_argument("--z-impl", default="cuda", choices=H.Z_IMPLS)
    ap.add_argument("--smoke", action="store_true", help="reduced configs (CI sanity)")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        archs, shapes, hdp = ARCHS, list(SHAPES), list(HDP_CELLS)
    else:
        archs = [args.arch] if args.arch and args.arch in set(ARCHS) else []
        shapes = [args.shape] if args.shape else list(SHAPES)
        hdp = []
        if args.hdp:
            hdp = list(HDP_CELLS) if args.hdp == "all" else args.hdp.split(",")
        if args.arch and args.arch in HDP_CELLS:
            hdp = [args.arch]
    return run_cells(archs, shapes, meshes, args.out, smoke=args.smoke, hdp=hdp,
                     z_impl=args.z_impl)


if __name__ == "__main__":
    main()
