"""LM training sharded over a grid of ranks (the port's counterpart of
``jax.jit(step, in_shardings=...)`` in ``repro/launch/train.py``).

Placement. Every parameter, and both AdamW moments, is placed by
``launch/mesh.py::train_rules`` on the rank's ``Grid``: a rank holds
exactly its slice (``shard_slices``) of each leaf, as the reference's
``NamedSharding`` places it. The batch is split by ``batch_shardings``.

The step, one rank's part of it:

  * Before each block runs, in the forward pass and in the
    ``torch.utils.checkpoint`` recompute of the backward pass, the
    block's leaves are all-gathered over the grid axes their spec uses
    (``_Gather``); the gathered copies are freed when the block is done.
    The embedding table and the final norm are gathered once a step.
  * After a block's backward pass each leaf's gradient is summed over
    the axes that split the batch (``pod``, ``data``, where the batch
    divides them) and sliced to the rank's spec. Ranks along ``model``
    compute the same rows, so nothing is summed over ``model``.
    Tensor-parallel compute over ``model`` is not done: each rank
    computes its batch rows whole.
  * The MoE layers take capacity and places over the global batch
    (``models/moe.py::global_batch``): each rank's cumsum starts from the
    per-expert counts of the rows before its own.
  * The loss is the global masked mean: the summed cross-entropy and the
    mask count are summed over the batch axes before the division.
  * The gradient norm sums each shard's squares over the axes that shard
    its leaf (a replicated leaf counts once); AdamW, elementwise, updates
    each shard in place. The NaN skip reads global values, so every rank
    decides alike.

Every collective goes through ``core/collectives.py::Collectives``, whose
``sent`` counts this rank's bytes by the labels below. At world 1 every
collective is skipped and the step is, op for op, the one-process
``train/trainer.py::make_train_step``.

Checkpoints are at logical shape, in the one-process format
(``params/<name>``, ``mu/<name>``, ``nu/<name>``, ``step``): the leaves
are gathered one at a time and rank 0 writes them; a restore reads each
rank's slices, onto any grid.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from types import SimpleNamespace
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.collectives import Collectives
from repro_torch.launch import mesh as MESH
from repro_torch.launch.mesh import Grid, Spec
from repro_torch.models import blocks as BLK
from repro_torch.models import lm as LM
from repro_torch.models import moe as MOE
from repro_torch.models.config import LMConfig
from repro_torch.models.layers import init_embedding, init_rmsnorm
from repro_torch.train import checkpoint as CKPT
from repro_torch.train.optimizer import AdamWConfig, adamw_update
from repro_torch.train.trainer import Trainer

# labels of Collectives.sent
BYTES_GATHER = "all_gather params [spec axes]"
BYTES_GRADS = "psum grads [batch axes]"
BYTES_LOSS = "psum loss terms [batch axes]"
BYTES_NORM = "psum grad norm [spec axes]"
BYTES_MOE = "all_gather expert counts [batch axes]"
BYTES_CKPT = "all_gather checkpoint leaves"


def axis_sets(grid: Grid) -> list[tuple[str, ...]]:
    """Every non-empty set of the grid's axes (in grid order): the
    process groups the sharded step may reduce or gather over."""
    return [c for n in range(1, len(grid.axes) + 1)
            for c in itertools.combinations(grid.axes, n)]


def make_comm(grid: Grid, backend: str, device: torch.device) -> Collectives:
    """The ``Collectives`` of a sharded LM run (a group for every axis
    set); every rank must call it, in the same order as its other
    ``new_group`` calls."""
    return Collectives(grid, backend, device, axis_sets=axis_sets(grid))


def _live(grid: Grid, axes: Iterable[str]) -> tuple[str, ...]:
    """``axes`` of size above 1, in grid order: the ones a collective
    must cross."""
    names = set(axes)
    return tuple(a for a in grid.axes if a in names and grid.size(a) > 1)


def param_specs(cfg: LMConfig, grid: Grid) -> dict[str, Spec]:
    """Each parameter's ``Spec`` under ``train_rules`` (the moments take
    the same)."""
    return MESH.shardings_for_tree(LM.param_shapes(cfg), LM.param_axes(cfg),
                                   MESH.train_rules(grid), grid)


class Layout:
    """Where one rank's shards sit: for each leaf its full shape, spec,
    slices and the dims it is gathered over."""

    def __init__(self, cfg: LMConfig, comm: Collectives):
        self.cfg = cfg
        self.comm = comm
        self.grid = comm.grid
        self.shapes = LM.param_shapes(cfg)
        self.specs = param_specs(cfg, self.grid)
        self.slices = {k: MESH.shard_slices(self.shapes[k], sp, self.grid)
                       for k, sp in self.specs.items()}
        # (dim, axes) for every dim whose entry spans more than one rank;
        # Collectives gathers in grid order, so an entry must list its
        # axes in that order
        self.gathers = {}
        for k, sp in self.specs.items():
            dims = []
            for d, entry in enumerate(sp):
                live = tuple(a for a in MESH.as_axes(entry or ())
                             if self.grid.size(a) > 1)
                if live != _live(self.grid, live):
                    raise ValueError(f"{k}: entry {entry} is not in grid order")
                if live:
                    dims.append((d, live))
            self.gathers[k] = tuple(dims)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full leaf, a tensor of its own."""
        return full[self.slices[name]].clone()

    def gather(self, name: str, shard: torch.Tensor,
               label: str | None = BYTES_GATHER) -> torch.Tensor:
        """The full leaf from every rank's shard (no autograd)."""
        full = shard
        for d, axes in self.gathers[name]:
            full = self.comm.all_gather(full, axes, d, label=label)
        return full


class _Gather(torch.autograd.Function):
    """A leaf gathered whole from the ranks' shards; its gradient summed
    over the batch axes and sliced back to the rank's shard."""

    @staticmethod
    def forward(ctx, shard, layout: Layout, name: str, batch: tuple):
        ctx.layout, ctx.name, ctx.batch = layout, name, batch
        full = layout.gather(name, shard)
        return shard.clone() if full is shard else full

    @staticmethod
    def backward(ctx, g):
        layout = ctx.layout
        if ctx.batch:
            g = layout.comm.psum(g, ctx.batch, label=BYTES_GRADS)
        return g[layout.slices[ctx.name]].contiguous(), None, None, None


def _tree(flat: dict[str, torch.Tensor]) -> SimpleNamespace:
    """Dotted names as nested attributes (``attn.wq`` -> ns.attn.wq), the
    form the block functions read."""
    root = SimpleNamespace()
    for key, val in flat.items():
        node = root
        *path, leaf = key.split(".")
        for part in path:
            if not hasattr(node, part):
                setattr(node, part, SimpleNamespace())
            node = getattr(node, part)
        setattr(node, leaf, val)
    return root


class ShardedLM(LM.CausalLM):
    """The LM's forward over one rank's shards: a ``CausalLM`` whose
    blocks gather their leaves when they run (``lm_loss`` takes it as it
    takes the model). ``batch`` names the grid axes that split this
    step's batch, over which gradients are summed."""

    def __init__(self, layout: Layout, params: dict[str, torch.Tensor],
                 batch: tuple[str, ...]):
        torch.nn.Module.__init__(self)
        self.cfg = layout.cfg
        self.layout = layout
        self.shards = params
        self.batch = batch
        self.embed = self._gathered("embed.")
        self.final_norm = self._gathered("final_norm.")

    def _leaf(self, name: str) -> torch.Tensor:
        if not self.layout.gathers[name] and not self.batch:
            return self.shards[name]  # nothing to cross: the leaf itself
        return _Gather.apply(self.shards[name], self.layout, name, self.batch)

    def _gathered(self, prefix: str) -> SimpleNamespace:
        return _tree({k[len(prefix):]: self._leaf(k) for k in self.shards
                      if k.startswith(prefix)})

    def _block_train(self, i: int, x: torch.Tensor, positions: torch.Tensor):
        return BLK.block_train(self._gathered(f"blocks.{i}."), self.cfg, x,
                               positions)


@dataclasses.dataclass
class ShardedTrainState:
    """One rank's shards of the parameters (leaves that take gradients)
    and of the float32 moments, by parameter name, and the step."""
    params: dict
    mu: dict
    nu: dict
    step: int = 0


def _zeros_like_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def init_sharded_state(seed: int, layout: Layout,
                       device: torch.device) -> ShardedTrainState:
    """The rank's shards of the model ``CausalLM(cfg, Generator(seed))``
    initializes, and zero moments: every leaf drawn whole in the same
    order from the same generator, one block at a time, then sliced."""
    cfg = layout.cfg
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}

    def take(prefix, module):
        for k, p in module.named_parameters():
            params[prefix + k] = layout.shard(prefix + k, p.detach())

    take("embed.", init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype))
    for i in range(cfg.num_layers):
        take(f"blocks.{i}.", BLK.Block(gen, cfg))
    take("final_norm.", init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device))
    for p in params.values():
        p.requires_grad_(True)
    return ShardedTrainState(params, _zeros_like_f32(params),
                             _zeros_like_f32(params), 0)


def shard_train_state(state, layout: Layout) -> ShardedTrainState:
    """The rank's shards of a whole ``train/trainer.py::TrainState``."""
    params = {k: layout.shard(k, p.detach()).requires_grad_(True)
              for k, p in state.params.items()}
    return ShardedTrainState(
        params, {k: layout.shard(k, v) for k, v in state.mu.items()},
        {k: layout.shard(k, v) for k, v in state.nu.items()}, state.step)


def gather_params(state: ShardedTrainState, layout: Layout) -> dict:
    """Every parameter whole, on every rank (every rank must call it)."""
    with torch.no_grad():
        return {k: layout.gather(k, p.detach(), label=None)
                for k, p in state.params.items()}


def sharded_global_norm(grads: dict, layout: Layout) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares over all ranks' shards:
    each leaf's shard sums are added over the axes that shard it (one
    psum for each set of axes), then the leaves are added in order, as
    ``train/optimizer.py::global_norm`` adds them."""
    sq = {k: torch.sum(g.float() ** 2) for k, g in grads.items()}
    groups: dict[tuple, list[str]] = {}
    for k in grads:
        axes = _live(layout.grid, (a for _, ax in layout.gathers[k] for a in ax))
        groups.setdefault(axes, []).append(k)
    for axes, names in groups.items():
        if axes:
            tot = layout.comm.psum(torch.stack([sq[k] for k in names]), axes,
                                   label=BYTES_NORM)
            sq.update(zip(names, tot.unbind(0)))
    return torch.sqrt(sum(sq[k] for k in grads))


def batch_split(grid: Grid, batch_shapes: dict) -> tuple[dict, tuple[str, ...]]:
    """The batch leaves' specs (``batch_shardings``) and the grid axes of
    size above 1 that split the batch."""
    specs = MESH.batch_shardings(grid, batch_shapes, MESH.train_rules(grid))
    lead = specs["tokens"][0]
    return specs, _live(grid, MESH.as_axes(lead) if lead is not None else ())


def local_batch(grid: Grid, batch: dict) -> dict:
    """This rank's rows of a global batch (numpy or tensors)."""
    specs, _ = batch_split(grid, {k: v.shape for k, v in batch.items()})
    return {k: v[MESH.shard_slices(v.shape, specs[k], grid)]
            for k, v in batch.items()}


def _before_counts(comm: Collectives, axes: tuple[str, ...]):
    def before(counts: torch.Tensor) -> torch.Tensor:
        every = comm.all_gather(counts[None], axes, 0, label=BYTES_MOE)
        return every[:comm.grid.index(axes)].sum(dim=0, dtype=torch.int32)
    return before


def make_sharded_train_step(opt: AdamWConfig, layout: Layout, global_batch: int):
    """(state, batch) -> (state, metrics), ``batch`` this rank's rows of a
    global batch of ``global_batch`` sequences (``local_batch``). The
    metrics are global: the same on every rank."""
    grid, comm = layout.grid, layout.comm
    _, split = batch_split(grid, {"tokens": (global_batch, 1)})
    ranks = grid.size(split) if split else 1

    def train_step(state: ShardedTrainState, batch: dict):
        model = ShardedLM(layout, state.params, split)
        moe_ctx = (MOE.global_batch(ranks, _before_counts(comm, split)) if split
                   else contextlib.nullcontext())
        with moe_ctx:
            total, count = LM.lm_loss_terms(model, batch["tokens"], batch["targets"],
                                            batch["mask"], batch.get("embeds"))
            if split:
                terms = comm.psum(torch.stack([total.detach(), count]), split,
                                  label=BYTES_LOSS)
                g_total, g_count = terms[0], terms[1]
            else:
                g_total, g_count = total.detach(), count
            denom = torch.clamp_min(g_count, 1.0)
            shards = list(state.params.values())
            grads = dict(zip(state.params, torch.autograd.grad(total / denom, shards)))
        loss = g_total / denom
        gnorm = sharded_global_norm(grads, layout)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        for k in grads:
            grads[k] = torch.where(ok, grads[k], 0.0)
        # the norm of the zeroed gradients is 0: the one-process step's
        # second global_norm, without its collectives
        gnorm = torch.where(ok, gnorm, 0.0)
        gnorm = adamw_update(opt, grads, state.mu, state.nu, state.params,
                             state.step, ok, gnorm=gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped": (~ok).to(torch.int32)}
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


# -- checkpoints at logical shape --------------------------------------------------

def _leaf_names(state: ShardedTrainState):
    for group in ("params", "mu", "nu"):
        for k in getattr(state, group):
            yield group, k


def save_sharded(ckpt_dir: str, state: ShardedTrainState, layout: Layout, *,
                 keep: int = 3) -> Optional[str]:
    """Every leaf gathered to logical shape, one at a time, and written by
    rank 0 in the one-process format; every rank must call it. Returns
    the path on rank 0."""
    comm = layout.comm

    def items():
        with torch.no_grad():
            for group, k in _leaf_names(state):
                full = layout.gather(k, getattr(state, group)[k], label=BYTES_CKPT)
                yield f"{group}/{k}", full
        yield "step", np.int32(state.step)

    path = None
    if comm.grid.rank == 0:
        path = CKPT.save_items(ckpt_dir, state.step, items(), keep=keep)
    else:
        for _ in items():
            pass
    if comm.grid.world_size > 1:
        dist.barrier()
    return path


def restore_sharded(ckpt_dir: str, layout: Layout, device: torch.device,
                    step: int | None = None) -> Optional[ShardedTrainState]:
    """This rank's slices of a logical-shape checkpoint (by default the
    latest; None when there is none), onto the layout's grid, each leaf
    in the dtype it was stored in."""
    if step is None:
        step = CKPT.latest_step(ckpt_dir)
        if step is None:
            return None

    def load(group, k):
        t = CKPT.load_slice(ckpt_dir, step, f"{group}/{k}", layout.slices[k])
        return t.to(device)

    params = {k: load("params", k).requires_grad_(True) for k in layout.shapes}
    mu = {k: load("mu", k) for k in layout.shapes}
    nu = {k: load("nu", k) for k in layout.shapes}
    got = int(CKPT.load_array(ckpt_dir, step, "step"))
    return ShardedTrainState(params, mu, nu, got)


class ShardedTrainer(Trainer):
    """``train/trainer.py::Trainer`` on one rank of a grid: the same loop,
    its checkpoints at logical shape (``save_sharded``), resumed on any
    grid (``restore_sharded``). The history is the same on every rank."""

    def __init__(self, cfg: LMConfig, opt: AdamWConfig, layout: Layout,
                 step_fn, **kw):
        super().__init__(cfg, opt, step_fn, device=layout.comm.device, **kw)
        self.layout = layout

    def restore_or_init(self, seed: int) -> ShardedTrainState:
        """The latest checkpoint's state, else a new one from ``seed``."""
        if self.checkpoint_dir:
            got = restore_sharded(self.checkpoint_dir, self.layout, self.device)
            if got is not None:
                return got
        return init_sharded_state(seed, self.layout, self.device)

    def save(self, state: ShardedTrainState) -> None:
        save_sharded(self.checkpoint_dir, state, self.layout)
