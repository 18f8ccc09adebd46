"""Collectives over the named axes of a ``Grid`` (counterparts of
``jax.lax.psum``, ``all_gather(..., tiled=True)`` and
``psum_scatter(..., tiled=True)`` inside ``shard_map``).

``Collectives(grid, backend, device)`` makes the process groups once,
every rank calling ``new_group`` for every group in the same order: one
group for each line of the axis sets the sampler reduces over, the last
axis (``model``) and the axes before it, and for each further axis set
the caller names (``axis_sets``; the sharded LM trainer names every
set); all axes are the default group. Every call takes the rank's
tensor on ``device`` and returns one there.

  * ``"nccl"``: every rank on a card of its own; the native calls.
  * ``"gloo"``: CPU tensors, or CUDA tensors of ranks that share one
    card. gloo moves host memory, so each CUDA tensor is staged through a
    pinned host buffer: copied out, reduced or gathered there, copied
    back. ``psum_scatter`` is composed from ``all_reduce`` and a slice
    (gloo has no reduce-scatter in older torch releases; the composition
    runs on every release and moves the whole tensor a rank).

``all_gather`` moves bytes (a ``uint8`` view of the tensor), so int16 and
bfloat16 tables, which the backends' reductions do not all take, gather
as they are. ``sent`` adds up the bytes of the tensors this rank hands to
the collectives, by label, until the caller clears it.

``TracingCollectives`` is one rank of a grid with no process group: each
call allocates and counts what the real one does and moves nothing, so
``launch/dryrun.py`` traces a rank's step on fake tensors and reads its
bytes from the code that runs on the card.
"""

from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import BACKENDS, Grid, as_axes


class Collectives:
    """The collectives of one rank of ``grid`` on ``backend``, its tensors
    on ``device``."""

    # the calls that move the bytes (``torch.distributed``'s)
    wire = dist

    def __init__(self, grid: Grid, backend: str, device: torch.device,
                 axis_sets=()):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: the port runs {BACKENDS}")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA tensors, not {device}")
        if dist.get_world_size() != grid.world_size or dist.get_rank() != grid.rank:
            raise ValueError(
                f"grid of {grid.world_size} ranks at rank {grid.rank}, the "
                f"process group {dist.get_world_size()} at {dist.get_rank()}")
        self._setup(grid, backend, device)
        for key in self._group_keys(axis_sets):
            for ranks in grid.lines(key):
                group = dist.new_group(ranks)
                if grid.rank in ranks:
                    self._groups[key] = group

    def _setup(self, grid: Grid, backend: str, device: torch.device) -> None:
        self.grid = grid
        self.backend = backend
        self.device = device
        self.stage = backend == "gloo" and device.type == "cuda"
        self.sent: dict[str, int] = defaultdict(int)
        self._groups: dict[tuple[str, ...], dist.ProcessGroup | None] = {
            grid.axes: None}

    def _group_keys(self, axis_sets) -> list[tuple[str, ...]]:
        """The axis sets that get groups of their own beyond the default
        one, in the order every rank creates them."""
        keys = []
        for key in (self.grid.axes[-1:], self.grid.axes[:-1],
                    *(self._key(a) for a in axis_sets)):
            if key and key not in self._groups and key not in keys:
                keys.append(key)
        return keys

    def _key(self, axes: str | tuple[str, ...]) -> tuple[str, ...]:
        names = as_axes(axes)
        return tuple(a for a in self.grid.axes if a in names)

    def _group(self, axes) -> tuple[dist.ProcessGroup | None, int]:
        key = self._key(axes)
        if key not in self._groups:
            raise ValueError(f"no process group over {key}: the groups are "
                             f"{sorted(self._groups)}")
        return self._groups[key], self.grid.size(key)

    def _count(self, label: str | None, x: torch.Tensor) -> None:
        if label is not None:
            self.sent[label] += x.numel() * x.element_size()

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of a CUDA tensor, for gloo (which moves host
        memory); a contiguous CPU tensor as it is."""
        if not self.stage:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host

    def _all_reduce(self, x: torch.Tensor, axes, label: str | None, op) -> torch.Tensor:
        group, _ = self._group(axes)
        self._count(label, x)
        buf = self._host(x)
        if buf is x:
            buf = x.clone()
        self.wire.all_reduce(buf, op=op, group=group)
        return buf.to(self.device)

    def psum(self, x: torch.Tensor, axes, label: str | None = None) -> torch.Tensor:
        """Sum over ``axes``; every rank of a line gets the sum."""
        return self._all_reduce(x, axes, label, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes, label: str | None = None) -> torch.Tensor:
        """Elementwise maximum over ``axes``; every rank of a line gets it."""
        return self._all_reduce(x, axes, label, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axes, dim: int,
                   label: str | None = None) -> torch.Tensor:
        """The line's tensors concatenated along ``dim`` in the order of
        their ``index(axes)`` (tiled)."""
        group, size = self._group(axes)
        self._count(label, x)
        xb = self._host(x).view(torch.uint8)
        parts = [torch.empty_like(xb) for _ in range(size)]
        self.wire.all_gather(parts, xb, group=group)
        return torch.cat(parts, dim=dim).view(x.dtype).to(self.device)

    def psum_scatter(self, x: torch.Tensor, axes, dim: int,
                     label: str | None = None) -> torch.Tensor:
        """The sum over ``axes``, split into equal blocks along ``dim``;
        the rank at ``index(axes)`` i keeps block i (tiled)."""
        _, size = self._group(axes)
        if x.shape[dim] % size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {size} ranks")
        self._count(label, x)
        if self.backend == "gloo":
            return self.psum(x, axes).chunk(size, dim)[self.grid.index(axes)].contiguous()
        return self.reduce_scatter(x, axes, dim)

    def reduce_scatter(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``psum_scatter`` by the backend's own reduce-scatter: NCCL's
        path, and on gloo (where the torch release has it) the native form
        that the tests hold the composition to."""
        group, size = self._group(axes)
        blocks = [c.contiguous() for c in x.chunk(size, dim)]
        out = torch.empty_like(blocks[self.grid.index(axes)])
        self.wire.reduce_scatter(out, blocks, group=group)
        return out


class _NoWire:
    """Stands in for ``torch.distributed``'s calls: moves nothing."""

    @staticmethod
    def all_reduce(buf, op=None, group=None) -> None:
        pass

    @staticmethod
    def all_gather(parts, x, group=None) -> None:
        pass

    @staticmethod
    def reduce_scatter(out, blocks, group=None) -> None:
        pass


class TracingCollectives(Collectives):
    """Rank ``grid.rank``'s collectives with no process group: the same
    calls, allocations and ``sent`` counts as ``Collectives`` on NCCL, the
    card's backend, with tensors that nothing fills (the caller traces on
    fake tensors, whose values do not exist)."""

    wire = _NoWire

    def __init__(self, grid: Grid, device: torch.device, axis_sets=()):
        self._setup(grid, "nccl", device)
        for key in self._group_keys(axis_sets):
            self._groups[key] = None
