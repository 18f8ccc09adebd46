"""The rank grid and the logical-axis sharding rules (counterpart of
``repro/launch/mesh.py``).

A ``Grid`` lays the ranks of a ``torch.distributed`` world out on named
axes, ``(data, model)`` or ``(pod, data, model)``, in row-major order:
rank r sits at ``np.unravel_index(r, shape)``, the last axis fastest, as
a JAX mesh orders its devices. ``host_grid_shape`` gives the shape that
``make_host_mesh`` gives a host's devices. Importing this module touches
no process group; ``init_distributed`` starts one, after
``check_backend`` has refused a layout the backend cannot run.

The LM half maps logical axes (``models/lm.py::param_axes``,
``cache_axes``) to grid axes as the reference does: ``train_rules`` and
``serve_rules`` name the grid axes of each logical axis, ``spec_for``
turns one array's (shape, axes) into a ``Spec``, skipping a grid axis
that does not divide the dim (shorter prefixes tried first) or that an
earlier dim already took (the first dim wins), ``shardings_for_tree``
does it for a dict of arrays, ``kv_cache_shardings`` and
``batch_shardings`` for the KV cache and the batch. A ``Spec`` is a
tuple with one entry a dim: None (replicated), a grid axis, or a tuple
of grid axes (sharded over their product, the first the major).
``shard_slices`` gives a rank's index range of each dim. The sharded
trainer (``train/sharding.py``) places parameters, moments and batches
by them; ``serve_rules`` and ``kv_cache_shardings`` drive no path yet.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

Spec = tuple  # one entry a dim: None, a grid axis, or a tuple of axes

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")
BACKENDS = ("nccl", "gloo")


def host_grid_shape(n: int) -> tuple[int, int]:
    """``(data, model)`` for ``n`` ranks, as ``make_host_mesh`` shapes
    ``n`` devices: model is the largest power of two at most sqrt(n)."""
    half = 2 ** (int(math.log2(n)) // 2) if n > 1 else 1
    return (n // half, half)


@dataclass(frozen=True)
class Grid:
    """Named axes over ``prod(shape)`` ranks; ``rank`` is this process's."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]
    rank: int

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.shape) != len(self.axes) or len(set(self.axes)) != len(self.axes):
            raise ValueError(f"grid shape {self.shape} and axes {self.axes} do "
                             f"not match")
        if min(self.shape) < 1 or not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} is not on a grid of shape {self.shape}")

    @classmethod
    def for_world(cls, world_size: int, rank: int,
                  shape: Sequence[int] | None = None) -> "Grid":
        """The grid of a world: the caller's shape, or ``host_grid_shape``'s;
        axes ``(data, model)`` or ``(pod, data, model)`` by its rank."""
        shape = tuple(host_grid_shape(world_size) if shape is None else shape)
        if len(shape) not in (2, 3):
            raise ValueError(f"a grid has 2 or 3 axes, not the shape {shape}")
        grid = cls(shape, AXES_2D if len(shape) == 2 else AXES_3D, rank)
        if grid.world_size != world_size:
            raise ValueError(f"grid {shape} holds {grid.world_size} ranks, the "
                             f"world {world_size}")
        return grid

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    def size(self, axes: str | Sequence[str]) -> int:
        return math.prod(self.shape[self.axes.index(a)] for a in as_axes(axes))

    def coords(self, rank: int | None = None) -> tuple[int, ...]:
        r = self.rank if rank is None else rank
        return tuple(int(c) for c in np.unravel_index(r, self.shape))

    def index(self, axes: str | Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (in grid order), as
        ``jax.lax.axis_index`` gives it."""
        names = [a for a in self.axes if a in as_axes(axes)]
        c = self.coords()
        dims = [self.shape[self.axes.index(a)] for a in names]
        return int(np.ravel_multi_index([c[self.axes.index(a)] for a in names], dims))

    def lines(self, axes: str | Sequence[str]) -> list[list[int]]:
        """Every group of ranks that differ only in ``axes``, each in
        increasing rank order (so a rank's place in its group is its
        ``index(axes)``), the groups ordered by their first rank."""
        names = set(as_axes(axes))
        unknown = names - set(self.axes)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not on the grid {self.axes}")
        groups: dict[tuple, list[int]] = {}
        for r in range(self.world_size):
            c = self.coords(r)
            key = tuple(x for a, x in zip(self.axes, c) if a not in names)
            groups.setdefault(key, []).append(r)
        return sorted(groups.values())


def as_axes(axes: str | Sequence[str]) -> tuple[str, ...]:
    """One axis name or several, as a tuple."""
    return (axes,) if isinstance(axes, str) else tuple(axes)


class LaunchEnv(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    local_world_size: int


def torchrun_env() -> LaunchEnv | None:
    """The rank layout ``torchrun`` put in the environment, or None when
    the process was not started by it."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return None
    world = int(env["WORLD_SIZE"])
    return LaunchEnv(int(env["RANK"]), world, int(env["LOCAL_RANK"]),
                     int(env.get("LOCAL_WORLD_SIZE", world)))


def check_backend(backend: str, device: torch.device, *, local_rank: int,
                  local_world_size: int, device_count: int) -> None:
    """Refuse a backend that cannot run the ranks' layout; nothing falls
    back from one backend to the other.

    NCCL takes one rank a card: rank ``local_rank`` of this host on
    ``cuda:{local_rank}``. NCCL refuses two ranks on one device, so more
    ranks on a host than cards raises. gloo takes CPU tensors, and CUDA
    tensors of ranks that share a card (``core/collectives.py`` stages
    them through pinned host memory)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: the port runs {BACKENDS}")
    if backend == "gloo":
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"gloo ranks run on cpu or cuda, not {device}")
        return
    if device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA tensors, not {device}: pass "
                         f"backend='gloo' for the CPU")
    if local_world_size > device_count:
        raise ValueError(
            f"NCCL refuses two ranks on one device: {local_world_size} ranks on "
            f"this host share {device_count} card(s). Give every rank a card "
            f"of its own, or run the ranks on gloo, which stages each "
            f"collective through pinned host memory")
    if device.index != local_rank:
        raise ValueError(f"NCCL rank {local_rank} of this host runs on "
                         f"cuda:{local_rank}, not {device}")


def init_distributed(backend: str, device: torch.device, *, rank: int,
                     world_size: int, init_method: str = "env://",
                     local_rank: int = 0, local_world_size: int = 1) -> None:
    """Check the layout (``check_backend``), bind the card, and start the
    default process group."""
    check_backend(backend, device, local_rank=local_rank,
                  local_world_size=local_world_size,
                  device_count=torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


# -- the LM's logical-axis rules ----------------------------------------------------

def batch_axes(grid: Grid) -> tuple[str, ...]:
    """The axes the batch is split over: ``pod`` and ``data``, where the
    grid has them."""
    return tuple(a for a in ("pod", "data") if a in grid.axes)


def train_rules(grid: Grid) -> dict[str, tuple[str, ...]]:
    """Logical axis -> grid axes (a tuple: sharded over their product)."""
    return {
        "batch": batch_axes(grid),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "ssm_inner": ("model",),
        "ssm_heads": ("model",),
        "embed": ("data",),      # FSDP within a pod
        "layers": (),
        "head_dim": (),
        "cache_seq": (),
    }


def serve_rules(grid: Grid) -> dict[str, tuple[str, ...]]:
    r = train_rules(grid)
    r["cache_seq"] = ("model",)  # flash-decoding style fallback
    return r


def _entry(dim: int, cand: tuple[str, ...], grid: Grid):
    """The longest prefix of ``cand`` whose product divides ``dim``, as a
    spec entry (one axis bare), or None."""
    for cut in range(len(cand), 0, -1):
        sub = cand[:cut]
        if dim % grid.size(sub) == 0:
            return sub if len(sub) > 1 else sub[0]
    return None


def spec_for(shape: Sequence[int], axes: Sequence | None,
             rules: dict[str, tuple], grid: Grid) -> Spec:
    """The ``Spec`` of one array, with the reference's divisibility
    checks. When two logical dims map to overlapping grid axes, the first
    (leftmost) dim wins and the later dim stays replicated."""
    if axes is None:
        return Spec()
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {tuple(shape)}")
    used: set[str] = set()
    parts = []
    for dim, name in zip(shape, axes):
        entry = None
        if name is not None:
            cand = tuple(a for a in rules.get(name, ())
                         if a in grid.axes and a not in used)
            if cand:
                entry = _entry(int(dim), cand, grid)
                if entry is not None:
                    used.update(as_axes(entry))
        parts.append(entry)
    return Spec(parts)


def shardings_for_tree(shapes: dict, axes: dict, rules: dict[str, tuple],
                       grid: Grid) -> dict:
    """``{key: Spec}`` from parallel dicts of shapes and axes (nested
    dicts recurse)."""
    return {k: (shardings_for_tree(v, axes[k], rules, grid) if isinstance(v, dict)
                else spec_for(v, axes[k], rules, grid))
            for k, v in shapes.items()}


def kv_cache_shardings(grid: Grid, cfg, cache_shapes: dict,
                       rules: dict[str, tuple]) -> dict:
    """The cache rule: kv_heads over ``model`` when they divide it, else
    the cache's sequence. ``cache_shapes`` is one layer's ``{name:
    shape}`` (``models/lm.py::cache_axes``)."""
    from repro_torch.models import lm as LM

    r = dict(rules)
    if cfg.attn_active and cfg.num_kv_heads % grid.size("model") != 0:
        r["kv_heads"] = ()
        r["cache_seq"] = ("model",)
    else:
        r["cache_seq"] = ()
    return shardings_for_tree(cache_shapes, LM.cache_axes(cfg), r, grid)


def batch_shardings(grid: Grid, batch_shapes: dict,
                    rules: dict[str, tuple]) -> dict:
    """tokens, targets, mask and embeds: the leading dim over the batch
    axes (the longest prefix that divides it), the rest replicated."""
    ba = tuple(rules.get("batch", ()))

    def one(shape):
        lead = _entry(int(shape[0]), ba, grid) if ba else None
        return Spec((lead,) + (None,) * (len(shape) - 1))

    return {k: one(v) for k, v in batch_shapes.items()}


def shard_slices(shape: Sequence[int], spec: Spec, grid: Grid,
                 rank: int | None = None) -> tuple[slice, ...]:
    """A rank's index range of each dim under ``spec``: dim i split into
    ``size(entry)`` equal blocks, the rank taking the block of its index
    over the entry's axes (the first the major, as a JAX mesh orders
    them)."""
    coords = dict(zip(grid.axes, grid.coords(rank)))
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            out.append(slice(0, int(dim)))
            continue
        names = as_axes(entry)
        sizes = [grid.size(a) for a in names]
        n = math.prod(sizes)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split over {names}")
        idx = int(np.ravel_multi_index([coords[a] for a in names], sizes))
        per = int(dim) // n
        out.append(slice(idx * per, (idx + 1) * per))
    return tuple(out)


def shard_shape(shape: Sequence[int], spec: Spec, grid: Grid) -> tuple[int, ...]:
    """The shape of every rank's shard under ``spec``."""
    return tuple(s.stop - s.start for s in shard_slices(shape, spec, grid, 0))
