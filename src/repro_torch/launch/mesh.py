"""The rank grid of the data-parallel HDP sampler (counterpart of the HDP
part of ``repro/launch/mesh.py``).

A ``Grid`` lays the ranks of a ``torch.distributed`` world out on named
axes, ``(data, model)`` or ``(pod, data, model)``, in row-major order:
rank r sits at ``np.unravel_index(r, shape)``, the last axis fastest, as
a JAX mesh orders its devices. ``host_grid_shape`` gives the shape that
``make_host_mesh`` gives a host's devices. Importing this module touches
no process group; ``init_distributed`` starts one, after
``check_backend`` has refused a layout the backend cannot run.

The LM's sharding rules (``train_rules``, ``shardings_for_tree``) are not
ported here.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

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
