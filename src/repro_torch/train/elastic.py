"""Elastic restart and straggler mitigation (counterpart of
``repro/train/elastic.py``).

On node loss the surviving ranks build the largest grid they can fill
(``remesh``: a ``Grid`` and a new process group over its ranks), restore
the last checkpoint, which holds every array at logical shape
(``train/checkpoint.py``), onto that grid's slices (``reshard_state``),
and split the data again. These helpers are the mechanics and the
monitoring policy; finding the dead hosts is the scheduler's job.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as MESH


def largest_mesh(num_devices: int, axes=MESH.AXES_2D,
                 model_parallel: int = 1) -> tuple[int, ...]:
    """The biggest usable (data, model) grid from a (possibly reduced)
    device count: data drops to the largest power of two."""
    model = model_parallel
    data = num_devices // model
    data = 2 ** int(math.log2(data)) if data > 0 else 0
    if data == 0:
        raise ValueError("not enough devices for the model-parallel degree")
    return (data, model)


def remesh(survivors: Sequence[int], rank: int, *, backend: str,
           device: torch.device, init_method: str, axes=MESH.AXES_2D,
           model_parallel: int = 1) -> Optional[MESH.Grid]:
    """Rebuild the grid from the surviving ranks (elastic restart).

    Every survivor calls it with the same ``survivors`` (old ranks) and
    its own old ``rank``. The old process group, if any, is destroyed;
    the first ``prod(largest_mesh(len(survivors)))`` survivors, in old
    rank order, start a new one at ``init_method`` and get its ``Grid``
    (new rank = place among them); the others get None and stay out."""
    shape = largest_mesh(len(survivors), axes, model_parallel)
    keep = sorted(survivors)[:math.prod(shape)]
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank not in keep:
        return None
    new_rank = keep.index(rank)
    MESH.init_distributed(backend, device, rank=new_rank, world_size=len(keep),
                          init_method=init_method,
                          local_rank=device.index if device.type == "cuda" else 0)
    return MESH.Grid(shape, axes, new_rank)


def reshard_state(ckpt_dir: str, layout, device: torch.device,
                  step: int | None = None):
    """A logical-shape checkpoint's slices for this rank of the layout's
    grid (``train/sharding.py::restore_sharded``)."""
    from repro_torch.train.sharding import restore_sharded

    return restore_sharded(ckpt_dir, layout, device, step)


class StragglerMonitor:
    """Per-step wall-time tracker with outlier detection.

    A step slower than ``threshold`` x the trailing median is flagged;
    ``breaches_before_action`` consecutive flags trigger the registered
    action (e.g. checkpoint and re-shard without the slow host)."""

    def __init__(self, *, window: int = 32, threshold: float = 2.0,
                 breaches_before_action: int = 3,
                 action: Optional[Callable[[], None]] = None):
        self.window = window
        self.threshold = threshold
        self.breaches_before_action = breaches_before_action
        self.action = action
        self.times: list[float] = []
        self.consecutive = 0
        self.total_breaches = 0
        self.actions_fired = 0

    def record(self, seconds: float) -> bool:
        """Returns True if this step was flagged as straggling."""
        flagged = False
        if len(self.times) >= 8:
            med = statistics.median(self.times[-self.window:])
            if seconds > self.threshold * med:
                flagged = True
                self.consecutive += 1
                self.total_breaches += 1
                if (self.consecutive >= self.breaches_before_action
                        and self.action is not None):
                    self.action()
                    self.actions_fired += 1
                    self.consecutive = 0
            else:
                self.consecutive = 0
        self.times.append(seconds)
        return flagged

    def timed(self, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, its wall time recorded to the end of
        its work on the card (the current card is synchronized where the
        reference blocks until the output is ready; nothing to wait for
        on the CPU)."""
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.record(time.monotonic() - t0)
        return out
