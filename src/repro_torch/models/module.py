"""Parameter groups and init (counterpart of ``repro/models/module.py``).

The reference keeps parameters as nested dicts of arrays; here each
group is a ``Params`` module whose parameters keep the reference's names
and layouts (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), ...), so a state
dict key such as ``blocks.3.attn.wq`` names the reference's
``blocks/attn/wq[3]``. Random init draws from an explicit
``torch.Generator`` on the device the parameters go to.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Params(nn.Module):
    """A named group of parameters, read as attributes (``p.wq``) where
    the reference reads ``p["wq"]``. They start without gradients, as
    serving wants them; the trainer turns gradients on
    (``train/trainer.py::init_train_state``)."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


def dense_init(gen: torch.Generator, shape: tuple[int, ...],
               dtype: torch.dtype = torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init on ``gen``'s device: a standard
    normal cut to [-2, 2], drawn in float32, times ``scale`` (default
    1/sqrt(shape[0])), cast to ``dtype``."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (scale * t).to(dtype)
