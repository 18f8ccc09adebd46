"""The swiglu MLP (counterpart of ``repro/models/mlp.py``), the one that
hymba uses. The reference's other variants (geglu, gelu, squared_relu)
raise until an arch that uses them is ported."""

from __future__ import annotations

import torch

from repro_torch.models.layers import silu
from repro_torch.models.module import Params, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> Params:
    if mlp_type != "swiglu":
        raise NotImplementedError(
            f"mlp_type {mlp_type!r} is not ported yet; see ROADMAP.md, section A")
    return Params(wi=dense_init(gen, (d_model, 2 * d_ff), dtype),
                  wo=dense_init(gen, (d_ff, d_model), dtype))


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g, u = torch.matmul(x, p.wi.to(x.dtype)).chunk(2, dim=-1)
    return torch.matmul(silu(g) * u, p.wo.to(x.dtype))
