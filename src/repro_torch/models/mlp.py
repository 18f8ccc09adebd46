"""MLP variants (counterpart of ``repro/models/mlp.py``): swiglu and
geglu (gated: ``wi`` (d_model, 2 d_ff) split as gate | up), gelu and
squared_relu (nemotron). The activations expand as the reference's do
in XLA (``layers.silu``, ``layers.gelu``)."""

from __future__ import annotations

import torch

from repro_torch.models.layers import gelu, silu
from repro_torch.models.module import Params, dense_init

GATED = {"swiglu", "geglu"}
MLP_TYPES = ("swiglu", "geglu", "gelu", "squared_relu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, mlp_type: str,
             dtype: torch.dtype) -> Params:
    if mlp_type not in MLP_TYPES:
        raise ValueError(f"unknown mlp_type {mlp_type!r}; one of {MLP_TYPES}")
    width = 2 * d_ff if mlp_type in GATED else d_ff
    return Params(wi=dense_init(gen, (d_model, width), dtype),
                  wo=dense_init(gen, (d_ff, d_model), dtype))


def activation(h: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """The hidden activation of ``wi``'s output: a gated type halves the
    last dim (gate | up)."""
    if mlp_type in GATED:
        g, u = h.chunk(2, dim=-1)
        return (silu(g) if mlp_type == "swiglu" else gelu(g)) * u
    if mlp_type == "gelu":
        return gelu(h)
    if mlp_type == "squared_relu":
        r = torch.relu(h)
        return r * r
    raise ValueError(f"unknown mlp_type {mlp_type!r}; one of {MLP_TYPES}")


def mlp(p: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    h = activation(torch.matmul(x, p.wi.to(x.dtype)), mlp_type)
    return torch.matmul(h, p.wo.to(x.dtype))
