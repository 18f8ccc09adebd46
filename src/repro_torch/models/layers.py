"""Norms, embeddings and rotary embeddings (counterpart of
``repro/models/layers.py``)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.module import Params, dense_init


# -- RMSNorm ----------------------------------------------------------------

def init_rmsnorm(dim: int, dtype: torch.dtype, device) -> Params:
    return Params(scale=torch.ones((dim,), dtype=dtype, device=device))


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with sigmoid(x) = 1 / (1 + exp(-x)), each operation
    in x's dtype: the reference's jax.nn.silu as XLA expands it, so that
    in bf16 every step rounds where the reference's does (F.silu and
    torch.sigmoid round once, and differ in about a third of bf16
    inputs)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation 0.5 x (1 + tanh(c (x + 0.044715 x^3))),
    c = sqrt(2 / pi), each operation in x's dtype with both constants
    rounded to it: the reference's jax.nn.gelu (approximate=True) as XLA
    expands it, x^3 as integer_pow's two products x * (x * x), so that in
    bf16 every step rounds where the reference's does
    (F.gelu(approximate="tanh") rounds once). The constants are Python
    floats holding the rounded values, so the card gets no copy."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype).item()
    a = torch.tensor(0.044715, dtype=x.dtype).item()
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * (x * x)))))
    return x * cdf


# -- Embedding ----------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, dim: int,
                   dtype: torch.dtype) -> Params:
    return Params(table=dense_init(gen, (vocab, dim), dtype, scale=1.0))


def embed(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p.table[tokens.long()]


def unembed(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied softmax head: (..., D) @ (V, D)^T -> (..., V) float32 logits
    accumulated in float32, as the reference's
    ``preferred_element_type=float32``: a bf16 product rounded to bf16
    would change the greedy argmax. The products of bf16 values are
    exact in float32, so casting the operands first computes the same."""
    return torch.matmul(x.float(), p.table.float().t())


# -- Rotary position embeddings ----------------------------------------------

def rope_frequencies(head_dim: int, theta: float, rotary_fraction: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * rotary_fraction)
    rot -= rot % 2
    return 1.0 / (theta ** (
        torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               rotary_fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``rotary_fraction`` of the head dims of x
    (B, S, H, Dh) at ``positions`` (B, S), even and odd dims paired, and
    pass the rest through. bf16 times the float32 angles promotes to
    float32, as in the reference; the rotated part is cast back."""
    dh = x.shape[-1]
    inv = rope_frequencies(dh, theta, rotary_fraction, x.device)
    rot = inv.shape[0] * 2
    ang = positions[..., None].float() * inv  # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)
