"""Entry point for attention (counterpart of
``repro/kernels/flash_attention/ops.py``): on the card every call
launches one of the two flash kernels (``flash_attention.route`` picks
it); on the CPU the plain version runs, query chunked above
``CHUNKED_THRESHOLD`` as in the reference.

Training differentiates through ``FlashAttentionFn``: its forward is
the same call, and its backward is the vector-Jacobian product of the
plain version, recomputed from the saved q, k, v. The reference
differentiates no Pallas kernel either: its trainer runs the plain
formulation (``use_kernels=False``), so both packages take the same
gradient, and the port's forward stays the kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_chunked, attention_ref

# Above this sequence length the plain version switches to query-chunked
# attention so (S, S) score tensors are never materialized.
CHUNKED_THRESHOLD = 8192


def _plain(q, k, v, causal: bool, window: int | None):
    fn = attention_chunked if q.shape[2] >= CHUNKED_THRESHOLD else attention_ref
    return fn(q, k, v, causal=causal, window=window)


def _forward(q, k, v, causal: bool, window: int | None):
    """The kernel on the card, the plain version on the CPU."""
    if q.device.type == "cpu" and q.shape[2] >= CHUNKED_THRESHOLD:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` forward; the plain version's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int | None):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = _plain(*ins, ctx.causal, ctx.window)
        dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention over (B, H, S, D) tensors; through
    ``FlashAttentionFn`` when an input needs a gradient."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
