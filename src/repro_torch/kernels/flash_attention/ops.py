"""Entry point for attention (counterpart of
``repro/kernels/flash_attention/ops.py``): on the card every call
launches one of the two flash kernels (``flash_attention.route`` picks
it); on the CPU the plain version runs, query chunked above
``CHUNKED_THRESHOLD`` as in the reference."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_chunked

# Above this sequence length the plain version switches to query-chunked
# attention so (S, S) score tensors are never materialized.
CHUNKED_THRESHOLD = 8192


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None) -> torch.Tensor:
    """GQA attention over (B, H, S, D) tensors."""
    if q.device.type == "cpu" and q.shape[2] >= CHUNKED_THRESHOLD:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)
