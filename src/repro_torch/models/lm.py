"""CausalLM: full-sequence forward, prefill, decode and the training
loss (counterpart of ``repro/models/lm.py``).

Layers are an ``nn.ModuleList`` of ``Block``s, one per layer, where the
reference stacks them under one scan. A cache is a list with one dict
per layer. In training (``cfg.remat``, gradients on) each block runs
under ``torch.utils.checkpoint``: only the residual stream between
blocks is kept, and the backward pass recomputes one block at a time,
as the reference's ``jax.checkpoint(..., nothing_saveable)``.

``lm_loss`` computes the vocabulary cross-entropy in sequence chunks of
``cfg.loss_chunk`` (each checkpointed), so the (B, S, V) float32 logits
are never held at once.

Prefix embeddings: with ``cfg.prefix_len`` set, ``embeds`` (B, P, D)
(precomputed frontend outputs, e.g. image patches) are cast to the
compute dtype and put before the token embeddings, and positions run over
the whole P + S. The loss is taken on the token positions only.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks as BLK
from repro_torch.models.config import LMConfig
from repro_torch.models.layers import (embed, init_embedding, init_rmsnorm,
                                       rmsnorm, unembed)


class CausalLM(nn.Module):
    """Parameters drawn from ``gen`` on its device, in ``cfg.pdtype``
    (``a_log``, ``dt_bias`` and ``d_skip`` in float32, as in the
    reference)."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype)
        self.blocks = nn.ModuleList(BLK.Block(gen, cfg) for _ in range(cfg.num_layers))
        self.final_norm = init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device)

    def _inputs(self, tokens: torch.Tensor, embeds: torch.Tensor | None):
        """The input hidden states, ``embeds`` first where the config has
        a prefix and they are given (as the reference, which then takes
        tokens alone), and their positions 0..S_total-1."""
        x = embed(self.embed, tokens).to(self.cfg.cdtype)
        if self.cfg.prefix_len and embeds is not None:
            x = torch.cat([embeds.to(self.cfg.cdtype), x], dim=1)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return x, positions

    def forward_hidden(self, tokens: torch.Tensor,
                       embeds: torch.Tensor | None = None) -> torch.Tensor:
        """Final hidden states (B, S_total, D) of the full-sequence forward."""
        x, positions = self._inputs(tokens, embeds)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                # the block draws no random numbers: no RNG state to keep
                x = checkpoint(BLK.block_train, blk, self.cfg, x, positions,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = BLK.block_train(blk, self.cfg, x, positions)
        return rmsnorm(self.final_norm, x, self.cfg.norm_eps)

    def prefill(self, tokens: torch.Tensor, cache_len: int,
                embeds: torch.Tensor | None = None):
        """Returns (last-position float32 logits (B, V), cache). The
        cache holds the trailing ``cache_len`` positions of prefix and
        tokens, so a decode that follows needs prefix + prompt + gen."""
        x, positions = self._inputs(tokens, embeds)
        caches = []
        for blk in self.blocks:
            x, c = BLK.block_prefill(blk, self.cfg, x, positions, cache_len)
            caches.append(c)
        h = rmsnorm(self.final_norm, x[:, -1:], self.cfg.norm_eps)
        return unembed(self.embed, h)[:, 0], caches

    def decode_step(self, token: torch.Tensor, cache: list, fill: int):
        """One decode step for token (B,) with ``fill`` tokens already in
        the cache. Returns (float32 logits (B, V), new cache); raises
        once ``fill`` reaches the cache's length."""
        x = embed(self.embed, token[:, None]).to(self.cfg.cdtype)
        positions = torch.full((x.shape[0], 1), fill, dtype=torch.int32,
                               device=x.device)
        new_cache = []
        for blk, c in zip(self.blocks, cache):
            x, c = BLK.block_decode(blk, self.cfg, x, positions, c, fill)
            new_cache.append(c)
        h = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return unembed(self.embed, h)[:, 0], new_cache

    def init_cache(self, batch: int, cache_len: int) -> list:
        dev = self.embed.table.device
        return [BLK.init_cache(self.cfg, batch, cache_len, dev)
                for _ in range(self.cfg.num_layers)]


# -- training loss ---------------------------------------------------------------

def _largest_divisor_leq(s: int, target: int) -> int:
    for c in range(min(target, s), 0, -1):
        if s % c == 0:
            return c
    return s


class _GradDtypeBarrier(torch.autograd.Function):
    """Identity whose gradient is cast back to the input's dtype (the
    reference's ``_grad_dtype_barrier``): the float32 logits' gradient
    reaches the bf16 hidden states, and the backward chain below them
    runs in the model's dtype. The identity in float32."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _chunk_loss(table_p, hc, tc, mc):
    """Summed cross-entropy of one chunk and its mask count."""
    logits = unembed(table_p, hc)  # (B, c, V) float32
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tc[..., None].long())[..., 0]
    return torch.sum((lse - ll) * mc), torch.sum(mc)


def lm_loss(model: CausalLM, tokens: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor, embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the positions ``mask`` keeps.
    tokens, targets, mask: (B, S); ``embeds`` (B, P, D), the prefix, whose
    positions take no loss. The vocabulary is reduced in
    ``_largest_divisor_leq(S, cfg.loss_chunk)``-position chunks, each
    recomputed in the backward pass, not stored."""
    h = _GradDtypeBarrier.apply(model.forward_hidden(tokens, embeds))
    h = h[:, model.cfg.prefix_len:]  # loss on token positions only
    b, s, _ = h.shape
    chunk = _largest_divisor_leq(s, model.cfg.loss_chunk)
    mf = mask.float()
    losses, counts = [], []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        args = (model.embed, h[:, sl], targets[:, sl], mf[:, sl])
        if torch.is_grad_enabled():
            loss, count = checkpoint(_chunk_loss, *args, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            loss, count = _chunk_loss(*args)
        losses.append(loss)
        counts.append(count)
    return torch.stack(losses).sum() / torch.clamp_min(torch.stack(counts).sum(), 1.0)
