"""CausalLM: full-sequence forward, prefill and decode (counterpart of
``repro/models/lm.py``; training and the loss are not ported yet).

Layers are an ``nn.ModuleList`` of ``Block``s, one per layer, where the
reference stacks them under one scan. A cache is a list with one dict
per layer.
"""

from __future__ import annotations

import torch
from torch import nn

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
        if cfg.prefix_len:
            raise NotImplementedError(
                "prefix embeddings are not ported yet; see ROADMAP.md")
        self.cfg = cfg
        self.embed = init_embedding(gen, cfg.vocab_size, cfg.d_model, cfg.pdtype)
        self.blocks = nn.ModuleList(BLK.Block(gen, cfg) for _ in range(cfg.num_layers))
        self.final_norm = init_rmsnorm(cfg.d_model, cfg.pdtype, gen.device)

    def _inputs(self, tokens: torch.Tensor):
        x = embed(self.embed, tokens).to(self.cfg.cdtype)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        return x, positions

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final hidden states (B, S, D) of the full-sequence forward."""
        x, positions = self._inputs(tokens)
        for blk in self.blocks:
            x = BLK.block_train(blk, self.cfg, x, positions)
        return rmsnorm(self.final_norm, x, self.cfg.norm_eps)

    def prefill(self, tokens: torch.Tensor, cache_len: int):
        """Returns (last-position float32 logits (B, V), cache)."""
        x, positions = self._inputs(tokens)
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
