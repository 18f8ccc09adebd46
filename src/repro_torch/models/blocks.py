"""Decoder blocks (counterpart of ``repro/models/blocks.py``): dense,
moe (attention, then a mixture of experts in the MLP's place), ssm
(Mamba-2) and hybrid (hymba: attention and SSD heads in parallel on the
same input, outputs averaged).

A ``Block`` holds one layer's parameters under the reference's names;
the functions take it where the reference takes the layer's dict. A
layer's cache is a dict with ``k``, ``v`` (attention) and ``conv``,
``ssm`` (SSD).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as ATT
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import init_rmsnorm, rmsnorm
from repro_torch.models.mlp import init_mlp, mlp


BLOCK_TYPES = ("dense", "moe", "ssm", "hybrid")


class Block(nn.Module):
    def __init__(self, gen: torch.Generator, cfg):
        super().__init__()
        if cfg.block_type not in BLOCK_TYPES:
            raise ValueError(f"unknown block_type {cfg.block_type!r}; one of "
                             f"{BLOCK_TYPES}")
        dt, dev = cfg.pdtype, gen.device
        self.norm1 = init_rmsnorm(cfg.d_model, dt, dev)
        if cfg.attn_active:
            self.attn = ATT.init_attention(gen, cfg, dt)
        if cfg.ssm_active:
            self.ssm = SSM.init_ssm(gen, cfg, dt)
        if cfg.block_type == "moe":
            self.norm2 = init_rmsnorm(cfg.d_model, dt, dev)
            self.moe = MOE.init_moe(gen, cfg, dt)
        elif cfg.mlp_type != "none" and cfg.d_ff > 0:
            self.norm2 = init_rmsnorm(cfg.d_model, dt, dev)
            self.mlp = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, dt)


def _mix(parts):
    return parts[0] if len(parts) == 1 else 0.5 * (parts[0] + parts[1])


def _ffn(p: Block, cfg, x):
    """The MLP or the experts on the normed residual; the experts' load
    statistics are dropped, as the reference's stack drops them."""
    if hasattr(p, "moe"):
        y, _ = MOE.moe(p.moe, cfg, rmsnorm(p.norm2, x, cfg.norm_eps),
                       mode=cfg.moe_dispatch)
        x = x + y
    elif hasattr(p, "mlp"):
        x = x + mlp(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps), cfg.mlp_type)
    return x


def block_train(p: Block, cfg, x, positions):
    """Full-sequence forward of one block."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    parts = []
    if cfg.attn_active:
        parts.append(ATT.attention(p.attn, cfg, h, positions))
    if cfg.ssm_active:
        parts.append(SSM.ssm_mixer(p.ssm, cfg, h, chunk=cfg.ssd_chunk)[0])
    return _ffn(p, cfg, x + _mix(parts))


def init_cache(cfg, batch: int, cache_len: int, device):
    c = {}
    if cfg.attn_active:
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
        c["v"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
    if cfg.ssm_active:
        c["conv"], c["ssm"] = SSM.init_ssm_cache(cfg, batch, device)
    return c


def block_prefill(p: Block, cfg, x, positions, cache_len: int):
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    cache, parts = {}, []
    if cfg.attn_active:
        att, (cache["k"], cache["v"]) = ATT.attention_prefill(
            p.attn, cfg, h, positions, cache_len)
        parts.append(att)
    if cfg.ssm_active:
        sso, (cache["conv"], hf) = SSM.ssm_mixer(p.ssm, cfg, h,
                                                 chunk=cfg.ssd_chunk)
        cache["ssm"] = hf.float()
        parts.append(sso)
    return _ffn(p, cfg, x + _mix(parts)), cache


def block_decode(p: Block, cfg, x, positions, cache, fill: int):
    """One token; the attention cache is written in place, the SSD state
    replaced. Returns (x, cache)."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    cache = dict(cache)
    parts = []
    if cfg.attn_active:
        att, (cache["k"], cache["v"]) = ATT.attention_decode(
            p.attn, cfg, h, positions, (cache["k"], cache["v"]), fill)
        parts.append(att)
    if cfg.ssm_active:
        sso, (cache["conv"], cache["ssm"]) = SSM.ssm_decode(
            p.ssm, cfg, h, (cache["conv"], cache["ssm"]))
        parts.append(sso)
    return _ffn(p, cfg, x + _mix(parts)), cache
