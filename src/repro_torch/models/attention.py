"""GQA attention with RoPE, KV caching and sliding windows (counterpart
of ``repro/models/attention.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import Params, dense_init


def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, hq, dh), dtype),
        "wk": dense_init(gen, (d, hkv, dh), dtype),
        "wv": dense_init(gen, (d, hkv, dh), dtype),
        "wo": dense_init(gen, (hq, dh, d), dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((heads, dh), dtype=dtype, device=gen.device)
    return Params(**p)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, H, Dh) -> (B, S, H, Dh)."""
    d, h, dh = w.shape
    return torch.matmul(x, w.reshape(d, h * dh).to(x.dtype)).unflatten(-1, (h, dh))


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) x (H, Dh, d) -> (B, S, d)."""
    h, dh, d = wo.shape
    return torch.matmul(o.reshape(*o.shape[:2], h * dh), wo.reshape(h * dh, d).to(o.dtype))


def _project_qkv(p: Params, cfg, x, positions):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_fraction)
    return q, k, v


def _full(cfg, q, k, v):
    """Causal (windowed) attention over (B, S, H, Dh) projections; the
    kernel reads them through (B, H, S, Dh) views in place."""
    return mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=True, window=cfg.window).transpose(1, 2)


def attention(p: Params, cfg, x, positions):
    """Full-sequence causal attention (training / prefill)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    return _out(_full(cfg, q, k, v), p.wo)


def attention_prefill(p: Params, cfg, x, positions, cache_len: int):
    """Prefill: full attention and the KV cache (B, cache_len, Hkv, Dh),
    which keeps the trailing ``cache_len`` positions and is zero beyond
    them, as in the reference."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    out = _out(_full(cfg, q, k, v), p.wo)
    b, s = x.shape[:2]
    keep = min(cache_len, s)
    kc = k.new_zeros((b, cache_len) + k.shape[2:])
    vc = v.new_zeros((b, cache_len) + v.shape[2:])
    kc[:, :keep] = k[:, s - keep:]
    vc[:, :keep] = v[:, s - keep:]
    return out, (kc, vc)


def attention_decode(p: Params, cfg, x, positions, cache, fill: int):
    """Single-token decode against a KV cache, in plain PyTorch.

    x: (B, 1, D); cache: (k, v) of (B, C, Hkv, Dh), written in place at
    index ``fill`` (tokens already in the cache). The reference writes at
    ``min(fill, C - 1)`` and so keeps overwriting the last slot once the
    cache is full, which no longer computes the full-sequence model;
    here ``fill >= C`` raises instead.
    """
    kc, vc = cache
    b, c, hkv, dh = kc.shape
    if not 0 <= fill < c:
        raise ValueError(
            f"decode at fill={fill} needs a free cache slot, and the cache "
            f"holds {c}; size the cache for prompt + generated tokens")
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    kc[:, fill] = k_new[:, 0]
    vc[:, fill] = v_new[:, 0]

    hq = cfg.num_heads
    qg = q[:, 0].float().reshape(b, hkv, hq // hkv, dh)  # head h -> kv h // group
    logits = torch.einsum("bkgd,bckd->bkgc", qg, kc.float()) * dh ** -0.5
    pos_c = torch.arange(c, device=x.device)
    valid = pos_c <= fill
    if cfg.window is not None:
        valid &= pos_c > fill - cfg.window
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgc,bckd->bkgd", w, vc.float()).reshape(b, 1, hq, dh)
    return _out(o.to(x.dtype), p.wo), (kc, vc)
