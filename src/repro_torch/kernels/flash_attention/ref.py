"""Plain PyTorch attention (counterpart of
``repro/kernels/flash_attention/ref.py``): the flash kernel's plain
version, dense softmax attention with GQA by head repetition."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: int | None) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _repeat_kv(q, k, v):
    hq, hkv = q.shape[1], k.shape[1]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    return k, v


def _softmax_pv(logits, mask, vf):
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D). Float32 scores, output in
    q's dtype."""
    s, d = q.shape[2], q.shape[3]
    k, v = _repeat_kv(q, k, v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    pos = torch.arange(s, device=q.device)
    return _softmax_pv(logits, _mask(pos, pos, causal, window),
                       v.float()).to(q.dtype)


def attention_chunked(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_chunk: int = 1024):
    """Query-chunked attention: O(q_chunk * S) score memory, exact. One
    chunk when S is not a multiple of ``q_chunk``."""
    b, hq, s, d = q.shape
    k, v = _repeat_kv(q, k, v)
    if s % q_chunk:
        q_chunk = s
    kf, vf = k.float(), v.float()
    kpos = torch.arange(s, device=q.device)
    outs = []
    for start in range(0, s, q_chunk):
        qc = q[:, :, start:start + q_chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * d ** -0.5
        qpos = start + torch.arange(q_chunk, device=q.device)
        outs.append(_softmax_pv(logits, _mask(qpos, kpos, causal, window), vf))
    return torch.cat(outs, dim=2).to(q.dtype)
