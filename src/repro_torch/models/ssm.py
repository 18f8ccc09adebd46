"""Mamba-2 (SSD) mixer and single-token decode (counterpart of
``repro/models/ssm.py``).

in_proj produces [z_gate, x, B, C, dt]; a depthwise causal conv runs
over (x, B, C); SSD (the intra-chunk kernel plus the inter-chunk scan);
gated RMSNorm; out_proj. Decode carries (conv_state (B, K-1, conv_dim),
ssm_state (B, H, N, P)).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step
from repro_torch.models.layers import init_rmsnorm, rmsnorm, silu
from repro_torch.models.module import Params, dense_init

CONV_K = 4


def ssm_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return d_inner, heads, conv_dim


def init_ssm(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    d, n = cfg.d_model, cfg.ssm_state
    d_inner, heads, conv_dim = ssm_dims(cfg)
    dev = gen.device
    proj_out = 2 * d_inner + 2 * n + heads  # z, x, B, C, dt
    p = Params(
        in_proj=dense_init(gen, (d, proj_out), dtype),
        conv_w=dense_init(gen, (CONV_K, conv_dim), dtype, scale=0.5),
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=dev),
        a_log=torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32,
                                       device=dev)),
        dt_bias=torch.zeros((heads,), dtype=torch.float32, device=dev),
        d_skip=torch.ones((heads,), dtype=torch.float32, device=dev),
        out_proj=dense_init(gen, (d_inner, d), dtype),
    )
    p.norm = init_rmsnorm(d_inner, dtype, dev)
    return p


def _split_proj(cfg, h):
    d_inner, _, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    z = h[..., :d_inner]
    xbc = h[..., d_inner:2 * d_inner + 2 * n]
    dt = h[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt  # gate, conv input, dt (B,S,H)


def _split_xbc(cfg, xbc):
    d_inner, _, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    return xbc[..., :d_inner], xbc[..., d_inner:d_inner + n], xbc[..., d_inner + n:]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) for every x, as jax.nn.softplus; F.softplus returns x
    # itself above its threshold of 20
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(p: Params, xbc: torch.Tensor, conv_state=None):
    """Depthwise causal conv, kernel CONV_K, over xbc (B, S, C): the taps
    are summed in the order i = 0..K-1, then the bias is added."""
    w = p.conv_w.to(xbc.dtype)  # (K, C)
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], CONV_K - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, S+K-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s] * w[0]
    for i in range(1, CONV_K):
        out = out + xp[:, i:i + s] * w[i]
    out = out + p.conv_b.to(xbc.dtype)
    # a copy, so that the cache does not hold all of xp
    new_state = xp[:, -(CONV_K - 1):].clone()
    return silu(out), new_state


def ssm_mixer(p: Params, cfg, x, h0=None, conv_state=None, *, chunk: int = 64):
    """Full-sequence SSD. x: (B, S, D). Returns (out, (conv_state,
    ssm_state)). B and C are shared by all heads and reach the kernel as
    a stride-0 view."""
    d_inner, heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    b, s, _ = x.shape
    h = torch.matmul(x, p.in_proj.to(x.dtype))
    z, xbc, dt = _split_proj(cfg, h)
    xbc, conv_state = _causal_conv(p, xbc, conv_state)
    xi, bmat, cmat = _split_xbc(cfg, xbc)

    dt = _softplus(dt.float() + p.dt_bias)  # (B,S,H)
    a = -torch.exp(p.a_log)  # (H,) negative
    xh = xi.reshape(b, s, heads, cfg.ssm_head_dim).float()
    bm = bmat.float()[:, :, None, :].expand(b, s, heads, n)
    cm = cmat.float()[:, :, None, :].expand(b, s, heads, n)
    y, hf = ssd(xh, dt, a, bm, cm, h0, chunk=min(chunk, s))
    y = y + xh * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * silu(z))
    out = torch.matmul(y, p.out_proj.to(x.dtype))
    return out, (conv_state, hf)


def ssm_decode(p: Params, cfg, x, state):
    """Single-token step. x: (B, 1, D); state = (conv_state, ssm_state)."""
    conv_state, hprev = state
    d_inner, heads, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    b = x.shape[0]
    h = torch.matmul(x, p.in_proj.to(x.dtype))
    z, xbc, dt = _split_proj(cfg, h)
    xbc, conv_state = _causal_conv(p, xbc, conv_state)
    xi, bmat, cmat = _split_xbc(cfg, xbc)

    dt1 = _softplus(dt[:, 0].float() + p.dt_bias)  # (B,H)
    a = -torch.exp(p.a_log)
    xh = xi[:, 0].reshape(b, heads, cfg.ssm_head_dim).float()
    bm = bmat[:, 0, None, :].float().expand(b, heads, n)
    cm = cmat[:, 0, None, :].float().expand(b, heads, n)
    yt, hnew = ssd_decode_step(xh, dt1, a, bm, cm, hprev)
    yt = yt + xh * p.d_skip[None, :, None]
    y = yt.reshape(b, 1, d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * silu(z))
    out = torch.matmul(y, p.out_proj.to(x.dtype))
    return out, (conv_state, hnew)


def init_ssm_cache(cfg, batch: int, device):
    d_inner, heads, conv_dim = ssm_dims(cfg)
    return (
        torch.zeros((batch, CONV_K - 1, conv_dim), dtype=torch.float32, device=device),
        torch.zeros((batch, heads, cfg.ssm_state, cfg.ssm_head_dim),
                    dtype=torch.float32, device=device),
    )
