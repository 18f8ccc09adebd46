"""Plain PyTorch SSD (counterpart of ``repro/kernels/ssd/ref.py`` and of
the reference's chunked SSD): the exact sequential recurrence, the
intra-chunk pass that the CUDA kernel computes, and the loop-free
chunked SSD.

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T     (N, P) per head
  y_t = C_t h_t
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ssd_ref(x, dt, a, bmat, cmat, h0=None):
    """x: (B,S,H,P), dt: (B,S,H), a: (H,), bmat/cmat: (B,S,H,N).

    Returns (y (B,S,H,P), h_final (B,H,N,P)), float32."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    hcur = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
            if h0 is None else h0)
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        decay = torch.exp(dtt * a[None, :])[:, :, None, None]
        upd = torch.einsum("bhn,bhp->bhnp", bmat[:, t].float(),
                           x[:, t].float() * dtt[..., None])
        hcur = hcur * decay + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", cmat[:, t].float(), hcur))
    return torch.stack(ys, dim=1), hcur


def _chunk_terms(x, dt, a, bmat, cmat, chunk):
    """Per-chunk terms of SSD over S = NC * chunk: (cum (b,nc,cl,h),
    y_intra (b,nc,cl,h,p), st (b,nc,h,n,p), cr (b,nc,cl,h,n))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc, cl = s // chunk, chunk
    xr = x.reshape(b, nc, cl, h, p).float()
    dtr = dt.reshape(b, nc, cl, h).float()
    br = bmat.reshape(b, nc, cl, h, n).float()
    cr = cmat.reshape(b, nc, cl, h, n).float()
    cum = torch.cumsum(dtr * a[None, None, None, :], dim=2)  # inclusive
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,i,j,h)
    ii = torch.arange(cl, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # mask before exp: above the diagonal seg > 0 and exp could overflow
    ldec = torch.exp(torch.where(tri, seg, -1e30))
    xdt = xr * dtr[..., None]
    scores = torch.einsum("bcihn,bcjhn->bcijh", cr, br) * ldec
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    st = torch.einsum("bcjhn,bcjhp->bchnp", br * decay_end[..., None], xdt)
    return cum, y_intra, st, cr


def ssd_intra_chunk_ref(x, dt, a, bmat, cmat, *, chunk: int = 64):
    """The intra-chunk pass of the CUDA kernel (and of the reference's
    ``ssd_intra_chunk``). Returns (y_intra (B,S,H,P), st (B,NC,H,N,P),
    dec (B,S,H)), float32; S must be a multiple of ``chunk``."""
    b, s, h, p = x.shape
    if s % chunk:
        raise ValueError(f"S={s} must divide chunk={chunk}")
    cum, y_intra, st, _ = _chunk_terms(x, dt, a, bmat, cmat, chunk)
    return (y_intra.reshape(b, s, h, p), st,
            torch.exp(cum).reshape(b, s, h))


def pad_sequence(pad: int, *arrays):
    """Zero-pad each (B, S, ...) array by ``pad`` steps along S. With
    dt = 0 a padded step is an identity of the recurrence: decay
    exp(0) = 1 and update 0."""
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in arrays)


def ssd_chunked(x, dt, a, bmat, cmat, h0=None, *, chunk: int = 64):
    """Loop-free chunked SSD, any S (padded with dt = 0 steps). Returns
    (y (B,S,H,P) in x's dtype, h_final (B,H,N,P) float32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x, dt, bmat, cmat = pad_sequence(pad, x, dt, bmat, cmat)
    nc = (s + pad) // chunk
    cum, y_intra, st, cr = _chunk_terms(x, dt, a, bmat, cmat, chunk)
    cdecay = torch.exp(cum[:, :, -1, :])  # (b,nc,h)
    hcur = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
            if h0 is None else h0)
    hstarts = []
    for c in range(nc):
        hstarts.append(hcur)
        hcur = hcur * cdecay[:, c, :, None, None] + st[:, c]
    y_inter = torch.einsum("bcihn,bchnp->bcihp", cr,
                           torch.stack(hstarts, dim=1)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s + pad, h, p)[:, :s]
    return y.to(x.dtype), hcur
