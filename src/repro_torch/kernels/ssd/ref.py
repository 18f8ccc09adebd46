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


def segsum(steps: torch.Tensor, dim: int) -> torch.Tensor:
    """Segment sums of ``steps`` along ``dim`` (length CL): a new dim
    after it holds j, and seg[..., i, j, ...] = sum of steps[k] over
    k = j+1..i for i >= j, -inf above the diagonal.

    Each is its own float32 sum from k = j+1 upward (a cumsum over the
    i dim of a masked (CL, CL) matrix, as Mamba-2's ``segsum`` takes
    it). The steps share one sign, so no sum cancels: exp(seg) keeps its
    relative precision where cum_i - cum_j, the difference of two sums
    that reach -1900 within a chunk on the model's dt and A, does not.
    """
    cl = steps.shape[dim]
    ii = torch.arange(cl, device=steps.device)
    shape = [1] * (steps.dim() + 1)
    shape[dim], shape[dim + 1] = cl, cl
    rep = steps.unsqueeze(dim + 1)                 # [.., i, 1, ..] = a_i
    below = (ii[:, None] > ii[None, :]).reshape(shape)
    seg = torch.cumsum(torch.where(below, rep, torch.zeros((), dtype=steps.dtype,
                                                             device=steps.device)),
                       dim=dim)
    tri = (ii[:, None] >= ii[None, :]).reshape(shape)
    return torch.where(tri, seg, float("-inf"))


def decay_to_end(steps: torch.Tensor, dim: int) -> torch.Tensor:
    """sum of steps[k] over k = j+1..CL-1 along ``dim``: a reverse
    cumsum, from the chunk's end down, shifted by one (0 at j = CL-1)."""
    rev = torch.flip(torch.cumsum(torch.flip(steps, [dim]), dim), [dim])
    return torch.cat([rev.narrow(dim, 1, rev.shape[dim] - 1),
                      torch.zeros_like(rev.narrow(dim, 0, 1))], dim)


def _chunk_terms(x, dt, a, bmat, cmat, chunk):
    """Per-chunk terms of SSD over S = NC * chunk: (cum (b,nc,cl,h),
    y_intra (b,nc,cl,h,p), st (b,nc,h,n,p), cr (b,nc,cl,h,n)).

    cum = cumsum(dt A) gives only dec = exp(cum), a prefix sum with no
    difference in it; the pairwise decays L and the decays to the
    chunk's end come from segment sums (``segsum``, ``decay_to_end``)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc, cl = s // chunk, chunk
    xr = x.reshape(b, nc, cl, h, p).float()
    dtr = dt.reshape(b, nc, cl, h).float()
    br = bmat.reshape(b, nc, cl, h, n).float()
    cr = cmat.reshape(b, nc, cl, h, n).float()
    steps = dtr * a[None, None, None, :]
    cum = torch.cumsum(steps, dim=2)                 # inclusive
    ldec = torch.exp(segsum(steps, 2))               # (b,nc,i,j,h), 0 above
    xdt = xr * dtr[..., None]
    scores = torch.einsum("bcihn,bcjhn->bcijh", cr, br) * ldec
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xdt)
    decay_end = torch.exp(decay_to_end(steps, 2))
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
