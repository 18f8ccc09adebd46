"""SSD entry points (counterpart of ``repro/kernels/ssd/ops.py``): the
intra-chunk kernel, then the inter-chunk state scan over the NC chunks
in PyTorch.

  y_t = y_intra_t + C_t (decay_from_chunk_start_t * h_chunkstart)
  H_c = exp(sum_chunk a) H_{c-1} + st_c
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import pad_sequence
from repro_torch.kernels.ssd.ssd import ssd_intra_chunk


def ssd(x, dt, a, bmat, cmat, h0=None, *, chunk: int = 64):
    """Chunked SSD over float32 x (B,S,H,P), dt (B,S,H), a (H,),
    B/C (B,S,H,N). Any S: where S is not a multiple of ``chunk`` the
    sequence is padded with dt = 0 steps, identities of the recurrence.
    Returns (y (B,S,H,P), h_final (B,H,N,P))."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    pad = (-s) % chunk
    if pad:
        x, dt, bmat, cmat = pad_sequence(pad, x, dt, bmat, cmat)
    nc = (s + pad) // chunk
    y_intra, st, dec = ssd_intra_chunk(x, dt, a, bmat, cmat, chunk=chunk)

    # chunk-level decays: exp(sum of a over chunk) per (B, NC, H)
    a_steps = dt.float() * a[None, None, :]
    cdecay = torch.exp(a_steps.reshape(b, nc, chunk, h).sum(dim=2))
    hcur = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
            if h0 is None else h0)
    hstarts = []
    for c in range(nc):
        hstarts.append(hcur)  # state at chunk start
        hcur = hcur * cdecay[:, c, :, None, None] + st[:, c]

    # inter-chunk output: C_t (dec_t * h_chunkstart)
    cm = cmat.reshape(b, nc, chunk, h, n).float()
    y_inter = torch.einsum("bclhn,bchnp->bclhp", cm,
                           torch.stack(hstarts, dim=1))
    y_inter = y_inter * dec.reshape(b, nc, chunk, h)[..., None]
    y = y_intra + y_inter.reshape(b, s + pad, h, p)
    return y[:, :s].to(x.dtype), hcur


def ssd_decode_step(xt, dtt, a, bt, ct, hprev):
    """Single-token recurrence: xt (B,H,P), dtt (B,H), bt/ct (B,H,N),
    hprev (B,H,N,P). Returns (y_t (B,H,P), h_new)."""
    decay = torch.exp(dtt * a[None, :])[:, :, None, None]
    hnew = hprev * decay + torch.einsum("bhn,bhp->bhnp", bt, xt * dtt[..., None])
    yt = torch.einsum("bhn,bhnp->bhp", ct, hnew)
    return yt, hnew
