"""SSD entry points (counterpart of ``repro/kernels/ssd/ops.py``): the
intra-chunk kernel, then the inter-chunk state scan over the NC chunks
in PyTorch.

  y_t = y_intra_t + C_t (decay_from_chunk_start_t * h_chunkstart)
  H_c = exp(sum_chunk a) H_{c-1} + st_c

Training differentiates the intra-chunk pass through
``SSDIntraChunkFn``: the kernel forward, and the vector-Jacobian product
of the plain version ``ssd_intra_chunk_ref`` in the backward pass, as
the reference's trainer differentiates its plain ``ssd_chunked`` and
no Pallas kernel. The inter-chunk scan is plain PyTorch and
differentiates as it is.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd.ref import pad_sequence, ssd_intra_chunk_ref
from repro_torch.kernels.ssd.ssd import ssd_intra_chunk


class SSDIntraChunkFn(torch.autograd.Function):
    """``ssd_intra_chunk`` forward, returning (y_intra, st, dec); the
    plain version's gradient. B and C may arrive as stride-0 views
    (shared by the heads): their gradients come back in the views' shape
    and autograd's ``expand`` backward sums them over the heads."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        return ssd_intra_chunk(x, dt, a, bmat, cmat, chunk=chunk)

    @staticmethod
    def backward(ctx, *grads):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(ctx.saved_tensors, needs)]
            outs = ssd_intra_chunk_ref(*ins, chunk=ctx.chunk)
        used = [(o, g) for o, g in zip(outs, grads) if g is not None]
        wrt = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in used], wrt,
                                       [g for _, g in used], allow_unused=True))
        return (*(next(got) if n else None for n in needs), None)


def _intra_chunk(x, dt, a, bmat, cmat, chunk: int):
    """``ssd_intra_chunk``, through ``SSDIntraChunkFn`` when an input
    needs a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, bmat, cmat)):
        return SSDIntraChunkFn.apply(x, dt, a, bmat, cmat, chunk)
    return ssd_intra_chunk(x, dt, a, bmat, cmat, chunk=chunk)


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
    y_intra, st, dec = _intra_chunk(x, dt, a, bmat, cmat, chunk)

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
