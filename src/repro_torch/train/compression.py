"""Gradient compression for the cross-pod reduction: an int8-quantized
psum with error feedback (counterpart of ``repro/train/compression.py``).

``compressed_psum(comm, x, axis, resid)`` agrees on a shared scale (an
all-reduce MAX of the largest magnitude), quantizes ``x + resid`` to
int8 with that scale, sums the integers over ``axis`` and dequantizes;
the quantization residual comes back for the next step's feedback.
``make_compressed_grads`` wraps a loss: each rank takes the gradient of
its pod's rows, and the gradients are summed over ``pod`` this way.

The wire. The reference sums int16 (``compression.py:38-42``). Neither
backend sums 16-bit integers: gloo refuses an int16 ``all_reduce`` and
NCCL's integer types are 8, 32 and 64 bits wide. So each quantized
value, biased by +127 into [0, 254], takes a 16-bit lane of an int64
word, four lanes a word, and the words are summed as int64: 2 bytes an
element on the wire, half of float32, as the reference's int16. A
lane's sum stays below 2^16 for up to 258 pods (254 * 258 = 65,532), so
no lane carries into the next; the top lane may wrap the int64's sign,
which integer addition does exactly, and shift-and-mask reads every
lane back. The unbiased sum is the lane's sum less 127 a pod.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.collectives import Collectives

LANES = 4
BIAS = 127
MAX_PODS = (2**16 - 1) // (2 * BIAS)  # 258
BYTES_AMAX = "pmax scale [pod]"
BYTES_WIRE = "psum int8 in int64 lanes [pod]"
BYTES_PLAIN = "psum float32 [pod]"
BYTES_LOSS = "pmean loss [pod]"


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], as int8 (round half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def pack_lanes(q: torch.Tensor) -> torch.Tensor:
    """int8 values, flattened and zero-padded to a multiple of 4, biased
    by +127 into four 16-bit lanes of each int64 word."""
    flat = q.reshape(-1).to(torch.int64) + BIAS
    pad = (-flat.numel()) % LANES
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), BIAS)])
    lanes = flat.view(-1, LANES)
    word = lanes[:, 0]
    for i in range(1, LANES):
        word = word | (lanes[:, i] << (16 * i))
    return word


def unpack_lanes(word: torch.Tensor, n: int, pods: int) -> torch.Tensor:
    """The summed lanes of ``pack_lanes`` words as the (n,) int32 sums of
    the unbiased values over ``pods`` pods."""
    lanes = torch.stack([(word >> (16 * i)) & 0xFFFF for i in range(LANES)], dim=1)
    return (lanes.reshape(-1)[:n] - BIAS * pods).to(torch.int32)


def compressed_psum(comm: Collectives, x: torch.Tensor, axis: str,
                    resid: torch.Tensor):
    """int8 all-reduce with error feedback over ``axis``. Returns (mean
    over the axis in x's dtype, new residual in float32)."""
    n = comm.grid.size(axis)
    if n > MAX_PODS:
        raise ValueError(f"the int64-lane wire sums at most {MAX_PODS} ranks, "
                         f"not {n}")
    xf = x.float() + resid
    amax = comm.pmax(torch.max(torch.abs(xf)).reshape(1), axis, label=BYTES_AMAX)[0]
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = quantize_int8(xf, scale)
    deq = q.float() * scale
    new_resid = xf - deq
    total = unpack_lanes(comm.psum(pack_lanes(q), axis, label=BYTES_WIRE),
                         q.numel(), n).reshape(q.shape)
    return (total.float() * scale / n).to(x.dtype), new_resid


def tree_compressed_psum(comm: Collectives, grads: dict, resid: dict, *,
                         pod_axis: str = "pod", compress: bool = True):
    """``compressed_psum`` leaf by leaf over ``pod_axis``; without
    ``compress``, the float32 mean (the residuals unchanged)."""
    out_g, out_r = {}, {}
    for k, g in grads.items():
        if compress:
            out_g[k], out_r[k] = compressed_psum(comm, g, pod_axis, resid[k])
        else:
            total = comm.psum(g.float(), pod_axis, label=BYTES_PLAIN)
            out_g[k] = (total / comm.grid.size(pod_axis)).to(g.dtype)
            out_r[k] = resid[k]
    return out_g, out_r


def make_compressed_grads(loss_fn: Callable, comm: Collectives, *,
                          compress: bool = True, pod_axis: str = "pod"):
    """(params, batch, resid) -> (loss, grads, resid): the gradient of
    ``loss_fn(params, batch)`` on this rank's pod's rows of the global
    ``batch`` (its leading dim split over ``pod_axis``), reduced over the
    pods by ``tree_compressed_psum``, and the loss averaged over them.
    Ranks of one pod compute the same rows, as the reference's automatic
    partitioner does within a pod."""
    pods = comm.grid.size(pod_axis)
    me = comm.grid.index(pod_axis)

    def run(params: dict, batch: dict, resid: dict):
        rows = {k: v.chunk(pods, dim=0)[me] for k, v in batch.items()}
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss = loss_fn(leaves, rows)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        grads, resid = tree_compressed_psum(comm, grads, resid, pod_axis=pod_axis,
                                            compress=compress)
        loss = comm.psum(loss.detach().reshape(1), pod_axis, label=BYTES_LOSS)[0] / pods
        return loss, grads, resid

    return run


def init_residuals(params: dict) -> dict:
    """float32 zeros shaped like each leaf."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
