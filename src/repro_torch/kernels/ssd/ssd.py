"""Wrapper of the SSD intra-chunk CUDA kernel (counterpart of
``repro/kernels/ssd/ssd.py::ssd_intra_chunk``).

``ssd_intra_chunk`` returns (y_intra (B,S,H,P), st (B,NC,H,N,P),
dec (B,S,H)), all float32, for float32 x (B,S,H,P), dt (B,S,H), a (H,)
and B, C (B,S,H,N), S a multiple of ``chunk``. For CUDA tensors it
launches the kernel in ``csrc/ssd_chunk.cu`` on the current stream or
raises; for CPU tensors it runs the plain version
``ref.ssd_intra_chunk_ref``. Inputs are read through their strides as
long as the last dim is contiguous, so B and C shared by all heads may
come as a stride-0 ``expand``. ``ssd_intra_chunk.launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    lib.ssd_chunk_launch.restype = ci
    lib.ssd_chunk_smem_bytes.argtypes = [ci] * 3
    lib.ssd_chunk_smem_bytes.restype = ci
    return lib


@functools.cache
def _smem_limit(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    bmat: torch.Tensor, cmat: torch.Tensor, *,
                    chunk: int = 64):
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    for name, t, shape in (("dt", dt, (b, s, h)), ("a", a, (h,)),
                           ("bmat", bmat, (b, s, h, n)),
                           ("cmat", cmat, (b, s, h, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"S={s} must divide chunk={chunk}")
    if x.device.type == "cpu":
        return ssd_intra_chunk_ref(x, dt, a, bmat, cmat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not {x.device}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bmat", bmat),
                    ("cmat", cmat)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if t.stride(-1) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous")
    dev = x.device
    lib = _lib()
    smem = lib.ssd_chunk_smem_bytes(chunk, n, p)
    limit = _smem_limit(dev.index if dev.index is not None else torch.cuda.current_device())
    if smem > limit:
        raise ValueError(f"ssd_intra_chunk: chunk={chunk}, N={n}, P={p} need "
                         f"{smem} bytes of shared memory per block, above the "
                         f"card's {limit}")
    nc = s // chunk
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=dev)
    dec = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    if y.numel() == 0 or st.numel() == 0:
        return y, st.zero_(), dec
    strides = (ctypes.c_longlong * 12)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        dt.stride(2), bmat.stride(0), bmat.stride(1), bmat.stride(2),
        cmat.stride(0), cmat.stride(1), cmat.stride(2))
    a = a.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, s, h, p, n, chunk, stream)
    if err:
        raise RuntimeError(f"ssd_chunk kernel launch failed: cudaError_t {err}")
    ssd_intra_chunk.launches += 1
    return y, st, dec


ssd_intra_chunk.launches = 0
