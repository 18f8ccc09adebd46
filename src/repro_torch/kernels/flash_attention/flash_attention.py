"""Wrapper of the flash attention CUDA kernel (counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention``).

``flash_attention`` computes GQA attention over q (B, Hq, S, D) and
k, v (B, Hkv, S, D), causal and with an optional sliding window. For
CUDA tensors it launches the kernel in ``csrc/flash_attention.cu`` on
the current stream or raises; for CPU tensors it runs the plain version
``ref.attention_ref``. Any S works (the kernel masks a ragged last
tile); q, k and v are read through their strides as long as the last
dim is contiguous, so (B, S, H, D) projections transposed to
(B, H, S, D) need no copy. The output is a new contiguous
(B, Hq, S, D) tensor. ``flash_attention.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 5 + [ci] * 5 + [ctypes.c_float] + [ci] * 3 + [vp])
    lib.flash_attention_launch.restype = ci
    return lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, S, D)")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"(B, Hkv, S, D) with q {tuple(q.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: int | None = None) -> torch.Tensor:
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel; one of "
                         f"{HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, hq, hkv, s, d,
            d ** -0.5, int(causal), window or 0, DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
