"""Wrapper of the hdp_z CUDA kernel (counterpart of
``repro/kernels/hdp_z/hdp_z.py::hdp_z_pallas``).

``hdp_z_cuda`` runs one z-sweep. Table mode takes ``q_a``/``fpack``/
``ipack``; prologue mode takes ``apsi``/``vals``/``ids`` (the reference
passes apsi in the q_a slot; here each has its own argument). For CUDA
tensors it launches the kernel in ``csrc/hdp_z.cu`` on the current stream
or raises; for CPU tensors it runs the plain version in ``ref.py``.
``hdp_z_cuda.launches`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hdp_z.ref import hdp_z_ref, hdp_z_ref_prologue

SOURCE = Path(__file__).resolve().parent / "csrc" / "hdp_z.cu"
MAX_WARPS_PER_BLOCK = 8


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hdp_z_launch.argtypes = [vp] * 11 + [ci] * 6 + [vp]
    lib.hdp_z_launch.restype = ci
    lib.hdp_z_smem_limit.argtypes = [ci, ctypes.POINTER(ci)]
    lib.hdp_z_smem_limit.restype = ci
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def smem_bytes_per_warp(kk: int, w: int, in_kernel: bool) -> int:
    """Shared memory one document's warp uses: m (K int32) and W-wide
    scratch lines (1 in table mode, 5 in prologue mode)."""
    return 4 * (kk + (5 if in_kernel else 1) * w)


def hdp_z_cuda(
    tokens: torch.Tensor,    # (D, L) int32
    mask: torch.Tensor,      # (D, L) bool
    z: torch.Tensor,         # (D, L) int32
    uniforms: torch.Tensor,  # (D, L, 3) f32
    *,
    kk: int,
    q_a: torch.Tensor | None = None,    # table mode (V,) f32
    fpack: torch.Tensor | None = None,  # table mode (V, 2, W) f32
    ipack: torch.Tensor | None = None,  # table mode (V, 2, W) int32
    apsi: torch.Tensor | None = None,   # prologue mode (K,) f32
    vals: torch.Tensor | None = None,   # prologue mode (V, W) f32
    ids: torch.Tensor | None = None,    # prologue mode (V, W) int32
    emit_delta: bool = False,
) -> tuple[torch.Tensor, ...]:
    """One z-sweep; returns ``(z_new, m)`` or ``(z_new, m, dn)``."""
    in_kernel = all(x is not None for x in (apsi, vals, ids))
    if in_kernel == all(x is not None for x in (q_a, fpack, ipack)):
        raise ValueError(
            "pass exactly one of (q_a, fpack, ipack) or (apsi, vals, ids)"
        )
    if tokens.device.type == "cpu":
        if in_kernel:
            return hdp_z_ref_prologue(tokens, mask, z, uniforms, apsi, vals,
                                      ids, kk=kk, emit_delta=emit_delta)
        return hdp_z_ref(tokens, mask, z, uniforms, q_a, fpack, ipack,
                         kk=kk, emit_delta=emit_delta)
    if tokens.device.type != "cuda":
        raise ValueError(f"hdp_z_cuda runs on cuda or cpu, not {tokens.device}")

    dev = tokens.device
    d, l = tokens.shape
    if in_kernel:
        vv, w = vals.shape
        _check("apsi", apsi, torch.float32, (kk,), dev)
        _check("vals", vals, torch.float32, (vv, w), dev)
        _check("ids", ids, torch.int32, (vv, w), dev)
        fvals, ivals = vals, ids
    else:
        vv, _, w = fpack.shape
        _check("q_a", q_a, torch.float32, (vv,), dev)
        _check("fpack", fpack, torch.float32, (vv, 2, w), dev)
        _check("ipack", ipack, torch.int32, (vv, 2, w), dev)
        fvals, ivals = fpack, ipack
    _check("tokens", tokens, torch.int32, (d, l), dev)
    _check("mask", mask, torch.bool, (d, l), dev)
    _check("z", z, torch.int32, (d, l), dev)
    _check("uniforms", uniforms, torch.float32, (d, l, 3), dev)
    if w < 1 or kk < 1:
        raise ValueError(f"need W >= 1 and K >= 1, got W={w}, K={kk}")

    z_out = torch.empty_like(z)
    m = torch.empty((d, kk), dtype=torch.int32, device=dev)
    dn = (torch.zeros((kk, vv), dtype=torch.int32, device=dev)
          if emit_delta else None)
    if d and l:
        lib = _lib()
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        limit = ctypes.c_int(0)
        err = lib.hdp_z_smem_limit(idx, ctypes.byref(limit))
        if err:
            raise RuntimeError(f"hdp_z: cudaDeviceGetAttribute failed ({err})")
        per_warp = smem_bytes_per_warp(kk, w, in_kernel)
        if per_warp > limit.value:
            raise ValueError(
                f"hdp_z: one document needs {per_warp} bytes of shared memory "
                f"(K={kk}, W={w}), above the card's {limit.value}-byte limit "
                f"per block; K*4 + {5 if in_kernel else 1}*W*4 must fit"
            )
        warps = max(1, min(MAX_WARPS_PER_BLOCK, limit.value // per_warp))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.hdp_z_launch(
                tokens.data_ptr(), mask.data_ptr(), z.data_ptr(),
                uniforms.data_ptr(),
                None if in_kernel else q_a.data_ptr(),
                apsi.data_ptr() if in_kernel else None,
                fvals.data_ptr(), ivals.data_ptr(),
                z_out.data_ptr(), m.data_ptr(),
                dn.data_ptr() if emit_delta else None,
                d, l, kk, vv, w, warps, stream,
            )
        if err:
            raise RuntimeError(f"hdp_z kernel launch failed: cudaError_t {err}")
        hdp_z_cuda.launches += 1
    else:
        m.zero_()
        z_out.copy_(z)
    return (z_out, m, dn) if emit_delta else (z_out, m)


hdp_z_cuda.launches = 0
