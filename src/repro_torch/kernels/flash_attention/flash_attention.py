"""Wrapper of the flash attention CUDA kernels (counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention``).

``flash_attention`` computes GQA attention over q (B, Hq, S, D) and
k, v (B, Hkv, S, D), causal and with an optional sliding window. For
CPU tensors it runs the plain version ``ref.attention_ref``. For CUDA
tensors it launches one of two kernels on the current stream, chosen by
``route`` from the dtype and head dim, or raises; nothing falls back:

- ``tensor_cores``: bf16 at D in (64, 128, 192, 256),
  ``csrc/flash_fwd_sm90.cu`` (wgmma for both products, K and V staged by
  TMA). TMA needs every base pointer 16-byte aligned and every stride
  but the last a multiple of 16 bytes; ``tma_check`` refuses inputs that
  break that.
- ``cuda_cores``: float32 at every D of ``HEAD_DIMS``, and bf16 at D in
  (16, 32), ``csrc/flash_attention.cu`` (float32 products on the CUDA
  cores; float32 stays there, as the tensor cores would run it in TF32;
  32-row query tiles at D=256, 64 rows below).

The reference's Pallas kernel takes any D; the port's kernels take the
head dims of ``HEAD_DIMS``, which cover the reference's configs (64 and
128, 192 for nemotron-4-340b, 256 for paligemma-3b), and raise on another.

Any S works (both kernels mask a ragged last tile); q, k and v are read
through their strides as long as the last dim is contiguous, so
(B, S, H, D) projections transposed to (B, H, S, D) need no copy. The
output is a new contiguous (B, Hq, S, D) tensor.
``flash_attention.launches`` counts kernel launches, and nothing else;
``flash_attention.launches_by_route`` splits them by route.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"        # the CUDA-core kernel
SM90_SOURCE = CSRC / "flash_fwd_sm90.cu"    # the tensor-core kernel
SOURCES = (SOURCE, SM90_SOURCE)
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 192, 256)
ROUTES = ("tensor_cores", "cuda_cores")
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16  # bytes, for base pointers and strides


def _bind(source: Path, name: str, n_ints: int) -> ctypes.CDLL:
    lib = _build.load(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.argtypes = [vp] * 5 + [ci] * 5 + [ctypes.c_float] + [ci] * n_ints + [vp]
    fn.restype = ci
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(SOURCE, "flash_attention_launch", 3)


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = _bind(SM90_SOURCE, "flash_fwd_sm90_launch", 2)
    lib.flash_fwd_sm90_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_fwd_sm90_smem_bytes.restype = ctypes.c_int
    return lib


def sm90_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one CTA of the tensor-core kernel at head
    dim ``d`` (builds the kernel if needed)."""
    return _lib_sm90().flash_fwd_sm90_smem_bytes(d)


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that runs (dtype, head dim) on the card; raises
    ValueError for a head dim that neither kernel takes."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernels; one of "
                         f"{HEAD_DIMS}")
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


def tma_check(name: str, shape, strides, ptr: int, itemsize: int) -> None:
    """Raise ValueError unless TMA can load this tensor: a 16-byte aligned
    base pointer and, for every dim but the last (whose stride is 1) of
    size above 1, a stride that is a multiple of 16 bytes."""
    if ptr % TMA_ALIGN:
        raise ValueError(
            f"{name}: base pointer {ptr:#x} is not {TMA_ALIGN}-byte aligned; "
            f"the tensor-core kernel loads it by TMA, which needs that")
    for dim, (n, st) in enumerate(zip(shape[:-1], strides[:-1])):
        if n > 1 and (st * itemsize) % TMA_ALIGN:
            raise ValueError(
                f"{name}: stride {st} of dim {dim} is {st * itemsize} bytes, "
                f"not a multiple of {TMA_ALIGN}; the tensor-core kernel loads "
                f"it by TMA, which needs that")


def _tma_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Batch, head and sequence strides for the tensor map; a dim of size
    1 is never stepped, so it gets a stride TMA accepts whatever its own."""
    _, _, s, d = t.shape
    return tuple(st if n > 1 else s * d for n, st in zip(t.shape[:3], t.stride()[:3]))


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
    r = route(q.dtype, q.shape[3])
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    if r == "tensor_cores":
        for name, t in (("q", q), ("k", k), ("v", v)):
            tma_check(name, t.shape, t.stride(), t.data_ptr(), t.element_size())
    return _launch(r, q, k, v, causal, window)


def _launch(r: str, q, k, v, causal: bool, window: int | None) -> torch.Tensor:
    """Launch route ``r``'s kernel on checked CUDA inputs."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if r == "tensor_cores":
        st = [x for t in (q, k, v) for x in _tma_strides(t)]
        fn, extra = _lib_sm90().flash_fwd_sm90_launch, ()
    else:
        st = [x for t in (q, k, v) for x in t.stride()[:3]]
        fn, extra = _lib().flash_attention_launch, (DTYPES[q.dtype],)
    strides = (ctypes.c_longlong * 9)(*st)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.cast(strides, ctypes.c_void_p), b, hq, hkv, s, d,
                 d ** -0.5, int(causal), window or 0, *extra, stream)
    if err:
        raise RuntimeError(f"flash_attention ({r}) launch failed: "
                           f"{_describe(err)}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[r] += 1
    return out


def _describe(err: int) -> str:
    if err >= 2000:
        return "the CUDA driver has no cuTensorMapEncodeTiled"
    if err >= 1000:
        return f"cuTensorMapEncodeTiled returned CUresult {err - 1000}"
    return f"cudaError_t {err}"


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
