"""Wrapper of the SSD intra-chunk CUDA kernels (counterpart of
``repro/kernels/ssd/ssd.py::ssd_intra_chunk``).

``ssd_intra_chunk`` returns (y_intra (B,S,H,P), st (B,NC,H,N,P),
dec (B,S,H)), all float32, for float32 x (B,S,H,P), dt (B,S,H), a (H,)
and B, C (B,S,H,N), S a multiple of ``chunk``. For CPU tensors it runs
the plain version ``ref.ssd_intra_chunk_ref``. For CUDA tensors it
launches one of three kernels on the current stream, chosen by ``route``
from the shape, or raises; nothing falls back:

- ``tensor_cores``: chunk <= 128, P <= 64 and N <= 32 with P and N
  multiples of 4, ``csrc/ssd_chunk_sm90.cu`` (all three products on the
  tensor cores by ``mma.sync`` in three TF32 passes, tiles staged by
  cp.async).
- ``tensor_cores_wide``: the same chunk and P with 32 < N <= 128
  (mamba2-780m's N=128), ``csrc/ssd_chunk_sm90_wide.cu`` (the same
  products; B and C streamed in slices of 32 state columns, C B^T
  computed once for a group of heads that share B and C).
- ``cuda_cores``: every other shape, ``csrc/ssd_chunk.cu`` (the products
  on the CUDA cores from shared memory).

The two tensor-core kernels copy x, B and C 16 bytes at a time, which
needs 16-byte aligned base pointers and strides; ``cp_async_check``
refuses inputs that break that. All three kernels take the pairwise
decays L and the decays to the chunk's end from segment sums of dt A
(``ref.segsum``), never as exp(cum_i - cum_j), whose two large sums
cancel on the model's dt and A; cum gives only dec = exp(cum).

Inputs are read through their strides as long as the last dim is
contiguous, so B and C shared by all heads may come as a stride-0
``expand``. ``ssd_intra_chunk.launches`` counts kernel launches, and
nothing else; ``ssd_intra_chunk.launches_by_route`` splits them by route.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssd_chunk.cu"            # the CUDA-core kernel
SM90_SOURCE = CSRC / "ssd_chunk_sm90.cu"  # the tensor-core kernel, N <= 32
WIDE_SOURCE = CSRC / "ssd_chunk_sm90_wide.cu"  # the tensor-core kernel, N <= 128
SOURCES = (SOURCE, SM90_SOURCE, WIDE_SOURCE)
ROUTES = ("tensor_cores", "tensor_cores_wide", "cuda_cores")
# the largest chunk, head dim and state the tensor-core kernels take
SM90_MAX_CHUNK, SM90_MAX_P, SM90_MAX_N = 128, 64, 32
WIDE_MAX_N = 128
WIDE_SLICE = 32  # state columns of a slice of B and C in the wide kernel
CP_ASYNC_ALIGN = 16  # bytes, for base pointers and strides


def _bind(source: Path, name: str) -> ctypes.CDLL:
    lib = _build.load(source)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [vp] * 9 + [ci] * 6 + [vp]
    fn.restype = ci
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes = [ci] * 3
    smem.restype = ci
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(SOURCE, "ssd_chunk")


@functools.cache
def _lib_sm90() -> ctypes.CDLL:
    lib = _bind(SM90_SOURCE, "ssd_chunk_sm90")
    ci = ctypes.c_int
    lib.ssd_chunk_sm90_ctas_per_sm.argtypes = [ci] * 3 + [ctypes.POINTER(ci)]
    lib.ssd_chunk_sm90_ctas_per_sm.restype = ci
    return lib


@functools.cache
def _lib_wide() -> ctypes.CDLL:
    lib = _bind(WIDE_SOURCE, "ssd_chunk_sm90_wide")
    ci = ctypes.c_int
    lib.ssd_chunk_sm90_wide_plan.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]
    lib.ssd_chunk_sm90_wide_plan.restype = ci
    return lib


def wide_plan(b: int, s: int, h: int, p: int, n: int, chunk: int,
              shared: bool) -> dict:
    """How the wide kernel splits (B, S, H, P, N, chunk) on the current
    card: head groups a (batch, chunk) (each computes C B^T once; H where
    B or C differ by head), units of work, the persistent grid and CTAs
    an SM (builds the kernel if needed)."""
    out = (ctypes.c_int * 4)()
    err = _lib_wide().ssd_chunk_sm90_wide_plan(b, s, h, p, n, chunk, int(shared), out)
    if err:
        raise RuntimeError(f"ssd_chunk_sm90_wide_plan failed: cudaError_t {err}")
    return dict(zip(("head_groups", "units", "grid", "ctas_per_sm"), out))


def sm90_ctas_per_sm(chunk: int, n: int, p: int) -> int:
    """CTAs of the tensor-core kernel that share an SM of the current
    card at (chunk, N, P); its persistent grid is this times the SMs
    (builds the kernel if needed)."""
    out = ctypes.c_int(0)
    err = _lib_sm90().ssd_chunk_sm90_ctas_per_sm(chunk, n, p, ctypes.byref(out))
    if err:
        raise RuntimeError(f"ssd_chunk_sm90_ctas_per_sm failed: cudaError_t {err}")
    return out.value


@functools.cache
def _smem_limit(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


def sm90_smem_bytes(chunk: int, n: int, p: int) -> int:
    """Dynamic shared memory of one CTA of the tensor-core kernel: two
    stages of x (rows of P + 4 floats, P padded to 8), B and C (rows of
    N + 4, N padded to 8) and dt, over chunk rows padded to 16; then the
    segment-sum lines pre and sfx and w*dt (a padded chunk each), the
    mid sums between its 16-row sub-blocks (8 x 8) and one 16 x 16
    lower-triangular table of the diagonal block's segment sums for each
    of the 4 warps. ``ssd_chunk_sm90_smem_bytes`` in the source computes
    the same."""
    clp = -(-chunk // 16) * 16
    pp, np_ = -(-p // 8) * 8, -(-n // 8) * 8
    stage = clp * (pp + 4) + 2 * clp * (np_ + 4) + clp
    return 4 * (2 * stage + 3 * clp + 8 * 8 + 4 * (16 * 17 // 2))


def wide_smem_bytes(chunk: int, n: int, p: int) -> int:
    """Dynamic shared memory of one CTA of the wide tensor-core kernel: B
    whole (rows of N + 4 floats, N padded to 32), two slices of C (rows
    of 36) and two stages of x (rows of P + 4, P padded to 8) and dt,
    over chunk rows padded to 16; G's lower triangle of 16 x 16 blocks;
    the segment-sum lines pre, sfx and w*dt (a padded chunk each), the
    mid sums between 16-row sub-blocks (8 x 8), the sums before and
    after each (2 x 8) and one 16 x 16 lower-triangular table for each of
    the 8 warps. ``ssd_chunk_sm90_wide_smem_bytes`` in the source
    computes the same."""
    clp = -(-chunk // 16) * 16
    pp, np_ = -(-p // 8) * 8, -(-n // WIDE_SLICE) * WIDE_SLICE
    rt = clp // 16
    floats = (clp * (np_ + 4) + 2 * clp * (WIDE_SLICE + 4) + 2 * clp * (pp + 4)
              + 2 * clp + rt * (rt + 1) // 2 * 256 + 3 * clp + 8 * 8 + 2 * 8
              + 8 * (16 * 17 // 2))
    return 4 * floats


def route(chunk: int, n: int, p: int) -> str:
    """The kernel that runs the intra-chunk pass at chunk length
    ``chunk``, state ``n`` and head dim ``p`` on the card. Every shape
    the tensor-core kernels take fits an H100 block's shared memory
    (148,352 B at most for N <= 32, 218,176 B for the wide kernel,
    against 232,448)."""
    if (chunk <= SM90_MAX_CHUNK and 0 < p <= SM90_MAX_P and p % 4 == 0
            and 0 < n and n % 4 == 0):
        if n <= SM90_MAX_N:
            return "tensor_cores"
        if n <= WIDE_MAX_N:
            return "tensor_cores_wide"
    return "cuda_cores"


def cp_async_check(name: str, t: torch.Tensor) -> None:
    """Raise ValueError unless the tensor-core kernel can copy ``t``'s
    rows 16 bytes at a time: a 16-byte aligned base pointer and, for
    every dim but the last of size above 1, a stride that is a multiple
    of 16 bytes (0, a dim shared by expand, is one)."""
    ptr, size = t.data_ptr(), t.element_size()
    if ptr % CP_ASYNC_ALIGN:
        raise ValueError(
            f"{name}: base pointer {ptr:#x} is not {CP_ASYNC_ALIGN}-byte aligned; "
            f"the tensor-core kernel copies it 16 bytes at a time")
    for dim, (n, st) in enumerate(zip(t.shape[:-1], t.stride()[:-1])):
        if n > 1 and (st * size) % CP_ASYNC_ALIGN:
            raise ValueError(
                f"{name}: stride {st} of dim {dim} is {st * size} bytes, not a "
                f"multiple of {CP_ASYNC_ALIGN}; the tensor-core kernel copies "
                f"its rows 16 bytes at a time")


def check_operands(r: str, **tensors: torch.Tensor) -> None:
    """What route ``r``'s kernel needs of its inputs on the card: float32,
    a contiguous last dim, and on the tensor-core routes the 16-byte rules
    of ``cp_async_check`` for x, bmat and cmat (dt is copied 4 bytes at
    a time, and a is copied contiguous)."""
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        if t.stride(-1) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous")
        if r != "cuda_cores" and name in ("x", "bmat", "cmat"):
            cp_async_check(name, t)


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
    r = route(chunk, n, p)
    check_operands(r, x=x, dt=dt, a=a, bmat=bmat, cmat=cmat)
    return _launch(r, x, dt, a, bmat, cmat, chunk)


def _launch(r: str, x, dt, a, bmat, cmat, chunk: int):
    """Launch route ``r``'s kernel on checked CUDA inputs."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    if r == "tensor_cores":
        lib, name = _lib_sm90(), "ssd_chunk_sm90"
    elif r == "tensor_cores_wide":
        lib, name = _lib_wide(), "ssd_chunk_sm90_wide"
    else:
        lib, name = _lib(), "ssd_chunk"
        smem = lib.ssd_chunk_smem_bytes(chunk, n, p)
        limit = _smem_limit(dev.index if dev.index is not None
                            else torch.cuda.current_device())
        if smem > limit:
            raise ValueError(f"ssd_intra_chunk: chunk={chunk}, N={n}, P={p} need "
                             f"{smem} bytes of shared memory per block, above "
                             f"the card's {limit}")
    nc = s // chunk
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=dev)
    st = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=dev)
    dec = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    if y.numel() == 0 or st.numel() == 0:
        return y, st.zero_(), dec
    strides = (ctypes.c_longlong * 12)(
        *x.stride()[:3], *dt.stride()[:3], *bmat.stride()[:3], *cmat.stride()[:3])
    a = a.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, s, h, p, n, chunk, stream)
    if err:
        raise RuntimeError(f"ssd_intra_chunk ({r}) launch failed: cudaError_t {err}")
    ssd_intra_chunk.launches += 1
    ssd_intra_chunk.launches_by_route[r] += 1
    return y, st, dec


ssd_intra_chunk.launches = 0
ssd_intra_chunk.launches_by_route = dict.fromkeys(ROUTES, 0)
