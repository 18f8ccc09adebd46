"""Wrapper of the hdp_z CUDA kernels (counterpart of
``repro/kernels/hdp_z/hdp_z.py::hdp_z_pallas``).

``hdp_z_cuda`` runs one z-sweep. Table mode takes ``q_a``/``fpack``/
``ipack``; prologue mode takes ``apsi``/``vals``/``ids`` (the reference
passes apsi in the q_a slot; here each has its own argument). For CPU
tensors it runs the plain version in ``ref.py``. For CUDA tensors it
launches one of two kernels on the current stream, chosen by ``route``
from the shapes and the card's shared memory, or raises; nothing falls
back:

- ``lanes``: ``csrc/hdp_z_lanes.cu``, one document per lane, m in shared
  memory as uint16 (2 K bytes a document), each walk bounded by the
  word's live slots (``live_slots``). Taken when one warp's 32
  documents fit (with apsi staged per block in prologue mode) and
  L <= 32767.
- ``warp``: ``csrc/hdp_z.cu``, one document per warp, m as int32 and
  W-wide scratch lines in shared memory, every walk over all W slots.

Table mode takes float32 ``fpack``/int32 ``ipack`` or compact tables,
bf16 ``fpack``/int16 ``ipack`` (K <= 32768, ``COMPACT_MAX_K``), on
both routes; each kernel widens a row's elements as it reads them, which
is exact, so a sweep on compact tables is bitwise the one on their
widened copies. Prologue mode reads float32 supports only. The tables
stay in global memory on both routes, so their element size moves no
route's shared memory.

Both are bitwise equal to the plain version. ``hdp_z_cuda.launches``
counts kernel launches, and nothing else;
``hdp_z_cuda.launches_by_route`` splits them by route.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hdp_z.ref import hdp_z_ref, hdp_z_ref_prologue

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "hdp_z.cu"               # the warp kernel
LANES_SOURCE = CSRC / "hdp_z_lanes.cu"   # the lanes kernel
SOURCES = (LANES_SOURCE, SOURCE)
ROUTES = ("lanes", "warp")
MAX_WARPS_PER_BLOCK = 8
LANES = 32
# m is uint16 on the lanes route, and a count reaches at most L
LANES_MAX_L = 2**15 - 1
# compact tables hold topic ids as int16
COMPACT_MAX_K = 2**15
# table mode's (fpack, ipack) element types: float32 tables, compact tables
TABLE_DTYPES = ((torch.float32, torch.int32), (torch.bfloat16, torch.int16))
_COUNT_LOCK = threading.Lock()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hdp_z_launch.argtypes = [vp] * 11 + [ci] * 7 + [vp]
    lib.hdp_z_launch.restype = ci
    return lib


@functools.cache
def _lib_lanes() -> ctypes.CDLL:
    lib = _build.load(LANES_SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.hdp_z_lanes_launch.argtypes = [vp] * 13 + [ci] * 9 + [vp]
    lib.hdp_z_lanes_launch.restype = ci
    lib.hdp_z_lanes_smem_limit.argtypes = [ci, ctypes.POINTER(ci)]
    lib.hdp_z_lanes_smem_limit.restype = ci
    return lib


def smem_limit(device: torch.device) -> int:
    """Largest dynamic shared memory one block may opt in to on
    ``device`` (232,448 bytes on an H100)."""
    return _smem_limit(device.index if device.index is not None
                       else torch.cuda.current_device())


@functools.cache
def _smem_limit(index: int) -> int:
    out = ctypes.c_int(0)
    err = _lib_lanes().hdp_z_lanes_smem_limit(index, ctypes.byref(out))
    if err:
        raise RuntimeError(f"hdp_z: cudaDeviceGetAttribute failed ({err})")
    return out.value


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
    """Shared memory one document's warp uses on the warp route: m (K
    int32) and W-wide scratch lines (1 in table mode, 5 in prologue
    mode)."""
    return 4 * (kk + (5 if in_kernel else 1) * w)


def lanes_smem_bytes(kk: int, in_kernel: bool, warps: int = 1) -> int:
    """Shared memory of one block of ``warps`` warps on the lanes route:
    each warp's 32 documents' m (K uint16 each) and its 32 x 33 int32
    tile that stages m out and, in prologue mode, apsi (K float32,
    padded to 16 bytes) once per block."""
    apsi = (4 * kk + 15) // 16 * 16 if in_kernel else 0
    return apsi + warps * (LANES * 2 * kk + 4 * LANES * (LANES + 1))


def lanes_warps(kk: int, in_kernel: bool, limit: int) -> int:
    """Warps a block of the lanes route holds under ``limit`` bytes."""
    per_warp = lanes_smem_bytes(kk, in_kernel, 1) - lanes_smem_bytes(kk, in_kernel, 0)
    room = limit - lanes_smem_bytes(kk, in_kernel, 0)
    return max(1, min(MAX_WARPS_PER_BLOCK, room // per_warp))


def route(kk: int, l: int, in_kernel: bool, limit: int) -> str:
    """The kernel that sweeps K topics over documents of length L on a
    card whose blocks may opt in to ``limit`` bytes of shared memory.
    The tables' element size (float32 or compact) does not enter: both
    routes read the tables from global memory."""
    if l <= LANES_MAX_L and lanes_smem_bytes(kk, in_kernel) <= limit:
        return "lanes"
    return "warp"


def live_slots(vals: torch.Tensor, apsi: torch.Tensor | None = None,
               ids: torch.Tensor | None = None) -> torch.Tensor:
    """(V,) int32: 1 + the index of each row's last slot whose value is
    non-zero or not finite, 0 for a row with none. With ``apsi`` and
    ``ids`` (prologue mode) a slot whose ``apsi[id]`` is not finite also
    counts, since 0 * inf is NaN. Every slot past it adds +-0.0 to each
    of the sweep's sums, so the lanes kernel stops its walks there.
    Computed on the tensors' device, with no host sync."""
    nz = (vals != 0) | ~torch.isfinite(vals)
    if apsi is not None:
        nz |= ~torch.isfinite(apsi[ids.to(torch.int64)])
    pos = torch.arange(1, vals.shape[-1] + 1, device=vals.device, dtype=torch.int32)
    return torch.where(nz, pos, 0).amax(-1).to(torch.int32)


def hdp_z_cuda(
    tokens: torch.Tensor,    # (D, L) int32
    mask: torch.Tensor,      # (D, L) bool
    z: torch.Tensor,         # (D, L) int32
    uniforms: torch.Tensor,  # (D, L, 3) f32 in [0, 1)
    *,
    kk: int,
    q_a: torch.Tensor | None = None,    # table mode (V,) f32
    fpack: torch.Tensor | None = None,  # table mode (V, 2, W) f32 or bf16
    ipack: torch.Tensor | None = None,  # table mode (V, 2, W) int32 or int16
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
    if not in_kernel and fpack.dtype == torch.bfloat16 and kk > COMPACT_MAX_K:
        raise ValueError(f"compact tables hold int16 topic ids: K={kk} is "
                         f"above {COMPACT_MAX_K}")
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
    else:
        vv, _, w = fpack.shape
        fdt, idt = next((pair for pair in TABLE_DTYPES if pair[0] == fpack.dtype),
                        TABLE_DTYPES[0])
        _check("q_a", q_a, torch.float32, (vv,), dev)
        _check("fpack", fpack, fdt, (vv, 2, w), dev)
        _check("ipack", ipack, idt, (vv, 2, w), dev)
    _check("tokens", tokens, torch.int32, (d, l), dev)
    _check("mask", mask, torch.bool, (d, l), dev)
    _check("z", z, torch.int32, (d, l), dev)
    _check("uniforms", uniforms, torch.float32, (d, l, 3), dev)
    if w < 1 or kk < 1:
        raise ValueError(f"need W >= 1 and K >= 1, got W={w}, K={kk}")
    r = route(kk, l, in_kernel, smem_limit(dev))
    return _launch(r, tokens, mask, z, uniforms, kk=kk, q_a=q_a, fpack=fpack,
                   ipack=ipack, apsi=apsi, vals=vals, ids=ids,
                   emit_delta=emit_delta)


def _launch(r: str, tokens, mask, z, uniforms, *, kk, q_a=None, fpack=None,
            ipack=None, apsi=None, vals=None, ids=None, emit_delta=False):
    """Launch route ``r``'s kernel on inputs ``hdp_z_cuda`` has checked."""
    dev = tokens.device
    d, l = tokens.shape
    in_kernel = apsi is not None
    fvals, ivals = (vals, ids) if in_kernel else (fpack, ipack)
    compact = int(fvals.dtype == torch.bfloat16)
    vv, w = fvals.shape[0], fvals.shape[-1]
    # the lanes kernel writes live positions only: padding keeps its z
    z_out = z.clone() if r == "lanes" else torch.empty_like(z)
    m = torch.empty((d, kk), dtype=torch.int32, device=dev)
    dn = (torch.zeros((kk, vv), dtype=torch.int32, device=dev)
          if emit_delta else None)
    if not (d and l):
        m.zero_()
        z_out.copy_(z)
        return (z_out, m, dn) if emit_delta else (z_out, m)
    limit = smem_limit(dev)
    common = (tokens.data_ptr(), mask.data_ptr(), z.data_ptr(),
              uniforms.data_ptr(), None if in_kernel else q_a.data_ptr(),
              apsi.data_ptr() if in_kernel else None,
              fvals.data_ptr(), ivals.data_ptr())
    outs = (z_out.data_ptr(), m.data_ptr(),
            dn.data_ptr() if emit_delta else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if r == "lanes":
            if route(kk, l, in_kernel, limit) != "lanes":
                raise ValueError(
                    f"hdp_z (lanes): L={l} and K={kk} need L <= {LANES_MAX_L} "
                    f"and {lanes_smem_bytes(kk, in_kernel)} bytes of shared "
                    f"memory, above the card's {limit}-byte limit per block")
            live = (live_slots(vals, apsi, ids) if in_kernel
                    else live_slots(fpack[:, 0].float()))
            # longest documents first, so a warp's 32 are of about one length
            order = torch.argsort(mask.sum(1, dtype=torch.int32), descending=True,
                                  stable=True).to(torch.int32)
            # 4 slots a load: 16 bytes of float32/int32 or 8 of bf16/int16;
            # with W % 4 == 0 every row and piece then stays aligned
            vec_rows = (w % 4 == 0
                        and fvals.data_ptr() % (4 * fvals.element_size()) == 0
                        and ivals.data_ptr() % (4 * ivals.element_size()) == 0)
            vec_pos = (l % 4 == 0 and mask.data_ptr() % 4 == 0 and all(
                t.data_ptr() % 16 == 0 for t in (tokens, z, uniforms)))
            err = _lib_lanes().hdp_z_lanes_launch(
                *common, live.data_ptr(), order.data_ptr(), *outs, d, l, kk, vv, w,
                lanes_warps(kk, in_kernel, limit), int(vec_rows), int(vec_pos),
                compact, stream)
        elif r == "warp":
            per_warp = smem_bytes_per_warp(kk, w, in_kernel)
            if per_warp > limit:
                raise ValueError(
                    f"hdp_z (warp): one document needs {per_warp} bytes of "
                    f"shared memory (K={kk}, W={w}), above the card's "
                    f"{limit}-byte limit per block; K*4 + "
                    f"{5 if in_kernel else 1}*W*4 must fit")
            warps = max(1, min(MAX_WARPS_PER_BLOCK, limit // per_warp))
            err = _lib().hdp_z_launch(*common, *outs, d, l, kk, vv, w, warps,
                                      compact, stream)
        else:
            raise ValueError(f"unknown hdp_z route {r!r}; one of {ROUTES}")
    if err:
        raise RuntimeError(f"hdp_z ({r}) kernel launch failed: cudaError_t {err}")
    with _COUNT_LOCK:  # fleet workers launch from several threads
        hdp_z_cuda.launches += 1
        hdp_z_cuda.launches_by_route[r] += 1
    return (z_out, m, dn) if emit_delta else (z_out, m)


hdp_z_cuda.launches = 0
hdp_z_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)
