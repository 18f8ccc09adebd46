"""Sparse bit-packed wire format for ``delta_n`` exchange (the port's copy
of ``repro/data/deltawire.py``: the same bytes on the wire).

The data-parallel z-sweep (core/streaming.py lane mode) has each device
sweep a disjoint row shard of a corpus block and emit its exact integer
``delta_n`` contribution — a (K, V) int32 array that is typically very
sparse (the doubly-sparse z-step touches at most two cells per changed
token). The shards merge by plain integer addition, so the only thing
that needs to move between workers is the nonzero cells: COO-style
``(idx, count)`` pairs, each packed to the narrowest integer dtype that
holds it, with a dense fallback once the sparse encoding stops paying.

This module is the host-side half of that exchange and is deliberately
device-free (pure numpy): it is the wire protocol that later crosses
hosts once the trainer spans machines, where the packed bytes are
what hits the network. The device-side half — extracting the bounded
COO triplet ``(idx, val, nnz)`` from a device-resident delta without a
full D2H copy — lives in kernels/hdp_z/ops.py (``delta_sparsify``).

Wire layout per shard (``PackedDelta``):

  * ``kind="coo"`` — ``idx`` (flat C-order indices into the (K, V)
    grid; uint8 / uint16 / int32 by the max index) and ``val`` (the
    integer deltas; int8 / int16 / int32 by the max magnitude).
  * ``kind="dense"`` — the full grid at the narrowest value dtype.
    Chosen when the COO bytes would not beat the dense bytes, or above
    an explicit nnz-fraction threshold (``dense_threshold``).

``nbytes`` of a pack is its wire size (payload arrays only; the
constant-size header is ignored, same as the bench's other byte keys).
``reduce_packed`` merges shards in ascending shard order — the
canonical merge order — though integer addition makes any order
bitwise-identical.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

#: default nnz fraction above which a shard ships dense even if COO
#: would be marginally smaller (predictable wire size under churn).
DENSE_THRESHOLD = 0.25


class PackedDelta(NamedTuple):
    """One shard's ``delta_n`` contribution in wire form."""
    kind: str            # "coo" | "dense"
    shape: tuple         # (K, V) of the dense grid
    idx: Optional[np.ndarray]   # flat indices (coo) | None (dense)
    val: np.ndarray      # deltas (coo) | the dense grid (dense)

    @property
    def nbytes(self) -> int:
        n = int(self.val.nbytes)
        if self.idx is not None:
            n += int(self.idx.nbytes)
        return n


def idx_dtype_for(max_idx: int) -> np.dtype:
    """Narrowest dtype holding flat index ``max_idx`` (uint8 / uint16 /
    int32 — the widest tier matches the device-side extraction)."""
    if max_idx <= np.iinfo(np.uint8).max:
        return np.dtype(np.uint8)
    if max_idx <= np.iinfo(np.uint16).max:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


def val_dtype_for(min_val: int, max_val: int) -> np.dtype:
    """Narrowest signed dtype holding every delta in [min, max]."""
    for dt in (np.int8, np.int16):
        info = np.iinfo(dt)
        if info.min <= min_val and max_val <= info.max:
            return np.dtype(dt)
    return np.dtype(np.int32)


def pack_coo(idx: np.ndarray, val: np.ndarray, shape: tuple, *,
             dense_threshold: float = DENSE_THRESHOLD) -> PackedDelta:
    """Pack an already-extracted COO triplet (flat ``idx``, ``val``,
    both truncated to the true nnz) into wire form.

    This is the lane-mode hot path: the device-side ``delta_sparsify``
    hands over bounded arrays, the host truncates to nnz and packs here
    — the dense (K, V) grid is never materialized on the host unless
    the dense fallback fires.
    """
    idx = np.asarray(idx).reshape(-1)
    val = np.asarray(val).reshape(-1)
    if idx.shape != val.shape:
        raise ValueError(f"idx/val length mismatch: {idx.shape} vs "
                         f"{val.shape}")
    size = int(np.prod(shape))
    nnz = int(idx.size)
    if nnz:
        if int(idx.max()) >= size:
            raise ValueError("flat index out of range for shape "
                             f"{shape}")
        idt = idx_dtype_for(int(idx.max()))
        vdt = val_dtype_for(int(val.min()), int(val.max()))
    else:
        idt, vdt = np.dtype(np.uint8), np.dtype(np.int8)
    coo_bytes = nnz * (idt.itemsize + vdt.itemsize)
    dense_bytes = size * vdt.itemsize
    if coo_bytes >= dense_bytes or nnz > dense_threshold * size:
        dense = np.zeros((size,), vdt)
        np.add.at(dense, idx.astype(np.int64), val.astype(vdt))
        return PackedDelta("dense", tuple(shape), None,
                           dense.reshape(shape))
    return PackedDelta("coo", tuple(shape), idx.astype(idt),
                       val.astype(vdt))


def pack_delta(dn: np.ndarray, *,
               dense_threshold: float = DENSE_THRESHOLD) -> PackedDelta:
    """Pack a dense integer delta grid (tests / single-host callers)."""
    dn = np.asarray(dn)
    flat = dn.reshape(-1)
    idx = np.flatnonzero(flat)
    return pack_coo(idx, flat[idx], dn.shape,
                    dense_threshold=dense_threshold)


def unpack_delta(p: PackedDelta) -> np.ndarray:
    """Back to the dense int32 grid."""
    if p.kind == "dense":
        return np.asarray(p.val, np.int32).reshape(p.shape)
    out = np.zeros((int(np.prod(p.shape)),), np.int32)
    if p.idx is not None and p.idx.size:
        # += not np.add.at: pack never emits duplicate indices.
        out[p.idx.astype(np.int64)] = np.asarray(p.val, np.int32)
    return out.reshape(p.shape)


def reduce_packed(packs: Sequence[PackedDelta],
                  shape: Optional[tuple] = None) -> np.ndarray:
    """Merge shard contributions: sum of unpacked grids in ascending
    shard order (the canonical order — integer adds make any order
    bitwise-equal, but a fixed order keeps the cross-host protocol
    trivially reproducible). Returns the dense int32 merged delta."""
    if not packs and shape is None:
        raise ValueError("reduce_packed of zero shards needs a shape")
    shape = tuple(shape) if shape is not None else packs[0].shape
    out = np.zeros(shape, np.int32)
    for p in packs:
        if p.shape != shape:
            raise ValueError(f"shard shape {p.shape} != {shape}")
        if p.kind == "dense":
            out += np.asarray(p.val, np.int32).reshape(shape)
        elif p.idx is not None and p.idx.size:
            np.add.at(out.reshape(-1), p.idx.astype(np.int64),
                      np.asarray(p.val, np.int32))
    return out


def packed_nbytes(packs: Sequence[PackedDelta]) -> int:
    """Total wire bytes of a shard set (what a cross-host exchange
    would put on the network)."""
    return sum(p.nbytes for p in packs)
