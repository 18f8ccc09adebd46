"""Pluggable z-slab storage (counterpart of ``repro/data/zstore.py``): one
abstraction for live training state and checkpoints.

z, the topic indicators, is the largest state of a streamed run (O(corpus)
beside the O(K V) model). ``ZSlabStore`` holds it as (DB, L) slabs, one a
corpus block, host-side numpy:

  * ``RamZStore``: every slab in one host array; reads are views, writes
    are in-place row stores.
  * ``DiskZStore``: slabs as immutable per-block version files
    (``zstore/block_<b>.v<ver>.npy``, the layout checkpoints use, kept by
    ``ZBlockStore``), with only the slabs in flight held in host memory:
    at most ``prefetch_depth + writeback_depth + 1``. A checkpoint into
    the store's own root pins the current version vector and copies
    nothing.

Both give bitwise the same chains. Slabs may be packed to
``pack_dtype_for(K)`` (uint8 for K <= 256, uint16 for K <= 65536): ``read``
hands out packed slabs, which is what crosses to the card, and ``write``
narrows what it lands; ``peek``/``materialize`` return int32. Both casts
are exact for topics in [0, K).

Consistency: version files are immutable, and a committed checkpoint
manifest references only files written before its commit, so a crash
leaves at worst orphan version files, which ``ZBlockStore.gc`` sweeps
against the union of the retained manifests' version vectors and the
live store's current versions.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import threading
import weakref
from typing import Callable, Optional

import numpy as np

from repro_torch import obs

# Content stamps are process-global monotone counters so that two slab
# stores (e.g. two chains driven by one StreamingHDP in tests) can save
# into the same checkpoint directory without stamp collisions: a
# ZBlockStore's written_stamp can never accidentally match a slab it has
# not actually written.
_STAMP_LOCK = threading.Lock()
_STAMP = 0


def _next_stamp() -> int:
    global _STAMP
    with _STAMP_LOCK:
        _STAMP += 1
        return _STAMP


def pack_dtype_for(k: int) -> np.dtype:
    """Narrowest unsigned dtype that holds topic indices in [0, k):
    uint8 for K* <= 256, uint16 for K* <= 65536, else int32 (no packing).
    Narrow/widen round-trips are exact for every legal z value, so packed
    slabs are bitwise-interchangeable with int32 ones."""
    if k <= 2 ** 8:
        return np.dtype(np.uint8)
    if k <= 2 ** 16:
        return np.dtype(np.uint16)
    return np.dtype(np.int32)


class ZBlockStore:
    """Per-block immutable z-slab version files: the shared persistence
    layer under both incremental checkpoints and ``DiskZStore``.

    Each write lands in its own ``zstore/block_<b>.v<ver>.npy`` file — a
    new version file per write, never an overwrite, so a crash mid-write
    can only corrupt a file no committed manifest references. Checkpoint
    payloads carry just the (B,) version vector; restore loads each
    block at its recorded version (version -1 denotes the implicit
    all-zeros slab a fresh ``DiskZStore`` starts from, so stores that
    checkpoint before their first sweep need no files at all).

    Staleness is tracked by content *stamps* (process-global monotone
    counters bumped on every slab write): ``sync`` rewrites exactly the
    blocks whose in-memory stamp differs from the stamp last written to
    THIS store, so alternating save dirs stay individually consistent.

    ``gc`` sweeps EVERY on-disk version file not in the caller's
    referenced set — including orphans left by a crash between a version
    file landing and the manifest commit that would have referenced it
    (regression-tested by forging exactly that state).
    """

    _FILE_RE = re.compile(r"^block_(\d+)\.v(\d+)\.npy$")

    def __init__(self, root_dir: str, num_blocks: int):
        self.root = os.path.abspath(root_dir)
        self.dir = os.path.join(self.root, "zstore")
        os.makedirs(self.dir, exist_ok=True)
        self.versions = np.full(num_blocks, -1, np.int64)
        self.written_stamp = np.full(num_blocks, -1, np.int64)
        # never reuse a version number that may exist on disk (including
        # orphans from a crashed writer): scan at open.
        self._next_ver = 0
        self._rescan_next_ver()

    def _path(self, b: int, ver: int) -> str:
        return os.path.join(self.dir, f"block_{b}.v{ver}.npy")

    def _rescan_next_ver(self):
        """Bump ``_next_ver`` past anything on disk. Called per ``sync``
        so that a checkpoint dir written to by several store instances
        (e.g. two drivers alternating saves) never reuses — and thereby
        overwrites — a version number another instance committed."""
        vers = [int(m.group(2)) for m in
                (self._FILE_RE.match(f) for f in os.listdir(self.dir)) if m]
        self._next_ver = max(self._next_ver, max(vers, default=-1) + 1)

    def write_block(self, b: int, arr: np.ndarray, stamp: int) -> int:
        """Write one slab as a new immutable version file; returns the
        version. Used by ``DiskZStore`` live writes (one version per
        block sweep)."""
        ver = self._next_ver
        if os.path.exists(self._path(b, ver)):
            # another store instance committed this (b, ver) into the
            # directory since our last scan (e.g. a second chain
            # checkpointing here): never overwrite an immutable file.
            self._rescan_next_ver()
            ver = self._next_ver
        self._next_ver = ver + 1
        a = np.asarray(arr)
        if a.dtype not in (np.uint8, np.uint16, np.int32):
            a = a.astype(np.int32)
        np.save(self._path(b, ver), a)
        self.versions[b] = ver
        self.written_stamp[b] = stamp
        return ver

    def sync(self, read_slab: Callable[[int], np.ndarray],
             stamps: np.ndarray) -> tuple:
        """Write blocks whose content stamp moved since the last sync to
        this store; returns (version vector, blocks written).
        ``read_slab(b)`` supplies the slab content (an array row for
        ``RamZStore``, a disk read for a foreign-dir ``DiskZStore``
        sync)."""
        self._rescan_next_ver()
        ver = self._next_ver
        wrote = 0
        for b in range(len(self.versions)):
            if self.versions[b] >= 0 and self.written_stamp[b] == stamps[b]:
                continue
            np.save(self._path(b, ver), read_slab(b))
            self.versions[b] = ver
            self.written_stamp[b] = stamps[b]
            wrote += 1
        if wrote:
            self._next_ver = ver + 1
        return self.versions.copy(), wrote

    def load_block(self, b: int, ver: int,
                   block_shape: Optional[tuple] = None,
                   dtype=np.int32) -> np.ndarray:
        """One slab at its recorded version, cast to ``dtype``; version
        -1 is the implicit zero slab (needs ``block_shape``). Version
        files written at a different dtype (e.g. an int32 checkpoint
        restored into a packed store, or vice versa) load
        interchangeably — topic indices fit every legal dtype."""
        if ver < 0:
            if block_shape is None:
                raise ValueError(
                    f"block {b} recorded at version -1 (implicit zeros) "
                    "but no block_shape was provided"
                )
            return np.zeros(block_shape, dtype)
        arr = np.load(self._path(b, int(ver)))
        return arr if arr.dtype == dtype else arr.astype(dtype)

    def load(self, versions: np.ndarray,
             block_shape: Optional[tuple] = None,
             dtype=np.int32) -> np.ndarray:
        """Materialize every block at its recorded version into one
        (B, DB, L) array — the RAM-backend restore path; O(corpus) host
        memory by design."""
        return np.stack([self.load_block(b, int(v), block_shape, dtype)
                         for b, v in enumerate(versions)])

    def delete(self, b: int, ver: int):
        """Best-effort removal of one superseded, unpinned version file
        (``DiskZStore`` eager reclamation between checkpoints)."""
        try:
            os.remove(self._path(b, ver))
        except OSError:
            pass

    def mark_loaded(self, versions: np.ndarray, stamps: np.ndarray):
        """After a restore: disk content at ``versions`` IS the current
        in-memory content (stamps), so nothing is dirty."""
        self.versions = np.asarray(versions, np.int64).copy()
        self.written_stamp = np.asarray(stamps, np.int64).copy()

    def gc(self, referenced: set):
        """Delete every on-disk version file not in ``referenced`` (a
        set of (block, version) pairs: the union of all retained
        checkpoint manifests' pinned version vectors plus the live
        store's current versions). This sweeps superseded versions AND
        orphans — files fully or partially written by a writer that
        crashed before committing the manifest that would have
        referenced them."""
        for f in os.listdir(self.dir):
            m = self._FILE_RE.match(f)
            if m and (int(m.group(1)), int(m.group(2))) not in referenced:
                try:
                    os.remove(os.path.join(self.dir, f))
                except OSError:
                    pass


class ZSlabStore:
    """Storage protocol for per-block z slabs (shared base).

    The live training loop only ever touches slabs through this surface:

      ``read(b)``        check a slab out for staging (host-resident
                         until ``release``/``write``)
      ``release(b)``     host copy no longer needed (it was staged to
                         device unchanged)
      ``write(b, arr)``  store the swept slab back (checks the slab in
                         and bumps its content stamp)
      ``peek(b)`` / ``store[b]``   read-only copy, no residency tracking
      ``materialize()``  full (B, DB, L) array — O(corpus) host memory,
                         tests/export only

    and the checkpoint system through:

      ``sync_to(zbs)``       flush dirty slabs into a ``ZBlockStore``;
                             returns the version vector to pin in the
                             payload manifest
      ``load_from(zbs, v)``  adopt checkpointed content
      ``pin_versions(zbs, refs)`` / ``live_versions_in(zbs)``
                             GC bookkeeping (which files manifests pin,
                             which files are live state)

    ``resident_slabs`` / ``high_water`` count slabs the store is holding
    (or writing) in host memory; the streaming pipeline's bound is
    ``prefetch_depth + writeback_depth + 1``.

    ``dtype`` is the storage dtype (``pack_dtype_for``): ``read`` hands
    out packed slabs (the H2D transport representation), ``write``
    narrows what it lands (counting the landed bytes in
    ``bytes_written``), while ``peek``/``materialize`` always return
    int32 — the sampler's working dtype.
    """

    kind = "abstract"

    def __init__(self, num_blocks: int, block_shape: tuple,
                 dtype=np.int32):
        self.num_blocks = num_blocks
        self.block_shape = tuple(int(x) for x in block_shape)
        self.dtype = np.dtype(dtype)
        self.bytes_written = 0
        # bytes moved by actual storage I/O on the hot read path: the
        # RAM backend hands out views (no I/O, stays 0), the disk
        # backend counts every slab file it loads for staging.
        self.bytes_read = 0
        self.stamps = np.zeros(num_blocks, np.int64)
        self._res_lock = threading.Lock()
        self._resident: dict[int, int] = {}
        self.high_water = 0
        for b in range(num_blocks):
            self.touch(b)  # fresh zero content: every slab is save-dirty

    def _packed(self, arr: np.ndarray) -> np.ndarray:
        a = np.asarray(arr)
        return a if a.dtype == self.dtype else a.astype(self.dtype)

    # -- dirty tracking ----------------------------------------------------
    def touch(self, b: int):
        self.stamps[b] = _next_stamp()

    # -- residency bookkeeping --------------------------------------------
    def _checkout(self, b: int):
        with self._res_lock:
            self._resident[b] = self._resident.get(b, 0) + 1
            self.high_water = max(self.high_water,
                                  sum(self._resident.values()))

    def _checkin(self, b: int):
        with self._res_lock:
            c = self._resident.get(b, 0) - 1
            if c <= 0:
                self._resident.pop(b, None)
            else:
                self._resident[b] = c

    @property
    def resident_slabs(self) -> int:
        with self._res_lock:
            return sum(self._resident.values())

    # -- conveniences ------------------------------------------------------
    def __getitem__(self, b: int) -> np.ndarray:
        return self.peek(b)

    def __array__(self, dtype=None, copy=None):
        arr = self.materialize()
        return arr.astype(dtype) if dtype is not None else arr

    def materialize(self) -> np.ndarray:
        """Full (B, DB, L) int32 array. O(corpus) host memory — for
        tests, exports, and small runs only."""
        return np.stack([self.peek(b) for b in range(self.num_blocks)])

    # -- subclass surface --------------------------------------------------
    def read(self, b: int) -> np.ndarray:
        raise NotImplementedError

    def release(self, b: int):
        raise NotImplementedError

    def write(self, b: int, arr: np.ndarray):
        raise NotImplementedError

    def peek(self, b: int) -> np.ndarray:
        raise NotImplementedError

    def sync_to(self, zbs: ZBlockStore) -> tuple:
        raise NotImplementedError

    def load_from(self, zbs: ZBlockStore, versions: np.ndarray):
        raise NotImplementedError

    def blockstore_for(self, root_dir: str) -> Optional[ZBlockStore]:
        """The store's own ``ZBlockStore`` when ``root_dir`` is its home
        (live files double as checkpoint files there), else None."""
        return None

    def live_versions_in(self, zbs: ZBlockStore) -> set:
        """(block, version) pairs in ``zbs`` that are live training
        state (must survive GC even when no manifest references them)."""
        return set()

    def pin_versions(self, zbs: ZBlockStore, referenced: set):
        """Record which versions in ``zbs`` retained checkpoint
        manifests reference (protects them from eager reclamation)."""


class RamZStore(ZSlabStore):
    """All slabs resident in one host array — the pre-refactor behavior,
    bitwise-identical: reads hand out views of the backing array and
    writes store rows in place, so the training loop sees exactly the
    same buffers it did when ``StreamingState.z_blocks`` was a raw
    ndarray."""

    kind = "ram"

    def __init__(self, num_blocks: int, block_shape: tuple,
                 dtype=np.int32):
        super().__init__(num_blocks, block_shape, dtype)
        self._arr = np.zeros((num_blocks,) + self.block_shape, self.dtype)
        # the whole array is always resident — report that honestly
        self.high_water = num_blocks

    @property
    def resident_slabs(self) -> int:
        return self.num_blocks

    def read(self, b: int) -> np.ndarray:
        # the hot path: a view, exactly the buffer the pre-refactor loop
        # staged (read/release/write callers never mutate it in place).
        # Packed stores hand out the packed view — the H2D copy moves
        # dtype-sized bytes; the driver widens on device.
        return self._arr[b]

    def release(self, b: int):
        pass

    def write(self, b: int, arr: np.ndarray):
        self._arr[b] = self._packed(arr)
        self.bytes_written += self._arr[b].nbytes
        self.touch(b)

    def peek(self, b: int) -> np.ndarray:
        # a copy, matching DiskZStore: peek is the public read surface,
        # and a live view here would let callers mutate training state
        # under one backend but not the other.
        return self._arr[b].astype(np.int32)

    def materialize(self) -> np.ndarray:
        # a copy, not the live backing array: DiskZStore.materialize is
        # necessarily a fresh array, and an aliased "snapshot" that kept
        # mutating under write-back would make the backends observably
        # different.
        return self._arr.astype(np.int32)

    def sync_to(self, zbs: ZBlockStore) -> tuple:
        return zbs.sync(lambda b: self._arr[b], self.stamps)

    def load_from(self, zbs: ZBlockStore, versions: np.ndarray):
        self._arr = zbs.load(np.asarray(versions, np.int64),
                             self.block_shape, self.dtype)
        for b in range(self.num_blocks):
            self.touch(b)  # loaded content IS the current content
        zbs.mark_loaded(versions, self.stamps)


class DiskZStore(ZSlabStore):
    """Out-of-core slabs: immutable per-block version files under
    ``<root>/zstore/``, with only in-flight slabs host-resident.

    ``read`` loads the block's current version from disk (version -1 —
    never swept — is an implicit zero slab, no file); ``write`` lands a
    new version file and eagerly reclaims the superseded one unless a
    retained checkpoint manifest pins it, so steady-state disk usage is
    one file per block plus whatever retained checkpoints reference.

    Checkpointing to ``root`` itself is near-free: ``sync_to`` returns
    the current version vector with zero I/O, because every live write
    already produced the immutable file the manifest will reference.
    Restoring from ``root`` is equally free (adopt the version vector);
    restoring from a foreign directory copies slabs over one at a time
    (bounded host memory).

    One live run per root directory: two stores writing the same root
    concurrently would race the version counter.
    """

    kind = "disk"

    def __init__(self, num_blocks: int, block_shape: tuple, *,
                 root: Optional[str] = None, dtype=np.int32):
        super().__init__(num_blocks, block_shape, dtype)
        if root is None:
            root = tempfile.mkdtemp(prefix="repro-zslabs-")
            self._cleanup = weakref.finalize(
                self, shutil.rmtree, root, ignore_errors=True
            )
        self.root = os.path.abspath(root)
        self._zbs = ZBlockStore(self.root, num_blocks)
        self._pinned: set = set()

    def read(self, b: int) -> np.ndarray:
        self._checkout(b)
        try:
            # packed stores keep packed files AND hand out packed slabs:
            # the disk read and the H2D copy both move dtype-sized bytes.
            with obs.tracer().span("zstore_read", cat="zstore", block=b):
                arr = self._zbs.load_block(b, int(self._zbs.versions[b]),
                                           self.block_shape, self.dtype)
        except BaseException:
            # a failed load checked nothing out for the caller to
            # release — undo, or the resident-slab accounting (and the
            # prefetcher's high-water bound) leaks across the error.
            self._checkin(b)
            raise
        self.bytes_read += arr.nbytes
        return arr

    def release(self, b: int):
        self._checkin(b)

    def write(self, b: int, arr: np.ndarray):
        self._checkout(b)  # the slab is host-resident while being written
        try:
            old = int(self._zbs.versions[b])
            self.touch(b)
            packed = self._packed(arr)
            with obs.tracer().span("zstore_write", cat="zstore", block=b):
                self._zbs.write_block(b, packed, int(self.stamps[b]))
            self.bytes_written += packed.nbytes
            if old >= 0 and (b, old) not in self._pinned:
                self._zbs.delete(b, old)
        finally:
            self._checkin(b)

    def peek(self, b: int) -> np.ndarray:
        return self._zbs.load_block(b, int(self._zbs.versions[b]),
                                    self.block_shape)

    def sync_to(self, zbs: ZBlockStore) -> tuple:
        if zbs is self._zbs:
            # live files ARE the checkpoint files: pin, don't copy.
            return self._zbs.versions.copy(), 0
        return zbs.sync(self.peek, self.stamps)

    def load_from(self, zbs: ZBlockStore, versions: np.ndarray):
        versions = np.asarray(versions, np.int64)
        if zbs is self._zbs:
            # restore from home: adopt the vector, zero I/O.
            for b in range(self.num_blocks):
                self.touch(b)
            self._zbs.mark_loaded(versions, self.stamps)
            return
        for b in range(self.num_blocks):
            self.write(b, zbs.load_block(b, int(versions[b]),
                                         self.block_shape))
        zbs.mark_loaded(versions, self.stamps)

    def blockstore_for(self, root_dir: str) -> Optional[ZBlockStore]:
        if os.path.abspath(root_dir) == self.root:
            return self._zbs
        return None

    def live_versions_in(self, zbs: ZBlockStore) -> set:
        if zbs is not self._zbs:
            return set()
        return {(b, int(v)) for b, v in enumerate(self._zbs.versions)
                if v >= 0}

    def pin_versions(self, zbs: ZBlockStore, referenced: set):
        if zbs is self._zbs:
            self._pinned = set(referenced)


def make_zslab_store(kind: str, num_blocks: int, block_shape: tuple, *,
                     root: Optional[str] = None,
                     dtype=np.int32) -> ZSlabStore:
    """Backend factory: ``kind`` is "ram" or "disk" (``root`` names the
    disk backend's home directory — point it at the checkpoint directory
    for near-free saves; default is a self-cleaning temp dir).
    ``dtype`` packs the slabs (``pack_dtype_for(K)``) — values are
    bitwise-identical through any dtype that holds [0, K)."""
    if kind == "ram":
        return RamZStore(num_blocks, block_shape, dtype)
    if kind == "disk":
        return DiskZStore(num_blocks, block_shape, root=root, dtype=dtype)
    raise ValueError(
        f"unknown z-slab store kind {kind!r} (expected 'ram' or 'disk')"
    )
