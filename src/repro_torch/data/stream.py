"""Streaming corpus store and the host pipeline stages of a streamed
Gibbs iteration (counterpart of ``repro/data/stream.py``).

  * ``ShardedCorpusStore`` packs documents into ``num_blocks`` fixed-shape
    ``(DB, L)`` int32 blocks with boolean masks; the last block pads with
    rows whose mask is all False. Blocks live in RAM or in an
    ``np.memmap`` on disk (``save``/``open``).
  * ``BlockPrefetcher`` stages block b+1 (a daemon thread) while block b
    is swept, with an optional ``pre`` stage on its own thread (the
    driver's read of a block and its z slab) under one shared in-flight
    budget.
  * ``AsyncStage``/``BlockWriteback`` write swept blocks back on a daemon
    thread, so the driver never waits for a sweep it has queued; each
    work item is a span on the tracer (``repro_torch.obs``), "writeback"
    for the write-back.

The stages are device-agnostic: the streaming driver
(core/streaming.py) passes the functions that copy to and from the card
on side CUDA streams, ordered by events.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np

from repro_torch import obs
from repro_torch.data.corpus import Corpus


class CorpusBlock(NamedTuple):
    index: int
    tokens: np.ndarray  # (DB, L) int32
    mask: np.ndarray    # (DB, L) bool
    doc_start: int      # global row offset of this block


class ShardedCorpusStore:
    """Fixed-shape block view over a packed corpus: ``num_blocks`` blocks
    of ``block_docs`` (DB) rows, the final block padded with zero-mask
    rows. (The reference's ``doc_multiple``, which rounds DB to the mesh's
    document axes, has no counterpart: the port runs on one card.)
    """

    def __init__(self, tokens: np.ndarray, mask: np.ndarray, V: int,
                 block_docs: int):
        if block_docs <= 0:
            raise ValueError("block_docs must be positive")
        self.tokens = tokens
        self.mask = mask
        self.V = V
        self.block_docs = block_docs
        self.num_docs = tokens.shape[0]
        self.max_len = tokens.shape[1]
        self.num_blocks = max(
            (self.num_docs + block_docs - 1) // block_docs, 1
        )
        self._num_tokens: Optional[int] = None
        self._vocab_ids: Optional[np.ndarray] = None

    @classmethod
    def from_corpus(cls, corpus: Corpus, block_docs: int) -> "ShardedCorpusStore":
        return cls(corpus.tokens, corpus.mask, corpus.V, block_docs)

    @property
    def num_tokens(self) -> int:
        # cached: a full mask reduction is a whole-corpus disk scan for
        # memmap-backed stores.
        if self._num_tokens is None:
            self._num_tokens = int(np.asarray(self.mask).sum())
        return self._num_tokens

    def vocab_ids(self) -> np.ndarray:
        """Sorted unique word ids present (masked) anywhere in the corpus.

        Computed blockwise into a (V,) seen-array — one bounded pass, no
        whole-corpus materialization for memmap-backed stores — and
        cached: it feeds the block-sparse table build
        (core/streaming.py), which only constructs alias tables for
        words the sweep can actually touch.
        """
        if self._vocab_ids is None:
            seen = np.zeros((self.V,), bool)
            for b in range(self.num_blocks):
                blk = self.block(b)
                ids = blk.tokens[blk.mask]
                if ids.size:
                    seen[ids] = True
            self._vocab_ids = np.flatnonzero(seen).astype(np.int32)
        return self._vocab_ids

    @property
    def vocab_coverage(self) -> float:
        """Fraction of the vocabulary present in the corpus (<= 1.0)."""
        return len(self.vocab_ids()) / max(self.V, 1)

    def fill(self, b: int, tokens: np.ndarray, mask: np.ndarray) -> None:
        """Write block b into the (DB, L) arrays ``tokens`` and ``mask``:
        its rows copied once from the store, the padded rows zeroed. The
        streaming driver fills its pinned buffers with it."""
        if not 0 <= b < self.num_blocks:
            raise IndexError(f"block {b} out of range [0, {self.num_blocks})")
        lo = b * self.block_docs
        live = min(lo + self.block_docs, self.num_docs) - lo
        tokens[:live] = self.tokens[lo:lo + live]
        mask[:live] = self.mask[lo:lo + live]
        tokens[live:] = 0
        mask[live:] = False

    def block(self, b: int) -> CorpusBlock:
        tokens = np.empty((self.block_docs, self.max_len), np.int32)
        mask = np.empty((self.block_docs, self.max_len), bool)
        self.fill(b, tokens, mask)
        return CorpusBlock(index=b, tokens=tokens, mask=mask,
                           doc_start=b * self.block_docs)

    def blocks(self, start: int = 0) -> Iterator[CorpusBlock]:
        for b in range(start, self.num_blocks):
            yield self.block(b)

    # -- disk spill (corpora larger than host RAM) ------------------------
    def save(self, path: str) -> str:
        """Write the packed corpus as memmap-able .npy files + metadata."""
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "tokens.npy"), np.asarray(self.tokens))
        np.save(os.path.join(path, "mask.npy"), np.asarray(self.mask))
        with open(os.path.join(path, "store.json"), "w") as f:
            json.dump({"V": self.V, "block_docs": self.block_docs}, f)
        return path

    @classmethod
    def open(cls, path: str, block_docs: Optional[int] = None) -> "ShardedCorpusStore":
        """Memory-map a saved store — blocks are read lazily from disk."""
        with open(os.path.join(path, "store.json")) as f:
            meta = json.load(f)
        tokens = np.load(os.path.join(path, "tokens.npy"), mmap_mode="r")
        mask = np.load(os.path.join(path, "mask.npy"), mmap_mode="r")
        return cls(tokens, mask, meta["V"], block_docs or meta["block_docs"])


class AsyncStage:
    """Bounded single-worker pipeline stage: the double-buffering idiom
    of the streaming D2H write-back (``BlockWriteback``).

    ``submit(item)`` enqueues work; a daemon thread runs ``fn(item)`` in
    submission order. The bounded queue (``depth``) backpressures the
    producer so at most ``depth`` items are in flight. ``flush()`` waits
    until everything submitted so far has been processed; ``close()``
    drains and stops the worker (idempotent). Worker errors are captured
    and re-raised on the next flush/close — after an error, queued and
    subsequent items are dropped unprocessed rather than run against
    possibly-corrupt state.
    """

    _DONE = object()

    def __init__(self, fn, *, depth: int = 2, name: str = "AsyncStage"):
        self._fn = fn
        self._name = name
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._worker, daemon=True, name=name
        )
        self._thread.start()

    def _span(self, item):
        """The trace span around one work item (subclasses name it); the
        shared no-op span when tracing is off."""
        return obs.tracer().span(self._name, cat="pipeline")

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is self._DONE:
                    return
                if self._err is None:
                    try:
                        with self._span(item):
                            self._fn(item)
                    except BaseException as e:  # surfaced on flush/close
                        self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, item):
        self._q.put(item)

    def flush(self):
        self._q.join()
        self._raise_pending()

    def close(self):
        """Drain outstanding work and stop the worker (idempotent)."""
        if self._thread.is_alive():
            self._q.put(self._DONE)
            self._thread.join(timeout=600)
            if self._thread.is_alive():
                # never return while the worker may still be mutating the
                # stage's target — silently-torn state is worse than an
                # exception.
                raise RuntimeError(
                    f"{self._name} worker failed to drain within 600s "
                    "(wedged device transfer?)"
                )
        self._raise_pending()


class BlockWriteback(AsyncStage):
    """Bounded asynchronous write-back of swept blocks.

    ``submit(index, payload)`` enqueues a block the driver has just
    queued on the device; the daemon thread turns it into a host array
    with ``fetch(payload)`` (which waits for the sweep, off the driver
    thread) and hands that to ``sink(index, array)``. The bounded queue
    (``depth``) holds the driver back so that at most ``depth`` swept
    blocks wait on the device. ``flush()`` waits until everything
    submitted so far has been written (call it before reading the sink's
    target, e.g. in a checkpoint save); ``close()`` drains and stops the
    worker. Worker errors are re-raised on the next flush/close.
    """

    def __init__(self, sink, fetch, *, depth: int = 2):
        def run(item):
            index, payload = item
            sink(index, fetch(payload))

        super().__init__(run, depth=depth, name="BlockWriteback")

    def _span(self, item):
        # the fetch in this span waits for the sweep on the card, so the
        # span is where device work shows on the write-back's track
        return obs.tracer().span("writeback", cat="pipeline", block=item[0])

    def submit(self, index: int, payload):  # type: ignore[override]
        super().submit((index, payload))


class BlockPrefetcher:
    """Double-buffered host->device block staging, with an optional
    read-ahead pre-stage.

    Wraps an iterator of host items; a daemon thread runs ``stage`` (the
    streaming driver's copy to the card) up to ``depth`` items ahead of
    the consumer, so the host->device copy of block b+1 overlaps the
    Gibbs sweep of block b.

    ``pre`` adds a second pipeline stage on its own daemon thread,
    upstream of ``stage`` — the streaming driver's read of a block and
    its z slab into a host buffer (a disk load for ``DiskZStore``), so
    the read of block b+2 overlaps the H2D staging of block b+1 AND the
    sweep of block b. The two stages share ONE in-flight budget of
    ``depth`` items, enforced by a semaphore held from ``pre`` start
    until the consumer takes the staged item: at most ``depth`` items
    are ever between read-start and consumption, which is what bounds
    the driver's host buffers in use. Items dropped after ``pre`` (an
    early close, a stage error) are discarded: ``pre`` must leave
    nothing to undo.
    """

    _DONE = object()

    def __init__(self, items, stage, *, depth: int = 2, pre=None):
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._sem: Optional[threading.Semaphore] = None
        if pre is None:
            self._init_single(items, stage, depth)
        else:
            self._init_piped(items, stage, depth, pre)

    def _init_single(self, items, stage, depth):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))

        def put(item) -> bool:
            # bounded put that aborts when the consumer closes us, so an
            # early-exiting consumer never leaves the worker blocked on a
            # full queue pinning staged device buffers.
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in items:
                    if self._stop.is_set():
                        break
                    if not put(stage(item)):
                        break
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                put(self._DONE)

        self._threads = [threading.Thread(
            target=worker, daemon=True, name="BlockPrefetcher.stage")]
        self._threads[0].start()

    def _init_piped(self, items, stage, depth, pre):
        # both queues are unbounded: the semaphore is the only in-flight
        # bound, released when the consumer takes a staged item (or the
        # pipeline is closed, which aborts the acquire loop).
        self._q = queue.Queue()
        mid: queue.Queue = queue.Queue()
        self._sem = threading.Semaphore(max(depth, 1))

        def acquire() -> bool:
            while not self._stop.is_set():
                if self._sem.acquire(timeout=0.05):
                    return True
            return False

        def reader():
            try:
                for item in items:
                    if self._stop.is_set() or not acquire():
                        break
                    try:
                        staged = pre(item)
                    except BaseException:
                        # the permit acquired for this item never reaches
                        # the consumer (who would release it) — give it
                        # back so the shared in-flight budget stays exact
                        # across the error. ``pre`` undoes its own partial
                        # side effects (the driver checks a slab back in
                        # however its copy ends).
                        self._sem.release()
                        raise
                    mid.put(staged)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                mid.put(self._DONE)

        def stager():
            while True:
                item = mid.get()
                if item is self._DONE:
                    self._q.put(self._DONE)
                    return
                if self._err is not None or self._stop.is_set():
                    continue  # the consumer is going away: drop the item
                try:
                    self._q.put(stage(item))
                except BaseException as e:
                    self._err = e
                    self._stop.set()  # unblock the reader's acquire loop

        self._threads = [
            threading.Thread(target=reader, daemon=True,
                             name="BlockPrefetcher.pre"),
            threading.Thread(target=stager, daemon=True,
                             name="BlockPrefetcher.stage"),
        ]
        for t in self._threads:
            t.start()

    def close(self):
        """Stop the workers and release staged items (idempotent)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5)

    def __iter__(self):
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    if self._err is not None:
                        raise self._err
                    return
                if self._sem is not None:
                    self._sem.release()
                yield item
        finally:
            self.close()
