"""Chunk plans, the worker pool, score stores and selection sinks.

The streaming plane the selection engine walks, copied from the JAX
package (it is numpy and threads, and imports nothing of JAX):

  * every chunked walk — sketch construction, selection emission, the PT
    stage-2 region draw — iterates one shared `ChunkPlan` (shard → chunk
    spans), driven through a persistent `WorkerPool`; results land in
    preassigned slots, so the worker count never changes an output bit;
  * record stores are memory-mapped score arrays (`ScoreStore`), so a
    corpus larger than memory never materializes;
  * selection *output* is streamed into a `SelectionSink` (in-memory
    `IndexSink`, memmap-packed `BitmaskStore`, or `CallbackSink`) as
    shard-local int64 host indices, so a query never allocates a
    full-corpus boolean mask. Sinks carry an explicit thread-safety
    contract (see `SelectionSink`); `SelectionStream` turns a
    `CallbackSink` into an iterator;
  * `parallel_map`, `DeterministicSource` and `Prefetcher` are the batch
    plumbing of the host side.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import queue
import threading
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, TypeVar)

import numpy as np

# Leaf module: the two-phase commit primitives ScoreStore.append and
# BitmaskStore growth publish through.
from repro_torch.durable import atomic as _atomic

# Default streaming granularity: 4M records (16 MB of float32 scores per
# chunk) — big enough to amortize per-chunk overheads, small enough that
# per-query peak host memory stays O(chunk), not O(corpus).
CHUNK_RECORDS = 1 << 22

_T = TypeVar("_T")
_R = TypeVar("_R")


# ---------------------------------------------------------------------------
# ChunkPlan — the shared shard → chunk iteration contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkSpan:
    """One unit of streaming work: a half-open [start, stop) record range
    inside one shard. `chunk_id` is the span's dense index within its shard,
    so per-chunk state (sampling masses, region counts) lines up with the
    span order without any extra bookkeeping."""
    shard_id: int
    chunk_id: int
    start: int
    stop: int

    @property
    def size(self) -> int:
        """Records in the span."""
        return self.stop - self.start


class ChunkPlan:
    """Shard → chunk decomposition shared by every streaming pass.

    One plan instance replaces the hand-rolled ``range(0, n, chunk)`` loops
    that used to live in sketch construction, selection emission, and the
    PT stage-2 region walk: all of them iterate the same spans, so per-chunk
    state computed by one pass (e.g. the sampling chunk masses accumulated
    during the sketch pass) is addressable by any other via
    ``(shard_id, chunk_id)``. Empty shards contribute no spans.

    >>> plan = ChunkPlan([5, 3], chunk_records=2)
    >>> [(s.shard_id, s.chunk_id, s.start, s.stop) for s in plan]
    [(0, 0, 0, 2), (0, 1, 2, 4), (0, 2, 4, 5), (1, 0, 0, 2), (1, 1, 2, 3)]
    >>> plan.total_chunks
    5

    A plan may be restricted to a subset of its shards (`shard_ids`) while
    keeping the full corpus addressing — the live plane's standing-query
    re-emissions walk only newly appended shards this way, and plans with
    equal restriction still fuse:

    >>> [(s.shard_id, s.start, s.stop)
    ...  for s in ChunkPlan([5, 3], 2, shard_ids=[1])]
    [(1, 0, 2), (1, 2, 3)]
    """

    def __init__(self, shard_sizes: Sequence[int], chunk_records: int,
                 shard_ids: Optional[Sequence[int]] = None):
        if chunk_records <= 0:
            raise ValueError("chunk_records must be positive")
        self.shard_sizes = [int(n) for n in shard_sizes]
        self.chunk_records = int(chunk_records)
        if shard_ids is None:
            self.shard_ids = tuple(range(len(self.shard_sizes)))
        else:
            ids = sorted({int(i) for i in shard_ids})
            if ids and (ids[0] < 0 or ids[-1] >= len(self.shard_sizes)):
                raise ValueError(
                    f"shard_ids {ids} out of range for "
                    f"{len(self.shard_sizes)} shards")
            self.shard_ids = tuple(ids)

    def num_chunks(self, shard_id: int) -> int:
        """Number of chunks (spans) in one shard."""
        n = self.shard_sizes[shard_id]
        return -(-n // self.chunk_records)

    @property
    def total_chunks(self) -> int:
        """Number of spans the plan walks."""
        return sum(self.num_chunks(sh) for sh in self.shard_ids)

    def shard_spans(self, shard_id: int) -> List[ChunkSpan]:
        """The spans of one shard, in order."""
        n = self.shard_sizes[shard_id]
        c = self.chunk_records
        return [ChunkSpan(shard_id, ci, o, min(o + c, n))
                for ci, o in enumerate(range(0, n, c))]

    def __iter__(self) -> Iterator[ChunkSpan]:
        for shard_id in self.shard_ids:
            yield from self.shard_spans(shard_id)

    @property
    def geometry(self) -> Tuple[Tuple[int, ...], int, Tuple[int, ...]]:
        """Hashable span-structure identity: two plans with equal geometry
        produce identical span lists and can therefore fuse. Shard
        restriction is part of the identity — a restricted walk must not
        share spans with a full-corpus one."""
        return (tuple(self.shard_sizes), self.chunk_records, self.shard_ids)

    @staticmethod
    def fuse(plans: Sequence["ChunkPlan"]) \
            -> List[Tuple[ChunkSpan, List[int]]]:
        """Compose several plans' walks into one span list.

        Plans sharing geometry contribute their spans *once*, tagged with
        every plan index that covers them; distinct geometries keep their
        own spans. A scheduler walking the fused list runs k same-geometry
        passes while touching each data chunk once instead of k times —
        the per-round fusion a multi-query session relies on. Span order:
        geometry groups in first-appearance order, spans in plan order
        within a group, so a single-plan fuse degenerates to `list(plan)`.
        """
        groups: Dict[Tuple, List[int]] = {}
        first: List[Tuple[Tuple, "ChunkPlan"]] = []
        for i, plan in enumerate(plans):
            g = plan.geometry
            if g not in groups:
                groups[g] = []
                first.append((g, plan))
            groups[g].append(i)
        fused: List[Tuple[ChunkSpan, List[int]]] = []
        for g, plan in first:
            owners = groups[g]
            for span in plan:
                fused.append((span, owners))
        return fused


@dataclasses.dataclass
class ChunkWalk:
    """One chunk-streamed pass: run `fn` on every span of `plan`.

    The unit a query plan *yields* when it needs a full chunked walk
    (selection emission): the scheduler fuses all walks yielded in one
    round via `ChunkPlan.fuse` and drives the fused span list through the
    worker pool once (`run_fused`), then resumes each plan."""
    plan: ChunkPlan
    fn: Callable[[ChunkSpan], None]


class WorkerPool:
    """Persistent, lazily-built thread pool for the streaming plane.

    An engine owns one pool for its whole lifetime, so thread creation is
    paid once, not per chunk walk. Semantics:

      * `map` preserves item order, and work items carry their output
        slots, so thread count never changes any output bit;
      * inline fast path: with `workers <= 1`, a single-item work list, or
        a call *from one of the pool's own worker threads* (a plan step
        running on the pool may itself call `map` for its internal walks),
        the map runs as a plain in-order loop on the calling thread — the
        nested case would otherwise deadlock a fixed-size pool waiting on
        its own slots;
      * a task exception propagates to the caller and the pool stays
        usable (the executor survives poisoned tasks);
      * `close()` is idempotent and exception-safe; a closed pool still
        serves the inline fast paths (they own no threads) but refuses
        threaded work. Use as a context manager for scoped lifetimes.

    >>> with WorkerPool(4) as pool:
    ...     pool.map(lambda x: x * x, range(5))   # order preserved
    [0, 1, 4, 9, 16]
    """

    def __init__(self, workers: int = 1):
        self.workers = max(1, int(workers))
        self._ex: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._tl = threading.local()
        self._closed = False

    @property
    def closed(self) -> bool:
        """Whether `close` has run."""
        return self._closed

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._lock:
            if self._closed:
                raise RuntimeError("WorkerPool is closed")
            if self._ex is None:
                tl = self._tl

                def _mark_worker():
                    tl.inside_pool = True

                self._ex = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self.workers,
                    thread_name_prefix="repro-torch-pool",
                    initializer=_mark_worker)
            return self._ex

    def map(self, fn: Callable[[_T], _R], items: Iterable[_T]) -> List[_R]:
        """Map `fn` over `items` preserving order; threaded when the pool
        is sized > 1 and the call comes from outside the pool itself."""
        items = list(items)
        if (self.workers <= 1 or len(items) <= 1
                or getattr(self._tl, "inside_pool", False)):
            return [fn(it) for it in items]
        return list(self._executor().map(fn, items))

    def close(self) -> None:
        """Shut the executor down (joining its threads). Idempotent."""
        with self._lock:
            self._closed = True
            ex, self._ex = self._ex, None
        if ex is not None:
            ex.shutdown(wait=True)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def run_fused(walks: Sequence[ChunkWalk],
              pool: Optional[WorkerPool] = None) \
        -> List[Optional[BaseException]]:
    """Run several chunk walks as one fused span pass over the pool.

    Same-geometry walks share spans (`ChunkPlan.fuse`), so k emission
    passes touch each data chunk once. Errors are isolated per walk: the
    first exception a walk's `fn` raises is captured, that walk skips its
    remaining spans (best effort — spans already in flight on other
    threads still run), and the other walks keep streaming. Returns one
    entry per walk: None on success, the captured exception otherwise —
    the caller throws it into the owning plan.
    """
    walks = list(walks)
    errors: List[Optional[BaseException]] = [None] * len(walks)
    fused = ChunkPlan.fuse([w.plan for w in walks])

    def run_item(item):
        span, owners = item
        for i in owners:
            if errors[i] is not None:
                continue
            try:
                walks[i].fn(span)
            except BaseException as err:  # noqa: BLE001 — isolated per walk
                errors[i] = err

    if pool is not None:
        pool.map(run_item, fused)
    else:
        for it in fused:
            run_item(it)
    return errors


def parallel_map(fn: Callable[[_T], _R], items: Iterable[_T],
                 workers: int = 1,
                 pool: Optional[WorkerPool] = None) -> List[_R]:
    """Map `fn` over `items`, preserving order; threaded when workers > 1.

    With `pool` given, the work rides that persistent pool; otherwise a
    scoped pool lives for this one call. With workers <= 1 this is a plain
    in-order loop — identical results, no thread overhead: work items
    carry their output slot and never depend on completion order.

    >>> parallel_map(lambda x: x * x, range(5), workers=3)
    [0, 1, 4, 9, 16]
    """
    if pool is not None:
        return pool.map(fn, items)
    items = list(items)
    if workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    with WorkerPool(workers) as scoped:
        return scoped.map(fn, items)


class DeterministicSource:
    """Batch source: batch = f(seed, step), sharded across hosts (host
    `shard_index` of `num_shards` takes every num_shards-th row)."""

    def __init__(self, make_batch: Callable[[np.random.Generator, int], dict],
                 seed: int, shard_index: int = 0, num_shards: int = 1):
        self._make = make_batch
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards

    def batch_at(self, step: int) -> dict:
        """The batch of `step`, this host's rows."""
        rng = np.random.default_rng((self.seed, step))
        full = self._make(rng, step)
        return {k: v[self.shard_index::self.num_shards]
                for k, v in full.items()}

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Batches from `start_step` on, without end."""
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of a batch iterator (depth-bounded); an
    error in the iterator is raised at the consumer's next `next`."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 — surfaced on get
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class ScoreStore:
    """Memory-mapped proxy-score shard store for the selection plane.

    Layout: one float32 array per shard on disk. Writers are the serve
    plane's scoring jobs; readers are SUPG queries and the sketch kernel.
    """

    _ITEM = np.dtype(np.float32).itemsize

    def __init__(self, path, num_records: int, mode="r+", create=False):
        self.path = str(path)
        if create:
            self._arr = np.memmap(self.path, np.float32, "w+",
                                  shape=(num_records,))
            self._arr[:] = -1.0   # unscored marker
            self._arr.flush()
            _atomic.commit_length(self.path, num_records * self._ITEM)
        else:
            # Crash recovery for the two-phase append: bytes past the
            # committed length are an un-acknowledged grow — truncate
            # them away and clamp the view, so a reopened store is
            # exactly its last committed state. Stores without a length
            # sidecar (pre-durability files, ad-hoc arrays) open as-is.
            committed = _atomic.committed_length(self.path)
            if committed is not None:
                _atomic.discard_uncommitted_tail(self.path)
                num_records = min(int(num_records),
                                  committed // self._ITEM)
            self._arr = np.memmap(self.path, np.float32, mode,
                                  shape=(num_records,))
        self._num_scored: Optional[int] = None
        # write()/append() bump _version under _lock; num_scored's chunked
        # scan runs lock-free and commits only if the version it started
        # from is still current — see num_scored for the race contract.
        self._lock = threading.Lock()
        self._version = 0

    def write(self, start: int, scores: np.ndarray):
        """Overwrite `scores.size` records at `start` (atomic w.r.t. the
        `num_scored` cache: a racing count can never commit a stale scan
        over this write)."""
        scores = np.asarray(scores)
        with self._lock:
            n = int(self._arr.shape[0])
            # Reject out-of-range writes outright — memmap slicing would
            # silently truncate them and scoring jobs would lose records.
            if start < 0 or start + scores.shape[0] > n:
                raise ValueError(
                    f"write [{start}, {start + scores.shape[0]}) out of "
                    f"range for store of {n} records")
            self._arr[start:start + scores.shape[0]] = scores
            self._arr.flush()
            self._version += 1
            self._num_scored = None   # invalidate the cached scan

    def append(self, scores: np.ndarray) -> int:
        """Grow the store by `scores.size` records at the tail; returns the
        new record count.

        The backing file is extended and remapped; existing `.scores`
        views (e.g. shards pinned by an in-flight engine snapshot) keep
        their old length and stay valid — the file only ever grows, and
        records below the old tail are untouched. The `num_scored` cache
        is delta-updated in place (appends know exactly how many scored
        records they add), so a warm cache never pays a rescan — the
        only cache an append invalidates is none at all.

        The grow is a two-phase commit: the tail bytes are written and
        fsync'd first, then the new length is published through the
        atomic sidecar (`repro_torch.durable.atomic.commit_length`). A crash
        between the phases (`pre_length_commit`) leaves a file whose
        extra bytes are truncated away on the next open — the append was
        never acknowledged, so re-issuing it is exactly-once.
        """
        scores = np.asarray(scores, np.float32)
        k = int(scores.shape[0])
        with self._lock:
            old = self._arr
            n = int(old.shape[0])
            if k:
                old.flush()
                # Seed the sidecar for pre-durability files so recovery
                # has a committed length to truncate back to.
                if _atomic.committed_length(self.path) is None:
                    _atomic.commit_length(self.path, n * self._ITEM)
                with open(self.path, "r+b") as f:
                    f.truncate((n + k) * self._ITEM)
                grown = np.memmap(self.path, np.float32, "r+",
                                  shape=(n + k,))
                grown[n:] = scores
                grown.flush()
                _atomic.fsync_path(self.path)
                _atomic.crashpoint("pre_length_commit")
                _atomic.commit_length(self.path, (n + k) * self._ITEM)
                self._arr = grown
            self._version += 1
            if self._num_scored is not None:
                self._num_scored += int((scores >= 0).sum())
            return n + k

    def read(self, start: int = 0, count: Optional[int] = None) -> np.ndarray:
        """Copy of `count` records from `start` (to the end by default)."""
        end = None if count is None else start + count
        return np.asarray(self._arr[start:end])

    @property
    def scores(self) -> np.ndarray:
        """Zero-copy memmap view — SelectionEngine consumes stores directly
        through this so out-of-core shards never materialize in RAM."""
        return self._arr

    def __len__(self) -> int:
        return self._arr.shape[0]

    def _count_span(self, arr: np.ndarray, start: int, stop: int) -> int:
        """Scored-record count over one span of `arr` (a seam a test
        can override to land a write mid-scan)."""
        return int((arr[start:stop] >= 0).sum())

    @property
    def num_scored(self) -> int:
        """Count of scored (non-sentinel) records, cached between writes.

        The scan itself is chunked so even a 1e9-record store is counted
        with O(chunk) peak memory; repeat reads are O(1) until the next
        `write` invalidates the cache (appends delta-update it instead).

        Concurrency contract: the chunked scan runs *outside* the store
        lock (it may touch gigabytes), but it only commits to the cache —
        and only returns — if the store's version is unchanged from when
        the scan started. A `write()` or `append()` landing mid-scan bumps
        the version, so the stale count is discarded and the scan retries;
        the epoch-pinning logic layered on top (a live-ingest plane) can therefore
        never observe a count that mixes pre- and post-write state.
        """
        while True:
            with self._lock:
                if self._num_scored is not None:
                    return self._num_scored
                v0 = self._version
                arr = self._arr
            plan = ChunkPlan([int(arr.shape[0])], CHUNK_RECORDS)
            total = sum(self._count_span(arr, sp.start, sp.stop)
                        for sp in plan)
            with self._lock:
                if self._num_scored is not None:
                    return self._num_scored
                if self._version == v0:
                    self._num_scored = total
                    return total
                # a write/append landed mid-scan: the count may be stale
                # in either direction — rescan against the new version.


# ---------------------------------------------------------------------------
# Selection sinks — the streaming output plane
# ---------------------------------------------------------------------------

class SelectionSink:
    """Chunked consumer protocol for streamed selection emission.

    The engine calls, in order:

        open(shard_sizes)              once, before any emission
        fold(shard_id, local_idx)      labeled positives *below* tau
                                       (Algorithm 1's R1, sink-level merge)
        emit(shard_id, local_idx)      ascending in-chunk; disjoint from
                                       fold()
        close() -> per-shard counts    once, after the last chunk

    emit/fold receive *shard-local* indices; `offsets` maps them to global
    ids. Because the engine guarantees fold/emit disjointness, the base
    class's per-shard counts are exact without any dedup state.

    Thread-safety contract: with an engine worker pool (workers > 1) `emit`
    may be called concurrently from multiple threads, including for chunks
    of the *same* shard, and chunk arrival order is unspecified. The base
    class serializes each call (count update + `_consume`) under one lock,
    so subclasses only need per-shard buffers that tolerate interleaved
    appends and are merged into canonical order at `close()` — exactly what
    `IndexSink` does with its per-shard chunk lists. With workers == 1 the
    legacy ordering (chunks ascending per shard, shards in order) still
    holds. `open`, `fold` and `close` are always driver-thread only.

    One sink serves one query at a time: under a `QuerySession` (or any
    concurrent `run_many` batch) each query opens and closes its own sink,
    and `open` refuses a sink that is already open — two queries sharing a
    sink object would silently interleave their emissions. A sink may be
    *reused* sequentially (open after close), which resets its state.

    The `IndexSink` flow, driven by hand:

    >>> import numpy as np
    >>> sink = IndexSink()
    >>> sink.open([4, 4])                    # two shards of 4 records
    >>> sink.fold(1, np.asarray([0]))        # labeled positive below tau
    >>> sink.emit(0, np.asarray([1, 3]))     # a {A >= tau} chunk
    >>> sink.close().tolist()                # per-shard counts
    [2, 1]
    >>> sink.indices(0).tolist(), sink.mask(1).tolist()
    ([1, 3], [True, False, False, False])
    """

    def open(self, shard_sizes: Sequence[int]) -> None:
        """Start a query's emission over shards of these sizes."""
        if getattr(self, "_is_open", False):
            raise RuntimeError(
                f"{type(self).__name__} is already open: one sink object "
                "cannot serve two queries at once (their emissions would "
                "interleave) — give each query its own sink")
        self._is_open = True
        self.shard_sizes = [int(n) for n in shard_sizes]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.shard_sizes)]).astype(np.int64)
        self.counts = np.zeros(len(self.shard_sizes), np.int64)
        self._lock = threading.Lock()

    def emit(self, shard_id: int, local_idx: np.ndarray) -> None:
        """Take one chunk's ascending selected shard-local indices."""
        local_idx = np.asarray(local_idx, np.int64)
        if local_idx.size == 0:
            return
        with self._lock:
            self.counts[shard_id] += local_idx.size
            self._consume(shard_id, local_idx, folded=False)

    def fold(self, shard_id: int, local_idx: np.ndarray) -> None:
        """Take labeled positives below tau (disjoint from `emit`)."""
        local_idx = np.asarray(local_idx, np.int64)
        if local_idx.size == 0:
            return
        with self._lock:
            self.counts[shard_id] += local_idx.size
            self._consume(shard_id, local_idx, folded=True)

    def close(self) -> np.ndarray:
        """Finish the query; returns the per-shard selected counts."""
        self._finalize()
        self._is_open = False
        return self.counts.copy()

    @property
    def total_selected(self) -> int:
        """Records selected so far, over all shards."""
        return int(self.counts.sum())

    # -- subclass hooks -------------------------------------------------

    def _consume(self, shard_id: int, local_idx: np.ndarray,
                 folded: bool) -> None:
        raise NotImplementedError

    def _finalize(self) -> None:
        pass

    # -- optional views (materializing sinks only) ----------------------

    def indices(self, shard_id: int) -> np.ndarray:
        """Sorted shard-local selected indices."""
        raise NotImplementedError(f"{type(self).__name__} holds no state")

    def mask(self, shard_id: int) -> np.ndarray:
        """Boolean selection mask for one shard (materializes that shard)."""
        m = np.zeros(self.shard_sizes[shard_id], bool)
        m[self.indices(shard_id)] = True
        return m


class IndexSink(SelectionSink):
    """In-memory per-shard index sink — the default materializer.

    Holds O(selected) int64 indices instead of O(corpus) booleans; `mask`
    rematerializes a single shard's boolean view on demand.
    """

    def open(self, shard_sizes):
        """Start a query: empty per-shard index lists."""
        super().open(shard_sizes)
        self._chunks: List[List[np.ndarray]] = [[] for _ in self.shard_sizes]
        self._idx: Optional[List[np.ndarray]] = None

    def _consume(self, shard_id, local_idx, folded):
        self._chunks[shard_id].append(local_idx)

    def _finalize(self):
        # Emission is ascending per shard but fold() chunks interleave
        # arbitrarily; one sort per shard restores canonical order.
        self._idx = [
            np.sort(np.concatenate(c)) if c else np.empty(0, np.int64)
            for c in self._chunks]
        self._chunks = [[] for _ in self.shard_sizes]

    def indices(self, shard_id):
        """Sorted shard-local selected indices (after `close`)."""
        if self._idx is None:
            raise RuntimeError("sink not closed yet")
        return self._idx[shard_id]


class BitmaskStore(SelectionSink):
    """Memmap-backed packed selection bitmask: 1 bit per record on disk.

    The out-of-core materializer — a 1e9-record selection costs 125 MB of
    disk and O(chunk) host memory while being written. Bits are byte-aligned
    per shard so shards stay independently addressable.

    Epoch-aware growth: a sidecar meta file (``<path>.meta.json``) records
    the shard layout the stored bits were written under. Reopening with a
    layout that *extends* the recorded one (same shard sizes, plus new
    shards at the tail — exactly what a live-corpus append produces) grows
    the backing file through the two-phase atomic-commit path and keeps
    every committed bit, so a store sized at certify time covers appended
    shards as standing-query catch-ups re-emit over them. Reopening with
    an incompatible layout starts fresh (wipe), the pre-durability
    behavior.
    """

    def __init__(self, path):
        self.path = str(path)
        self.meta_path = self.path + ".meta.json"
        self._arr: Optional[np.memmap] = None

    def open(self, shard_sizes):
        """Start a query: map (or grow) the bitmask file for the layout."""
        super().open(shard_sizes)
        self._byte_offsets = np.concatenate(
            [[0], np.cumsum([(n + 7) // 8 for n in self.shard_sizes])]
        ).astype(np.int64)
        total = max(int(self._byte_offsets[-1]), 1)
        meta = _atomic.read_json(self.meta_path)
        old_sizes = (None if meta is None
                     else [int(n) for n in meta.get("shard_sizes", [])])
        if (old_sizes is not None and os.path.exists(self.path)
                and len(self.shard_sizes) >= len(old_sizes)
                and self.shard_sizes[:len(old_sizes)] == old_sizes):
            # Extend-or-equal: grow in place, preserving committed bits.
            # Two phases — zero + fsync the grown tail, then commit the
            # new layout through the atomic meta replace. A crash between
            # them (`mid_bitmask_commit`) leaves the old layout
            # committed; the next open simply re-grows, and re-emission
            # over the new shards is an idempotent OR.
            old_total = max(int(sum((n + 7) // 8 for n in old_sizes)), 1)
            with open(self.path, "r+b") as f:
                f.truncate(total)
            self._arr = np.memmap(self.path, np.uint8, "r+", shape=(total,))
            if total > old_total:
                self._arr[old_total:] = 0
                self._arr.flush()
                _atomic.fsync_path(self.path)
                _atomic.crashpoint("mid_bitmask_commit")
        else:
            self._arr = np.memmap(self.path, np.uint8, "w+", shape=(total,))
        _atomic.atomic_write_json(self.meta_path,
                                  {"shard_sizes": self.shard_sizes})

    def _consume(self, shard_id, local_idx, folded):
        base = int(self._byte_offsets[shard_id])
        np.bitwise_or.at(self._arr, base + (local_idx >> 3),
                         (1 << (local_idx & 7)).astype(np.uint8))

    def _finalize(self):
        self._arr.flush()
        _atomic.fsync_path(self.path)

    def mask(self, shard_id):
        """Boolean selection mask of one shard, from the stored bits."""
        base = int(self._byte_offsets[shard_id])
        nbytes = int(self._byte_offsets[shard_id + 1]) - base
        bits = np.unpackbits(np.asarray(self._arr[base:base + nbytes]),
                             bitorder="little")
        return bits[:self.shard_sizes[shard_id]].astype(bool)

    def indices(self, shard_id, chunk_bytes: int = 1 << 20):
        """Sorted shard-local indices, decoded in bounded byte chunks."""
        base = int(self._byte_offsets[shard_id])
        nbytes = int(self._byte_offsets[shard_id + 1]) - base
        out = []
        for off in range(0, nbytes, chunk_bytes):
            span = np.asarray(self._arr[base + off:
                                        base + min(off + chunk_bytes,
                                                   nbytes)])
            bits = np.unpackbits(span, bitorder="little")
            hit = np.nonzero(bits)[0].astype(np.int64) + off * 8
            if hit.size:
                out.append(hit)
        if not out:
            return np.empty(0, np.int64)
        idx = np.concatenate(out)
        return idx[idx < self.shard_sizes[shard_id]]


class CallbackSink(SelectionSink):
    """Streams (shard_id, global_ids, folded) chunks to a callback as the
    engine emits them — the service-streaming sink. Holds no index state;
    only the per-shard counts survive close()."""

    def __init__(self, fn: Callable[[int, np.ndarray, bool], None]):
        self._fn = fn

    def _consume(self, shard_id, local_idx, folded):
        self._fn(shard_id, self.offsets[shard_id] + local_idx, folded)


class _StreamCancelled(Exception):
    """Raised inside the producer when the consumer closed the stream."""


class SelectionStream:
    """Iterator inversion of `CallbackSink`: consume a streamed selection
    as `(shard_id, global_ids, folded)` chunks while the engine produces
    them from a background thread.

        with SelectionStream(
                lambda sink: engine.run(key, oracle, q, sink=sink)) as st:
            for shard_id, gids, folded in st:
                ...                    # incremental consumption
        result = st.result             # ShardedSelection after exhaustion

    The queue is depth-bounded, so a slow consumer backpressures the
    emission loop instead of buffering the whole selection. A consumer
    that stops early must call `close()` (the context manager does) —
    it cancels the producer at its next chunk and reaps the thread;
    `result` stays None for a cancelled stream.
    """

    _SENTINEL = object()

    def __init__(self, run_fn: Callable[[SelectionSink], object],
                 depth: int = 8):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._closed = False
        self._done = False
        self.result = None

        def on_chunk(sh, gids, folded):
            if self._closed:
                raise _StreamCancelled
            self._q.put((sh, gids, folded))

        def produce():
            try:
                self.result = run_fn(CallbackSink(on_chunk))
            except _StreamCancelled:
                pass
            except BaseException as e:  # noqa: BLE001 — surfaced on get
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Abandon the stream: cancel the producer at its next chunk and
        drain the queue so a blocked put() can finish. Safe to call at any
        point, including after exhaustion."""
        if self._done:
            return
        self._closed = True
        while True:
            if self._q.get() is self._SENTINEL:
                break
        self._thread.join()
        self._done = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
