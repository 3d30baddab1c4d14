"""SUPG selection engine — RT / PT / JT queries over a sharded corpus of
proxy scores, with the corpus on the card.

All O(n) work is paid once, at construction, and queries then run off
cached state:

  1. **Build.** One chunked pass over the shards (`data.pipeline.ChunkPlan`,
     driven by the engine's `WorkerPool`) sketches each chunk with the
     `score_hist` kernel and sums its float64 raw sampling masses. The
     per-chunk sketches fold left into per-shard and global sketches; the
     global normalizers (Σ sqrt(A), Σ A) come from the merged sketch.
  2. **Sample.** `draw_sample` draws shard → chunk → record: a categorical
     over cached shard masses, an inverse-CDF draw over each shard's cached
     chunk-mass CDF (host numpy, O(n_chunks)), then an exact within-chunk
     inverse-CDF draw over p(x) computed on the card for the allocated
     chunks only.
  3. **Label.** Oracle labels come through a `BatchingOracle` channel under
     a per-query `BudgetLedger`.
  4. **Threshold.** The §5 estimators (`core.thresholds`) turn the labeled
     sample (a few thousand records, on the host) into tau.
  5. **Emit.** A streamed walk runs the `threshold_select` kernel on every
     chunk and emits {A >= tau} (plus the labeled positives below tau)
     into a `SelectionSink` as host int64 indices. PT stage 2
     (`_uniform_in_region`) counts its region with the kernel's counting
     mode (`threshold_count`) and resolves its draws with the kernel.

**Residency.** In-RAM shards (numpy arrays or tensors) are copied once, at
construction, into one flat float32 tensor on the engine's device; the
shards are views into it, and it is also `score_at`'s gather cache, so
nothing is held twice. Memory-mapped shards (`ScoreStore`) stay on the
host and each span is copied to the device when a walk reaches it.

**Epochs.** A `CorpusState` is one epoch of the corpus. An append
(`_append_shards`, public face `repro_torch.live.IngestPlane`) sketches
only the appended chunks (one `score_hist` launch each), folds their
sketches onto the old global sketch (the same left fold from zero as a
cold build, so sketch, z, chunk masses and CDFs are bit for bit a cold
build's), and installs a new state. The old state is never mutated, so
a plan that pinned it goes on computing against it. On a device-resident
corpus an append allocates a new flat tensor of the whole new corpus
(4 bytes a record), copies the old flat into it on the device and each
appended shard into it once (a tensor already on the device without a
host round trip); every shard of the new epoch is a view into the new
flat. So while an append runs, and while a superseded epoch is pinned,
the device holds that epoch's own flat (4 bytes a record of it) and its
global sketch (3 x 4 bytes a bin) beside the current epoch's; per-shard
sketches are shared between epochs. `gc_epochs` drops every reference a
dead (superseded, unpinned) epoch holds, and its flat goes back to the
allocator. A memory-mapped corpus keeps `flat` None across appends.

**Sessions.** `session()` returns a `QuerySession`, the multi-query
scheduler: in-flight plans (`_run_plan`, `_run_joint_plan`, or any plan
that speaks their yield protocol through `submit_plan`) are split into
two cohorts that take turns. While one cohort's coalesced oracle drain
runs on the channel's drain thread (`BatchingOracle.drain_async`, which
labels on the host and launches no kernel), the other cohort's plan
steps run on the engine's `WorkerPool`, and all emission walks a cohort
yields in one turn run as one fused span pass (`pipeline.run_fused`:
each owner's `emit_span` still launches `threshold_select` on the span,
so k fused walks make k launches a chunk). `run_many` serves a batch of
RT/PT/JT queries through one session. Results (tau, counts, sink
contents) are bit for bit the sequential `run`/`run_joint` results at
any worker count and concurrency.

**Device.** ``device=None`` means ``cuda``, and the engine raises if there
is no CUDA device; ``device="cpu"`` runs every kernel's plain version. The
tensor's device picks the path: there is no switch that runs the plain
versions on the card.

**Randomness.** Keys are jax-format ``uint32[2]`` threefry keys
(`repro_torch.random`), so one key drives this engine and the JAX
package's alike. Results are identical at any worker count: work items
carry their output slots, and the sketch's sums are integer sums on the
card.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import (Dict, Generator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import binned, sampling, thresholds
from repro_torch.core.oracle import (BudgetLedger, DrainHandle, OracleClient,
                                     OracleRequest, as_oracle_client)
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.kernels.threshold_select import ops as select_ops

logger = logging.getLogger(__name__)

_clamp_logged = False


def _effective_workers(requested: Optional[int], clamp: bool) -> int:
    """Resolve the engine's pool width: at most `os.cpu_count()` unless
    `clamp` is False (oversubscribing the chunk walks is a slowdown)."""
    global _clamp_logged
    workers = max(1, int(requested)) if requested else 1
    if not clamp:
        return workers
    cpus = os.cpu_count() or 1
    if workers > cpus:
        if not _clamp_logged:
            logger.info("clamping engine workers=%d to cpu_count=%d "
                        "(pass clamp_workers=False to override)",
                        workers, cpus)
            _clamp_logged = True
        return cpus
    return workers


def _close_quietly(sink: "pipeline.SelectionSink") -> None:
    """Best-effort close on an error path: the sink must come back
    reusable, but the original exception owns the outcome."""
    try:
        sink.close()
    except Exception:  # noqa: BLE001 — error path; original exc wins
        pass


class ShardedSelection:
    """Lazy view over one query's selection.

    Sink-backed (the engine's streaming output) or mask-backed (direct
    construction). Nothing O(corpus) lives here: `total_selected` and
    `shard_counts` come from the per-shard counts the sink accumulated,
    `indices(shard)` reads the sink, and `masks` materializes per-shard
    boolean views only when asked for.
    """

    def __init__(self, masks: Optional[List[np.ndarray]] = None,
                 tau: float = 0.0, oracle_calls: int = 0,
                 sampled_positive_global: Optional[np.ndarray] = None,
                 sink: Optional[pipeline.SelectionSink] = None,
                 shard_sizes: Optional[Sequence[int]] = None,
                 counts: Optional[np.ndarray] = None):
        if masks is None and sink is None:
            raise ValueError("need per-shard masks or a SelectionSink")
        self.tau = float(tau)
        self.oracle_calls = int(oracle_calls)
        self.sampled_positive_global = (
            np.empty(0, np.int64) if sampled_positive_global is None
            else np.asarray(sampled_positive_global, np.int64))
        self.sink = sink
        self._masks = list(masks) if masks is not None else None
        if shard_sizes is None:
            if self._masks is not None:
                shard_sizes = [int(m.shape[0]) for m in self._masks]
            elif getattr(sink, "shard_sizes", None) is not None:
                shard_sizes = sink.shard_sizes
            else:
                raise ValueError(
                    "shard_sizes required when the sink has not been opened")
        self.shard_sizes = [int(n) for n in shard_sizes]
        self._counts = (None if counts is None
                        else np.asarray(counts, np.int64))

    @property
    def num_shards(self) -> int:
        """Number of score shards this selection spans."""
        return len(self.shard_sizes)

    @property
    def shard_counts(self) -> np.ndarray:
        """Per-shard selected counts (no mask materialization needed)."""
        if self._counts is not None:
            return self._counts.copy()
        return np.asarray([int(m.sum()) for m in self.masks], np.int64)

    @property
    def total_selected(self) -> int:
        """Total selected records (from counts)."""
        if self._counts is not None:
            return int(self._counts.sum())
        return int(sum(int(m.sum()) for m in self.masks))

    def indices(self, shard_id: int) -> np.ndarray:
        """Sorted shard-local selected indices for one shard."""
        if self._masks is not None:
            return np.nonzero(self._masks[shard_id])[0].astype(np.int64)
        return np.asarray(self.sink.indices(shard_id), np.int64)

    @property
    def masks(self) -> List[np.ndarray]:
        """Per-shard boolean masks, materialized lazily from the sink."""
        if self._masks is None:
            self._masks = [self.sink.mask(i)
                           for i in range(self.num_shards)]
        return self._masks


@dataclasses.dataclass
class _ShardChunkState:
    """One shard's hierarchical draw state for one (scheme, kappa)."""
    mass: float            # shard total defensive mass (unnormalized)
    cdf: np.ndarray        # (n_chunks,) float64 normalized chunk-mass CDF


@dataclasses.dataclass
class CorpusState:
    """One epoch of the corpus: every piece of engine state a query reads,
    replaced as a unit by an append and never mutated after install.

    `shards` are float32 tensor views into `flat` (device-resident corpus)
    or host arrays and memmaps (`flat` is None). Sketches are float32
    tensors on the engine's device; chunk masses and chunk CDFs are host
    numpy.
    """

    epoch: int                          # 0 at construction, +1 per append
    shards: List                        # per-shard tensor views or memmaps
    offsets: np.ndarray                 # (n_shards+1,) int64 global offsets
    n_total: int                        # total records
    plan: pipeline.ChunkPlan            # the canonical chunk plan
    shard_sketches: List                # per-shard binned.ScoreSketch
    sketch: binned.ScoreSketch          # global merged sketch
    chunk_masses: List[sampling.ChunkMasses]   # per-shard raw chunk masses
    z: Dict[str, float]                 # global weight normalizers
    flat: Optional[torch.Tensor]        # the device corpus (or None)
    sampling_cache: Dict[Tuple[str, float], List[_ShardChunkState]] = \
        dataclasses.field(default_factory=dict)   # by (scheme, kappa)
    pins: int = 0                       # live references (engine._gc_lock)


def _host_shards(shards: Sequence) -> List:
    """The score arrays behind `shards` (a ScoreStore gives its memmap)."""
    return [getattr(s, "scores", s) for s in shards]


def _on_host(shards: List) -> List:
    """Shards kept on the host (a memory-mapped corpus): tensors become
    numpy arrays, arrays and memmaps stay as they are."""
    return [s.cpu().numpy() if isinstance(s, torch.Tensor) else s
            for s in shards]


def _residency(raw: List, device: torch.device,
               prefix: Optional[torch.Tensor] = None) \
        -> Tuple[List, Optional[torch.Tensor]]:
    """Place the corpus: in-RAM shards go into one flat float32 tensor on
    `device` (the shards become views into it); if any shard is memory
    mapped, all stay on the host and walks copy spans as they reach them.

    With `prefix` (an append's old flat), the new flat starts with a
    device copy of it, `raw` (the appended shards) follows, and the views
    returned are of `raw` only."""
    if any(isinstance(s, np.memmap) for s in raw):
        return _on_host(raw), None
    sizes = [int(s.shape[0]) for s in raw]
    start = 0 if prefix is None else int(prefix.numel())
    flat = torch.empty(start + sum(sizes), dtype=torch.float32,
                       device=device)
    if start:
        flat[:start].copy_(prefix)
    views = []
    for s, n in zip(raw, sizes):
        src = s if isinstance(s, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(s, np.float32))
        flat[start:start + n].copy_(src.reshape(-1))
        views.append(flat[start:start + n])
        start += n
    return views, flat


def state_from_reference(arrays: Dict[str, np.ndarray],
                         shards: Sequence) -> CorpusState:
    """Corpus state built from the JAX package's `CorpusState`, exported
    as numpy arrays — the system's state carried across packages.

    ``arrays`` holds, for n shards over B bins:

      * ``shard_counts``, ``shard_sum_w``, ``shard_sum_a``: (n, B) float32
        per-shard sketches; ``counts``, ``sum_w``, ``sum_a``: (B,) merged;
      * ``chunk_sum_sqrt``, ``chunk_sum_a``, ``chunk_sizes``: the shards'
        `ChunkMasses`, concatenated in shard order;
      * ``z``: [Σ sqrt(A), Σ A] float64; ``offsets``: (n+1,) int64;
      * ``chunk_records``: the plan's chunk size (one element).

    `shards` are the same score shards. The state is on the host;
    `SelectionEngine.from_state` places it on a device.
    """
    raw = _host_shards(shards)
    offsets = np.asarray(arrays["offsets"], np.int64)
    sizes = [int(s.shape[0]) for s in raw]
    if list(np.diff(offsets)) != sizes:
        raise ValueError("shards do not match the state's offsets")
    plan = pipeline.ChunkPlan(sizes, int(np.asarray(
        arrays["chunk_records"]).reshape(-1)[0]))

    def sketch(c, w, a):
        return binned.ScoreSketch(*(torch.from_numpy(np.array(v, np.float32))
                                    for v in (c, w, a)))

    per_shard = [sketch(c, w, a) for c, w, a in zip(
        arrays["shard_counts"], arrays["shard_sum_w"], arrays["shard_sum_a"])]
    masses, at = [], 0
    for sh in range(len(sizes)):
        k = plan.num_chunks(sh)
        masses.append(sampling.ChunkMasses(*(
            np.asarray(arrays[name][at:at + k], dt) for name, dt in (
                ("chunk_sum_sqrt", np.float64), ("chunk_sum_a", np.float64),
                ("chunk_sizes", np.int64)))))
        at += k
    z = np.asarray(arrays["z"], np.float64)
    return CorpusState(
        epoch=0, shards=raw, offsets=offsets, n_total=int(offsets[-1]),
        plan=plan, shard_sketches=per_shard,
        sketch=sketch(arrays["counts"], arrays["sum_w"], arrays["sum_a"]),
        chunk_masses=masses, z={"sqrt": float(z[0]), "prop": float(z[1])},
        flat=None)


class SelectionEngine:
    """Executes SUPG queries over a list of score shards on one device.

    Construction pays all O(n) work once (see the module docstring);
    queries then run off the cache. Use as a context manager so the
    engine's worker pool is released:

    >>> import numpy as np
    >>> from repro_torch.core.queries import SUPGQuery
    >>> scores = np.linspace(0.0, 1.0, 512, dtype=np.float32)
    >>> labels = (scores > 0.75).astype(np.float32)
    >>> q = SUPGQuery(target="recall", gamma=0.9, delta=0.1,
    ...               budget=128, method="is")
    >>> with SelectionEngine([scores[:256], scores[256:]], num_bins=32,
    ...                      device="cpu") as eng:
    ...     sel = eng.run(None, lambda idx: labels[idx], q)
    ...     bool(0.0 <= sel.tau <= 1.0), sel.total_selected > 0
    (True, True)
    """

    def __init__(self, shards: Sequence, num_bins: int = 4096,
                 weight_schemes: Sequence[str] = ("sqrt",),
                 kappa: float = sampling.DEFENSIVE_KAPPA,
                 chunk_records: Optional[int] = None,
                 workers: Optional[int] = None,
                 clamp_workers: bool = True,
                 device=None):
        self._setup(device, chunk_records, workers, clamp_workers, kappa)
        self.num_bins = int(num_bins)
        views, flat = _residency(_host_shards(shards), self.device)
        sizes = [int(s.shape[0]) for s in views]
        plan = pipeline.ChunkPlan(sizes, self.chunk_records)
        shard_sketches, chunk_masses = self._sketch_shards(views, plan, 0)
        sketch = (binned.merge_sketches(*shard_sketches) if shard_sketches
                  else binned.empty_sketch(self.num_bins, self.device))
        z_sqrt, z_prop, _ = binned.weight_normalizers(sketch)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._state = CorpusState(
            epoch=0, shards=views, offsets=offsets,
            n_total=int(offsets[-1]), plan=plan,
            shard_sketches=shard_sketches, sketch=sketch,
            chunk_masses=chunk_masses,
            z={"sqrt": float(z_sqrt), "prop": float(z_prop)}, flat=flat)
        # `weight_schemes` only pre-warms the chunk-mass CDFs; any other
        # scheme builds on first use.
        for scheme in weight_schemes:
            self._sampling_state(scheme, self.kappa)

    def _setup(self, device, chunk_records, workers, clamp_workers,
               kappa):
        self.device = resolve_device(device)
        self.kappa = float(kappa)
        self.chunk_records = int(chunk_records or pipeline.CHUNK_RECORDS)
        self.workers = _effective_workers(workers, clamp_workers)
        self.pool = pipeline.WorkerPool(self.workers)
        # Appends sketch under `_ingest_lock` and install their epoch under
        # `_gc_lock`, which also guards pins and the superseded epochs that
        # `gc_epochs` frees once no plan pins them.
        self._ingest_lock = threading.Lock()
        self._gc_lock = threading.Lock()
        self._superseded: List[CorpusState] = []
        self.epochs_freed = 0

    @classmethod
    def from_state(cls, state: CorpusState, *, device=None,
                   workers: Optional[int] = None,
                   clamp_workers: bool = True) -> "SelectionEngine":
        """An engine serving queries from an existing corpus state (e.g.
        `state_from_reference`), placed on `device` without re-sketching."""
        eng = cls.__new__(cls)
        eng._setup(device, state.plan.chunk_records, workers, clamp_workers,
                   sampling.DEFENSIVE_KAPPA)
        eng.num_bins = state.sketch.num_bins
        views, flat = _residency(list(state.shards), eng.device)

        def place(sk):
            return binned.ScoreSketch(*(t.to(eng.device) for t in sk))

        eng._state = dataclasses.replace(
            state, shards=views, flat=flat, sketch=place(state.sketch),
            shard_sketches=[place(sk) for sk in state.shard_sketches],
            sampling_cache={}, pins=0)
        eng._sampling_state("sqrt", eng.kappa)
        return eng

    def _span(self, shard, start: int, stop: int) -> torch.Tensor:
        """Records [start, stop) of one shard as a contiguous float32
        tensor on the engine's device (a view when the corpus lives
        there; a host copy moved over otherwise)."""
        if isinstance(shard, torch.Tensor):
            return shard[start:stop]
        block = np.array(shard[start:stop], dtype=np.float32)
        return torch.from_numpy(block).to(self.device)

    def _select(self, shard, start: int, stop: int,
                tau: float) -> torch.Tensor:
        return select_ops.threshold_select(self._span(shard, start, stop),
                                           tau)

    def _count(self, shard, start: int, stop: int,
               tau: float) -> torch.Tensor:
        return select_ops.threshold_count(self._span(shard, start, stop),
                                          tau)

    def _sketch_shards(self, shards: List, plan: pipeline.ChunkPlan,
                       first_shard: int):
        """Chunked sketch + raw-mass pass over ``shards[first_shard:]``:
        their sketches (left-fold merged in span order) and `ChunkMasses`.
        Each chunk writes its masses into its row of one float64
        (n_chunks, 2) buffer on the engine's device, read back once after
        the pass. A build passes ``first_shard=0``; `_append_shards` the
        old shard count, so an append sketches only the appended chunks,
        through the same per-chunk launches as a cold build."""
        spans = [sp for sp in plan if sp.shard_id >= first_shard]
        sums = torch.empty((len(spans), 2), dtype=torch.float64,
                           device=self.device)

        def sketch(i):
            sp = spans[i]
            return binned.chunk_sketch_into(
                self._span(shards[sp.shard_id], sp.start, sp.stop), sums[i],
                self.num_bins)

        stats = self.pool.map(sketch, range(len(spans)))
        host = sums.cpu().numpy()          # the pass's one read-back
        k = len(shards) - first_shard
        parts: List[List] = [[] for _ in range(k)]
        rows: List[List[int]] = [[] for _ in range(k)]
        for i, (sp, sk) in enumerate(zip(spans, stats)):
            parts[sp.shard_id - first_shard].append(sk)
            rows[sp.shard_id - first_shard].append(i)
        sketches = [binned.merge_sketches(*p) if p else
                    binned.empty_sketch(self.num_bins, self.device)
                    for p in parts]
        masses = [
            sampling.ChunkMasses(
                host[r, 0], host[r, 1],
                np.asarray([spans[i].size for i in r], np.int64))
            if r else sampling.ChunkMasses.empty()
            for r in rows]
        return sketches, masses

    # -- lifecycle ------------------------------------------------------

    def close(self) -> None:
        """Release the engine's worker pool (joins its threads).
        Idempotent; a closed engine still serves ``workers == 1``."""
        self.pool.close()

    def __enter__(self) -> "SelectionEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- cached state -----------------------------------------------------

    def pin(self) -> CorpusState:
        """Snapshot the corpus state for a multi-step computation; counts
        as a live reference until `unpin`."""
        with self._gc_lock:
            st = self._state
            st.pins += 1
            return st

    def unpin(self, state: CorpusState) -> None:
        """Release a reference taken by `pin`. Unbalanced unpins raise."""
        with self._gc_lock:
            if state.pins <= 0:
                raise ValueError(
                    f"unpin of epoch {state.epoch} with no live pins")
            state.pins -= 1

    def gc_epochs(self) -> int:
        """Free superseded epochs with no live pins; returns the count.

        Drops every reference a dead epoch holds: its flat device corpus,
        its shard views, sketches, chunk masses, CDFs and plan. Sketches
        and host shards shared with a live epoch stay alive through it;
        the dead epoch's own flat and global sketch go back to the
        allocator."""
        with self._gc_lock:
            live = [st for st in self._superseded if st.pins > 0]
            dead = [st for st in self._superseded if st.pins <= 0]
            self._superseded = live
            self.epochs_freed += len(dead)
        for st in dead:
            st.shards = []
            st.shard_sketches = []
            st.chunk_masses = []
            st.sampling_cache = {}
            st.sketch = None
            st.flat = None
            st.plan = None
        return len(dead)

    @property
    def epochs_live(self) -> int:
        """Epochs still holding memory: current + unfreed superseded."""
        with self._gc_lock:
            return 1 + len(self._superseded)

    @property
    def epoch(self) -> int:
        """Current corpus epoch: 0 at construction, +1 per append."""
        return self._state.epoch

    @property
    def shards(self) -> List:
        """Score shards of the current epoch (device tensor views, or host
        arrays and memmaps)."""
        return self._state.shards

    @property
    def offsets(self) -> np.ndarray:
        """(n_shards+1,) int64 global record offsets, current epoch."""
        return self._state.offsets

    @property
    def n_total(self) -> int:
        """Total records in the current epoch."""
        return self._state.n_total

    @property
    def plan(self) -> pipeline.ChunkPlan:
        """The current epoch's canonical ChunkPlan."""
        return self._state.plan

    @property
    def sketch(self) -> binned.ScoreSketch:
        """Global merged ScoreSketch of the current epoch."""
        return self._state.sketch

    @property
    def shard_sketches(self) -> List:
        """Per-shard ScoreSketches of the current epoch."""
        return self._state.shard_sketches

    def _append_shards(self, shards: Sequence) -> CorpusState:
        """Extend the corpus by `shards` and install the new epoch.

        The live plane's core (`repro_torch.live.IngestPlane` is its public
        face): sketch only the appended chunks (`_sketch_shards` from the
        old shard count), fold them onto the old global sketch (a left
        fold from zero, so bit for bit the cold fold), refresh the
        normalizers, rebuild every cached (scheme, kappa) CDF from the
        cached chunk masses (no old record is read), and install the new
        `CorpusState` under the GC lock. A device-resident corpus gets a
        new flat (module docstring, Epochs); memory-mapped or host shards
        keep `flat` None. Epochs pinned by in-flight plans stay valid.
        Returns the new state.
        """
        raw_new = _host_shards(shards)
        with self._ingest_lock:
            st = self._state
            if st.flat is None or any(isinstance(s, np.memmap)
                                      for s in raw_new):
                new_views, flat = _on_host(raw_new), None
                all_shards = st.shards + new_views
            else:
                new_views, flat = _residency(raw_new, self.device,
                                             prefix=st.flat)
                all_shards = [flat[a:b] for a, b in zip(
                    st.offsets[:-1], st.offsets[1:])] + new_views
            sizes = [int(s.shape[0]) for s in all_shards]
            plan = pipeline.ChunkPlan(sizes, self.chunk_records)
            new_sketches, new_masses = self._sketch_shards(
                all_shards, plan, len(st.shards))
            sketch = (binned.merge_sketches(st.sketch, *new_sketches)
                      if new_sketches else st.sketch)
            z_sqrt, z_prop, _ = binned.weight_normalizers(sketch)
            offsets = np.concatenate(
                [[0], np.cumsum(sizes)]).astype(np.int64)
            new_state = CorpusState(
                epoch=st.epoch + 1, shards=all_shards, offsets=offsets,
                n_total=int(offsets[-1]), plan=plan,
                shard_sketches=st.shard_sketches + new_sketches,
                sketch=sketch, chunk_masses=st.chunk_masses + new_masses,
                z={"sqrt": float(z_sqrt), "prop": float(z_prop)},
                flat=flat)
            # Pre-warm every (scheme, kappa) the outgoing epoch served, so
            # the first query after the append builds no CDF.
            for scheme, kappa in list(st.sampling_cache):
                self._sampling_state(scheme, kappa, state=new_state)
            with self._gc_lock:
                self._superseded.append(st)
                self._state = new_state
            return new_state

    def _sampling_state(self, scheme: str, kappa: float,
                        state: Optional[CorpusState] = None) \
            -> List[_ShardChunkState]:
        st = self._state if state is None else state
        cache_key = (scheme, float(kappa))
        if cache_key not in st.sampling_cache:
            states = []
            for cm in st.chunk_masses:
                if cm.sizes.size == 0:   # empty shard: zero mass, no draws
                    states.append(_ShardChunkState(
                        mass=0.0, cdf=np.empty(0, np.float64)))
                    continue
                total, cdf = sampling.chunk_mass_cdf(
                    cm.raw(scheme), cm.sizes, st.z[scheme], kappa,
                    st.n_total)
                states.append(_ShardChunkState(mass=total, cdf=cdf))
            st.sampling_cache[cache_key] = states
        return st.sampling_cache[cache_key]

    def _shard_masses(self, scheme: str, kappa: float,
                      state: Optional[CorpusState] = None) -> np.ndarray:
        states = self._sampling_state(scheme, kappa, state=state)
        mass = np.asarray([st.mass for st in states], np.float64)
        return mass / mass.sum()

    # -- sampling -------------------------------------------------------

    @staticmethod
    def _group_sorted(values: np.ndarray, order: np.ndarray):
        """Split `order` (an argsort of `values`) into runs of equal
        value; yields (value, positions)."""
        if order.size == 0:
            return
        sorted_vals = values[order]
        cuts = np.flatnonzero(np.diff(sorted_vals)) + 1
        for grp in np.split(order, cuts):
            yield int(values[grp[0]]), grp

    def draw_sample(self, key, s: int, scheme: str = "sqrt",
                    kappa: Optional[float] = None,
                    state: Optional[CorpusState] = None):
        """Global with-replacement draws; returns host (global_idx, m).

        Hierarchical (shard → chunk → record): only the allocated chunks
        are read, so transient memory is O(chunk). The joint probability
        telescopes to the global defensive-mixed p(x), so m(x) = (1/n) /
        p(x) is globally correct. Outputs land in preassigned slots, so
        results are identical at any worker count. `kappa` defaults to
        the engine's; `state` pins a corpus epoch (default: the current
        one).
        """
        st = self._state if state is None else state
        if scheme == "uniform":
            idx = random.randint(key, (s,), 0, st.n_total)
            return idx.astype(np.int64), np.ones(s, np.float32)
        kappa = self.kappa if kappa is None else kappa
        states = self._sampling_state(scheme, kappa, state=st)
        mass = self._shard_masses(scheme, kappa, state=st)
        k_alloc, k_chunk, k_rec = random.split(key, 3)
        alloc = random.categorical(k_alloc, random.log32(mass), (s,))
        u_chunk = random.uniform(k_chunk, (s,)).astype(np.float64)
        u_rec = random.uniform(k_rec, (s,)).astype(np.float64)
        out_idx = np.empty(s, np.int64)
        out_m = np.empty(s, np.float32)
        work = []    # (shard_id, chunk_id, draw positions into [0, s))
        for sh, seg in self._group_sorted(alloc,
                                          np.argsort(alloc, kind="stable")):
            chunk_ids = sampling.draw_from_cdf(states[sh].cdf,
                                               u_chunk[seg]).numpy()
            for ci, grp in self._group_sorted(
                    chunk_ids, np.argsort(chunk_ids, kind="stable")):
                work.append((sh, ci, seg[grp]))

        chunk = st.plan.chunk_records
        inv_n = float(np.float32(1.0 / st.n_total))

        def resolve(item):
            sh, ci, pos = item
            start = ci * chunk
            p = sampling.defensive_probs(
                self._span(st.shards[sh], start, start + chunk), scheme,
                st.z[scheme], kappa, st.n_total)
            local = sampling.draw_from_cdf(sampling.normalized_cdf(p),
                                           u_rec[pos])
            m = torch.div(torch.full_like(local, inv_n, dtype=torch.float32),
                          torch.clamp_min(p[local], 1e-38))
            out_idx[pos] = st.offsets[sh] + start + local.cpu().numpy()
            out_m[pos] = m.cpu().numpy()

        self.pool.map(resolve, work)
        return out_idx, out_m

    def score_at(self, global_idx,
                 state: Optional[CorpusState] = None) -> np.ndarray:
        """Host float32 scores of global record ids: one gather from the
        device corpus, or shard-routed host gathers for memmap shards."""
        st = self._state if state is None else state
        gi = np.asarray(global_idx, np.int64)
        if st.flat is not None:
            return st.flat[torch.from_numpy(gi).to(st.flat.device)] \
                .cpu().numpy()
        sh = np.searchsorted(st.offsets, gi, side="right") - 1
        local = gi - st.offsets[sh]
        out = np.empty(gi.shape[0], np.float32)
        order = np.argsort(sh, kind="stable")
        seg_bounds = np.searchsorted(sh[order],
                                     np.arange(len(st.shards) + 1))
        for shard_id in range(len(st.shards)):
            seg = order[seg_bounds[shard_id]:seg_bounds[shard_id + 1]]
            if seg.size:
                shard = st.shards[shard_id]
                if isinstance(shard, torch.Tensor):   # after an append
                    out[seg] = shard[torch.from_numpy(local[seg]).to(
                        shard.device)].cpu().numpy()
                else:
                    out[seg] = np.asarray(shard[local[seg]], np.float32)
        return out

    # -- query plans ------------------------------------------------------

    def _run_plan(self, key, query: SUPGQuery, *,
                  sink: Optional[pipeline.SelectionSink] = None,
                  chunk_records: Optional[int] = None,
                  ledger_parent: Optional[BudgetLedger] = None,
                  state: Optional[CorpusState] = None) \
            -> Generator[object, Optional[np.ndarray], ShardedSelection]:
        """Resumable plan for one RT/PT query.

        Yields `OracleRequest`s where labels are needed (and receives the
        label array back) and one `pipeline.ChunkWalk` for the emission
        pass; everything between yields is compute off the cached state.
        The plan pins one `CorpusState` for its whole run (`state`
        overrides which; a caller passing it owns that pin). Returns the
        ShardedSelection via StopIteration.value.
        """
        st = self.pin() if state is None else state
        try:
            result = yield from self._run_plan_pinned(
                key, query, sink=sink, chunk_records=chunk_records,
                ledger_parent=ledger_parent, st=st)
            return result
        finally:
            if state is None:
                self.unpin(st)

    def _run_plan_pinned(self, key, query: SUPGQuery, *,
                         sink: Optional[pipeline.SelectionSink] = None,
                         chunk_records: Optional[int] = None,
                         ledger_parent: Optional[BudgetLedger] = None,
                         st: CorpusState) \
            -> Generator[object, Optional[np.ndarray], ShardedSelection]:
        key = random.PRNGKey(0) if key is None else key
        ledger = BudgetLedger(query.budget, parent=ledger_parent)
        s = query.budget
        if query.target == "recall":
            scheme = {"is": query.weight_scheme, "uniform": "uniform",
                      "noci": "uniform"}[query.method]
            idx, m = self.draw_sample(key, s, scheme, state=st)
            o_s = yield OracleRequest(idx, ledger)
            a_s = self.score_at(idx, state=st)
            if query.method == "noci":
                res = thresholds.tau_unoci_r(a_s, o_s, query.gamma)
            else:
                res = thresholds.tau_ci_r(a_s, o_s, m, query.gamma,
                                          query.delta)
        else:
            k0, k1 = random.split(key)
            if query.method == "is" and query.two_stage:
                idx0, m0 = self.draw_sample(k0, s // 2,
                                            query.weight_scheme, state=st)
                o0 = yield OracleRequest(idx0, ledger)
                _, rank = thresholds.pt_stage1_nmatch(
                    o0, m0, st.n_total, query.gamma, query.delta)
                tau_dp = binned.rank_to_threshold(st.sketch, int(rank))
                # stage 2: uniform on D', rank-routed through the chunks
                idx1 = self._uniform_in_region(k1, s - s // 2, tau_dp,
                                               state=st)
                o1 = yield OracleRequest(idx1, ledger)
                a1 = self.score_at(idx1, state=st)
                res = thresholds.tau_ci_p(a1, o1, query.gamma,
                                          query.delta / 2.0,
                                          min_step=query.min_step)
            else:
                scheme = ("uniform" if query.method in ("uniform", "noci")
                          else query.weight_scheme)
                idx, m = self.draw_sample(k0, s, scheme, state=st)
                o_s = yield OracleRequest(idx, ledger)
                a_s = self.score_at(idx, state=st)
                if query.method == "noci":
                    res = thresholds.tau_unoci_p(a_s, o_s, query.gamma)
                else:
                    res = thresholds.tau_ci_p(
                        a_s, o_s, query.gamma, query.delta,
                        m_s=None if scheme == "uniform" else m,
                        min_step=query.min_step)
        tau = float(res.tau)

        pos = ledger.labeled_positives()
        walk, out_sink, finish = self._emission_walk(tau, pos, sink,
                                                     chunk_records,
                                                     state=st)
        try:
            yield walk
        except BaseException:
            # Emission died (a CallbackSink consumer raised, the walk was
            # poisoned, or the plan was abandoned at this yield): release
            # the sink so sequential reuse still works.
            _close_quietly(out_sink)
            raise
        return finish(ledger.charged)

    def _run_joint_plan(self, key, query: JointSUPGQuery, *,
                        sink: Optional[pipeline.SelectionSink] = None,
                        chunk_records: Optional[int] = None,
                        ledger_parent: Optional[BudgetLedger] = None,
                        state: Optional[CorpusState] = None) \
            -> Generator[object, Optional[np.ndarray], ShardedSelection]:
        """Resumable plan for one JT query (Appendix A): the RT sub-plan,
        then chunked verification requests over the candidate set. The
        verification ledger is capped at n_total, unbounded by design."""
        st = self.pin() if state is None else state
        try:
            result = yield from self._run_joint_plan_pinned(
                key, query, sink=sink, chunk_records=chunk_records,
                ledger_parent=ledger_parent, st=st)
            return result
        finally:
            if state is None:
                self.unpin(st)

    def _run_joint_plan_pinned(self, key, query: JointSUPGQuery, *,
                               sink=None, chunk_records=None,
                               ledger_parent=None, st: CorpusState) \
            -> Generator[object, Optional[np.ndarray], ShardedSelection]:
        rt = SUPGQuery(target="recall", gamma=query.gamma_recall,
                       delta=query.delta, budget=query.stage_budget,
                       method=query.method)
        cand = yield from self._run_plan(key, rt,
                                         chunk_records=chunk_records,
                                         ledger_parent=ledger_parent,
                                         state=st)
        vledger = BudgetLedger(st.n_total, parent=ledger_parent)
        out = pipeline.IndexSink() if sink is None else sink
        chunk = int(chunk_records or self.chunk_records)
        sizes = [int(s.shape[0]) for s in st.shards]
        out.open(sizes)
        try:
            for sh in range(len(st.shards)):
                local = cand.indices(sh)
                for start in range(0, local.size, chunk):
                    seg = local[start:start + chunk]
                    labels = yield OracleRequest(st.offsets[sh] + seg,
                                                 vledger)
                    out.emit(sh, seg[labels > 0.5])
        except BaseException:
            _close_quietly(out)
            raise
        counts = out.close()
        return ShardedSelection(
            tau=cand.tau,
            oracle_calls=cand.oracle_calls + vledger.charged,
            sampled_positive_global=cand.sampled_positive_global,
            sink=out, shard_sizes=sizes, counts=counts)

    def _plan_for(self, key, query, *, sink=None, chunk_records=None,
                  ledger_parent=None, state=None):
        if isinstance(query, JointSUPGQuery):
            return self._run_joint_plan(key, query, sink=sink,
                                        chunk_records=chunk_records,
                                        ledger_parent=ledger_parent,
                                        state=state)
        return self._run_plan(key, query, sink=sink,
                              chunk_records=chunk_records,
                              ledger_parent=ledger_parent, state=state)

    # -- query entry points -----------------------------------------------

    def run(self, key, oracle_fn, query: SUPGQuery, *,
            sink: Optional[pipeline.SelectionSink] = None,
            chunk_records: Optional[int] = None) -> ShardedSelection:
        """Execute one RT/PT query, streaming the selection through `sink`.

        `key` is a jax-format ``uint32[2]`` key (`repro_torch.random`;
        None means ``PRNGKey(0)``). `oracle_fn` is a plain ``indices ->
        labels`` callable or an `OracleClient`. With no sink the selection
        lands in an in-memory `IndexSink`; pass a `BitmaskStore` for
        out-of-core output or a `CallbackSink` to consume chunks as they
        are emitted.
        """
        return _drive_plan(
            self._run_plan(key, query, sink=sink,
                           chunk_records=chunk_records),
            as_oracle_client(oracle_fn), self.pool)

    def run_joint(self, key, oracle_fn, query: JointSUPGQuery, *,
                  sink: Optional[pipeline.SelectionSink] = None,
                  chunk_records: Optional[int] = None) -> ShardedSelection:
        """JT query (Appendix A): RT stage at gamma_recall, then oracle
        filtering of the candidate set into `sink` (precision exactly 1.0;
        oracle usage beyond the RT stage is unbounded by design). Both
        stages ride one labeling channel."""
        return _drive_plan(
            self._run_joint_plan(key, query, sink=sink,
                                 chunk_records=chunk_records),
            as_oracle_client(oracle_fn), self.pool)

    def session(self, oracle_fn, *, concurrency: Optional[int] = None,
                max_batch: Optional[int] = None,
                retry=None, call_timeout_s: Optional[float] = None,
                breaker=None) -> "QuerySession":
        """Open a `QuerySession`: the multi-query scheduler over one shared
        batched-oracle channel. Use as a context manager::

            with engine.session(oracle_fn, concurrency=8) as sess:
                handles = [sess.submit(q, key=k) for q, k in work]
                results = [h.result() for h in handles]

        All in-flight plans' oracle requests funnel through one
        `BatchingOracle` (an `OracleClient` passed in is shared as it is),
        so overlapping samples are labeled once. One cohort's coalesced
        drain runs on the channel's drain thread while the other cohort's
        plan steps run on the engine's worker pool, and a round's emission
        walks run as one fused chunk pass. `concurrency` caps in-flight
        plans (default: unbounded); `max_batch` caps records per oracle
        call; `retry`, `call_timeout_s` and `breaker` configure the
        private channel's fault tolerance (`core.resilience`). Overlap and
        retry accounting is on `session.stats` (a `SessionStats`).
        """
        return QuerySession(self, oracle_fn, concurrency=concurrency,
                            max_batch=max_batch, retry=retry,
                            call_timeout_s=call_timeout_s, breaker=breaker)

    def run_many(self, key, oracle_fn,
                 queries: Sequence[Union[SUPGQuery, JointSUPGQuery]], *,
                 sinks: Optional[Sequence[
                     Optional[pipeline.SelectionSink]]] = None,
                 chunk_records: Optional[int] = None,
                 concurrency: Optional[int] = None) \
            -> List[ShardedSelection]:
        """Serve a batch of RT / PT / JT queries through one `session()`.

        `key` is split into one key per query (`repro_torch.random.split`);
        the batch shares the cached state and one labeling channel, and
        budgets stay per query. Output (tau, counts, sink contents) is bit
        for bit the sequential path's at any `concurrency` for a pure
        oracle; only `oracle_calls` attribution can shift, since the
        shared cache answers later queries for free. `sinks`, when given,
        has one sink (or None) per query; one sink object cannot serve two
        queries.
        """
        if sinks is None:
            sinks = [None] * len(queries)
        # Validate the sinks before any key splitting, so a malformed call
        # fails on its actual mistake.
        if len(sinks) != len(queries):
            raise ValueError(
                f"need exactly one sink (or None) per query: got "
                f"{len(sinks)} sinks for {len(queries)} queries")
        live = [id(s) for s in sinks if s is not None]
        if len(live) != len(set(live)):
            raise ValueError(
                "one sink object is shared by multiple queries; their "
                "emissions would interleave — give each query its own sink")
        if not len(queries):
            return []
        keys = random.split(random.PRNGKey(0) if key is None else key,
                            len(queries))
        with self.session(oracle_fn, concurrency=concurrency) as sess:
            handles = [sess.submit(q, key=k, sink=snk,
                                   chunk_records=chunk_records)
                       for k, q, snk in zip(keys, queries, sinks)]
            return [h.result() for h in handles]

    # -- streaming emission ---------------------------------------------

    def _emission_walk(self, tau: float, pos: np.ndarray,
                       sink: Optional[pipeline.SelectionSink],
                       chunk_records: Optional[int],
                       state: Optional[CorpusState] = None,
                       shard_ids: Optional[Sequence[int]] = None):
        """Prepare the streamed {A >= tau} ∪ labeled-positives emission.

        Opens the sink, folds the labeled positives *below* tau (those at
        or above tau stream out of their own chunks, so fold and emit stay
        disjoint and counts exact), and returns ``(walk, sink, finish)``:
        the `ChunkWalk` whose spans run `threshold_select`, the opened
        sink, and the closure that closes the sink and builds the
        `ShardedSelection`. Unscored records (the -1 sentinel) are never
        emitted; an unscored labeled positive still folds in.

        `state` pins the epoch walked; `shard_ids` restricts the walk to
        those shards (a standing query's re-emission over appended shards;
        the sink still opens with every shard's size, so offsets hold).
        """
        st = self._state if state is None else state
        sink = pipeline.IndexSink() if sink is None else sink
        chunk = int(chunk_records or self.chunk_records)
        sizes = [int(s.shape[0]) for s in st.shards]
        if shard_ids is not None:
            plan = pipeline.ChunkPlan(sizes, chunk, shard_ids=shard_ids)
        else:
            plan = (st.plan if chunk == st.plan.chunk_records
                    else pipeline.ChunkPlan(sizes, chunk))
        sink.open(sizes)
        try:
            if pos.size:
                below = pos[self.score_at(pos, state=st) < tau]
                if below.size:
                    sh_ids = np.searchsorted(st.offsets, below,
                                             side="right") - 1
                    for shard_id in np.unique(sh_ids):
                        loc = (below[sh_ids == shard_id]
                               - st.offsets[shard_id])
                        sink.fold(int(shard_id), np.unique(loc))
        except BaseException:
            _close_quietly(sink)
            raise

        def emit_span(span):
            local = self._select(st.shards[span.shard_id], span.start,
                                 span.stop, tau)
            if local.numel():
                sink.emit(span.shard_id, span.start + local.cpu().numpy())

        def finish(oracle_calls: int) -> ShardedSelection:
            counts = sink.close()
            return ShardedSelection(
                tau=float(tau), oracle_calls=oracle_calls,
                sampled_positive_global=pos, sink=sink,
                shard_sizes=sizes, counts=counts)

        return pipeline.ChunkWalk(plan, emit_span), sink, finish

    def _uniform_in_region(self, key, s, tau, state=None) -> np.ndarray:
        """Uniform draws from {A >= tau} across shards, chunk-streamed.

        One counting pass of `threshold_count` over the chunk plan gives
        per-chunk region sizes, read back to the host once; draws are
        rank-routed through them, and the resolve pass runs
        `threshold_select` only on chunks that received draws. Empty
        regions get zero mass; if the region is globally empty the draws
        fall back to uniform over all records (stage-2 restriction is an
        efficiency device, never a correctness one).
        """
        st = self._state if state is None else state
        plan = st.plan
        spans = list(plan)
        span_counts = self.pool.map(
            lambda sp: self._count(st.shards[sp.shard_id], sp.start,
                                   sp.stop, tau), spans)
        span_counts = torch.stack(span_counts).cpu().numpy() \
            if span_counts else []
        per_shard = [np.zeros(plan.num_chunks(sh), np.int64)
                     for sh in range(len(st.shards))]
        for span, c in zip(spans, span_counts):
            per_shard[span.shard_id][span.chunk_id] = c
        counts = np.asarray([pc.sum() for pc in per_shard], np.float64)
        total = counts.sum()
        if total == 0:
            return random.randint(key, (s,), 0, st.n_total).astype(np.int64)
        mass = counts / total
        k_alloc, k_draw = random.split(key)
        # log(0) = -inf => empty shards are excluded from the categorical.
        alloc = random.categorical(k_alloc, random.log32(mass), (s,))
        out = np.empty(s, np.int64)
        dkeys = random.split(k_draw, len(st.shards))
        work = []    # (shard_id, chunk_id, positions, in-chunk region ranks)
        for sh, seg in self._group_sorted(alloc,
                                          np.argsort(alloc, kind="stable")):
            cum = np.concatenate([[0], np.cumsum(per_shard[sh])])
            r = random.randint(dkeys[sh], (seg.size,), 0,
                               int(cum[-1])).astype(np.int64)
            ch = np.searchsorted(cum, r, side="right") - 1
            corder = np.argsort(ch, kind="stable")
            for ci, grp in self._group_sorted(ch, corder):
                work.append((sh, ci, seg[grp], r[grp] - cum[ci]))

        chunk = plan.chunk_records

        def resolve(item):
            sh, ci, pos, ranks = item
            start = ci * chunk
            region = self._select(st.shards[sh], start, start + chunk, tau)
            picked = region[torch.from_numpy(ranks).to(region.device)]
            out[pos] = st.offsets[sh] + start + picked.cpu().numpy()

        self.pool.map(resolve, work)
        return out


def _drive_plan(plan, client: OracleClient,
                pool: Optional[pipeline.WorkerPool] = None) \
        -> ShardedSelection:
    """Sequential trampoline: answer each `OracleRequest` through the
    channel, run each `ChunkWalk` on the engine pool, resume the plan.

    A channel or walk error is thrown *into* the plan at its yield point,
    so the plan's cleanup (sink release) runs."""
    send = None
    while True:
        try:
            req = plan.send(send)
        except StopIteration as done:
            return done.value
        try:
            if isinstance(req, pipeline.ChunkWalk):
                walk_err = pipeline.run_fused([req], pool)[0]
                if walk_err is not None:
                    raise walk_err
                send = None
            else:
                send = client.submit(req.indices,
                                     ledger=req.ledger).result()
        except BaseException as err:  # noqa: BLE001 — rethrown in plan
            try:
                plan.throw(err)       # runs the plan's except/finally
            except StopIteration as done:
                return done.value     # plan absorbed the error gracefully
            raise RuntimeError(
                "plan yielded again after its request failed")


_START = object()       # inbox sentinel: plan not yet started


class QueryHandle:
    """Future for one query submitted to a `QuerySession`.

    `result()` pumps the session's scheduler until this query's plan
    completes, then returns its `ShardedSelection`, or raises the plan's
    error (`BudgetExceededError` if this query's ledger was rejected in a
    coalesced drain; the other queries are unaffected).
    """

    def __init__(self, session: "QuerySession", query, sink):
        self.query = query
        self.sink = sink
        self._session = session
        self._result: Optional[ShardedSelection] = None
        self._error: Optional[BaseException] = None
        self._done = False

    @property
    def done(self) -> bool:
        """True once this query's plan has completed (or failed)."""
        return self._done

    def result(self) -> ShardedSelection:
        """This query's `ShardedSelection` (pumps the session if needed)."""
        if not self._done:
            self._session._pump(until=self)
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class SessionStats:
    """Per-session scheduler accounting.

    `drain_busy_s` is the wall time coalesced drains were in flight on
    the channel and `drain_wait_s` how long the driver blocked on them;
    their difference (`overlap_hidden_s`) is oracle latency hidden under
    the other cohort's compute. `walk_spans` counts the chunk spans the
    round's emission walks would cost run one by one, `fused_spans` the
    spans the fused passes walked (`spans_saved` is the difference). On
    the card each owner of a fused span still launches `threshold_select`
    on it, so `walk_spans` is the launches the walks make."""

    rounds: int = 0            # scheduler turns taken
    plan_steps: int = 0        # generator resumptions
    drains: int = 0            # coalesced drains launched
    drain_busy_s: float = 0.0  # wall time drains spent in flight
    drain_wait_s: float = 0.0  # driver time blocked awaiting drains
    fused_walks: int = 0       # emission walks executed through fusion
    walk_spans: int = 0        # spans those walks would cost unfused
    fused_spans: int = 0       # spans the fused passes actually ran
    retries: int = 0           # oracle calls re-attempted (resilience)
    timeouts: int = 0          # oracle calls killed by the watchdog
    batch_failures: int = 0    # micro-batches that exhausted retries/fatal
    batch_sheds: int = 0       # micro-batches shed by the open circuit

    @property
    def overlap_hidden_s(self) -> float:
        """Oracle in-flight time the driver never blocked on."""
        return max(0.0, self.drain_busy_s - self.drain_wait_s)

    @property
    def spans_saved(self) -> int:
        """Chunk touches eliminated by per-round walk fusion."""
        return self.walk_spans - self.fused_spans


class QuerySession:
    """Scheduler that drives N query plans concurrently over one shared,
    batched labeling channel: `SelectionEngine.session()`'s return value.

    In-flight plans are split across two cohorts that take strictly
    alternating turns. One turn advances every plan of the current cohort
    to its next yield on the engine's `WorkerPool` (sampling, tau
    estimation and emission run there, launching their kernels from the
    pool's threads; the cohort's `ChunkWalk`s run as one fused span
    pass), then settles the other cohort's in-flight drain, submits this
    cohort's requests in submission order, and starts their coalesced
    drain on the channel's drain thread (`BatchingOracle.drain_async`),
    which only labels on the host. At most one drain is in flight, a
    cohort is stepped only after its own drain's tickets resolved, and
    cohort state commits before any channel call, so results are bit for
    bit the sequential path's at any worker count and overlap, and the
    fixed submission order keeps charge attribution reproducible at a
    given concurrency.

    Finished plans leave their cohort; queued plans join in submission
    order, balanced so both cohorts carry work. A plan whose ticket failed
    (e.g. `BudgetExceededError`) has the error thrown into it at its
    yield on its next turn: its handle raises, co-batched queries are
    untouched; a poisoned drain reaches every ticket it owned.

    The scheduler runs on whichever thread pumps it (`handle.result()`,
    `step()`, or the context manager's exit).

    >>> import numpy as np
    >>> from repro_torch import random
    >>> from repro_torch.core.queries import SUPGQuery
    >>> scores = np.linspace(0.0, 1.0, 512, dtype=np.float32)
    >>> labels = (scores > 0.75).astype(np.float32)
    >>> qs = [SUPGQuery(target="recall", gamma=0.9, delta=0.1,
    ...                 budget=128, method="is") for _ in range(3)]
    >>> keys = random.split(random.PRNGKey(0), 3)
    >>> with SelectionEngine([scores], num_bins=32, device="cpu") as eng:
    ...     with eng.session(lambda idx: labels[idx]) as sess:
    ...         handles = [sess.submit(q, key=k)
    ...                    for q, k in zip(qs, keys)]
    ...         results = [h.result() for h in handles]
    >>> len(results), sess.client.fn_calls <= len(qs)  # coalesced drains
    (3, True)
    """

    def __init__(self, engine: SelectionEngine, oracle_fn, *,
                 concurrency: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 retry=None, call_timeout_s: Optional[float] = None,
                 breaker=None):
        self.engine = engine
        self._owns_client = not isinstance(oracle_fn, OracleClient)
        self.client = as_oracle_client(oracle_fn, max_batch=max_batch,
                                       retry=retry,
                                       call_timeout_s=call_timeout_s,
                                       breaker=breaker)
        self.concurrency = (None if concurrency is None
                            else max(1, int(concurrency)))
        self.stats = SessionStats()
        self._queued: List[Tuple[QueryHandle, Generator]] = []
        # Two cohorts of slots [handle, plan, inbox]; _turn picks the one
        # stepped next. _outstanding is the in-flight drain of the cohort
        # whose turn just ended: (DrainHandle, [(slot, ticket), ...]).
        self._bufs: List[List[List]] = [[], []]
        self._turn = 0
        self._outstanding: Optional[
            Tuple[DrainHandle, List[Tuple[List, object]]]] = None
        self._closed = False

    # -- submission -------------------------------------------------------

    def submit(self, query, *, key=None,
               sink: Optional[pipeline.SelectionSink] = None,
               chunk_records: Optional[int] = None,
               ledger_parent: Optional[BudgetLedger] = None,
               state: Optional[CorpusState] = None) -> QueryHandle:
        """Enqueue one RT/PT/JT query; returns its `QueryHandle`.

        `key` defaults to ``PRNGKey(0)``. The plan starts when a scheduler
        turn has a free cohort slot (`concurrency` caps the two cohorts'
        combined size). `ledger_parent` chains the query's budget ledger
        under a shared quota ledger. `state` pins the plan to a corpus
        epoch (`engine.pin()`, owned by the caller); by default the plan
        pins the epoch current at its first step.
        """
        if self._closed:
            raise RuntimeError("QuerySession is closed")
        handle = QueryHandle(self, query, sink)
        plan = self.engine._plan_for(key, query, sink=sink,
                                     chunk_records=chunk_records,
                                     ledger_parent=ledger_parent,
                                     state=state)
        self._queued.append((handle, plan))
        return handle

    def submit_plan(self, plan: Generator, *, query=None,
                    sink: Optional[pipeline.SelectionSink] = None) \
            -> QueryHandle:
        """Enqueue a pre-built resumable plan; returns its `QueryHandle`.

        For plans that are not SUPG queries but speak the same yield
        protocol (`OracleRequest` / `pipeline.ChunkWalk`): the live
        plane's standing re-emissions enter here and join the same
        cohorts, walk fusion and drains as ordinary queries. `query` and
        `sink` only annotate the handle.
        """
        if self._closed:
            raise RuntimeError("QuerySession is closed")
        handle = QueryHandle(self, query, sink)
        self._queued.append((handle, plan))
        return handle

    def drain(self) -> None:
        """Explicit barrier on the shared channel (pending tickets only:
        plans advance when the scheduler is pumped)."""
        self.client.drain()

    # -- scheduler --------------------------------------------------------

    def _work_left(self) -> bool:
        return bool(self._queued or self._bufs[0] or self._bufs[1]
                    or self._outstanding is not None)

    @property
    def in_flight(self) -> int:
        """Queries admitted or queued but not yet completed."""
        return (len(self._queued) + len(self._bufs[0])
                + len(self._bufs[1]))

    def step(self) -> bool:
        """Advance the scheduler by exactly one turn; True if work remains.

        The incremental pump for a host that drives the session from its
        own thread: submit any number of queries, call `step()` until it
        returns False (or poll handles' `done` between turns); new
        submissions join the next turn's admission.
        """
        if self._work_left():
            self._round()
        return self._work_left()

    def _pump(self, until: Optional[QueryHandle] = None) -> None:
        """Run scheduler turns until `until` (or everything) completes."""
        while not (until._done if until is not None
                   else not self._work_left()):
            if not self._work_left():
                raise RuntimeError(
                    "pumped a handle that is neither queued nor active")
            self._round()

    def _admit(self, buf: List[List]) -> None:
        """Move queued plans into `buf`, keeping the cohorts balanced:
        each is filled to at most half the concurrency cap, so a full
        session always has a second cohort to compute under the first
        one's drain."""
        active = len(self._bufs[0]) + len(self._bufs[1])
        cap = self.concurrency or (active + len(self._queued))
        half = max(1, -(-cap // 2))
        while self._queued and active < cap and len(buf) < half:
            handle, plan = self._queued.pop(0)
            buf.append([handle, plan, _START])
            active += 1

    def _step_cohort(self, buf: List[List]) -> List[Tuple[str, object]]:
        """Advance every slot of one cohort to its next `OracleRequest`
        or completion. Slots pausing at `ChunkWalk` yields have their walks
        fused and run as one span pass on the engine pool, then resume, so
        the cohort leaves this call holding only oracle requests and
        results. Steps land in their slots, so the thread count never
        changes an output, and a walk's error goes back into its plan."""

        def step(i):
            _, plan, inbox = buf[i]
            try:
                if inbox is _START:
                    out = plan.send(None)
                elif isinstance(inbox, BaseException):
                    out = plan.throw(inbox)
                else:
                    out = plan.send(inbox)
            except StopIteration as done:
                return ("done", done.value)
            except BaseException as err:  # noqa: BLE001 — owned by handle
                return ("err", err)
            if isinstance(out, pipeline.ChunkWalk):
                return ("walk", out)
            return ("req", out)

        outcomes: List[Optional[Tuple[str, object]]] = [None] * len(buf)
        live = list(range(len(buf)))
        while live:
            self.stats.plan_steps += len(live)
            stepped = self.engine.pool.map(step, live)
            walkers: List[int] = []
            for i, res in zip(live, stepped):
                outcomes[i] = res
                if res[0] == "walk":
                    walkers.append(i)
            if not walkers:
                break
            walks = [outcomes[i][1] for i in walkers]
            geoms: Dict[Tuple, pipeline.ChunkPlan] = {}
            for w in walks:
                geoms.setdefault(w.plan.geometry, w.plan)
            self.stats.fused_walks += len(walks)
            self.stats.walk_spans += sum(
                w.plan.total_chunks for w in walks)
            self.stats.fused_spans += sum(
                p.total_chunks for p in geoms.values())
            errs = pipeline.run_fused(walks, self.engine.pool)
            for i, err in zip(walkers, errs):
                # None resumes the plan past its walk; an error is thrown
                # into it (releasing its sink) on the re-step below.
                buf[i][2] = err
            live = walkers
        return outcomes

    def _await_outstanding(self) -> None:
        """Settle the in-flight drain (if any) and deliver its tickets'
        labels, or its poison, into the owning cohort's inboxes."""
        if self._outstanding is None:
            return
        handle, pending = self._outstanding
        self._outstanding = None
        t0 = time.perf_counter()
        handle.wait()
        self.stats.drain_wait_s += time.perf_counter() - t0
        self.stats.drain_busy_s += handle.duration_s
        self.stats.retries += handle.retries
        self.stats.timeouts += handle.timeouts
        self.stats.batch_failures += handle.batch_failures
        self.stats.batch_sheds += handle.batch_sheds
        for slot, ticket in pending:
            try:
                slot[2] = ticket.result()
            except BaseException as err:  # noqa: BLE001 — rethrown in plan
                slot[2] = err

    def _round(self) -> None:
        """One scheduler turn: admit + step the current cohort (fusing its
        walks), commit, settle the other cohort's drain, then start this
        cohort's drain and hand the turn over."""
        cur = self._turn
        buf = self._bufs[cur]
        self._admit(buf)
        self.stats.rounds += 1
        requests: List[Tuple[List, OracleRequest]] = []
        if buf:
            # The compute that overlaps the other cohort's drain: the
            # drain thread touches only the channel, the steps only
            # engine state.
            outcomes = self._step_cohort(buf)
            survivors: List[List] = []
            for slot, (kind, value) in zip(buf, outcomes):
                handle = slot[0]
                if kind == "done":
                    handle._result, handle._done = value, True
                elif kind == "err":
                    handle._error, handle._done = value, True
                else:
                    requests.append((slot, value))
                    survivors.append(slot)
            # Commit the cohort before touching the channel: a submit
            # whose max_batch auto-drain runs a broken oracle must find
            # finished plans gone and give every survivor a definitive
            # inbox, never a stale one from the previous turn.
            self._bufs[cur] = buf = survivors
        # Settle the other cohort's drain before submitting: submits would
        # only block on the channel lock the drain holds anyway.
        self._await_outstanding()
        if requests:
            pending: List[Tuple[List, object]] = []
            try:
                for slot, req in requests:
                    pending.append((slot, self.client.submit(
                        req.indices, ledger=req.ledger)))
            except BaseException as err:  # noqa: BLE001 — into inboxes
                # A submit-time auto-drain failed: its poison marks every
                # ticket it popped; the plans see the error on their next
                # turn, as with an async drain failure.
                submitted = {id(slot) for slot, _ in pending}
                for slot, _ in requests:
                    if id(slot) not in submitted:
                        slot[2] = err     # failed before this submit ran
                for slot, ticket in pending:
                    try:
                        slot[2] = ticket.result()
                    except BaseException as terr:  # noqa: BLE001
                        slot[2] = terr
            else:
                self.stats.drains += 1
                self._outstanding = (self._start_drain(), pending)
        self._turn = 1 - cur

    def _start_drain(self) -> DrainHandle:
        """Start the pending tickets' coalesced drain, overlapped when the
        client has `drain_async`; other `OracleClient`s drain on the
        driver thread (same results, no overlap)."""
        start = getattr(self.client, "drain_async", None)
        if start is not None:
            return start()
        handle = DrainHandle()
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        try:
            self.client.drain()
        except BaseException as e:  # noqa: BLE001 — carried by handle
            err = e
        handle._finish(err, time.perf_counter() - t0)
        return handle

    # -- lifecycle --------------------------------------------------------

    def close(self, abandon: bool = False) -> None:
        """Finish the session: pump every submitted query to completion
        (unless `abandon`), then reject stragglers, close their plans, and
        reap the channel's drain thread (a session-owned client only: a
        caller's `OracleClient` outlives the session)."""
        if self._closed:
            return
        if not abandon:
            self._pump()
        self._await_outstanding()    # settle any in-flight drain
        self._closed = True
        leftovers = self._queued + [
            (s[0], s[1]) for s in self._bufs[0] + self._bufs[1]]
        self._queued, self._bufs = [], [[], []]
        for handle, plan in leftovers:
            plan.close()
            if not handle._done:
                handle._error = RuntimeError("QuerySession abandoned")
                handle._done = True
        if self._owns_client:
            close_client = getattr(self.client, "close", None)
            if close_client is not None:
                close_client()

    def __enter__(self) -> "QuerySession":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(abandon=exc_type is not None)
        return False
