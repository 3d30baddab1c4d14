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
     (`_uniform_in_region`) counts and resolves its region draws with the
     same kernel.

**Residency.** In-RAM shards (numpy arrays or tensors) are copied once, at
construction, into one flat float32 tensor on the engine's device; the
shards are views into it, and it is also `score_at`'s gather cache, so
nothing is held twice. Memory-mapped shards (`ScoreStore`) stay on the
host and each span is copied to the device when a walk reaches it.

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
from typing import Dict, Generator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import binned, sampling, thresholds
from repro_torch.core.oracle import (BudgetLedger, OracleClient,
                                     OracleRequest, as_oracle_client)
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery
from repro_torch.data import pipeline
from repro_torch.kernels.threshold_select import ops as select_ops

logger = logging.getLogger(__name__)

_clamp_logged = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises if CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the engine runs on cuda unless "
            "the caller passes device='cpu'")
    return dev


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
    """One shard's hierarchical draw state for one weight scheme."""
    mass: float            # shard total defensive mass (unnormalized)
    cdf: np.ndarray        # (n_chunks,) float64 normalized chunk-mass CDF


@dataclasses.dataclass
class CorpusState:
    """Every piece of engine state a query reads, as one snapshot.

    `shards` are float32 tensor views into `flat` (device-resident corpus)
    or host memmaps (`flat` is None). Sketches are float32 tensors on the
    engine's device; chunk masses and chunk CDFs are host numpy.
    """

    shards: List                        # per-shard tensor views or memmaps
    offsets: np.ndarray                 # (n_shards+1,) int64 global offsets
    n_total: int                        # total records
    plan: pipeline.ChunkPlan            # the canonical chunk plan
    shard_sketches: List                # per-shard binned.ScoreSketch
    sketch: binned.ScoreSketch          # global merged sketch
    chunk_masses: List[sampling.ChunkMasses]   # per-shard raw chunk masses
    z: Dict[str, float]                 # global weight normalizers
    flat: Optional[torch.Tensor]        # the device corpus (or None)
    sampling_cache: Dict[str, List[_ShardChunkState]] = \
        dataclasses.field(default_factory=dict)   # by weight scheme
    pins: int = 0                       # live references (engine._gc_lock)


def _host_shards(shards: Sequence) -> List:
    """The score arrays behind `shards` (a ScoreStore gives its memmap)."""
    return [getattr(s, "scores", s) for s in shards]


def _residency(raw: List, device: torch.device) \
        -> Tuple[List, Optional[torch.Tensor]]:
    """Place the corpus: in-RAM shards go into one flat float32 tensor on
    `device` (the shards become views into it); if any shard is memory
    mapped, all stay on the host and walks copy spans as they reach them."""
    if any(isinstance(s, np.memmap) for s in raw):
        return [s.cpu().numpy() if isinstance(s, torch.Tensor) else s
                for s in raw], None
    sizes = [int(s.shape[0]) for s in raw]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    views, start = [], 0
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
        shards=raw, offsets=offsets, n_total=int(offsets[-1]), plan=plan,
        shard_sketches=per_shard,
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
                 chunk_records: Optional[int] = None,
                 workers: Optional[int] = None,
                 clamp_workers: bool = True,
                 device=None):
        self._setup(device, chunk_records, workers, clamp_workers)
        self.num_bins = int(num_bins)
        views, flat = _residency(_host_shards(shards), self.device)
        sizes = [int(s.shape[0]) for s in views]
        plan = pipeline.ChunkPlan(sizes, self.chunk_records)
        shard_sketches, chunk_masses = self._sketch_shards(views, plan)
        sketch = (binned.merge_sketches(*shard_sketches) if shard_sketches
                  else binned.empty_sketch(self.num_bins, self.device))
        z_sqrt, z_prop, _ = binned.weight_normalizers(sketch)
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._state = CorpusState(
            shards=views, offsets=offsets, n_total=int(offsets[-1]),
            plan=plan, shard_sketches=shard_sketches, sketch=sketch,
            chunk_masses=chunk_masses,
            z={"sqrt": float(z_sqrt), "prop": float(z_prop)}, flat=flat)
        self._sampling_state("sqrt")

    def _setup(self, device, chunk_records, workers, clamp_workers):
        self.device = resolve_device(device)
        self.chunk_records = int(chunk_records or pipeline.CHUNK_RECORDS)
        self.workers = _effective_workers(workers, clamp_workers)
        self.pool = pipeline.WorkerPool(self.workers)
        self._gc_lock = threading.Lock()

    @classmethod
    def from_state(cls, state: CorpusState, *, device=None,
                   workers: Optional[int] = None,
                   clamp_workers: bool = True) -> "SelectionEngine":
        """An engine serving queries from an existing corpus state (e.g.
        `state_from_reference`), placed on `device` without re-sketching."""
        eng = cls.__new__(cls)
        eng._setup(device, state.plan.chunk_records, workers, clamp_workers)
        eng.num_bins = state.sketch.num_bins
        views, flat = _residency(list(state.shards), eng.device)

        def place(sk):
            return binned.ScoreSketch(*(t.to(eng.device) for t in sk))

        eng._state = dataclasses.replace(
            state, shards=views, flat=flat, sketch=place(state.sketch),
            shard_sketches=[place(sk) for sk in state.shard_sketches],
            sampling_cache={}, pins=0)
        eng._sampling_state("sqrt")
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

    def _sketch_shards(self, shards: List, plan: pipeline.ChunkPlan):
        """Chunked sketch + raw-mass pass: per-shard sketches (left-fold
        merged in span order) and per-shard `ChunkMasses`."""
        spans = list(plan)
        stats = self.pool.map(
            lambda sp: binned.chunk_sketch_stats(
                self._span(shards[sp.shard_id], sp.start, sp.stop),
                self.num_bins), spans)
        parts: List[List] = [[] for _ in shards]
        sums: List[List[Tuple[float, float, int]]] = [[] for _ in shards]
        for sp, (sk, s_sqrt, s_a) in zip(spans, stats):
            parts[sp.shard_id].append(sk)
            sums[sp.shard_id].append((s_sqrt, s_a, sp.size))
        sketches = [binned.merge_sketches(*p) if p else
                    binned.empty_sketch(self.num_bins, self.device)
                    for p in parts]
        masses = [
            sampling.ChunkMasses(
                np.asarray([t[0] for t in ss], np.float64),
                np.asarray([t[1] for t in ss], np.float64),
                np.asarray([t[2] for t in ss], np.int64))
            if ss else sampling.ChunkMasses.empty()
            for ss in sums]
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
                raise ValueError("unpin with no live pins")
            state.pins -= 1

    @property
    def shards(self) -> List:
        """Score shards (device tensor views, or host memmaps)."""
        return self._state.shards

    @property
    def offsets(self) -> np.ndarray:
        """(n_shards+1,) int64 global record offsets."""
        return self._state.offsets

    @property
    def n_total(self) -> int:
        """Total records."""
        return self._state.n_total

    @property
    def plan(self) -> pipeline.ChunkPlan:
        """The canonical ChunkPlan."""
        return self._state.plan

    @property
    def sketch(self) -> binned.ScoreSketch:
        """Global merged ScoreSketch."""
        return self._state.sketch

    @property
    def shard_sketches(self) -> List:
        """Per-shard ScoreSketches."""
        return self._state.shard_sketches

    def _sampling_state(self, scheme: str,
                        state: Optional[CorpusState] = None) \
            -> List[_ShardChunkState]:
        st = self._state if state is None else state
        if scheme not in st.sampling_cache:
            states = []
            for cm in st.chunk_masses:
                if cm.sizes.size == 0:   # empty shard: zero mass, no draws
                    states.append(_ShardChunkState(
                        mass=0.0, cdf=np.empty(0, np.float64)))
                    continue
                total, cdf = sampling.chunk_mass_cdf(
                    cm.raw(scheme), cm.sizes, st.z[scheme],
                    sampling.DEFENSIVE_KAPPA, st.n_total)
                states.append(_ShardChunkState(mass=total, cdf=cdf))
            st.sampling_cache[scheme] = states
        return st.sampling_cache[scheme]

    def _shard_masses(self, scheme: str,
                      state: Optional[CorpusState] = None) -> np.ndarray:
        states = self._sampling_state(scheme, state=state)
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
                    state: Optional[CorpusState] = None):
        """Global with-replacement draws; returns host (global_idx, m).

        Hierarchical (shard → chunk → record): only the allocated chunks
        are read, so transient memory is O(chunk). The joint probability
        telescopes to the global defensive-mixed p(x), so m(x) = (1/n) /
        p(x) is globally correct. Outputs land in preassigned slots, so
        results are identical at any worker count.
        """
        st = self._state if state is None else state
        if scheme == "uniform":
            idx = random.randint(key, (s,), 0, st.n_total)
            return idx.astype(np.int64), np.ones(s, np.float32)
        states = self._sampling_state(scheme, state=st)
        mass = self._shard_masses(scheme, state=st)
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
                st.z[scheme], sampling.DEFENSIVE_KAPPA, st.n_total)
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
                out[seg] = np.asarray(
                    st.shards[shard_id][local[seg]], np.float32)
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

    # -- streaming emission ---------------------------------------------

    def _emission_walk(self, tau: float, pos: np.ndarray,
                       sink: Optional[pipeline.SelectionSink],
                       chunk_records: Optional[int],
                       state: Optional[CorpusState] = None):
        """Prepare the streamed {A >= tau} ∪ labeled-positives emission.

        Opens the sink, folds the labeled positives *below* tau (those at
        or above tau stream out of their own chunks, so fold and emit stay
        disjoint and counts exact), and returns ``(walk, sink, finish)``:
        the `ChunkWalk` whose spans run `threshold_select`, the opened
        sink, and the closure that closes the sink and builds the
        `ShardedSelection`. Unscored records (the -1 sentinel) are never
        emitted; an unscored labeled positive still folds in.
        """
        st = self._state if state is None else state
        sink = pipeline.IndexSink() if sink is None else sink
        chunk = int(chunk_records or self.chunk_records)
        sizes = [int(s.shape[0]) for s in st.shards]
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

        One counting pass of `threshold_select` over the chunk plan gives
        per-chunk region sizes; draws are rank-routed through them, and
        the resolve pass re-runs the kernel only on chunks that received
        draws. Empty regions get zero mass; if the region is globally
        empty the draws fall back to uniform over all records (stage-2
        restriction is an efficiency device, never a correctness one).
        """
        st = self._state if state is None else state
        plan = st.plan
        spans = list(plan)
        span_counts = self.pool.map(
            lambda sp: self._select(st.shards[sp.shard_id], sp.start,
                                    sp.stop, tau).numel(), spans)
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
