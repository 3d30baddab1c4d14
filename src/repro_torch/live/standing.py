"""Standing queries: certified once, re-emitting over every new epoch.

A `StandingQuery` is registered against a `QuerySession` + `IngestPlane`
pair through a `StandingRegistry`. The query certifies its tau on the
epoch current at registration (an ordinary RT/PT plan through the
session); from then on each `pump()` catches every certified query up to
the latest epoch with a *re-emission plan*: a threshold walk over exactly
the shards appended since the query's last epoch
(`ChunkPlan(shard_ids=...)`), streaming {A >= tau} into the query's own
sink. On the card that is one `threshold_select` launch per appended
chunk; no old chunk is walked. Re-emission plans enter the session
through `QuerySession.submit_plan`, so they join the same cohorts, walk
fusion and drains as ordinary queries.

Re-emitting a certified tau over appended data is the right default only
while the score distribution has not drifted: pair the registry with a
`repro_torch.live.sentinel.DriftSentinel` to re-validate tau when it has.
"""
from __future__ import annotations

import threading
from typing import Generator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.engine import (CorpusState, QueryHandle, QuerySession,
                                     ShardedSelection, _close_quietly)
from repro_torch.core.oracle import BudgetLedger
from repro_torch.data import pipeline
from repro_torch.live.ingest import IngestPlane


def _reemission_plan(engine, tau: float,
                     sink: Optional[pipeline.SelectionSink],
                     shard_ids: Sequence[int],
                     state: CorpusState) \
        -> Generator[object, Optional[np.ndarray], ShardedSelection]:
    """Resumable plan: one {A >= tau} walk over `shard_ids` of `state`.

    Speaks `_run_plan`'s yield protocol (a single `ChunkWalk` yield, no
    oracle request), so a `QuerySession` schedules and fuses it like any
    query plan.
    """
    walk, out_sink, finish = engine._emission_walk(
        tau, np.empty(0, np.int64), sink, None, state=state,
        shard_ids=shard_ids)
    try:
        yield walk
    except BaseException:
        _close_quietly(out_sink)
        raise
    return finish(0)


class StandingQuery:
    """One registered query: its certification result and re-emission
    bookkeeping. Made by `StandingRegistry.register`; a consumer holds it
    to await certification and watch re-emission progress.
    """

    def __init__(self, query, key=None,
                 sink: Optional[pipeline.SelectionSink] = None):
        self.query = query
        self.key = key
        self.sink = sink
        self.tau: Optional[float] = None
        self.selection: Optional[ShardedSelection] = None
        self.epoch = -1                 # last epoch the sink is current for
        self.emissions = 0              # re-emission walks completed
        self.records_reemitted = 0      # records those walks selected
        self.reemit_failures = 0
        self.last_error: Optional[BaseException] = None
        self._certified = threading.Event()
        self._error: Optional[BaseException] = None
        self._busy = False              # a re-emission plan is in flight

    @property
    def certified(self) -> bool:
        """True once the initial certification query completed cleanly."""
        return self._certified.is_set() and self._error is None

    def wait_certified(self, timeout: Optional[float] = None) -> float:
        """Block until certification completes; returns tau.

        Raises `TimeoutError` on timeout, or the certification error if
        the query failed. Safe from any thread: whoever pumps the registry
        sets the event.
        """
        if not self._certified.wait(timeout):
            raise TimeoutError(
                "standing query not certified within timeout")
        if self._error is not None:
            raise self._error
        return float(self.tau)

    def update_tau(self, tau: float) -> None:
        """Install a re-validated tau; later re-emissions use it."""
        self.tau = float(tau)


class StandingRegistry:
    """Owns the standing queries of one (`IngestPlane`, `QuerySession`).

    Drive it from the thread that pumps the session: `activate` starts
    certifications, `pump` submits catch-up re-emission plans for
    certified queries behind the current epoch, and `poll` folds finished
    handles back into their `StandingQuery`s.

    >>> import numpy as np
    >>> from repro_torch.core.engine import SelectionEngine
    >>> from repro_torch.core.queries import SUPGQuery
    >>> from repro_torch.live.ingest import IngestPlane
    >>> scores = np.linspace(0.0, 1.0, 512, dtype=np.float32)
    >>> labels = lambda idx: (np.asarray(idx) >= 384).astype(np.float32)
    >>> eng = SelectionEngine([scores], num_bins=32, device="cpu")
    >>> sess = eng.session(labels)
    >>> reg = StandingRegistry(IngestPlane(eng), sess)
    >>> sq = reg.register(SUPGQuery(target="recall", gamma=0.9,
    ...                             budget=128, method="is"))
    >>> reg.settle()    # pump the certification to completion
    >>> tau = sq.wait_certified(timeout=0)
    >>> _ = reg.plane.append(np.full(256, 0.99, np.float32))
    >>> reg.pump()      # one catch-up walk over the appended shard
    1
    >>> reg.settle(); (sq.emissions, sq.records_reemitted, sq.epoch)
    (1, 256, 1)
    >>> sess.close(); eng.close()
    """

    def __init__(self, plane: IngestPlane, session: QuerySession):
        self.plane = plane
        self.session = session
        self._lock = threading.Lock()
        self._standing: List[StandingQuery] = []
        # (sq, handle, kind, state): kind is "certify" or "reemit"; the
        # pinned CorpusState is unpinned when the handle folds, so epoch
        # GC can free superseded epochs once no plan reads them.
        self._pending: List[Tuple[StandingQuery, QueryHandle, str,
                                  CorpusState]] = []
        self.emissions = 0
        self.records_reemitted = 0

    @property
    def standing(self) -> List[StandingQuery]:
        """Snapshot of the registered standing queries."""
        with self._lock:
            return list(self._standing)

    def register(self, query, *, key=None,
                 sink: Optional[pipeline.SelectionSink] = None,
                 ledger_parent: Optional[BudgetLedger] = None) \
            -> StandingQuery:
        """Create a `StandingQuery` and start its certification."""
        return self.activate(StandingQuery(query, key, sink),
                             ledger_parent=ledger_parent)

    def activate(self, sq: StandingQuery, *,
                 ledger_parent: Optional[BudgetLedger] = None) \
            -> StandingQuery:
        """Submit `sq`'s certification plan; call on the pumping thread.

        The plan pins the epoch current now, so the certification and the
        query's re-emission baseline name the same corpus even if an
        append lands while the plan runs.
        """
        state = self.plane.engine.pin()
        sq.epoch = state.epoch
        handle = self.session.submit(sq.query, key=sq.key, sink=sq.sink,
                                     ledger_parent=ledger_parent,
                                     state=state)
        with self._lock:
            self._standing.append(sq)
            self._pending.append((sq, handle, "certify", state))
        return sq

    def adopt(self, sq: StandingQuery) -> StandingQuery:
        """Reinstate an already-certified `StandingQuery` without running
        anything: it keeps its tau, epoch and counters, no plan is
        submitted and no oracle budget is spent. The next `pump` catches
        its sink up to the current epoch."""
        with self._lock:
            self._standing.append(sq)
        return sq

    def poll(self) -> None:
        """Fold every finished pending handle into its `StandingQuery`."""
        with self._lock:
            pending, self._pending = self._pending, []
        keep = []
        for sq, handle, kind, state in pending:
            if not handle.done:
                keep.append((sq, handle, kind, state))
                continue
            self.plane.engine.unpin(state)
            try:
                sel = handle.result()
            except BaseException as err:  # noqa: BLE001 — folded into sq
                if kind == "certify":
                    sq._error = err
                    sq._certified.set()
                else:
                    sq.reemit_failures += 1
                    sq.last_error = err
                    sq._busy = False
                continue
            if kind == "certify":
                sq.tau = float(sel.tau)
                sq.selection = sel
                sq._certified.set()
            else:
                sq.emissions += 1
                sq.records_reemitted += sel.total_selected
                sq._busy = False
                with self._lock:
                    self.emissions += 1
                    self.records_reemitted += sel.total_selected
        with self._lock:
            self._pending = keep + self._pending

    def has_pending(self) -> bool:
        """True while any certification or re-emission is in flight."""
        with self._lock:
            return bool(self._pending)

    def pump(self) -> int:
        """Submit catch-up re-emission plans; returns how many started.

        For every certified, idle standing query behind the current
        epoch: pin the epoch, restrict a threshold walk to the shards
        appended since the query's last epoch, and submit it through
        `QuerySession.submit_plan` (so concurrent catch-ups fuse). The
        query's epoch advances to the pinned one at once: the walk covers
        exactly the gap.
        """
        self.poll()
        started = 0
        for sq in self.standing:
            if not sq.certified or sq._busy:
                continue
            state = self.plane.engine.pin()
            if sq.epoch >= state.epoch:
                self.plane.engine.unpin(state)
                continue
            # An append may install between the pin and this call, so
            # shards_since (which reads the current shard list) can name
            # shards the pinned epoch lacks: clamp to the pinned state;
            # the excess is walked next turn.
            shard_ids = [s for s in self.plane.shards_since(sq.epoch)
                         if s < len(state.shards)]
            if not shard_ids:
                sq.epoch = state.epoch
                self.plane.engine.unpin(state)
                continue
            plan = _reemission_plan(self.plane.engine, sq.tau, sq.sink,
                                    shard_ids, state)
            handle = self.session.submit_plan(plan, query=sq.query,
                                              sink=sq.sink)
            sq._busy = True
            sq.epoch = state.epoch
            with self._lock:
                self._pending.append((sq, handle, "reemit", state))
            started += 1
        return started

    def settle(self) -> None:
        """Run every pending handle to completion (pumps the session)."""
        while True:
            with self._lock:
                pending = list(self._pending)
            if not pending:
                return
            for _, handle, _, _ in pending:
                if not handle.done:
                    try:
                        handle.result()
                    except BaseException:  # noqa: BLE001 — poll folds it
                        pass
            self.poll()
