"""Oracle / proxy UDF interfaces, batched labeling, and budget accounting.

The paper's operational model (Section 4.1): the user supplies
  * a proxy model A(x) in [0,1] — cheap, executed over the complete dataset
    (in this framework: a distributed `serve` pass of one of the configured
    architectures, see launch/serve.py), and
  * an oracle predicate O(x) in {0,1} — expensive (human, or an oracle-grade
    model), rate-limited by the query's ORACLE LIMIT.

Because the oracle is the rate-limited resource, a serving system's
throughput is set by how well it *coalesces* oracle calls. This module
therefore splits the old monolithic `BudgetedOracle` into three parts:

`OracleClient` protocol — the batched labeling channel
    ``submit(indices, ledger=...) -> Ticket`` enqueues a labeling request;
    ``drain()`` is the explicit barrier that resolves everything pending.
    Plans and sessions speak only this protocol, so the expensive callable
    is invoked at the *channel's* cadence, not the caller's. Clients may
    additionally expose ``drain_async() -> DrainHandle`` — the overlapped
    drain surface: the pending set is snapshotted at call time and resolved
    on a dedicated drain thread so callers keep computing while oracle I/O
    is in flight. ``drain()`` stays the synchronous wrapper with identical
    semantics, so every existing caller works unchanged.

`BatchingOracle` — the one real implementation
    Coalesces pending requests from any number of concurrent queries into
    micro-batches of at most ``max_batch`` unique records per underlying
    ``fn`` call, backed by one process-wide label cache per client
    instance. `SelectionEngine.session()` funnels every in-flight query of
    a `QuerySession` through a single `BatchingOracle`, which is what makes
    cross-query batching (and cross-query cache reuse) happen.

`BudgetLedger` — per-query budget *views* over the shared channel
    Budget semantics under a shared cache:

      * a record is *charged* the moment the channel has to invoke ``fn``
        for it, and it is charged to exactly one ledger — the earliest
        submitted ticket (in `submit` order) that requested it;
      * a record whose label is already cached (labeled earlier for any
        query of the same client/session) is **free**: query B never pays
        for what query A already bought. `ledger.charged` is therefore an
        *attribution*, not a per-query isolation guarantee — at different
        session concurrency levels the same query can be charged
        differently, while its labels (and hence its selection) are
        identical for any pure ``fn``;
      * enforcement is still strictly per query: inside one coalesced
        drain, a ticket whose charge would push its ledger past its
        ORACLE LIMIT fails with `BudgetExceededError` *alone* — co-batched
        tickets still resolve, and indices requested only by the failing
        ticket are neither sent to ``fn`` nor cached (no label leaks from
        an over-budget query);
      * `ledger.labeled_positives()` sees only records the *owning query*
        requested (Algorithm 1's R1 must not absorb other queries'
        samples), returned sorted so results never depend on how batches
        interleaved across queries.

`as_oracle_client` adapts a plain ``indices -> labels`` callable into a
private `BatchingOracle`, so every legacy entry point (`run`, `run_joint`,
`run_many`, `queries.run_query`) keeps accepting bare callables unchanged.
`BudgetedOracle` survives as the back-compat callable facade — one private
client plus one ledger — with the original semantics: repeat draws of the
same record (possible under with-replacement sampling) are answered from
the cache and do NOT consume budget, matching how a batch labeling system
behaves.

Fault tolerance (`core.resilience`): the channel treats transport
failures exactly like budget failures — *per ticket*, never per drain.
Each micro-batch is validated (length + finiteness; a torn or NaN
response is rejected before caching and raised as
`OracleMalformedError`), optionally watchdogged (`call_timeout_s` →
`OracleTimeoutError`), retried per an injectable `RetryPolicy`
(transient errors only), and gated by a `CircuitBreaker`. Only when a
micro-batch exhausts its retries (or fails fatally) do the tickets
whose records sat in that micro-batch fail — with the typed transport
error — while co-batched tickets whose records labeled cleanly still
resolve. Ledgers are charged per *completed* micro-batch only, and the
shared label cache never holds unpaid or malformed labels.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Callable, List, Optional, Protocol, Tuple, \
    runtime_checkable

import numpy as np

from repro_torch.core.resilience import (CircuitBreaker, CircuitOpenError,
                                   OracleMalformedError, OracleTimeoutError,
                                   RetryPolicy, call_with_timeout,
                                   is_retryable)


class BudgetExceededError(RuntimeError):
    """Raised when a query attempts to exceed its ORACLE LIMIT."""


# ---------------------------------------------------------------------------
# Vectorized label cache
# ---------------------------------------------------------------------------

class _LabelCache:
    """Sorted-array label cache with vectorized membership.

    Replaces the per-element Python dict probe loop: lookups are one
    `searchsorted` over the batch (a 1e6-index probe is a single numpy
    pass), inserts are one merge. Keys are unique int64 record ids.
    """

    def __init__(self):
        self._keys = np.empty(0, np.int64)
        self._vals = np.empty(0, np.float32)

    def __len__(self) -> int:
        return int(self._keys.size)

    def lookup(self, idx: np.ndarray):
        """Vectorized probe: returns (labels, known_mask) aligned to idx.

        Unknown positions carry 0.0 in `labels`; callers must consult
        `known_mask` before trusting them.
        """
        idx = np.asarray(idx, np.int64)
        if self._keys.size == 0:
            return (np.zeros(idx.shape[0], np.float32),
                    np.zeros(idx.shape[0], bool))
        pos = np.searchsorted(self._keys, idx)
        pos = np.minimum(pos, self._keys.size - 1)
        known = self._keys[pos] == idx
        out = np.where(known, self._vals[pos], 0.0).astype(np.float32)
        return out, known

    def missing(self, idx: np.ndarray) -> np.ndarray:
        """Sorted unique indices from `idx` not present in the cache."""
        uniq = np.unique(np.asarray(idx, np.int64))
        if self._keys.size == 0:
            return uniq
        _, known = self.lookup(uniq)
        return uniq[~known]

    def insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Merge new keys into the sorted store.

        `keys` must be sorted, unique, and disjoint from the store (every
        caller passes `np.unique`/`missing()` output). Both sides being
        sorted, this is a linear two-way merge — O(N + k), not the
        O(N log N) re-sort that would make a long-lived session's drains
        quadratic in cumulative cache size.
        """
        keys = np.asarray(keys, np.int64)
        if keys.size == 0:
            return
        vals = np.asarray(vals, np.float32)
        if self._keys.size == 0:
            self._keys, self._vals = keys.copy(), vals.copy()
            return
        ins = np.searchsorted(self._keys, keys) + np.arange(keys.size)
        out_k = np.empty(self._keys.size + keys.size, np.int64)
        out_v = np.empty(out_k.size, np.float32)
        out_k[ins], out_v[ins] = keys, vals
        old = np.ones(out_k.size, bool)
        old[ins] = False
        out_k[old], out_v[old] = self._keys, self._vals
        self._keys, self._vals = out_k, out_v

    def positives(self) -> np.ndarray:
        """Sorted indices with a positive cached label."""
        return self._keys[self._vals > 0.5].copy()


# ---------------------------------------------------------------------------
# Budget ledgers — per-query views over a shared channel
# ---------------------------------------------------------------------------

class BudgetLedger:
    """One query's budget view of a (possibly shared) labeling channel.

    Tracks how many `fn` labels were *attributed* to this query
    (`charged`, capped at `budget` — see the module docstring for the
    attribution rule under a shared cache) and which records this query
    requested, so `labeled_positives()` reflects exactly this query's
    sample — never co-batched queries' labels.

    Ledgers chain: `parent` names a coarser shared ledger (the serving
    plane's per-tenant quota) that every charge flows through as well.
    Enforcement covers the whole chain — a charge that fits the query's
    own budget but would blow the tenant quota fails exactly like a
    per-query overrun (`BudgetExceededError`, the failing ticket alone),
    so a tenant exhausting its quota mid-drain cannot starve co-batched
    queries of other tenants. `label` names the ledger in error messages
    ("tenant 'abc' quota") so clients can tell a quota rejection from a
    per-query ORACLE LIMIT.

    >>> tenant = BudgetLedger(5, label="tenant 'abc' quota")
    >>> q1, q2 = BudgetLedger(4, parent=tenant), BudgetLedger(4, parent=tenant)
    >>> q1.charge(3); (q1.remaining, q2.remaining)   # parent caps q2 at 2
    (1, 2)
    >>> try:
    ...     q2.charge(3)
    ... except BudgetExceededError as e:
    ...     print(e)
    oracle budget 5 exceeded (tenant 'abc' quota): 3 used, 3 requested
    """

    def __init__(self, budget: int, *,
                 parent: Optional["BudgetLedger"] = None,
                 label: Optional[str] = None):
        self.budget = int(budget)
        self.charged = 0
        self.parent = parent
        self.label = label
        self._seen = _LabelCache()   # records this query requested

    def chain(self) -> List["BudgetLedger"]:
        """This ledger followed by its ancestors (query -> tenant -> ...)."""
        out, node = [], self
        while node is not None:
            out.append(node)
            node = node.parent
        return out

    @property
    def remaining(self) -> int:
        """Headroom left on the tightest ledger of the chain."""
        return min(l.budget - l.charged for l in self.chain())

    def charge(self, k: int) -> None:
        """Commit `k` attributed labels to every ledger of the chain.

        Checked before committed, so a chain whose parent rejects leaves
        the child uncharged (the drain's pre-check makes rejection here
        unreachable on the batched path, but direct callers keep atomic
        semantics)."""
        for led in self.chain():
            if led.charged + k > led.budget:
                raise led.exceeded(led.charged, int(k))
        for led in self.chain():
            led.charged += int(k)

    def exceeded(self, used: int, requested: int) -> "BudgetExceededError":
        """Build this ledger's budget-overrun error (labelled for quotas)."""
        tag = f" ({self.label})" if self.label else ""
        return BudgetExceededError(
            f"oracle budget {self.budget} exceeded{tag}: "
            f"{used} used, {requested} requested")

    def record(self, idx: np.ndarray, labels: np.ndarray) -> None:
        """Attach resolved labels for records this query requested."""
        idx = np.asarray(idx, np.int64)
        uniq, first = np.unique(idx, return_index=True)
        _, known = self._seen.lookup(uniq)
        if not known.all():
            self._seen.insert(uniq[~known],
                              np.asarray(labels, np.float32)[first[~known]])

    def labeled_positives(self) -> np.ndarray:
        """Sorted positive-labeled records among this query's requests —
        the R1 component of Algorithm 1. Sorted by construction so the
        result is independent of batch interleaving across queries."""
        return self._seen.positives()


@dataclasses.dataclass
class OracleRequest:
    """What a query plan yields when it needs labels: a batch of record
    indices plus the ledger the resulting charges belong to. `ledger=None`
    requests uncapped, unattributed labeling (used nowhere by the built-in
    plans; JT verification carries an explicit n_total-capped ledger)."""
    indices: np.ndarray
    ledger: Optional[BudgetLedger] = None


# ---------------------------------------------------------------------------
# The batched labeling channel
# ---------------------------------------------------------------------------

class Ticket:
    """Handle for one submitted labeling request. `result()` blocks the
    logical exchange: it drains the owning channel if the ticket is still
    pending, then returns labels aligned to the submitted indices (or
    raises this ticket's error — e.g. `BudgetExceededError` when the
    coalesced drain rejected this query's charge)."""

    __slots__ = ("indices", "ledger", "_owner", "_labels", "_error", "_done")

    def __init__(self, owner: "BatchingOracle", indices: np.ndarray,
                 ledger: Optional[BudgetLedger]):
        self._owner = owner
        self.indices = indices
        self.ledger = ledger
        self._labels: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        self._done = False

    @property
    def done(self) -> bool:
        """True once a drain resolved (or poisoned) this ticket."""
        return self._done

    def result(self) -> np.ndarray:
        """Labels aligned to the submitted indices (drains if pending)."""
        if not self._done:
            self._owner.drain()
        if self._error is not None:
            raise self._error
        if not self._done:
            # Never hand back labels for a ticket a drain dropped.
            raise RuntimeError("ticket unresolved after drain")
        return self._labels


class DrainHandle:
    """Completion handle for one asynchronous drain.

    Settles exactly once, with either success or the drain's error; the
    error also poisons every ticket the drain had popped (the same
    semantics a synchronous `drain()` has), so awaiting the handle and
    then reading tickets observes one consistent outcome. Callers must
    `wait()`/`exception()`/`result()` the handle *before* calling
    `result()` on any ticket the drain owns — a ticket poked mid-flight
    would trigger a useless synchronous drain of an empty pending set.
    `duration_s` is the wall time the resolve spent in flight (0.0 for
    the empty-drain fast path) — the overlap metric sessions report.
    `retries` / `timeouts` / `batch_failures` / `batch_sheds` are this
    drain's slice of the channel's resilience counters (snapshotted
    under the channel lock, so concurrent drains never double-count) —
    `SessionStats` aggregates them per session.
    """

    __slots__ = ("_event", "_error", "tickets", "duration_s",
                 "retries", "timeouts", "batch_failures", "batch_sheds")

    def __init__(self, tickets: int = 0):
        self._event = threading.Event()
        self._error: Optional[BaseException] = None
        self.tickets = int(tickets)
        self.duration_s = 0.0
        self.retries = 0
        self.timeouts = 0
        self.batch_failures = 0
        self.batch_sheds = 0

    def _finish(self, error: Optional[BaseException],
                duration_s: float = 0.0) -> None:
        self._error = error
        self.duration_s = float(duration_s)
        self._event.set()

    @property
    def done(self) -> bool:
        """True once the drain has settled (success or failure)."""
        return self._event.is_set()

    def wait(self) -> None:
        """Block until the drain settles (success or failure)."""
        self._event.wait()

    def exception(self) -> Optional[BaseException]:
        """Block until settled; return the drain's error, or None."""
        self._event.wait()
        return self._error

    def result(self) -> None:
        """Block until settled; raise the drain's error if it failed."""
        err = self.exception()
        if err is not None:
            raise err


@runtime_checkable
class OracleClient(Protocol):
    """The batched labeling channel protocol query plans are driven over.

    `submit`/`drain` are the required surface. Implementations may also
    provide ``drain_async() -> DrainHandle`` (see `BatchingOracle`);
    schedulers probe for it with `getattr` and fall back to the
    synchronous `drain`, so third-party clients stay protocol-complete
    without it."""

    def submit(self, indices,
               ledger: Optional[BudgetLedger] = None) -> Ticket:
        """Enqueue a labeling request; resolved at the next drain."""
        ...

    def drain(self) -> None:
        """Barrier: resolve every pending ticket."""
        ...


class BatchingOracle:
    """`OracleClient` that coalesces concurrent queries' requests into
    micro-batches over one shared label cache.

    `submit` only enqueues (auto-draining once the pending *new-to-cache*
    record count reaches `max_batch`); `drain` is the explicit barrier:
    it walks pending tickets in submission order, attributes each
    new-to-cache record to the earliest ticket requesting it, enforces
    each ledger's budget over its attributed records (a failing ticket
    errors alone; its exclusive records are dropped from the batch and
    never cached), then invokes ``fn`` on the surviving unique records in
    sorted micro-batches of at most `max_batch`.

    `fn_calls` / `records_labeled` / `cache_hits` count underlying oracle
    invocations, labeled records, and requested records answered without
    a new labeling (from the cache, or coalesced into an earlier
    co-batched ticket's claim) — the serving-side metrics a session
    exists to minimize. Thread-safe: `submit` and `drain` serialize on
    one lock (drain runs ``fn`` while holding it, so concurrent
    submitters observe either the pre- or post-drain cache, never a
    partial one).

    `pacer`, when given, is the serving plane's rate-limiter hook: it is
    called with the micro-batch size right before each ``fn`` invocation
    (a token bucket, say), so oracle pacing composes with
    `drain_async` — a paced drain blocks on the drain thread while plan
    compute keeps running. A pacer that *raises* is classified through
    the same taxonomy as ``fn`` failures: a transient throttle error is
    retried per policy, while `serve.RateLimitError` (a request that can
    never fit the bucket) fails the micro-batch's tickets alone — it
    never kills the drain, the drain thread, or co-batched tickets.

    Fault tolerance (`retry` / `call_timeout_s` / `breaker` — see
    `core.resilience`): each micro-batch invocation is validated (a
    wrong-length or non-finite response raises `OracleMalformedError`
    *before* anything is cached), optionally watchdogged
    (`call_timeout_s` seconds per call, overruns raise
    `OracleTimeoutError` and the late result is discarded), and retried
    per `retry` while the error classifies transient — with
    deterministic backoff on the draining thread. Only when a
    micro-batch exhausts its attempts (or fails fatally, or the
    `breaker` is open) do the tickets whose records were in that
    micro-batch fail, carrying the typed error; tickets whose records
    all labeled cleanly still resolve in the same drain, and ledgers
    are only ever charged for completed micro-batches. The breaker
    records one failure per exhausted micro-batch and trips open after
    its threshold; while open, micro-batches fail fast with
    `CircuitOpenError` until the cooldown grants a half-open probe —
    the probe's grant covers every retry attempt of its micro-batch,
    and the chunk's final outcome (success / exhaustion) settles it.
    `retries` / `timeouts` / `batch_failures` / `batch_sheds` count fn
    re-invocations, watchdog overruns, micro-batches that exhausted
    their retries (or failed fatally), and micro-batches shed by the
    open circuit (sheds are load the breaker refused, not channel
    failures, so the two counters never mix).

    When `call_timeout_s` is set, a timed-out invocation's thread is
    abandoned, not killed — so the retry that follows may run while the
    abandoned call is still executing. ``fn`` must therefore tolerate
    concurrent invocation when watchdogged (pure array lookups and
    `testing.FaultInjector` qualify; an oracle with shared mutable
    state needs its own lock).

    >>> import numpy as np
    >>> calls = []
    >>> def fn(idx):
    ...     calls.append(len(idx))
    ...     return (np.asarray(idx) % 2).astype(np.float32)
    >>> client = BatchingOracle(fn)
    >>> a = client.submit([3, 4, 5], ledger=BudgetLedger(8))
    >>> b = client.submit([4, 5, 6], ledger=BudgetLedger(8))
    >>> client.drain()                  # one coalesced fn micro-batch
    >>> calls, client.fn_calls, client.cache_hits
    ([4], 1, 2)
    >>> [int(v) for v in b.result()]    # labels aligned to b's indices
    [0, 1, 0]

    `drain_async` is the overlapped-drain surface: it pops the pending
    tickets *at call time* (so later submits deterministically belong to
    the next drain) and resolves them on a lazily created, dedicated drain
    thread, returning a `DrainHandle`. Exception-poisoning semantics are
    identical to the synchronous path — a failed resolve marks every
    popped ticket with the error before the handle settles. The drain
    thread only exists once `drain_async` has been used; `close()` reaps
    it (pure-`drain()` clients never pay for one).
    """

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 max_batch: Optional[int] = None,
                 pacer: Optional[Callable[[int], object]] = None,
                 retry: Optional[RetryPolicy] = None,
                 call_timeout_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None):
        if max_batch is not None and max_batch <= 0:
            raise ValueError("max_batch must be positive")
        if call_timeout_s is not None and call_timeout_s <= 0:
            raise ValueError("call_timeout_s must be positive")
        self._fn = fn
        self.max_batch = max_batch
        # The rate-limiter hook on the drain path: called with the
        # micro-batch size immediately before each underlying `fn`
        # invocation (a `serve.TokenBucket` blocks here until the batch
        # is inside the configured rate). Because resolution runs on the
        # drain thread under `drain_async`, pacing throttles the channel
        # while plan compute keeps overlapping it.
        self._pacer = pacer
        self.retry = retry
        self.call_timeout_s = call_timeout_s
        self.breaker = breaker
        self._cache = _LabelCache()
        self._pending: List[Ticket] = []
        self._pending_new = 0
        self._lock = threading.RLock()
        self._drain_worker: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        self.fn_calls = 0
        self.records_labeled = 0
        self.cache_hits = 0
        self.retries = 0          # fn re-invocations after transient errors
        self.timeouts = 0         # watchdogged calls that overran the deadline
        self.batch_failures = 0   # micro-batches that exhausted retries/fatal
        self.batch_sheds = 0      # micro-batches shed by the open circuit

    @property
    def cache_size(self) -> int:
        """Number of distinct records with a cached label."""
        return len(self._cache)

    def submit(self, indices,
               ledger: Optional[BudgetLedger] = None) -> Ticket:
        """Enqueue a labeling request; resolved at the next drain (or
        immediately, if the pending new-record count trips `max_batch`)."""
        idx = np.asarray(indices, np.int64).reshape(-1)
        with self._lock:
            t = Ticket(self, idx, ledger)
            self._pending.append(t)
            # The new-to-cache probe exists only to arm the auto-drain
            # threshold; without a max_batch cap it would be pure waste
            # (drain recomputes the missing sets anyway).
            if self.max_batch is not None:
                self._pending_new += int(self._cache.missing(idx).size)
                if self._pending_new >= self.max_batch:
                    self._drain_locked()
            return t

    def drain(self) -> None:
        """Barrier: resolve every pending ticket on the calling thread."""
        with self._lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        tickets, self._pending = self._pending, []
        self._pending_new = 0
        self._resolve_guarded(tickets)

    def _resolve_guarded(self, tickets: List[Ticket]) -> None:
        if not tickets:
            return
        try:
            self._resolve(tickets)
        except BaseException as err:
            # Poisoned drain: every popped ticket must leave resolved —
            # the ones the failure skipped carry the failure itself, so a
            # later result() raises instead of returning stale labels
            # (already-cached earlier micro-batches stay; they were
            # labeled correctly).
            for t in tickets:
                if not t._done:
                    t._error, t._done = err, True
            raise

    def drain_async(self) -> DrainHandle:
        """Start resolving everything pending on the drain thread.

        The pending set is snapshotted under the lock *now*: tickets
        submitted after this call belong to the next drain, so overlap
        never changes which drain owns a request. With nothing pending
        the returned handle is already settled and no thread is touched.
        Await the handle before calling `result()` on any popped ticket.
        """
        with self._lock:
            tickets, self._pending = self._pending, []
            self._pending_new = 0
            handle = DrainHandle(len(tickets))
            if not tickets:
                handle._finish(None)
                return handle
            if self._drain_worker is None:
                self._drain_worker = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="repro-torch-drain")

            def resolve_snapshot():
                t0 = time.perf_counter()
                err: Optional[BaseException] = None
                try:
                    with self._lock:
                        # Counter deltas are exact per drain: the whole
                        # resolve runs under the channel lock, so no
                        # concurrent drain can interleave its counts.
                        before = (self.retries, self.timeouts,
                                  self.batch_failures, self.batch_sheds)
                        try:
                            self._resolve_guarded(tickets)
                        finally:
                            handle.retries = self.retries - before[0]
                            handle.timeouts = self.timeouts - before[1]
                            handle.batch_failures = (
                                self.batch_failures - before[2])
                            handle.batch_sheds = (
                                self.batch_sheds - before[3])
                except BaseException as e:  # noqa: BLE001 — handle carries
                    err = e
                handle._finish(err, time.perf_counter() - t0)

            # Enqueued under the lock: concurrent drain_async calls hit
            # the single drain thread in pop order, so snapshots resolve
            # in the order their tickets were claimed.
            self._drain_worker.submit(resolve_snapshot)
        return handle

    def close(self) -> None:
        """Reap the drain thread (if `drain_async` ever created one),
        waiting for any in-flight `drain_async` resolve to settle its
        `DrainHandle` first. Loops because a concurrent `drain_async`
        may install a fresh worker after we popped the old one — close
        must reap that one too, or its thread leaks. Safe to call
        multiple times; the client stays usable for synchronous
        submit/drain afterwards."""
        while True:
            with self._lock:
                worker, self._drain_worker = self._drain_worker, None
            if worker is None:
                return
            worker.shutdown(wait=True)

    def _resolve(self, tickets: List[Ticket]) -> None:
        # 1. attribution + enforcement, in submission order: each record
        #    not in the cache is claimed by the earliest ticket requesting
        #    it; a ticket whose claims would blow any ledger of its chain
        #    (its own ORACLE LIMIT or a shared parent quota) fails alone
        #    and its exclusive claims are released (later tickets may
        #    re-claim them).
        claimed = np.empty(0, np.int64)          # sorted union of claims
        claims: List = []                        # (ticket, its new records)
        drain_charge: dict = {}                  # ledger -> pending charge
        for t in tickets:
            uniq_requested = int(np.unique(t.indices).size)
            new = self._cache.missing(t.indices)
            if claimed.size:
                new = new[~np.isin(new, claimed)]
            if t.ledger is not None:
                chain = t.ledger.chain()
                over = next(
                    (led for led in chain
                     if (led.charged + drain_charge.get(id(led), 0)
                         + new.size > led.budget)), None)
                if over is not None:
                    used = over.charged + drain_charge.get(id(over), 0)
                    t._error = over.exceeded(used, int(new.size))
                    t._done = True
                    continue
                for led in chain:
                    drain_charge[id(led)] = (
                        drain_charge.get(id(led), 0) + int(new.size))
            self.cache_hits += uniq_requested - int(new.size)
            claims.append((t, new))
            claimed = np.union1d(claimed, new)
        # 2. label the surviving union in sorted micro-batches <= max_batch,
        #    charging each ledger the moment a micro-batch *completes*:
        #    if a micro-batch fails (retries exhausted / fatal / circuit
        #    open), the records already labeled (and cached) stay paid
        #    for, the failed chunk is never charged, and the remaining
        #    chunks still run — real oracle usage can never exceed the
        #    sum of what the ledgers were charged.
        failed: List[Tuple[np.ndarray, BaseException]] = []
        step = self.max_batch or max(int(claimed.size), 1)
        for start in range(0, int(claimed.size), step):
            chunk = claimed[start:start + step]
            try:
                labels = self._label_chunk(chunk)
            except BaseException as err:  # noqa: BLE001 — fail-alone below
                failed.append((chunk, err))
                continue
            self.fn_calls += 1
            self.records_labeled += int(chunk.size)
            self._cache.insert(chunk, labels)
            for t, new in claims:
                if t.ledger is not None and new.size:
                    lo = np.searchsorted(new, chunk[0])
                    hi = np.searchsorted(new, chunk[-1], side="right")
                    if hi > lo:
                        t.ledger.charge(hi - lo)
        # 3. resolve. A ticket with any record still unlabeled owned a
        #    failed micro-batch (the cache holds every completed chunk),
        #    so it fails alone with that chunk's error; co-batched
        #    tickets whose records all landed resolve normally.
        for t, new in claims:
            labels, known = self._cache.lookup(t.indices)
            if not bool(known.all()):
                err = next(
                    (e for ch, e in failed if np.isin(t.indices, ch).any()),
                    failed[0][1] if failed else
                    RuntimeError("oracle drain lost labels"))
                t._error, t._done = err, True
                continue
            if t.ledger is not None:
                t.ledger.record(t.indices, labels)
            t._labels, t._done = labels, True

    def _label_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """Label one micro-batch through the resilience stack: circuit
        check -> pacer -> (watchdogged) `fn` -> shape/finiteness
        validation, retried per `self.retry` with deterministic
        per-chunk backoff. Raises the final error once attempts are
        exhausted, the error is fatal, or the circuit is open; callers
        (`_resolve`) translate that into fail-alone ticket poisoning.

        The breaker is consulted exactly once per chunk, *before* the
        attempt loop: a granted half-open probe slot covers every retry
        attempt of this chunk (re-asking `allow()` per attempt would
        reject the probe's own retries and wedge the breaker half-open
        with no failure ever recorded). The chunk's final outcome then
        settles the probe — `record_success` closes the circuit,
        `record_failure` on exhaustion re-opens it and restarts the
        cooldown."""
        if self.breaker is not None and not self.breaker.allow():
            # Shed, not a channel failure: counted as `batch_sheds`
            # (never `batch_failures` — during an outage every chunk of
            # every drain sheds, which would swamp the retry-exhaustion
            # signal) and never recorded on the breaker.
            self.batch_sheds += 1
            raise CircuitOpenError(
                "oracle circuit open — shedding micro-batch",
                retry_after_s=self.breaker.retry_after_s())
        policy = self.retry
        attempts = policy.max_attempts if policy is not None else 1
        salt = int(chunk[0]) if chunk.size else 0
        attempt = 1
        while True:
            try:
                if self._pacer is not None:
                    self._pacer(int(chunk.size))
                if self.call_timeout_s is not None:
                    labels = call_with_timeout(
                        self._fn, chunk, self.call_timeout_s)
                else:
                    labels = self._fn(chunk)
                labels = np.asarray(labels, np.float32).reshape(-1)
                if labels.shape[0] != chunk.shape[0]:
                    raise OracleMalformedError(
                        "oracle returned wrong number of labels "
                        f"({labels.shape[0]} for {chunk.shape[0]} records)")
                if not bool(np.isfinite(labels).all()):
                    raise OracleMalformedError(
                        "oracle returned non-finite labels")
            except BaseException as err:  # noqa: BLE001 — classified below
                if isinstance(err, OracleTimeoutError):
                    self.timeouts += 1
                retryable = (policy.retryable(err) if policy is not None
                             else is_retryable(err))
                if not retryable or attempt >= attempts:
                    self.batch_failures += 1
                    if self.breaker is not None:
                        self.breaker.record_failure()
                    raise
                self.retries += 1
                policy.sleep(policy.backoff_s(attempt, salt))
                attempt += 1
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return labels


def as_oracle_client(oracle,
                     max_batch: Optional[int] = None,
                     retry: Optional[RetryPolicy] = None,
                     call_timeout_s: Optional[float] = None,
                     breaker: Optional[CircuitBreaker] = None,
                     ) -> OracleClient:
    """Adapter: pass `OracleClient`s through, wrap plain ``indices ->
    labels`` callables in a private `BatchingOracle` — the shim that keeps
    bare callables working across `run`, `run_joint`, `run_many`,
    `queries.run_query`, and `SelectionEngine.session()`. The resilience
    kwargs (`retry`, `call_timeout_s`, `breaker`) configure the private
    channel; passing any of them alongside a ready-made `OracleClient`
    is an error — configure that client directly instead."""
    if isinstance(oracle, OracleClient):
        if retry is not None or call_timeout_s is not None \
                or breaker is not None:
            raise ValueError(
                "retry/call_timeout_s/breaker apply to the private "
                "channel wrapped around a bare callable; configure "
                "your OracleClient directly instead")
        return oracle
    if callable(oracle):
        return BatchingOracle(oracle, max_batch=max_batch, retry=retry,
                              call_timeout_s=call_timeout_s,
                              breaker=breaker)
    raise TypeError(
        f"oracle must be an OracleClient or an indices->labels callable, "
        f"got {type(oracle).__name__}")


# ---------------------------------------------------------------------------
# Back-compat facade
# ---------------------------------------------------------------------------

class BudgetedOracle:
    """Callable facade with the original single-query semantics: one
    private `BatchingOracle` channel plus one `BudgetLedger`.

    Each `__call__` is a submit + drain exchange, so behavior matches the
    historical class — hard budget enforcement, dedup accounting (repeat
    draws of the same record are answered from the cache and do NOT
    consume budget) — but the cache probe is the vectorized `_LabelCache`
    pass instead of a per-element dict loop, and `labeled_positives()` is
    sorted (dict insertion order is not deterministic once batches
    interleave across a session's queries).
    """

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray], budget: int):
        self._client = BatchingOracle(fn)
        self.ledger = BudgetLedger(budget)

    @property
    def budget(self) -> int:
        """The query's ORACLE LIMIT."""
        return self.ledger.budget

    @property
    def calls_used(self) -> int:
        """Labels charged so far (repeat draws are free, see class doc)."""
        return self.ledger.charged

    @property
    def remaining(self) -> int:
        """Budget headroom left."""
        return self.ledger.remaining

    def __call__(self, indices) -> np.ndarray:
        """Label a batch of record indices; returns float32 {0,1} labels."""
        return self._client.submit(indices, ledger=self.ledger).result()

    def labeled_positives(self) -> np.ndarray:
        """Sorted indices labeled positive so far — Algorithm 1's R1."""
        return self.ledger.labeled_positives()


def array_oracle(labels) -> Callable[[np.ndarray], np.ndarray]:
    """Oracle backed by a ground-truth label array (tests / benchmarks)."""
    arr = np.asarray(labels, np.float32)

    def fn(indices):
        return arr[np.asarray(indices, np.int64)]

    return fn
