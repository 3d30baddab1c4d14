"""`SelectionServer` — the long-lived serving plane around `QuerySession`,
ported.

The engine is a library; this module makes it a daemon. One server hosts:

  * one long-lived `SelectionEngine` (sketch + sampling state built once,
    amortized over every query the process ever serves),
  * one shared `BatchingOracle` channel — optionally paced by a
    `TokenBucket` (the paper's §4.1 rate-limited oracle, made literal) —
    so concurrent clients' oracle requests coalesce into micro-batches
    and share one label cache,
  * a pool of `QuerySession`s driven by a single scheduler thread
    (`step()` turns), so client threads never touch engine state,
  * admission control: at most `max_inflight` queries execute; the rest
    wait in a bounded FIFO overflow queue (`queue_depth`), rejected
    synchronously with `AdmissionError` when it is full and expired with
    `QueueTimeoutError` when they out-wait `queue_timeout_s`,
  * per-tenant metering: every query's budget ledger chains under its
    tenant's quota ledger, so a tenant exhausting its quota mid-drain
    fails *its own* ticket alone (`BudgetExceededError`, labelled with
    the tenant) while co-batched queries of other tenants proceed —
    exactly the per-query poisoning semantics of the session scheduler.

Results are bit-for-bit identical to `engine.run_many` over the same
(queries, keys) for any pure oracle: plans are pure given (key, labels),
and neither admission order, pacing, queue waits, nor tenant metering
changes which labels a query sees — only *when* the oracle is invoked
and who pays for it.

**The card.** The hosted engine's device picks every kernel: a served
query's emission and PT stage 2 launch `threshold_select`, an append
launches `score_hist` once per appended chunk, and a restore replays the
journal through the same appends, then catches standing queries up
through `threshold_select`. Those launches come from the engine's pool
threads and from the server's scheduler thread. `restore` builds its
engine on ``cuda`` unless `engine_kw` names another device. Keys are
jax-format ``uint32[2]`` (`repro_torch.random`, `fold_in` included), so
a restored server audits with the keys an uncrashed one would, and one
key drives this server and the JAX package's alike.

Client API::

    with SelectionServer(engine, oracle_fn, max_inflight=8,
                         rate=10_000, burst=2_000,
                         quotas={"alice": 5_000}) as server:
        h = server.submit(query, tenant="alice", key=key)
        sel = h.result()          # blocks this client only
        print(server.stats().format())
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch

from repro_torch import random
from repro_torch.core.engine import (QueryHandle, QuerySession,
                                     SelectionEngine, ShardedSelection)
from repro_torch.core.oracle import (BatchingOracle, BudgetLedger,
                                     OracleClient)
from repro_torch.core.resilience import (CircuitBreaker, CircuitOpenError,
                                         RetryPolicy)
from repro_torch.data import pipeline
from repro_torch.durable import (DurabilityPlane, decode_key, decode_query,
                                 encode_key, encode_query)
from repro_torch.live import (DriftSentinel, DriftWatch, IngestPlane,
                              StandingQuery, StandingRegistry)
from repro_torch.serve.limiter import TokenBucket
from repro_torch.serve.stats import (LatencyHistogram, ServerStats,
                                     TenantStats)

_UNMETERED = 1 << 62      # tenant ledger budget when no quota configured


def _device_fault(err: BaseException) -> bool:
    """A CUDA error, raised by torch or by a kernel's launch check."""
    accel = getattr(torch, "AcceleratorError", ())
    return isinstance(err, accel) or (isinstance(err, RuntimeError)
                                      and "CUDA error" in str(err))


class ServerClosedError(RuntimeError):
    """The server is closing or closed; the query was not accepted."""


class AdmissionError(RuntimeError):
    """Admission control refused the query (overflow queue full)."""


class QueueTimeoutError(AdmissionError):
    """The query expired in the overflow queue before being admitted."""


class ServerHandle:
    """Client-facing future for one submitted query.

    `result()` blocks the calling client thread only — all scheduling
    happens on the server's own thread — and returns the query's
    `ShardedSelection` or raises its typed error (`QueueTimeoutError`,
    `BudgetExceededError` for a budget/quota overrun, `ServerClosedError`
    if the server shut down first).
    """

    def __init__(self, query, tenant: str, key, sink, chunk_records):
        self.query = query
        self.tenant = tenant
        self._key = key
        self._sink = sink
        self._chunk_records = chunk_records
        self._t_submit = time.monotonic()
        self._deadline: Optional[float] = None    # overflow-queue expiry
        self._event = threading.Event()
        self._result: Optional[ShardedSelection] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        """True once the query finished (result or error)."""
        return self._event.is_set()

    def _finish(self, result=None, error=None) -> float:
        self._result, self._error = result, error
        latency = time.monotonic() - self._t_submit
        self._event.set()
        return latency

    def result(self, timeout: Optional[float] = None) -> ShardedSelection:
        """Block until the query finishes; return its selection.

        Raises the query's error if it failed, or `TimeoutError` if
        `timeout` seconds elapse first (the query keeps running — call
        `result()` again to keep waiting).
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query for tenant {self.tenant!r} still running "
                f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class _Tenant:
    """Server-internal per-tenant state: quota ledger + counters."""

    def __init__(self, name: str, quota: Optional[int]):
        self.stats = TenantStats(tenant=name, quota=quota)
        # Unmetered tenants still get a ledger so oracle usage is
        # attributed per tenant in ServerStats; the budget is just never
        # reachable.
        self.ledger = BudgetLedger(
            _UNMETERED if quota is None else int(quota),
            label=f"tenant {name!r} quota")


class SelectionServer:
    """Rate-limited, quota-metered daemon serving SUPG queries.

    Parameters
    ----------
    engine: the hosted `SelectionEngine` (closed with the server when
        `own_engine`, the default — pass ``own_engine=False`` when the
        caller manages the engine's lifetime, e.g. inside an existing
        ``with engine:`` block).
    oracle_fn: plain ``indices -> labels`` callable wrapped in the
        server's shared `BatchingOracle`, or an existing `OracleClient`
        (then `rate`/`burst`/`max_batch` must be None — the channel's
        owner configured it).
    max_inflight: queries executing concurrently across the session pool.
    queue_depth: overflow-queue capacity; a full queue rejects at
        `submit` with `AdmissionError`.
    queue_timeout_s: max time a query may wait for admission before its
        handle fails with `QueueTimeoutError` (None = wait forever).
    rate, burst: `TokenBucket` pacing of the oracle channel, in records
        per second and records of burst capacity (None = unpaced).
    max_batch: records per underlying oracle call (see `BatchingOracle`).
    retry, call_timeout_s, breaker: the channel's fault-tolerance stack
        (`RetryPolicy`, per-call watchdog seconds, `CircuitBreaker` —
        see `core.resilience`). While the circuit is open, `submit`
        sheds new admissions with `CircuitOpenError` (carrying a
        retry-after hint) instead of queueing work that will die; the
        half-open probe is left to the drain path, so shedding never
        delays recovery.
    quotas: tenant name -> total oracle-label quota (a `BudgetLedger`
        each query of that tenant chains under). Unknown tenants get
        `default_quota` (None = unmetered).
    sessions: size of the `QuerySession` pool. All sessions share the
        one channel/cache; more sessions only add scheduling isolation.
    sentinel_probe_budget, sentinel_sigma: the drift sentinel's probe
        size (oracle labels per calibration probe) and trigger threshold
        (see `repro_torch.live.DriftSentinel`) — used for subscriptions made
        with ``audit=True``.

    Live corpus surface: `append(shards)` grows the hosted corpus one
    epoch at a time (delta-update, never a rebuild — in-flight queries
    keep their pinned epoch), and `subscribe(query, ...)` registers a
    standing query that certifies once and re-emits over every appended
    shard; with ``audit=True`` the drift sentinel probes each new epoch
    and auto re-validates tau through the shared channel when the §6.2
    drift statistic trips.

    Durability surface: pass ``durable=<path>`` to journal every append
    (write-ahead, fsync'd) under that root; `snapshot()` persists the
    certifications, sentinel references, and tenant ledger balances that
    replay cannot recompute, and `SelectionServer.restore(<path>, ...)`
    brings a killed server back bit-for-bit without re-spending any
    oracle budget — see "Durability & recovery" in the JAX package's
    docs/guarantees.md, which holds for the port unchanged.
    """

    def __init__(self, engine: SelectionEngine, oracle_fn, *,
                 max_inflight: int = 8, queue_depth: int = 64,
                 queue_timeout_s: Optional[float] = None,
                 rate: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 call_timeout_s: Optional[float] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 quotas: Optional[Dict[str, int]] = None,
                 default_quota: Optional[int] = None,
                 sessions: int = 1,
                 own_engine: bool = True,
                 sentinel_probe_budget: int = 2048,
                 sentinel_sigma: float = 4.0,
                 durable: Optional[Union[str, DurabilityPlane]] = None):
        self.engine = engine
        self._own_engine = bool(own_engine)
        # Durability plane (optional): journal-first appends + snapshots.
        # A path means a *new* journal for this server's lifetime — a
        # journal that already has records belongs to a crashed server
        # and must come back through `SelectionServer.restore` so its
        # epochs and certifications are actually re-applied.
        if isinstance(durable, (str, bytes)) or hasattr(durable,
                                                        "__fspath__"):
            durable = DurabilityPlane(durable)
            if durable.journal_records:
                raise ValueError(
                    f"durable root {durable.root!r} already holds "
                    f"{durable.journal_records} journal record(s) — "
                    f"recover it with SelectionServer.restore(...) "
                    f"instead of attaching a fresh server")
        self.durable: Optional[DurabilityPlane] = durable
        self._append_lock = threading.Lock()
        self.recovered_epochs = 0
        self.recovered_queries = 0
        self.snapshots = 0
        self.bucket: Optional[TokenBucket] = None
        if isinstance(oracle_fn, OracleClient):
            if rate is not None or burst is not None or max_batch is not None \
                    or retry is not None or call_timeout_s is not None \
                    or breaker is not None:
                raise ValueError(
                    "rate/burst/max_batch/retry/call_timeout_s/breaker "
                    "configure the server's own channel; an "
                    "externally-owned OracleClient carries its own "
                    "configuration")
            self.channel = oracle_fn
            self._own_channel = False
            # Admission shedding still works with an external channel
            # that carries its own breaker.
            self.breaker = getattr(oracle_fn, "breaker", None)
        else:
            if rate is not None:
                self.bucket = TokenBucket(rate,
                                          rate if burst is None else burst)
            elif burst is not None:
                raise ValueError("burst requires rate")
            self.channel = BatchingOracle(oracle_fn, max_batch=max_batch,
                                          pacer=self.bucket, retry=retry,
                                          call_timeout_s=call_timeout_s,
                                          breaker=breaker)
            self._own_channel = True
            self.breaker = breaker
        self.max_inflight = max(1, int(max_inflight))
        self.queue_depth = max(0, int(queue_depth))
        self.queue_timeout_s = queue_timeout_s
        self._quotas = dict(quotas or {})
        self._default_quota = default_quota
        self._sessions: List[QuerySession] = [
            engine.session(self.channel) for _ in range(max(1, sessions))]

        # Live corpus plane: ingestion, standing queries, drift sentinel.
        # The registry rides the first session so re-emission walks fuse
        # with ordinary query rounds; the sentinel shares the channel so
        # probe labels join the common cache and metering.
        self.plane = IngestPlane(engine)
        self._registry = StandingRegistry(self.plane, self._sessions[0])
        self._sentinel = DriftSentinel(engine, self.channel,
                                       probe_budget=sentinel_probe_budget,
                                       sigma=sentinel_sigma)
        # Handed from subscribe() (any thread) to the scheduler under
        # the condition variable; everything below it is scheduler-owned.
        self._subscriptions: List[Tuple[StandingQuery, _Tenant, bool]] = []
        self._awaiting_watch: List[Tuple[StandingQuery, object]] = []
        # [sq, DriftWatch, base_key, last_audited_epoch] per audited query
        self._watches: List[list] = []

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: Deque[ServerHandle] = collections.deque()
        self._tenants: Dict[str, _Tenant] = {}
        self._latency = LatencyHistogram()
        self._completed = 0
        self._failed = 0
        self._inflight: List[Tuple[ServerHandle, QueryHandle,
                                   QuerySession]] = []   # scheduler-owned
        self._inflight_n = 0      # mirrored under the lock for stats()
        self._closing = False
        self._abandon = False
        self._closed = False
        self._fatal: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-serve", daemon=True)
        self._thread.start()

    # -- client surface ---------------------------------------------------

    def submit(self, query, *, tenant: str = "default", key=None,
               sink: Optional[pipeline.SelectionSink] = None,
               chunk_records: Optional[int] = None) -> ServerHandle:
        """Submit one RT/PT/JT query on behalf of `tenant`.

        Returns a `ServerHandle` immediately. Raises `AdmissionError`
        synchronously when the overflow queue is full (the client should
        back off and retry), `CircuitOpenError` while the oracle circuit
        is open (graceful degradation — the error carries a retry-after
        hint), and `ServerClosedError` after `close()`. Thread-safe —
        this is the concurrent-client entry point.
        """
        with self._cond:
            if self._closing or self._closed:
                raise ServerClosedError("SelectionServer is closed")
            if self._fatal is not None:
                raise ServerClosedError(
                    f"SelectionServer scheduler died: {self._fatal!r}")
            ten = self._tenant_locked(tenant)
            if self.breaker is not None:
                # Non-mutating probe: retry_after_s() never consumes the
                # half-open slot, so admission shedding cannot starve
                # the drain path's recovery probe.
                retry_after = self.breaker.retry_after_s()
                if retry_after > 0.0:
                    ten.stats.submitted += 1
                    ten.stats.shed += 1
                    raise CircuitOpenError(
                        f"oracle circuit open — retry in "
                        f"{retry_after:.1f}s", retry_after_s=retry_after)
            room = self.max_inflight - self._inflight_n
            if len(self._queue) >= self.queue_depth + max(0, room):
                # Even an empty execution plane admits through the queue,
                # so the bound is queue_depth beyond the free slots.
                ten.stats.submitted += 1
                ten.stats.rejected += 1
                raise AdmissionError(
                    f"admission queue full ({len(self._queue)} waiting, "
                    f"{self._inflight_n}/{self.max_inflight} in flight) — "
                    f"back off and resubmit")
            handle = ServerHandle(query, tenant, key, sink, chunk_records)
            if self.queue_timeout_s is not None:
                handle._deadline = handle._t_submit + self.queue_timeout_s
            ten.stats.submitted += 1
            self._queue.append(handle)
            self._cond.notify_all()
            return handle

    def append(self, shards) -> int:
        """Append score shard(s) (arrays, tensors or `ScoreStore`s) to
        the hosted corpus; returns the new epoch number.

        Delta-updates the engine in place (only the appended records are
        sketched); queries already in flight keep the epoch they pinned
        at submit. Standing queries catch up on the scheduler's next
        turn, and audited subscriptions get a sentinel pass over the new
        epoch before their re-emission runs. Thread-safe.

        With a durability plane the append is journal-first: shard bytes
        spool to disk and the epoch record fsyncs *before* the in-memory
        install, so a crash at any instant loses at most an append the
        caller never saw acknowledged — and if the journal got the record
        first, restore replays it, matching the timeline the caller was
        about to see. A client whose `append` call died mid-crash should
        re-issue it after restore iff the restored epoch shows the append
        missing (the epoch number is the idempotency key). A CUDA tensor
        is copied to the host once for the spool and installed as given
        (`DurabilityPlane.record_append`).
        """
        with self._cond:
            if self._closing or self._closed:
                raise ServerClosedError("SelectionServer is closed")
            if self._fatal is not None:
                raise ServerClosedError(
                    f"SelectionServer scheduler died: {self._fatal!r}")
        # Outside the lock: sketching the new shards may fan out over the
        # engine's worker pool, and clients must not block on it. The
        # append lock keeps journal order identical to install order.
        with self._append_lock:
            if self.durable is not None:
                shards = self.durable.record_append(
                    shards, epoch=self.plane.epoch + 1)
            epoch = self.plane.append(shards)
        with self._cond:
            self._cond.notify_all()
        return epoch

    def subscribe(self, query, *, tenant: str = "default", key=None,
                  sink: Optional[pipeline.SelectionSink] = None,
                  audit: bool = False) -> StandingQuery:
        """Register a standing query; returns its `StandingQuery`.

        The query certifies once on the current epoch (await it with
        ``sq.wait_certified()``), then every `append` triggers a catch-up
        re-emission of ``{A >= tau}`` over exactly the appended shards
        into `sink`. With ``audit=True`` the drift sentinel probes each
        new epoch first and auto re-validates tau (fresh budget, same
        query) when the drift statistic trips — see
        `repro_torch.live.DriftSentinel`. Oracle labels (certification, probes,
        re-validations) are metered against `tenant`'s quota.
        """
        with self._cond:
            if self._closing or self._closed:
                raise ServerClosedError("SelectionServer is closed")
            if self._fatal is not None:
                raise ServerClosedError(
                    f"SelectionServer scheduler died: {self._fatal!r}")
            ten = self._tenant_locked(tenant)
            sq = StandingQuery(query, key, sink)
            sq.tenant_name = tenant        # snapshot()'s attribution
            sq.audited = bool(audit)
            self._subscriptions.append((sq, ten, bool(audit)))
            self._cond.notify_all()
            return sq

    def stats(self) -> ServerStats:
        """One consistent `ServerStats` snapshot (cheap; lock-guarded)."""
        with self._lock:
            tenants = {name: TenantStats(**vars(t.stats))
                       for name, t in self._tenants.items()}
            for name, t in self._tenants.items():
                tenants[name].oracle_charged = t.ledger.charged
            snap = ServerStats(
                tenants=tenants,
                queued=len(self._queue),
                in_flight=self._inflight_n,
                completed=self._completed,
                failed=self._failed,
                p50_s=self._latency.quantile(0.5),
                p99_s=self._latency.quantile(0.99),
                mean_s=self._latency.mean_s,
            )
        snap.oracle_calls = getattr(self.channel, "fn_calls", 0)
        snap.records_labeled = getattr(self.channel, "records_labeled", 0)
        snap.cache_hits = getattr(self.channel, "cache_hits", 0)
        snap.retries = getattr(self.channel, "retries", 0)
        snap.timeouts = getattr(self.channel, "timeouts", 0)
        snap.batch_failures = getattr(self.channel, "batch_failures", 0)
        snap.batch_sheds = getattr(self.channel, "batch_sheds", 0)
        if self.breaker is not None:
            snap.circuit_state = self.breaker.state
            snap.circuit_opens = self.breaker.opens
        if self.bucket is not None:
            snap.throttle_wait_s = self.bucket.wait_s
        for sess in self._sessions:
            snap.rounds += sess.stats.rounds
            snap.drains += sess.stats.drains
            snap.overlap_hidden_s += sess.stats.overlap_hidden_s
        snap.epochs = self.plane.appends
        snap.records_ingested = self.plane.records_ingested
        snap.standing_queries = len(self._registry.standing)
        snap.standing_emissions = self._registry.emissions
        snap.sentinel_checks = self._sentinel.checks
        snap.sentinel_triggers = self._sentinel.triggers
        snap.revalidations = self._sentinel.revalidations
        snap.epochs_live = self.engine.epochs_live
        snap.epochs_freed = self.engine.epochs_freed
        snap.recovered_epochs = self.recovered_epochs
        snap.recovered_queries = self.recovered_queries
        snap.snapshots = self.snapshots
        if self.durable is not None:
            snap.durable = True
            snap.journal_records = self.durable.journal_records
            snap.journal_bytes = self.durable.journal_bytes
        return snap

    # -- durability surface ----------------------------------------------

    @staticmethod
    def _encode_sink(sink) -> Optional[dict]:
        """Serialize a standing query's sink for the snapshot. Disk-backed
        sinks restore with their committed contents; in-memory sinks
        restore empty (their pre-crash state died with the process)."""
        if sink is None:
            return None
        if isinstance(sink, pipeline.BitmaskStore):
            return {"kind": "bitmask", "path": sink.path}
        if isinstance(sink, pipeline.IndexSink):
            return {"kind": "index"}
        return None

    @staticmethod
    def _decode_sink(obj: Optional[dict]):
        if obj is None:
            return None
        if obj["kind"] == "bitmask":
            return pipeline.BitmaskStore(obj["path"])
        return pipeline.IndexSink()

    def snapshot(self) -> dict:
        """Persist the serving-plane state no replay can recompute.

        Captures every *certified* standing query (tau, epoch, counters,
        sink identity), every sentinel watch (reference probe, last
        audited epoch), and every tenant ledger balance; writes it
        through the durability plane's atomic snapshot publish, then
        garbage-collects superseded corpus epochs (`engine.gc_epochs` —
        snapshotting is the natural checkpoint boundary). Returns the
        snapshot dict. Call at quiescent points (no certification in
        flight); `serve()`'s users typically snapshot after
        `wait_certified` or between appends.
        """
        standing = self._registry.standing
        entries = []
        kept = []
        for sq in standing:
            if not sq.certified or sq.tau is None:
                continue      # uncertified: nothing durable to keep yet
            kept.append(sq)
            entries.append({
                "tenant": getattr(sq, "tenant_name", "default"),
                "query": encode_query(sq.query),
                "key": encode_key(sq.key),
                "tau": float(sq.tau),
                "epoch": int(sq.epoch),
                "emissions": int(sq.emissions),
                "records_reemitted": int(sq.records_reemitted),
                "sink": self._encode_sink(sq.sink),
                "audit": bool(getattr(sq, "audited", False)),
            })
        watches = []
        for sq, watch, _base, last in list(self._watches):
            if sq not in kept:
                continue
            watches.append({
                "standing_index": kept.index(sq),
                "watch": {"scheme": watch.scheme,
                          "kappa": float(watch.kappa),
                          "tau": float(watch.tau),
                          "epoch": int(watch.epoch),
                          "ref_rate": float(watch.ref_rate),
                          "ref_var": float(watch.ref_var),
                          "probe_s": int(watch.probe_s)},
                "last_audited": int(last),
            })
        with self._lock:
            tenants = {name: {"charged": int(t.ledger.charged),
                              "quota": t.stats.quota}
                       for name, t in self._tenants.items()}
        state = {"epoch": int(self.plane.epoch), "standing": entries,
                 "watches": watches, "tenants": tenants}
        if self.durable is not None:
            self.durable.write_snapshot(state)
            self.snapshots += 1
        self.engine.gc_epochs()
        return state

    @classmethod
    def restore(cls, durable_root, oracle_fn, *, base_shards,
                engine_kw: Optional[dict] = None,
                **server_kw) -> "SelectionServer":
        """Resurrect a crashed server from its durability root.

        `base_shards` are the shards the dead server's engine was
        *constructed* with (the pre-journal corpus — score files
        themselves are the data plane's to persist; `ScoreStore`s
        qualify). The sequence: rebuild the engine over the base corpus,
        replay every journaled epoch (deterministic delta-sketching — the
        corpus comes back bit-for-bit), re-charge tenant ledgers to their
        snapshot balances, and re-adopt certified standing queries and
        sentinel watches *without running anything* — no oracle budget is
        re-spent, which is exactly why the recovered taus keep their
        certifications. Standing queries behind the replayed corpus catch
        up through ordinary re-emission (tau-threshold walks, zero
        labels) on the scheduler's first turn.

        `engine_kw` are the rebuilt `SelectionEngine`'s keyword arguments;
        without a ``device`` the engine runs on ``cuda`` (and raises where
        there is none), so the replay sketches on the card.
        """
        dur = DurabilityPlane(durable_root)
        snap = dur.read_snapshot() or {"epoch": 0, "standing": [],
                                       "watches": [], "tenants": {}}
        engine = SelectionEngine(base_shards, **(engine_kw or {}))
        server = cls(engine, oracle_fn, durable=dur, **server_kw)
        try:
            server._restore_from(snap)
        except BaseException:
            server.close(abandon=True)
            raise
        return server

    def _restore_from(self, snap: dict) -> None:
        """Apply a snapshot + journal suffix to this freshly-built server
        (scheduler idle: nothing is registered yet)."""
        self.recovered_epochs = self.durable.replay_into(self.plane)
        with self._lock:
            for name, info in snap.get("tenants", {}).items():
                if name not in self._quotas and info.get("quota") is not None:
                    self._quotas[name] = int(info["quota"])
                ten = self._tenant_locked(name)
                if info.get("charged"):
                    ten.ledger.charge(int(info["charged"]))
        restored: List[StandingQuery] = []
        for entry in snap.get("standing", []):
            sq = StandingQuery(decode_query(entry["query"]),
                               decode_key(entry["key"]),
                               self._decode_sink(entry["sink"]))
            sq.tau = float(entry["tau"])
            sq.epoch = int(entry["epoch"])
            sq.emissions = int(entry["emissions"])
            sq.records_reemitted = int(entry["records_reemitted"])
            sq.tenant_name = entry["tenant"]
            sq.audited = bool(entry["audit"])
            sq._certified.set()
            self._registry.adopt(sq)
            restored.append(sq)
            self.recovered_queries += 1
        for w in snap.get("watches", []):
            sq = restored[w["standing_index"]]
            base = random.fold_in(
                sq.key if sq.key is not None else random.PRNGKey(0),
                0x5E47)
            watch = DriftWatch(query=sq.query, **w["watch"])
            self._watches.append([sq, watch, base,
                                  int(w["last_audited"])])
        with self._cond:
            self._cond.notify_all()    # pump catch-up re-emissions

    # -- scheduler thread -------------------------------------------------

    def _tenant_locked(self, name: str) -> _Tenant:
        ten = self._tenants.get(name)
        if ten is None:
            quota = self._quotas.get(name, self._default_quota)
            ten = self._tenants[name] = _Tenant(name, quota)
        return ten

    def _expire_locked(self, now: float) -> List[ServerHandle]:
        """Pop queued handles whose admission deadline passed."""
        expired = []
        while self._queue and self._queue[0]._deadline is not None \
                and self._queue[0]._deadline <= now:
            h = self._queue.popleft()
            self._tenants[h.tenant].stats.timed_out += 1
            expired.append(h)
        return expired

    def _admit_locked(self) -> List[Tuple[ServerHandle, _Tenant]]:
        admitted = []
        while self._queue and self._inflight_n < self.max_inflight:
            h = self._queue.popleft()
            ten = self._tenants[h.tenant]
            ten.stats.admitted += 1
            self._inflight_n += 1
            admitted.append((h, ten))
        return admitted

    def _next_wait_locked(self) -> Optional[float]:
        """Idle wait bound: the earliest queued admission deadline."""
        if not self._queue or self._queue[0]._deadline is None:
            return None
        return max(0.0, self._queue[0]._deadline - time.monotonic())

    def _live_work(self) -> bool:
        """True while the live plane has work the scheduler must drive:
        in-flight certifications/re-emissions, certified standing queries
        behind the current epoch, watches owed a sentinel pass, or a
        certification whose watch is ready to baseline."""
        if self._registry.has_pending():
            return True
        epoch = self.plane.epoch
        if any(sq.certified and not sq._busy and sq.epoch < epoch
               for sq in self._registry.standing):
            return True
        if any(entry[3] < epoch for entry in self._watches):
            return True
        return any(sq._certified.is_set()
                   for sq, _ in self._awaiting_watch)

    def _loop(self) -> None:
        try:
            self._run_scheduler()
        except BaseException as err:  # noqa: BLE001 — daemon must not die mute
            with self._cond:
                self._fatal = err
                self._cond.notify_all()
            self._fail_all(err)

    def _run_scheduler(self) -> None:
        while True:
            with self._cond:
                for h in self._expire_locked(time.monotonic()):
                    self._finish_locked(h, error=QueueTimeoutError(
                        f"query for tenant {h.tenant!r} waited "
                        f"{self.queue_timeout_s}s for admission"),
                        count=False)
                if self._abandon:
                    return
                admitted = self._admit_locked()
                subs, self._subscriptions = self._subscriptions, []
                if not admitted and not subs and not self._inflight \
                        and not self._live_work():
                    if self._closing and not self._queue:
                        return
                    self._cond.wait(self._next_wait_locked())
                    continue
            # Session work runs outside the server lock: plans touch only
            # engine/channel state, and clients must be able to submit
            # (and read stats) while rounds are in flight.
            for sq, ten, audit in subs:
                self._registry.activate(sq, ledger_parent=ten.ledger)
                if audit:
                    base = (sq.key if sq.key is not None
                            else random.PRNGKey(0))
                    self._awaiting_watch.append(
                        (sq, random.fold_in(base, 0x5E47)))
            if self._awaiting_watch:
                # Promote certified subscriptions to sentinel watches;
                # the reference probe adopts the certified tau (no extra
                # query budget spent).
                keep = []
                for sq, base in self._awaiting_watch:
                    if not sq._certified.is_set():
                        keep.append((sq, base))
                        continue
                    if sq._error is None:
                        watch = self._sentinel.watch(sq.query, key=base,
                                                     tau=sq.tau)
                        self._watches.append([sq, watch, base, watch.epoch])
                self._awaiting_watch = keep
            # Sentinel audits run *before* the registry pumps, so a
            # drifted epoch is re-emitted with the re-validated tau.
            epoch = self.plane.epoch
            for entry in self._watches:
                sq, watch, base, last = entry
                if epoch <= last:
                    continue
                try:
                    report = self._sentinel.audit(
                        watch, key=random.fold_in(base, epoch))
                except Exception as err:  # noqa: BLE001 — audit must not
                    # kill the scheduler: a failed probe (oracle fault,
                    # quota overrun) is recorded on the standing query and
                    # the epoch is skipped, not retried hot. A fault of the
                    # card (or a simulated crash) is not absorbed: it ends
                    # the scheduler through `_loop`.
                    if _device_fault(err):
                        raise
                    sq.last_error = err
                else:
                    if report.revalidated:
                        sq.update_tau(watch.tau)
                entry[3] = epoch
            self._registry.pump()
            for h, ten in admitted:
                sess = min(self._sessions, key=lambda s: s.in_flight)
                qh = sess.submit(h.query, key=h._key, sink=h._sink,
                                 chunk_records=h._chunk_records,
                                 ledger_parent=ten.ledger)
                self._inflight.append((h, qh, sess))
            for sess in self._sessions:
                sess.step()
            self._registry.poll()
            done = [(h, qh) for h, qh, _ in self._inflight if qh.done]
            if done:
                self._inflight = [t for t in self._inflight
                                  if not t[1].done]
                with self._cond:
                    for h, qh in done:
                        self._inflight_n -= 1
                        try:
                            self._finish_locked(h, result=qh.result())
                        except BaseException as err:  # noqa: BLE001
                            self._finish_locked(h, error=err)
                    self._cond.notify_all()

    def _finish_locked(self, h: ServerHandle, result=None, error=None,
                       count: bool = True) -> None:
        latency = h._finish(result, error)
        self._latency.record(latency)
        if not count:
            return
        ten = self._tenants[h.tenant].stats
        if error is None:
            self._completed += 1
            ten.completed += 1
        else:
            self._failed += 1
            ten.failed += 1

    def _fail_all(self, err: BaseException) -> None:
        """Scheduler died: every accepted-but-unfinished handle must
        still settle loudly (clients are blocked in result())."""
        with self._cond:
            leftovers = list(self._queue) + [h for h, _, _ in self._inflight]
            self._queue.clear()
            self._inflight = []
            self._inflight_n = 0
            for h in leftovers:
                if not h.done:
                    h._finish(error=ServerClosedError(
                        f"SelectionServer scheduler died: {err!r}"))

    # -- lifecycle --------------------------------------------------------

    def close(self, abandon: bool = False) -> None:
        """Shut the server down.

        Default: stop admissions, serve everything already accepted
        (queued + in flight) to completion, then release the session
        pool, the channel's drain thread, and (when owned) the engine.
        `abandon=True` drops unfinished work instead — their handles
        fail with `ServerClosedError`. Idempotent.

        An owned engine also drops its corpus (every epoch's flat,
        views and sketches), so a closed server, a crashed one above
        all, holds no device memory; `stats()` stays readable.
        """
        with self._cond:
            if self._closed:
                return
            self._closing = True
            self._abandon = self._abandon or bool(abandon)
            self._cond.notify_all()
        self._thread.join()
        with self._cond:
            self._closed = True
            leftovers = list(self._queue) + [h for h, _, _ in self._inflight]
            self._queue.clear()
            self._inflight = []
            self._inflight_n = 0
        for sess in self._sessions:
            sess.close(abandon=True)   # anything left is being dropped
        for h in leftovers:
            if not h.done:
                h._finish(error=ServerClosedError(
                    "SelectionServer closed before this query ran"))
        if self._own_channel:
            close_channel = getattr(self.channel, "close", None)
            if close_channel is not None:
                close_channel()
        if self._own_engine:
            self.engine.close()
            self.engine._release()
        if self.durable is not None:
            self.durable.close()

    def __enter__(self) -> "SelectionServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close(abandon=exc_type is not None)
        return False
