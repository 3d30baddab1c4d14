"""Serving-plane observability: counters, latency histograms, snapshots.

Everything here is cheap enough to update on every request and snapshot
on demand: counters are plain ints behind the server's lock, and
latencies go into a fixed-size log-spaced histogram (`LatencyHistogram`)
whose quantiles are read without storing per-request samples — the
standard serving-metrics shape (a query's p99 must not cost O(queries)
memory to know).

`ServerStats` is the exported snapshot: per-tenant counters (admitted /
rejected / timed out / completed / failed, oracle records charged),
channel totals (fn calls, records labeled, cache hits, throttle wait),
scheduler overlap accounting aggregated from the session pool, and
p50/p99 end-to-end latency. `SelectionServer.stats()` builds one;
`format()` renders the table the example prints.

>>> h = LatencyHistogram()
>>> for ms in (1, 2, 3, 100):
...     h.record(ms / 1e3)
>>> h.count, h.quantile(0.5) <= h.quantile(0.99)
(4, True)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional


class LatencyHistogram:
    """Log-spaced latency histogram with O(1) record and quantile reads.

    Buckets span 1 µs .. ~1000 s at 10 buckets/decade (91 bins), which
    resolves quantiles to within ~26% — ample for p50/p99 serving
    dashboards. `record` takes seconds; quantile reads return seconds
    (the bucket's upper edge, so reported latency never understates).
    """

    DECADES = 9           # 1e-6 .. 1e3 seconds
    PER_DECADE = 10

    def __init__(self):
        self._counts = [0] * (self.DECADES * self.PER_DECADE + 1)
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= 1e-6:
            return 0
        pos = (math.log10(seconds) + 6.0) * self.PER_DECADE
        return min(len(self._counts) - 1, max(0, int(math.ceil(pos))))

    def record(self, seconds: float) -> None:
        """Add one observation (in seconds)."""
        self._counts[self._bucket(seconds)] += 1
        self.count += 1
        self.total_s += seconds
        self.max_s = max(self.max_s, seconds)

    def quantile(self, q: float) -> float:
        """Approximate `q`-quantile in seconds (upper bucket edge)."""
        if self.count == 0:
            return 0.0
        rank = min(self.count, max(1, int(math.ceil(q * self.count))))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                return 10.0 ** (i / self.PER_DECADE - 6.0)
        return self.max_s

    @property
    def mean_s(self) -> float:
        """Mean observed latency in seconds."""
        return self.total_s / self.count if self.count else 0.0


@dataclasses.dataclass
class TenantStats:
    """Per-tenant serving counters (one row of the `ServerStats` table)."""

    tenant: str
    quota: Optional[int] = None      # None = unmetered
    submitted: int = 0               # submit() calls accepted into the plane
    admitted: int = 0                # entered a session (left the queue)
    rejected: int = 0                # refused at submit (overflow queue full)
    shed: int = 0                    # refused at submit (circuit open)
    timed_out: int = 0               # expired waiting in the overflow queue
    completed: int = 0               # finished with a result
    failed: int = 0                  # finished with an error (budget/quota/..)
    oracle_charged: int = 0          # fn labels attributed to this tenant

    @property
    def in_flight(self) -> int:
        """Accepted queries not yet finished."""
        return self.submitted - self.rejected - self.shed - self.timed_out \
            - self.completed - self.failed


@dataclasses.dataclass
class ServerStats:
    """One consistent snapshot of a `SelectionServer`'s counters.

    `tenants` maps tenant name to its `TenantStats`; the scalar fields
    aggregate the channel (`oracle_calls`, `records_labeled`,
    `cache_hits`, `throttle_wait_s`), the channel's resilience layer
    (`retries`, `timeouts`, `batch_failures`, `batch_sheds`, plus the
    breaker's `circuit_state`/`circuit_opens`), the session pool's scheduler
    accounting (`rounds`, `drains`, `overlap_hidden_s`), and end-to-end
    query latency (`p50_s`/`p99_s`, measured submit -> result-ready,
    queue wait included).
    """

    tenants: Dict[str, TenantStats]
    queued: int = 0                  # waiting in the overflow queue now
    in_flight: int = 0               # admitted into sessions now
    oracle_calls: int = 0            # underlying fn invocations
    records_labeled: int = 0
    cache_hits: int = 0
    throttle_wait_s: float = 0.0     # time drains spent inside the bucket
    rounds: int = 0                  # session scheduler turns
    drains: int = 0                  # coalesced drains launched
    overlap_hidden_s: float = 0.0    # oracle latency hidden under compute
    completed: int = 0
    failed: int = 0
    p50_s: float = 0.0
    p99_s: float = 0.0
    mean_s: float = 0.0
    retries: int = 0                 # oracle calls re-attempted
    timeouts: int = 0                # oracle calls killed by the watchdog
    batch_failures: int = 0          # micro-batches that exhausted retries
                                     # (or failed fatally) — excludes sheds
    batch_sheds: int = 0             # micro-batches shed by the open circuit
    circuit_state: str = "closed"    # breaker state at snapshot time
    circuit_opens: int = 0           # closed -> open transitions so far
    epochs: int = 0                  # corpus appends installed (live plane)
    records_ingested: int = 0        # records those appends added
    standing_queries: int = 0        # registered standing queries
    standing_emissions: int = 0      # catch-up re-emission walks completed
    sentinel_checks: int = 0         # drift probes run
    sentinel_triggers: int = 0       # probes that flagged drift
    revalidations: int = 0           # re-validation queries auto-submitted
    durable: bool = False            # a durability plane is attached
    epochs_live: int = 1             # epochs still holding host memory
    epochs_freed: int = 0            # superseded epochs GC'd so far
    journal_records: int = 0         # valid epoch-journal records on disk
    journal_bytes: int = 0           # valid epoch-journal bytes on disk
    snapshots: int = 0               # snapshot() publishes this process
    recovered_epochs: int = 0        # epochs replayed at restore()
    recovered_queries: int = 0       # standing queries re-adopted at restore()

    @property
    def admitted(self) -> int:
        """Total queries admitted across tenants."""
        return sum(t.admitted for t in self.tenants.values())

    @property
    def rejected(self) -> int:
        """Total queries rejected at submit across tenants."""
        return sum(t.rejected for t in self.tenants.values())

    @property
    def circuit_shed(self) -> int:
        """Total admissions refused because the circuit was open."""
        return sum(t.shed for t in self.tenants.values())

    @property
    def timed_out(self) -> int:
        """Total queue-timeout expiries across tenants."""
        return sum(t.timed_out for t in self.tenants.values())

    def format(self) -> str:
        """Render the human-readable snapshot the example prints."""
        lines = [
            f"queries: {self.admitted} admitted, {self.completed} "
            f"completed, {self.failed} failed, {self.rejected} rejected, "
            f"{self.timed_out} timed out "
            f"({self.queued} queued, {self.in_flight} in flight)",
            f"latency: p50 {self.p50_s * 1e3:.1f} ms, "
            f"p99 {self.p99_s * 1e3:.1f} ms, "
            f"mean {self.mean_s * 1e3:.1f} ms",
            f"oracle:  {self.oracle_calls} calls, "
            f"{self.records_labeled} records labeled, "
            f"{self.cache_hits} cache hits, "
            f"throttled {self.throttle_wait_s * 1e3:.1f} ms",
            f"session: {self.rounds} rounds, {self.drains} drains, "
            f"{self.overlap_hidden_s * 1e3:.1f} ms oracle latency "
            f"hidden under compute",
            f"resilience: {self.retries} retries, {self.timeouts} "
            f"timeouts, {self.batch_failures} failed micro-batches, "
            f"{self.batch_sheds} shed micro-batches, "
            f"circuit {self.circuit_state} "
            f"({self.circuit_opens} opens, "
            f"{self.circuit_shed} admissions shed)",
            f"live:    {self.epochs} epochs, {self.records_ingested} "
            f"records ingested, {self.standing_queries} standing queries "
            f"({self.standing_emissions} re-emissions), sentinel "
            f"{self.sentinel_checks} checks / {self.sentinel_triggers} "
            f"triggers / {self.revalidations} re-validations",
            f"durable: {'on' if self.durable else 'off'}, "
            f"{self.journal_records} journal records "
            f"({self.journal_bytes} B), {self.snapshots} snapshots, "
            f"epochs {self.epochs_live} live / {self.epochs_freed} freed, "
            f"recovered {self.recovered_epochs} epochs / "
            f"{self.recovered_queries} queries",
        ]
        for name in sorted(self.tenants):
            t = self.tenants[name]
            quota = "unmetered" if t.quota is None else (
                f"{t.oracle_charged}/{t.quota} labels")
            lines.append(
                f"tenant {name!r}: {t.completed}/{t.submitted} completed "
                f"({t.failed} failed, {t.rejected} rejected, "
                f"{t.shed} shed, {t.timed_out} timed out), {quota}")
        return "\n".join(lines)
