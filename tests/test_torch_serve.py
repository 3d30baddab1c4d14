"""The port's serving plane (`repro_torch.serve`) against the JAX
package's, on the CPU.

1. `TokenBucket`: burst then rate, `try_acquire`, the typed error over
   capacity, a zero-capacity bucket, concurrent acquirers.
2. Served results equal the port's `run_many` (tau, counts, masks under
   any admission order), and, where admission is deterministic (one
   query in flight, submitted in order), the port's `run_many` at
   concurrency 1 and the reference's server too, `oracle_calls`
   included. Paced results equal unpaced ones.
3. Admission control, queue timeouts, submit after close, close with
   abandon, a tenant's quota exhausted mid-drain failing alone,
   `ledger_parent` directly, the default quota, and a stats snapshot.

The reference engine sketches with its jnp scatter-add path
(``use_kernel=False``), as in `tests/test_torch_engine.py`.
"""
import threading
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.queries import JointSUPGQuery as RefJoint  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data.synthetic import make_beta  # noqa: E402
from repro.serve import SelectionServer as RefServer  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import BudgetLedger, array_oracle  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.serve import (AdmissionError,  # noqa: E402
                               BudgetExceededError, QueueTimeoutError,
                               RateLimitError, SelectionServer,
                               ServerClosedError, TokenBucket)

from test_torch_engine import _partitionable_threefry  # noqa: E402,F401


class _FakeTime:
    """Hand-driven clock + sleep pair for deterministic bucket tests."""

    def __init__(self):
        self.now = 0.0

    def clock(self):
        return self.now

    def sleep(self, s):
        self.now += s


def _bucket(rate, burst):
    ft = _FakeTime()
    return TokenBucket(rate, burst, clock=ft.clock, sleep=ft.sleep), ft


# -- 1. TokenBucket -----------------------------------------------------------

def test_bucket_burst_then_pays_rate():
    bucket, ft = _bucket(rate=10.0, burst=5)
    assert bucket.acquire(5) == 0.0          # starts full: burst is free
    assert bucket.acquire(3) == pytest.approx(0.3)   # 3 tokens at 10/s
    assert bucket.acquired == 8
    assert bucket.wait_s == pytest.approx(0.3)
    ft.now += 100.0                          # refill caps at capacity
    assert bucket.acquire(5) == 0.0
    assert bucket.acquire(1) == pytest.approx(0.1)


def test_bucket_try_acquire_never_blocks():
    bucket, ft = _bucket(rate=10.0, burst=4)
    assert bucket.try_acquire(4)
    assert not bucket.try_acquire(1)         # empty, and try never waits
    ft.now += 0.1                            # 1 token refilled
    assert bucket.try_acquire(1)
    assert not bucket.try_acquire(5)         # over capacity: always False
    assert bucket.try_acquire(0)             # degenerate: trivially granted


def test_bucket_over_capacity_acquire_raises_typed():
    bucket, _ = _bucket(rate=100.0, burst=8)
    with pytest.raises(RateLimitError, match="exceeds bucket capacity"):
        bucket.acquire(9)
    assert not RateLimitError.retryable
    assert bucket.acquire(8) == 0.0          # bucket still usable after


def test_bucket_zero_capacity_rejects_not_deadlocks():
    bucket, ft = _bucket(rate=5.0, burst=0)
    with pytest.raises(RateLimitError):
        bucket.acquire(1)
    assert not bucket.try_acquire(1)
    assert bucket.acquire(0) == 0.0          # zero-token acquire is free
    assert ft.now == 0.0                     # no sleep ever happened
    assert bucket.acquired == 0


def test_bucket_concurrent_acquirers_account_all_tokens():
    bucket = TokenBucket(rate=1e6, burst=64)
    total = 200
    done = []

    def worker():
        for _ in range(total // 4):
            bucket.acquire(1)
        done.append(1)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(done) == 4 and bucket.acquired == total


# -- server fixtures ----------------------------------------------------------

def _dataset(n=50_000, seed=12):
    ds = make_beta(n, 0.02, 1.0, seed=seed)
    return ds, array_oracle(ds.labels)


def _shards(ds, shards):
    return np.array_split(ds.scores, shards)


def _engine(ds, shards=4):
    return SelectionEngine(_shards(ds, shards), num_bins=1024, device="cpu")


SPECS = [
    ("rt", dict(target="recall", gamma=0.9, budget=2000, method="is")),
    ("pt", dict(target="precision", gamma=0.8, budget=2000, method="is")),
    ("jt", dict(gamma_recall=0.8, stage_budget=2000)),
    ("rt-uniform", dict(target="recall", gamma=0.85, budget=1500,
                        method="uniform")),
]


def _batch(ref=False):
    q, j = (RefQuery, RefJoint) if ref else (SUPGQuery, JointSUPGQuery)
    return [j(**s) if n == "jt" else q(**s) for n, s in SPECS]


class _GatedOracle:
    """Oracle whose fn blocks until released — holds a server slot open."""

    def __init__(self, labels):
        self.inner = array_oracle(labels)
        self.gate = threading.Event()
        self.calls = 0

    def __call__(self, idx):
        self.calls += 1
        assert self.gate.wait(timeout=60), "gated oracle never released"
        return self.inner(idx)


def _assert_same(a, b, calls=True):
    assert a.tau == b.tau
    np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
    for i in range(a.num_shards):
        np.testing.assert_array_equal(a.indices(i), b.indices(i))
    if calls:
        assert a.oracle_calls == b.oracle_calls


# -- 2. served results --------------------------------------------------------

def test_server_results_bit_for_bit_vs_run_many():
    """Admission order, queue waits, tenant metering and the session pool
    change *when* the oracle runs, never *what* a query returns."""
    ds, oracle = _dataset()
    qs = _batch()
    key = R.PRNGKey(7)
    keys = list(R.split(key, len(qs)))
    with _engine(ds) as engine:
        ref = engine.run_many(key, oracle, qs)
    with SelectionServer(_engine(ds), oracle, max_inflight=2, sessions=2,
                         quotas={"a": 10**9}) as server:
        handles = [server.submit(q, tenant="a" if i % 2 else "b", key=k)
                   for i, (q, k) in enumerate(zip(qs, keys))]
        out = [h.result(timeout=120) for h in handles]
        stats = server.stats()
    for r, o in zip(ref, out):
        # oracle_calls *attribution* depends on the schedule (the earliest
        # requester of a shared record is charged for it).
        _assert_same(r, o, calls=False)
        np.testing.assert_array_equal(np.concatenate(r.masks),
                                      np.concatenate(o.masks))
    assert stats.completed == len(qs) and stats.failed == 0
    assert stats.tenants["a"].oracle_charged > 0
    assert sum(o.oracle_calls for o in out) == stats.records_labeled


def _served_in_order(server_cls, engine, oracle, qs, keys):
    """One query in flight, submitted from one thread: admission order is
    the submission order, so charge attribution is deterministic."""
    with server_cls(engine, oracle, max_inflight=1,
                    quotas={"a": 10**9}) as server:
        handles = [server.submit(q, tenant="a", key=k)
                   for q, k in zip(qs, keys)]
        out = [h.result(timeout=120) for h in handles]
        charged = server.stats().tenants["a"].oracle_charged
    return out, charged


def test_served_in_order_equals_run_many_and_reference_server():
    """In submission order, the port's server returns its `run_many`'s
    results at concurrency 1 and the reference's server's, tau, counts,
    indices and `oracle_calls` alike."""
    ds, oracle = _dataset()
    shards = _shards(ds, 4)
    key = R.PRNGKey(7)
    keys = list(R.split(key, len(SPECS)))
    with _engine(ds) as engine:
        many = engine.run_many(key, oracle, _batch(), concurrency=1)
    got, charged = _served_in_order(SelectionServer, _engine(ds), oracle,
                                    _batch(), keys)
    want, ref_charged = _served_in_order(
        RefServer, RefEngine(shards, num_bins=1024, use_kernel=False),
        oracle, _batch(ref=True),
        list(jax.random.split(jax.random.PRNGKey(7), len(SPECS))))
    for m, g, w in zip(many, got, want):
        _assert_same(m, g)
        _assert_same(w, g)
    assert charged == ref_charged == sum(g.oracle_calls for g in got)


def test_server_paced_results_match_unpaced():
    """A throttled channel slows drains down; it must not change results.
    The bucket must actually engage (wait_s > 0) for this to test pacing."""
    ds, oracle = _dataset(30_000)
    qs = _batch()[:2]
    keys = list(R.split(R.PRNGKey(3), len(qs)))
    with SelectionServer(_engine(ds), oracle) as fast:
        ref = [fast.submit(q, key=k).result(timeout=120)
               for q, k in zip(qs, keys)]
    with SelectionServer(_engine(ds), oracle, rate=40_000, burst=256,
                         max_batch=256) as paced:
        out = [paced.submit(q, key=k) for q, k in zip(qs, keys)]
        out = [h.result(timeout=120) for h in out]
        stats = paced.stats()
    assert paced.bucket is not None and paced.bucket.wait_s > 0.0
    assert stats.throttle_wait_s == paced.bucket.wait_s
    for r, o in zip(ref, out):
        _assert_same(r, o)


# -- 3. admission control, quotas, stats --------------------------------------

def test_admission_queue_full_rejects_synchronously():
    ds, _ = _dataset(20_000)
    gated = _GatedOracle(ds.labels)
    q = SUPGQuery(target="recall", gamma=0.9, budget=500, method="is")
    server = SelectionServer(_engine(ds, shards=2), gated,
                             max_inflight=1, queue_depth=1)
    try:
        first = server.submit(q, tenant="t0")
        deadline = time.monotonic() + 30
        while server.stats().in_flight < 1:       # wait for admission
            assert time.monotonic() < deadline, "first query never admitted"
            time.sleep(0.005)
        second = server.submit(q, tenant="t1")    # fills the overflow queue
        with pytest.raises(AdmissionError, match="admission queue full"):
            server.submit(q, tenant="t2")
        stats = server.stats()
        assert stats.rejected == 1 and stats.tenants["t2"].rejected == 1
        gated.gate.set()
        assert first.result(timeout=60).total_selected >= 0
        assert second.result(timeout=60).total_selected >= 0
    finally:
        gated.gate.set()
        server.close()
    assert server.stats().completed == 2


def test_queue_timeout_expires_with_typed_error():
    ds, _ = _dataset(20_000)
    gated = _GatedOracle(ds.labels)
    q = SUPGQuery(target="recall", gamma=0.9, budget=500, method="is")
    server = SelectionServer(_engine(ds, shards=2), gated,
                             max_inflight=1, queue_timeout_s=0.15)
    try:
        first = server.submit(q)
        deadline = time.monotonic() + 30
        while server.stats().in_flight < 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        starved = server.submit(q)            # queued behind the held slot
        time.sleep(0.3)                       # out-wait the deadline...
        gated.gate.set()                      # ...then free the slot
        assert first.result(timeout=60) is not None
        with pytest.raises(QueueTimeoutError, match="waited"):
            starved.result(timeout=60)
        stats = server.stats()
        assert stats.timed_out == 1 and stats.completed == 1
        assert stats.tenants["default"].in_flight == 0
    finally:
        gated.gate.set()
        server.close()


def test_submit_after_close_raises_server_closed():
    ds, oracle = _dataset(20_000)
    server = SelectionServer(_engine(ds, shards=2), oracle)
    server.close()
    with pytest.raises(ServerClosedError):
        server.submit(SUPGQuery(target="recall", gamma=0.9, budget=500))
    with pytest.raises(ServerClosedError):
        server.append(np.zeros(8, np.float32))
    server.close()                            # idempotent


def test_close_abandon_fails_pending_handles():
    ds, _ = _dataset(20_000)
    gated = _GatedOracle(ds.labels)
    q = SUPGQuery(target="recall", gamma=0.9, budget=500, method="is")
    server = SelectionServer(_engine(ds, shards=2), gated, max_inflight=1)
    held = server.submit(q)
    queued = server.submit(q)
    server.close(abandon=True)
    gated.gate.set()
    for h in (held, queued):
        with pytest.raises(ServerClosedError):
            h.result(timeout=60)
    # the owned engine gave its corpus back
    assert server.engine.shards == [] and server.engine._state.flat is None


def test_tenant_quota_exhausted_mid_drain_fails_alone():
    """A tenant blowing its quota inside a coalesced drain poisons only
    its own query; co-batched tenants complete, and the server keeps
    serving the broke tenant's later queries that fit the remainder."""
    ds, oracle = _dataset()
    qs = _batch()[:2]
    keys = list(R.split(R.PRNGKey(7), 2))
    with SelectionServer(_engine(ds), oracle, max_inflight=4,
                         quotas={"broke": 300, "rich": 10**9}) as server:
        hb = server.submit(qs[0], tenant="broke", key=keys[0])
        hr = server.submit(qs[1], tenant="rich", key=keys[1])
        with pytest.raises(BudgetExceededError, match="tenant 'broke'"):
            hb.result(timeout=120)
        assert hr.result(timeout=120).total_selected > 0
        tiny = SUPGQuery(target="recall", gamma=0.9, budget=100,
                         method="is")
        assert server.submit(tiny, tenant="broke",
                             key=keys[0]).result(timeout=120) is not None
        stats = server.stats()
    broke = stats.tenants["broke"]
    assert broke.failed == 1 and broke.completed == 1
    assert broke.oracle_charged <= 300        # quota held mid-drain
    assert stats.tenants["rich"].completed == 1


def test_session_ledger_parent_direct():
    """The hook under the server: QuerySession.submit(ledger_parent=...)
    chains the per-query ledger under a shared quota, enforced inside the
    session's coalesced drains with fail-alone semantics."""
    ds, oracle = _dataset()
    quota = BudgetLedger(300, label="tenant 'q' quota")
    qs = _batch()[:2]
    keys = list(R.split(R.PRNGKey(7), 2))
    with _engine(ds) as engine:
        with engine.session(oracle) as sess:
            metered = sess.submit(qs[0], key=keys[0], ledger_parent=quota)
            free = sess.submit(qs[1], key=keys[1])
            with pytest.raises(BudgetExceededError, match="tenant 'q'"):
                metered.result()
            assert free.result().total_selected > 0   # pumpable after
            assert quota.charged <= 300


def test_default_quota_meters_unknown_tenants():
    ds, oracle = _dataset(20_000)
    q = SUPGQuery(target="recall", gamma=0.9, budget=2000, method="is")
    with SelectionServer(_engine(ds, shards=2), oracle,
                         default_quota=100) as server:
        with pytest.raises(BudgetExceededError, match="quota"):
            server.submit(q, tenant="anon").result(timeout=120)
        assert server.stats().tenants["anon"].quota == 100


def test_server_stats_snapshot_consistency():
    ds, oracle = _dataset()
    qs = _batch()
    keys = list(R.split(R.PRNGKey(9), len(qs)))
    with SelectionServer(_engine(ds), oracle, max_inflight=2,
                         quotas={"a": 10**9}) as server:
        for q, k in zip(qs, keys):
            server.submit(q, tenant="a", key=k).result(timeout=120)
        stats = server.stats()
    assert stats.admitted == stats.completed == len(qs)
    assert stats.failed == stats.rejected == stats.timed_out == 0
    assert stats.queued == stats.in_flight == 0
    assert stats.oracle_calls > 0
    assert stats.records_labeled >= stats.tenants["a"].oracle_charged > 0
    assert 0.0 < stats.p50_s <= stats.p99_s
    assert stats.rounds > 0 and stats.drains > 0
    text = stats.format()
    assert "tenant 'a'" in text and "p99" in text and "oracle" in text
