"""The port's session scheduler (`QuerySession`, `run_many`) against the
JAX package's, on the CPU.

1. Given the reference's corpus state, `run_many` over an RT/PT/JT mix
   returns the reference's exact tau, per-shard counts, indices and
   `oracle_calls` at concurrency 1, 2 and None and workers 1, 4 and 8;
   `SessionStats`' integer counters equal the reference's (timings are
   never compared: they vary from run to run).
2. Built independently from the same shards, the two engines agree on
   `run_many` wherever their normalizers z agree (the pattern of
   `test_end_to_end_matches_reference`).
3. `run_many` is bit for bit sequential `run`/`run_joint` on the split
   keys, and a solo JT spends what the reference's solo `run_joint`
   spends (2997 labels on the seed-12 corpus and key 5).
4. The session's surface: `submit_plan`, handle lifecycle, sink
   validation before key splitting, a query over budget that fails
   alone, drains that fail loud, and the fault injector: the same
   schedule as the reference's, and a faulty run with retries bit for
   bit the fault-free one.

The reference engine sketches with its jnp scatter-add path
(``use_kernel=False``), as in `tests/test_torch_engine.py`.
"""
import os
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.oracle import array_oracle  # noqa: E402
from repro.core.queries import JointSUPGQuery as RefJoint  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data.synthetic import make_beta  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch import testing  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.oracle import BatchingOracle  # noqa: E402
from repro_torch.core.oracle import BudgetExceededError  # noqa: E402
from repro_torch.core.oracle import BudgetLedger  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.core.resilience import RetryPolicy  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

from test_torch_engine import (_partitionable_threefry,  # noqa: E402,F401
                               export_state)

# An RT/PT/JT mix over every sampling branch a session schedules: IS and
# no-CI RT, two-stage IS and uniform PT, and JT. The corpus gives each a
# finite tau (`test_mix_selects_at_finite_thresholds`).
MIX = [
    ("rt", dict(target="recall", gamma=0.9, delta=0.05, budget=1000)),
    ("pt", dict(target="precision", gamma=0.6, delta=0.05, budget=1000)),
    ("jt", dict(gamma_recall=0.85, stage_budget=1000)),
    ("rt-noci", dict(target="recall", gamma=0.85, budget=800,
                     method="noci")),
    ("pt-uniform", dict(target="precision", gamma=0.3, budget=800,
                        method="uniform")),
]
CHUNK = 4000
N_SHARDS = 3


def _mix():
    ref = [RefJoint(**s) if n == "jt" else RefQuery(**s) for n, s in MIX]
    port = [JointSUPGQuery(**s) if n == "jt" else SUPGQuery(**s)
            for n, s in MIX]
    return ref, port


def _corpus(seed=57, n=30_000):
    ds = make_beta(n, 0.1, 1.0, seed=seed)
    return ds, np.array_split(ds.scores, N_SHARDS)


def _assert_same(a, b, calls=True):
    assert a.tau == b.tau
    np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
    for i in range(a.num_shards):
        np.testing.assert_array_equal(a.indices(i), b.indices(i))
    if calls:
        assert a.oracle_calls == b.oracle_calls


def _session(engine, oracle, queries, keys, concurrency):
    """Every query through one session: (results, SessionStats)."""
    with engine.session(oracle, concurrency=concurrency) as sess:
        handles = [sess.submit(q, key=k) for q, k in zip(queries, keys)]
        results = [h.result() for h in handles]
    return results, sess.stats


INT_STATS = ("rounds", "plan_steps", "drains", "fused_walks", "walk_spans",
             "fused_spans", "retries", "timeouts", "batch_failures",
             "batch_sheds")


# -- 1. exact, given the reference's state ------------------------------------

@pytest.fixture(scope="module")
def given():
    ds, shards = _corpus()
    ref = RefEngine(shards, num_bins=1024, use_kernel=False,
                    chunk_records=CHUNK)
    state = E.state_from_reference(export_state(ref._state), shards)
    yield ds, shards, ref, state, array_oracle(ds.labels)
    ref.close()


@pytest.fixture(scope="module")
def reference_runs(given):
    """The reference's `run_many` and session stats, by concurrency."""
    _, _, ref, _, oracle = given
    ref_q, _ = _mix()
    out = {}
    for c in (1, 2, None):
        many = ref.run_many(jax.random.PRNGKey(77), oracle, ref_q,
                            concurrency=c)
        keys = jax.random.split(jax.random.PRNGKey(77), len(ref_q))
        _, stats = _session(ref, oracle, ref_q, keys, c)
        out[c] = (many, stats)
    return out


@pytest.mark.parametrize("workers", [1, 4, 8])
@pytest.mark.parametrize("concurrency", [1, 2, None])
def test_run_many_matches_reference_exactly(given, reference_runs,
                                            concurrency, workers):
    _, _, _, state, oracle = given
    want, want_stats = reference_runs[concurrency]
    _, port_q = _mix()
    with E.SelectionEngine.from_state(state, device="cpu", workers=workers,
                                      clamp_workers=False) as eng:
        got = eng.run_many(R.PRNGKey(77), oracle, port_q,
                           concurrency=concurrency)
        keys = R.split(R.PRNGKey(77), len(port_q))
        again, stats = _session(eng, oracle, port_q, keys, concurrency)
    for a, b, c in zip(want, got, again):
        _assert_same(a, b)
        _assert_same(a, c)
    for name in INT_STATS:
        assert getattr(stats, name) == getattr(want_stats, name), name


def test_mix_selects_at_finite_thresholds(given):
    """Every query of the mix certifies a finite tau on this corpus, so the
    exact comparisons above cover real selections."""
    _, _, _, state, oracle = given
    with E.SelectionEngine.from_state(state, device="cpu") as eng:
        for sel in eng.run_many(R.PRNGKey(77), oracle, _mix()[1]):
            assert np.isfinite(sel.tau) and sel.total_selected > 0


# -- 2. both engines built independently --------------------------------------

@pytest.mark.parametrize("seed", [3, 4, 5])
def test_independent_build_run_many_matches_reference(seed):
    """The port's sketch counts and sums equal the reference's; where z is
    bit-equal, `run_many` equals the reference's; where it is not, the
    port from the reference's state does (the difference traces to z)."""
    ds, shards = _corpus(seed=seed, n=20_000)
    oracle = array_oracle(ds.labels)
    ref_q, port_q = _mix()
    with RefEngine(shards, num_bins=1024, use_kernel=False,
                   chunk_records=CHUNK) as ref, \
            E.SelectionEngine(shards, num_bins=1024, chunk_records=CHUNK,
                              workers=4, clamp_workers=False,
                              device="cpu") as eng:
        for mine, theirs in zip(eng.shard_sketches + [eng.sketch],
                                ref.shard_sketches + [ref.sketch]):
            for m, t in zip(mine, theirs):
                np.testing.assert_array_equal(m.numpy(), np.asarray(t))
        want = ref.run_many(jax.random.PRNGKey(seed), oracle, ref_q)
        if eng._state.z == ref._state.z:
            got = eng.run_many(R.PRNGKey(seed), oracle, port_q)
        else:
            state = E.state_from_reference(export_state(ref._state), shards)
            with E.SelectionEngine.from_state(state, device="cpu") as given:
                got = given.run_many(R.PRNGKey(seed), oracle, port_q)
    for a, b in zip(want, got):
        _assert_same(a, b)


# -- 3. run_many == sequential runs; the solo JT's spend ----------------------

@pytest.mark.parametrize("concurrency", [1, None])
def test_run_many_equals_sequential_runs(given, concurrency):
    _, _, _, state, oracle = given
    _, port_q = _mix()
    keys = R.split(R.PRNGKey(33), len(port_q))
    with E.SelectionEngine.from_state(state, device="cpu", workers=8,
                                      clamp_workers=False) as eng:
        many = eng.run_many(R.PRNGKey(33), oracle, port_q,
                            concurrency=concurrency)
        for k, q, b in zip(keys, port_q, many):
            run = (eng.run_joint if isinstance(q, JointSUPGQuery)
                   else eng.run)
            _assert_same(run(k, oracle, q), b, calls=False)


def test_solo_joint_spends_what_the_reference_spends():
    """The reference's `test_run_many_batches_rt_pt_jt` corpus and key: a
    batch through `run_many`, each query equal to its sequential run, and
    the solo JT charging exactly the reference's 2997 labels (that test's
    own bar, > 3000, is one the reference itself misses)."""
    ds = make_beta(100_000, 0.01, 1.0, seed=12)
    shards = np.array_split(ds.scores, 4)
    oracle = array_oracle(ds.labels)
    specs = [dict(target="recall", gamma=0.9, delta=0.05, budget=3000),
             dict(target="precision", gamma=0.9, delta=0.05, budget=3000)]
    jt = dict(gamma_recall=0.8, stage_budget=3000)
    port_q = [SUPGQuery(**s) for s in specs] + [JointSUPGQuery(**jt)]
    with RefEngine(shards, num_bins=1024, use_kernel=False) as ref:
        want = ref.run_joint(jax.random.PRNGKey(5), oracle, RefJoint(**jt))
        state = E.state_from_reference(export_state(ref._state), shards)
    with E.SelectionEngine.from_state(state, device="cpu") as eng:
        solo = eng.run_joint(R.PRNGKey(5), oracle, port_q[2])
        many = eng.run_many(R.PRNGKey(5), oracle, port_q)
        keys = R.split(R.PRNGKey(5), len(port_q))
        for k, q, b in zip(keys, port_q, many):
            run = (eng.run_joint if isinstance(q, JointSUPGQuery)
                   else eng.run)
            _assert_same(run(k, oracle, q), b, calls=False)
    _assert_same(want, solo)
    assert solo.oracle_calls == want.oracle_calls == 2997
    for r in many[:2]:
        assert r.oracle_calls <= 3000


def test_session_under_thread_stress_equals_sequential_runs(given):
    """More pool threads than cores, switching every few microseconds:
    a session's steps and fused walks share the engine across threads,
    and its results still equal the sequential runs (a lost or crossed
    slot update would change a tau, a count or an index)."""
    _, _, _, state, oracle = given
    batch = _mix()[1] * 2
    keys = R.split(R.PRNGKey(91), len(batch))
    with E.SelectionEngine.from_state(state, device="cpu") as one:
        want = [(one.run_joint if isinstance(q, JointSUPGQuery)
                 else one.run)(k, oracle, q) for k, q in zip(keys, batch)]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with E.SelectionEngine.from_state(
                state, device="cpu", workers=4 * (os.cpu_count() or 1),
                clamp_workers=False) as many:
            got = many.run_many(R.PRNGKey(91), oracle, batch)
    finally:
        sys.setswitchinterval(before)
    for a, b in zip(want, got):
        _assert_same(a, b, calls=False)


# -- 4. the session's surface -------------------------------------------------

@pytest.fixture(scope="module")
def small():
    ds = make_beta(12_000, 0.1, 1.0, seed=54)
    return ds, np.array_split(ds.scores, 2)


def _engine(shards, **kw):
    return E.SelectionEngine(shards, num_bins=256, chunk_records=2500,
                             device="cpu", **kw)


RT = SUPGQuery(target="recall", gamma=0.9, budget=500)


def test_submit_plan_runs_a_prebuilt_plan_like_submit(small):
    """A plan built outside the session and entered through `submit_plan`
    answers like the same query through `submit`, and its handle carries
    the annotations it was given."""
    ds, shards = small
    oracle = array_oracle(ds.labels)
    sink = pipeline.IndexSink()
    with _engine(shards) as eng:
        with eng.session(oracle) as sess:
            plan = eng._plan_for(R.PRNGKey(3), RT, sink=sink)
            h_plan = sess.submit_plan(plan, query=RT, sink=sink)
            h_q = sess.submit(RT, key=R.PRNGKey(3))
            assert sess.in_flight == 2
            assert h_plan.query is RT and h_plan.sink is sink
            # One channel: the second of the two finds its labels cached,
            # so only their charges differ.
            _assert_same(h_q.result(), h_plan.result(), calls=False)
            assert h_plan.result().sink is sink
        with pytest.raises(RuntimeError, match="closed"):
            sess.submit_plan(eng._plan_for(None, RT))


def test_session_handles_lifecycle(small):
    ds, shards = small
    oracle = array_oracle(ds.labels)
    with _engine(shards) as eng:
        with eng.session(oracle, concurrency=2) as sess:
            hs = [sess.submit(RT, key=R.PRNGKey(i)) for i in range(4)]
            assert not any(h.done for h in hs)
            first = hs[0].result()               # pumps until hs[0] is done
            assert hs[0].done and first.total_selected > 0
        assert all(h.done for h in hs)           # exit pumps the rest
        assert all(h.result().total_selected > 0 for h in hs)
        assert sess.in_flight == 0
        with pytest.raises(RuntimeError, match="closed"):
            sess.submit(RT)
        sess2 = eng.session(oracle)              # abandoned: rejected
        h2 = sess2.submit(RT)
        assert sess2.step()                      # one turn, work remains
        sess2.close(abandon=True)
        with pytest.raises(RuntimeError, match="abandoned"):
            h2.result()


def test_run_many_validates_sinks_before_keys(small):
    ds, shards = small
    oracle = array_oracle(ds.labels)
    with _engine(shards) as eng:
        with pytest.raises(ValueError, match="one sink"):
            eng.run_many(None, oracle, [RT, RT], sinks=[None])
        shared = pipeline.IndexSink()
        with pytest.raises(ValueError, match="shared"):
            eng.run_many(None, oracle, [RT, RT], sinks=[shared, shared])
        assert eng.run_many(None, oracle, [], sinks=[]) == []
        sinks = [pipeline.IndexSink(), None]
        got = eng.run_many(R.PRNGKey(1), oracle, [RT, RT], sinks=sinks)
        assert got[0].sink is sinks[0]
        assert isinstance(got[1].sink, pipeline.IndexSink)


def test_query_over_its_quota_fails_alone(small):
    """A query whose labels would pass its parent ledger raises
    `BudgetExceededError`; its co-batched neighbour completes and equals
    its solo run."""
    ds, shards = small
    oracle = array_oracle(ds.labels)
    with _engine(shards) as eng:
        solo = eng.run(R.PRNGKey(2), oracle, RT)
        with eng.session(oracle) as sess:
            starved = sess.submit(RT, key=R.PRNGKey(1),
                                  ledger_parent=BudgetLedger(50))
            ok = sess.submit(RT, key=R.PRNGKey(2))
            with pytest.raises(BudgetExceededError):
                starved.result()
            _assert_same(solo, ok.result(), calls=False)


@pytest.mark.parametrize("max_batch", [None, 64])
def test_session_drain_failure_fails_loud(small, max_batch):
    """A drain that dies (asynchronously, or at submit time when
    `max_batch` forces an auto-drain) fails every affected handle loudly,
    never resuming a plan on stale labels; the session winds down and the
    engine is unharmed."""
    ds, shards = small
    boom = [True]
    labels = np.asarray(ds.labels, np.float32)

    def flaky(idx):
        if boom[0]:
            raise IOError("labeling backend down")
        return labels[np.asarray(idx, np.int64)]

    with _engine(shards) as eng:
        sess = eng.session(flaky, concurrency=4, max_batch=max_batch)
        hs = [sess.submit(RT, key=R.PRNGKey(i)) for i in range(3)]
        with pytest.raises(IOError, match="backend down"):
            hs[0].result()
        boom[0] = False
        for h in hs:
            with pytest.raises(IOError):
                h.result()
        sess.close()
        with eng.session(flaky) as fresh:
            assert fresh.submit(RT, key=R.PRNGKey(0)).result() \
                .total_selected > 0


def test_fault_schedule_matches_reference():
    for seed, n, rate, kinds in [(17, 400, 0.3, ("transient",)),
                                 (3, 1000, 0.1, testing.faults.KINDS),
                                 (0, 50, 0.9, ("torn", "dup", "nan"))]:
        assert testing.fault_schedule(seed, n, rate, kinds) == \
            ref_faults.fault_schedule(seed, n, rate, kinds)
    with pytest.raises(ValueError, match="unknown fault kind"):
        testing.fault_schedule(0, 10, 0.5, ("gremlin",))


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_faulty_run_many_bit_for_bit_fault_free(given, workers):
    """Under a seeded transient-only schedule with retries, `run_many`
    returns the fault-free results at any worker count: retries re-ask
    for the same records, and a pure oracle answers the same labels."""
    ds, _, _, state, oracle = given
    _, port_q = _mix()
    schedule = testing.fault_schedule(seed=17, n_calls=400, rate=0.3)
    inj = testing.FaultInjector(oracle, schedule)
    retry = RetryPolicy(max_attempts=8, base_delay_s=0.0,
                        sleep=lambda s: None)
    with E.SelectionEngine.from_state(state, device="cpu", workers=workers,
                                      clamp_workers=False) as eng:
        want = eng.run_many(R.PRNGKey(7), oracle, port_q)
        client = BatchingOracle(inj, retry=retry)
        got = eng.run_many(R.PRNGKey(7), client, port_q)
        with eng.session(testing.FaultInjector(oracle, schedule),
                         retry=retry) as sess:
            again = [sess.submit(q, key=k).result() for q, k in
                     zip(port_q, R.split(R.PRNGKey(7), len(port_q)))]
    assert inj.injected["transient"] > 0 and client.retries > 0
    assert sess.stats.retries > 0 and sess.stats.batch_failures == 0
    for a, b, c in zip(want, got, again):
        _assert_same(a, b, calls=False)
        _assert_same(a, c, calls=False)
