"""The port's live plane (`repro_torch.live`, the engine's epochs) against
the JAX package's, on the CPU.

1. An engine after appends equals a cold build of the same shards bit for
   bit (sketches, z, chunk masses, chunk-mass CDFs, RT/PT/JT results and
   their charges) at workers 1, 4 and 8, and the reference's appended
   engine: sketches bit for bit, z exactly, chunk masses within rel 1e-12
   (the port sums a chunk's float64 masses in torch's order, the
   reference in numpy's: `test_chunk_sketch_stats`), sizes and query
   results exactly.
2. A pinned epoch survives an append; an unknown epoch is rejected;
   `gc_epochs`, `epochs_live` and `epochs_freed` count as the reference's
   and free the dead epoch's flat corpus.
3. A standing query's re-emission streams the reference's records, over
   the appended shards only.
4. The drift sentinel's reference rate, fresh rate, z and verdict equal
   the reference's for the same keys, on Table 3's drift pair (it
   triggers) and on a same-law control (it stays quiet).

The reference engine sketches with its jnp scatter-add path
(``use_kernel=False``), as in `tests/test_torch_engine.py`.
"""
import weakref

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.oracle import array_oracle  # noqa: E402
from repro.core.queries import JointSUPGQuery as RefJoint  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data.synthetic import make_beta  # noqa: E402
from repro.data.synthetic import make_drift_pair as ref_drift_pair  # noqa
from repro.live import DriftSentinel as RefSentinel  # noqa: E402
from repro.live import IngestPlane as RefPlane  # noqa: E402
from repro.live import StandingRegistry as RefRegistry  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import sampling  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import make_drift_pair  # noqa: E402
from repro_torch.live import (DriftSentinel, IngestPlane,  # noqa: E402
                              StandingRegistry)

from test_torch_engine import (_partitionable_threefry,  # noqa: E402,F401
                               export_state)

N_SHARDS, SHARD = 6, 10_000
SPECS = [
    ("rt", dict(target="recall", gamma=0.9, budget=1000)),
    ("pt", dict(target="precision", gamma=0.6, budget=1000)),
    ("jt", dict(gamma_recall=0.85, stage_budget=1000)),
]
KW = dict(num_bins=1024, chunk_records=1 << 12)


def _queries():
    ref = [RefJoint(**s) if n == "jt" else RefQuery(**s) for n, s in SPECS]
    port = [JointSUPGQuery(**s) if n == "jt" else SUPGQuery(**s)
            for n, s in SPECS]
    return ref, port


@pytest.fixture(scope="module")
def corpus():
    ds = make_beta(N_SHARDS * SHARD, 0.1, 1.0, seed=3)
    shards = [ds.scores[i * SHARD:(i + 1) * SHARD] for i in range(N_SHARDS)]
    return ds, shards


def _assert_same(a, b, calls=True):
    assert a.tau == b.tau
    np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
    for i in range(a.num_shards):
        np.testing.assert_array_equal(a.indices(i), b.indices(i))
    np.testing.assert_array_equal(a.sampled_positive_global,
                                  b.sampled_positive_global)
    if calls:
        assert a.oracle_calls == b.oracle_calls


def _sketch_arrays(sk):
    return [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for v in sk]


def _assert_state_bitwise(a, b):
    """Two port corpus states hold the same bits everywhere a query
    reads."""
    assert a.n_total == b.n_total
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert a.z == b.z
    for x, y in zip(a.shard_sketches + [a.sketch],
                    b.shard_sketches + [b.sketch]):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    for x, y in zip(a.chunk_masses, b.chunk_masses):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert a.sampling_cache.keys() == b.sampling_cache.keys()
    for k in a.sampling_cache:
        for x, y in zip(a.sampling_cache[k], b.sampling_cache[k]):
            assert x.mass == y.mass
            np.testing.assert_array_equal(x.cdf, y.cdf)


# -- 1. appends == a cold build ----------------------------------------------

@pytest.fixture(scope="module")
def reference_appended(corpus):
    """The reference: built over shards 0-2, then 3, then 4 and 5 appended;
    its state and `run_many` results."""
    ds, shards = corpus
    ref_q, _ = _queries()
    with RefEngine(shards[:3], use_kernel=False, **KW) as ref:
        plane = RefPlane(ref)
        plane.append(shards[3])
        plane.append([shards[4], shards[5]])
        want = ref.run_many(jax.random.PRNGKey(42), array_oracle(ds.labels),
                            ref_q)
        return ref._state, want


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_append_matches_cold_build_and_reference(corpus, reference_appended,
                                                 workers):
    ds, shards = corpus
    oracle = array_oracle(ds.labels)
    ref_state, want = reference_appended
    _, port_q = _queries()
    key = R.PRNGKey(42)
    with E.SelectionEngine(shards, workers=workers, clamp_workers=False,
                           device="cpu", **KW) as cold, \
            E.SelectionEngine(shards[:3], workers=workers,
                              clamp_workers=False, device="cpu",
                              **KW) as warm:
        cold.draw_sample(key, 8, "prop")     # a second cached scheme
        warm.draw_sample(key, 8, "prop")
        plane = IngestPlane(warm)
        assert plane.append(shards[3]) == 1
        assert plane.append([shards[4], shards[5]]) == 2
        assert (warm.epoch, warm.n_total) == (2, N_SHARDS * SHARD)
        assert plane.shards_since(0) == [3, 4, 5]
        assert plane.shards_since(1) == [4, 5]
        assert (plane.appends, plane.records_ingested) == (2, 3 * SHARD)
        _assert_state_bitwise(warm._state, cold._state)
        assert torch.equal(warm._state.flat, cold._state.flat)
        for sh in range(N_SHARDS):      # the new epoch's views of its flat
            assert warm.shards[sh].data_ptr() == \
                warm._state.flat[warm.offsets[sh]:].data_ptr()
        got = warm.run_many(key, oracle, port_q)
        for a, b in zip(cold.run_many(key, oracle, port_q), got):
            _assert_same(a, b)
        # the reference's appended engine
        assert warm._state.z == ref_state.z
        for mine, theirs in zip(warm.shard_sketches + [warm.sketch],
                                ref_state.shard_sketches + [ref_state.sketch]):
            for m, t in zip(_sketch_arrays(mine), _sketch_arrays(theirs)):
                np.testing.assert_array_equal(m, t)
        for mine, theirs in zip(warm._state.chunk_masses,
                                ref_state.chunk_masses):
            np.testing.assert_allclose(mine.sum_sqrt, theirs.sum_sqrt,
                                       rtol=1e-12)
            np.testing.assert_allclose(mine.sum_a, theirs.sum_a, rtol=1e-12)
            np.testing.assert_array_equal(mine.sizes, theirs.sizes)
        for a, b in zip(want, got):
            _assert_same(a, b)


def test_cdfs_from_the_reference_masses_match_bitwise(corpus,
                                                    reference_appended):
    """Given the reference's appended state (its chunk masses and z
    exported), the port's chunk-mass CDFs and shard masses are the
    reference's bit for bit: both fold with `append_cdf`, which continues
    the cold cumsum."""
    _, shards = corpus
    ref_state, _ = reference_appended
    state = E.state_from_reference(export_state(ref_state), shards)
    with E.SelectionEngine.from_state(state, device="cpu") as eng:
        cache = eng._state.sampling_cache[("sqrt", sampling.DEFENSIVE_KAPPA)]
        for mine, theirs in zip(cache, ref_state.sampling_cache[
                ("sqrt", sampling.DEFENSIVE_KAPPA)]):
            assert mine.mass == theirs.mass
            np.testing.assert_array_equal(mine.cdf, theirs.cdf)


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(0.0, 10.0), min_size=1, max_size=50),
       st.integers(0, 50))
def test_append_cdf_continues_cold_cumsum_bitwise(masses, split):
    m = np.asarray(masses, np.float64)
    k = min(split, m.size)
    cold = sampling.append_cdf(np.empty(0, np.float64), m)
    grown = sampling.append_cdf(
        sampling.append_cdf(np.empty(0, np.float64), m[:k]), m[k:])
    np.testing.assert_array_equal(cold, grown)


@pytest.mark.parametrize("stored", ["corpus", "appended"])
def test_append_with_memmap_shards_stays_on_the_host(corpus, tmp_path,
                                                     stored):
    """A memory-mapped corpus that takes an in-RAM shard, and an in-RAM
    corpus that takes a memory-mapped shard, both keep `flat` None (the
    routed `score_at` gathers device views and memmaps alike) and answer
    like a cold in-RAM engine over the same shards."""
    ds, shards = corpus
    oracle = array_oracle(ds.labels)

    def store(i):
        s = pipeline.ScoreStore(tmp_path / f"s{i}.f32", SHARD, create=True)
        s.write(0, shards[i])
        return s

    if stored == "corpus":
        first, appended = [store(0), store(1)], torch.from_numpy(shards[2])
    else:
        first, appended = shards[:2], store(2)
    _, port_q = _queries()
    with E.SelectionEngine(first, device="cpu", **KW) as eng, \
            E.SelectionEngine(shards[:3], device="cpu", **KW) as cold:
        IngestPlane(eng).append(appended)
        assert eng._state.flat is None
        _assert_state_bitwise(eng._state, cold._state)
        np.testing.assert_array_equal(
            eng.score_at(np.arange(0, 3 * SHARD, 7)),
            cold.score_at(np.arange(0, 3 * SHARD, 7)))
        for a, b in zip(cold.run_many(R.PRNGKey(4), oracle, port_q),
                        eng.run_many(R.PRNGKey(4), oracle, port_q)):
            _assert_same(a, b)


# -- 2. epochs ----------------------------------------------------------------

def test_inflight_plan_pins_epoch_across_append(corpus):
    """A partly stepped plan keeps its epoch: an append landing mid-query
    changes neither its result nor its shard count."""
    ds, shards = corpus
    oracle = array_oracle(ds.labels)
    q = _queries()[1][0]
    with RefEngine(shards[:3], use_kernel=False, **KW) as ref:
        want = ref.run(jax.random.PRNGKey(5), oracle, _queries()[0][0])
    with E.SelectionEngine(shards[:3], device="cpu", **KW) as eng:
        with eng.session(oracle) as sess:
            h = sess.submit(q, key=R.PRNGKey(5))
            sess.step()                      # plan started, epoch pinned
            assert IngestPlane(eng).append(shards[3]) == 1
            sel = h.result()
        assert sel.num_shards == 3
        _assert_same(want, sel)


def test_append_rejects_unknown_epoch(corpus):
    _, shards = corpus
    with E.SelectionEngine(shards[:1], device="cpu", **KW) as eng:
        with pytest.raises(ValueError, match="not recorded"):
            IngestPlane(eng).shards_since(7)
        with pytest.raises(ValueError, match="no live pins"):
            eng.unpin(eng._state)


def test_gc_epochs_frees_unpinned_superseded_epochs(corpus):
    """`gc_epochs` frees exactly the superseded epochs no plan pins, as the
    reference's does, and drops every reference the dead epoch held: its
    flat corpus is freed once nothing else holds it."""
    _, shards = corpus
    seen = []
    for engine, plane in (
            (RefEngine(shards[:2], use_kernel=False, **KW), RefPlane),
            (E.SelectionEngine(shards[:2], device="cpu", **KW), IngestPlane)):
        with engine as eng:
            p = plane(eng)
            pinned = eng.pin()                   # epoch 0, held
            p.append(shards[2])
            p.append(shards[3])                  # epochs 0, 1 superseded
            counts = [eng.epochs_live, eng.gc_epochs(), eng.epochs_live,
                      eng.epochs_freed]
            eng.unpin(pinned)
            counts += [eng.gc_epochs(), eng.epochs_live, eng.epochs_freed,
                       eng.gc_epochs()]
            seen.append(counts)
            assert pinned.shards == [] and pinned.flat is None
            assert pinned.sketch is None and pinned.sampling_cache == {}
            assert eng.epoch == 2
    assert seen[0] == seen[1] == [3, 1, 2, 1, 1, 1, 2, 0]
    # The dead epoch's flat is its own: nothing else keeps it alive.
    with E.SelectionEngine(shards[:2], device="cpu", **KW) as eng:
        old_flat = weakref.ref(eng._state.flat)
        IngestPlane(eng).append(shards[2])
        assert old_flat() is not None
        assert eng.gc_epochs() == 1
        assert old_flat() is None


# -- 3. standing queries ------------------------------------------------------

def _standing(engine_cls, plane_cls, registry_cls, sink_cls, key, shards,
              oracle, query, **kw):
    """Register one standing query over shards 0-3, append 4 and 5, catch
    up: (tau, re-emitted (shard, indices), counters)."""
    got = []
    sink = sink_cls(lambda sid, idx, folded: got.append(
        (sid, np.asarray(idx).copy())))
    with engine_cls(shards[:4], **kw) as eng:
        with eng.session(oracle) as sess:
            reg = registry_cls(plane_cls(eng), sess)
            sq = reg.register(query, key=key, sink=sink)
            reg.settle()
            tau = sq.wait_certified(timeout=0)
            got.clear()                       # keep only re-emissions
            reg.plane.append([shards[4], shards[5]])
            started = reg.pump()
            reg.settle()
            again = reg.pump()
            counters = (started, again, sq.emissions, sq.epoch,
                        sq.reemit_failures, sq.records_reemitted,
                        reg.emissions, reg.records_reemitted)
    return tau, got, counters


def test_standing_reemission_matches_reference(corpus):
    """One catch-up walk streams the reference's {A >= tau} records over
    the appended shards, and only those."""
    ds, shards = corpus
    oracle = array_oracle(ds.labels)
    ref_q, port_q = _queries()
    want = _standing(RefEngine, RefPlane, RefRegistry,
                     ref_pipeline.CallbackSink, jax.random.PRNGKey(11),
                     shards, oracle, ref_q[0], use_kernel=False, **KW)
    got = _standing(E.SelectionEngine, IngestPlane, StandingRegistry,
                    pipeline.CallbackSink, R.PRNGKey(11), shards, oracle,
                    port_q[0], device="cpu", **KW)
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert got[2][:5] == (1, 0, 1, 1, 0)
    assert [s for s, _ in got[1]] == [s for s, _ in want[1]]
    assert all(s >= 4 for s, _ in got[1])
    for (_, a), (_, b) in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    emitted = np.sort(np.concatenate([idx for _, idx in got[1]]))
    thr = np.float32(got[0])
    expect = np.sort(np.concatenate(
        [j * SHARD + np.flatnonzero(shards[j] >= thr) for j in (4, 5)]))
    np.testing.assert_array_equal(emitted, expect)


# -- 4. the drift sentinel ----------------------------------------------------

def _drift_audit(engine_cls, plane_cls, sentinel_cls, keys, train,
                 appended, **kw):
    labels = np.concatenate([train.labels, appended.labels])
    shards = [np.ascontiguousarray(a)
              for a in np.array_split(train.scores, 4)]
    q_cls = RefQuery if engine_cls is RefEngine else SUPGQuery
    q = q_cls(target="recall", gamma=0.9, budget=2000, method="is")
    with engine_cls(shards, num_bins=1024, **kw) as eng:
        sent = sentinel_cls(eng, array_oracle(labels), probe_budget=4096,
                            sigma=4.0)
        watch = sent.watch(q, key=keys[0])
        tau0, ref0 = watch.tau, (watch.ref_rate, watch.ref_var)
        plane_cls(eng).append(appended.scores)
        rep = sent.audit(watch, key=keys[1])
        return (tau0, ref0, rep.epoch, rep.ref_rate, rep.rate, rep.z,
                rep.drifted, rep.revalidated, rep.tau_after,
                rep.probe_spent, rep.revalidation_spent, watch.tau,
                watch.epoch, (watch.ref_rate, watch.ref_var),
                (sent.checks, sent.triggers, sent.revalidations))


@pytest.mark.parametrize("kind", ["drift", "control"])
def test_sentinel_matches_reference(kind):
    """Table 3's drift pair trips the sentinel (and re-validates); a fresh
    same-law sample does not. Every number of the audit equals the
    reference's for the same keys."""
    train, shifted = ref_drift_pair(n=100_000, seed=0)
    port_train, port_shifted = make_drift_pair(n=100_000, seed=0)
    for a, b in ((train, port_train), (shifted, port_shifted)):
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.labels, b.labels)
    appended = (shifted if kind == "drift"
                else make_beta(100_000, 0.01, 1.0, seed=99))
    want = _drift_audit(RefEngine, RefPlane, RefSentinel,
                        [jax.random.PRNGKey(0), jax.random.PRNGKey(1)],
                        train, appended, use_kernel=False)
    got = _drift_audit(E.SelectionEngine, IngestPlane, DriftSentinel,
                       [R.PRNGKey(0), R.PRNGKey(1)], train, appended,
                       device="cpu")
    assert got == want
    drifted = kind == "drift"
    assert got[6] is drifted and got[7] is drifted and got[2] == 1
    assert got[-1] == ((1, 1, 1) if drifted else (1, 0, 0))
