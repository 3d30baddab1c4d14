"""The port's durability plane (`repro_torch.durable`, `testing.crash`,
`SelectionServer`'s journal, snapshot and restore) against the JAX
package's, on the CPU.

1. Journal frames are the reference's bytes, and each package scans what
   the other wrote; a journal cut at every byte replays a prefix; a
   corrupt frame stops the scan; reopening truncates a torn tail.
2. The crash injector: atomic replace survives `pre_fsync`/`pre_rename`,
   the injector latches, unknown points are refused, and
   `crash_schedule` is the reference's for seeds 0-31.
3. Replay is idempotent, and `run_many` after a crash and a replay is
   the reference's uncrashed `run_many` bit for bit at workers 1/4/8.
4. A durable server killed at each of the reference's append-path
   crashpoints, restored and resumed, ends with the reference's
   uncrashed server's taus, sink bits and tenant charge; a snapshot crash
   keeps the old snapshot; an audited watch restores without re-spending
   and labels what the reference's restored server labels (63 records:
   the 64-draw probe holds one record twice, and the channel labels
   distinct records); a fresh server refuses a crashed journal; stats.
5. Interchange: a durable root written by either package's server
   restores in the other's with equal taus, balances and corpus.

The reference engine sketches with its jnp scatter-add path
(``use_kernel=False``), as in `tests/test_torch_engine.py`.
"""
import os
import tempfile
import time

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.queries import JointSUPGQuery as RefJoint  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data.pipeline import BitmaskStore as RefBitmask  # noqa: E402
from repro.durable import journal as ref_journal  # noqa: E402
from repro.durable.recovery import DurabilityPlane as RefPlaneD  # noqa
from repro.live.ingest import IngestPlane as RefIngest  # noqa: E402
from repro.serve.server import SelectionServer as RefServer  # noqa: E402
from repro.testing import crash as ref_crash  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data.pipeline import BitmaskStore  # noqa: E402
from repro_torch.durable import atomic, journal  # noqa: E402
from repro_torch.durable.journal import EpochJournal, scan  # noqa: E402
from repro_torch.durable.recovery import DurabilityPlane  # noqa: E402
from repro_torch.live.ingest import IngestPlane  # noqa: E402
from repro_torch.serve.server import SelectionServer  # noqa: E402
from repro_torch.testing import (CrashInjector, SimulatedCrash,  # noqa: E402
                                 crash_schedule)

from test_torch_engine import _partitionable_threefry  # noqa: E402,F401

BASE_N, DELTA_N = 2048, 1024
ENGINE_KW = dict(num_bins=64, device="cpu")
REF_KW = dict(num_bins=64, use_kernel=False)
SPECS = [
    ("rt", dict(target="recall", gamma=0.9, budget=192, method="is")),
    ("pt", dict(target="precision", gamma=0.9, budget=192, method="is")),
    ("jt", dict(gamma_recall=0.85, stage_budget=192)),
]
QUERIES = [JointSUPGQuery(**s) if n == "jt" else SUPGQuery(**s)
           for n, s in SPECS]
REF_QUERIES = [RefJoint(**s) if n == "jt" else RefQuery(**s)
               for n, s in SPECS]

# The reference's crashpoints on the ingest/append/standing-catch-up path
# (tests/test_durable.py); `pre_snapshot_publish` is tested on its own.
APPEND_PATH_POINTS = [
    "pre_fsync", "pre_rename", "journal_pre_append", "journal_pre_fsync",
    "post_journal_pre_install", "mid_bitmask_commit",
]


def _base_shards():
    return [np.linspace(0.0, 1.0, BASE_N, dtype=np.float32)]


def _deltas():
    rng = np.random.default_rng(11)
    return [rng.beta(0.05, 1.0, DELTA_N).astype(np.float32)
            for _ in range(3)]


def _oracle(idx):
    return (np.asarray(idx) % 7 == 0).astype(np.float32)


# -- 1. journal framing -------------------------------------------------------

def test_journal_frames_are_the_reference_bytes(tmp_path):
    """Frames are byte-identical, and each package scans the other's
    journal to the same records."""
    records = [{"type": "append", "epoch": 1, "shards": [
        {"file": "epoch_00000001_0000.npy", "records": 10, "crc": 7}]},
        {"epoch": 2, "z": [1.5, "x"]}, {}]
    assert journal.MAGIC == ref_journal.MAGIC
    for r in records:
        assert journal._frame(r) == ref_journal._frame(r)
    mine, theirs = str(tmp_path / "port.log"), str(tmp_path / "ref.log")
    with EpochJournal(mine) as j:
        for r in records:
            j.append(r)
    with ref_journal.EpochJournal(theirs) as j:
        for r in records:
            j.append(r)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert scan(theirs) == ref_journal.scan(mine) == (
        records, os.path.getsize(mine))


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 10**6), min_size=1, max_size=4))
def test_journal_truncation_property(epochs):
    """Truncating the file at every byte offset: replay never raises and
    never invents a record — it returns a strict prefix, monotone in the
    bytes kept, and the reference's scan agrees at every cut."""
    records = [{"type": "append", "epoch": e, "shards": []} for e in epochs]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "j.log")
        with EpochJournal(path) as j:
            for r in records:
                j.append(r)
        data = open(path, "rb").read()
        cut = os.path.join(d, "cut.log")
        prefix_lens = []
        for n in range(len(data) + 1):
            with open(cut, "wb") as f:
                f.write(data[:n])
            got, valid = scan(cut)
            assert valid <= n
            assert got == records[:len(got)]    # prefix, never invented
            assert (got, valid) == ref_journal.scan(cut)
            prefix_lens.append(len(got))
    assert prefix_lens[0] == 0 and prefix_lens[-1] == len(records)
    assert prefix_lens == sorted(prefix_lens)


def test_journal_corrupt_frame_stops_scan(tmp_path):
    path = str(tmp_path / "j.log")
    with EpochJournal(path) as j:
        j.append({"epoch": 1})
        j.append({"epoch": 2})
    data = bytearray(open(path, "rb").read())
    first_len = scan(path)[1] // 2  # two equal frames
    data[first_len + 14] ^= 0xFF    # corrupt the second frame's payload
    open(path, "wb").write(bytes(data))
    got, valid = scan(path)
    assert [r["epoch"] for r in got] == [1]
    assert valid == first_len


def test_journal_reopen_truncates_torn_tail_and_appends(tmp_path):
    path = str(tmp_path / "j.log")
    with EpochJournal(path) as j:
        j.append({"epoch": 1})
    with open(path, "ab") as f:
        f.write(b"EPJ1\x07\x00")    # half a header
    with EpochJournal(path) as j:
        assert [r["epoch"] for r in j.records] == [1]
        j.append({"epoch": 2})
    assert [r["epoch"] for r in EpochJournal(path).replay()] == [1, 2]


# -- 2. crash injector + atomic replace ---------------------------------------

@pytest.mark.parametrize("point", ["pre_fsync", "pre_rename"])
def test_atomic_replace_crash_leaves_old_file(tmp_path, point):
    path = str(tmp_path / "s.json")
    atomic.atomic_write_json(path, {"v": 1})
    with CrashInjector({point: 0}):
        with pytest.raises(SimulatedCrash):
            atomic.atomic_write_json(path, {"v": 2})
    assert atomic.read_json(path) == {"v": 1}
    atomic.atomic_write_json(path, {"v": 3})    # hook uninstalled
    assert atomic.read_json(path) == {"v": 3}


def test_crash_injector_latches(tmp_path):
    """After firing once, every later crashpoint raises too — a dead
    process cannot keep committing."""
    inj = CrashInjector({"pre_rename": 0})
    with inj:
        with pytest.raises(SimulatedCrash):
            atomic.atomic_write_json(str(tmp_path / "a.json"), {})
        with pytest.raises(SimulatedCrash):
            atomic.crashpoint("journal_pre_append")    # unscheduled point
    assert inj.fired and inj.fired_at == "pre_rename"
    assert inj.fired_event.is_set()


def test_crash_injector_rejects_unknown_points():
    with pytest.raises(ValueError, match="unknown crashpoint"):
        CrashInjector({"not_a_point": 0})


@pytest.mark.parametrize("seed", range(32))
def test_crash_schedule_matches_reference(seed):
    got = crash_schedule(seed)
    assert got == crash_schedule(seed) == ref_crash.crash_schedule(seed)
    (point, hit), = got.items()
    assert point in atomic.CRASHPOINTS and 0 <= hit < 3
    pts = APPEND_PATH_POINTS[seed % 3:]
    assert crash_schedule(seed, pts, max_hit=5) == \
        ref_crash.crash_schedule(seed, pts, max_hit=5)


# -- 3. replay ----------------------------------------------------------------

def test_record_append_spools_the_reference_bytes(tmp_path):
    """A shard spools to the reference's file and manifest; a tensor shard
    spools its scores and is handed back as given for the install."""
    delta = _deltas()[0]
    mine = DurabilityPlane(str(tmp_path / "port"))
    theirs = RefPlaneD(str(tmp_path / "ref"))
    t = torch.from_numpy(delta.copy())
    out = mine.record_append([delta, t], epoch=1)
    theirs.record_append([delta, delta], epoch=1)
    assert isinstance(out[0], np.ndarray) and out[1] is t
    assert mine.journal.records == theirs.journal.records
    for name in sorted(os.listdir(mine.shard_dir)):
        assert open(os.path.join(mine.shard_dir, name), "rb").read() == \
            open(os.path.join(theirs.shard_dir, name), "rb").read()
    mine.close()
    theirs.close()


def test_replay_is_idempotent(tmp_path):
    dur = DurabilityPlane(str(tmp_path / "dur"))
    with SelectionEngine(_base_shards(), **ENGINE_KW) as eng:
        plane = IngestPlane(eng)
        for d in _deltas():
            arrs = dur.record_append(d, epoch=plane.epoch + 1)
            plane.append(arrs)
        assert dur.replay_into(plane) == 0      # already applied: no-op
    with SelectionEngine(_base_shards(), **ENGINE_KW) as eng2:
        plane2 = IngestPlane(eng2)
        assert dur.replay_into(plane2) == 3
        assert dur.replay_into(plane2) == 0     # replaying again: no-op
        assert eng2.n_total == BASE_N + 3 * DELTA_N
        assert dur.replayed_epochs == 3


@pytest.fixture(scope="module")
def reference_run_many():
    """The reference's uncrashed engine after three appends: `run_many`."""
    with RefEngine(_base_shards(), **REF_KW) as ref_eng:
        plane = RefIngest(ref_eng)
        for d in _deltas():
            plane.append(d)
        return ref_eng.run_many(jax.random.PRNGKey(5), _oracle, REF_QUERIES)


@pytest.mark.parametrize("workers", [1, 4, 8])
def test_run_many_crash_restore_bit_for_bit(tmp_path, workers,
                                            reference_run_many):
    """Kill mid-append, rebuild from the journal, run RT/PT/JT through
    `run_many`: results equal the reference's never-crashed engine's bit
    for bit, `oracle_calls` included."""
    kw = dict(ENGINE_KW, workers=workers, clamp_workers=False)
    deltas = _deltas()
    dur = DurabilityPlane(str(tmp_path / "dur"))
    with SelectionEngine(_base_shards(), **kw) as eng:
        plane = IngestPlane(eng)
        with CrashInjector({"post_journal_pre_install": 2}):
            with pytest.raises(SimulatedCrash):
                for d in deltas:
                    plane.append(dur.record_append(d, epoch=plane.epoch + 1))
        assert eng.epoch == 2
    with SelectionEngine(_base_shards(), **kw) as rec_eng:
        rec_plane = IngestPlane(rec_eng)
        # The journaled-but-uninstalled epoch replays too.
        assert dur.replay_into(rec_plane) == 3
        got = rec_eng.run_many(R.PRNGKey(5), _oracle, QUERIES)
    for r, g in zip(reference_run_many, got):
        assert g.tau == r.tau
        assert g.oracle_calls == r.oracle_calls
        np.testing.assert_array_equal(g.shard_counts, r.shard_counts)
        for sh in range(len(r.shard_sizes)):
            np.testing.assert_array_equal(g.indices(sh), r.indices(sh))


# -- 4. server crashpoint acceptance ------------------------------------------

def _make_server(cls, root, sink_dir, tag, port=True):
    """A durable server with the three queries subscribed on BitmaskStore
    sinks, certified and snapshotted."""
    if port:
        eng = SelectionEngine(_base_shards(), **ENGINE_KW)
        keys, qs, sink_cls = [R.PRNGKey(j) for j in range(3)], QUERIES, \
            BitmaskStore
    else:
        eng = RefEngine(_base_shards(), **REF_KW)
        keys, qs, sink_cls = [jax.random.PRNGKey(j) for j in range(3)], \
            REF_QUERIES, RefBitmask
    srv = cls(eng, _oracle, durable=root, quotas={"t": 1_000_000})
    sqs = [srv.subscribe(q, tenant="t", key=k, sink=sink_cls(
        os.path.join(sink_dir, f"{tag}_{j}.bits")))
        for j, (q, k) in enumerate(zip(qs, keys))]
    for sq in sqs:
        sq.wait_certified(timeout=120)
    srv.snapshot()
    return srv, sqs


def _wait_quiescent(srv, sqs, epoch, inj=None, timeout=120):
    deadline = time.monotonic() + timeout
    while True:
        if inj is not None and inj.fired:
            return False
        if all(sq.epoch >= epoch and not sq._busy for sq in sqs) \
                and not srv._registry.has_pending():
            return True
        if srv._fatal is not None:
            raise AssertionError(f"scheduler died: {srv._fatal!r}")
        assert time.monotonic() < deadline, "standing catch-up stalled"
        time.sleep(0.01)


def _collect(srv, sqs):
    n_shards = len(srv.engine.shards)
    taus = [sq.tau for sq in sqs]
    masks = [[sq.sink.mask(sh).copy() for sh in range(n_shards)]
             for sq in sqs]
    charged = srv.stats().tenants["t"].oracle_charged
    return taus, masks, charged


@pytest.fixture(scope="module")
def uncrashed_reference(tmp_path_factory):
    """The reference's never-crashed server: taus, sink bits, charge."""
    d = str(tmp_path_factory.mktemp("ref_uncrashed"))
    srv, sqs = _make_server(RefServer, os.path.join(d, "dur"), d, "ref",
                            port=False)
    for i, delta in enumerate(_deltas()):
        srv.append(delta)
        _wait_quiescent(srv, sqs, i + 1)
    out = _collect(srv, sqs)
    srv.close()
    return out


@pytest.mark.parametrize("point", APPEND_PATH_POINTS)
def test_server_crashpoint_acceptance(tmp_path, point, uncrashed_reference):
    """Kill at `point` (hit 1 on the journal's points, else 0, as the
    reference's test), abandon, restore, re-issue the appends the restored
    epoch shows missing: the reference's uncrashed taus, sink bits and
    tenant charge, with no oracle budget re-spent."""
    ref_taus, ref_masks, ref_charged = uncrashed_reference
    hit = 1 if "journal" in point else 0
    root = str(tmp_path / "dur")
    deltas = _deltas()
    srv, sqs = _make_server(SelectionServer, root, str(tmp_path), "crash")
    died = False
    inj = CrashInjector({point: hit})
    with inj:
        for i, delta in enumerate(deltas):
            try:
                srv.append(delta)
            except SimulatedCrash:
                died = True
                break
            if not _wait_quiescent(srv, sqs, i + 1, inj=inj):
                died = True
                break
    assert died or inj.fired, f"{point}[{hit}] never fired"
    srv.close(abandon=True)
    assert srv.engine.shards == [] and srv.engine._state.flat is None

    srv = SelectionServer.restore(
        root, _oracle, base_shards=_base_shards(), engine_kw=ENGINE_KW,
        quotas={"t": 1_000_000})
    try:
        sqs = srv._registry.standing
        assert len(sqs) == len(QUERIES)
        assert srv.recovered_queries == len(QUERIES)
        for i in range(srv.plane.epoch, len(deltas)):
            srv.append(deltas[i])
        _wait_quiescent(srv, sqs, len(deltas))
        taus, masks, charged = _collect(srv, sqs)
    finally:
        srv.close()
    assert taus == ref_taus
    for got, ref in zip(masks, ref_masks):
        for sh, (g, r) in enumerate(zip(got, ref)):
            assert np.array_equal(g, r), f"shard {sh} bits diverged"
    assert charged == ref_charged


def test_snapshot_crash_keeps_previous_snapshot(tmp_path):
    root = str(tmp_path / "dur")
    srv, sqs = _make_server(SelectionServer, root, str(tmp_path), "snap")
    before = srv.durable.read_snapshot()
    srv.append(_deltas()[0])
    _wait_quiescent(srv, sqs, 1)
    with CrashInjector({"pre_snapshot_publish": 0}):
        with pytest.raises(SimulatedCrash):
            srv.snapshot()
    assert srv.durable.read_snapshot() == before
    srv.close(abandon=True)


def _audited_restore(cls, eng, key, sink_cls, q, tmp_path):
    """Subscribe an audited RT (probe 64), append, snapshot, abandon,
    restore, append again: the numbers both packages must agree on."""
    root = str(tmp_path / "dur")
    kw = dict(quotas={"t": 1_000_000}, sentinel_probe_budget=64)
    srv = cls(eng, _oracle, durable=root, **kw)
    sq = srv.subscribe(q, tenant="t", key=key,
                       sink=sink_cls(str(tmp_path / "a.bits")), audit=True)
    sq.wait_certified(timeout=120)
    deadline = time.monotonic() + 120
    while not srv._watches:        # the scheduler attaches the watch
        assert time.monotonic() < deadline
        time.sleep(0.01)
    srv.append(_deltas()[0])
    while srv._watches[0][3] < 1 or srv._registry.has_pending():
        assert time.monotonic() < deadline
        time.sleep(0.01)
    snap = srv.snapshot()
    srv.close(abandon=True)

    restore_kw = (dict(engine_kw=ENGINE_KW) if cls is SelectionServer
                  else dict(engine_kw=REF_KW))
    srv = cls.restore(root, _oracle, base_shards=_base_shards(),
                      **restore_kw, **kw)
    try:
        charged0 = srv.stats().tenants["t"].oracle_charged
        [sq2] = srv._registry.standing
        watch = (np.asarray(srv._watches[0][2]).tolist(),
                 srv._watches[0][3])
        srv.append(_deltas()[1])
        deadline = time.monotonic() + 120
        while srv._watches[0][3] < 2 or srv._registry.has_pending():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        st = srv.stats()
    finally:
        srv.close()
    return dict(snap_charged=snap["tenants"]["t"]["charged"],
                last_audited=snap["watches"][0]["last_audited"],
                charged_at_restore=charged0, watch=watch,
                tau=(sq.tau, sq2.tau), certified=sq2.certified,
                checks=st.sentinel_checks,
                records_labeled=st.records_labeled,
                cache_hits=st.cache_hits, oracle_calls=st.oracle_calls,
                charged=st.tenants["t"].oracle_charged)


def test_restore_spends_nothing_with_audited_watch(tmp_path):
    """Restore re-adopts an audited watch from its snapshot: the tenant
    sits at its snapshot balance, epoch 1 is not audited again, epoch 2
    is audited with the uncrashed scheduler's key, and the restored
    server labels exactly what the reference's restored server labels
    (its 64-draw probe holds 63 distinct records)."""
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _audited_restore(RefServer, RefEngine(_base_shards(), **REF_KW),
                            jax.random.PRNGKey(9), RefBitmask,
                            REF_QUERIES[0], tmp_path / "ref")
    got = _audited_restore(SelectionServer,
                           SelectionEngine(_base_shards(), **ENGINE_KW),
                           R.PRNGKey(9), BitmaskStore, QUERIES[0],
                           tmp_path / "port")
    assert got == want
    assert got["snap_charged"] > 0 and got["last_audited"] == 1
    assert got["charged_at_restore"] == got["charged"] == got["snap_charged"]
    assert got["watch"] == (R.fold_in(R.PRNGKey(9), 0x5E47).tolist(), 1)
    assert got["tau"][0] == got["tau"][1] and got["certified"]
    assert got["checks"] == 1                   # epoch 2 only: 1 was done
    assert got["records_labeled"] == 63 and got["cache_hits"] == 0


def test_fresh_server_refuses_crashed_journal(tmp_path):
    root = str(tmp_path / "dur")
    dur = DurabilityPlane(root)
    dur.record_append(_deltas()[0], epoch=1)
    dur.close()
    with SelectionEngine(_base_shards(), **ENGINE_KW) as eng:
        with pytest.raises(ValueError, match="restore"):
            SelectionServer(eng, _oracle, durable=root, own_engine=False)


def test_server_stats_report_durability(tmp_path):
    root = str(tmp_path / "dur")
    srv, sqs = _make_server(SelectionServer, root, str(tmp_path), "stats")
    srv.append(_deltas()[0])
    _wait_quiescent(srv, sqs, 1)
    srv.snapshot()
    st = srv.stats()
    assert st.durable and st.journal_records == 1 and st.journal_bytes > 0
    assert st.snapshots == 2
    assert st.epochs_freed >= 1 and st.epochs_live >= 1
    assert "durable: on" in st.format()
    srv.close()
    assert srv.stats().epochs_live == st.epochs_live   # readable after


def test_restore_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = str(tmp_path / "dur")
    DurabilityPlane(root).close()
    with pytest.raises(RuntimeError, match="CUDA"):
        SelectionServer.restore(root, _oracle, base_shards=_base_shards(),
                                engine_kw=dict(num_bins=64))


# -- 5. interchange -----------------------------------------------------------

def _write_root(port, root, tmp_path):
    """A durable server of one package: certified, snapshotted, one
    append installed and one journaled whose install crashed."""
    cls = SelectionServer if port else RefServer
    srv, sqs = _make_server(cls, root, str(tmp_path), "x", port=port)
    inj_cls = CrashInjector if port else ref_crash.CrashInjector
    crash = SimulatedCrash if port else ref_crash.SimulatedCrash
    with inj_cls({"post_journal_pre_install": 1}):
        srv.append(_deltas()[0])
        _wait_quiescent(srv, sqs, 1)
        with pytest.raises(crash):
            srv.append(_deltas()[1])
    srv.close(abandon=True)


def _restored(port, root):
    """Restore `root` in one package: taus, balance and corpus."""
    if port:
        srv = SelectionServer.restore(root, _oracle,
                                      base_shards=_base_shards(),
                                      engine_kw=ENGINE_KW,
                                      quotas={"t": 1_000_000})
    else:
        srv = RefServer.restore(root, _oracle, base_shards=_base_shards(),
                                engine_kw=REF_KW, quotas={"t": 1_000_000})
    try:
        sqs = srv._registry.standing
        _wait_quiescent(srv, sqs, 2)
        eng = srv.engine
        sk = [np.asarray(s.counts) for s in eng.shard_sketches]
        return dict(taus=[sq.tau for sq in sqs],
                    charged=srv.stats().tenants["t"].oracle_charged,
                    n_total=eng.n_total, epoch=eng.epoch,
                    recovered=(srv.recovered_epochs, srv.recovered_queries),
                    counts=[c.tolist() for c in sk],
                    masks=[[sq.sink.mask(sh).tolist()
                            for sh in range(len(eng.shards))]
                           for sq in sqs])
    finally:
        srv.close()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_durable_root_restores_in_either_package(tmp_path, writer):
    """A journal, spool and snapshot written by one package restore in
    the other to the same taus, balance, corpus and sink bits as in the
    writer's own package."""
    root = str(tmp_path / "dur")
    _write_root(writer == "port", root, tmp_path)
    theirs = _restored(writer != "port", root)
    ours = _restored(writer == "port", root)
    assert theirs == ours
    assert ours["epoch"] == 2 and ours["recovered"] == (2, 3)
    assert ours["n_total"] == BASE_N + 2 * DELTA_N
