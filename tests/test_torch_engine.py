"""The port's SelectionEngine against the JAX package's, on the CPU.

1. Given the same corpus state (`state_from_reference`), RT, PT and JT
   give the reference's exact tau, per-shard counts, IndexSink indices and
   BitmaskStore bytes at workers 1/4/8.
2. Built independently from the same shards, the two engines agree on the
   sketch and on every query, seed by seed.
3. Entry points run on cuda unless told otherwise, and raise without it.
4. The port imports neither jax nor the JAX package.

The reference engine sketches with its jnp scatter-add path
(``use_kernel=False``): its Pallas and jnp sketches differ in the last
bits of their sums, and the port's CPU sketch is the scatter-add.
"""
import doctest
import importlib
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.oracle import array_oracle  # noqa: E402
from repro.core.queries import JointSUPGQuery as RefJoint  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.data.synthetic import make_beta  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _partitionable_threefry():
    """`repro_torch.random` implements only jax's partitionable threefry,
    so the reference draws its keys under that mode whatever jax's default
    is: pinned in the config too, so an engine's worker threads see it."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)

# (name, spec): RT, two-stage IS PT and JT are the main path; the uniform
# RT and one-stage PT specs cover the engine's other sampling branches.
QUERIES = [
    ("rt", dict(target="recall", gamma=0.9, delta=0.05, budget=800)),
    ("pt", dict(target="precision", gamma=0.6, delta=0.05, budget=800)),
    ("jt", dict(gamma_recall=0.8, stage_budget=800)),
    ("rt-uniform", dict(target="recall", gamma=0.85, delta=0.1, budget=600,
                        method="uniform")),
    ("pt-one-stage", dict(target="precision", gamma=0.5, delta=0.1,
                          budget=600, two_stage=False)),
]


def _queries(name, spec):
    if name == "jt":
        return RefJoint(**spec), JointSUPGQuery(**spec)
    return RefQuery(**spec), SUPGQuery(**spec)


def _run(engine, key, oracle, name, query, sink=None):
    fn = engine.run_joint if name == "jt" else engine.run
    return fn(key, oracle, query, sink=sink)


def export_state(st):
    """The reference `CorpusState` as the arrays `state_from_reference`
    takes."""
    sk = st.shard_sketches
    return {
        "shard_counts": np.stack([np.asarray(s.counts) for s in sk]),
        "shard_sum_w": np.stack([np.asarray(s.sum_w) for s in sk]),
        "shard_sum_a": np.stack([np.asarray(s.sum_a) for s in sk]),
        "counts": np.asarray(st.sketch.counts),
        "sum_w": np.asarray(st.sketch.sum_w),
        "sum_a": np.asarray(st.sketch.sum_a),
        "chunk_sum_sqrt": np.concatenate([c.sum_sqrt
                                          for c in st.chunk_masses]),
        "chunk_sum_a": np.concatenate([c.sum_a for c in st.chunk_masses]),
        "chunk_sizes": np.concatenate([c.sizes for c in st.chunk_masses]),
        "z": np.asarray([st.z["sqrt"], st.z["prop"]], np.float64),
        "offsets": np.asarray(st.offsets, np.int64),
        "chunk_records": np.asarray([st.plan.chunk_records]),
    }


def _assert_same(ref_sel, sel):
    assert sel.tau == ref_sel.tau
    np.testing.assert_array_equal(sel.shard_counts, ref_sel.shard_counts)
    for i in range(ref_sel.num_shards):
        np.testing.assert_array_equal(sel.indices(i), ref_sel.indices(i))


# -- 1. exact, given the reference's state -------------------------------------

@pytest.fixture(scope="module", params=[64, 4096])
def given_state(request):
    bins = request.param
    ds = make_beta(15_000, 0.1, 1.0, seed=21 + bins)
    shards = [ds.scores[:2000], ds.scores[2000:8000], ds.scores[8000:]]
    ref = RefEngine(shards, num_bins=bins, use_kernel=False,
                    chunk_records=1024)
    state = E.state_from_reference(export_state(ref._state), shards)
    yield ref, state, array_oracle(ds.labels)
    ref.close()


@pytest.mark.parametrize("workers", [1, 4, 8])
@pytest.mark.parametrize("name,spec", QUERIES, ids=[q[0] for q in QUERIES])
def test_given_state_matches_reference_exactly(given_state, tmp_path,
                                               workers, name, spec):
    ref, state, oracle = given_state
    ref_q, q = _queries(name, spec)
    with E.SelectionEngine.from_state(state, device="cpu", workers=workers,
                                      clamp_workers=False) as eng:
        for seed in (0, 1):
            ref_sel = _run(ref, jax.random.PRNGKey(seed), oracle, name,
                           ref_q)
            sel = _run(eng, R.PRNGKey(seed), oracle, name, q)
            _assert_same(ref_sel, sel)
            assert isinstance(sel.sink, pipeline.IndexSink)
            ref_bits = ref_pipeline.BitmaskStore(tmp_path / f"r{seed}.bits")
            bits = pipeline.BitmaskStore(tmp_path / f"p{seed}.bits")
            _run(ref, jax.random.PRNGKey(seed), oracle, name, ref_q,
                 sink=ref_bits)
            _run(eng, R.PRNGKey(seed), oracle, name, q, sink=bits)
            assert (tmp_path / f"p{seed}.bits").read_bytes() == \
                (tmp_path / f"r{seed}.bits").read_bytes()


def test_given_state_covers_finite_thresholds(given_state):
    """The fixture's corpus gives every main-path query a finite tau, so
    the exact comparisons above cover real selections."""
    ref, state, oracle = given_state
    with E.SelectionEngine.from_state(state, device="cpu") as eng:
        for name, spec in QUERIES[:3]:
            sel = _run(eng, R.PRNGKey(0), oracle, name,
                       _queries(name, spec)[1])
            assert np.isfinite(sel.tau) and sel.total_selected > 0


# -- 2. end to end, both engines built independently ---------------------------

SEEDS = list(range(10))


@pytest.mark.parametrize("seed", SEEDS)
def test_end_to_end_matches_reference(seed):
    """Sketch counts are exact and the scatter sums bit-equal. z is held to
    rtol 1e-6: both sum the same 4096 float32 bins in the same (XLA CPU)
    order, but the bound is what a float32 sum guarantees. Where z is
    bit-equal, tau and counts must be equal; where it is not, re-running
    the port from the reference's state must restore equality, which
    shows the difference traces to z."""
    ds = make_beta(9000, 0.1, 1.0, seed=seed)
    shards = np.array_split(ds.scores, 3)
    oracle = array_oracle(ds.labels)
    with RefEngine(shards, num_bins=4096, use_kernel=False,
                   chunk_records=1024) as ref, \
            E.SelectionEngine(shards, num_bins=4096, chunk_records=1024,
                              device="cpu") as eng:
        for mine, theirs in zip(eng.shard_sketches + [eng.sketch],
                                ref.shard_sketches + [ref.sketch]):
            np.testing.assert_array_equal(mine.counts.numpy(),
                                          np.asarray(theirs.counts))
            np.testing.assert_array_equal(mine.sum_w.numpy(),
                                          np.asarray(theirs.sum_w))
            np.testing.assert_array_equal(mine.sum_a.numpy(),
                                          np.asarray(theirs.sum_a))
        for k in ("sqrt", "prop"):
            assert eng._state.z[k] == pytest.approx(ref._state.z[k],
                                                    rel=1e-6)
        if eng._state.z == ref._state.z:
            _assert_same_queries(ref, eng, seed, oracle)
        else:
            state = E.state_from_reference(export_state(ref._state), shards)
            with E.SelectionEngine.from_state(state, device="cpu") as given:
                _assert_same_queries(ref, given, seed, oracle)


def _assert_same_queries(ref, eng, seed, oracle):
    for name, spec in QUERIES[:3]:
        ref_q, q = _queries(name, spec)
        _assert_same(_run(ref, jax.random.PRNGKey(seed), oracle, name, ref_q),
                     _run(eng, R.PRNGKey(seed), oracle, name, q))


def test_memmap_shards_stay_on_the_host(tmp_path):
    """ScoreStore shards are walked span by span from the host and give
    the same answers as in-RAM shards."""
    ds = make_beta(6000, 0.1, 1.0, seed=4)
    halves = np.array_split(ds.scores, 2)
    stores = []
    for i, h in enumerate(halves):
        st = pipeline.ScoreStore(tmp_path / f"s{i}.f32", h.shape[0],
                                 create=True)
        st.write(0, h)
        stores.append(st)
    oracle = array_oracle(ds.labels)
    with E.SelectionEngine(stores, num_bins=64, chunk_records=1024,
                           device="cpu") as disk, \
            E.SelectionEngine(halves, num_bins=64, chunk_records=1024,
                              device="cpu") as ram:
        assert disk._state.flat is None
        assert isinstance(disk.shards[0], np.memmap)
        assert ram._state.flat is not None
        for name, spec in QUERIES[:3]:
            q = _queries(name, spec)[1]
            _assert_same(_run(ram, R.PRNGKey(2), oracle, name, q),
                         _run(disk, R.PRNGKey(2), oracle, name, q))


# -- 3. device selection ---------------------------------------------------------

def test_entry_points_need_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    shards = [np.linspace(0, 1, 100, dtype=np.float32)]
    with pytest.raises(RuntimeError, match="CUDA"):
        E.SelectionEngine(shards, num_bins=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        E.SelectionEngine(shards, num_bins=64, device="cuda")
    with E.SelectionEngine(shards, num_bins=64, device="cpu") as eng:
        assert eng.device.type == "cpu"
        assert eng.shards[0].device.type == "cpu"
        state = eng._state
    with pytest.raises(RuntimeError, match="CUDA"):
        E.SelectionEngine.from_state(state)


# -- 4. no jax, no JAX package -------------------------------------------------------

IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                       re.MULTILINE)


def test_port_imports_neither_jax_nor_repro():
    files = list((SRC / "repro_torch").rglob("*.py"))
    files.append(SRC.parent / "chip_smoke.py")
    for f in files:
        assert not IMPORT_RE.search(f.read_text()), f
    script = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


PORT_DOC_MODULES = [
    "repro_torch.random",
    "repro_torch.core.engine",
    "repro_torch.core.oracle",
    "repro_torch.core.resilience",
    "repro_torch.core.sampling",
    "repro_torch.data.pipeline",
    "repro_torch.durable.atomic",
    "repro_torch.durable.journal",
    "repro_torch.durable.recovery",
    "repro_torch.kernels.score_hist.ops",
    "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.threshold_select.ops",
    "repro_torch.live.ingest",
    "repro_torch.live.standing",
    "repro_torch.live.sentinel",
    "repro_torch.serve.limiter",
    "repro_torch.serve.stats",
    "repro_torch.testing.crash",
    "repro_torch.testing.faults",
]


@pytest.mark.parametrize("modname", PORT_DOC_MODULES)
def test_port_docstring_examples_run(modname):
    failures, tests = doctest.testmod(importlib.import_module(modname),
                                      verbose=False)
    assert tests > 0 and failures == 0
