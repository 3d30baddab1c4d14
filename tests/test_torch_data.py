"""The port's host-side data plumbing against the JAX package's:
`SelectionStream` over the port's `CallbackSink` (the same chunks in the
same order as the reference's stream, for engines run on the CPU; a
stream shuts down on `close()` and on leaving its ``with`` block),
`parallel_map`, `DeterministicSource` and `Prefetcher`.
"""
import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.engine import SelectionEngine as RefEngine  # noqa: E402
from repro.core.oracle import array_oracle as jarray_oracle  # noqa: E402
from repro.core.queries import SUPGQuery as RefQuery  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.core.queries import SUPGQuery  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data.synthetic import make_beta  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _partitionable_threefry():
    """`repro_torch.random` implements only jax's partitionable threefry,
    so the reference draws its keys under that mode."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        with jax.threefry_partitionable(True):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", before)


@pytest.fixture(scope="module")
def corpus():
    ds = make_beta(24_000, 0.05, 1.0, seed=8)
    return ds, np.array_split(ds.scores, 3)


SPEC = dict(target="recall", gamma=0.9, delta=0.05, budget=800)


def _chunks(stream):
    return [(int(sh), np.asarray(g).copy(), bool(f)) for sh, g, f in stream]


@pytest.mark.parametrize("depth", [1, 8])
def test_selection_stream_matches_reference(corpus, depth):
    ds, shards = corpus
    key = jax.random.PRNGKey(4)
    with RefEngine(shards, num_bins=256, use_kernel=False,
                   chunk_records=1024) as ref, \
            SelectionEngine(shards, num_bins=256, chunk_records=1024,
                            device="cpu") as eng:
        with jpipeline.SelectionStream(
                lambda sink: ref.run(key, jarray_oracle(ds.labels),
                                     RefQuery(**SPEC), sink=sink),
                depth=depth) as jst:
            want = _chunks(jst)
        with pipeline.SelectionStream(
                lambda sink: eng.run(np.asarray(key), array_oracle(ds.labels),
                                     SUPGQuery(**SPEC), sink=sink),
                depth=depth) as st:
            got = _chunks(st)
    assert len(got) == len(want) > 3
    for (sh, g, f), (jsh, jg, jf) in zip(got, want):
        assert (sh, f) == (jsh, jf)
        np.testing.assert_array_equal(g, jg)
    assert st.result.tau == jst.result.tau
    assert st.result.total_selected == sum(len(g) for _, g, _ in got)


def test_selection_stream_closes_early_and_in_with(corpus):
    ds, shards = corpus
    with SelectionEngine(shards, num_bins=256, chunk_records=1024,
                         device="cpu") as eng:
        def run(sink):
            return eng.run(np.asarray(jax.random.PRNGKey(1)),
                           array_oracle(ds.labels), SUPGQuery(**SPEC),
                           sink=sink)

        st = pipeline.SelectionStream(run, depth=1)
        first = next(st)
        assert first[1].size > 0
        st.close()
        assert not st._thread.is_alive() and st.result is None
        st.close()                                  # idempotent
        with pytest.raises(StopIteration):
            next(st)

        with pipeline.SelectionStream(run, depth=1) as st2:
            next(st2)
        assert not st2._thread.is_alive() and st2.result is None

        with pipeline.SelectionStream(run) as st3:
            n = len(list(st3))
        assert n > 3 and st3.result is not None


def test_selection_stream_raises_the_producers_error():
    def run(sink):
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        with pipeline.SelectionStream(run) as st:
            list(st)


@pytest.mark.parametrize("workers", [1, 4])
def test_parallel_map_keeps_order(workers):
    items = list(range(40))
    want = jpipeline.parallel_map(lambda x: x * x, items, workers=workers)
    assert pipeline.parallel_map(lambda x: x * x, items,
                                 workers=workers) == want
    with pipeline.WorkerPool(3) as pool:
        assert pipeline.parallel_map(lambda x: x * x, items,
                                     pool=pool) == want


def _batch(rng, step):
    return {"x": rng.integers(0, 100, (8, 3)), "step": np.full(8, step)}


@pytest.mark.parametrize("shard", [(0, 1), (1, 2), (3, 4)])
def test_deterministic_source_matches_reference(shard):
    src = pipeline.DeterministicSource(_batch, 7, *shard)
    ref = jpipeline.DeterministicSource(_batch, 7, *shard)
    for step in (0, 5):
        got, want = src.batch_at(step), ref.batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    it = src.iter_from(3)
    for step in (3, 4, 5):
        np.testing.assert_array_equal(next(it)["x"], ref.batch_at(step)["x"])


def test_prefetcher_order_and_errors():
    assert list(pipeline.Prefetcher(iter(range(20)), depth=2)) == list(
        range(20))

    def bad():
        yield 1
        raise ValueError("source failed")

    pf = pipeline.Prefetcher(bad())
    assert next(pf) == 1
    with pytest.raises(ValueError, match="source failed"):
        next(pf)
