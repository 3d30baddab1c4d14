"""The port's distributed selection plane on ``torch.distributed`` against
the JAX package's ``shard_map`` plane, on the CPU.

Each world size (1, 2, 4) is one spawn of ``gloo`` ranks over a
``FileStore`` in the test's temporary directory; every rank runs every
function of `repro_torch.core.distributed` on its shard and saves what it
got, and the test holds that against the reference on a 1-device mesh,
run on each rank's shard and on the whole array. A spawn that does not
end within its timeout fails the test.

Bars: counts and selections are exact. Sums in the global sketch add the
ranks' float32 sketches in the backend's order, where the reference adds
the whole array's records in one float32 scatter-add; each of the two
float32 sums of a bin's k non-negative terms lies within (k − 1)·2^-24 of
the exact sum S, so they are held within 2·k·2^-24·S of each other, and
to the bit at world size 1. Shard weight totals (float32 tree sums, one
a rank), `two_level_sample`, `within_shard_probs` and `local_selection`
are local and exact.
"""
import pathlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as tmp  # noqa: E402

from repro.core import binned as jbinned  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import distributed, sampling  # noqa: E402
from repro_torch.data.synthetic import make_beta  # noqa: E402

N_RECORDS = 24_001          # not a multiple of any world size
BINS = 256
TAUS = (0.0, 1e-3, 0.25, 0.9, -0.5)
N_DRAWS = 4000
SPAWN_TIMEOUT_S = 120


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


def _corpus() -> np.ndarray:
    s = make_beta(N_RECORDS, 0.01, 1.0, seed=21).scores.copy()
    rng = np.random.default_rng(21)
    s[rng.random(N_RECORDS) < 0.02] = -1.0          # unscored sentinels
    s[rng.random(N_RECORDS) < 0.01] = np.float32(-0.25)
    return s


def _rank(rank: int, world: int, root: str) -> None:
    """One gloo rank: every distributed function on its shard."""
    torch.set_num_threads(1)
    root = pathlib.Path(root)
    store = dist.FileStore(str(root / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        shard = torch.from_numpy(np.array_split(np.load(root / "scores.npy"),
                                                world)[rank])
        out = {"sketch": torch.stack(list(distributed.global_sketch(
            shard, BINS)))}
        for scheme in ("sqrt", "prop"):
            totals = distributed.shard_weight_totals(shard, scheme)
            out[f"totals_{scheme}"] = totals
            ids, keys = distributed.two_level_sample(R.PRNGKey(rank), totals,
                                                     N_DRAWS)
            out[f"ids_{scheme}"], out[f"keys_{scheme}"] = ids, keys
            p, m = distributed.within_shard_probs(
                shard, float(totals[:, 0].sum()), float(totals[:, 1].sum()),
                scheme)
            out[f"p_{scheme}"], out[f"m_{scheme}"] = p, m
        for tau in TAUS:
            out[f"mask_{tau}"] = distributed.local_selection(shard, tau)
            out[f"count_{tau}"] = distributed.global_selection_count(shard,
                                                                     tau)
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(world: int, root: pathlib.Path) -> None:
    ctx = tmp.start_processes(_rank, args=(world, str(root)), nprocs=world,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} gloo ranks did not end in "
                        f"{SPAWN_TIMEOUT_S} s")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_distributed_plane_matches_reference(world, tmp_path):
    scores = _corpus()
    np.save(tmp_path / "scores.npy", scores)
    _spawn(world, tmp_path)
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    mesh = make_test_mesh((1, 1))
    shards = np.array_split(scores, world)

    # the global sketch: every rank holds the same one
    want = jdist.global_sketch(mesh, jnp.asarray(scores), BINS)
    np.testing.assert_array_equal(
        np.asarray(want.counts),
        np.asarray(jbinned.build_sketch(scores, BINS,
                                        use_kernel=False).counts))
    for out in outs:
        np.testing.assert_array_equal(out["sketch"], outs[0]["sketch"])
    got = outs[0]["sketch"].numpy()
    counts = np.asarray(want.counts)
    np.testing.assert_array_equal(got[0], counts)
    for row, ref in ((1, want.sum_w), (2, want.sum_a)):
        ref = np.asarray(ref, np.float64)
        if world == 1:
            np.testing.assert_array_equal(got[row], ref)
        bar = 2.0 * counts * 2.0 ** -24 * ref
        assert np.all(np.abs(got[row] - ref) <= bar), row

    for scheme in ("sqrt", "prop"):
        # shard totals: each row is the reference on that rank's shard
        want_rows = np.concatenate([np.asarray(jdist.shard_weight_totals(
            mesh, jnp.asarray(s), scheme)) for s in shards])
        for rank, out in enumerate(outs):
            totals = out[f"totals_{scheme}"].numpy()
            np.testing.assert_array_equal(totals, want_rows)
            key = jax.random.PRNGKey(rank)
            ids, keys = jdist.two_level_sample(key, jnp.asarray(totals),
                                               N_DRAWS)
            np.testing.assert_array_equal(out[f"ids_{scheme}"],
                                          np.asarray(ids))
            np.testing.assert_array_equal(out[f"keys_{scheme}"],
                                          np.asarray(keys))
            p, m = jdist.within_shard_probs(
                jnp.asarray(shards[rank]), float(totals[:, 0].sum()),
                float(totals[:, 1].sum()), scheme)
            np.testing.assert_array_equal(out[f"p_{scheme}"], np.asarray(p))
            np.testing.assert_array_equal(out[f"m_{scheme}"], np.asarray(m))

    for tau in TAUS:
        want_count = float(jdist.global_selection_count(
            mesh, jnp.asarray(scores), tau))
        for rank, out in enumerate(outs):
            assert out[f"count_{tau}"].dtype == torch.int64
            assert int(out[f"count_{tau}"]) == want_count == int(
                (scores >= np.float32(tau)).sum())
            np.testing.assert_array_equal(out[f"mask_{tau}"], np.asarray(
                jdist.local_selection(mesh, jnp.asarray(shards[rank]), tau)))


def test_collectives_raise_without_a_group():
    assert not dist.is_initialized()
    s = torch.rand(100)
    for call in (lambda: distributed.global_sketch(s, 64),
                 lambda: distributed.shard_weight_totals(s),
                 lambda: distributed.local_selection(s, 0.5),
                 lambda: distributed.global_selection_count(s, 0.5)):
        with pytest.raises(RuntimeError, match="no torch.distributed"):
            call()


def test_two_level_draws_are_unbiased():
    """Shard allocation, then within-shard inverse-CDF draws over
    `within_shard_probs`: mean(label · m) estimates the positive rate
    (the local half of the plane, no group needed)."""
    ds = make_beta(80_000, 0.05, 1.0, seed=6)
    shards = [torch.from_numpy(s) for s in np.array_split(ds.scores, 8)]
    labels = np.array_split(ds.labels, 8)
    totals = torch.stack([torch.stack([
        torch.sqrt(torch.clamp(s, 0.0, 1.0)).sum(),
        torch.tensor(float(s.numel()))]) for s in shards])
    z, n = float(totals[:, 0].sum()), float(totals[:, 1].sum())
    ids, keys = distributed.two_level_sample(R.PRNGKey(1), totals, 40_000)
    est = []
    for i, shard in enumerate(shards):
        k = int((ids == i).sum())
        if k == 0:
            continue
        p, m = distributed.within_shard_probs(shard, z, n)
        draws = sampling.sample_weighted(keys[np.argmax(ids == i)], p, k)
        est.append(labels[i][draws.indices.numpy()] * m[draws.indices]
                   .numpy())
    got = float(np.mean(np.concatenate(est)))
    assert got == pytest.approx(float(ds.labels.mean()), rel=0.2)
