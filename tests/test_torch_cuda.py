"""Tests that need an NVIDIA GPU (marked ``cuda``; they skip without one).

They import nothing of jax or the JAX package, so they run on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The CUDA kernels are held against their plain versions on the card, the
card's engine against a CPU engine serving the same corpus state, and
narrow models' scores (float32) and logits (bf16) through the kernels
(flash_attention; linear_scan and flash_attention for the hybrid) against
the same models with the plain versions, a durable server's crash and
restore on the card against its uncrashed run, the single-array query
path and the distributed plane (nccl at world size 1, two gloo ranks on
CUDA tensors) as phase 15 of ``chip_smoke.py`` checks them, and smoke-size
RWKV6 prefills (the channel kernel) and decode steps of the four families on
the card against the same models on the CPU, and the MoE layer's routing and
dispatch on the card against the CPU's from the same router logits;
flash_attention at MLA's (dh, dv) = (192, 128), a narrow MLA + MoE model
through it and deepseek-v2's absorbed-latent decode on the card against
the CPU; the flash_attention backward kernel against its plain backward,
train steps of a narrow model on the card against the CPU, and a
checkpoint restored onto the card.
"""
import dataclasses
import pathlib
import time
from unittest import mock

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import binned, sampling  # noqa: E402
from repro_torch.core import distributed as dplane  # noqa: E402
from repro_torch.core import queries as qpath  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.core.queries import JointSUPGQuery, SUPGQuery  # noqa: E402
from repro_torch.data.pipeline import BitmaskStore  # noqa: E402
from repro_torch.data.synthetic import make_beta  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_scan import ops as ls_ops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as ls_ref  # noqa: E402
from repro_torch.kernels.score_hist import ops as sh_ops  # noqa: E402
from repro_torch.kernels.score_hist import ref as sh_ref  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402
from repro_torch.kernels.threshold_select import ref as ts_ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.live import IngestPlane  # noqa: E402
from repro_torch.models import attention, mamba, model, moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import SelectionServer  # noqa: E402
from repro_torch.testing import CrashInjector, SimulatedCrash  # noqa: E402


def _scores(n, seed, sentinel_frac=0.01):
    rng = np.random.default_rng(seed)
    s = rng.beta(0.1, 1.0, n).astype(np.float32)
    s[rng.random(n) < sentinel_frac] = -1.0
    return s


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with -m cuda")
    return torch.device("cuda")


def _hist_scores(card, n, fill, seed):
    """n scores for score_hist: "beta" as `_scores` draws them (1% -1
    sentinels), "uniform" on [0, 1), "clustered" in four bins of 4096 (one
    of 64), all drawn on the card from `seed`."""
    if fill == "beta":
        return torch.from_numpy(_scores(n, seed)).to(card)
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.rand(n, generator=g, device=card)
    if fill == "uniform":
        return u
    k = torch.tensor([517.0, 1024.0, 2900.0, 4000.0], device=card)[
        torch.randint(0, 4, (n,), generator=g, device=card)]
    return (k + 0.25 + 0.5 * u) / 4096


def _float64_sums(s, bins):
    """Per-bin float64 Σ sqrt(a) and Σ a over the records the sketch
    counts (the binning of `sh_ref.bin_index`)."""
    valid = s >= 0
    a = s.clamp(0.0, 1.0)[valid].double()
    ids = sh_ref.bin_index(s, bins)[valid]
    return [torch.bincount(ids, weights=w, minlength=bins)
            for w in (a.sqrt(), a)]


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["beta", "uniform", "clustered"])
@pytest.mark.parametrize("n,bins", [(1 << 22, 4096), (1 << 22, 64),
                                    (777, 4096), (5, 64),
                                    (100_000, sh_ops.MAX_BINS), (3000, 1)])
def test_score_hist_kernel_matches_plain(card, n, bins, fill):
    """Counts exactly the plain version's; sums within 1e-6 |e| + n 2^-32
    of float64 sums (the fixed point truncates each run below 2^-32) and,
    but for clustered scores, within the plain float32 version's own drift
    (rtol 4e-3, atol 1e-3); where every record falls in a few bins that
    scatter-add drifts past it, and float64 decides (chip_smoke.py's
    `HIST_INPUTS`). Bitwise identical on a second launch."""
    s = _hist_scores(card, n, fill, 7)
    got = sh_ops.score_hist(s, bins)
    again = sh_ops.score_hist(s, bins)
    plain = sh_ref.score_hist_ref(s, bins)
    exact = _float64_sums(s, bins)
    torch.cuda.synchronize()
    assert torch.equal(got[0], plain[0])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, p, e in zip(got[1:], plain[1:], exact):
        if fill != "clustered":
            torch.testing.assert_close(g, p, rtol=4e-3, atol=1e-3)
        assert bool(((g.double() - e).abs()
                     <= 1e-6 * e.abs() + n * 2.0 ** -32).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["beta", "uniform", "clustered"])
@pytest.mark.parametrize("n", [1 << 22, 1000, 1])
def test_score_hist_masses_match_float64_sums(card, n, fill):
    """The launch's chunk masses are within rel 1e-12 of torch.float64
    sums of the clipped scores and their float32 square roots
    (`chunk_masses_ref`), bitwise the same on a second launch, and leave
    the sketch as it is without them."""
    s = _hist_scores(card, n, fill, 5)
    m1 = torch.empty(2, dtype=torch.float64, device=card)
    m2 = torch.empty_like(m1)
    with_masses = sh_ops.score_hist(s, 4096, masses=m1)
    sh_ops.score_hist(s, 4096, masses=m2)
    alone = sh_ops.score_hist(s, 4096)
    want = sh_ref.chunk_masses_ref(s)
    torch.cuda.synchronize()
    assert torch.equal(m1, m2)
    assert all(torch.equal(a, b) for a, b in zip(with_masses, alone))
    torch.testing.assert_close(m1, want, rtol=1e-12, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", [(1, (1 << 22) - 1), (3, 1000),
                                     (2, (1 << 20) + 1), (1, 2)])
def test_score_hist_reads_unaligned_spans(card, start, n):
    """A span that starts off a 16-byte boundary, of a length that is not
    a multiple of 4, takes the kernel's scalar head and tail: counts and
    masses as on an aligned copy of the same scores (the masses within
    rel 1e-12: the records fall to other threads)."""
    base = _hist_scores(card, start + n, "beta", 9)
    span = base[start:start + n]
    copy = span.clone()
    assert span.data_ptr() % 16 and copy.data_ptr() % 16 == 0
    m_span = torch.empty(2, dtype=torch.float64, device=card)
    m_copy = torch.empty_like(m_span)
    got = sh_ops.score_hist(span, 64, masses=m_span)
    want = sh_ops.score_hist(copy, 64, masses=m_copy)
    plain = sh_ref.score_hist_ref(copy, 64)
    torch.cuda.synchronize()
    assert torch.equal(got[0], plain[0]) and torch.equal(want[0], plain[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=n * 2.0 ** -32)
    torch.testing.assert_close(m_span, m_copy, rtol=1e-12, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("own_streams", [False, True])
def test_score_hist_threads_at_once_match_serial(card, own_streams):
    """Eight threads launching on 16 chunks at once, on the default stream
    or each on its own, give each chunk the bits of a serial run: the
    sketch and the masses."""
    import concurrent.futures
    scores = _hist_scores(card, 16 << 18, "beta", 4)
    chunks = list(scores.view(16, -1))

    def one(c):
        m = torch.empty(2, dtype=torch.float64, device=card)
        h = sh_ops.score_hist(c, 4096, masses=m)
        return torch.cat(h).cpu(), m.cpu()

    def on_own_stream(c):
        with torch.cuda.stream(torch.cuda.Stream(card)):
            return one(c)

    serial = [one(c) for c in chunks]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        both = list(pool.map(on_own_stream if own_streams else one, chunks))
    for (h1, m1), (h2, m2) in zip(serial, both):
        assert torch.equal(h1, h2) and torch.equal(m1, m2)


@pytest.mark.cuda
def test_score_hist_uses_no_shared_compare_and_swap(card):
    """The compiled kernel's shared-memory atomics are 32-bit adds: no
    compare-and-swap loop (what a 64-bit shared atomicAdd compiles to on
    this card), read from its SASS with the toolkit's cuobjdump."""
    import pathlib
    import subprocess
    from repro_torch.kernels import _build
    sh_ops._lib()
    cuobjdump = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build._lib_path("score_hist"))],
                          capture_output=True, text=True, check=True).stdout
    shared = [next(t for t in ln.split() if t.startswith("ATOMS"))
              for ln in sass.splitlines() if "ATOMS" in ln]
    assert shared and all(op == "ATOMS.ADD" or op.startswith("ATOMS.POPC")
                          for op in shared), sorted(set(shared))
    assert "CAS" not in sass


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 8])
def test_card_build_reads_the_masses_back_once(card, workers):
    """A build on the card launches score_hist once a chunk and copies
    from the device three times: the chunk masses' one read-back and the
    two weight normalizers. Its sketch counts equal a CPU build's and its
    chunk masses are within rel 1e-12 of them."""
    ds = make_beta(400_000, 0.01, 1.0, seed=6)
    shards = np.array_split(ds.scores, 4)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 15,
                         device="cpu") as cpu:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            gpu = SelectionEngine(shards, num_bins=4096,
                                  chunk_records=1 << 15, workers=workers,
                                  clamp_workers=False, device=card)
            torch.cuda.synchronize()
        gpu.close()
        events = prof.key_averages()
        cuda = torch.autograd.DeviceType.CUDA
        launches = sum(e.count for e in events if e.device_type == cuda
                       and "hist_chunk" in e.key)
        d2h = sum(e.count for e in events if e.device_type == cuda
                  and "DtoH" in e.key)
        assert launches == cpu.plan.total_chunks
        assert d2h == 3
        assert torch.equal(gpu.sketch.counts.cpu(), cpu.sketch.counts)
        for a, b in zip(gpu._state.chunk_masses, cpu._state.chunk_masses):
            np.testing.assert_allclose(a.sum_sqrt, b.sum_sqrt, rtol=1e-12)
            np.testing.assert_allclose(a.sum_a, b.sum_a, rtol=1e-12)
            np.testing.assert_array_equal(a.sizes, b.sizes)


# Lengths: a few plain ones, those around the kernel's tile (one CTA's
# records) and deep look-backs: 2^27 records are 8,192 tiles.
_LENGTHS = {"0": lambda t: 0, "1": lambda t: 1, "1000": lambda t: 1000,
            "2048": lambda t: 2048, "2049": lambda t: 2049,
            "tile-1": lambda t: t - 1, "tile": lambda t: t,
            "tile+1": lambda t: t + 1, "2^22": lambda t: 1 << 22,
            "2^22+1": lambda t: (1 << 22) + 1, "2^27": lambda t: 1 << 27}


def _card_scores(card, n, fill, seed):
    """n scores: "beta" drawn as `_scores` draws them, then on the card
    "mixed" uniform with 1% -1 sentinels, "all" at or above 0.5, "none"
    below 0.5 or -1."""
    if fill == "beta":
        return torch.from_numpy(_scores(n, seed)).to(card)
    g = torch.Generator(device=card).manual_seed(seed)
    u = torch.rand(n, generator=g, device=card)
    if fill == "all":
        return 0.5 + 0.5 * u
    if fill == "none":
        return torch.where(u < 0.1, -1.0, 0.49 * u)
    return torch.where(torch.rand(n, generator=g, device=card) < 0.01,
                       -1.0, u)


@pytest.mark.cuda
@pytest.mark.parametrize("length", list(_LENGTHS))
@pytest.mark.parametrize("tau", [0.0, 0.5, 0.999, 1.01])
@pytest.mark.parametrize("fill", ["beta", "all", "none"])
def test_threshold_select_kernel_matches_plain(card, length, tau, fill):
    """Indices exactly the plain version's at every tile boundary and
    look-back depth, with everything or nothing selected;
    `threshold_count` (the same kernel without the scatter) is a 0-d
    tensor on the card equal to the selection's length."""
    n = _LENGTHS[length](ts_ops._lib()[1])
    s = _card_scores(card, n, fill, 3)
    got = ts_ops.threshold_select(s, tau)
    count = ts_ops.threshold_count(s, tau)
    want = ts_ref.threshold_select_ref(s, tau)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert count.dim() == 0 and count.device == s.device
    assert int(count) == want.numel()
    if fill == "all" and tau <= 0.5:
        assert got.numel() == n
    if fill == "none" and tau >= 0.5:
        assert got.numel() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(1 << 22) + 1, 1 << 27])
def test_threshold_select_kernel_repeats_bitwise(card, n):
    """Twenty launches give the same indices: tiles take tickets in no
    fixed order across launches, but each writes its fixed rank range."""
    s = _card_scores(card, n, "mixed", 11)
    first = ts_ops.threshold_select(s, 0.3)
    for _ in range(19):
        assert torch.equal(ts_ops.threshold_select(s, 0.3), first)


@pytest.mark.cuda
def test_threshold_select_reads_unaligned_spans(card):
    """A span that starts off a 16-byte boundary (a view of a shard) takes
    the kernel's scalar loads and selects the same records."""
    s = _card_scores(card, 100_003, "mixed", 5)
    for start in (1, 2, 3):
        part = s[start:]
        assert torch.equal(ts_ops.threshold_select(part, 0.4),
                           ts_ref.threshold_select_ref(part, 0.4))
        assert int(ts_ops.threshold_count(part, 0.4)) == \
            int((part >= 0.4).sum())


@pytest.mark.cuda
def test_card_engine_matches_cpu_engine(card):
    """From one corpus state the card's engine (kernels) and a CPU engine
    (plain versions) return the same tau, counts and indices."""
    ds = make_beta(300_000, 0.01, 1.0, seed=5)
    shards = np.array_split(ds.scores, 3)
    oracle = array_oracle(ds.labels)
    queries = [SUPGQuery(target="recall", gamma=0.9, budget=2000),
               SUPGQuery(target="precision", gamma=0.8, budget=2000),
               JointSUPGQuery(gamma_recall=0.8, stage_budget=2000)]
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 15,
                         device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=card,
                                       workers=4) as gpu:
        for q in queries:
            run = "run_joint" if isinstance(q, JointSUPGQuery) else "run"
            a = getattr(cpu, run)(R.PRNGKey(1), oracle, q)
            b = getattr(gpu, run)(R.PRNGKey(1), oracle, q)
            assert a.tau == b.tau
            np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
            for i in range(3):
                np.testing.assert_array_equal(a.indices(i), b.indices(i))


# The main path's plan: 2^22-record chunks (`chip_smoke.py` phase 3), two
# of them a shard.
_MAIN_CHUNK = 1 << 22


@pytest.mark.cuda
def test_card_chunk_cdf_repeats_bitwise_at_main_path_chunks(card):
    """`draw_sample`'s within-chunk resolve at the main path's 2^22-record
    chunks: `sampling.normalized_cdf` of a chunk's defensive probabilities
    on the card, and whole draws, give the same bits every time."""
    ds = make_beta(2 * _MAIN_CHUNK, 0.01, 1.0, seed=6)
    with SelectionEngine([ds.scores], num_bins=4096,
                         chunk_records=_MAIN_CHUNK, device=card,
                         workers=4) as eng:
        st = eng._state
        for start in (0, _MAIN_CHUNK):
            p = sampling.defensive_probs(
                eng._span(st.shards[0], start, start + _MAIN_CHUNK), "sqrt",
                st.z["sqrt"], eng.kappa, st.n_total)
            first = sampling.normalized_cdf(p)
            assert first.device.type == "cuda" and first.numel() == _MAIN_CHUNK
            for _ in range(8):
                assert torch.equal(sampling.normalized_cdf(p), first)
        idx, m = eng.draw_sample(R.PRNGKey(3), 4000)
        for _ in range(4):
            again = eng.draw_sample(R.PRNGKey(3), 4000)
            np.testing.assert_array_equal(again[0], idx)
            np.testing.assert_array_equal(again[1], m)


@pytest.mark.cuda
def test_card_draw_matches_cpu_engine_at_main_path_chunks(card):
    """From one corpus state, the card's `draw_sample` and a CPU engine's
    give the same records and weights at the main path's 2^22-record
    chunks, as RT and PT queries then give the same tau."""
    ds = make_beta(2 * _MAIN_CHUNK, 0.01, 1.0, seed=7)
    shards = np.array_split(ds.scores, 2)
    oracle = array_oracle(ds.labels)
    with SelectionEngine(shards, num_bins=4096, chunk_records=_MAIN_CHUNK,
                         device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=card,
                                       workers=4) as gpu:
        for key in (2, 9):
            a = cpu.draw_sample(R.PRNGKey(key), 3000)
            b = gpu.draw_sample(R.PRNGKey(key), 3000)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        for q in (SUPGQuery(target="recall", gamma=0.9, budget=2000),
                  SUPGQuery(target="precision", gamma=0.8, budget=2000)):
            assert cpu.run(R.PRNGKey(1), oracle, q).tau == \
                gpu.run(R.PRNGKey(1), oracle, q).tau


_LIVE_QUERIES = [SUPGQuery(target="recall", gamma=0.9, budget=2000),
                 SUPGQuery(target="precision", gamma=0.8, budget=2000),
                 JointSUPGQuery(gamma_recall=0.8, stage_budget=2000)]


def _same_selection(a, b):
    assert a.tau == b.tau
    np.testing.assert_array_equal(a.shard_counts, b.shard_counts)
    for i in range(a.num_shards):
        np.testing.assert_array_equal(a.indices(i), b.indices(i))


def _live_shards(card, n_shards=6, n=150_000, seed=8):
    """`n_shards` Beta(0.01, 1) shards on the card, and their labels."""
    ds = make_beta(n_shards * n, 0.01, 1.0, seed=seed)
    scores = torch.from_numpy(ds.scores).to(card)
    return list(scores.split(n)), ds.labels


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 8])
def test_card_append_equals_cold_build_bitwise(card, workers):
    """On the card, an engine over shards 0-2 with 3 and then 4-5 appended
    holds the bits of a cold build over all six: sketches, z, chunk masses
    and CDFs; score_hist launched exactly once per appended chunk; and
    RT/PT/JT through `run_many` give the cold build's results."""
    shards, labels = _live_shards(card)
    oracle = array_oracle(labels)
    kw = dict(num_bins=4096, chunk_records=1 << 15, workers=workers,
              clamp_workers=False, device=card)
    with SelectionEngine(shards, **kw) as cold, \
            SelectionEngine(shards[:3], **kw) as warm:
        plane = IngestPlane(warm)
        before = sh_ops.launches.count
        plane.append(shards[3])
        plane.append(shards[4:])
        torch.cuda.synchronize()
        appended = sum(-(-s.numel() // (1 << 15)) for s in shards[3:])
        assert sh_ops.launches.count - before == appended
        a, b = warm._state, cold._state
        assert a.z == b.z
        for x, y in zip(a.shard_sketches + [a.sketch],
                        b.shard_sketches + [b.sketch]):
            assert all(torch.equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a.chunk_masses, b.chunk_masses):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        for x, y in zip(a.sampling_cache[("sqrt", 0.1)],
                        b.sampling_cache[("sqrt", 0.1)]):
            assert x.mass == y.mass
            np.testing.assert_array_equal(x.cdf, y.cdf)
        assert torch.equal(a.flat, b.flat)
        key = R.PRNGKey(3)
        for x, y in zip(cold.run_many(key, oracle, _LIVE_QUERIES),
                        warm.run_many(key, oracle, _LIVE_QUERIES)):
            _same_selection(x, y)


@pytest.mark.cuda
def test_card_run_many_at_workers_8_equals_sequential_runs(card):
    """`run_many` at concurrency None on 8 workers (pool threads launching
    threshold_select at once, 8 walks fused a round) returns what
    sequential `run`/`run_joint` at workers 1 return on the split keys."""
    shards, labels = _live_shards(card, n_shards=4)
    oracle = array_oracle(labels)
    batch = [SUPGQuery(target="recall", gamma=0.9, budget=2000)] * 3 + [
        SUPGQuery(target="recall", gamma=0.85, budget=1500,
                  method="noci"),
        SUPGQuery(target="precision", gamma=0.8, budget=2000)] * 2 + [
        JointSUPGQuery(gamma_recall=0.8, stage_budget=2000)]
    key = R.PRNGKey(9)
    with SelectionEngine(shards, num_bins=4096, chunk_records=1 << 15,
                         workers=8, clamp_workers=False, device=card) as w8:
        with w8.session(oracle) as sess:
            handles = [sess.submit(q, key=k) for q, k in
                       zip(batch, R.split(key, len(batch)))]
            many = [h.result() for h in handles]
        assert sess.stats.fused_walks == len(batch)
        assert sess.stats.fused_spans < sess.stats.walk_spans
        for x, y in zip(w8.run_many(key, oracle, batch), many):
            _same_selection(x, y)
        state = w8._state
    with SelectionEngine.from_state(state, device=card, workers=1) as w1:
        for k, q, b in zip(R.split(key, len(batch)), batch, many):
            run = w1.run_joint if isinstance(q, JointSUPGQuery) else w1.run
            _same_selection(run(k, oracle, q), b)


@pytest.mark.cuda
def test_card_engine_with_an_append_matches_cpu_engine(card):
    """A card engine and a CPU engine from one state, each appending the
    same shard: the sketches' counts are equal and the chunk masses within
    rel 1e-12 (the card's sums are fixed point). From the card's appended
    state, the CPU engine answers RT/PT/JT with the card's tau, counts and
    indices."""
    shards, labels = _live_shards(card, n_shards=3)
    oracle = array_oracle(labels)
    with SelectionEngine([s.cpu() for s in shards[:2]], num_bins=4096,
                         chunk_records=1 << 15, device="cpu") as cpu, \
            SelectionEngine.from_state(cpu._state, device=card,
                                       workers=4) as gpu:
        IngestPlane(cpu).append(shards[2].cpu().numpy())
        IngestPlane(gpu).append(shards[2])
        assert torch.equal(gpu.sketch.counts.cpu(), cpu.sketch.counts)
        for a, b in zip(gpu._state.chunk_masses, cpu._state.chunk_masses):
            np.testing.assert_allclose(a.sum_sqrt, b.sum_sqrt, rtol=1e-12)
            np.testing.assert_allclose(a.sum_a, b.sum_a, rtol=1e-12)
            np.testing.assert_array_equal(a.sizes, b.sizes)
        with SelectionEngine.from_state(gpu._state, device="cpu") as host:
            assert host.epoch == gpu.epoch == 1
            for q in _LIVE_QUERIES:
                run = ("run_joint" if isinstance(q, JointSUPGQuery)
                       else "run")
                _same_selection(getattr(host, run)(R.PRNGKey(1), oracle, q),
                                getattr(gpu, run)(R.PRNGKey(1), oracle, q))


@pytest.mark.cuda
def test_card_gc_epochs_lowers_memory_allocated(card):
    """While an epoch is pinned its flat corpus stays on the card; once
    unpinned, `gc_epochs` frees it and `torch.cuda.memory_allocated()`
    falls by at least its bytes (4 a record) and its global sketch."""
    shards, _ = _live_shards(card, n_shards=3, n=1 << 20)
    with SelectionEngine(shards[:2], num_bins=4096, device=card) as eng:
        pinned = eng.pin()
        own = pinned.flat.numel() * 4 + 3 * 4 * eng.num_bins
        IngestPlane(eng).append(shards[2])
        torch.cuda.synchronize()
        assert eng.gc_epochs() == 0 and eng.epochs_live == 2
        before = torch.cuda.memory_allocated(card)
        eng.unpin(pinned)
        del pinned
        assert eng.gc_epochs() == 1 and eng.epochs_live == 1
        torch.cuda.synchronize()
        assert before - torch.cuda.memory_allocated(card) >= own


def _plain_attention(q, k, v, causal=True):
    """flash_attention's plain version in the kernel's (B,S,H,dh) layout."""
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal).transpose(1, 2)


# bf16 bar of flash_attention against its plain version, chip_smoke.py's
# (whose note gives the reason and the measurement): each output within
# 5e-3 + 2^-7 |plain| (one bf16 ulp for the two roundings of the output,
# plus p's rounding to bf16 before p·v, where the products cancel), and
# the whole within 5e-3 of ||plain||.
BF16_RTOL, BF16_ATOL, BF16_FRO_TOL = 2.0 ** -7, 5e-3, 5e-3


# Shapes: a few mixed ones, then lengths around the bf16 kernel's 128-row
# tiles at both head dims with smollm's, zamba2's and an MQA head layout.
_FLASH_SHAPES = [(2, 256, 8, 2, 64), (1, 128, 6, 1, 128),
                 (2, 1000, 15, 5, 64), (3, 77, 6, 3, 128),
                 (1, 1, 2, 1, 64)] + [
    (1 if s > 1000 else 2, s, h, kv, dh)
    for s in (1, 63, 127, 128, 129, 1000, 4096) for dh in (64, 128)
    for h, kv in ((15, 5), (32, 32), (8, 1))] + [
    # dh 128 at the GQA ratios of the dense and MoE configs' attention:
    # llama4-maverick's 40/8 and yi-6b's and chameleon-34b's 32/4, 64/8
    (1 if s > 1000 else 2, s, h, kv, 128)
    for s in (129, 1000, 4096) for h, kv in ((40, 8), (32, 4), (64, 8))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,dh", _FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_kernel_matches_plain(card, b, s, h, kv, dh, causal,
                                              dtype):
    """Within the bf16 bar above, or in float32 within the reference's own
    kernel-vs-ref tolerance (tests/test_kernels.py, 2e-5); bitwise
    identical across launches."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q = torch.randn(b, s, h, dh, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, dh, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, dh, generator=g, device=card).to(dtype)
    before = fa_ops.launches.count
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = _plain_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_ops.launches.count == before + 2
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.bfloat16:
        plain = plain.float()
        torch.testing.assert_close(got.float(), plain, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)
        assert float((got.float() - plain).norm()) \
            <= BF16_FRO_TOL * float(plain.norm())
    else:
        torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_narrow_model_scores_through_the_kernel_match_plain(card,
                                                            monkeypatch):
    """A two-layer float32 model at head_dim 64: one kernel launch a layer,
    and scores within rtol 1e-4 of attention by the plain version (the
    tolerance of the CPU parity tests against the JAX package)."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-360m"),
                              d_model=192, num_heads=3, num_kv_heads=1,
                              head_dim=64, d_ff=256, vocab_size=512)
    g = torch.Generator(device=card).manual_seed(0)
    m = model.init(cfg, generator=g, device=card)
    tokens = np.random.default_rng(0).integers(0, 512, (8, 100))
    before = fa_ops.launches.count
    got = model.proxy_scores(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    want = model.proxy_scores(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_narrow_bf16_model_logits_through_the_kernel_match_plain(
        card, monkeypatch, seed):
    """The same narrow model in bf16: last-position logits within 6e-3 of
    their largest magnitude of attention by the plain version. bf16 rounds
    each layer's output, and the kernel's roundings differ from the plain
    version's at a few outputs; over these seeds this model measured 1.3e-3
    to 2.1e-3 on an H100, as far as the same model with plain attention
    lies from its float32 copy. The tolerance is three times the largest."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-360m"),
                              d_model=192, num_heads=3, num_kv_heads=1,
                              head_dim=64, d_ff=256, vocab_size=512,
                              dtype="bfloat16")
    g = torch.Generator(device=card).manual_seed(seed)
    m = model.init(cfg, generator=g, device=card)
    tokens = np.random.default_rng(seed).integers(0, 512, (8, 100))
    before = fa_ops.launches.count
    got = model.last_logits(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    want = model.last_logits(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) \
        <= 6e-3 * float(want.abs().max())


# (B, S, H, KV) at MLA's (dh, dv) = (192, 128): lengths around the 128-row
# tiles, S = 1, a GQA layout (the kernel takes one; MLA has H = KV) and
# deepseek-v2's prefill at 16 of its 128 heads
_MLA_FLASH_SHAPES = [(2, 1, 4, 4), (2, 127, 8, 8), (2, 129, 8, 8),
                     (1, 1000, 16, 16), (2, 300, 8, 2), (1, 4096, 16, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv", _MLA_FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_192_128_kernel_matches_plain(card, b, s, h, kv,
                                                      causal, dtype):
    """q and k at head dim 192, v at 128 (MLA's prefill): o (B,S,H,128)
    within the bf16 bar above, or in float32 within 2e-5, of the plain
    version; bitwise identical across launches."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q = torch.randn(b, s, h, 192, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, 192, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, 128, generator=g, device=card).to(dtype)
    before = fa_ops.launches.count
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    plain = _plain_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa_ops.launches.count == before + 2
    assert got.dtype == dtype and got.shape == (b, s, h, 128)
    if dtype == torch.bfloat16:
        plain = plain.float()
        torch.testing.assert_close(got.float(), plain, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)
        assert float((got.float() - plain).norm()) \
            <= BF16_FRO_TOL * float(plain.norm())
    else:
        torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv", [(192, 192), (192, 64), (128, 64),
                                   (96, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_refuses_other_head_dim_pairs_on_the_card(
        card, dh, dv, dtype):
    """A (dh, dv) pair with no kernel instance raises on CUDA tensors and
    launches nothing."""
    q = torch.zeros(1, 64, 2, dh, dtype=dtype, device=card)
    v = torch.zeros(1, 64, 2, dv, dtype=dtype, device=card)
    before = fa_ops.launches.count
    with pytest.raises(ValueError, match="head_dim, v_dim"):
        fa_ops.flash_attention(q, q, v)
    assert fa_ops.launches.count == before


# Sk >= Sq: (B, Sk, H, KV, dh, dv) and the query rows [lo, Sk) of each
# case; in bf16 Sk - Sq = lo is a multiple of 128 when causal.
_LONG_KEYS = [(2, 1024, 6, 2, 64, 64, (256, 512, 768)),
              (1, 2048, 8, 4, 128, 128, (1024,)),
              (1, 1024, 8, 8, 192, 128, (512, 896)),
              (2, 1000, 15, 5, 64, 64, (128, 512))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sk,h,kv,dh,dv,cuts", _LONG_KEYS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_keys_longer_than_queries(card, b, sk, h, kv, dh,
                                                  dv, cuts, dtype):
    """Query rows [lo, Sk) against all Sk keys, causal (row i at position
    lo + i) and not: within the bars above of the plain version, and the
    same bits as those rows of one launch over all Sk rows (the same key
    tiles, in the same order, for each row). float32 takes any offset,
    bf16 causal refuses one that is not a multiple of 128."""
    g = torch.Generator(device=card).manual_seed(sk + dh)
    q = torch.randn(b, sk, h, dh, generator=g, device=card).to(dtype)
    k = torch.randn(b, sk, kv, dh, generator=g, device=card).to(dtype)
    v = torch.randn(b, sk, kv, dv, generator=g, device=card).to(dtype)
    for causal in (True, False):
        full = fa_ops.flash_attention(q, k, v, causal=causal)
        for lo in cuts:
            part = q[:, lo:].contiguous()
            got = fa_ops.flash_attention(part, k, v, causal=causal)
            plain = _plain_attention(part, k, v, causal)
            assert torch.equal(got, full[:, lo:]), (causal, lo)
            if dtype == torch.bfloat16:
                plain = plain.float()
                torch.testing.assert_close(got.float(), plain,
                                           atol=BF16_ATOL, rtol=BF16_RTOL)
            else:
                torch.testing.assert_close(got, plain, atol=2e-5, rtol=2e-5)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="multiple of 128"):
            fa_ops.flash_attention(q[:, 100:].contiguous(), k, v)
    else:
        got = fa_ops.flash_attention(q[:, 100:].contiguous(), k, v)
        assert torch.equal(got, fa_ops.flash_attention(q, k, v)[:, 100:])


@pytest.mark.cuda
def test_backward_kernel_raises_on_keys_longer_than_queries(card):
    """The backward kernel takes Sk = S only: at Sk > S it raises before
    any launch (the CPU's plain backward takes the offset)."""
    q = torch.randn(1, 128, 4, 64, device=card, dtype=torch.bfloat16)
    k = torch.randn(1, 256, 4, 64, device=card, dtype=torch.bfloat16)
    o, lse = fa_ops.flash_attention_fwd(q, k, k)
    before = fa_ops.bwd_launches.count
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa_ops.flash_attention_bwd(q, k, k, o, o, lse=lse)
    with pytest.raises(ValueError, match="as many keys as queries"):
        fa_ops.check_backward(64, 64, 128, 256)
    assert fa_ops.bwd_launches.count == before


@pytest.mark.cuda
def test_narrow_mla_model_logits_through_the_kernel_match_plain(
        card, monkeypatch):
    """A two-layer float32 MLA + MoE model at deepseek-v2's head dims (q·k
    at 192, v at 128) and narrow widths: one kernel launch a layer, and
    logits within 2e-5 of their largest magnitude of attention by the
    plain version (the CPU parity tests' bar against the JAX package)."""
    cfg = dataclasses.replace(configs.get_smoke_config("deepseek-v2-236b"),
                              d_model=256, num_heads=4, num_kv_heads=4,
                              kv_lora_rank=64, q_lora_rank=96,
                              qk_nope_head_dim=128, qk_rope_head_dim=64,
                              v_head_dim=128)
    g = torch.Generator(device=card).manual_seed(0)
    m = model.init(cfg, generator=g, device=card)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 200))
    before = fa_ops.launches.count
    got = model.apply_train(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    want = model.apply_train(m, tokens)
    assert fa_ops.launches.count == before + cfg.num_layers
    assert float((got - want).abs().max()) \
        <= 2e-5 * float(want.abs().max())


@pytest.mark.cuda
def test_mla_decode_on_the_card_matches_cpu(card):
    """Six absorbed-latent decode steps of deepseek-v2's float32 smoke model
    on the card against the same weights and caches on the CPU, rows at
    their own positions: logits within 2e-5 of the largest |logit| each
    step, the latent caches likewise after the last."""
    cfg, cpu_model, card_model = _cpu_and_card("deepseek-v2-236b", card, 3)
    caches = {where: model.init_caches(cfg, 3, 12, torch.float32,
                                       device=dev)
              for where, dev in (("cpu", "cpu"), ("card", card))}
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 6))
    for i in range(6):
        pos = [i, i + 4, 11 - i]
        want, _ = model.apply_decode(cpu_model, tokens[:, i:i + 1],
                                     caches["cpu"], pos)
        got, _ = model.apply_decode(card_model, tokens[:, i:i + 1],
                                    caches["card"], pos)
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=2e-5 * float(want.abs().max()))
    for name, entries in caches["cpu"].items():
        for want, got in zip(entries, caches["card"][name]):
            for k in ("c", "k_rope"):
                torch.testing.assert_close(
                    got[k].cpu(), want[k], rtol=0,
                    atol=2e-5 * float(want[k].abs().max()))


def _scan_inputs(card, b, h, s, dk, dv, seed, w_const=None):
    """The reference's test law (tests/test_kernels.py): q, k, v normal at
    scale 0.5, w = sigmoid(normal + 2.5) (about 0.92) or `w_const`,
    u normal at scale 0.3; drawn with numpy."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, h, s, dk)) * 0.5 for _ in range(2))
    v = rng.standard_normal((b, h, s, dv)) * 0.5
    w = (1 / (1 + np.exp(-(rng.standard_normal((b, h, s, dk)) + 2.5)))
         if w_const is None else np.full((b, h, s, dk), w_const))
    u = rng.standard_normal((h, dk)) * 0.3
    return [torch.tensor(x, dtype=torch.float32, device=card)
            for x in (q, k, v, w, u)]


def _mamba_scan_inputs(card, b, h, s, n, hd, seed, law, dtype):
    """Mamba2's layout as `mamba_block` hands it over: B and C (B,S,N)
    normal in `dtype`, shared by the heads, and the decay (B,H,S) over N,
    as stride-0 views; v = x · dt, a (B,S,H,hd) float32 tensor seen as
    (B,H,S,hd). Decays exp(-dt), dt = softplus(normal · 0.88) (Zamba2's
    law), or with ``law="tiny"`` 1e-6 in the first 8 steps of every 16 and
    near 1 after; u normal at scale 0.3."""
    rng = np.random.default_rng(seed)
    bc = torch.tensor(rng.standard_normal((b, s, 2 * n)), device=card)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) * 0.88))
    a = np.exp(-dt)
    if law == "tiny":
        a = np.where((np.arange(s) % 16 < 8)[None, :, None], 1e-6,
                     1 - 1e-3 * rng.random((b, s, h)))
    x = rng.standard_normal((b, s, h, hd)) * dt[..., None]
    v = torch.tensor(x, dtype=torch.float32, device=card).transpose(1, 2)
    w = torch.tensor(a, dtype=torch.float32, device=card).transpose(1, 2)
    bc = bc.to(dtype)
    u = torch.tensor(rng.standard_normal((h, n)) * 0.3, dtype=torch.float32,
                     device=card)
    return (bc[..., n:][:, None].expand(b, h, s, n),
            bc[..., :n][:, None].expand(b, h, s, n), v,
            w[..., None].expand(b, h, s, n), u)


# linear_scan against its plain version: the reference's atol = 1e-4
# (tests/test_kernels.py) plus rtol 1e-5. Both kernels compute chunked forms
# with split-TF32 products: on Zamba2's bf16 path the chunked kernel lies
# within 4.4e-7 of the largest |o| of the plain version (chip_smoke.py
# phase 9, --seed 0, 1, 2, H100 80GB HBM3 at 700 W), and phase 9 holds the
# channel kernel to 1e-6 of the largest |output|.
SCAN_TOL = dict(atol=1e-4, rtol=1e-5)
# With bf16 v, o comes back in bf16: within one bf16 ulp of the float64
# recurrence's o (the rounding of o, half an ulp, and the kernel's float32
# error beside it) plus SCAN_REL of its largest |o|, phase 9's bar; the
# float32 state within SCAN_REL of its largest |value|.
SCAN_REL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,dk,dv,w_const,layout", [
    (2, 2, 128, 16, 24, None, "plain"), (1, 1, 128, 8, 8, None, "plain"),
    (2, 3, 1000, 64, 64, None, "plain"), (2, 3, 1, 64, 64, None, "plain"),
    (1, 4, 300, 64, 64, 0.05, "plain"), (3, 2, 77, 33, 40, None, "plain"),
    (2, 3, 63, 64, 64, None, "mamba"), (2, 3, 64, 64, 64, None, "mamba"),
    (2, 3, 65, 64, 64, None, "mamba"), (2, 3, 1, 64, 64, None, "mamba"),
    (2, 3, 300, 64, 64, "tiny", "mamba"),
    (2, 3, 200, 64, 64, None, "mamba f32"),
    (2, 3, 130, 16, 24, None, "mamba"),
    (4, 64, 128, 64, 64, None, "mamba"),
    (1, 64, 512, 64, 64, None, "mamba")])
@pytest.mark.parametrize("bonus", [False, True])
def test_linear_scan_kernel_matches_plain(card, b, h, s, dk, dv, w_const,
                                          layout, bonus):
    """Both modes, the reference's shapes, ragged S, S = 1 and w = 0.05
    (below the Pallas kernel's log-decay floor); Mamba2's views through
    the chunked kernel at a chunk's edges (S = 63, 64, 65), S = 1, decays
    of 1e-6 early in each chunk, float32 q and k, dk, dv below 64, and
    zamba2-1.2b's scoring and prefill layouts at small B (with u, the
    same views go to the channel kernel); bitwise identical across
    launches."""
    if layout == "plain":
        q, k, v, w, u = _scan_inputs(card, b, h, s, dk, dv, s + dk, w_const)
    else:
        q, k, v, w, u = _mamba_scan_inputs(
            card, b, h, s, dk, dv, s + dk, w_const,
            torch.float32 if layout == "mamba f32" else torch.bfloat16)
    uu = u if bonus else None
    route = "chunked" if layout != "plain" and not bonus else "channel"
    assert ls_ops.route(q, k, v, w, uu) == route
    before = ls_ops.launches.count
    on_route = ls_ops.launches.routes[route]
    o, st = ls_ops.linear_scan(q, k, v, w, uu)
    o2, st2 = ls_ops.linear_scan(q, k, v, w, uu)
    po, pst = ls_ref.linear_scan_ref(q, k, v, w, uu)
    torch.cuda.synchronize()
    assert ls_ops.launches.count == before + 2
    assert ls_ops.launches.routes[route] == on_route + 2
    assert o.shape == v.shape and st.shape == (b, h, dk, dv)
    assert st.dtype == torch.float32
    torch.testing.assert_close(o, po, **SCAN_TOL)
    torch.testing.assert_close(st, pst, **SCAN_TOL)
    assert torch.equal(o, o2) and torch.equal(st, st2)


def _rwkv_scan_inputs(card, b, h, s, d, seed, vdtype):
    """RWKV6's layout as `time_mix` hands it over: r, k and v (B,S,H,hd)
    seen as (B,H,S,hd), r and k bf16, v in `vdtype`, the decay per channel
    exp(-exp(w0 + 0.5 · normal)) around w0 = -6 in float32, the bonus u
    at scale 0.1."""
    rng = np.random.default_rng(seed)

    def heads(x, dtype):
        return torch.tensor(x, dtype=torch.float32, device=card).to(
            dtype).transpose(1, 2)
    r = heads(rng.standard_normal((b, s, h, d)), torch.bfloat16)
    k = heads(rng.standard_normal((b, s, h, d)) / 8, torch.bfloat16)
    v = heads(rng.standard_normal((b, s, h, d)), vdtype)
    w = heads(np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal((b, s, h, d)))),
              torch.float32)
    u = torch.tensor(rng.standard_normal((h, d)) * 0.1, dtype=torch.float32,
                     device=card)
    return r, k, v, w, u


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (2^-7 of its power of two)."""
    return torch.pow(2.0, torch.floor(torch.log2(x.abs().clamp_min(
        1e-30))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "rwkv", "rwkv ragged", "rwkv S=1", "plain 33x40", "plain 16x24",
    "plain w=0.05", "float32 q"])
@pytest.mark.parametrize("bonus", [False, True])
def test_linear_scan_kernel_takes_bf16_v(card, case, bonus):
    """bf16 v through the channel kernel, o back in bf16: RWKV6's views at
    S = 300, a ragged S = 1000 and S = 1; the reference's law at dk, dv =
    33 x 40 and 16 x 24 and w = 0.05; float32 q and k. o within one bf16
    ulp of the float64 recurrence's plus SCAN_REL of its largest |o|, the
    float32 state within SCAN_REL of its largest |value|; bitwise
    identical across launches."""
    if case.startswith("rwkv"):
        s = {"rwkv": 300, "rwkv ragged": 1000, "rwkv S=1": 1}[case]
        q, k, v, w, u = _rwkv_scan_inputs(card, 2, 8, s, 64, s, torch.bfloat16)
    else:
        shape = {"plain 33x40": (3, 2, 77, 33, 40),
                 "plain 16x24": (2, 2, 130, 16, 24),
                 "plain w=0.05": (1, 4, 300, 64, 64),
                 "float32 q": (2, 3, 200, 64, 64)}[case]
        q, k, v, w, u = _scan_inputs(card, *shape, sum(shape),
                                     0.05 if case == "plain w=0.05" else None)
        v = v.to(torch.bfloat16)
        if case != "float32 q":
            q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
    uu = u if bonus else None
    assert ls_ops.route(q, k, v, w, uu) == "channel"
    on_route = ls_ops.launches.routes["channel"]
    o, st = ls_ops.linear_scan(q, k, v, w, uu)
    o2, st2 = ls_ops.linear_scan(q, k, v, w, uu)
    ao, ast = ls_ref.linear_scan_ref(q, k, v.double(), w, uu,
                                     compute_dtype=torch.float64)
    torch.cuda.synchronize()
    assert ls_ops.launches.routes["channel"] == on_route + 2
    assert o.dtype == torch.bfloat16 and o.shape == v.shape
    assert o.stride() == v.stride() and st.dtype == torch.float32
    err = (o.double() - ao).abs()
    assert bool((err <= _bf16_ulp(ao) + SCAN_REL * ao.abs().max()).all())
    assert float((st.double() - ast).abs().max()) <= \
        SCAN_REL * float(ast.abs().max())
    assert torch.equal(o, o2) and torch.equal(st, st2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_linear_scan_kernel_reads_mamba_broadcast_views(card, dtype):
    """Mamba2's layout: B and C (B,S,N) shared by the heads and a scalar
    decay per head, as stride-0 views, v a transposed float32 view; they
    take the chunked kernel, o comes back in v's layout and matches the
    plain version on materialized copies."""
    b, s, h, n, hd = 2, 200, 6, 64, 32
    g = torch.Generator(device=card).manual_seed(3)
    bc = torch.randn(b, s, 2 * n, generator=g, device=card).to(dtype)
    a = torch.rand(b, s, h, generator=g, device=card) * 0.5 + 0.5
    v = torch.randn(b, s, h, hd, generator=g, device=card).transpose(1, 2)
    q = bc[..., n:][:, None].expand(b, h, s, n)
    k = bc[..., :n][:, None].expand(b, h, s, n)
    w = a.transpose(1, 2)[..., None].expand(b, h, s, n)
    chunked = ls_ops.launches.routes["chunked"]
    o, st = ls_ops.linear_scan(q, k, v, w)
    assert ls_ops.launches.routes["chunked"] == chunked + 1
    po, pst = ls_ref.linear_scan_ref(q.contiguous(), k.contiguous(),
                                     v.contiguous(), w.contiguous())
    torch.cuda.synchronize()
    assert o.stride() == v.stride() and o.dtype == torch.float32
    torch.testing.assert_close(o, po, **SCAN_TOL)
    torch.testing.assert_close(st, pst, **SCAN_TOL)


def _narrow_zamba(dtype):
    """Zamba2's smoke layout (two super-blocks of two Mamba2 blocks and the
    shared block, one tail block) at widths the kernels take: attention
    head_dim 64, state dim 64."""
    return dataclasses.replace(configs.get_smoke_config("zamba2-1.2b"),
                               d_model=128, num_heads=2, num_kv_heads=2,
                               head_dim=64, d_ff=256, vocab_size=512,
                               ssm_state_dim=64,
                               ssm_head_dim=32, dtype=dtype)


def _plain_paths(monkeypatch):
    monkeypatch.setattr(attention, "flash_attention", _plain_attention)
    monkeypatch.setattr(mamba, "linear_scan", ls_ref.linear_scan_ref)


@pytest.mark.cuda
def test_narrow_zamba_scores_through_the_kernels_match_plain(card,
                                                             monkeypatch):
    """float32: one linear_scan launch a Mamba2 block and one
    flash_attention launch a shared-block run; scores within rtol 1e-4 of
    the plain versions (the CPU parity tests' tolerance)."""
    cfg = _narrow_zamba("float32")
    m = model.init(cfg, generator=torch.Generator(device=card).manual_seed(0),
                   device=card)
    tokens = np.random.default_rng(0).integers(0, 512, (8, 100))
    ls0, fa0 = ls_ops.launches.count, fa_ops.launches.count
    got = model.proxy_scores(m, tokens)
    assert ls_ops.launches.count == ls0 + cfg.num_layers
    assert fa_ops.launches.count == fa0 + 2
    _plain_paths(monkeypatch)
    want = model.proxy_scores(m, tokens)
    assert (ls_ops.launches.count, fa_ops.launches.count) == \
        (ls0 + cfg.num_layers, fa0 + 2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_narrow_bf16_zamba_logits_through_the_kernels_match_plain(
        card, monkeypatch, seed):
    """bf16: last-position logits within 3.5e-2 of their largest magnitude
    of the plain versions. Both compute the scan in float32 from the same
    bf16 inputs, but bf16 rounds each block's output, and the kernels'
    roundings differ from the plain versions' at a few outputs; the
    untied head's logits are small (about 1), so a rounding is large
    beside them. Over these seeds this model measured 8.3e-3 to 1.18e-2 on
    an H100 80GB HBM3 at 700 W; the tolerance is three times the
    largest."""
    cfg = _narrow_zamba("bfloat16")
    m = model.init(cfg, generator=torch.Generator(device=card)
                   .manual_seed(seed), device=card)
    tokens = np.random.default_rng(seed).integers(0, 512, (8, 100))
    got = model.last_logits(m, tokens)
    _plain_paths(monkeypatch)
    want = model.last_logits(m, tokens)
    assert bool(torch.isfinite(got).all())
    ratio = float((got - want).abs().max()) / float(want.abs().max())
    assert ratio <= 3.5e-2


def _durable_server(card, root, tag, shards, labels, crash_at=None):
    """A durable server on the card over shards 0-2: two standing queries
    on BitmaskStore sinks, certified and snapshotted, then shards 3 and 4
    appended through the journal (a `CrashInjector` at `crash_at`)."""
    srv = SelectionServer(
        SelectionEngine(shards[:3], num_bins=4096, chunk_records=1 << 15,
                        device=card),
        array_oracle(labels), durable=root / f"{tag}_durable",
        quotas={"t": 10**7})
    sqs = []
    for j, q in enumerate(_LIVE_QUERIES[:2]):
        sqs.append(srv.subscribe(q, tenant="t", key=R.PRNGKey(20 + j),
                                 sink=BitmaskStore(root / f"{tag}_{j}.bits")))
        sqs[-1].wait_certified(timeout=300)
    srv.snapshot()
    with CrashInjector(crash_at or {}) as inj:
        for epoch, part in enumerate(shards[3:5], start=1):
            try:
                srv.append(part)
            except SimulatedCrash:
                break
            _caught_up(srv, epoch)
    assert inj.fired == bool(crash_at)
    return srv


def _caught_up(srv, epoch, timeout=300):
    import time
    deadline = time.monotonic() + timeout
    while not (all(sq.epoch >= epoch and not sq._busy
                   for sq in srv._registry.standing)
               and not srv._registry.has_pending()):
        assert srv._fatal is None and time.monotonic() < deadline
        time.sleep(0.005)


@pytest.mark.cuda
def test_card_server_crash_restore_equals_the_uncrashed_run(card,
                                                           tmp_path):
    """A durable server on the card killed at `post_journal_pre_install`
    on its second append, abandoned (its corpus leaves the card) and
    restored with no device named (so on cuda): 2 epochs and 2 standing
    queries recovered, score_hist once per replayed chunk,
    threshold_select once per appended chunk per standing query in the
    catch-ups, and the uncrashed run's taus, sink bits and charge."""
    shards, labels = _live_shards(card, n_shards=5)
    srv = _durable_server(card, tmp_path, "ref", shards, labels)
    want = ([sq.tau for sq in srv._registry.standing],
            [np.fromfile(sq.sink.path, np.uint8)
             for sq in srv._registry.standing],
            srv.stats().tenants["t"].oracle_charged)
    srv.close()
    srv = _durable_server(card, tmp_path, "crash", shards, labels,
                          {"post_journal_pre_install": 1})
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    held = srv.engine._state.flat.numel() * 4
    srv.close(abandon=True)
    del srv
    torch.cuda.synchronize()
    assert before - torch.cuda.memory_allocated(card) >= held
    hist0, sel0 = sh_ops.launches.count, ts_ops.launches.count
    srv = SelectionServer.restore(
        tmp_path / "crash_durable", array_oracle(labels),
        base_shards=shards[:3],
        engine_kw={"num_bins": 4096, "chunk_records": 1 << 15},
        quotas={"t": 10**7})
    try:
        assert srv.engine.device.type == "cuda"
        assert (srv.recovered_epochs, srv.recovered_queries) == (2, 2)
        _caught_up(srv, 2)
        chunks = [-(-s.numel() // (1 << 15)) for s in shards[:5]]
        assert sh_ops.launches.count - hist0 == sum(chunks)  # build+replay
        assert ts_ops.launches.count - sel0 == 2 * sum(chunks[3:])
        got = ([sq.tau for sq in srv._registry.standing],
               [np.fromfile(sq.sink.path, np.uint8)
                for sq in srv._registry.standing],
               srv.stats().tenants["t"].oracle_charged)
    finally:
        srv.close()
    assert got[0] == want[0] and got[2] == want[2]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)


# -- phase 15 at a small size: the single-array path, the distributed plane --

_ARRAY_QUERIES = {
    "rt-is": SUPGQuery(target="recall", gamma=0.9, budget=2000),
    "rt-uniform": SUPGQuery(target="recall", gamma=0.9, budget=2000,
                            method="uniform"),
    "rt-noci": SUPGQuery(target="recall", gamma=0.9, budget=2000,
                         method="noci"),
    "pt-two-stage": SUPGQuery(target="precision", gamma=0.8, budget=2000),
    "pt-one-stage": SUPGQuery(target="precision", gamma=0.8, budget=2000,
                              two_stage=False),
    "jt": None,
}
_ARRAY_LAUNCHES = {"rt-is": 1, "rt-uniform": 1, "rt-noci": 1,
                   "pt-two-stage": 2, "pt-one-stage": 1, "jt": 1}


def _recorded_query(name, key, scores, labels):
    seen = []

    def fn(idx):
        idx = np.asarray(idx, np.int64)
        seen.append(idx[labels[idx] > 0.5])
        return labels[idx]

    dev = scores.device
    if name == "jt":
        res = qpath.run_joint_query(key, scores, fn, 0.9, 1.0,
                                    stage_budget=2000, device=dev)
    else:
        res = qpath.run_query(key, scores, fn, _ARRAY_QUERIES[name],
                              device=dev)
    return res, np.unique(np.concatenate(seen))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_ARRAY_QUERIES))
def test_card_run_query_through_the_kernels_matches_plain(card, name):
    """On the card (the default device): selected is union(R1, {A >= tau})
    exactly, the threshold kernels launch as the path says, the budget
    holds, and the same query with the kernels' plain versions gives the
    same tau and selection."""
    ds = make_beta(400_000, 0.01, 1.0, seed=15)
    scores = torch.from_numpy(ds.scores).to(card)
    for k in range(2):
        ts_ops.launches.reset()
        res, pos = _recorded_query(name, R.PRNGKey(k), scores, ds.labels)
        assert ts_ops.launches.count == _ARRAY_LAUNCHES[name]
        tau = res.stage2_tau if name == "jt" else res.tau
        r2 = torch.nonzero(scores >= tau).reshape(-1).cpu().numpy()
        if name == "jt":
            want = np.union1d(pos, r2[ds.labels[r2] > 0.5])
        else:
            assert res.oracle_calls <= 2000
            assert res.n_sampled_positives == pos.size
            want = np.union1d(pos, r2)
        np.testing.assert_array_equal(res.selected, want)
        with mock.patch.object(ts_ops, "threshold_select",
                               ts_ref.threshold_select_ref), \
                mock.patch.object(ts_ops, "threshold_count",
                                  ts_ref.threshold_count_ref):
            plain, _ = _recorded_query(name, R.PRNGKey(k), scores,
                                       ds.labels)
        assert ts_ops.launches.count == _ARRAY_LAUNCHES[name]
        assert (plain.stage2_tau if name == "jt" else plain.tau) == tau
        np.testing.assert_array_equal(plain.selected, res.selected)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_ARRAY_QUERIES))
def test_card_run_query_matches_cpu(card, name):
    """The card draws with the CPU's bits (the blocked CDF, float64 square
    roots and FMAs, IEEE division), so a query on the card equals the same
    query on the CPU: tau, selection and oracle calls."""
    ds = make_beta(400_000, 0.01, 1.0, seed=16)
    for k in range(2):
        got, _ = _recorded_query(name, R.PRNGKey(k),
                                 torch.from_numpy(ds.scores).to(card),
                                 ds.labels)
        want, _ = _recorded_query(name, R.PRNGKey(k),
                                  torch.from_numpy(ds.scores), ds.labels)
        for f in ("tau", "stage2_tau", "corrected_target", "oracle_calls"):
            assert getattr(got, f, None) == getattr(want, f, None), f
        np.testing.assert_array_equal(got.selected, want.selected)


@pytest.mark.cuda
def test_card_selection_below_zero(card):
    """threshold_select keeps A >= max(tau, 0); the query path's R2 and
    |D'| add the records in [tau, 0) where tau < 0."""
    s = np.random.default_rng(9).uniform(-1, 1, 300_000).astype(np.float32)
    t = torch.from_numpy(s).to(card)
    for tau in (float("-inf"), -0.5, -1e-30, 0.0, 0.5):
        want = np.nonzero(s >= tau)[0]
        np.testing.assert_array_equal(
            ts_ops.select_at_least(t, tau).cpu().numpy(), want)
        assert int(ts_ops.count_at_least(t, tau)) == want.size


def _exact_hist(scores, bins):
    s = scores[scores >= 0]
    ids = sh_ref.bin_index(s, bins)
    a = torch.clamp(s, 0.0, 1.0).double()
    return torch.bincount(ids, minlength=bins), [
        torch.zeros(bins, dtype=torch.float64, device=s.device)
        .index_add_(0, ids, v) for v in (torch.sqrt(a), a)]


@pytest.mark.cuda
def test_card_distributed_plane_on_nccl_world_one(card, tmp_path):
    import torch.distributed as dist
    scores = torch.from_numpy(_scores(1 << 22, 16)).to(card)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        assert dist.get_backend() == "nccl"
        sh_ops.launches.reset()
        ts_ops.launches.reset()
        sketch = dplane.global_sketch(scores)
        totals = dplane.shard_weight_totals(scores)
        count = dplane.global_selection_count(scores, 0.3)
        assert (sh_ops.launches.count, ts_ops.launches.count) == (2, 1)
    finally:
        dist.destroy_process_group()
    for a, b in zip(sketch, binned.build_sketch(scores)):
        assert torch.equal(a, b)
    exact, _ = _exact_hist(scores, binned.DEFAULT_BINS)
    assert torch.equal(sketch.counts, exact.float())
    assert count.dtype == torch.int64
    assert int(count) == int((scores >= 0.3).sum())
    want = float(torch.sqrt(torch.clamp(scores, 0, 1).double()).sum())
    assert abs(float(totals[0, 0]) - want) <= 1e-6 * want
    assert float(totals[0, 1]) == scores.numel()


def _gloo_card_rank(rank, world, root):
    import torch.distributed as dist
    root = pathlib.Path(root)
    scores = torch.from_numpy(_scores(1 << 22, 17)).to("cuda")
    half = torch.tensor_split(scores, world)[rank].clone()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "store"), world), rank=rank, world_size=world)
    try:
        out = {"sketch": torch.stack(list(dplane.global_sketch(half))).cpu(),
               "totals": dplane.shard_weight_totals(half).cpu(),
               "count": int(dplane.global_selection_count(half, 0.3)),
               "launches": (sh_ops.launches.count, ts_ops.launches.count)}
    finally:
        dist.destroy_process_group()
    torch.save(out, root / f"rank{rank}.pt")


@pytest.mark.cuda
def test_card_distributed_plane_two_gloo_ranks_on_cuda_tensors(card,
                                                                 tmp_path):
    """Two gloo ranks share the card, half the scores each (the kernels
    are built first: the ranks load the libraries). Counts within two
    float32 roundings of the exact ones, sums within 2e-6 |e| + n 2^-32
    of float64, the global count exact."""
    import torch.multiprocessing as tmp
    s = torch.from_numpy(_scores(1 << 22, 17)).to(card)
    sh_ops.score_hist(s[:1000], 4096)
    ts_ops.threshold_count(s[:1000], 0.3)
    ctx = tmp.start_processes(_gloo_card_rank, args=(2, str(tmp_path)),
                              nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("gloo ranks did not end in 180 s")
    counts, sums = _exact_hist(s, 4096)
    c = counts.double().cpu()
    for r in range(2):
        out = torch.load(tmp_path / f"rank{r}.pt")
        assert out["launches"] == (2, 1)
        got = out["sketch"].double()
        assert bool(((got[0] - c).abs() <= 2.0 ** -22 * c).all())
        for row, e in zip((1, 2), sums):
            e = e.cpu()
            assert bool(((got[row] - e).abs()
                         <= 2e-6 * e.abs() + c * 2.0 ** -32).all())
        assert out["count"] == int((s >= 0.3).sum())
        for i, h in enumerate(torch.tensor_split(s, 2)):
            want = float(torch.sqrt(torch.clamp(h, 0, 1).double()).sum())
            assert abs(float(out["totals"][i, 0]) - want) <= 1e-6 * want


# -- RWKV6 and decode -------------------------------------------------------------

def _cpu_and_card(arch, card, seed=0):
    """The smoke config's float32 model drawn on the CPU from `seed`, and
    the same weights on the card."""
    cfg = configs.get_smoke_config(arch)
    m = model.init(cfg, generator=torch.Generator().manual_seed(seed),
                   device="cpu")
    on_card = model.init(cfg, generator=torch.Generator().manual_seed(seed),
                         device="cpu").to(card)
    on_card.cfg = cfg
    return cfg, m, on_card


@pytest.mark.cuda
def test_rwkv_prefill_on_the_card_matches_cpu(card):
    """A smoke-size RWKV6 prefill through the channel kernel against the
    same model on the CPU (the plain scan): logits within 2e-5 of the
    largest |logit|, one channel-route launch a block."""
    cfg, cpu_model, card_model = _cpu_and_card("rwkv6-7b", card)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 70))
    ls_ops.launches.reset()
    got = model.apply_train(card_model, tokens).cpu()
    assert dict(ls_ops.launches.routes) == {"chunked": 0,
                                            "channel": cfg.num_layers}
    want = model.apply_train(cpu_model, tokens)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_rwkv_prefill_launches_the_step_route_once_a_block(card):
    """rwkv6's blocks hand linear_scan r, k and v in the model's dtype and
    float32 w as transposed views and the bonus u: `ops.route` sends them
    to the channel kernel, once a block, in bf16 as in float32."""
    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6-7b"),
                              dtype="bfloat16")
    m = model.init(cfg, generator=torch.Generator(device=card).manual_seed(2),
                   device=card)
    ls_ops.launches.reset()
    scores = model.proxy_scores(m, np.ones((4, 33), np.int64))
    assert dict(ls_ops.launches.routes) == {"chunked": 0,
                                            "channel": cfg.num_layers}
    assert bool(((scores > 0) & (scores < 1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-1.2b", "rwkv6-7b",
                                  "llama4-maverick-400b-a17b"])
def test_decode_on_the_card_matches_cpu(card, arch):
    """Four decode steps from `init_caches` on the card against the same
    steps on the CPU, rows at their own positions: logits within 2e-5 of
    the largest |logit|, and every cache after the last step within 2e-5
    of its largest |value|."""
    cfg, cpu_model, card_model = _cpu_and_card(arch, card, 3)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 4))
    caches = {"cpu": model.init_caches(cfg, 3, 8, torch.float32,
                                       device="cpu"),
              "card": model.init_caches(cfg, 3, 8, torch.float32,
                                        device=card)}
    for i in range(4):
        pos = np.array([i, i + 2, i + 4])
        want, caches["cpu"] = model.apply_decode(
            cpu_model, tokens[:, i:i + 1], caches["cpu"], pos)
        got, caches["card"] = model.apply_decode(
            card_model, torch.from_numpy(tokens[:, i:i + 1]).to(card),
            caches["card"], torch.from_numpy(pos).to(card))
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=2e-5 * float(want.abs().max()))

    def leaves(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in leaves(v)]
        if isinstance(tree, list):
            return [t for v in tree for t in leaves(v)]
        return [tree]
    for got, want in zip(leaves(caches["card"]), leaves(caches["cpu"])):
        assert got.device.type == "cuda"
        torch.testing.assert_close(
            got.cpu(), want, rtol=0,
            atol=2e-5 * max(float(want.abs().max()), 1e-30))


# -- MoE -----------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n,e,k,gate_fn", [(16384, 160, 6, "softmax"),
                                           (16384, 128, 1, "sigmoid"),
                                           (37, 8, 2, "softmax")])
def test_moe_routing_on_the_card_matches_cpu(card, n, e, k, gate_fn):
    """The same router logits (deepseek-v2's and llama4's MoE widths, and a
    ragged small case) routed and dispatched on the card and on the CPU:
    expert ids, the order, each assignment's token, slot and whether it
    is kept exactly equal (the gates are rounded from float64, so no ulp
    of float32 arithmetic decides a choice); gates within 1e-6."""
    g = torch.Generator(device=card).manual_seed(n + e)
    logits = torch.randn(n, e, generator=g, device=card) * 0.9
    cfg = dataclasses.replace(configs.get_smoke_config(
        "llama4-maverick-400b-a17b"), num_experts=e, num_experts_per_tok=k)
    cap = moe.capacity(cfg, n)
    out = {}
    for where, x in (("card", logits), ("cpu", logits.cpu())):
        ids, gates, gates_all = moe.top_k_routing(x, k, gate_fn)
        out[where] = (ids, gates, gates_all, *moe.dispatch(ids, e, cap))
    for got, want in zip(out["card"], out["cpu"]):
        assert got.device.type == "cuda"
        if got.dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
        else:
            assert torch.equal(got.cpu(), want)
    if k == 1 and n > 1000:
        assert not bool(out["cpu"][-1].all())    # the capacity drops some


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "dense_prefix"])
def test_moe_prefill_on_the_card_matches_cpu(card, layout):
    """A narrow float32 MoE model at head dim 64 (llama4's interleaved
    pairs with sigmoid top-1, or deepseek-v2's dense prefix with softmax
    top-2) on the card against the same weights on the CPU: logits within
    2e-5 of the largest |logit|, one flash_attention launch a block."""
    cfg = dataclasses.replace(
        configs.get_smoke_config("llama4-maverick-400b-a17b"), d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, num_experts=8)
    if layout == "dense_prefix":
        cfg = dataclasses.replace(cfg, moe_layer_step=1, first_k_dense=1,
                                  num_experts_per_tok=2)
    cpu_model = model.init(cfg, generator=torch.Generator().manual_seed(5),
                           device="cpu")
    card_model = model.init(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu").to(card)
    card_model.cfg = cfg
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (4, 96))
    before = fa_ops.launches.count
    got = model.apply_train(card_model, tokens).cpu()
    assert fa_ops.launches.count == before + cfg.num_layers
    want = model.apply_train(cpu_model, tokens)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=2e-5 * float(want.abs().max()))


# The backward kernel sums in float32 and rounds dq, dk and dv once; in
# bf16 it rounds P and dS before the products that take them. So in bf16
# each output lies within one rounding of the plain backward's float32
# sums (BF16_RTOL) plus what those roundings move
# (chip_smoke.BWD_BF16_ATOL).
BWD_BF16_ATOL = 2e-2
# The forward kernel's lse against the plain lse of the same inputs in
# float32: both sum the same products in float32, in other orders, and the
# kernel's exp2 is the hardware's approximation (chip_smoke.LSE_TOL).
LSE_TOL = 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kv", [(2, 200, 4, 2), (1, 333, 3, 3),
                                      (2, 64, 6, 1), (1, 1, 2, 1)])
def test_flash_attention_forward_lse_matches_plain(card, b, s, h, kv, causal,
                                                   dtype):
    """`flash_attention_fwd`'s lse, a (B, H, S) view of the kernel's
    (B, H, lse_rows(S)) buffer, against the plain lse within LSE_TOL abs +
    rel; its o bitwise the o of a launch that stores no lse."""
    g = torch.Generator(device=card).manual_seed(s + h)
    q = torch.randn(b, s, h, 64, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, 64, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, 64, generator=g, device=card).to(dtype)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal)
    o2 = fa_ops.flash_attention(q, k, v, causal=causal)
    _, want = fa_ref.attention_ref(*(x.float().transpose(1, 2) for x in
                                     (q, k, v)), causal, return_lse=True)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert lse.stride() == (h * fa_ops.lse_rows(s), fa_ops.lse_rows(s), 1)
    assert torch.equal(o, o2)
    torch.testing.assert_close(lse, want, atol=LSE_TOL, rtol=LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv", [(64, 64), (128, 128), (192, 128)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kv", [(2, 200, 4, 2), (1, 333, 3, 3),
                                      (2, 64, 6, 1), (1, 130, 6, 6),
                                      (1, 257, 12, 2)])
def test_flash_attention_bwd_kernel_matches_plain(card, b, s, h, kv, causal,
                                                  dtype, dh, dv):
    """dq, dk and dv of the backward kernel, given the forward's lse,
    against the plain backward in float32 from the same inputs (bf16
    within BWD_BF16_ATOL + 2^-7 |plain|, float32 within 2e-5 abs + rel);
    two calls bitwise equal. The shapes reach the grid's edges: S not a
    multiple of the 32-, 64- and 128-row tiles, H/KV of 1, 2, 3 and 6, at
    each (dh, dv) pair of the kernel; every column block of dq and dk (the
    MN-major operands span dh/64 swizzle atoms) is held."""
    g = torch.Generator(device=card).manual_seed(s + h + dh)
    q = torch.randn(b, s, h, dh, generator=g, device=card).to(dtype)
    k = torch.randn(b, s, kv, dh, generator=g, device=card).to(dtype)
    v = torch.randn(b, s, kv, dv, generator=g, device=card).to(dtype)
    do = torch.randn(b, s, h, dv, generator=g, device=card).to(dtype)
    o, lse = fa_ops.flash_attention_fwd(q, k, v, causal=causal)
    before = fa_ops.bwd_launches.count
    got = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    again = fa_ops.flash_attention_bwd(q, k, v, o, do, causal=causal,
                                       lse=lse)
    plain = fa_ref.attention_bwd_ref(*(x.float().transpose(1, 2) for x in
                                       (q, k, v, o, do)), causal)
    torch.cuda.synchronize()
    assert fa_ops.bwd_launches.count == before + 2
    for a, a2, w, like in zip(got, again, plain, (q, k, v)):
        w = w.transpose(1, 2)
        assert a.dtype == dtype and a.shape == like.shape
        assert torch.equal(a, a2)
        if dtype == torch.bfloat16:
            torch.testing.assert_close(a.float(), w, atol=BWD_BF16_ATOL,
                                       rtol=BF16_RTOL)
        else:
            torch.testing.assert_close(a, w, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv", [(128, 128), (192, 128)])
def test_flash_attention_bwd_repeats_bitwise_at_the_wide_pairs(card, dh, dv):
    """Three bf16 calls of the backward kernel at a wider pair (its three
    launches, dq then dv then dk, over many work tiles and CTAs) give the
    same bits: no sum depends on which CTA takes which tile."""
    g = torch.Generator(device=card).manual_seed(dh)
    b, s, h, kv = 2, 1000, 12, 2
    q, k = (torch.randn(b, s, n, dh, generator=g, device=card)
            .to(torch.bfloat16) for n in (h, kv))
    v = torch.randn(b, s, kv, dv, generator=g, device=card).to(torch.bfloat16)
    o, lse = fa_ops.flash_attention_fwd(q, k, v)
    do = torch.randn(o.shape, generator=g, device=card).to(torch.bfloat16)
    first = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    for _ in range(2):
        again = fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


@pytest.mark.cuda
def test_flash_attention_bwd_on_the_card_needs_the_lse(card):
    """A missing lse, or one not laid out as the forward keeps it, raises
    before any launch."""
    q, k, v, do = (torch.randn(1, 200, 2, 64, device=card,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fa_ops.flash_attention_fwd(q, k, v)
    before = fa_ops.bwd_launches.count
    for bad in (None, lse[:, :1], lse.double(), lse.contiguous()):
        with pytest.raises(ValueError, match="forward's lse"):
            fa_ops.flash_attention_bwd(q, k, v, o, do, lse=bad)
    assert fa_ops.bwd_launches.count == before
    fa_ops.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert fa_ops.bwd_launches.count == before + 1


@pytest.mark.cuda
def test_flash_attention_gradient_on_the_card_is_the_kernel(card):
    """Autograd through `flash_attention` on CUDA tensors runs the backward
    kernel once, from the lse its forward kept, at (64, 64) and at the
    wider pairs (128, 128) and (192, 128)."""
    q, k, v = (torch.randn(1, 128, 2, 64, device=card, requires_grad=True)
               for _ in range(3))
    before = fa_ops.bwd_launches.count
    with mock.patch.object(fa_ops, "flash_attention_bwd",
                           wraps=fa_ops.flash_attention_bwd) as bwd:
        fa_ops.flash_attention(q, k, v).sum().backward()
    assert fa_ops.bwd_launches.count == before + 1
    lse = bwd.call_args.kwargs["lse"]
    _, want = fa_ops.flash_attention_fwd(*(x.detach() for x in (q, k, v)))
    assert torch.equal(lse, want)
    for dh, dv in ((128, 128), (192, 128)):
        q, k = (torch.randn(1, 200, 2, dh, device=card, dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))
        v = torch.randn(1, 200, 2, dv, device=card, dtype=torch.bfloat16,
                        requires_grad=True)
        before = fa_ops.bwd_launches.count
        fa_ops.flash_attention(q, k, v).float().sum().backward()
        assert fa_ops.bwd_launches.count == before + 1
        assert q.grad.shape == q.shape and v.grad.shape == v.shape


@pytest.mark.cuda
@pytest.mark.parametrize("arch,accum,change", [
    ("smollm-360m", 2, dict(head_dim=64)),
    ("musicgen-medium", 1, dict(head_dim=64)),
    ("yi-6b", 2, dict(head_dim=128)),
    ("deepseek-v2-236b", 1, dict(num_layers=1, qk_nope_head_dim=128,
                                 qk_rope_head_dim=64, v_head_dim=128))],
    ids=["smollm-64", "musicgen-64", "yi-128", "deepseek-v2-mla-192-128"])
def test_train_steps_on_the_card_match_cpu(card, arch, accum, change):
    """Three float32 train steps of a narrow model (remat on) at each head
    dim pair of the backward kernel, (64, 64), (128, 128) and MLA's
    (128 + 64, 128) (deepseek-v2 cut to its dense MLA block), on the card
    against the same weights and batches on the CPU: the metrics within
    1e-5 relative, the weights within lr (as the CPU test holds the port to
    the reference), one backward launch a layer a microbatch."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), d_model=128,
                              num_heads=2, num_kv_heads=2, remat="block",
                              **change)
    opts = train.TrainOptions(grad_accum=accum, adamw=adamw.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    runs = {}
    for dev in ("cpu", card):
        m = model.init(cfg, generator=torch.Generator().manual_seed(3),
                       device="cpu").to(dev)
        m.cfg = cfg
        o = adamw.init(m)
        step = train.make_train_step(cfg, opts)
        mets = []
        for i in range(3):
            rng = np.random.default_rng(i)
            shape = (4, 96) + ((cfg.num_codebooks,) if cfg.num_codebooks > 1
                               else ())
            batch = {key: rng.integers(0, cfg.vocab_size, shape)
                     for key in ("tokens", "labels")}
            before = fa_ops.bwd_launches.count
            m, o, met = step(m, o, batch)
            if dev != "cpu":
                assert fa_ops.bwd_launches.count == before \
                    + accum * cfg.num_layers
            mets.append({key: float(v) for key, v in met.items()})
        runs[str(dev)] = (m, mets)
    (cpu_m, cpu_mets), (card_m, card_mets) = runs.values()
    for a, b_ in zip(card_mets, cpu_mets):
        for key in a:
            assert a[key] == pytest.approx(b_[key], rel=1e-5, abs=1e-9), key
    for (name, p), (_, p_cpu) in zip(card_m.named_parameters(),
                                     cpu_m.named_parameters()):
        assert float((p.detach().cpu() - p_cpu.detach()).abs().max()) \
            <= 1e-3, name


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card(card, tmp_path):
    cfg = configs.get_smoke_config("musicgen-medium")
    m = model.init(cfg, generator=torch.Generator(device=card).manual_seed(1))
    o = adamw.init(m)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, m, o)
    m2, o2, step, _ = mgr.restore()
    assert step == 2
    params, params2 = dict(m.named_parameters()), dict(m2.named_parameters())
    assert params.keys() == params2.keys()
    for n, p in params.items():
        assert params2[n].device.type == "cuda", n
        assert torch.equal(p, params2[n]), n
    assert all(torch.equal(o.mu[n], o2.mu[n]) for n in o.mu)
