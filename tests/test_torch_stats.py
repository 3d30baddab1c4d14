"""The port's statistical plane — binned sketches, hierarchical sampling
primitives, Lemma-1 bounds and the §5 threshold estimators — against the
JAX package on the same inputs.

Every output is held bit for bit. Float32 reductions run in XLA's CPU
association order. The port's log is XLA's CPU log (Cephes' ``logf`` with
its FMAs, `bounds.xla_log32`), swept against ``jnp.log`` here, and the
port's estimators contract the multiply-adds that XLA's CPU backend
contracts into FMAs under ``jit`` (mu = sum · 1/s into each bound; the
precision scan's variance), so gamma' (RT) and n_match (PT stage 1) equal
the reference's to the bit, as the tau that comes out of them does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import binned as jbinned  # noqa: E402
from repro.core import bounds as jbounds  # noqa: E402
from repro.core import sampling as jsampling  # noqa: E402
from repro.core import thresholds as jthresholds  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import random as prandom  # noqa: E402
from repro_torch.core import binned, bounds, sampling, thresholds  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- association order of float32 sums ----------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(1, 9000), st.integers(0, 2**31 - 1))
def test_sum_and_cumsum_match_xla_order(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(n) * rng.random(n) * 5).astype(np.float32)
    x[rng.random(n) < 0.5] = 0.0
    _eq(bounds.tree_sum(_t(x)), jnp.sum(x))
    _eq(bounds.blocked_cumsum(_t(x)), jnp.cumsum(x))


# -- binned -----------------------------------------------------------------

@pytest.mark.parametrize("bins", [64, 4096])
def test_sketch_merge_normalizers_rank(bins):
    rng = np.random.default_rng(bins)
    shards = [rng.beta(0.01, 1.0, n).astype(np.float32)
              for n in (2000, 3500, 6000)]
    shards[1][rng.random(3500) < 0.05] = -1.0
    mine = [binned.build_sketch(_t(s), bins) for s in shards]
    ref = [jbinned.build_sketch(s, bins, use_kernel=False) for s in shards]
    for a, b in zip(mine, ref):
        for f in ("counts", "sum_w", "sum_a"):
            _eq(getattr(a, f), getattr(b, f))
    merged = binned.merge_sketches(*mine)
    jmerged = jbinned.merge_sketches(*ref)
    for f in ("counts", "sum_w", "sum_a"):
        _eq(getattr(merged, f), getattr(jmerged, f))
    for got, want in zip(binned.weight_normalizers(merged),
                         jbinned.weight_normalizers(jmerged)):
        _eq(got, want)
    for rank in (1, 7, 100, 5000, 11_000, 50_000):
        assert binned.rank_to_threshold(merged, rank) == float(
            jbinned.rank_to_threshold(jmerged, rank))


def test_chunk_sketch_stats():
    s = np.random.default_rng(1).beta(0.05, 1.0, 4000).astype(np.float32)
    s[:40] = -1.0
    sk, s_sqrt, s_a = binned.chunk_sketch_stats(_t(s), 64)
    jsk, js_sqrt, js_a = jbinned.chunk_sketch_stats(s, 64, use_kernel=False)
    _eq(sk.counts, jsk.counts)
    # float64 sums of the same float32 terms, in torch's order vs numpy's
    assert s_sqrt == pytest.approx(js_sqrt, rel=1e-12)
    assert s_a == pytest.approx(js_a, rel=1e-12)


def test_chunk_sketch_into_writes_the_masses_of_chunk_sketch_stats():
    """The buffer path (masses written into a float64 row, no read-back)
    gives the sketch and the masses of `chunk_sketch_stats`, bit for bit."""
    s = np.random.default_rng(2).beta(0.05, 1.0, 5000).astype(np.float32)
    s[::50] = -1.0
    row = torch.full((2,), np.nan, dtype=torch.float64)
    sk = binned.chunk_sketch_into(_t(s), row, 64)
    want, w_sqrt, w_a = binned.chunk_sketch_stats(_t(s), 64)
    for f in ("counts", "sum_w", "sum_a"):
        _eq(getattr(sk, f), getattr(want, f))
    assert row.tolist() == [w_sqrt, w_a]


@pytest.mark.parametrize("workers", [1, 4])
def test_sketch_shards_masses_through_the_buffer(workers):
    """`_sketch_shards` reads every chunk's masses from one (n_chunks, 2)
    buffer and gives the `ChunkMasses` of a per-chunk float64 sum (the
    pass before the buffer: each chunk's clipped terms and their float32
    square roots, summed by torch and read back), bit for bit, and the
    reference's within float64 reordering (rel 1e-12)."""
    from repro.core.engine import SelectionEngine as RefEngine
    from repro_torch.core.engine import SelectionEngine
    rng = np.random.default_rng(8)
    shards = [rng.beta(0.02, 1.0, n).astype(np.float32)
              for n in (3000, 1024, 2500)]
    shards[0][rng.random(3000) < 0.02] = -1.0
    with SelectionEngine(shards, num_bins=64, chunk_records=1024,
                         workers=workers, device="cpu") as eng:
        got = eng._state.chunk_masses
    ref = RefEngine(shards, num_bins=64, chunk_records=1024,
                    use_kernel=False)
    try:
        want_ref = ref._state.chunk_masses
    finally:
        ref.close()
    for shard, cm, rm in zip(shards, got, want_ref):
        chunks = [shard[i:i + 1024] for i in range(0, shard.size, 1024)]
        a = [torch.clamp(_t(c), 0.0, 1.0) for c in chunks]
        _eq(cm.sum_sqrt, [float(bounds.sqrt32(x).to(torch.float64).sum())
                          for x in a])
        _eq(cm.sum_a, [float(x.to(torch.float64).sum()) for x in a])
        _eq(cm.sizes, [c.size for c in chunks])
        np.testing.assert_allclose(cm.sum_sqrt, rm.sum_sqrt, rtol=1e-12)
        np.testing.assert_allclose(cm.sum_a, rm.sum_a, rtol=1e-12)
        _eq(cm.sizes, rm.sizes)


# -- sampling -----------------------------------------------------------------

def test_sampling_primitives():
    rng = np.random.default_rng(3)
    chunk = rng.beta(0.05, 1.0, 3000).astype(np.float32)
    chunk[::97] = -1.0
    for scheme in ("sqrt", "prop"):
        p = sampling.defensive_probs(_t(chunk), scheme, 123.4, 0.1, 50_000)
        jp = jsampling.defensive_probs(chunk, scheme, 123.4, 0.1, 50_000)
        assert p.dtype == torch.float32
        _eq(p, jp)
        cdf = sampling.normalized_cdf(p)
        _eq(cdf, jsampling.normalized_cdf(jp))
        u = rng.random(500)
        _eq(sampling.draw_from_cdf(cdf, u), jsampling.draw_from_cdf(
            jsampling.normalized_cdf(jp), u))
    raw, sizes = rng.random(9) * 40, np.full(9, 1024, np.int64)
    _eq(sampling.defensive_chunk_mass(raw, sizes, 300.0, 0.1, 9216),
        jsampling.defensive_chunk_mass(raw, sizes, 300.0, 0.1, 9216))
    t, c = sampling.chunk_mass_cdf(raw, sizes, 300.0, 0.1, 9216)
    jt, jc = jsampling.chunk_mass_cdf(raw, sizes, 300.0, 0.1, 9216)
    assert t == jt
    _eq(c, jc)
    _eq(sampling.draw_from_cdf(c, [0.0, 0.5, 1.0]),
        jsampling.draw_from_cdf(jc, [0.0, 0.5, 1.0]))
    with pytest.raises(ValueError):
        sampling.normalized_cdf(torch.zeros(4))


# -- bounds and thresholds ----------------------------------------------------

def _sample(seed, s, ties):
    rng = np.random.default_rng(seed)
    a = rng.beta(0.05, 1.0, s).astype(np.float32)
    if ties:
        a = np.round(a, 2).astype(np.float32)
    o = (rng.random(s) < a).astype(np.float32)
    m = (rng.random(s) * 3 + 0.1).astype(np.float32)
    return a, o, m


CASES = [(seed, s, ties, g, d)
         for seed, (s, ties, g, d) in enumerate([
             (3000, False, 0.9, 0.05), (3000, True, 0.9, 0.05),
             (1500, False, 0.8, 0.1), (1500, True, 0.95, 0.025),
             (100, False, 0.5, 0.05), (777, True, 0.9, 0.05),
             (4096, False, 0.8, 0.05), (2000, True, 0.7, 0.1)])]


def test_bounds_match_reference():
    """The prefix and sample statistics equal the reference's as its
    estimators run them, under ``jit`` (the bounds built on them are held
    through the estimators, `test_tau_estimators_match_reference`)."""
    a, o, m = _sample(0, 3000, False)
    mu, sg, n = bounds.weighted_prefix_mean_std(_t(o), _t(m))
    jmu, jsg, jn = jax.jit(jbounds.weighted_prefix_mean_std)(o, m)
    _eq(mu, jmu)
    _eq(sg, jsg)
    _eq(n, jn)
    z = o * m
    total, inv_n, sigma = bounds.sample_sum_std(_t(z))
    jmean, jsigma = jax.jit(jbounds.sample_mean_std)(z)
    _eq(total * inv_n, jmean)
    _eq(sigma, jsigma)
    w = bounds.gaussian_width(torch.tensor([0.0, 2.0]),
                              torch.tensor([0.0, 16.0]), 0.05)
    assert torch.isinf(w[0]) and torch.isfinite(w[1])


@pytest.mark.parametrize("seed,s,ties,gamma,delta", CASES)
def test_tau_estimators_match_reference(seed, s, ties, gamma, delta):
    """Equal tau from every estimator, tied sample scores included (the
    stable descending sort keeps ties in draw order)."""
    a, o, m = _sample(seed, s, ties)
    pairs = [
        (thresholds.tau_unoci_r(a, o, gamma),
         jthresholds.tau_unoci_r(a, o, gamma)),
        (thresholds.tau_ci_r(a, o, m, gamma, delta),
         jthresholds.tau_ci_r(a, o, m, gamma, delta)),
        (thresholds.tau_unoci_p(a, o, gamma),
         jthresholds.tau_unoci_p(a, o, gamma)),
        (thresholds.tau_ci_p(a, o, gamma, delta),
         jthresholds.tau_ci_p(a, o, gamma, delta)),
        (thresholds.tau_ci_p(a, o, gamma, delta, m_s=m),
         jthresholds.tau_ci_p(a, o, gamma, delta, m_s=m)),
        (thresholds.tau_ci_p(a, o, gamma, delta / 2.0, min_step=50),
         jthresholds.tau_ci_p(a, o, gamma, delta / 2.0, min_step=50)),
    ]
    for got, want in pairs:
        _eq(got.tau, want.tau)
        _eq(got.n_candidates, want.n_candidates)
        _eq(got.valid, want.valid)
        _eq(got.corrected_target, want.corrected_target)
    nm, rank = thresholds.pt_stage1_nmatch(o, m, 100_000, gamma, delta)
    jnm, jrank = jthresholds.pt_stage1_nmatch(o, m, 100_000, gamma, delta)
    _eq(rank, jrank)
    _eq(nm, jnm)


# -- XLA's CPU log and FMA contractions ---------------------------------------

_LOG_SPECIALS = np.array(
    [0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754942e-38, 1.1754944e-38, 1.0,
     0.5, 2.0, 0.70710677, 0.7071068, 3.4028235e38, -1.0, np.inf, -np.inf,
     np.nan], np.float32)


def _log_sweep():
    """1.5 million float32 inputs from a seed: random bit patterns (every
    exponent, subnormals, negatives, infinities and nans), their absolute
    values, a dense run over [1/4, 4] and the special values."""
    rng = np.random.default_rng(20)
    x = rng.integers(0, 2**32, 500_000, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    dense = np.linspace(0.25, 4.0, 500_000, dtype=np.float32)
    return np.concatenate([x, np.abs(x), dense, _LOG_SPECIALS])


def test_xla_log32_is_jnp_log_bit_for_bit():
    x = _log_sweep()
    got = bounds.xla_log32(_t(x)).numpy()
    _eq(got.view(np.uint32), np.asarray(jnp.log(x)).view(np.uint32))


def test_random_log32_is_xla_log32():
    """The numpy entry point of the sampler (`random.log32`, the logits of
    `categorical`) is the same function, special values included."""
    x = _log_sweep()[::7]
    got = prandom.log32(x)
    assert got.dtype == np.float32 and got.shape == x.shape
    _eq(got.view(np.uint32), bounds.xla_log32(_t(x)).numpy().view(np.uint32))
    _eq(prandom.log32(np.float32(0.5)), jnp.log(np.float32(0.5)))


@pytest.mark.parametrize("seed", [0, 1])
def test_fma32_contractions_match_jit(seed):
    """The contracted variance of the weighted prefix statistics and the
    contracted bounds equal the reference's under jit, where its op-by-op
    results differ from them somewhere (the contractions are real)."""
    a, o, m = _sample(seed, 3000, False)
    got = bounds.weighted_prefix_mean_std(_t(o), _t(m))
    jitted = jax.jit(jbounds.weighted_prefix_mean_std)(o, m)
    eager = jbounds.weighted_prefix_mean_std(o, m)
    for x, y in zip(got, jitted):
        _eq(x, y)
    assert not np.array_equal(np.asarray(jitted[1]), np.asarray(eager[1]))


# -- synthetic corpora ----------------------------------------------------------

def test_make_beta_matches_reference_and_device_law():
    ours = synthetic.make_beta(20_000, 0.01, 1.0, seed=3)
    theirs = jsynthetic.make_beta(20_000, 0.01, 1.0, seed=3)
    _eq(ours.scores, theirs.scores)
    _eq(ours.labels, theirs.labels)
    scores, labels = synthetic.make_beta_on_device(200_000, 0.01, 1.0,
                                                   seed=3, device="cpu")
    assert scores.dtype == torch.float32 and labels.dtype == np.float32
    # Beta(0.01, 1): mean 1/101, P(A < 1/4096) = 4096**-0.01
    assert float(scores.mean()) == pytest.approx(1 / 101, rel=0.1)
    assert float((scores < 1 / 4096).double().mean()) == pytest.approx(
        4096 ** -0.01, abs=0.005)
    assert labels.mean() == pytest.approx(float(scores.mean()), rel=0.15)


# -- the single-array path's bounds and binned leftovers ----------------------

@settings(max_examples=40, deadline=None)
@given(st.sampled_from([1, 2, 31, 33, 1000, 4097]), st.integers(0, 2**31 - 1))
def test_bounds_leftovers_match_reference(n, seed):
    """The eager reference's mean/std (mean by the reciprocal of n, the
    variance by a division), weighted and prefix statistics, UB/LB with
    s an int or a tensor, and the union-bound split: bit for bit. A few
    lengths around XLA's reduction windows (32) and scan blocks (16), so
    the reference compiles each shape once."""
    rng = np.random.default_rng(seed)
    z = (rng.random(n) * (rng.random(n) < 0.3) * rng.random() * 50).astype(
        np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    mask = rng.random(n) < 0.5
    pairs = [
        (bounds.sample_mean_std(_t(z)), jbounds.sample_mean_std(z)),
        (bounds.weighted_mean_std(_t(z), _t(w)),
         jbounds.weighted_mean_std(z, w)),
        (bounds.prefix_mean_std(_t(z)), jbounds.prefix_mean_std(z)),
        (bounds.masked_prefix_mean_std(_t(z), _t(mask)),
         jbounds.masked_prefix_mean_std(z, mask)),
        ((bounds.ub(0.3, 0.7, n, 0.05),), (jbounds.ub(0.3, 0.7, n, 0.05),)),
        ((bounds.ub(_t(z), _t(z) * 0.5, _t(w), 0.01),),
         (jbounds.ub(z, z * 0.5, w, 0.01),)),
        ((bounds.lb(_t(z), _t(z) * 0.5, _t(w), 0.05),),
         (jbounds.lb(z, z * 0.5, w, 0.05),)),
        ((bounds.lb(0.3, 0.7, n, 0.05),), (jbounds.lb(0.3, 0.7, n, 0.05),)),
        ((bounds.union_bound_split(0.05, n),),
         (jbounds.union_bound_split(0.05, n),)),
    ]
    for got, want in pairs:
        for g, r in zip(got, want):
            _eq(g, r)


@pytest.mark.parametrize("n", [3, 7, 31, 32, 33, 64, 100])
def test_sample_mean_std_matches_jnp_std_around_the_fused_window(n):
    """Up to 32 records XLA fuses the square into the variance's sum (each
    step an FMA); past that it rounds the squares first. Bit for bit on
    either side, over samples where the two orders differ."""
    rng = np.random.default_rng(n)
    for _ in range(40):
        z = (rng.normal(size=n) * rng.random() * 10).astype(np.float32)
        mu, sigma = bounds.sample_mean_std(_t(z))
        _eq(mu, jnp.mean(z))
        _eq(sigma, jnp.std(z))


def test_sample_mean_std_takes_a_vector_only():
    with pytest.raises(ValueError, match="1-D"):
        bounds.sample_mean_std(torch.ones(2, 3))


def test_flush32_reads_subnormals_as_zero():
    x = np.asarray([1e-40, -1e-40, 1.2e-38, -0.0, 3.0, np.nan, np.inf],
                   np.float32)
    got = bounds.flush32(_t(x)).numpy()
    np.testing.assert_array_equal(got[:2], [0.0, 0.0])
    assert np.signbit(got[1]) and not np.signbit(got[0])
    np.testing.assert_array_equal(got[2:5], x[2:5])
    assert np.isnan(got[5]) and got[6] == np.inf


@pytest.mark.parametrize("bins", [64, 1000, 4096])
def test_bin_index_and_selection_size(bins):
    rng = np.random.default_rng(bins)
    s = rng.beta(0.3, 1.0, 50_000).astype(np.float32)
    s[:100], s[100:110], s[110:120] = -1.0, 1.0, 2.0
    _eq(binned.bin_index(_t(s), bins), jbinned.bin_index(s, bins))
    assert binned.bin_index(_t(s), bins).dtype == torch.int32
    sk = binned.build_sketch(_t(s), bins)
    jsk = jbinned.build_sketch(s, bins, use_kernel=False)
    for tau in (-1.0, 0.0, 1e-7, 0.1, 0.33333334, 0.5, 0.999, 1.0, 1.5,
                float(np.float32(7 / bins))):
        _eq(binned.selection_size(sk, tau), jbinned.selection_size(jsk, tau))
    assert float(binned.selection_size(sk, 0.0)) == 49_900


def test_chunk_raw_masses_match_reference():
    s = np.random.default_rng(12).beta(0.05, 1.0, 9000).astype(np.float32)
    s[:90] = -1.0
    assert sampling.chunk_raw_masses(s) == jsampling.chunk_raw_masses(s)
