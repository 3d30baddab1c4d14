"""The port's statistical plane — binned sketches, hierarchical sampling
primitives, Lemma-1 bounds and the §5 threshold estimators — against the
JAX package on the same inputs.

Integer and threshold outputs are exact. Float32 reductions run in XLA's
CPU association order and are bit-equal. Two intermediate scalars are held
to rtol 1e-6 instead: XLA's CPU log is a polynomial that differs from a
correctly rounded log by one unit in the last place for some arguments,
and its compiled estimators contract some multiply-adds into FMAs, so
n_match (PT stage 1) and gamma' (RT) can differ in their last bit. The tau
that comes out of them is compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import binned as jbinned
from repro.core import bounds as jbounds
from repro.core import sampling as jsampling
from repro.core import thresholds as jthresholds
from repro.data import synthetic as jsynthetic
from repro_torch.core import binned, bounds, sampling, thresholds
from repro_torch.data import synthetic


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
    a, o, m = _sample(0, 3000, False)
    mu, sg, n = bounds.weighted_prefix_mean_std(_t(o), _t(m))
    jmu, jsg, jn = jbounds.weighted_prefix_mean_std(o, m)
    _eq(mu, jmu)
    _eq(sg, jsg)
    _eq(n, jn)
    z = o * m
    _eq(bounds.sample_mean_std(_t(z))[0], jnp.mean(z))
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
        np.testing.assert_allclose(got.corrected_target,
                                   want.corrected_target, rtol=1e-6)
    nm, rank = thresholds.pt_stage1_nmatch(o, m, 100_000, gamma, delta)
    jnm, jrank = jthresholds.pt_stage1_nmatch(o, m, 100_000, gamma, delta)
    _eq(rank, jrank)
    np.testing.assert_allclose(nm, jnm, rtol=1e-6)


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
