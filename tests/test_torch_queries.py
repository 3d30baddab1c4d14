"""The port's single-array query path — `run_query`, `run_joint_query`
and the samplers under them — against the JAX package's, on the CPU.

Every output is held exactly: tau, gamma', the selected indices, oracle
calls and sampled positives of each query at the same key, and the
indices, m and w of each sampler. The reference draws under jit, where
XLA's CPU code contracts the defensive mix into an FMA and reads float32
subnormals as zero (a Beta(0.01, 1) corpus is about 40% subnormal); the
port reproduces both (`bounds.fma32`, `bounds.flush32`). R2 = {A >= tau}
goes through `threshold_select`, which keeps A >= max(tau, 0); the
negative-score cases below hold the port to the reference's set where
tau <= 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import queries as jqueries  # noqa: E402
from repro.core import sampling as jsampling  # noqa: E402
from repro.core import thresholds as jthresholds  # noqa: E402
from repro.core.oracle import array_oracle as jarray_oracle  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import queries, sampling, thresholds  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.data.synthetic import make_beta  # noqa: E402
from repro_torch.kernels.threshold_select import ops as ts_ops  # noqa: E402


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
def corpora():
    """Two make_beta corpora (the paper's Beta(0.01, 1) setting)."""
    return {n: make_beta(n, 0.01, 1.0, seed=n % 97) for n in
            (20_000, 200_000)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_sample(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _same_result(got, want):
    assert got.tau == want.tau
    assert got.corrected_target == want.corrected_target
    assert got.oracle_calls == want.oracle_calls
    assert got.n_sampled_positives == want.n_sampled_positives
    assert got.selected.dtype == np.int64
    np.testing.assert_array_equal(got.selected, want.selected)


# -- samplers -----------------------------------------------------------------

@pytest.mark.parametrize("scheme", ["uniform", "sqrt", "prop"])
@pytest.mark.parametrize("defensive", [True, False])
def test_draw_oracle_sample_matches_reference(corpora, scheme, defensive):
    for n, ds in corpora.items():
        for k in (0, 5):
            key = jax.random.PRNGKey(k)
            want = jsampling.draw_oracle_sample(
                key, jnp.asarray(ds.scores), 1500, scheme=scheme,
                defensive=defensive)
            got = sampling.draw_oracle_sample(np.asarray(key),
                                              _t(ds.scores), 1500,
                                              scheme=scheme,
                                              defensive=defensive)
            _same_sample(got, want)


@pytest.mark.parametrize("defensive", [True, False])
def test_weights_match_reference(corpora, defensive):
    """The weights as the reference's jitted sampler computes them (the
    defensive mix contracted into one FMA)."""
    ds = corpora[20_000]
    for port, ref in ((sampling.sqrt_proxy_weights,
                       jsampling.sqrt_proxy_weights),
                      (sampling.proportional_proxy_weights,
                       jsampling.proportional_proxy_weights)):
        np.testing.assert_array_equal(
            port(_t(ds.scores), defensive).numpy(),
            np.asarray(jax.jit(ref, static_argnums=1)(ds.scores,
                                                       defensive)))
    np.testing.assert_array_equal(sampling.uniform_probs(777).numpy(),
                                  np.asarray(jsampling.uniform_probs(777)))


def test_all_zero_proxy_falls_back_to_uniform():
    zeros = np.zeros(500, np.float32)
    for port, ref in ((sampling.sqrt_proxy_weights,
                       jsampling.sqrt_proxy_weights),
                      (sampling.proportional_proxy_weights,
                       jsampling.proportional_proxy_weights)):
        np.testing.assert_array_equal(port(_t(zeros)).numpy(),
                                      np.asarray(jax.jit(ref)(zeros)))


@pytest.mark.parametrize("kind", ["uniform-counted", "ones", "weights"])
def test_sample_weighted_masked_matches_reference(corpora, kind):
    ds = corpora[200_000]
    thr = np.sort(ds.scores)[::-1][5000]
    mask = (ds.scores >= thr).astype(np.float32)
    probs = np.random.default_rng(3).random(ds.scores.size).astype(
        np.float32)
    for k in (1, 2):
        key = jax.random.PRNGKey(k)
        if kind == "uniform-counted":
            want = jsampling.sample_weighted_masked(
                key, np.ones_like(ds.scores), mask, 1200)
            got = sampling.sample_weighted_masked(
                np.asarray(key), None, _t(mask), 1200,
                n_sub=int(mask.sum()))
        else:
            p = np.ones_like(ds.scores) if kind == "ones" else probs
            want = jsampling.sample_weighted_masked(key, p, mask, 1200)
            got = sampling.sample_weighted_masked(np.asarray(key), _t(p),
                                                  _t(mask), 1200)
        _same_sample(got, want)
    with pytest.raises(ValueError, match="n_sub"):
        sampling.sample_weighted_masked(np.asarray(key), None, _t(mask), 10)


def test_sample_weighted_and_uniform_match_reference():
    rng = np.random.default_rng(4)
    probs = rng.random(30_000).astype(np.float32) ** 4
    probs /= probs.sum()
    probs[::7] = 1e-41                     # subnormal masses read as zero
    for k in range(3):
        key = jax.random.PRNGKey(k)
        _same_sample(sampling.sample_weighted(np.asarray(key), _t(probs),
                                              2000),
                     jsampling.sample_weighted(key, probs, 2000))
        _same_sample(sampling.sample_uniform(np.asarray(key), 30_000, 2000),
                     jsampling.sample_uniform(key, 30_000, 2000))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown sampling scheme"):
        sampling.draw_oracle_sample(R.PRNGKey(0), torch.rand(10), 5,
                                    scheme="cubic")


def test_dprime_cutoff_score_matches_reference():
    rng = np.random.default_rng(5)
    for n in (1, 9, 1000, 60_000):
        s = rng.beta(0.01, 1.0, n).astype(np.float32)
        s[: n // 10] = -1.0
        if n > 50:
            s[20:40] = s[50]                 # ties
        for rank in (-3, 0, 1, 2, n // 3, n - 1, n, n + 5):
            got = thresholds.dprime_cutoff_score(_t(s), rank)
            want = jthresholds.dprime_cutoff_score(s, jnp.int32(rank))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- run_query / run_joint_query -----------------------------------------------

QUERIES = {
    "rt-is-sqrt": dict(target="recall", gamma=0.9, method="is"),
    "rt-is-prop": dict(target="recall", gamma=0.9, method="is",
                       weight_scheme="prop"),
    "rt-uniform": dict(target="recall", gamma=0.9, method="uniform"),
    "rt-noci": dict(target="recall", gamma=0.9, method="noci"),
    "pt-is-two-stage": dict(target="precision", gamma=0.8, method="is"),
    "pt-is-one-stage": dict(target="precision", gamma=0.8, method="is",
                            two_stage=False),
    "pt-uniform": dict(target="precision", gamma=0.8, method="uniform"),
    "pt-noci": dict(target="precision", gamma=0.8, method="noci"),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_run_query_matches_reference(corpora, name):
    """Exact at the same key, on 20,000 and 200,000 records; key=None is
    PRNGKey(0) on both sides."""
    spec = QUERIES[name]
    for n, ds in corpora.items():
        for k in (3, None):
            jkey = None if k is None else jax.random.PRNGKey(k)
            want = jqueries.run_query(jkey, ds.scores,
                                      jarray_oracle(ds.labels),
                                      jqueries.SUPGQuery(budget=2000, **spec))
            got = queries.run_query(
                None if k is None else np.asarray(jkey), ds.scores,
                array_oracle(ds.labels),
                queries.SUPGQuery(budget=2000, **spec), device="cpu")
            _same_result(got, want)
            assert got.oracle_calls <= 2000


def test_run_query_takes_a_tensor(corpora):
    ds = corpora[20_000]
    q = queries.SUPGQuery(target="recall", gamma=0.9, budget=1000)
    a = queries.run_query(R.PRNGKey(1), _t(ds.scores),
                          array_oracle(ds.labels), q, device="cpu")
    b = queries.run_query(R.PRNGKey(1), ds.scores.astype(np.float64),
                          array_oracle(ds.labels), q, device="cpu")
    _same_result(a, b)
    assert isinstance(a.tau, float) and isinstance(a.oracle_calls, int)
    assert a.mask(ds.scores.size).sum() == a.selected.size


@pytest.mark.parametrize("method", ["is", "uniform"])
def test_run_joint_query_matches_reference(corpora, method):
    ds = corpora[200_000]
    key = jax.random.PRNGKey(11)
    want = jqueries.run_joint_query(key, ds.scores, jarray_oracle(ds.labels),
                                    0.9, 1.0, stage_budget=2000,
                                    method=method)
    got = queries.run_joint_query(np.asarray(key), ds.scores,
                                  array_oracle(ds.labels), 0.9, 1.0,
                                  stage_budget=2000, method=method,
                                  device="cpu")
    assert got.stage2_tau == want.stage2_tau
    assert got.oracle_calls == want.oracle_calls
    np.testing.assert_array_equal(got.selected, want.selected)
    assert queries.precision_of(got.selected, ds.truth_mask()) == 1.0


def test_run_query_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    q = queries.SUPGQuery(target="recall", gamma=0.9, budget=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        queries.run_query(None, np.ones(10, np.float32),
                          array_oracle(np.ones(10)), q)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        queries.run_joint_query(None, np.ones(10, np.float32),
                                array_oracle(np.ones(10)), 0.9, 1.0)


# -- tau <= 0: threshold_select keeps A >= max(tau, 0) ------------------------

def test_selection_below_zero_matches_numpy():
    rng = np.random.default_rng(6)
    s = rng.uniform(-1.0, 1.0, 10_000).astype(np.float32)
    s[:5] = [0.0, -0.0, -1.0, np.float32(-0.25), 1.0]
    for tau in (float("-inf"), -1.0, -0.25, -1e-30, 0.0, 0.25, 1.0,
                float("inf")):
        want = np.nonzero(s >= tau)[0]
        np.testing.assert_array_equal(
            ts_ops.select_at_least(_t(s), tau).numpy(), want)
        assert int(ts_ops.count_at_least(_t(s), tau)) == want.size
    # the kernel's own semantics stay A >= max(tau, 0)
    assert ts_ops.threshold_select(_t(s), -0.5).numel() == int(
        (s >= 0).sum())


@pytest.mark.parametrize("target", ["recall", "precision"])
def test_negative_scores_with_tau_at_or_below_zero(target):
    """Scores in [-1, 1] with positives spread over them: RT's tau lands
    below 0, and R2 keeps the negative scores above it, as the
    reference's ``scores >= tau`` does."""
    rng = np.random.default_rng(7)
    n = 40_000
    s = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    labels = (rng.random(n) < 0.3 + 0.2 * s).astype(np.float32)
    spec = (dict(target="recall", gamma=0.95, method="noci")
            if target == "recall"
            else dict(target="precision", gamma=0.35, method="noci"))
    taus = []
    for k in range(3):
        key = jax.random.PRNGKey(k)
        want = jqueries.run_query(key, s, jarray_oracle(labels),
                                  jqueries.SUPGQuery(budget=1500, **spec))
        got = queries.run_query(np.asarray(key), s, array_oracle(labels),
                                queries.SUPGQuery(budget=1500, **spec),
                                device="cpu")
        _same_result(got, want)
        taus.append(got.tau)
    assert min(taus) <= 0.0, taus
