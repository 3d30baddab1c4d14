"""The port's calibration, multi-proxy fusion and robustness corpora
against the JAX package's (bit for bit: the modules are NumPy), and the
port's own copies of the reference's statistical claims that its
single-array query path makes testable: SUPG keeps its guarantee on an
anti-correlated proxy where U-NoCI misses, Platt scaling improves
calibration, fusion beats a single proxy, and the engine agrees with
`run_query`. The statistical tests run on the port alone (device cpu).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import calibration as jcalibration  # noqa: E402
from repro.core import multiproxy as jmultiproxy  # noqa: E402
from repro.core.oracle import array_oracle as jarray_oracle  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch import random as R  # noqa: E402
from repro_torch.core import calibration, multiproxy, queries  # noqa: E402
from repro_torch.core.engine import SelectionEngine  # noqa: E402
from repro_torch.core.oracle import array_oracle  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- bit for bit ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_robustness_corpora_match_reference(seed):
    for port, ref, kw in (
            (synthetic.make_miscalibrated, jsynthetic.make_miscalibrated,
             dict(n=30_000, alpha=0.05, beta=1.0, temperature=3.0)),
            (synthetic.make_miscalibrated, jsynthetic.make_miscalibrated,
             dict(n=10_000)),
            (synthetic.make_adversarial, jsynthetic.make_adversarial,
             dict(n=30_000, tpr=0.02)),
            (synthetic.make_adversarial, jsynthetic.make_adversarial,
             dict())):
        got, want = port(seed=seed, **kw), ref(seed=seed, **kw)
        _eq(got.scores, want.scores)
        _eq(got.labels, want.labels)
        assert got.scores.dtype == want.scores.dtype
        assert (got.alpha, got.beta) == (want.alpha, want.beta)


@pytest.mark.parametrize("weighted", [False, True])
def test_calibration_matches_reference(weighted):
    ds = jsynthetic.make_miscalibrated(20_000, 0.05, 1.0, seed=2)
    rng = np.random.default_rng(2)
    idx = rng.integers(0, 20_000, 2000)
    w = rng.random(2000) + 0.5 if weighted else None
    s, y = ds.scores[idx], ds.labels[idx]
    assert calibration.platt_fit(s, y, w) == jcalibration.platt_fit(s, y, w)
    a, b = calibration.platt_fit(s, y, w)
    _eq(calibration.platt_apply(ds.scores, a, b),
        jcalibration.platt_apply(ds.scores, a, b))
    knots, vals = calibration.isotonic_fit(s, y, w)
    jknots, jvals = jcalibration.isotonic_fit(s, y, w)
    _eq(knots, jknots)
    _eq(vals, jvals)
    _eq(calibration.isotonic_apply(ds.scores, knots, vals),
        jcalibration.isotonic_apply(ds.scores, jknots, jvals))
    for method in ("platt", "isotonic"):
        _eq(calibration.calibrated_weights(ds.scores, s, y, w, method),
            jcalibration.calibrated_weights(ds.scores, s, y, w, method))
    with pytest.raises(ValueError):
        calibration.calibrated_weights(ds.scores, s, y, method="beta")


def _two_proxies(n=60_000, seed=3):
    rng = np.random.default_rng(seed)
    latent = rng.beta(0.05, 1.0, n).astype(np.float32)
    labels = (rng.random(n) < latent).astype(np.float32)
    p1 = np.clip(latent + rng.normal(0, 0.08, n), 1e-4, 1).astype(np.float32)
    p2 = np.clip(latent + rng.normal(0, 0.08, n), 1e-4, 1).astype(np.float32)
    return np.stack([p1, p2], 1), labels


def test_fusion_matches_reference():
    scores, labels = _two_proxies(20_000)
    rng = np.random.default_rng(4)
    pilot = rng.choice(20_000, 600, replace=False)
    w = rng.random(600) + 0.5
    for weights in (None, w):
        beta = multiproxy.fit_fusion(scores[pilot], labels[pilot], weights)
        _eq(beta, jmultiproxy.fit_fusion(scores[pilot], labels[pilot],
                                         weights))
        _eq(multiproxy.apply_fusion(scores, beta),
            jmultiproxy.apply_fusion(scores, beta))
    fused, calls = multiproxy.fuse_proxies(0, scores, array_oracle(labels),
                                           pilot_budget=500)
    jfused, jcalls = jmultiproxy.fuse_proxies(0, scores,
                                              jarray_oracle(labels),
                                              pilot_budget=500)
    _eq(fused, jfused)
    assert calls == jcalls == 500


# -- the reference's statistical claims, on the port alone ----------------------

def test_supg_meets_target_on_adversarial_proxy_where_noci_misses():
    """Defensive mixing keeps IS-CI-R valid on an anti-correlated proxy
    (at most 2 misses in 10, the reference's bar); U-NoCI, with no
    correction, misses its target in more than a fifth of its runs."""
    ds = synthetic.make_adversarial(100_000, 0.02, seed=3)
    truth = ds.truth_mask()
    fails = {"is": 0, "noci": 0}
    for method in fails:
        for t in range(10):
            q = queries.SUPGQuery(target="recall", gamma=0.8, delta=0.05,
                                  budget=5000, method=method)
            res = queries.run_query(R.PRNGKey(t), ds.scores,
                                    array_oracle(ds.labels), q,
                                    device="cpu")
            assert res.oracle_calls <= 5000
            fails[method] += queries.recall_of(res.selected, truth) < 0.8
    assert fails["is"] <= 2, fails
    assert fails["noci"] > 2, fails


def test_platt_recovers_calibration():
    ds = synthetic.make_miscalibrated(100_000, 0.05, 1.0, seed=0,
                                      temperature=3.0)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, ds.scores.shape[0], 3000)
    a, b = calibration.platt_fit(ds.scores[idx], ds.labels[idx])
    cal = calibration.platt_apply(ds.scores, a, b)
    hi = ds.scores > np.quantile(ds.scores, 0.99)
    err_raw = abs(ds.scores[hi].mean() - ds.labels[hi].mean())
    err_cal = abs(cal[hi].mean() - ds.labels[hi].mean())
    assert err_cal < err_raw


def test_isotonic_and_calibrated_weights_monotone():
    rng = np.random.default_rng(1)
    s = rng.random(2000).astype(np.float32)
    y = (rng.random(2000) < s).astype(np.float32)
    knots, vals = calibration.isotonic_fit(s, y)
    assert np.all(np.diff(vals) >= -1e-6)
    out = calibration.isotonic_apply(np.linspace(0, 1, 50), knots, vals)
    assert np.all(np.diff(out) >= -1e-6)
    ds = synthetic.make_miscalibrated(20_000, 0.05, 1.0, seed=2)
    idx = rng.integers(0, 20_000, 2000)
    w = calibration.calibrated_weights(ds.scores, ds.scores[idx],
                                       ds.labels[idx])
    order = np.argsort(ds.scores[:500])
    assert np.all(np.diff(w[:500][order]) >= -1e-6)


def test_multiproxy_fusion_beats_single():
    """Two weak complementary proxies fuse into a stronger one (AUC)."""
    scores, labels = _two_proxies()
    fused, calls = multiproxy.fuse_proxies(0, scores, array_oracle(labels),
                                           pilot_budget=800)
    assert calls <= 800

    def auc(a):
        y = labels[np.argsort(-a)]
        tp = np.cumsum(y) / max(y.sum(), 1)
        fp = np.cumsum(1 - y) / max((1 - y).sum(), 1)
        return float(np.trapezoid(tp, fp))

    assert auc(fused) >= max(auc(scores[:, 0]), auc(scores[:, 1])) - 0.005


def test_engine_consistent_with_run_query():
    """The sharded, sketch-backed engine and the single-array path select
    consistent sets at matched keys and budgets: both meet their target
    (one miss allowed across three keys) and the set sizes agree within
    a factor of 5."""
    ds = synthetic.make_beta(60_000, 0.01, 1.0, seed=30)
    truth = ds.truth_mask()
    oracle = array_oracle(ds.labels)
    with SelectionEngine(np.array_split(ds.scores, 4), num_bins=1024,
                         device="cpu") as engine:
        for target, gamma, metric in (
                ("recall", 0.9, queries.recall_of),
                ("precision", 0.8, queries.precision_of)):
            q = queries.SUPGQuery(target=target, gamma=gamma, delta=0.05,
                                  budget=3000, method="is")
            misses_engine = misses_exact = 0
            for t in range(3):
                key = R.PRNGKey(100 + t)
                sel = engine.run(key, oracle, q)
                res = queries.run_query(key, ds.scores, oracle, q,
                                        device="cpu")
                got_e = metric(np.nonzero(np.concatenate(sel.masks))[0],
                               truth)
                misses_engine += got_e < gamma
                misses_exact += metric(res.selected, truth) < gamma
                n_e = max(sel.total_selected, 1)
                n_x = max(res.selected.shape[0], 1)
                assert 1 / 5 < n_e / n_x < 5, (target, t, n_e, n_x)
            assert misses_engine <= 1, target
            assert misses_exact <= 1, target
