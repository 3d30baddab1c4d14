"""Multiple-proxy fusion (the paper's Section 8 future-work direction).

Given M proxy score vectors (e.g. a motion detector, a cheap CNN, and a
BERT-sized scorer in the legal-discovery case), SUPG's algorithms consume a
single A(x). We fuse with a *stacked logistic* model fit on a small labeled
pilot sample (part of the oracle budget):

    A_fused(x) = sigma( b0 + sum_m b_m * logit(A_m(x)) )

Fitting uses the importance-reweighted pilot labels, so the pilot can come
from any defensive-mixed proposal. Because the SUPG guarantees never assume
anything about A (Section 5.3), running the standard estimators on A_fused
preserves validity; fusion only improves the quality/variance side. A
pilot/holdout split guards against the fused proxy overfitting M >> pilot.
NumPy only, a copy of the JAX package's module (the same bits).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.calibration import _logit


def fit_fusion(pilot_scores, pilot_labels, weights=None, iters=80,
               l2=1e-3):
    """pilot_scores: (s, M); labels: (s,). Returns beta (M+1,)."""
    x = _logit(np.asarray(pilot_scores, np.float64))
    y = np.asarray(pilot_labels, np.float64)
    s, m = x.shape
    w = np.ones(s) if weights is None else np.asarray(weights, np.float64)
    xb = np.concatenate([np.ones((s, 1)), x], axis=1)
    beta = np.zeros(m + 1)
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-xb @ beta))
        g = xb.T @ (w * (p - y)) + l2 * beta
        h = (xb * (w * p * (1 - p))[:, None]).T @ xb + l2 * np.eye(m + 1)
        try:
            step = np.linalg.solve(h, g)
        except np.linalg.LinAlgError:
            break
        beta = beta - step
        if np.max(np.abs(step)) < 1e-10:
            break
    return beta


def apply_fusion(scores, beta):
    """scores: (n, M) -> fused (n,) in [0,1]."""
    x = _logit(np.asarray(scores, np.float64))
    xb = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
    return (1.0 / (1.0 + np.exp(-xb @ beta))).astype(np.float32)


def fuse_proxies(key_seed, all_scores, oracle_fn, pilot_budget=500):
    """Spend `pilot_budget` oracle calls on a uniform pilot, fit the fusion,
    return (fused_scores, pilot_calls_used). all_scores: (n, M)."""
    n = all_scores.shape[0]
    rng = np.random.default_rng(key_seed)
    pilot_idx = rng.choice(n, size=min(pilot_budget, n), replace=False)
    pilot_labels = np.asarray(oracle_fn(pilot_idx), np.float32)
    beta = fit_fusion(all_scores[pilot_idx], pilot_labels)
    return apply_fusion(all_scores, beta), len(pilot_idx)
