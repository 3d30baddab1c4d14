"""Proxy-score calibration from sampled oracle labels.

Theorem 1's optimal √A weights assume the proxy is *approximately
calibrated* (A(x) ≈ Pr[O(x)=1 | A(x)]). Production proxies rarely are —
DNN confidences are systematically over-sharp. The guarantees never depend
on calibration (Section 5.3), but sample efficiency does, so recalibrating
the proxy with a few hundred of the already-budgeted labels is free quality.

Two standard monotone calibrators (monotonicity preserves the threshold
semantics of Section 4.2 — a monotone remap of A never changes D(tau) sets,
only the *weights* improve):

  * Platt scaling: logistic fit sigma(a*logit(s)+b) by Newton steps on the
    binomial likelihood — 2 parameters, robust at tiny positive counts;
  * isotonic binning: PAV (pool-adjacent-violators) over score-sorted
    labels with importance reweighting.

`calibrated_weights` composes either with the Theorem-1 √· rule. NumPy
only, a copy of the JAX package's module (the same bits).
"""
from __future__ import annotations

import numpy as np


def _logit(p, eps=1e-6):
    """logit(p), p clipped to [eps, 1 - eps]."""
    p = np.clip(p, eps, 1 - eps)
    return np.log(p / (1 - p))


def platt_fit(scores, labels, weights=None, iters=50):
    """Weighted logistic regression on logit(score) -> (a, b)."""
    x = _logit(np.asarray(scores, np.float64))
    y = np.asarray(labels, np.float64)
    w = np.ones_like(y) if weights is None else np.asarray(weights,
                                                           np.float64)
    a, b = 1.0, 0.0
    for _ in range(iters):
        z = a * x + b
        p = 1.0 / (1.0 + np.exp(-z))
        g_a = np.sum(w * (p - y) * x)
        g_b = np.sum(w * (p - y))
        s = np.maximum(w * p * (1 - p), 1e-12)
        h_aa = np.sum(s * x * x) + 1e-9
        h_ab = np.sum(s * x)
        h_bb = np.sum(s) + 1e-9
        det = h_aa * h_bb - h_ab * h_ab
        if det <= 1e-12:
            break
        da = (h_bb * g_a - h_ab * g_b) / det
        db = (h_aa * g_b - h_ab * g_a) / det
        a, b = a - da, b - db
        if abs(da) + abs(db) < 1e-10:
            break
    return float(a), float(b)


def platt_apply(scores, a, b):
    """Platt-calibrated scores sigma(a·logit(s) + b), float32."""
    z = a * _logit(np.asarray(scores, np.float64)) + b
    return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def isotonic_fit(scores, labels, weights=None):
    """PAV isotonic regression; returns (knot_scores, knot_values)."""
    order = np.argsort(scores)
    s = np.asarray(scores, np.float64)[order]
    y = np.asarray(labels, np.float64)[order]
    w = (np.ones_like(y) if weights is None
         else np.asarray(weights, np.float64)[order])
    # pool adjacent violators
    vals, wts, lo = [], [], []
    for i in range(len(y)):
        vals.append(y[i])
        wts.append(w[i])
        lo.append(s[i])
        while len(vals) > 1 and vals[-2] >= vals[-1]:
            v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / \
                (wts[-2] + wts[-1])
            wts[-2] += wts[-1]
            vals[-2] = v
            vals.pop()
            wts.pop()
            lo.pop()
    return np.asarray(lo, np.float32), np.asarray(vals, np.float32)


def isotonic_apply(scores, knots, values):
    """Isotonic-calibrated scores: the value of the last knot <= each."""
    idx = np.searchsorted(knots, np.asarray(scores, np.float32),
                          side="right") - 1
    idx = np.clip(idx, 0, len(values) - 1)
    return values[idx]


def calibrated_weights(scores, sample_scores, sample_labels,
                       sample_m=None, method="platt"):
    """Recalibrate the full score array from a labeled sample, then return
    Theorem-1 optimal weights sqrt(calibrated). Monotone by construction."""
    if method == "platt":
        a, b = platt_fit(sample_scores, sample_labels, sample_m)
        cal = platt_apply(scores, a, b)
    elif method == "isotonic":
        knots, vals = isotonic_fit(sample_scores, sample_labels, sample_m)
        cal = isotonic_apply(scores, knots, vals)
    else:
        raise ValueError(method)
    return np.sqrt(np.clip(cal, 0.0, 1.0))
