"""Oracle-sample selection: uniform and optimal importance sampling.

Two planes share the formulas and dtypes of the JAX package:

* the single-array samplers of `repro_torch.core.queries.run_query`
  (Algorithm 1 over one score tensor): uniform i.i.d. draws (the
  NoScope / probabilistic-predicates baseline), importance draws with the
  paper's optimal weights w ∝ sqrt(A(x)) (Theorem 1) or the proportional
  baseline w ∝ A(x), defensive mixing w ← 0.9·w/||w||₁ + 0.1/|D| (Owen &
  Zhou), and the reweighting factors m(x) = u(x)/w(x). Draws are with
  replacement, by inverse CDF over the whole array, on the scores'
  device. Every value is the reference's to the bit: XLA's summation and
  prefix-sum orders (`bounds.tree_sum`, `bounds.blocked_cumsum`), the
  FMA its CPU backend contracts the defensive mix into under ``jit``,
  its subnormals read as zero, and jax's binary search. The card computes
  the same bits: its float32 ``torch.cumsum`` is not deterministic (a
  parallel scan whose association depends on timing), so the CDF takes
  the blocked order there too.
* the engine's cached sampling state, *hierarchical*: per (shard, scheme)
  only the per-chunk raw masses accumulated during the sketch pass —
  O(n / chunk_records) float64 values, host numpy — and a record-level
  draw resolved at query time by streaming just the allocated chunks: a
  categorical over chunk masses, then an exact inverse-CDF draw over
  freshly computed within-chunk weights. A chunk's defensive-mixture mass
  is exactly the sum of its records' p(x), so m(x) = (1/n)/p(x) stays
  exact with no O(n) state: per-record p(x) in float32 (on the corpus's
  device), prefix sums in float64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as prandom
from repro_torch.core import bounds
from repro_torch.core.bounds import sqrt32

DEFENSIVE_KAPPA = 0.1  # mass of the uniform mixture component (paper: 0.1)


def _scalar32(v: float, like: torch.Tensor) -> torch.Tensor:
    # A 0-d tensor on the data's device: elementwise arithmetic with it
    # rounds like numpy's float32-with-Python-scalar arithmetic, on the
    # CPU and the card alike (CUDA divides by a *host* scalar through its
    # reciprocal).
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


class WeightedSample(NamedTuple):
    """A sampling round's draws, on the scores' device.

    indices:  (s,) int64 record indices (with replacement)
    m:        (s,) float32 reweighting factors m(x) = u(x)/w(x)
    w:        (s,) float32 the sampling probabilities of the drawn records
    """

    indices: torch.Tensor
    m: torch.Tensor
    w: torch.Tensor


def _key(key) -> np.ndarray:
    return np.asarray(key, np.uint32)


def uniform_probs(n: int, device="cpu") -> torch.Tensor:
    """The uniform distribution over n records, float32."""
    return torch.full((n,), float(np.float32(1.0 / n)), dtype=torch.float32,
                      device=device)


def sqrt_proxy_weights(scores, defensive=True,
                       kappa=DEFENSIVE_KAPPA) -> torch.Tensor:
    """Theorem-1 optimal weights: w ∝ sqrt(A(x)) with defensive mixing,
    as the reference's jitted `draw_oracle_sample` computes them."""
    return _normalize_and_mix(sqrt32(_clip01(scores)), defensive, kappa)


def proportional_proxy_weights(scores, defensive=True,
                               kappa=DEFENSIVE_KAPPA) -> torch.Tensor:
    """Baseline weights w ∝ A(x) — provably no better than uniform
    (Sec 10.2)."""
    return _normalize_and_mix(_clip01(scores), defensive, kappa)


def _clip01(scores) -> torch.Tensor:
    """clip(A, 0, 1) in float32, subnormals as zero (`bounds.flush32`)."""
    return bounds.flush32(torch.clamp(
        torch.as_tensor(scores, dtype=torch.float32), 0.0, 1.0))


def _normalize_and_mix(w: torch.Tensor, defensive: bool,
                       kappa: float) -> torch.Tensor:
    """w / Σw, then (1-kappa)·w + kappa/n as one FMA: XLA's CPU backend
    contracts the mix under ``jit``."""
    n = w.numel()
    tot = bounds.tree_sum(w)
    if bool(tot > 0):
        w = bounds.flush32(w / torch.clamp_min(tot, 1e-30))
    else:       # degenerate all-zero proxy: uniform
        w = uniform_probs(n, w.device)
    if defensive:
        keep = _scalar32(1.0 - kappa, w)
        floor = _scalar32(kappa / n, w)
        w = bounds.fma32(keep, w, floor)
    return w


def sample_uniform(key, n: int, s: int, device="cpu") -> WeightedSample:
    """Uniform with-replacement sample of s records out of n
    (``jax.random.randint``'s draws)."""
    idx = torch.from_numpy(prandom.randint(_key(key), (s,), 0, n)
                           .astype(np.int64)).to(device)
    m = torch.ones(s, dtype=torch.float32, device=device)  # u/w = 1
    return WeightedSample(idx, m, torch.full(
        (s,), float(np.float32(1.0 / n)), dtype=torch.float32,
        device=device))


def _searchsorted_left(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """jax's ``searchsorted(side="left")`` (its "scan" method): the same
    binary search, so an index is the reference's even where rounding
    leaves the CDF a step out of order."""
    n = cdf.numel()
    low = torch.zeros(u.shape, dtype=torch.int64, device=cdf.device)
    high = torch.full(u.shape, n, dtype=torch.int64, device=cdf.device)
    for _ in range(int(np.ceil(np.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = u <= cdf[mid]
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def _inverse_cdf_draw(key, probs: torch.Tensor, s: int) -> torch.Tensor:
    """s with-replacement categorical draws in O(n + s log n) memory: the
    float32 CDF renormalized by its last entry, uniform draws
    (``jax.random.uniform``) and a left search."""
    cdf = bounds.blocked_cumsum(probs)
    cdf = bounds.flush32(cdf / cdf[-1])
    u = torch.from_numpy(prandom.uniform(_key(key), (s,))).to(probs.device)
    idx = _searchsorted_left(cdf, u)
    return torch.clamp(idx, 0, probs.numel() - 1)


def _floor38(w: torch.Tensor) -> torch.Tensor:
    """max(w, 1e-38) as XLA's CPU code has it: 1e-38 is a float32
    subnormal, read as 0 (`bounds.flush32`)."""
    return bounds.flush32(torch.clamp_min(w, 1e-38))


def _reweight(n_pop, w_drawn: torch.Tensor) -> torch.Tensor:
    """m = (1/n_pop) / max(w, 1e-38), 1/n_pop rounded to float32 first."""
    return torch.div(_scalar32(1.0 / n_pop, w_drawn), _floor38(w_drawn))


def sample_weighted(key, probs, s: int) -> WeightedSample:
    """With-replacement sample from an explicit probability vector."""
    probs = bounds.flush32(torch.as_tensor(probs, dtype=torch.float32))
    idx = _inverse_cdf_draw(key, probs, s)
    w_drawn = probs[idx]
    return WeightedSample(idx, _reweight(probs.numel(), w_drawn), w_drawn)


def sample_weighted_masked(key, probs, mask, s: int,
                           n_sub: Optional[int] = None) -> WeightedSample:
    """Weighted sampling restricted to records where mask=1 (stage 2 of
    PT). Probabilities are renormalized over the masked subset; m(x) is
    taken w.r.t. the *uniform distribution on the masked subset* (the
    paper's stage-2 estimator treats D' as the population).

    `probs` None means uniform over the masked records, and `n_sub`
    (used only then) is their number, counted by the caller (`run_query`
    counts D' with one ``threshold_count`` launch on the card): the
    reference's ``probs = 1`` with both sums taken as that count. Float32
    sums of 0/1 are exact below 2^24 records, so this is the reference's
    bits there."""
    mask = torch.as_tensor(mask).to(torch.float32)
    if probs is None:
        if n_sub is None:
            raise ValueError("uniform masked sampling needs n_sub")
        tot = torch.tensor(float(n_sub), dtype=torch.float32,
                           device=mask.device)
        probs = mask
    else:
        probs = bounds.flush32(torch.as_tensor(probs, dtype=torch.float32)
                               * mask)
        tot = bounds.tree_sum(probs)
        n_sub = bounds.tree_sum(mask)
    n_sub = torch.clamp_min(torch.as_tensor(n_sub, dtype=torch.float32)
                            .to(mask.device), 1.0)
    probs = bounds.flush32(probs / torch.clamp_min(tot, 1e-30)) \
        if bool(tot > 0) else mask / n_sub
    idx = _inverse_cdf_draw(key, probs, s)
    w_drawn = probs[idx]
    m = torch.div(torch.div(_scalar32(1.0, n_sub), n_sub),
                  _floor38(w_drawn))
    return WeightedSample(idx, m, w_drawn)


def draw_oracle_sample(key, scores: torch.Tensor, s: int, scheme="sqrt",
                       defensive=True) -> WeightedSample:
    """One-stop sampler used by the query layer, on the scores' device.

    scheme: 'uniform' | 'sqrt' (Theorem 1 optimal) | 'prop' (baseline).
    Computes what the reference's jitted sampler computes."""
    scores = torch.as_tensor(scores, dtype=torch.float32)
    n = scores.numel()
    if scheme == "uniform":
        return sample_uniform(key, n, s, device=scores.device)
    if scheme == "sqrt":
        probs = sqrt_proxy_weights(scores, defensive)
    elif scheme == "prop":
        probs = proportional_proxy_weights(scores, defensive)
    else:
        raise ValueError(f"unknown sampling scheme: {scheme}")
    return sample_weighted(key, probs, s)


def chunk_raw_masses(scores_chunk) -> Tuple[float, float]:
    """Float64 Σ sqrt(A) and Σ A over one chunk (sentinels contribute 0),
    host numpy as the reference's: the terms float32, summed by numpy.
    A parity helper with no caller on the port's path: a build takes the
    masses from its `score_hist` launch."""
    a = np.clip(np.asarray(scores_chunk, np.float32), 0.0, 1.0)
    return (float(np.sum(np.sqrt(a), dtype=np.float64)),
            float(np.sum(a, dtype=np.float64)))


def normalized_cdf(weights: torch.Tensor) -> torch.Tensor:
    """Inclusive float64 prefix CDF, renormalized to end exactly at 1."""
    cdf = torch.cumsum(weights.to(torch.float64), 0)
    total = float(cdf[-1]) if cdf.numel() else 0.0
    if not total > 0:
        raise ValueError("normalized_cdf needs positive total mass")
    return cdf / total


def draw_from_cdf(cdf, u) -> torch.Tensor:
    """Vectorized inverse-CDF draws: i with cdf[i-1] <= u < cdf[i] (int64,
    on the CDF's device). Host numpy CDFs are taken without a copy."""
    cdf = torch.as_tensor(cdf, dtype=torch.float64)
    u = torch.as_tensor(np.asarray(u, np.float64), device=cdf.device)
    idx = torch.searchsorted(cdf, u)
    return torch.clamp_max(idx, cdf.shape[0] - 1)


class ChunkMasses(NamedTuple):
    """Per-chunk raw sampling masses for one shard (host numpy,
    O(n_chunks)). `sizes` counts *all* records in the chunk (sentinels
    included): the defensive uniform component gives every record mass."""

    sum_sqrt: np.ndarray   # (n_chunks,) float64 Σ sqrt(clip(A)) per chunk
    sum_a: np.ndarray      # (n_chunks,) float64 Σ clip(A) per chunk
    sizes: np.ndarray      # (n_chunks,) int64 record count per chunk

    def raw(self, scheme: str) -> np.ndarray:
        """The raw masses of one weight scheme ('sqrt' or 'prop')."""
        return self.sum_sqrt if scheme == "sqrt" else self.sum_a

    @classmethod
    def empty(cls) -> "ChunkMasses":
        """An empty shard's masses."""
        return cls(np.empty(0, np.float64), np.empty(0, np.float64),
                   np.empty(0, np.int64))


def defensive_chunk_mass(raw: np.ndarray, sizes: np.ndarray, z: float,
                         kappa: float, n_total: int) -> np.ndarray:
    """Total defensive-mixture draw probability of each chunk:
    (1-kappa)·Σraw/Z + kappa·|chunk|/n."""
    z = max(float(z), 1e-30)
    return ((1.0 - kappa) * np.asarray(raw, np.float64) / z
            + kappa * np.asarray(sizes, np.float64) / n_total)


def append_cdf(cum: np.ndarray, new_masses) -> np.ndarray:
    """Extend an *unnormalized* float64 chunk-mass prefix sum: continuing
    the sequential fold from the existing tail reproduces, bit for bit,
    the prefix sum of a cold pass over the concatenated masses.

    >>> full = np.cumsum(np.asarray([0.3, 0.2, 0.5, 0.1], np.float64))
    >>> grown = append_cdf(np.cumsum(np.asarray([0.3, 0.2], np.float64)),
    ...                    [0.5, 0.1])
    >>> bool(np.array_equal(full, grown))
    True
    """
    new = np.asarray(new_masses, np.float64)
    cum = np.asarray(cum, np.float64)
    if cum.size == 0:
        return np.cumsum(new)
    if new.size == 0:
        return cum.copy()
    return np.concatenate(
        [cum, np.cumsum(np.concatenate([cum[-1:], new]))[1:]])


def chunk_mass_cdf(raw: np.ndarray, sizes: np.ndarray, z: float,
                   kappa: float, n_total: int) -> Tuple[float, np.ndarray]:
    """One shard's (total mass, normalized chunk-mass CDF) for the
    hierarchical draw."""
    m_c = defensive_chunk_mass(raw, sizes, z, kappa, n_total)
    total = float(m_c.sum())
    if not total > 0:
        raise ValueError(
            "shard has no sampling mass (kappa=0 with an all-zero proxy?)")
    return total, append_cdf(np.empty(0, np.float64), m_c) / total


def defensive_probs(chunk: torch.Tensor, scheme: str, z: float,
                    kappa: float, n_total: int) -> torch.Tensor:
    """Global float32 draw probabilities p(x) of one chunk's records,
    ``(1-kappa)·raw/Z + kappa/n`` with every constant rounded to float32,
    as the reference's numpy expression computes it."""
    z = max(float(z), 1e-30)
    a = torch.clamp(chunk.to(torch.float32), 0.0, 1.0)
    raw = sqrt32(a) if scheme == "sqrt" else a
    p = torch.div(raw * _scalar32(1.0 - kappa, a), _scalar32(z, a))
    return p + _scalar32(kappa / n_total, a)
