"""Hierarchical importance sampling primitives for the selection engine.

The engine's cached sampling state is *hierarchical*: per (shard, scheme)
it keeps only the per-chunk raw masses accumulated during the sketch pass
— O(n / chunk_records) float64 values, host numpy — and resolves a
record-level draw at query time by streaming just the allocated chunks: a
categorical over chunk masses, then an exact inverse-CDF draw over freshly
computed within-chunk weights. A chunk's defensive-mixture mass is exactly
the sum of its records' p(x), so m(x) = (1/n)/p(x) stays exact with no
O(n) state. The formulas and dtypes are the JAX package's: per-record
p(x) in float32 (on the corpus's device), prefix sums in float64.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.bounds import sqrt32

DEFENSIVE_KAPPA = 0.1  # mass of the uniform mixture component (paper: 0.1)


def _scalar32(v: float, like: torch.Tensor) -> torch.Tensor:
    # A 0-d tensor on the data's device: elementwise arithmetic with it
    # rounds like numpy's float32-with-Python-scalar arithmetic, on the
    # CPU and the card alike (CUDA divides by a *host* scalar through its
    # reciprocal).
    return torch.tensor(float(np.float32(v)), dtype=torch.float32,
                        device=like.device)


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


def chunk_raw_masses(chunk: torch.Tensor) -> Tuple[float, float]:
    """Float64 Σ sqrt(A) and Σ A over one chunk (sentinels contribute 0).

    Each term is the float32 value, summed in float64 on the chunk's
    device; the summation order is torch's, so a sum can differ from the
    reference's numpy sum in its last bits."""
    a = torch.clamp(chunk.to(torch.float32), 0.0, 1.0)
    sums = torch.stack([sqrt32(a).to(torch.float64).sum(),
                        a.to(torch.float64).sum()]).cpu()
    return float(sums[0]), float(sums[1])


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
