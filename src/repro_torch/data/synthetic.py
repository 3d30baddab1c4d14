"""Synthetic corpora — the paper's Beta benchmarks (Table 2).

Proxy scores A(x) ~ Beta(alpha, beta), oracle labels O(x) ~
Bernoulli(A(x)): a perfectly calibrated proxy whose sharpness and positive
rate are set by (alpha, beta). The paper's pairs: (0.01, 1) with TPR
~0.5-1% and (0.01, 2) with TPR ~1%. `make_beta` draws on the host with
numpy (the JAX package's generator, value for value); `make_beta_on_device`
draws the same law on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Records `make_beta_on_device` draws at a time (bounds its float64 scratch).
DEVICE_BLOCK = 1 << 24


@dataclasses.dataclass
class BetaDataset:
    """Scores, labels and the (alpha, beta) they were drawn with."""

    scores: np.ndarray       # A(x), float32 in [0,1]
    labels: np.ndarray       # O(x), float32 {0,1}
    alpha: float
    beta: float

    @property
    def tpr(self) -> float:
        """Positive rate of the labels."""
        return float(self.labels.mean())

    def truth_mask(self) -> np.ndarray:
        """Boolean ground-truth mask."""
        return self.labels > 0.5


def make_beta(n=1_000_000, alpha=0.01, beta=1.0, seed=0,
              noise_std=0.0) -> BetaDataset:
    """n records: A ~ Beta(alpha, beta) float32 (optionally plus clipped
    Gaussian noise), O ~ Bernoulli(A), from numpy's generator at `seed`."""
    rng = np.random.default_rng(seed)
    probs = rng.beta(alpha, beta, n).astype(np.float32)
    labels = (rng.random(n) < probs).astype(np.float32)
    scores = probs
    if noise_std > 0:
        scores = np.clip(probs + rng.normal(0, noise_std, n)
                         .astype(np.float32), 0.0, 1.0)
    return BetaDataset(scores=scores, labels=labels, alpha=alpha, beta=beta)


def make_beta_on_device(n: int, alpha: float = 0.01, beta: float = 1.0,
                        seed: int = 0, device="cuda") \
        -> Tuple[torch.Tensor, np.ndarray]:
    """The Beta corpus of `make_beta`, drawn on `device` from `seed`:
    float32 scores A ~ Beta(alpha, beta) on the device, and host float32
    labels O ~ Bernoulli(A). Beta is drawn as X / (X + Y) from float64
    Gamma(alpha), Gamma(beta) draws, `DEVICE_BLOCK` records at a time. The
    stream differs from numpy's, so the corpus matches `make_beta` in law,
    not in value."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    scores = torch.empty(n, dtype=torch.float32, device=device)
    labels = torch.empty(n, dtype=torch.bool, device=device)
    for start in range(0, n, DEVICE_BLOCK):
        m = min(DEVICE_BLOCK, n - start)
        x = torch._standard_gamma(torch.full(
            (m,), float(alpha), dtype=torch.float64, device=device),
            generator=g)
        y = torch._standard_gamma(torch.full(
            (m,), float(beta), dtype=torch.float64, device=device),
            generator=g)
        a = (x / (x + y)).to(torch.float32)
        scores[start:start + m] = a
        labels[start:start + m] = torch.rand(
            m, generator=g, device=device) < a
    return scores, labels.cpu().numpy().astype(np.float32)
