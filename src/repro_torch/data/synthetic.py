"""Synthetic corpora — the paper's Beta benchmarks (Table 2).

Proxy scores A(x) ~ Beta(alpha, beta), oracle labels O(x) ~
Bernoulli(A(x)): a perfectly calibrated proxy whose sharpness and positive
rate are set by (alpha, beta). The paper's pairs: (0.01, 1) with TPR
~0.5-1% and (0.01, 2) with TPR ~1%. `make_beta` draws on the host with
numpy (the JAX package's generator, value for value); `make_beta_on_device`
draws the same law on a device. `make_drift_pair` (and its device twin)
gives Table 3's drift pair: the Beta(0.01, 1) corpus and a Beta(0.01, 2)
shift. `make_miscalibrated` (sharpened scores) and `make_adversarial`
(an anti-correlated proxy) are the robustness corpora, value for value the
JAX package's.

Token corpora for the model plane: `make_token_corpus` plants the
`MARKER` tri-gram in a subset of random token records, and
`contains_marker` is the exact oracle, and `lm_batches` gives the
trainer's next-token batches (all value for value the JAX package's).
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


def make_drift_pair(n=1_000_000, seed=0):
    """(train, shifted) Beta datasets, Table 3's synthetic drift row:
    Beta(0.01, 1) at `seed` and Beta(0.01, 2) at ``seed + 1`` (the JAX
    package's pair, value for value)."""
    return (make_beta(n, 0.01, 1.0, seed=seed),
            make_beta(n, 0.01, 2.0, seed=seed + 1))


def make_miscalibrated(n=1_000_000, alpha=0.01, beta=1.0, seed=0,
                       temperature=3.0) -> BetaDataset:
    """A proxy that is *correlated but miscalibrated* (scores sharpened to
    A^(1/temperature)): guarantees must hold anyway (robustness tests)."""
    rng = np.random.default_rng(seed)
    probs = rng.beta(alpha, beta, n).astype(np.float32)
    labels = (rng.random(n) < probs).astype(np.float32)
    scores = probs ** (1.0 / temperature)
    return BetaDataset(scores=scores, labels=labels, alpha=alpha, beta=beta)


def make_adversarial(n=100_000, tpr=0.01, seed=0) -> BetaDataset:
    """An anti-correlated proxy: high scores on negatives. Defensive mixing
    must still deliver validity (quality will be poor — that's expected)."""
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < tpr).astype(np.float32)
    scores = np.where(labels > 0.5,
                      rng.beta(1, 20, n), rng.beta(20, 1, n)).astype(
                          np.float32)
    return BetaDataset(scores=scores, labels=labels, alpha=0, beta=0)


def make_drift_pair_on_device(n: int, seed: int = 0, device="cuda") \
        -> Tuple[Tuple[torch.Tensor, np.ndarray],
                 Tuple[torch.Tensor, np.ndarray]]:
    """`make_drift_pair`'s laws drawn on `device` by `make_beta_on_device`:
    ((scores, labels) of Beta(0.01, 1) at `seed`, (scores, labels) of
    Beta(0.01, 2) at ``seed + 1``)."""
    return (make_beta_on_device(n, 0.01, 1.0, seed=seed, device=device),
            make_beta_on_device(n, 0.01, 2.0, seed=seed + 1, device=device))


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


# ---------------------------------------------------------------------------
# Token corpora for the LM planes
# ---------------------------------------------------------------------------

MARKER = (7, 13, 42)   # planted n-gram; sequences containing it match


def make_token_corpus(num_records=4096, seq_len=128, vocab=128,
                      positive_rate=0.05, seed=0):
    """Deterministic synthetic corpus with planted positives.

    Returns (tokens (N, S) int32, labels (N,) float32). A record is positive
    iff the marker tri-gram occurs; the oracle is exact marker matching (the
    ground truth), the proxy is a model's confidence.
    """
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (num_records, seq_len), dtype=np.int32)
    # stamp the marker into a random subset at random offsets
    n_pos = int(num_records * positive_rate)
    pos_idx = rng.choice(num_records, n_pos, replace=False)
    offs = rng.integers(0, seq_len - len(MARKER), n_pos)
    for i, off in zip(pos_idx, offs):
        tokens[i, off:off + len(MARKER)] = MARKER
    labels = contains_marker(tokens).astype(np.float32)
    return tokens, labels


def contains_marker(tokens) -> np.ndarray:
    """Exact oracle predicate: does the marker tri-gram occur?"""
    t = np.asarray(tokens)
    hits = np.zeros(t.shape[0], bool)
    for off in range(t.shape[1] - len(MARKER) + 1):
        window = t[:, off:off + len(MARKER)]
        hits |= (window == np.asarray(MARKER)).all(axis=1)
    return hits


def lm_batches(key_seed, num_steps, global_batch, seq_len, vocab,
               start_step=0):
    """Deterministic next-token-prediction batches (resumable by step):
    step i's tokens come from ``default_rng((key_seed, i))``, (B, S+1)
    int32, split into tokens and labels shifted by one."""
    for step in range(start_step, num_steps):
        rng = np.random.default_rng((key_seed, step))
        toks = rng.integers(0, vocab, (global_batch, seq_len + 1),
                            dtype=np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
