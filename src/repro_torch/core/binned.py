"""Binned score sketches — the selection plane's dataset-side statistics.

Every *global* quantity the SUPG algorithms need from the corpus comes
from one fixed-width histogram sketch, built in one pass:

  counts[b]    |{x : A(x) in bin b}|      -> rank -> tau (D' cutoff)
  sum_w[b]     sum of sqrt(A(x)) in bin b -> normalizer of Theorem-1 weights
  sum_a[b]     sum of A(x) in bin b       -> normalizer of 'prop' weights

The per-chunk pass is the `score_hist` kernel on the card (its plain
version on the CPU). Sketches are float32 tensors on the corpus's device;
merging is the reference's left fold, and the normalizers and the rank
lookup sum in its order (`bounds.tree_sum`, `bounds.blocked_cumsum`).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import bounds, sampling
from repro_torch.kernels.score_hist import ops as hist_ops

DEFAULT_BINS = 4096


class ScoreSketch(NamedTuple):
    """Per-bin record counts, Σ sqrt(A) and Σ A, each (B,) float32."""

    counts: torch.Tensor
    sum_w: torch.Tensor
    sum_a: torch.Tensor

    @property
    def num_bins(self) -> int:
        """Number of bins B."""
        return int(self.counts.shape[0])


def empty_sketch(num_bins: int, device) -> ScoreSketch:
    """The all-zero sketch (an empty shard's)."""
    z = torch.zeros(num_bins, dtype=torch.float32, device=device)
    return ScoreSketch(z, z.clone(), z.clone())


def build_sketch(scores: torch.Tensor, num_bins: int = DEFAULT_BINS) \
        -> ScoreSketch:
    """One-pass sketch of a score tensor (entries < 0 are ignored)."""
    return ScoreSketch(*hist_ops.score_hist(scores, num_bins))


def chunk_sketch_stats(chunk: torch.Tensor, num_bins: int = DEFAULT_BINS) \
        -> Tuple[ScoreSketch, float, float]:
    """One construction-pass unit: a chunk's sketch plus its float64 raw
    sampling masses (Σ sqrt(A), Σ A) for the hierarchical sampler."""
    s_sqrt, s_a = sampling.chunk_raw_masses(chunk)
    return build_sketch(chunk, num_bins), s_sqrt, s_a


def merge_sketches(*sketches: ScoreSketch) -> ScoreSketch:
    """Elementwise sum, a left fold in argument order (as the reference's
    ``sum(...)``), so appending shards reproduces a cold fold bit for bit."""
    return ScoreSketch(
        sum(s.counts for s in sketches),
        sum(s.sum_w for s in sketches),
        sum(s.sum_a for s in sketches))


def rank_to_threshold(sketch: ScoreSketch, rank: int) -> float:
    """Conservative tau with |{A >= tau}| >= rank, from bin counts: the
    lower edge of the bin where the count from the top first reaches
    `rank` (rounding tau down gives a superset)."""
    b = sketch.num_bins
    cum = bounds.blocked_cumsum(torch.flip(sketch.counts, (0,)))
    reached = cum >= torch.tensor(float(np.float32(rank)),
                                  dtype=torch.float32, device=cum.device)
    j = int(torch.argmax(reached.to(torch.uint8))) if bool(reached.any()) \
        else b - 1
    return float(np.float32(b - 1 - j) / np.float32(b))


def weight_normalizers(sketch: ScoreSketch):
    """Global Σ sqrt(A), Σ A and n (0-d float32 tensors): the denominators
    of Theorem-1 and 'prop' weights, in the reference's summation order."""
    return (bounds.tree_sum(sketch.sum_w), bounds.tree_sum(sketch.sum_a),
            bounds.tree_sum(sketch.counts))
