"""Plain PyTorch score sketch (scatter-add formulation) and chunk masses.

The CPU path of `ops.score_hist`, and what the CUDA kernel is held against
on the card. Float32 `index_add_` on the CPU adds in record order, as the
JAX package's scatter-add does, so the two sketches are bit-equal there.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.bounds import sqrt32


def bin_index(scores: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Bin id in [0, B) of each score: b = min(floor(clip(A,0,1)*B), B-1)."""
    a = torch.clamp(scores.to(torch.float32), 0.0, 1.0)
    return torch.clamp_max((a * num_bins).to(torch.int64), num_bins - 1)


def score_hist_ref(scores: torch.Tensor, num_bins: int = 4096) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(counts, sum_w, sum_a), each (num_bins,) float32; entries < 0 (the
    unscored sentinel) are ignored."""
    s = scores.to(torch.float32).reshape(-1)
    valid = (s >= 0.0).to(torch.float32)
    a = torch.clamp(s, 0.0, 1.0)
    ids = bin_index(s, num_bins)

    def scatter(values):
        return torch.zeros(num_bins, dtype=torch.float32,
                           device=s.device).index_add_(0, ids, values)

    return scatter(valid), scatter(sqrt32(a) * valid), scatter(a * valid)


def chunk_masses_ref(scores: torch.Tensor) -> torch.Tensor:
    """(2,) float64 on the scores' device: Σ sqrt(clip(A,0,1)) and
    Σ clip(A,0,1), each term the float32 value (its square root correctly
    rounded, `sqrt32`), summed in float64 in torch's order; sentinels
    contribute 0. The chunk's raw sampling masses."""
    a = torch.clamp(scores.to(torch.float32), 0.0, 1.0)
    return torch.stack([sqrt32(a).to(torch.float64).sum(),
                        a.to(torch.float64).sum()])
