"""Plain PyTorch threshold selection (nonzero formulation).

The CPU path of `ops.threshold_select`, and what the CUDA kernel is held
against on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def threshold32(tau: float) -> float:
    """The float32 comparison threshold max(tau, 0): one comparison keeps
    A >= tau and drops the -1 "unscored" sentinel."""
    return float(np.float32(max(float(tau), 0.0)))


def threshold_select_ref(scores: torch.Tensor, tau: float) -> torch.Tensor:
    """Ascending int64 indices of {i : scores[i] >= max(tau, 0)}."""
    thr = torch.tensor(threshold32(tau), dtype=torch.float32)
    return torch.nonzero(scores.reshape(-1) >= thr).reshape(-1)
