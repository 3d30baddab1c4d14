"""SUPG query specs — Section 3 and Appendix A — and result metrics.

A query is:

    SELECT * FROM D WHERE oracle(x) ORACLE LIMIT s
    USING proxy_scores [RECALL | PRECISION] TARGET gamma WITH PROBABILITY 1-delta

`SUPGQuery` (RT/PT) and `JointSUPGQuery` (JT) are what
`repro_torch.core.engine.SelectionEngine` answers; `precision_of` and
`recall_of` score a selection against ground truth.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import thresholds


@dataclasses.dataclass(frozen=True)
class SUPGQuery:
    """Declarative RT/PT query spec (Section 3)."""

    target: str                 # 'recall' | 'precision'
    gamma: float                # target value in (0, 1)
    delta: float = 0.05         # failure probability
    budget: int = 10_000        # ORACLE LIMIT
    method: str = "is"          # 'is' (SUPG), 'uniform' (U-CI), 'nocI' (U-NoCI)
    weight_scheme: str = "sqrt"  # 'sqrt' (Theorem 1) | 'prop' (baseline)
    two_stage: bool = True      # PT only: Algorithm 5 vs one-stage
    defensive: bool = True      # Owen-Zhou defensive mixing
    min_step: int = thresholds.MIN_STEP

    def __post_init__(self):
        if self.target not in ("recall", "precision"):
            raise ValueError(f"bad target {self.target}")
        if not 0.0 < self.gamma < 1.0:
            raise ValueError("gamma must lie in (0,1)")
        if not 0.0 < self.delta < 1.0:
            raise ValueError("delta must lie in (0,1)")


@dataclasses.dataclass(frozen=True)
class JointSUPGQuery:
    """Declarative JT query spec (Appendix A).

    An RT stage at gamma_recall under stage_budget, then exhaustive oracle
    filtering of the candidate set (which makes the achieved precision
    exactly 1.0 >= gamma_precision; total oracle usage is unbounded by
    design).
    """
    gamma_recall: float
    gamma_precision: float = 1.0
    delta: float = 0.05
    stage_budget: int = 10_000
    method: str = "is"

    def __post_init__(self):
        if not 0.0 < self.gamma_recall < 1.0:
            raise ValueError("gamma_recall must lie in (0,1)")
        if not 0.0 < self.gamma_precision <= 1.0:
            raise ValueError("gamma_precision must lie in (0,1]")


def precision_of(selected, truth_mask) -> float:
    """Fraction of the selected records that are true positives."""
    sel = np.zeros_like(truth_mask, dtype=bool)
    sel[np.asarray(selected, np.int64)] = True
    denom = max(int(sel.sum()), 1)
    return float((sel & truth_mask).sum() / denom)


def recall_of(selected, truth_mask) -> float:
    """Fraction of the true positives that were selected."""
    sel = np.zeros_like(truth_mask, dtype=bool)
    sel[np.asarray(selected, np.int64)] = True
    denom = max(int(truth_mask.sum()), 1)
    return float((sel & truth_mask).sum() / denom)
