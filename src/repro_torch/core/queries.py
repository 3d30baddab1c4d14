"""SUPG query execution — Algorithm 1 plus RT/PT/JT semantics (Section 3).

A query is:

    SELECT * FROM D WHERE oracle(x) ORACLE LIMIT s
    USING proxy_scores [RECALL | PRECISION] TARGET gamma WITH PROBABILITY 1-delta

`run_query` drives Algorithm 1 over one score tensor:

    S   <- SampleOracle(D)            (core.sampling — uniform / sqrt-IS)
    tau <- EstimateTau(S)             (core.thresholds — Algs. 2-5)
    R   <- {x in S : O(x)=1}  ∪  {x in D : A(x) >= tau}

The sampled positives R1 are always included. R2 is one
``threshold_select`` launch over the whole array on the card (its plain
version on the CPU), and PT's two-stage |D'| one ``threshold_count``
launch; both keep A >= max(tau, 0), so where tau < 0 the records in
[tau, 0) are added by a plain compare (`select_at_least` and
`count_at_least` in `kernels.threshold_select.ops`). Joint-target (JT)
queries (Appendix A) run the RT estimator then exhaustively filter false
positives through the same labeling channel. `SUPGQuery` (RT/PT) and `JointSUPGQuery` (JT) are also
what `repro_torch.core.engine.SelectionEngine` answers; `precision_of`
and `recall_of` score a selection against ground truth.

>>> import numpy as np
>>> from repro_torch.core import run_query, SUPGQuery, array_oracle
>>> scores = np.linspace(0.0, 1.0, 2000, dtype=np.float32)
>>> labels = (scores > 0.7).astype(np.float32)
>>> q = SUPGQuery(target="recall", gamma=0.8, budget=400)
>>> res = run_query(None, scores, array_oracle(labels), q, device="cpu")
>>> bool(res.oracle_calls <= 400), res.selected.dtype
(True, dtype('int64'))
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import sampling, thresholds
from repro_torch.core.oracle import BudgetLedger, as_oracle_client
from repro_torch.device import resolve_device
from repro_torch.kernels.threshold_select import ops as select_ops


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


@dataclasses.dataclass
class QueryResult:
    """What `run_query` returns (host numpy and Python numbers)."""

    selected: np.ndarray        # sorted int64 record indices of R = R1 ∪ R2
    tau: float                  # proxy threshold used for R2
    oracle_calls: int           # budget actually consumed
    corrected_target: float     # gamma' diagnostics (RT)
    n_sampled_positives: int    # |R1|

    def mask(self, n: int) -> np.ndarray:
        """The selection as a boolean mask over n records."""
        m = np.zeros(n, bool)
        m[self.selected] = True
        return m


def _scores_on(scores, device: torch.device) -> torch.Tensor:
    """A score vector (numpy or tensor) as contiguous float32 on `device`."""
    if not isinstance(scores, torch.Tensor):
        scores = torch.from_numpy(np.ascontiguousarray(scores, np.float32))
    return scores.to(device=device, dtype=torch.float32).reshape(
        -1).contiguous()


def _union_into(r2: np.ndarray, r1: np.ndarray) -> np.ndarray:
    """``np.union1d(r1, r2)`` for an ascending, duplicate-free r2 (R2,
    millions of records) and a sorted unique r1 (R1, at most the budget):
    R1's missing records inserted into R2 in one pass, no set operation
    over R2."""
    r1 = np.asarray(r1, np.int64)
    r2 = np.asarray(r2, np.int64)
    if r2.size == 0:
        return r1.copy()
    at = np.searchsorted(r2, r1)
    new = r1[r2[np.minimum(at, r2.size - 1)] != r1]
    return np.insert(r2, np.searchsorted(r2, new), new)


def run_query(key, scores, oracle_fn, query: SUPGQuery, *,
              device=None) -> QueryResult:
    """Execute a SUPG query against proxy scores and an oracle callback.

    key:       a jax-format uint32[2] key (`repro_torch.random`), or None
               for PRNGKey(0).
    scores:    (n,) proxy scores A(x) of every record, numpy or a tensor;
               the query runs on `device`, ``cuda`` unless the caller
               names another.
    oracle_fn: callback indices -> {0,1} labels, or an
               `oracle.OracleClient` (e.g. a shared `BatchingOracle`);
               requests ride the batched labeling channel with this
               query's budget enforced by its own `BudgetLedger`.
    """
    scores = _scores_on(scores, resolve_device(device))
    key = random.PRNGKey(0) if key is None else np.asarray(key, np.uint32)
    client = as_oracle_client(oracle_fn)
    ledger = BudgetLedger(query.budget)

    def oracle(indices: torch.Tensor) -> np.ndarray:
        return client.submit(indices.cpu().numpy(), ledger=ledger).result()

    s = query.budget
    if query.target == "recall":
        tau, corrected = _run_rt(key, scores, oracle, s, query)
    else:
        tau, corrected = _run_pt(key, scores, oracle, s, query)

    r1 = ledger.labeled_positives()
    r2 = select_ops.select_at_least(scores, tau).cpu().numpy()
    selected = _union_into(r2, r1)
    return QueryResult(selected=selected, tau=tau,
                       oracle_calls=ledger.charged,
                       corrected_target=corrected,
                       n_sampled_positives=int(r1.shape[0]))


def _labeled(sample: sampling.WeightedSample, scores: torch.Tensor, oracle):
    """The sample's labels and scores, on the host."""
    return oracle(sample.indices), scores[sample.indices].cpu()


def _run_rt(key, scores, oracle, s, q):
    scheme = {"is": q.weight_scheme, "uniform": "uniform",
              "noci": "uniform"}[q.method]
    sample = sampling.draw_oracle_sample(key, scores, s, scheme=scheme,
                                         defensive=q.defensive)
    o_s, a_s = _labeled(sample, scores, oracle)
    if q.method == "noci":
        res = thresholds.tau_unoci_r(a_s, o_s, q.gamma)
    else:
        res = thresholds.tau_ci_r(a_s, o_s, sample.m.cpu(), q.gamma,
                                  q.delta)
    return float(res.tau), float(res.corrected_target)


def _run_pt(key, scores, oracle, s, q):
    k0, k1 = random.split(key)
    if q.method == "noci":
        sample = sampling.draw_oracle_sample(k0, scores, s, scheme="uniform")
        o_s, a_s = _labeled(sample, scores, oracle)
        res = thresholds.tau_unoci_p(a_s, o_s, q.gamma)
        return float(res.tau), q.gamma

    if q.method == "uniform" or not q.two_stage:
        scheme = "uniform" if q.method == "uniform" else q.weight_scheme
        sample = sampling.draw_oracle_sample(k0, scores, s, scheme=scheme)
        o_s, a_s = _labeled(sample, scores, oracle)
        m_s = None if scheme == "uniform" else sample.m.cpu()
        res = thresholds.tau_ci_p(a_s, o_s, q.gamma, q.delta, m_s=m_s,
                                  min_step=q.min_step)
        return float(res.tau), q.gamma

    # ---- Algorithm 5: two-stage importance sampling -----------------------
    # Stage 1 (budget s/2): UB the number of matches; restrict to D'.
    s0 = s // 2
    sample0 = sampling.draw_oracle_sample(k0, scores, s0,
                                          scheme=q.weight_scheme,
                                          defensive=q.defensive)
    o_s0 = oracle(sample0.indices)
    _, rank = thresholds.pt_stage1_nmatch(
        o_s0, sample0.m.cpu(), scores.numel(), q.gamma, q.delta)
    tau_dprime = float(thresholds.dprime_cutoff_score(scores, rank))

    # Stage 2 (budget s/2): sample *uniformly within D'*, whose size is
    # one threshold_count launch on the card.
    sample1 = sampling.sample_weighted_masked(
        k1, None, scores >= tau_dprime, s - s0,
        n_sub=int(select_ops.count_at_least(scores, tau_dprime)))
    o_s1, a_s1 = _labeled(sample1, scores, oracle)
    res = thresholds.tau_ci_p(a_s1, o_s1, q.gamma, q.delta / 2.0,
                              min_step=q.min_step)
    return float(res.tau), q.gamma


# ---------------------------------------------------------------------------
# Joint-target queries (Appendix A)
# ---------------------------------------------------------------------------

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


@dataclasses.dataclass
class JointResult:
    """What `run_joint_query` returns (host numpy and Python numbers)."""

    selected: np.ndarray
    oracle_calls: int
    stage2_tau: float


def run_joint_query(key, scores, oracle_fn, gamma_recall, gamma_precision,
                    delta=0.05, stage_budget=10_000, method="is", *,
                    device=None) -> JointResult:
    """JT query: RT subroutine + exhaustive false-positive filtering.

    1. optimistically allocate budget B for the RT stage;
    2. run IS-CI-R (or U-CI-R) at gamma_recall — with prob 1-delta the
       candidate set has sufficient recall;
    3. exhaustively oracle-label the candidate set on the host, through
       the same channel, and keep the true positives. Total oracle usage
       is unbounded by design (Appendix A semantics).
    """
    scores = _scores_on(scores, resolve_device(device))
    q = SUPGQuery(target="recall", gamma=gamma_recall, delta=delta,
                  budget=stage_budget, method=method)
    client = as_oracle_client(oracle_fn)
    rt_res = run_query(key, scores, client, q, device=scores.device)
    # Stage 3: no budget cap (the ledger is capped at n for attribution
    # only); candidates the RT stage labeled come from the channel's cache.
    ledger = BudgetLedger(scores.numel())
    labels = client.submit(rt_res.selected, ledger=ledger).result()
    keep = rt_res.selected[labels > 0.5]
    return JointResult(selected=keep,
                       oracle_calls=rt_res.oracle_calls + ledger.charged,
                       stage2_tau=rt_res.tau)


# ---------------------------------------------------------------------------
# Result metrics (Section 3.2)
# ---------------------------------------------------------------------------

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
