"""Proxy-threshold estimation — Algorithms 2-5 of the paper, float32 torch.

  U-NoCI-R / U-NoCI-P : empirical threshold, no CI (baseline, no guarantee).
  U-CI-R / IS-CI-R    : (importance-reweighted) CI-corrected recall target.
  U-CI-P              : per-candidate precision LBs with a delta/M union
                        bound over M = ceil(s/m) candidates.
  IS-CI-P stage 1     : `pt_stage1_nmatch` upper-bounds n_match;
                        `dprime_cutoff_score` turns its rank into D'.

Every estimator is a pure function of the labeled sample (a few thousand
records at most), so it runs wherever its inputs lie; the engine hands it
host tensors. Thresholds are inclusive: the query returns {A >= tau}.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import bounds

MIN_STEP = 100  # paper's minimum candidate step size m


class ThresholdResult(NamedTuple):
    """An estimator's output: tau and its diagnostics (0-d tensors)."""

    tau: torch.Tensor               # float32 inclusive score threshold
    corrected_target: torch.Tensor  # gamma' (RT) or gamma (PT)
    n_candidates: torch.Tensor      # M for PT scans, 1 for RT
    valid: torch.Tensor             # False if no candidate met the target


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def _sort_desc(a_s: torch.Tensor, *arrays: torch.Tensor):
    # Stable, like jnp.argsort: tied sample scores keep their draw order.
    order = torch.argsort(-a_s, stable=True)
    return (a_s[order],) + tuple(arr[order] for arr in arrays)


def _recall_prefix_curve(om_desc: torch.Tensor) -> torch.Tensor:
    csum = bounds.blocked_cumsum(om_desc)
    return csum / torch.clamp_min(csum[-1], 1e-30)


def _max_tau_for_recall(a_desc, recall_curve, gamma):
    """Score at the shortest prefix whose recall reaches gamma (-inf if
    none does)."""
    ok = recall_curve >= gamma
    any_ok = bool(ok.any())
    tau = a_desc[int(torch.argmax(ok.to(torch.uint8)))] if any_ok \
        else _f32(float("-inf"))
    return tau, any_ok


def tau_unoci_r(a_s, o_s, gamma) -> ThresholdResult:
    """U-NoCI-R: empirical threshold, no confidence correction (Eq. 6)."""
    a_desc, o_desc = _sort_desc(_f32(a_s), _f32(o_s))
    tau, _ = _max_tau_for_recall(a_desc, _recall_prefix_curve(o_desc),
                                 _f32(gamma))
    return ThresholdResult(tau, _f32(gamma), torch.tensor(1, dtype=torch.int32),
                           torch.tensor(True))


def tau_ci_r(a_s, o_s, m_s, gamma, delta) -> ThresholdResult:
    """Algorithms 2 & 4: CI-corrected recall-target threshold.

    m_s are the reweighting factors m(x) = u(x)/w(x) (1 for uniform):

        tau_o  <- max{tau : Recall_{S_w}(tau) >= gamma}
        gamma' <- UB(Z1)/(UB(Z1) + LB(Z2))        (each at delta/2)
        tau'   <- max{tau : Recall_{S_w}(tau) >= gamma'}
    """
    a_s = _f32(a_s)
    o_s = _f32(o_s)
    m_s = torch.broadcast_to(_f32(m_s), a_s.shape)
    gamma, delta = _f32(gamma), _f32(delta)
    s = a_s.shape[0]

    a_desc, om_desc = _sort_desc(a_s, o_s * m_s)
    curve = _recall_prefix_curve(om_desc)
    tau_o, _ = _max_tau_for_recall(a_desc, curve, gamma)

    above = (a_desc >= tau_o).to(torch.float32)
    z1 = om_desc * above
    z2 = om_desc * (1.0 - above)
    # mu = sum · (1/s) is contracted into each bound, as under jit
    sum1, inv_s, sg1 = bounds.sample_sum_std(z1)
    sum2, _, sg2 = bounds.sample_sum_std(z2)
    ub1 = bounds.ub_of_sum(sum1, inv_s, sg1, s, delta / 2.0)
    lb2 = torch.clamp_min(bounds.lb_of_sum(sum2, inv_s, sg2, s, delta / 2.0),
                          0.0)
    gamma_p = torch.clamp(ub1 / torch.clamp_min(ub1 + lb2, 1e-30),
                          min=gamma, max=_f32(1.0))

    tau_p, ok = _max_tau_for_recall(a_desc, curve, gamma_p)
    if not ok:      # gamma' beyond the sample's recall: take its whole range
        tau_p = a_desc[-1]
    return ThresholdResult(tau_p, gamma_p, torch.tensor(1, dtype=torch.int32),
                           torch.tensor(True))


def _last_true(mask: torch.Tensor) -> int:
    return mask.shape[0] - 1 - int(torch.argmax(
        torch.flip(mask, (0,)).to(torch.uint8)))


def _precision_candidate_scan(a_desc, o_desc, w_desc, gamma, delta,
                              min_step=MIN_STEP):
    """Algorithm-3 scan: per-candidate precision LBs at delta/M; returns
    the smallest passing threshold (largest passing prefix)."""
    s = a_desc.shape[0]
    m_step = min(min_step, s)
    num_cand = max(s // m_step, 1)

    mu, sg, n = bounds.weighted_prefix_mean_std(o_desc, w_desc)
    p_l = bounds.lb(mu, sg, n, delta * bounds.reciprocal32(num_cand, delta))

    idx = torch.arange(1, s + 1)
    is_cand = (idx % m_step == 0) & (idx <= num_cand * m_step)
    passing = is_cand & (p_l > gamma)
    any_pass = bool(passing.any())
    tau = a_desc[_last_true(passing)] if any_pass else _f32(float("inf"))
    return tau, torch.tensor(num_cand, dtype=torch.int32), any_pass


def tau_unoci_p(a_s, o_s, gamma) -> ThresholdResult:
    """U-NoCI-P: min{tau : empirical Precision_S(tau) >= gamma} (Eq. 5)."""
    a_desc, o_desc = _sort_desc(_f32(a_s), _f32(o_s))
    n = torch.arange(1, a_desc.shape[0] + 1, dtype=torch.float32)
    prec = bounds.blocked_cumsum(o_desc) / n
    passing = prec >= _f32(gamma)
    any_pass = bool(passing.any())
    tau = a_desc[_last_true(passing)] if any_pass else _f32(float("inf"))
    return ThresholdResult(tau, _f32(gamma),
                           torch.tensor(a_desc.shape[0], dtype=torch.int32),
                           torch.tensor(any_pass))


def tau_ci_p(a_s, o_s, gamma, delta, m_s=None,
             min_step=MIN_STEP) -> ThresholdResult:
    """Algorithm 3 (and stage 2 of Algorithm 5): CI precision threshold.

    With m_s=None the sample is uniform over its population (plain
    O-values); with m_s the scan uses the importance-weighted estimator
    (Eq. 12)."""
    a_s = _f32(a_s)
    o_s = _f32(o_s)
    if m_s is None:
        a_desc, o_desc = _sort_desc(a_s, o_s)
        w_desc = torch.ones_like(a_desc)
    else:
        a_desc, o_desc, w_desc = _sort_desc(a_s, o_s, _f32(m_s))
    tau, num_cand, ok = _precision_candidate_scan(
        a_desc, o_desc, w_desc, _f32(gamma), _f32(delta), min_step)
    return ThresholdResult(tau, _f32(gamma), num_cand, torch.tensor(ok))


def pt_stage1_nmatch(o_s0, m_s0, n_total, gamma, delta):
    """Stage 1 of Algorithm 5: UB on n_match and the D' cutoff rank
    ceil(n_match / gamma), both clipped to [1, n_total]."""
    z = _f32(o_s0) * _f32(m_s0)
    total, inv_s, sg = bounds.sample_sum_std(z)
    n = _f32(n_total)
    n_match = n * bounds.ub_of_sum(total, inv_s, sg, z.shape[0],
                                   _f32(delta) / 2.0)
    n_match = torch.clamp(n_match, min=_f32(1.0), max=n)
    rank = torch.clamp(torch.ceil(n_match / _f32(gamma)),
                       min=_f32(1.0), max=n).to(torch.int32)
    return n_match, rank


def dprime_cutoff_score(scores: torch.Tensor, rank) -> torch.Tensor:
    """tau with |{A >= tau}| ~= rank: the rank-th largest score (ranks
    clipped to [1, n]), a 0-d float32 tensor on the scores' device. The
    reference sorts the whole array; `torch.topk` picks the same element,
    and on the card it is far faster than `torch.kthvalue`."""
    scores = torch.as_tensor(scores, dtype=torch.float32).reshape(-1)
    idx = min(max(int(rank) - 1, 0), scores.numel() - 1)
    return torch.topk(scores, idx + 1).values[-1]
