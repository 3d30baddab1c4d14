"""Drift sentinel, ported: §6.2 calibration-drift detection with
re-validation.

The paper's guarantees hold for the score/label joint distribution the
certifying sample was drawn from; §6.2 shows that proxy calibration drift
silently voids them. The sentinel makes that failure loud and recoverable:

**The statistic.** For a sample drawn from the defensive importance
distribution p(x) with reweighting factors m(x) = u(x)/p(x), the
importance-weighted match estimate

    mu_hat = mean(m_i * o_i)   with   E_p[m * o] = (1/n) * sum_x o(x)

is an unbiased estimate of the corpus *match fraction* under any sampling
scheme the engine uses (for uniform draws m = 1 and it degenerates to the
plain mean). `watch()` records a certified reference probe (mu_ref,
var_ref); `check()` draws a fresh probe over the *current* epoch and
computes the two-sample z statistic

    z = |mu_hat - mu_ref| / sqrt(var_ref + var_cur)

(variances are of-the-mean, ddof=1). `z > sigma` flags drift: the match
mass has moved relative to what tau was certified against.

**The response.** `audit()` = check, and on trigger `revalidate()`:
re-run the watched query with a fresh budget through the shared oracle
channel, install the new tau on the watch (and, by the caller, on
the standing query), and re-baseline the reference probe. The re-validated
tau carries a fresh 1-delta guarantee over the corpus as of that epoch —
see "What re-validation re-guarantees" in the JAX package's
`docs/guarantees.md`, which holds for the port unchanged.

Keys are jax-format ``uint32[2]`` (`repro_torch.random`), split as the
JAX package splits them, so one key drives both packages' sentinels.
Probes draw through `SelectionEngine.draw_sample` (on the card its
within-chunk p(x) is computed on the device); the statistic itself is
host float64 over at most `probe_budget` records.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch import random
from repro_torch.core.engine import (CorpusState, SelectionEngine,
                                     ShardedSelection)
from repro_torch.core.oracle import BudgetLedger, as_oracle_client
from repro_torch.core.queries import SUPGQuery


@dataclasses.dataclass
class DriftReport:
    """Outcome of one sentinel audit (`DriftSentinel.audit`)."""

    epoch: int                    # corpus epoch the fresh probe covered
    ref_rate: float               # certified reference match-rate estimate
    rate: float                   # fresh probe match-rate estimate
    z: float                      # two-sample drift statistic
    sigma: float                  # trigger threshold the check used
    drifted: bool                 # z > sigma
    revalidated: bool = False     # a re-validation query ran
    tau_before: float = math.nan
    tau_after: float = math.nan
    probe_spent: int = 0          # oracle labels the fresh probe charged
    revalidation_spent: int = 0   # oracle labels re-validation charged

    def format(self) -> str:
        """Human-readable multi-line report."""
        lines = [
            f"drift audit @ epoch {self.epoch}:",
            f"  match rate: ref {self.ref_rate:.6f} -> cur "
            f"{self.rate:.6f}  (z = {self.z:.2f}, sigma = "
            f"{self.sigma:.1f})",
            f"  verdict:    "
            f"{'DRIFTED' if self.drifted else 'calibrated'}",
        ]
        if self.revalidated:
            lines.append(
                f"  re-validated: tau {self.tau_before:.6f} -> "
                f"{self.tau_after:.6f}  ({self.revalidation_spent} "
                f"oracle labels)")
        elif self.drifted:
            lines.append(f"  tau unchanged at {self.tau_before:.6f} "
                         f"(re-validation not requested)")
        lines.append(f"  probe cost: {self.probe_spent} oracle labels")
        return "\n".join(lines)


@dataclasses.dataclass
class DriftWatch:
    """Per-query sentinel state: the certified reference the drift
    statistic compares against, updated in place by re-validation."""

    query: SUPGQuery
    scheme: str                   # probe sampling scheme ('uniform' ok)
    kappa: float
    tau: float                    # currently-installed threshold
    epoch: int                    # epoch tau was last (re-)certified at
    ref_rate: float               # reference probe mean(m * o)
    ref_var: float                # reference probe var-of-the-mean
    probe_s: int                  # probe budget both probes used


class DriftSentinel:
    """Watches certified queries for calibration drift; re-validates on
    trigger. All oracle traffic (probes and re-validation queries) rides
    the one shared channel passed at construction, so probe labels join
    the common cache and are metered like any other labels.

    >>> import numpy as np
    >>> from repro_torch import random
    >>> from repro_torch.core.engine import SelectionEngine
    >>> from repro_torch.core.queries import SUPGQuery
    >>> from repro_torch.live.ingest import IngestPlane
    >>> scores = np.linspace(0.0, 1.0, 2048, dtype=np.float32)
    >>> labels = {}      # grown alongside the corpus
    >>> oracle = lambda idx: np.asarray(
    ...     [labels.get(int(i), 0.0) for i in np.asarray(idx)], np.float32)
    >>> labels.update({i: float(s > 0.7) for i, s in enumerate(scores)})
    >>> eng = SelectionEngine([scores], num_bins=64, device="cpu")
    >>> sent = DriftSentinel(eng, oracle, probe_budget=256, sigma=3.0)
    >>> q = SUPGQuery(target="recall", gamma=0.9, budget=256, method="is")
    >>> w = sent.watch(q, key=random.PRNGKey(1))
    >>> # Drift: append high-score records that are all oracle-negative.
    >>> labels.update({i + 2048: 0.0 for i in range(2048)})
    >>> _ = IngestPlane(eng).append(np.full(2048, 0.9, np.float32))
    >>> rep = sent.audit(w, key=random.PRNGKey(2))
    >>> (rep.drifted, rep.revalidated, rep.epoch)
    (True, True, 1)
    >>> eng.close()
    """

    def __init__(self, engine: SelectionEngine, oracle, *,
                 probe_budget: int = 2048, sigma: float = 4.0):
        self.engine = engine
        self.client = as_oracle_client(oracle)
        self.probe_budget = int(probe_budget)
        self.sigma = float(sigma)
        self.checks = 0
        self.triggers = 0
        self.revalidations = 0

    # -- probes ---------------------------------------------------------

    def _probe(self, key, scheme: str, kappa: float,
               state: CorpusState) -> Tuple[float, float, int]:
        """One importance-weighted match-rate probe over `state`.

        Returns (mean(m*o), var-of-the-mean, labels charged). Synchronous
        on the calling thread: safe between session rounds, when the
        channel holds no pending tickets.
        """
        s = self.probe_budget
        idx, m = self.engine.draw_sample(key, s, self.scheme_of(scheme),
                                         kappa=kappa, state=state)
        ledger = BudgetLedger(s)
        o = np.asarray(self.client.submit(idx, ledger=ledger).result(),
                       np.float64)
        x = np.asarray(m, np.float64) * o
        var = float(x.var(ddof=1)) / x.size if x.size > 1 else 0.0
        return float(x.mean()), var, int(ledger.charged)

    @staticmethod
    def scheme_of(scheme_or_query) -> str:
        """Probe sampling scheme for a query (or pass a scheme through)."""
        if isinstance(scheme_or_query, SUPGQuery):
            q = scheme_or_query
            return ("uniform" if q.method in ("uniform", "noci")
                    else q.weight_scheme)
        return str(scheme_or_query)

    # -- lifecycle ------------------------------------------------------

    def watch(self, query: SUPGQuery, *, key,
              tau: Optional[float] = None) -> DriftWatch:
        """Certify (or adopt) a query and baseline its reference probe.

        With `tau=None` the query is run through the shared channel to
        certify a threshold; pass an already-certified tau (e.g. a
        `StandingQuery`'s) to adopt it without spending query budget.
        Either way a reference probe of `probe_budget` labels is drawn
        over the current epoch.
        """
        state = self.engine.pin()
        try:
            scheme = self.scheme_of(query)
            k_cert, k_probe = random.split(key)
            if tau is None:
                sel = self.engine.run(k_cert, self.client, query)
                tau = float(sel.tau)
            ref_rate, ref_var, _ = self._probe(k_probe, scheme,
                                               self.engine.kappa, state)
            return DriftWatch(query=query, scheme=scheme,
                              kappa=self.engine.kappa, tau=float(tau),
                              epoch=state.epoch, ref_rate=ref_rate,
                              ref_var=ref_var, probe_s=self.probe_budget)
        finally:
            self.engine.unpin(state)

    def check(self, watch: DriftWatch, *, key) -> DriftReport:
        """Fresh probe over the current epoch; flags drift, changes
        nothing."""
        state = self.engine.pin()
        try:
            rate, var, spent = self._probe(key, watch.scheme, watch.kappa,
                                           state)
        finally:
            self.engine.unpin(state)
        z = (abs(rate - watch.ref_rate)
             / math.sqrt(max(watch.ref_var + var, 1e-300)))
        self.checks += 1
        drifted = z > self.sigma
        if drifted:
            self.triggers += 1
        return DriftReport(epoch=state.epoch, ref_rate=watch.ref_rate,
                           rate=rate, z=z, sigma=self.sigma,
                           drifted=drifted, tau_before=watch.tau,
                           tau_after=watch.tau, probe_spent=spent)

    def revalidate(self, watch: DriftWatch, *, key,
                   budget: Optional[int] = None) -> ShardedSelection:
        """Re-run the watched query with a fresh budget over the current
        epoch; installs the new tau and re-baselines the reference probe.
        """
        q = (watch.query if budget is None
             else dataclasses.replace(watch.query, budget=int(budget)))
        state = self.engine.pin()
        try:
            k_run, k_probe = random.split(key)
            sel = self.engine.run(k_run, self.client, q)
            watch.tau = float(sel.tau)
            watch.epoch = state.epoch
            watch.ref_rate, watch.ref_var, _ = self._probe(
                k_probe, watch.scheme, watch.kappa, state)
        finally:
            self.engine.unpin(state)
        self.revalidations += 1
        return sel

    def audit(self, watch: DriftWatch, *, key,
              budget: Optional[int] = None) -> DriftReport:
        """`check`, and on trigger `revalidate` — the serving host's
        per-epoch sentinel pass. Returns the full report."""
        k_check, k_reval = random.split(key)
        report = self.check(watch, key=k_check)
        if report.drifted:
            sel = self.revalidate(watch, key=k_reval, budget=budget)
            report.revalidated = True
            report.tau_after = watch.tau
            report.revalidation_spent = int(sel.oracle_calls)
        return report
