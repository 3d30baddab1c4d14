"""Deterministic fault injection for oracle channels (NumPy only, the
JAX package's harness with its imports pointed at the port).

`FaultInjector` wraps any ``indices -> labels`` callable and misbehaves
on a *schedule*: a plain mapping from underlying-call index to fault
kind. No wall clock, no global randomness — the schedule is data, so a
faulty run replays bit-for-bit and a test can assert exactly which
calls failed. `fault_schedule` builds one from a seed (its own
`numpy` Generator, never the global RNG).

Fault kinds (the failure shapes a real remote oracle exhibits):

``transient``  raise `OracleTransientError` (a 5xx / dropped connection)
``fatal``      raise `OracleFatalError` (a permanent rejection)
``latency``    answer correctly, but only after ``spike_s`` on the
               injectable sleep — trips a channel's per-call watchdog
``torn``       return one label too few (a truncated response body)
``dup``        return one label too many (a duplicated tail record)
``nan``        right length, but leading labels are NaN (corrupt data)

Every kind is either raised or *detectably* malformed: the channel's
validation (length + finiteness) must reject ``torn``/``dup``/``nan``
before caching, so no fault can silently corrupt a label. Faults spend
a schedule slot even when they raise — the retry is the *next* call
index, which the schedule may fault again.

>>> import numpy as np
>>> from repro_torch.core.oracle import array_oracle
>>> inj = FaultInjector(array_oracle(np.arange(8.0)),
...                     {0: "transient", 2: "torn"})
>>> try:
...     inj([1, 2])
... except Exception as e:
...     print(type(e).__name__)
OracleTransientError
>>> [float(v) for v in inj([1, 2])]     # call 1: clean
[1.0, 2.0]
>>> len(inj([1, 2, 3]))                 # call 2: torn — one label short
2
>>> inj.calls, dict(inj.injected)
(3, {'transient': 1, 'torn': 1})
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, Mapping, Sequence

import numpy as np

from repro_torch.core.resilience import OracleFatalError, OracleTransientError

KINDS = ("transient", "fatal", "latency", "torn", "dup", "nan")


def fault_schedule(seed: int, n_calls: int, rate: float,
                   kinds: Sequence[str] = ("transient",)) -> Dict[int, str]:
    """Seeded Bernoulli schedule: each of the first `n_calls` underlying
    calls faults with probability `rate`, drawing its kind uniformly
    from `kinds`. Pure function of the arguments (own Generator, no
    global RNG), so tests and benches share reproducible chaos."""
    for k in kinds:
        if k not in KINDS:
            raise ValueError(f"unknown fault kind {k!r} (choose from {KINDS})")
    rng = np.random.default_rng(seed)
    out: Dict[int, str] = {}
    for i in range(int(n_calls)):
        if rng.random() < rate:
            out[i] = kinds[int(rng.integers(len(kinds)))]
    return out


class FaultInjector:
    """Schedule-driven unreliable wrapper around an ``indices -> labels``
    callable (see the module docstring for the fault kinds).

    Thread-safe: the call counter and injection log update under a lock,
    so a channel's drain thread and a watchdog's sacrificial threads
    observe a consistent schedule. `calls` counts every invocation
    (faulted or not); `injected` tallies faults by kind.
    """

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray],
                 schedule: Mapping[int, str], *,
                 spike_s: float = 0.0,
                 sleep: Callable[[float], None] = time.sleep):
        for i, k in dict(schedule).items():
            if k not in KINDS:
                raise ValueError(
                    f"unknown fault kind {k!r} at call {i} "
                    f"(choose from {KINDS})")
        self._fn = fn
        self.schedule = dict(schedule)
        self.spike_s = float(spike_s)
        self._sleep = sleep
        self._lock = threading.Lock()
        self.calls = 0
        self.injected: collections.Counter = collections.Counter()

    def __call__(self, indices) -> np.ndarray:
        """Label `indices` — or misbehave, if this call is scheduled to."""
        with self._lock:
            i = self.calls
            self.calls += 1
            kind = self.schedule.get(i)
            if kind is not None:
                self.injected[kind] += 1
        if kind is None:
            return self._fn(indices)
        if kind == "transient":
            raise OracleTransientError(
                f"injected transient fault (call {i})")
        if kind == "fatal":
            raise OracleFatalError(f"injected fatal fault (call {i})")
        if kind == "latency":
            self._sleep(self.spike_s)
            return self._fn(indices)
        labels = np.asarray(self._fn(indices), np.float32).reshape(-1)
        if kind == "torn":
            return labels[:-1]
        if kind == "dup":
            return np.concatenate([labels, labels[-1:]])
        # kind == "nan": right length, corrupt leading values
        out = labels.copy()
        out[:max(1, out.size // 8)] = np.nan
        return out
