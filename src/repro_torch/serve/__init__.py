"""Serving plane, ported: a rate-limited, quota-metered daemon around the
engine.

`SelectionServer` hosts one long-lived `SelectionEngine` plus a
`QuerySession` pool behind a thread-safe `submit(query, tenant=...)`
API with admission control, per-tenant quotas (`BudgetLedger` chains),
and `TokenBucket` pacing of the shared oracle channel; with
``durable=<path>`` it journals every append and `SelectionServer.restore`
brings a crashed server back (`repro_torch.durable`).
"""
from repro_torch.core.oracle import BudgetExceededError
from repro_torch.core.resilience import (CircuitBreaker, CircuitOpenError,
                                         RetryPolicy)
from repro_torch.serve.limiter import RateLimitError, TokenBucket
from repro_torch.serve.server import (AdmissionError, QueueTimeoutError,
                                      SelectionServer, ServerClosedError,
                                      ServerHandle)
from repro_torch.serve.stats import (LatencyHistogram, ServerStats,
                                     TenantStats)

__all__ = [
    "SelectionServer",
    "ServerHandle",
    "ServerStats",
    "TenantStats",
    "LatencyHistogram",
    "TokenBucket",
    "RateLimitError",
    "AdmissionError",
    "QueueTimeoutError",
    "ServerClosedError",
    "BudgetExceededError",
    "CircuitBreaker",
    "CircuitOpenError",
    "RetryPolicy",
]
