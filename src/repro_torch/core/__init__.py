"""SUPG core, ported: query specs, the batched oracle channel, the
statistical plane and (in `repro_torch.core.engine`, imported explicitly)
the selection engine.

Public API:
  SUPGQuery / JointSUPGQuery                 query specs (Section 3, App. A)
  precision_of / recall_of                   result metrics
  OracleClient / BatchingOracle              batched labeling channel +
  BudgetLedger / as_oracle_client            per-query budget views
  resilience.*                               retry / timeout / breaker layer
  sampling.* / thresholds.* / bounds.*       §5 estimators and samplers
  binned.*                                   sketch-based dataset statistics
"""
from repro_torch.core import bounds, sampling, thresholds
from repro_torch.core.oracle import (BatchingOracle, BudgetedOracle,
                                     BudgetExceededError, BudgetLedger,
                                     DrainHandle, OracleClient,
                                     OracleRequest, Ticket, array_oracle,
                                     as_oracle_client)
from repro_torch.core.queries import (JointSUPGQuery, SUPGQuery,
                                      precision_of, recall_of)
from repro_torch.core.resilience import (CircuitBreaker, CircuitOpenError,
                                         OracleError, OracleFatalError,
                                         OracleMalformedError,
                                         OracleTimeoutError,
                                         OracleTransientError, RetryPolicy,
                                         is_retryable)

__all__ = [
    "bounds", "sampling", "thresholds",
    "BudgetedOracle", "BudgetExceededError", "array_oracle",
    "BatchingOracle", "BudgetLedger", "DrainHandle", "OracleClient",
    "OracleRequest", "Ticket", "as_oracle_client",
    "CircuitBreaker", "CircuitOpenError", "OracleError", "OracleFatalError",
    "OracleMalformedError", "OracleTimeoutError", "OracleTransientError",
    "RetryPolicy", "is_retryable",
    "SUPGQuery", "JointSUPGQuery", "precision_of", "recall_of",
]
