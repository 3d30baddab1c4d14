"""Live corpus plane, ported: incremental ingestion, standing queries and
the drift watch.

The paper's guarantees (§5) are certified against a frozen, fully scored
corpus. This package keeps them meaningful when the corpus grows:

  IngestPlane       append score shards and delta-update engine state
                    (only the appended chunks are sketched, one
                    `score_hist` launch each on the card) under a
                    versioned epoch; never a cold rebuild
  StandingQuery /   registered queries whose sinks re-emit over newly
  StandingRegistry  appended shards each epoch (`threshold_select` on
                    the appended chunks only), scheduled through the same
                    `QuerySession` as ordinary queries
  DriftSentinel /   §6.2 calibration-drift monitor: importance-weighted
  DriftWatch /      match-rate probes against a certified reference, and
  DriftReport       re-validation through the shared oracle channel
"""
from repro_torch.live.ingest import IngestPlane
from repro_torch.live.sentinel import DriftReport, DriftSentinel, DriftWatch
from repro_torch.live.standing import StandingQuery, StandingRegistry

__all__ = [
    "IngestPlane",
    "StandingQuery", "StandingRegistry",
    "DriftSentinel", "DriftWatch", "DriftReport",
]
