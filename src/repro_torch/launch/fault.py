"""Fault-tolerant training loop: checkpoint/restart, heartbeats, straggler
detection (the JAX package's ``launch/fault.py``).

* `HeartbeatMonitor`: workers report per-step latencies; the monitor
  flags stragglers by a robust z-score (median + k·MAD) and missing
  heartbeats by deadline.
* `TrainLoop`: drives step -> heartbeat -> periodic asynchronous
  checkpoint; on `RestartRequired` (a preemption, a flagged worker) it
  restores the last durable checkpoint and replays the deterministic data
  stream (`data.pipeline.DeterministicSource`) from the restored step.

Restoring onto another mesh waits for the mesh slice (ROADMAP §1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager


class RestartRequired(RuntimeError):
    """Raised when the fleet must roll back to the last checkpoint."""


@dataclasses.dataclass
class HeartbeatConfig:
    """Deadline of a heartbeat and the straggler rule."""

    deadline_s: float = 300.0      # missing heartbeat => dead worker
    straggler_mad_k: float = 5.0   # flag if latency > median + k * MAD
    min_history: int = 8


class HeartbeatMonitor:
    """Per-worker last heartbeat and recent step latencies."""

    def __init__(self, num_workers: int,
                 cfg: HeartbeatConfig = HeartbeatConfig()):
        self.cfg = cfg
        self.last_seen = {w: time.monotonic() for w in range(num_workers)}
        self.latency_hist: dict[int, list] = {w: [] for w in
                                              range(num_workers)}

    def report(self, worker: int, step_latency_s: float,
               now: Optional[float] = None):
        """Record a heartbeat of `worker` with its last step's latency."""
        self.last_seen[worker] = time.monotonic() if now is None else now
        h = self.latency_hist[worker]
        h.append(step_latency_s)
        if len(h) > 64:
            del h[:-64]

    def dead_workers(self, now: Optional[float] = None):
        """Workers whose last heartbeat is older than the deadline."""
        now = time.monotonic() if now is None else now
        return [w for w, t in self.last_seen.items()
                if now - t > self.cfg.deadline_s]

    def stragglers(self):
        """Robust z-score across workers on their median recent latency."""
        meds = {w: float(np.median(h)) for w, h in self.latency_hist.items()
                if len(h) >= self.cfg.min_history}
        if len(meds) < 2:
            return []
        vals = np.asarray(list(meds.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        return [w for w, v in meds.items()
                if v > med + self.cfg.straggler_mad_k * mad]


@dataclasses.dataclass
class LoopConfig:
    """Steps to run, the checkpoint period and the restart budget."""

    total_steps: int
    ckpt_every: int = 50
    max_restarts: int = 10


class TrainLoop:
    """Restartable training driver over `step_fn(params, opt_state, batch)
    -> (params, opt_state, metrics)` (the port's model as params, with
    `launch.train.make_train_step`)."""

    def __init__(self, step_fn: Callable, source, ckpt: CheckpointManager,
                 cfg: LoopConfig, monitor: Optional[HeartbeatMonitor] = None,
                 on_step: Optional[Callable] = None):
        self.step_fn = step_fn
        self.source = source
        self.ckpt = ckpt
        self.cfg = cfg
        self.monitor = monitor or HeartbeatMonitor(1)
        self.on_step = on_step
        self.restarts = 0

    def run(self, params, opt_state, start_step: int = 0):
        """Run to ``total_steps``, restoring the last checkpoint on each
        `RestartRequired` up to ``max_restarts`` times; returns (params,
        opt_state, step)."""
        step = start_step
        while step < self.cfg.total_steps:
            try:
                params, opt_state, step = self._run_span(params, opt_state,
                                                         step)
            except RestartRequired:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                params, opt_state, step, _ = self.ckpt.restore()
                # deterministic source: no iterator state to rebuild
        return params, opt_state, step

    def _run_span(self, params, opt_state, step):
        for batch in self.source.iter_from(step):
            t0 = time.monotonic()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            self.monitor.report(0, time.monotonic() - t0)
            step += 1
            if self.on_step:
                self.on_step(step, metrics)
            if step % self.cfg.ckpt_every == 0 or \
                    step >= self.cfg.total_steps:
                self.ckpt.save_async(step, params, opt_state)
            if self.monitor.dead_workers():
                raise RestartRequired("heartbeat deadline missed")
            if step >= self.cfg.total_steps:
                break
        return params, opt_state, step
