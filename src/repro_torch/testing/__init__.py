"""Test and benchmark harnesses that are product surface, not test code.

`repro_torch.testing.faults` carries the deterministic `FaultInjector`
(and `fault_schedule`, its seeded schedule) for anything that needs a
reproducibly unreliable oracle: the session's fault-isolation tests and
faulty-load runs.
"""
from repro_torch.testing.faults import FaultInjector, fault_schedule

__all__ = [
    "FaultInjector",
    "fault_schedule",
]
