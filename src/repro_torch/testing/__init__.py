"""Test and benchmark harnesses that are product surface, not test code.

`repro_torch.testing.faults` carries the deterministic `FaultInjector`
(and `fault_schedule`, its seeded schedule) for anything that needs a
reproducibly unreliable oracle: the session's fault-isolation tests and
faulty-load runs.

`repro_torch.testing.crash` carries `CrashInjector` (and
`crash_schedule`), its sibling for the durability plane: deterministic
process death at named crashpoints.
"""
from repro_torch.testing.crash import (CrashInjector, SimulatedCrash,
                                       crash_schedule)
from repro_torch.testing.faults import FaultInjector, fault_schedule

__all__ = [
    "CrashInjector",
    "FaultInjector",
    "SimulatedCrash",
    "crash_schedule",
    "fault_schedule",
]
