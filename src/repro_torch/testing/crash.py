"""`CrashInjector` — deterministically kill the process at a named instant.

Sibling of `repro_torch.testing.faults.FaultInjector` (which makes the
oracle *channel* unreliable): this harness makes the *process*
unreliable. The durable layer announces crash-interesting instants by
calling ``repro_torch.durable.atomic.crashpoint("name")`` between a write
and its commit; a `CrashInjector` installs a process-global hook that
raises `SimulatedCrash` at a scheduled hit of a scheduled point.

Two properties make the simulation honest:

  * `SimulatedCrash` subclasses `BaseException`, so routine
    ``except Exception`` blocks cannot absorb it — it unwinds like a
    kill signal, not like an error.
  * The injector **latches**: once it has fired, *every* subsequent
    crashpoint also raises. A dead process does not keep committing;
    without the latch, a caller that caught the first crash could run
    the rest of its commit protocol and the test would prove nothing.

What a simulated crash models: all fsync'd bytes survive (they were
acknowledged to stable storage), and bytes merely written survive too —
the page cache outlives a process kill, matching a real `SIGKILL`
(only power failure loses un-fsync'd pages; that stricter model is out
of scope here). What it loses is everything in process memory.

>>> import os, tempfile
>>> from repro_torch.durable import atomic
>>> path = os.path.join(tempfile.mkdtemp(), "state.json")
>>> atomic.atomic_write_json(path, {"epoch": 1})
>>> inj = CrashInjector({"pre_rename": 0})
>>> with inj:
...     try:
...         atomic.atomic_write_json(path, {"epoch": 2})
...     except SimulatedCrash:
...         pass
>>> (inj.fired, inj.fired_at)
(True, 'pre_rename')
>>> atomic.read_json(path)["epoch"]   # old file intact, no torn mix
1
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.durable import atomic


class SimulatedCrash(BaseException):
    """The process died here. `BaseException` so ``except Exception``
    recovery paths cannot accidentally survive their own death."""


def crash_schedule(seed: int,
                   points: Optional[Sequence[str]] = None,
                   max_hit: int = 3) -> Dict[str, int]:
    """Seeded schedule: pick one crashpoint and the hit index to kill at.

    Returns ``{point: hit_index}`` with a single entry — one process,
    one death. `points` defaults to every registered crashpoint;
    `hit_index` is uniform in ``[0, max_hit)`` so sweeps over seeds also
    cover "the Nth append dies", not just the first.

    >>> crash_schedule(0) == crash_schedule(0)
    True
    >>> (point, hit), = crash_schedule(7).items()
    >>> point in atomic.CRASHPOINTS and 0 <= hit < 3
    True
    """
    pool = tuple(points) if points is not None else atomic.CRASHPOINTS
    rng = np.random.default_rng(seed)
    point = pool[int(rng.integers(len(pool)))]
    return {point: int(rng.integers(max_hit))}


class CrashInjector:
    """Raise `SimulatedCrash` at scheduled hits of named crashpoints.

    `schedule` maps crashpoint name -> 0-based hit index at which to
    die; names are validated against
    `repro_torch.durable.atomic.CRASHPOINTS` so a renamed point cannot
    silently turn a crash test into a no-op. Use as a context manager —
    it installs itself as the process-global crash hook on enter and
    restores the previous hook on exit.
    """

    def __init__(self, schedule: Dict[str, int]):
        unknown = sorted(set(schedule) - set(atomic.CRASHPOINTS))
        if unknown:
            raise ValueError(
                f"unknown crashpoint(s) {unknown}; registered: "
                f"{list(atomic.CRASHPOINTS)}")
        self.schedule = {k: int(v) for k, v in schedule.items()}
        self.hits: Dict[str, int] = {}   # point -> times reached
        self.fired = False
        self.fired_at: Optional[str] = None
        self.fired_event = threading.Event()
        self._lock = threading.Lock()
        self._prev_hook = None

    def __enter__(self) -> "CrashInjector":
        self._prev_hook = atomic._hook
        atomic.set_crash_hook(self._observe)
        return self

    def __exit__(self, *exc) -> bool:
        atomic.set_crash_hook(self._prev_hook)
        return False

    def _observe(self, point: str) -> None:
        with self._lock:
            if self.fired:
                # Latch: the process is dead; nothing commits after.
                raise SimulatedCrash(
                    f"crashpoint {point!r} reached after death at "
                    f"{self.fired_at!r}")
            i = self.hits.get(point, 0)
            self.hits[point] = i + 1
            if self.schedule.get(point) == i:
                self.fired = True
                self.fired_at = point
                self.fired_event.set()
                raise SimulatedCrash(f"crash at {point}[{i}]")
