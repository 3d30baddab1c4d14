"""Token-bucket rate limiting for the oracle channel.

The paper's Section 4.1 operational model treats the oracle as a
*rate-limited, budgeted* external resource — a human labeling queue or an
expensive model endpoint that tolerates at most R records/second with
short bursts. `TokenBucket` makes that limit literal: the serving plane
hands one to `core.oracle.BatchingOracle` as its ``pacer`` hook, so every
underlying ``fn`` micro-batch first acquires as many tokens as it has
records. Because the hook runs on the channel's drain thread (under
`drain_async`), pacing throttles oracle I/O while query-plan compute
keeps overlapping it — the double-buffered scheduler never blocks on the
bucket directly.

Semantics are deterministic and test-friendly:

  * capacity (`burst`) bounds a single acquire — a request larger than
    the bucket can ever hold fails immediately with `RateLimitError`
    instead of deadlocking (the zero-capacity bucket is the degenerate
    case: every nonzero acquire is rejected);
  * the clock and sleep functions are injectable, so tests drive time
    by hand;
  * `wait_s` / `acquired` account total throttle wait and tokens
    granted — the serving plane's `ServerStats` reads them.

>>> t = [0.0]
>>> bucket = TokenBucket(rate=10.0, burst=5,
...                      clock=lambda: t[0],
...                      sleep=lambda s: t.__setitem__(0, t[0] + s))
>>> bucket.acquire(5)            # burst capacity: no wait
0.0
>>> round(bucket.acquire(3), 3)  # empty: 3 tokens at 10/s = 0.3 s
0.3
>>> bucket.acquired
8
"""
from __future__ import annotations

import threading
import time
from typing import Callable


class RateLimitError(RuntimeError):
    """A single acquire exceeds the bucket's capacity (can never succeed).

    `retryable` is False: `core.resilience.is_retryable` duck-types this
    attribute, so a channel's retry loop fails the micro-batch alone
    (poisoning only its owners) instead of re-running an acquire that
    can never be granted.
    """

    retryable = False


# Grant tolerance: refill arithmetic (`(now - last) * rate`) leaves float
# residue, and a deficit below the clock's ulp would otherwise spin the
# acquire loop forever (sleep too small to advance the clock).
_EPS = 1e-9


class TokenBucket:
    """Classic token bucket: `rate` tokens/second, capacity `burst`.

    `acquire(n)` blocks until `n` tokens are available, removes them, and
    returns the seconds it waited. Thread-safe — concurrent acquirers
    serialize on one lock and sleep outside their turn's refill math, so
    a stalled oracle drain never wedges other channel users.
    """

    def __init__(self, rate: float, burst: float, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if not rate > 0:
            raise ValueError("rate must be positive (tokens per second)")
        if burst < 0:
            raise ValueError("burst (capacity) must be >= 0")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._sleep = sleep
        self._tokens = float(burst)       # start full: allow initial burst
        self._last = clock()
        self._lock = threading.Lock()
        self.wait_s = 0.0                 # total time spent throttled
        self.acquired = 0                 # tokens granted so far

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: int = 1) -> bool:
        """Take `n` tokens if immediately available; never blocks."""
        if n <= 0:
            return True
        with self._lock:
            if n > self.burst:
                return False
            self._refill_locked()
            if self._tokens + _EPS >= n:
                self._tokens = max(0.0, self._tokens - n)
                self.acquired += int(n)
                return True
            return False

    def acquire(self, n: int = 1) -> float:
        """Block until `n` tokens are available; returns seconds waited.

        Raises `RateLimitError` when `n` exceeds the bucket's capacity —
        including every nonzero acquire on a zero-capacity bucket — since
        no amount of waiting could ever satisfy the request.
        """
        if n <= 0:
            return 0.0
        waited = 0.0
        while True:
            with self._lock:
                if n > self.burst:
                    raise RateLimitError(
                        f"acquire({n}) exceeds bucket capacity "
                        f"{self.burst:g}: the request can never be "
                        f"satisfied — lower the batch size or raise burst")
                self._refill_locked()
                if self._tokens + _EPS >= n:
                    self._tokens = max(0.0, self._tokens - n)
                    self.acquired += int(n)
                    self.wait_s += waited
                    return waited
                deficit = (n - self._tokens) / self.rate
            # Sleep outside the lock so other acquirers (and stats reads)
            # are never blocked by our wait.
            self._sleep(deficit)
            waited += deficit

    def __call__(self, n: int = 1) -> float:
        """Alias for `acquire` — the `BatchingOracle` pacer-hook shape."""
        return self.acquire(n)
