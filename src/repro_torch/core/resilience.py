"""Fault tolerance for the oracle channel: taxonomy, retries, breaker.

The paper's operational model treats the oracle as "often a human or an
expensive machine learning model" (§1) — in production that is a flaky
remote service: calls time out, rate-limit, and return malformed
batches. This module gives `core.oracle.BatchingOracle` the pieces it
needs to survive that without weakening any statistical guarantee:

Error taxonomy
    `OracleTransientError` (and its subclasses `OracleTimeoutError`,
    `OracleMalformedError`) marks failures worth retrying;
    `OracleFatalError` marks ones that are not. Any exception may carry
    a boolean ``retryable`` attribute to classify itself (the serving
    plane's `RateLimitError` sets ``retryable = False`` — a request
    that exceeds bucket capacity can never succeed); unknown exceptions
    fall back to `is_retryable`'s built-in transport heuristics.

`RetryPolicy`
    Exponential backoff with *deterministic* jitter: the jitter is a
    pure hash of (seed, attempt, salt), never global randomness, and
    the sleep function is injectable — exactly like `serve.TokenBucket`
    — so tests drive retries without wall-clock time. Retries re-ask
    the oracle for the *same* records; for a pure oracle the labels are
    identical whenever they arrive, so retries can never change a
    committed result (see `docs/guarantees.md`, "Failure semantics").

`CircuitBreaker`
    closed → open after N consecutive exhausted micro-batches →
    half-open probe after a cooldown. The channel consults it once per
    micro-batch, before the retry loop — a granted half-open probe
    covers every attempt of that chunk, and the chunk's final outcome
    settles the probe; the serving plane consults it at admission so a
    down oracle sheds load with a retry-after hint instead of queueing
    work that will die.

`call_with_timeout`
    The per-call watchdog: runs the oracle callable on a sacrificial
    thread and raises `OracleTimeoutError` if it overruns the deadline
    (the runaway call's eventual result is discarded, never cached).

>>> sleeps = []
>>> policy = RetryPolicy(max_attempts=3, base_delay_s=0.1, jitter=0.0,
...                      sleep=sleeps.append)
>>> [round(policy.backoff_s(a), 3) for a in (1, 2, 3)]
[0.1, 0.2, 0.4]
>>> policy.backoff_s(2, salt=7) == policy.backoff_s(2, salt=7)  # pure
True
>>> is_retryable(OracleTimeoutError("slow")), is_retryable(ValueError())
(True, False)
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

__all__ = [
    "OracleError", "OracleTransientError", "OracleTimeoutError",
    "OracleMalformedError", "OracleFatalError", "CircuitOpenError",
    "is_retryable", "RetryPolicy", "CircuitBreaker", "call_with_timeout",
]


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class OracleError(RuntimeError):
    """Base class for typed oracle-channel failures."""


class OracleFatalError(OracleError):
    """A failure that retrying cannot fix (never retried)."""

    retryable = False


class OracleTransientError(OracleError):
    """A failure expected to clear on retry (network blip, 5xx, ...)."""

    retryable = True


class OracleTimeoutError(OracleTransientError):
    """An oracle call overran its per-call deadline (watchdog fired)."""


class OracleMalformedError(OracleTransientError, ValueError):
    """The oracle returned a malformed batch (wrong length, non-finite
    labels). Rejected before caching and retried — a torn response must
    never poison the shared label cache."""


class CircuitOpenError(OracleError):
    """The circuit breaker is open: the channel (or server) is shedding
    work instead of hammering a down oracle. `retry_after_s` hints when
    the next probe will be allowed."""

    retryable = False

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


#: Built-in exception types treated as transient when the exception does
#: not classify itself via a ``retryable`` attribute. These are the
#: shapes real transports raise: socket resets, OS-level I/O errors,
#: stdlib timeouts.
_TRANSIENT_BUILTINS = (ConnectionError, TimeoutError, InterruptedError,
                       OSError)

#: `OSError` subclasses that are deterministic, not transport blips: a
#: missing file, a permission wall, or a path-shape error will not heal
#: on retry — retrying one just burns the whole backoff budget on the
#: drain thread (under the channel lock) before failing anyway.
_DETERMINISTIC_OSERRORS = (FileNotFoundError, FileExistsError,
                           IsADirectoryError, NotADirectoryError,
                           PermissionError)


def is_retryable(err: BaseException) -> bool:
    """Classify an exception as retryable (transient) or fatal.

    An explicit boolean ``retryable`` attribute on the exception wins
    (the taxonomy classes above carry one; `serve.RateLimitError`
    declares itself fatal); otherwise common transport exception types
    are transient — except the deterministic `OSError` subclasses like
    `FileNotFoundError` and `PermissionError`, which no retry can fix —
    and everything else — `ValueError`, assertion failures, arbitrary
    logic errors — is fatal, because retrying a deterministic bug just
    burns the rate budget.
    """
    flag = getattr(err, "retryable", None)
    if flag is not None:
        return bool(flag)
    if isinstance(err, _DETERMINISTIC_OSERRORS):
        return False
    return isinstance(err, _TRANSIENT_BUILTINS)


# ---------------------------------------------------------------------------
# Retry policy — exponential backoff, deterministic jitter
# ---------------------------------------------------------------------------

def _hash01(*parts: int) -> float:
    """Pure integer hash of `parts` into [0, 1) — splitmix64-flavored.

    This is the jitter source: no global RNG, no wall clock, so a retry
    schedule is a deterministic function of (seed, attempt, salt) and a
    faulty run replays bit-for-bit.
    """
    x = 0x9E3779B97F4A7C15
    for p in parts:
        x = (x ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return (x >> 11) / float(1 << 53)


@dataclasses.dataclass
class RetryPolicy:
    """How the channel retries a failed oracle micro-batch.

    `max_attempts` bounds total invocations (1 = no retries). Backoff
    before retry ``attempt`` (1-based: the wait after the attempt-th
    failure) is ``base_delay_s * multiplier**(attempt-1)``, capped at
    `max_delay_s`, then shrunk by up to ``jitter`` fraction using the
    deterministic `_hash01` of (seed, attempt, salt) — `salt` lets the
    channel decorrelate concurrent micro-batches without randomness.
    `sleep` and `classify` are injectable for tests (`classify` defaults
    to `is_retryable`).
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    sleep: Callable[[float], None] = time.sleep
    classify: Optional[Callable[[BaseException], bool]] = None

    def __post_init__(self):
        """Validate the knobs once, loudly."""
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def retryable(self, err: BaseException) -> bool:
        """True when `err` is worth another attempt under this policy."""
        return (self.classify or is_retryable)(err)

    def backoff_s(self, attempt: int, salt: int = 0) -> float:
        """Deterministic backoff before retry `attempt` (1-based)."""
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** (attempt - 1))
        if self.jitter <= 0.0:
            return raw
        return raw * (1.0 - self.jitter * _hash01(self.seed, attempt, salt))


# ---------------------------------------------------------------------------
# Circuit breaker — closed -> open -> half-open probe
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Sheds oracle traffic after `failure_threshold` consecutive
    exhausted micro-batches.

    closed: everything flows; each exhausted micro-batch counts, each
    success resets the count. open: `allow()` rejects until
    `reset_timeout_s` has elapsed on the injectable clock, then flips
    to half-open and grants exactly one probe. half-open: the probe's
    outcome decides — success closes the circuit, failure re-opens it
    (and restarts the cooldown). Thread-safe; transition counters
    (`opens`, `closes`, `probes`, `rejections`) feed `ServerStats`.

    >>> t = [0.0]
    >>> br = CircuitBreaker(failure_threshold=2, reset_timeout_s=10.0,
    ...                     clock=lambda: t[0])
    >>> br.record_failure(); br.state
    'closed'
    >>> br.record_failure(); br.state          # threshold hit
    'open'
    >>> br.allow()                             # cooling down
    False
    >>> t[0] = 11.0
    >>> br.allow(), br.state                   # cooldown over: one probe
    (True, 'half-open')
    >>> br.allow()                             # probe already in flight
    False
    >>> br.record_success(); br.state
    'closed'
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, *,
                 clock: Callable[[], float] = time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if reset_timeout_s < 0:
            raise ValueError("reset_timeout_s must be >= 0")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opens = 0          # closed/half-open -> open transitions
        self.closes = 0         # open/half-open -> closed transitions
        self.probes = 0         # half-open probes granted
        self.rejections = 0     # allow() == False occurrences

    @property
    def state(self) -> str:
        """Current state name (no transition side effects)."""
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller invoke the oracle now?

        closed: yes. open: no until the cooldown elapses, at which point
        the circuit flips to half-open and this call is the one granted
        probe. half-open: no (a probe is already in flight).
        """
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and \
                    self._clock() - self._opened_at >= self.reset_timeout_s:
                self._state = self.HALF_OPEN
                self.probes += 1
                return True
            self.rejections += 1
            return False

    def retry_after_s(self) -> float:
        """Seconds until the open circuit will grant a probe (0 when the
        circuit is not open or the cooldown already elapsed) — the
        retry-after hint `CircuitOpenError` carries."""
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_timeout_s
                       - (self._clock() - self._opened_at))

    def record_success(self) -> None:
        """A micro-batch labeled cleanly: reset the failure streak and
        close the circuit (a successful half-open probe heals it)."""
        with self._lock:
            self._failures = 0
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self.closes += 1

    def record_failure(self) -> None:
        """A micro-batch exhausted its retries (or failed fatally):
        extend the streak; trip open at the threshold, and re-open
        immediately on a failed half-open probe."""
        with self._lock:
            self._failures += 1
            if self._state == self.HALF_OPEN or (
                    self._state == self.CLOSED
                    and self._failures >= self.failure_threshold):
                self._state = self.OPEN
                self._opened_at = self._clock()
                self._failures = 0
                self.opens += 1


# ---------------------------------------------------------------------------
# Per-call watchdog
# ---------------------------------------------------------------------------

def call_with_timeout(fn: Callable, arg, timeout_s: float):
    """Invoke ``fn(arg)`` with a hard deadline.

    The call runs on a fresh sacrificial daemon thread; if it does not
    finish within `timeout_s` seconds an `OracleTimeoutError` is raised
    and the runaway call is abandoned — whatever it eventually returns
    is discarded, so a late answer can never reach the label cache. A
    thread per call is cheap next to an oracle invocation (the whole
    point of the channel is that ``fn`` is expensive).

    Abandoned means exactly that: Python offers no safe way to kill the
    runaway thread, so it keeps executing ``fn`` until it returns on
    its own. A caller that retries after the timeout (the channel's
    `RetryPolicy` does) therefore re-invokes ``fn`` while the abandoned
    call may still be running — ``fn`` must tolerate concurrent
    invocation. Pure functions and `testing.FaultInjector` (which locks
    internally) qualify; an oracle with shared mutable state needs its
    own synchronization.
    """
    box: List[Tuple[str, object]] = []
    done = threading.Event()

    def runner():
        try:
            box.append(("ok", fn(arg)))
        except BaseException as e:  # noqa: BLE001 — rethrown below
            box.append(("err", e))
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="repro-torch-oracle-call")
    t.start()
    if not done.wait(timeout_s):
        raise OracleTimeoutError(
            f"oracle call overran its {timeout_s:g}s deadline "
            f"(batch of {getattr(arg, 'size', len(arg))} records); "
            f"the call was abandoned")
    kind, val = box[0]
    if kind == "err":
        raise val
    return val
