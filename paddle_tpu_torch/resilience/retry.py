"""Retry/backoff policy (counterpart of paddle_tpu/resilience/retry.py,
whole).

One policy object with exponential backoff, jitter, an attempt cap, a
wall-clock deadline and exception filters. The DataLoader's worker respawn
(io/worker.py) paces its restarts with it.

Standard library only: forked DataLoader workers import it, and they must
never touch torch's CUDA state.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Optional, Tuple, Type


class RetryError(RuntimeError):
    """All attempts exhausted (or deadline passed); carries the last cause."""

    def __init__(self, message: str, attempts: int, last_exception: BaseException):
        super().__init__(message)
        self.attempts = attempts
        self.last_exception = last_exception


class RetryPolicy:
    """Exponential backoff with jitter, attempt cap, and deadline.

    Args:
        max_attempts: total tries (first call included). <=0 means unlimited
            (the deadline must then bound the loop).
        base_delay: sleep after the first failure (seconds).
        max_delay: backoff ceiling.
        multiplier: backoff growth factor.
        jitter: fraction of the delay randomized away, in [0, 1]. The sleep is
            uniform in [delay*(1-jitter), delay] so the worst case never
            exceeds the deterministic schedule (thundering-herd spread).
        deadline: overall wall-clock budget in seconds; once exceeded no
            further attempt starts.
        retry_on: exception classes considered transient.
        retry_filter: optional predicate(exc) -> bool for finer filtering
            (e.g. retry ConnectionRefusedError but not auth failures).
        sleep: injectable for tests.
    """

    def __init__(
        self,
        max_attempts: int = 3,
        base_delay: float = 0.1,
        max_delay: float = 5.0,
        multiplier: float = 2.0,
        jitter: float = 0.5,
        deadline: Optional[float] = None,
        retry_on: Tuple[Type[BaseException], ...] = (Exception,),
        retry_filter: Optional[Callable[[BaseException], bool]] = None,
        sleep: Callable[[float], None] = time.sleep,
        name: str = "",
    ):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.retry_on = tuple(retry_on)
        self.retry_filter = retry_filter
        self._sleep = sleep
        self.name = name
        self._rng = random.Random(0x5EED)  # deterministic spread for tests

    # -- schedule ----------------------------------------------------------
    def delay_for(self, attempt: int) -> float:
        """Backoff before attempt `attempt+1` (attempt is 1-based count of
        failures so far), pre-jitter."""
        d = self.base_delay * (self.multiplier ** max(attempt - 1, 0))
        return min(d, self.max_delay)

    def _jittered(self, delay: float) -> float:
        if self.jitter <= 0.0 or delay <= 0.0:
            return delay
        lo = delay * (1.0 - self.jitter)
        return self._rng.uniform(lo, delay)

    def _retryable(self, exc: BaseException) -> bool:
        if not isinstance(exc, self.retry_on):
            return False
        if self.retry_filter is not None and not self.retry_filter(exc):
            return False
        return True

    # -- execution ---------------------------------------------------------
    def call(self, fn: Callable, *args, **kwargs):
        """Run fn until it succeeds, attempts run out, or the deadline hits."""
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 — filtered below
                if not self._retryable(exc):
                    raise
                out_of_attempts = (self.max_attempts > 0
                                   and attempt >= self.max_attempts)
                delay = self._jittered(self.delay_for(attempt))
                over_deadline = (
                    self.deadline is not None
                    and time.monotonic() - start + delay >= self.deadline)
                if out_of_attempts or over_deadline:
                    label = self.name or getattr(fn, "__name__", "call")
                    raise RetryError(
                        f"{label}: giving up after {attempt} attempt(s): "
                        f"{type(exc).__name__}: {exc}", attempt, exc) from exc
                self._sleep(delay)

    def backoff(self, attempt: int):
        """Sleep the jittered backoff for `attempt` (1-based failure count).
        For callers that drive their own recovery loop (e.g. worker respawn)
        but want this policy's pacing."""
        self._sleep(self._jittered(self.delay_for(attempt)))

    def jittered_delay(self, attempt: int) -> float:
        """The jittered backoff for `attempt` WITHOUT sleeping — for
        callers that schedule recovery on their own event loop (e.g. the
        fleet replica supervisor arming a respawn deadline) rather than
        blocking a thread on it."""
        return self._jittered(self.delay_for(attempt))

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: `resilient_fn = policy.wrap(fn)`."""

        @functools.wraps(fn)
        def inner(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return inner

    def __repr__(self):  # pragma: no cover
        return (f"RetryPolicy(max_attempts={self.max_attempts}, "
                f"base_delay={self.base_delay}, deadline={self.deadline})")


def retrying(policy: Optional[RetryPolicy] = None, **kwargs) -> Callable:
    """`@retrying(max_attempts=5)` decorator sugar over RetryPolicy.wrap."""
    pol = policy or RetryPolicy(**kwargs)

    def deco(fn):
        return pol.wrap(fn)

    return deco
