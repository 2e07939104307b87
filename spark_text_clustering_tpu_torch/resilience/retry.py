"""Retry with jittered exponential backoff and a deadline, copied from the
JAX package: one policy object serves every transient-I/O call site
(stream polls, checkpoint, artifact and report writes, ledger appends).

Jitter is deterministic per call site: the jitter stream is seeded from
the site name, so a fault-injected run replays exactly and takes the same
delays in both packages.  Retries are observable: every absorbed failure
counts in ``resilience.retries`` and every exhausted policy in
``resilience.giveups`` (and ``resilience.deadline_giveups`` when the clock
ran out), plus a ``retry`` event when a run stream is configured.
"""

from __future__ import annotations

import random
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Type

from .errors import ResilienceError

__all__ = [
    "IO_POLICY",
    "TELEMETRY_POLICY",
    "RetryGiveUp",
    "RetryPolicy",
    "backoff_delays",
    "configure_lease_deadline",
    "lease_deadline",
    "retry_call",
    "sleep",
]

RETRIES_COUNTER = "resilience.retries"
GIVEUPS_COUNTER = "resilience.giveups"
DEADLINE_GIVEUPS_COUNTER = "resilience.deadline_giveups"


def sleep(seconds: float) -> None:
    """The one wall-clock wait of every backoff and poll delay: tests
    replace this symbol to run a simulated clock."""
    if seconds > 0:
        time.sleep(seconds)


class RetryGiveUp(ResilienceError):
    """A retry policy exhausted its attempts or deadline; ``last`` is the
    final underlying exception (also chained as ``__cause__``), and
    ``deadline_exceeded`` tells a budget spent on the clock from one spent
    on attempts."""

    def __init__(
        self,
        site: str,
        attempts: int,
        last: BaseException,
        deadline_exceeded: bool = False,
    ) -> None:
        self.site = site
        self.attempts = attempts
        self.last = last
        self.deadline_exceeded = deadline_exceeded
        why = "deadline expired" if deadline_exceeded else "gave up"
        super().__init__(
            f"{site}: {why} after {attempts} attempt(s): {last!r}"
        )


@dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with an optional wall-clock deadline.

    Delay before attempt ``i`` (0-based; attempt 0 is immediate)::

        min(max_delay, base_delay * multiplier**(i-1)) * (1 ± jitter)

    ``deadline_seconds`` bounds the whole retry loop: once it elapses no
    further attempt starts and ``RetryGiveUp`` raises with
    ``deadline_exceeded=True``.  The process-wide cap of
    ``configure_lease_deadline`` applies on top of it.
    """

    attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.25            # fraction of the delay, uniform ±
    deadline_seconds: Optional[float] = None
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    # False: count retries in the registry but emit no ``retry`` event —
    # the telemetry sink's own retries (an event would re-enter the
    # failing sink)
    emit_events: bool = True

    def delay(self, attempt: int, rng: Optional[random.Random] = None) -> float:
        if attempt <= 0:
            return 0.0
        d = min(
            self.max_delay, self.base_delay * self.multiplier ** (attempt - 1)
        )
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return d


# I/O micro-retry: absorbs transient filesystem hiccups without letting a
# dead disk stall the caller for more than about a second.
IO_POLICY = RetryPolicy(attempts=4, base_delay=0.05, max_delay=0.5)

# Telemetry writes are best-effort: one quick second chance, never a
# stall, and no retry events.
TELEMETRY_POLICY = RetryPolicy(
    attempts=2, base_delay=0.01, max_delay=0.01, emit_events=False
)

# Process-wide cap on every retry loop's deadline (None: unbounded), for a
# worker that must fail typed before its supervisor's lease runs out.
_lease_deadline: Optional[float] = None


def configure_lease_deadline(seconds: Optional[float]) -> None:
    """Cap every retry loop in this process at ``seconds`` of wall clock
    (None removes the cap)."""
    global _lease_deadline
    _lease_deadline = float(seconds) if seconds is not None else None


def lease_deadline() -> Optional[float]:
    return _lease_deadline


def _effective_deadline(policy: RetryPolicy) -> Optional[float]:
    if policy.deadline_seconds is None:
        return _lease_deadline
    if _lease_deadline is None:
        return policy.deadline_seconds
    return min(policy.deadline_seconds, _lease_deadline)


def _site_rng(site: str) -> random.Random:
    return random.Random(zlib.crc32(site.encode("utf-8")))


def backoff_delays(policy: RetryPolicy, site: str = "") -> Iterator[float]:
    """The policy's delay schedule (one entry per attempt, the first 0),
    for callers that drive their own loop (the accelerator probe)."""
    rng = _site_rng(site)
    for i in range(policy.attempts):
        yield policy.delay(i, rng)


def _count(name: str, **event_fields) -> None:
    # late import: the telemetry sink's own retries route through here
    from .. import telemetry

    telemetry.count(name)
    if event_fields:
        telemetry.event("retry", **event_fields)


def retry_call(
    fn: Callable,
    *args,
    site: str,
    policy: RetryPolicy = IO_POLICY,
    sleep: Callable[[float], None] = sleep,
    **kwargs,
):
    """``fn(*args, **kwargs)`` under ``policy``: exceptions in
    ``policy.retry_on`` are absorbed (counted in ``resilience.retries``)
    until the attempts or the deadline run out, then ``RetryGiveUp``
    raises (counted in ``resilience.giveups``) with the last one chained.
    Other exceptions propagate at once."""
    rng = _site_rng(site)
    t0 = time.monotonic()
    deadline = _effective_deadline(policy)
    last: Optional[BaseException] = None
    deadline_hit = False
    attempts_made = 0
    for attempt in range(policy.attempts):
        d = policy.delay(attempt, rng)
        if deadline is not None and (
            time.monotonic() - t0 + d >= deadline
        ):
            # the budget would expire during (or before) this backoff
            deadline_hit = attempt > 0 or deadline <= 0
            if deadline_hit:
                break
        if d:
            sleep(d)
        try:
            attempts_made += 1
            return fn(*args, **kwargs)
        except policy.retry_on as exc:
            last = exc
            if policy.emit_events:
                _count(RETRIES_COUNTER, site=site, attempt=attempt,
                       error=repr(exc))
            else:
                _count(RETRIES_COUNTER)
    if last is None:
        # a zero or negative budget expired before the first attempt
        last = TimeoutError(
            f"retry budget of {deadline}s expired before any attempt"
        )
    _count(GIVEUPS_COUNTER)
    if deadline_hit:
        _count(DEADLINE_GIVEUPS_COUNTER)
    raise RetryGiveUp(
        site, attempts_made, last, deadline_exceeded=deadline_hit
    ) from last
