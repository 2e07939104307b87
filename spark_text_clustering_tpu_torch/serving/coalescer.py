"""Request coalescer: continuous batching for the scoring service (the
JAX package's ``serving/coalescer.py``, copied onto the port's telemetry
and resilience modules).

Concurrent clients each carry one or a few documents; the device wants
one well-filled dispatch.  The coalescer sits between them: submitted
documents queue under a condition variable, a single batch worker pops
up to ``max_batch`` of them — waiting at most ``linger_s`` after the
first arrival for the batch to fill — and hands the batch to the
service's dispatch function, which scores it in ONE device call and
completes every document's event.  Under load the linger never fires
(batches fill instantly); at low traffic a lone document pays at most
the linger before it ships alone.

Admission control (docs/SERVING.md "Overload & degradation"): the
intake is BOUNDED.  ``max_queue`` caps the total backlog (queued docs
plus whole-request reservations); excess load is refused with the typed
``ServiceOverloaded`` instead of growing the queue without bound until
latency collapses.  Documents carry a priority class
(``interactive`` | ``batch``): when a full queue faces an interactive
arrival, queued BATCH documents are evicted (newest first) to make
room — batch sheds first — and each eviction completes that document
with a typed overload error its waiting client can map to a 429.  The
``serve.admit`` fault site sits at the head of admission so chaos runs
can force typed refusals without real pressure.

The batch worker pops interactive documents first but reserves
``ceil(max_batch * batch_weight)`` slots for the batch class whenever
batch documents are waiting, so a saturating interactive stream can
never starve batch beyond its configured weight.

Accounting per document: ``serve.queue_seconds`` (enqueue -> batch pop)
and, at the service layer, ``serve.request_seconds`` (accept -> response
ready).  Per batch: ``serve.batches`` and the ``serve.batch_fill`` ratio
(live docs / max_batch).  ``serve.queue_depth`` gauges the backlog after
every intake and pop.  Admission verdicts count under the
``admission.`` family (accepted/rejected per class, evictions).

A dispatch failure — including an armed ``serve.batch`` fault — marks
every document in THAT batch with an error (the per-request quarantine
discipline) and the worker keeps serving; ``drain()`` stops
intake, finishes the queue, and joins the worker (the SIGTERM half of
the service lifecycle).
"""

from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .. import telemetry
from ..resilience import ResilienceError, faultinject

__all__ = [
    "PendingDoc",
    "RequestCoalescer",
    "ServiceDraining",
    "ServiceOverloaded",
    "PRIORITIES",
    "DEFAULT_PRIORITY",
]

# batch_fill is a ratio in (0, 1]; the default log2-seconds buckets
# would fold everything above 0.32 into one bin
_FILL_BUCKETS = tuple(i / 16 for i in range(1, 17))

# the priority-class vocabulary of the X-STC-Priority header; anything
# else is folded to the default at the HTTP edge so the intake never
# grows unbounded per-class state from attacker-controlled strings
PRIORITIES = ("interactive", "batch")
DEFAULT_PRIORITY = "interactive"


class ServiceDraining(ResilienceError):
    """The service received its preemption notice: queued documents
    finish, new ones are refused (HTTP 503)."""


class ServiceOverloaded(ResilienceError):
    """The bounded intake refused (or evicted) this document: the
    replica is past its configured backlog.  Maps to a typed HTTP 429
    whose ``Retry-After`` the service computes from the live Erlang-C
    predicted wait — refusal with a schedule, not a timeout."""

    def __init__(
        self,
        message: str,
        *,
        priority: str = DEFAULT_PRIORITY,
        retry_after: Optional[float] = None,
        evicted: bool = False,
    ) -> None:
        super().__init__(message)
        self.priority = priority
        self.retry_after = retry_after
        self.evicted = evicted


@dataclass
class PendingDoc:
    """One document in flight through the coalescer."""

    name: str
    row: tuple                       # (ids, weights) over the model vocab
    priority: str = DEFAULT_PRIORITY
    enqueued_at: float = field(default_factory=time.perf_counter)
    done: threading.Event = field(default_factory=threading.Event)
    distribution: Optional[np.ndarray] = None     # [k] on success
    error: Optional[str] = None                   # repr on failure
    error_kind: Optional[str] = None              # exception class name
    served_by: Optional[dict] = None              # model attribution
    degraded: bool = False           # scored under degraded mode
    # causal timeline stamps (perf_counter space): when the batch
    # worker popped this doc and how long its shared dispatch took —
    # the service turns these into serve.batch_wait / serve.dispatch
    # spans under the request's trace context
    popped_at: Optional[float] = None
    dispatch_seconds: Optional[float] = None

    def fail(self, error: BaseException) -> None:
        self.error = repr(error)
        self.error_kind = type(error).__name__
        self.done.set()


class RequestCoalescer:
    """Queue + single batch worker implementing continuous batching.

    ``dispatch`` receives a non-empty ``List[PendingDoc]`` (at most
    ``max_batch``) and must complete every document — set its result or
    error and fire its event.  Exceptions it raises are converted to
    per-document errors here, so one bad batch can never kill the
    worker.

    ``max_queue`` bounds the intake (None = unbounded, for
    embedded/offline use); ``batch_weight`` is the
    fraction of each dispatch reserved for waiting batch-class docs.
    """

    def __init__(
        self,
        dispatch: Callable[[List[PendingDoc]], None],
        *,
        max_batch: int = 64,
        linger_s: float = 0.005,
        max_queue: Optional[int] = None,
        batch_weight: float = 0.25,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if not 0.0 <= batch_weight < 1.0:
            raise ValueError(
                f"batch_weight must be in [0, 1), got {batch_weight}"
            )
        self.dispatch = dispatch
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_s)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.batch_weight = float(batch_weight)
        self._interactive: List[PendingDoc] = []
        self._batch_docs: List[PendingDoc] = []
        self._reserved = 0           # admitted-but-not-yet-submitted docs
        self._cond = threading.Condition()
        self._draining = False
        self._worker = threading.Thread(
            target=self._run, name="stc-serve-coalescer", daemon=True
        )
        self._worker.start()

    # -- admission -------------------------------------------------------
    # helpers re-acquire _cond (its backing lock is an RLock) so every
    # touch of guarded state is lexically locked; callers hold the lock
    # across the composite check+mutate, which is what makes admission
    # verdicts race-free
    def _depth(self) -> int:
        with self._cond:
            return (
                len(self._interactive)
                + len(self._batch_docs)
                + self._reserved
            )

    def _admit(self, n: int, priority: str) -> None:
        """Admission verdict for ``n`` documents of ``priority``.
        Raises ``ServiceDraining``/``ServiceOverloaded`` on refusal;
        evicts queued batch docs to seat interactive load."""
        with self._cond:
            if self._draining:
                raise ServiceDraining(
                    "scoring service is draining (preemption notice "
                    "received) — retry against another replica"
                )
            try:
                faultinject.check("serve.admit")
            except OSError as exc:
                # an armed chaos fault forces the refusal path: typed,
                # with a schedule, exactly like real pressure
                telemetry.count(f"admission.rejected.{priority}", n)
                raise ServiceOverloaded(
                    f"admission refused (injected): {exc}",
                    priority=priority,
                )
            if self.max_queue is None:
                telemetry.count(f"admission.accepted.{priority}", n)
                return
            space = self.max_queue - self._depth()
            if space < n and priority != "batch":
                # batch sheds first: evict newest batch docs to seat
                # the interactive arrival (each eviction completes its
                # waiting client with a typed overload error)
                while space < n and self._batch_docs:
                    victim = self._batch_docs.pop()
                    victim.fail(ServiceOverloaded(
                        "evicted by interactive load (batch sheds "
                        "first)",
                        priority="batch", evicted=True,
                    ))
                    telemetry.count("admission.evicted")
                    space += 1
            if space < n:
                telemetry.count(f"admission.rejected.{priority}", n)
                telemetry.gauge("serve.queue_depth", self._depth())
                raise ServiceOverloaded(
                    f"intake full ({self._depth()}/{self.max_queue} "
                    f"queued, {n} more refused)",
                    priority=priority,
                )
            telemetry.count(f"admission.accepted.{priority}", n)

    def reserve(self, n: int, priority: str = DEFAULT_PRIORITY) -> None:
        """Admit a whole request of ``n`` documents atomically (the
        service reserves before vectorizing so a multi-doc request is
        admitted or refused as a unit).  Balance with ``n`` ``submit``
        calls and/or ``release`` for documents that never materialize."""
        with self._cond:
            self._admit(n, priority)
            self._reserved += n
            telemetry.gauge("serve.queue_depth", self._depth())

    def release(self, n: int) -> None:
        """Give back unused reservations (vectorizer quarantined docs)."""
        if n <= 0:
            return
        with self._cond:
            self._reserved = max(0, self._reserved - n)
            telemetry.gauge("serve.queue_depth", self._depth())

    # -- intake ----------------------------------------------------------
    def submit(self, doc: PendingDoc) -> PendingDoc:
        """Enqueue one document; raises ``ServiceDraining`` after the
        preemption notice and ``ServiceOverloaded`` past the bound.  A
        prior ``reserve`` covers the admission check; direct submits
        (no reservation outstanding) are admitted here."""
        with self._cond:
            if self._reserved > 0:
                if self._draining:
                    # drain raced the reserve->submit window: give the
                    # slot back and refuse typed
                    self._reserved -= 1
                    raise ServiceDraining(
                        "scoring service is draining (preemption notice "
                        "received) — retry against another replica"
                    )
                self._reserved -= 1
            else:
                self._admit(1, doc.priority)
            if doc.priority == "batch":
                self._batch_docs.append(doc)
            else:
                self._interactive.append(doc)
            telemetry.gauge("serve.queue_depth", self._depth())
            self._cond.notify_all()
        return doc

    def queue_depth(self) -> int:
        return self._depth()

    # -- worker ----------------------------------------------------------
    def _batch_share(self) -> int:
        """Dispatch slots reserved for the batch class when its queue is
        non-empty."""
        with self._cond:
            if not self._batch_docs:
                return 0
            return max(
                1, int(math.ceil(self.max_batch * self.batch_weight))
            )

    def _pop_batch(self) -> Optional[List[PendingDoc]]:
        """Block until a batch is ready (first arrival + fill-or-linger)
        or the drain completes; None ends the worker.  Interactive docs
        board first, but ``batch_weight`` of the dispatch is held for
        waiting batch docs so they are never starved beyond their
        weight."""
        with self._cond:
            while not (self._interactive or self._batch_docs):
                if self._draining:
                    return None
                self._cond.wait(0.1)
            deadline = time.perf_counter() + self.linger_s
            while (
                len(self._interactive) + len(self._batch_docs)
                < self.max_batch
                and not self._draining
            ):
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self._cond.wait(left)
            share = min(self._batch_share(), len(self._batch_docs))
            take_i = min(len(self._interactive), self.max_batch - share)
            take_b = min(
                len(self._batch_docs), self.max_batch - take_i
            )
            batch = self._interactive[:take_i] + self._batch_docs[:take_b]
            del self._interactive[:take_i]
            del self._batch_docs[:take_b]
            telemetry.gauge("serve.queue_depth", self._depth())
            return batch

    def _run(self) -> None:
        while True:
            batch = self._pop_batch()
            if batch is None:
                return
            now = time.perf_counter()
            for d in batch:
                d.popped_at = now
                telemetry.observe(
                    "serve.queue_seconds", now - d.enqueued_at
                )
            wait = sum(now - d.enqueued_at for d in batch) / len(batch)
            telemetry.count("serve.batches")
            fill = len(batch) / self.max_batch
            telemetry.observe(
                "serve.batch_fill", fill, buckets=_FILL_BUCKETS,
            )
            t0 = time.perf_counter()
            try:
                faultinject.check("serve.batch")
                self.dispatch(batch)
            except Exception as exc:
                # the batch dies, its documents get error responses,
                # the SERVICE keeps serving (the quarantine discipline)
                dt = time.perf_counter() - t0
                for d in batch:
                    d.dispatch_seconds = dt
                telemetry.count("serve.quarantined", len(batch))
                telemetry.event(
                    "serve_quarantined", docs=len(batch),
                    error=repr(exc),
                )
                for d in batch:
                    if not d.done.is_set():
                        d.fail(exc)
            else:
                dt = time.perf_counter() - t0
                for d in batch:
                    d.dispatch_seconds = dt
                # the live per-batch record the `stc monitor` serve
                # rules (p99/fill regressions) tail — the registry
                # histograms only reach the stream at shutdown
                # `wait` (mean queue seconds per doc) is the measured
                # half of the queueing observatory's predicted-vs-
                # measured wait divergence (telemetry/queueing.py)
                # `degraded` (fraction of docs answered under degraded
                # mode) feeds the degraded_fraction monitor builtin
                deg = sum(1 for d in batch if d.degraded) / len(batch)
                telemetry.event(
                    "serve_batch",
                    docs=len(batch),
                    seconds=round(dt, 6),
                    fill=round(fill, 4),
                    wait=round(wait, 6),
                    degraded=round(deg, 4),
                )

    # -- drain -----------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> None:
        """Stop intake, finish every queued document, join the worker.
        Idempotent; safe to call from a signal-driven main loop."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        self._worker.join(timeout)
