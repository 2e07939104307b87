"""Black-box prober for the serve fleet (the ``probe`` verb; the JAX
package's ``serving/probe.py``, copied).

Every other serving signal is inside-out: counters the front and the
replicas publish about themselves.  The prober is outside-in: a
synthetic canary that behaves like a client and records what a client
would have seen.  It scores one fixed sentinel document through the
front at a low fixed rate, over a fresh TCP connection a probe
(connection reuse would hide the connect-level failures a new client
meets), under a pinned ``X-STC-Stream``, so generation pinning is
checked from the outside too: the ``X-STC-Generation`` a probe stream
sees must never go backward (a regression counts
``probe.pin_violations``).

Its telemetry is its own run stream: ``probe_request`` events (outcome,
seconds, status, replica, generation) and the ``probe.*`` counters,
under the JAX package's names.

Standard library only, and no torch: the prober must run where no card
is, which is the point of a canary.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..resilience.retry import sleep as _sleep
from .front import (
    DEGRADED_HEADER,
    GENERATION_HEADER,
    PRIORITY_HEADER,
    REPLICA_HEADER,
    STREAM_HEADER,
)

__all__ = [
    "SENTINEL_TEXT",
    "DEFAULT_STREAM",
    "read_front_announce",
    "Prober",
]

# One fixed, boring, language-stable document: the probe measures the
# serving path, not the model, so the input never varies — any latency
# or outcome change is the fleet's, by construction.
SENTINEL_TEXT = (
    "The quick brown fox jumps over the lazy dog while the observant "
    "shepherd counts sheep beside a quiet river in the early morning."
)

DEFAULT_STREAM = "stc-probe"


def read_front_announce(
    fleet_dir: str, wait_s: float = 10.0
) -> Tuple[str, int]:
    """The front's announced address from ``<fleet_dir>/front.json``
    (``serving.front.write_front_announce``), polled until it lands or
    the wait budget runs out: probes usually start beside the fleet."""
    path = os.path.join(fleet_dir, "front.json")
    deadline = time.monotonic() + wait_s
    while True:
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            return str(doc["host"]), int(doc["port"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"no front announce at {path} after {wait_s:.1f}s"
                )
            _sleep(0.1)


class Prober:
    """Fixed-rate synthetic canary against one front address.

    ``probe_once()`` is one client-shaped request; ``run()`` paces
    ``count`` of them at ``rate`` per second (sequential — a canary
    measures the fleet, it must never load it).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        stream: str = DEFAULT_STREAM,
        timeout: float = 5.0,
        text: str = SENTINEL_TEXT,
        priority: Optional[str] = None,
    ) -> None:
        self.host = host
        self.port = int(port)
        self.stream = stream
        self.timeout = float(timeout)
        self.priority = priority
        self.body = json.dumps(
            {"text": text, "names": ["probe"]}
        ).encode("utf-8")
        self._pin: Optional[int] = None
        self._lock = threading.Lock()
        self.sent = 0
        self.failures = 0
        self.rejected = 0
        self.degraded = 0
        self.pin_violations = 0

    def probe_once(self) -> Dict:
        """One outside-in request; returns the ``probe_request`` record
        it also emitted.  Never raises: a dead front is an ``error``
        outcome, which is exactly the measurement.  A typed 429 (shed
        or admission refusal) is its own ``rejected`` outcome — under
        deliberate overload a priced refusal is the system working, and
        the SLO objectives must be able to tell it from a failure."""
        t0 = time.perf_counter()
        status: Optional[int] = None
        replica: Optional[int] = None
        generation: Optional[int] = None
        retry_after: Optional[float] = None
        degraded = False
        outcome = "ok"
        headers = {
            "Content-Type": "application/json",
            STREAM_HEADER: self.stream,
        }
        if self.priority:
            headers[PRIORITY_HEADER] = self.priority
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(
                "POST", "/score", body=self.body, headers=headers
            )
            resp = conn.getresponse()
            resp.read()
            status = resp.status
            if status == 429:
                outcome = "rejected"
                ra = resp.getheader("Retry-After")
                try:
                    retry_after = float(ra) if ra else None
                except ValueError:
                    retry_after = None
            elif status != 200:
                outcome = "error_status"
            degraded = resp.getheader(DEGRADED_HEADER) is not None
            r = resp.getheader(REPLICA_HEADER)
            g = resp.getheader(GENERATION_HEADER)
            replica = int(r) if r is not None and r.isdigit() else None
            generation = (
                int(g) if g is not None and g.lstrip("-").isdigit()
                else None
            )
        except (http.client.HTTPException, OSError):
            outcome = "error"
        finally:
            try:
                conn.close()
            except OSError:
                pass
        dt = time.perf_counter() - t0

        violation = False
        with self._lock:
            # ramp mode runs probe_once on many threads: the pin and
            # the tallies are shared, so fold them under the lock
            if generation is not None:
                if self._pin is not None and generation < self._pin:
                    # the stream observed an OLDER model generation than
                    # it was already answered with — the interleaving
                    # the front's pinning exists to forbid, from outside
                    violation = True
                    self.pin_violations += 1
                    telemetry.count("probe.pin_violations")
                else:
                    self._pin = generation
            self.sent += 1
            if outcome == "rejected":
                self.rejected += 1
            elif outcome != "ok":
                self.failures += 1
            if degraded:
                self.degraded += 1
        telemetry.count("probe.requests")
        if outcome == "rejected":
            telemetry.count("probe.rejected")
        elif outcome != "ok":
            telemetry.count("probe.failures")
        telemetry.observe("probe.request_seconds", dt)
        rec = {
            "outcome": outcome,
            "seconds": round(dt, 6),
            "status": status,
            "replica": replica,
            "generation": generation,
            "pin_violation": violation,
            "priority": self.priority,
            "retry_after": retry_after,
            "degraded": degraded,
        }
        telemetry.event("probe_request", **rec)
        return rec

    def _summary(self) -> Dict:
        with self._lock:
            return {
                "sent": self.sent,
                "failures": self.failures,
                "rejected": self.rejected,
                "degraded": self.degraded,
                "pin_violations": self.pin_violations,
            }

    def run(self, count: int, rate: float) -> Dict:
        """``count`` probes at ``rate``/s (fixed pacing off the wall
        clock, so a slow fleet cannot slow the probe cadence down and
        flatter its own availability window)."""
        interval = 1.0 / max(rate, 1e-6)
        t_next = time.monotonic()
        for _ in range(int(count)):
            self.probe_once()
            t_next += interval
            delay = t_next - time.monotonic()
            if delay > 0:
                _sleep(delay)
        return self._summary()

    def run_ramp(
        self, count: int, rate: float, ramp_to: float
    ) -> Dict:
        """Open-loop load ramp: ``count`` requests whose send rate
        climbs linearly from ``rate``/s to ``ramp_to``/s, each fired on
        its own thread AT its scheduled time whether or not earlier
        requests have answered.  The closed-loop ``run()`` can never
        drive a fleet past saturation (a slow fleet slows the prober —
        the classic coordinated-omission trap); an overload drill needs
        exactly the arrivals-keep-coming behavior of real clients."""
        n = max(1, int(count))
        threads: List[threading.Thread] = []
        t0 = time.monotonic()
        offset = 0.0
        for i in range(n):
            frac = i / max(1, n - 1)
            cur = max(1e-6, rate + (ramp_to - rate) * frac)
            delay = (t0 + offset) - time.monotonic()
            if delay > 0:
                _sleep(delay)
            th = threading.Thread(target=self.probe_once, daemon=True)
            th.start()
            threads.append(th)
            offset += 1.0 / cur
        for th in threads:
            th.join(self.timeout + 1.0)
        return self._summary()
