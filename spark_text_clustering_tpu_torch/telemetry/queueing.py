"""Queueing-signal estimation for the serve fleet: λ, S, ρ, and the
M/M/c-predicted wait (docs/OBSERVABILITY.md "SLOs & error budgets"): the
JAX package's ``telemetry/queueing.py``, copied; it reports through the
port's telemetry facade.

Traffic-shaped serving needs to know it is about to be overloaded
*before* p99 fires.  The minimal sufficient statistics are exactly the
queueing-theory triple:

  * **λ** (``queueing.lambda``): request arrival rate, counted from the
    front's typed per-request accounting (every exit path, not just
    successes — a refused request still arrived);
  * **S** (``queueing.service_seconds``): per-document service time,
    attributed from ``serve_batch`` dispatch records (batch wall
    seconds over batch docs — the ``serve.request_seconds`` minus
    ``serve.queue_seconds`` attribution, computed from the live event
    stream instead of the shutdown-only histograms);
  * **ρ** (``queueing.rho``): utilization ``λ·S / c`` fleet-wide, plus
    the measured per-replica busy fraction
    (``queueing.replica.<i>.rho``) whose spread exposes routing skew.

From (λ, S, c) the Erlang-C formula predicts the steady-state M/M/c
wait (mean and p99); publishing the prediction NEXT TO the measured
coalescer wait makes "the queueing model no longer describes the
fleet" (``queueing.wait_divergence``) an alertable scalar — the
monitor's ``queue_wait_divergence`` built-in rule consumes it.

The estimator is fed two ways, same math either way: the alert engine
tails front + replica run streams and forwards their events
(``observe_event``); the serve-fleet supervisor runs one in-process
next to its embedded front, reading arrivals off the front's own
counters (``note_arrivals``) and replica streams off the worker
telemetry dir — which is what puts the gauges on the front's
``/metrics`` exposition live.

Stdlib-only, like every telemetry module.
"""

from __future__ import annotations

import math
import re
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from .. import telemetry

__all__ = [
    "erlang_c",
    "predicted_waits",
    "QueueingEstimator",
    "PredictiveAutoscaler",
]

# replica index out of a StreamSet label ("worker-w002-s0.jsonl")
_WORKER_RE = re.compile(r"w(\d+)")

# predicted-wait floor for the divergence ratio: an idle fleet predicts
# ~0 wait, and measured/predicted on two near-zeros is noise, not signal
_PREDICT_FLOOR = 0.005

_EPS = 1e-12


def erlang_c(c: int, a: float) -> float:
    """P(wait > 0) for M/M/c at offered load ``a = λ·S`` — via the
    Erlang-B recurrence (numerically stable for any c).  Saturated or
    oversubscribed (``a >= c``) clamps to 1.0: every arrival waits."""
    if a <= 0.0:
        return 0.0
    if a >= c:
        return 1.0
    b = 1.0
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho + rho * b)


def predicted_waits(
    c: int, lam: float, service_s: float
) -> Tuple[float, float]:
    """(mean, p99) steady-state M/M/c queueing wait in seconds.  A
    saturated fleet (``λ·S >= c``) has no steady state — both values
    clamp to ``inf`` and the caller renders/publishes a cap."""
    a = lam * service_s
    if service_s <= 0.0 or lam < 0.0:
        return 0.0, 0.0
    if a >= c:
        return math.inf, math.inf
    p_wait = erlang_c(c, a)
    drain = (c - a) / service_s          # cμ - λ
    mean = p_wait / max(drain, _EPS)
    if p_wait <= 0.01:
        p99 = 0.0
    else:
        p99 = math.log(p_wait / 0.01) / max(drain, _EPS)
    return mean, p99


class QueueingEstimator:
    """Windowed λ/S/ρ estimation over serve-fleet telemetry.

    Feed it ``front_request`` / ``probe_request`` events (arrivals) and
    ``serve_batch`` events (service attribution) via ``observe_event``,
    or raw arrival counts via ``note_arrivals``; ``estimate(now)``
    publishes the ``queueing.*`` gauges and returns one
    ``queueing_estimate`` pseudo-event (or None while there is no
    signal yet).  Bounded memory: samples older than the window are
    pruned every estimate, with a hard item cap behind the time bound.
    """

    MAX_SAMPLES = 50_000

    def __init__(
        self,
        window_seconds: float = 30.0,
        *,
        replica_count: Optional[int] = None,
    ) -> None:
        self.window_seconds = float(window_seconds)
        self.replica_count = replica_count
        # (ts, n) arrival marks; (ts, docs, seconds, wait_mean, key)
        self._arrivals: Deque[Tuple[float, int]] = deque()
        self._batches: Deque[
            Tuple[float, int, float, Optional[float], str]
        ] = deque()
        self._t0: Optional[float] = None

    # -- ingest ----------------------------------------------------------
    def note_arrivals(self, n: int, ts: float) -> None:
        if n <= 0:
            return
        if self._t0 is None:
            self._t0 = ts
        self._arrivals.append((float(ts), int(n)))

    def observe_event(self, ts: float, e: Dict) -> None:
        name = e.get("event")
        if name in ("front_request", "probe_request"):
            self.note_arrivals(1, ts)
            return
        if name != "serve_batch":
            return
        docs = e.get("docs")
        seconds = e.get("seconds")
        if not isinstance(docs, (int, float)) or \
                not isinstance(seconds, (int, float)) or \
                isinstance(docs, bool) or isinstance(seconds, bool):
            return
        wait = e.get("wait")
        wait_f = (
            float(wait)
            if isinstance(wait, (int, float))
            and not isinstance(wait, bool) else None
        )
        if self._t0 is None:
            self._t0 = ts
        self._batches.append(
            (float(ts), int(docs), float(seconds), wait_f,
             str(e.get("_stream", "self")))
        )

    def observe_events(self, pairs) -> None:
        for ts, e in pairs:
            self.observe_event(ts, e)

    def _prune(self, now: float) -> None:
        lo = now - self.window_seconds
        for q in (self._arrivals, self._batches):
            while q and q[0][0] < lo:
                q.popleft()
            while len(q) > self.MAX_SAMPLES:
                q.popleft()

    # -- the estimate ----------------------------------------------------
    def estimate(self, now: float) -> Optional[Dict]:
        self._prune(now)
        if not self._arrivals and not self._batches:
            return None
        # effective window: a fleet 3 s old has 3 s of signal, not 30
        eff = self.window_seconds
        if self._t0 is not None:
            eff = min(eff, max(now - self._t0, 1e-3))

        lam = sum(n for _, n in self._arrivals) / eff

        docs = sum(d for _, d, _, _, _ in self._batches)
        busy = sum(s for _, _, s, _, _ in self._batches)
        service_s = (busy / docs) if docs else None

        per_replica: Dict[str, float] = {}
        for _, _, s, _, key in self._batches:
            per_replica[key] = per_replica.get(key, 0.0) + s
        c = self.replica_count or max(1, len(per_replica))

        waits = [
            (w, d) for _, d, _, w, _ in self._batches if w is not None
        ]
        measured_wait = (
            sum(w * d for w, d in waits)
            / max(sum(d for _, d in waits), 1)
            if waits else None
        )

        ev: Dict = {
            "event": "queueing_estimate",
            "ts": round(now, 6),
            "window_seconds": round(eff, 3),
            "lambda": round(lam, 6),
            "replicas": c,
        }
        telemetry.count("queueing.updates")
        telemetry.gauge("queueing.lambda", lam)
        telemetry.gauge("queueing.replicas", c)
        for key, b in sorted(per_replica.items()):
            m = _WORKER_RE.search(key)
            if m is None:
                continue
            telemetry.gauge(
                f"queueing.replica.{int(m.group(1))}.rho", b / eff
            )
        if service_s is not None:
            rho = lam * service_s / c
            mean_w, p99_w = predicted_waits(c, lam, service_s)
            # a saturated fleet predicts an unbounded wait; publish the
            # window itself as the cap — "longer than anything we can
            # see" — so gauges and JSON stay finite
            cap = self.window_seconds
            mean_w = min(mean_w, cap)
            p99_w = min(p99_w, cap)
            ev.update({
                "service_seconds": round(service_s, 6),
                "rho": round(rho, 6),
                "predicted_wait_seconds": round(mean_w, 6),
                "predicted_wait_p99_seconds": round(p99_w, 6),
            })
            telemetry.gauge("queueing.service_seconds", service_s)
            telemetry.gauge("queueing.rho", rho)
            telemetry.gauge("queueing.predicted_wait_seconds", mean_w)
            telemetry.gauge(
                "queueing.predicted_wait_p99_seconds", p99_w
            )
            if measured_wait is not None:
                divergence = measured_wait / max(
                    mean_w, _PREDICT_FLOOR
                )
                ev.update({
                    "measured_wait_seconds": round(measured_wait, 6),
                    "wait_divergence": round(divergence, 6),
                })
                telemetry.gauge(
                    "queueing.measured_wait_seconds", measured_wait
                )
                telemetry.gauge(
                    "queueing.wait_divergence", divergence
                )
        return ev


class PredictiveAutoscaler:
    """Turn queueing estimates into replica-count decisions BEFORE the
    p99 burn-rate page fires (the control half of the estimate above).

    The p99 alert is lagging by construction: by the time the tail
    breaches, the queue that caused it is already full.  ρ = λ·S/c is
    leading — it crosses ``high_rho`` while waits are still bounded
    (the Erlang-C knee), which is exactly when adding a replica still
    prevents the breach instead of mopping it up.

    Deliberately boring control law, because flapping is worse than
    lag:

      * **hysteresis** — a decision needs ``confirm`` *consecutive*
        estimates beyond the threshold (one window-sized spike is not
        load), and ``high_rho``/``low_rho`` leave a dead band between
        them;
      * **cooldown** — after any decision the controller holds for
        ``cooldown_seconds`` (a fresh replica needs a model load + a
        warmup before it absorbs anything; deciding again off the
        pre-spawn signal double-scales);
      * **clamps** — the target never leaves
        ``[min_replicas, max_replicas]``.

    ``decide()`` is pure policy: it returns the decision (or None) and
    publishes ``autoscale.*`` accounting; the serve-fleet supervisor
    owns actuation through the same ledger-gated actions-file path the
    monitor's alert actions ride.
    """

    def __init__(
        self,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        high_rho: float = 0.8,
        low_rho: float = 0.3,
        confirm: int = 2,
        cooldown_seconds: float = 30.0,
    ) -> None:
        if not 0.0 < low_rho < high_rho:
            raise ValueError(
                f"need 0 < low_rho < high_rho, got "
                f"low={low_rho} high={high_rho}"
            )
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"min={min_replicas} max={max_replicas}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_rho = float(high_rho)
        self.low_rho = float(low_rho)
        self.confirm = max(1, int(confirm))
        self.cooldown_seconds = float(cooldown_seconds)
        self._streak = 0                 # +n hot estimates / -n cold
        self._last_decision_ts: Optional[float] = None

    def decide(
        self, estimate: Optional[Dict], now: float,
        *, current: Optional[int] = None,
    ) -> Optional[Dict]:
        """Fold one ``queueing_estimate`` (as returned by
        ``QueueingEstimator.estimate``); returns a decision dict
        ``{"action", "from", "to", "rho", "streak"}`` or None.
        ``current`` overrides the estimate's replica count with the
        supervisor's actual spawn target (the estimate counts streams
        it has SEEN, which lags a replica that is still loading)."""
        if not estimate:
            return None
        rho = estimate.get("rho")
        if not isinstance(rho, (int, float)) or isinstance(rho, bool):
            return None                  # no service signal yet
        c = current if current is not None else int(
            estimate.get("replicas", self.min_replicas)
        )
        if rho >= self.high_rho:
            self._streak = max(1, self._streak + 1)
        elif rho <= self.low_rho:
            self._streak = min(-1, self._streak - 1)
        else:
            self._streak = 0             # dead band: no opinion
        if self._last_decision_ts is not None and \
                now - self._last_decision_ts < self.cooldown_seconds:
            return None
        action: Optional[str] = None
        target = c
        if self._streak >= self.confirm and c < self.max_replicas:
            action, target = "scale_out", c + 1
        elif self._streak <= -self.confirm and c > self.min_replicas:
            action, target = "scale_in", c - 1
        if action is None:
            return None
        self._last_decision_ts = now
        self._streak = 0
        telemetry.count(f"autoscale.{action}")
        telemetry.gauge("autoscale.target", target)
        decision = {
            "action": action,
            "from": c,
            "to": target,
            "rho": round(float(rho), 6),
            "streak": self.confirm,
        }
        telemetry.event("autoscale_decision", **decision)
        return decision
