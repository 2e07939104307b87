"""The serve fleet's routing front: one port, N hot replicas behind it
(the JAX package's ``serving/front.py``, copied).

N ``serve`` replicas run under ``supervise --role serve``
(``resilience.supervisor.ServeFleetSupervisor``); this module's thin
HTTP front spreads ``/score`` over them:

  * **Discovery is the lease protocol.**  Serve replicas renew the same
    heartbeat lease files stream workers do (``leases/w000.json``), with
    ``role="serve"``, the auto-picked ``port``, the replica ``state``
    (``starting``/``ready``/``draining``) and the served model's
    ``model_path``/``model_stamp``.  The front holds no topology of its
    own: it re-reads the lease dir and routes to whatever is alive, so a
    respawned replica is back in rotation the moment its lease lands.
    The lease fields are the JAX package's: either package's front reads
    either package's fleet.
  * **Least-outstanding-requests routing** over the ready replicas, with
    per-replica attribution (``X-STC-Replica`` on every response,
    ``front.replica.<i>.*`` counters behind the Prometheus ``replica``
    label).
  * **Drain-aware**: a lease in ``draining`` state stops receiving new
    requests at once; its in-flight requests finish at the replica.
  * **Retry on another replica** for connection-level failures (refused,
    reset, torn response) and 503 draining answers: scoring is
    idempotent per document, so a killed replica costs a retry, not a
    failed client request.
  * **Generation pinning**: a client stream (the ``X-STC-Stream``
    header) never sees two model generations interleaved.  The pin is
    the largest ``model_stamp`` the stream has been answered with; the
    front routes the stream only to replicas whose lease stamp is
    ``>= pin``, and holds it on the pinned generation while any replica
    still serves it (a move forward counts ``front.repins``).
  * **Shedding at the edge**: past ``max_pending`` requests in flight
    (half that for batch-class ones) the front answers a typed 429
    quoting the last replica-priced Retry-After (fault site
    ``front.shed``).

Standard library only, and no torch: the front must survive whatever its
replicas do to the card.  With ``alerts_file`` (a ``monitor``'s
``alerts.jsonl``) ``/healthz`` says ``degraded`` while it holds firing
alerts, and lists them.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import re
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .. import telemetry
from ..resilience import faultinject
from ..resilience.retry import sleep as _sleep
from ..resilience.supervisor import LEASE_DIRNAME, read_lease

__all__ = [
    "model_stamp",
    "discover_latest_model_dir",
    "ReplicaView",
    "read_replicas",
    "FrontRouter",
    "NoReplicaAvailable",
    "FrontOverloaded",
    "make_front_server",
    "write_front_announce",
    "REPLICA_HEADER",
    "GENERATION_HEADER",
    "STREAM_HEADER",
    "PRIORITY_HEADER",
    "DEGRADED_HEADER",
]

# response attribution / affinity headers (the serve replica stamps
# GENERATION_HEADER itself; the front adds REPLICA_HEADER and reads
# STREAM_HEADER for pinning).  PRIORITY_HEADER carries the request's
# class (interactive | batch) front -> replica -> coalescer;
# DEGRADED_HEADER comes back from a replica that answered under
# degraded mode and is forwarded to the client verbatim.
REPLICA_HEADER = "X-STC-Replica"
GENERATION_HEADER = "X-STC-Generation"
STREAM_HEADER = "X-STC-Stream"
PRIORITY_HEADER = "X-STC-Priority"
DEGRADED_HEADER = "X-STC-Degraded"

# retry backoff jitter (decorrelates a thundering herd of front
# handler threads re-trying into the same just-recovered replica)
_jitter = random.Random()

_STAMP_RE = re.compile(r"_(\d+)$")


def model_stamp(path: Optional[str]) -> Optional[int]:
    """The publish-order stamp embedded in a model dir's basename
    (``LdaModel_EN_1723456789``): the total order rolling swaps and
    generation pinning ride.  None for unstamped paths."""
    if not path:
        return None
    m = _STAMP_RE.search(os.path.basename(os.path.normpath(path)))
    return int(m.group(1)) if m else None


def discover_latest_model_dir(
    models_dir: str, lang: str
) -> Optional[str]:
    """Newest COMMITted model dir for ``lang``, by embedded stamp: the
    half of ``models.persistence.latest_model_dir`` that needs no model
    classes (and so no torch).  The supervisor's publish watcher runs on
    this; replicas still load through ``resolve_latest_model``."""
    prefix = f"LdaModel_{lang}_"
    best: Tuple[int, Optional[str]] = (-1, None)
    try:
        names = os.listdir(models_dir)
    except OSError:
        return None
    for n in names:
        if not n.startswith(prefix):
            continue
        p = os.path.join(models_dir, n)
        stamp = model_stamp(p)
        if stamp is None or not os.path.isdir(p):
            continue
        if not os.path.exists(os.path.join(p, "COMMIT")):
            continue                    # uncommitted/partial save
        if stamp > best[0]:
            best = (stamp, p)
    return best[1]


# ---------------------------------------------------------------------------
# Replica table (lease-file driven)
# ---------------------------------------------------------------------------
@dataclass
class ReplicaView:
    """One serve replica as its latest lease describes it."""

    index: int
    pid: int
    spawn_id: int
    port: int
    state: str                          # starting | ready | draining
    model_path: Optional[str]
    stamp: Optional[int]
    lease_ts: float

    @property
    def ready(self) -> bool:
        return self.state == "ready" and self.port > 0


def read_replicas(fleet_dir: str) -> List[ReplicaView]:
    """The current replica set from the fleet's lease files.  Done,
    torn, and non-serve leases read as absent — the front degrades to a
    smaller rotation, never crashes on its own discovery."""
    lease_dir = os.path.join(fleet_dir, LEASE_DIRNAME)
    try:
        names = sorted(os.listdir(lease_dir))
    except OSError:
        return []
    out: List[ReplicaView] = []
    for n in names:
        if not n.endswith(".json"):
            continue
        lease = read_lease(os.path.join(lease_dir, n))
        if lease is None or lease.get("done"):
            continue
        if lease.get("role") != "serve":
            continue
        try:
            out.append(
                ReplicaView(
                    index=int(lease.get("worker", -1)),
                    pid=int(lease.get("pid", -1)),
                    spawn_id=int(lease.get("spawn_id", -1)),
                    port=int(lease.get("port", 0) or 0),
                    state=str(lease.get("state", "starting")),
                    model_path=lease.get("model_path"),
                    stamp=(
                        int(lease["model_stamp"])
                        if lease.get("model_stamp") is not None
                        else model_stamp(lease.get("model_path"))
                    ),
                    lease_ts=float(lease.get("ts", 0.0)),
                )
            )
        except (TypeError, ValueError):
            continue                    # malformed lease: skip, not crash
    return out


class NoReplicaAvailable(RuntimeError):
    """No ready replica could take the request within the wait budget."""


class FrontOverloaded(RuntimeError):
    """The front's own pending set is full (or an armed ``front.shed``
    fault forced the path): the request is shed at the edge with a
    typed 429 before it can pile onto an already-saturated fleet."""

    def __init__(self, message: str, *, retry_after: float = 1.0) -> None:
        super().__init__(message)
        self.retry_after = retry_after


class FrontRouter:
    """Route /score requests across the lease-discovered replica set.

    Thread-safe: HTTP handler threads call ``route()`` concurrently;
    ``_lock`` guards the replica table, the outstanding counts, the
    per-stream pins, and the connection pools.
    """

    def __init__(
        self,
        fleet_dir: str,
        *,
        host: str = "127.0.0.1",
        refresh_s: float = 0.2,
        lease_timeout: float = 10.0,
        suspect_s: float = 1.0,
        retry_wait_s: float = 0.05,
        wait_for_replica_s: float = 30.0,
        request_timeout: float = 120.0,
        alerts_file: Optional[str] = None,
        max_pending: int = 128,
        retry_budget: int = 3,
    ) -> None:
        self.fleet_dir = fleet_dir
        self.host = host
        self.alerts_file = alerts_file
        self.refresh_s = float(refresh_s)
        self.lease_timeout = float(lease_timeout)
        self.suspect_s = float(suspect_s)
        self.retry_wait_s = float(retry_wait_s)
        self.wait_for_replica_s = float(wait_for_replica_s)
        self.request_timeout = float(request_timeout)
        # front-side shedding: bound our own pending set so the front
        # can never hold more in-flight work than the fleet could ever
        # drain (batch-class requests shed at HALF the watermark —
        # batch sheds first, here too).  0 disables the bound.
        self.max_pending = int(max_pending)
        # per-request retry budget (connection failures / 503s); a
        # typed 429 NEVER spends a retry — it is propagated as-is
        self.retry_budget = int(retry_budget)
        self._lock = threading.Lock()
        self._replicas: Dict[int, ReplicaView] = {}
        self._last_scan = 0.0
        self._outstanding: Dict[int, int] = {}
        self._pins: Dict[str, int] = {}
        self._suspect: Dict[int, float] = {}
        self._pool: Dict[int, List[http.client.HTTPConnection]] = {}
        self._rr = 0
        self._inflight = 0
        # last Retry-After a replica priced (seconds): what a shed at
        # the FRONT quotes, since the front has no estimator of its own
        self._last_retry_after = 1.0

    # -- discovery -------------------------------------------------------
    def refresh(self, force: bool = False) -> None:
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_scan < self.refresh_s:
                return
            self._last_scan = now
        fresh = {r.index: r for r in read_replicas(self.fleet_dir)}
        with self._lock:
            for i, r in fresh.items():
                old = self._replicas.get(i)
                if old is not None and (
                    old.port != r.port or old.spawn_id != r.spawn_id
                ):
                    # a respawn reuses the index on a new port: drop
                    # the dead incarnation's pooled connections
                    self._drop_pool_locked(i)
                    self._suspect.pop(i, None)
                if (
                    old is not None
                    and old.stamp is not None
                    and r.stamp is not None
                    and r.stamp > old.stamp
                ):
                    # a rolling swap landed on this replica — the
                    # summarize section derives the fleet's swap lag
                    # (first vs last replica) from these observations
                    telemetry.event(
                        "front_swap_observed",
                        replica=i,
                        from_stamp=old.stamp,
                        to_stamp=r.stamp,
                        model=r.model_path,
                    )
                self._replicas[i] = r
            for i in list(self._replicas):
                if i not in fresh:
                    self._drop_pool_locked(i)
                    self._replicas.pop(i, None)

    def _drop_pool_locked(self, index: int) -> None:
        for c in self._pool.pop(index, []):
            try:
                c.close()
            except OSError:
                pass

    # -- selection -------------------------------------------------------
    def _eligible_locked(self, pin: Optional[int]) -> List[ReplicaView]:
        now = time.time()
        mono = time.monotonic()
        out = []
        for r in self._replicas.values():
            if not r.ready:
                continue                # starting or draining: excluded
            if now - r.lease_ts > self.lease_timeout:
                continue                # stale lease: likely dead
            if self._suspect.get(r.index, 0.0) > mono:
                continue                # recent connection failure
            if pin is not None and r.stamp is not None \
                    and r.stamp < pin:
                continue                # older generation than the pin
            out.append(r)
        return out

    def pick(self, stream: Optional[str] = None) -> ReplicaView:
        """Least-outstanding ready replica honoring the stream's pin;
        raises ``NoReplicaAvailable`` when the rotation is empty."""
        self.refresh()
        with self._lock:
            pin = self._pins.get(stream) if stream else None
            elig = self._eligible_locked(pin)
            if not elig and pin is not None:
                # every surviving replica is AHEAD of the pin is handled
                # by the >= filter; none at all means the rotation is
                # empty for this stream right now
                raise NoReplicaAvailable(
                    f"no ready replica at or beyond generation {pin}"
                )
            if not elig:
                raise NoReplicaAvailable("no ready replica")
            if pin is not None:
                same = [r for r in elig if r.stamp == pin
                        or r.stamp is None]
                if same:
                    elig = same         # hold the old generation while
                else:                   # it still exists anywhere
                    telemetry.count("front.repins")
            self._rr += 1
            chosen = min(
                elig,
                key=lambda r: (
                    self._outstanding.get(r.index, 0),
                    (r.index + self._rr) % max(1, len(elig)),
                ),
            )
            self._outstanding[chosen.index] = (
                self._outstanding.get(chosen.index, 0) + 1
            )
            return chosen

    def _release(self, index: int) -> None:
        with self._lock:
            n = self._outstanding.get(index, 1) - 1
            self._outstanding[index] = max(0, n)

    def outstanding(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._outstanding)

    # -- transport -------------------------------------------------------
    def _connection(self, r: ReplicaView) -> http.client.HTTPConnection:
        with self._lock:
            pool = self._pool.get(r.index)
            if pool:
                return pool.pop()
        return http.client.HTTPConnection(
            self.host, r.port, timeout=self.request_timeout
        )

    def _pool_put(
        self, r: ReplicaView, conn: http.client.HTTPConnection
    ) -> None:
        with self._lock:
            cur = self._replicas.get(r.index)
            if cur is None or cur.port != r.port:
                conn.close()
                return
            self._pool.setdefault(r.index, []).append(conn)

    def _mark_suspect(self, index: int) -> None:
        with self._lock:
            self._suspect[index] = time.monotonic() + self.suspect_s
            self._drop_pool_locked(index)

    def _forward_once(
        self, r: ReplicaView, body: bytes, headers: Dict[str, str]
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """One attempt against one replica; connection-level failures
        raise OSError for the retry loop above."""
        conn = self._connection(r)
        try:
            conn.request("POST", "/score", body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
        except (http.client.HTTPException, OSError):
            try:
                conn.close()
            except OSError:
                pass
            raise
        out_headers = {
            k: v for k, v in resp.getheaders()
            if k.lower() in ("x-stc-trace", "x-stc-generation",
                             "x-stc-degraded", "retry-after",
                             "content-type")
        }
        self._pool_put(r, conn)
        return resp.status, payload, out_headers

    def _account(
        self,
        outcome: str,
        t0: float,
        *,
        status: Optional[int] = None,
        replica: Optional[int] = None,
    ) -> None:
        """Typed per-request accounting, on EVERY ``route()`` exit path
        — the availability SLO's denominator.  A request that exhausted
        the retry budget or found no replica still happened and still
        took this long; recording only successes (the pre-SLO behavior)
        made ``front.request_seconds`` a survivorship-biased lie."""
        dt = time.perf_counter() - t0
        telemetry.count(f"front.request_outcomes.{outcome}")
        telemetry.observe("front.request_seconds", dt)
        telemetry.event(
            "front_request",
            outcome=outcome,
            seconds=round(dt, 6),
            status=status,
            replica=replica,
        )

    def _note_retry_after(self, out_headers: Dict[str, str]) -> float:
        """Remember the replica-priced Retry-After (what a front-side
        shed will quote next) and return it."""
        try:
            ra = float(out_headers.get("Retry-After", ""))
        except ValueError:
            ra = 1.0
        with self._lock:
            self._last_retry_after = max(1.0, ra)
        return max(1.0, ra)

    def _backoff(self, retries: int) -> None:
        """Jittered exponential backoff between retries: decorrelates
        handler threads re-trying into the same recovering replica
        instead of re-forming the thundering herd that killed it."""
        base = self.retry_wait_s * (2 ** max(0, retries - 1))
        _sleep(min(1.0, base) * (0.5 + _jitter.random()))

    def route(
        self,
        body: bytes,
        *,
        stream: Optional[str] = None,
        trace_header: Optional[str] = None,
        priority: Optional[str] = None,
    ) -> Tuple[int, bytes, Dict[str, str], int]:
        """Route one /score body; returns ``(status, body, headers,
        replica_index)``.  Retries connection-level failures and
        503-draining answers on other replicas — at most
        ``retry_budget`` retries per request, jittered backoff between
        them, still fenced by the wait deadline.  A replica's typed 429
        is propagated immediately with its Retry-After intact: a
        saturated fleet must not be retry-stormed.  Raises
        ``FrontOverloaded`` when the front's own pending set is full."""
        t0 = time.perf_counter()
        with self._lock:
            self._inflight += 1
            inflight = self._inflight
        try:
            return self._route_admitted(
                body, stream=stream, trace_header=trace_header,
                priority=priority, t0=t0, inflight=inflight,
            )
        finally:
            with self._lock:
                self._inflight -= 1

    def _shed_check(
        self, inflight: int, priority: Optional[str], t0: float
    ) -> None:
        forced = False
        try:
            faultinject.check("front.shed")
        except OSError:
            forced = True               # armed chaos: force the path
        limit = self.max_pending
        if limit and priority == "batch":
            limit = max(1, limit // 2)  # batch sheds first
        if forced or (limit and inflight > limit):
            with self._lock:
                ra = self._last_retry_after
            telemetry.count("front.shed_total")
            self._account("shed", t0)
            raise FrontOverloaded(
                f"front pending set full ({inflight} in flight, "
                f"limit {limit})",
                retry_after=ra,
            )

    def _route_admitted(
        self,
        body: bytes,
        *,
        stream: Optional[str],
        trace_header: Optional[str],
        priority: Optional[str],
        t0: float,
        inflight: int,
    ) -> Tuple[int, bytes, Dict[str, str], int]:
        self._shed_check(inflight, priority, t0)
        deadline = time.monotonic() + self.wait_for_replica_s
        headers = {"Content-Type": "application/json"}
        if trace_header:
            headers["X-STC-Trace"] = trace_header
        if priority:
            headers[PRIORITY_HEADER] = priority
        retries = 0
        while True:
            try:
                r = self.pick(stream)
            except NoReplicaAvailable:
                if time.monotonic() >= deadline:
                    telemetry.count("front.no_replica")
                    self._account("no_replica", t0)
                    raise
                self.refresh(force=True)
                _sleep(self.retry_wait_s)
                continue
            try:
                status, payload, out_headers = self._forward_once(
                    r, body, headers
                )
            except (http.client.HTTPException, OSError):
                self._release(r.index)
                self._mark_suspect(r.index)
                retries += 1
                telemetry.count("front.retries")
                telemetry.count(f"front.replica.{r.index}.retries")
                if retries > self.retry_budget:
                    telemetry.count("front.retry_budget_exhausted")
                    self._account(
                        "retry_budget_exhausted", t0, replica=r.index
                    )
                    raise NoReplicaAvailable(
                        f"replica {r.index} failed and the "
                        f"{self.retry_budget}-retry budget is spent"
                    )
                if time.monotonic() >= deadline:
                    telemetry.count("front.no_replica")
                    self._account(
                        "retry_exhausted", t0, replica=r.index
                    )
                    raise NoReplicaAvailable(
                        f"replica {r.index} failed and the retry "
                        f"deadline ran out"
                    )
                self._backoff(retries)
                continue
            self._release(r.index)
            if status == 429:
                # the replica refused TYPED: propagate the refusal and
                # its Retry-After schedule verbatim — spending retries
                # here would storm the rest of the saturated fleet
                self._note_retry_after(out_headers)
                telemetry.count("front.rejected_total")
                telemetry.count(f"front.replica.{r.index}.rejected")
                self._account(
                    "rejected", t0, status=status, replica=r.index,
                )
                return status, payload, out_headers, r.index
            if status == 503:
                # the replica is draining (or refused): take it out of
                # rotation until its lease says otherwise and retry
                self._mark_suspect(r.index)
                retries += 1
                telemetry.count("front.retries")
                telemetry.count(f"front.replica.{r.index}.retries")
                if retries > self.retry_budget or \
                        time.monotonic() >= deadline:
                    self._account(
                        "error_status", t0,
                        status=status, replica=r.index,
                    )
                    return status, payload, out_headers, r.index
                self._backoff(retries)
                continue
            served = out_headers.get(GENERATION_HEADER)
            if stream and served is not None:
                try:
                    s = int(served)
                except ValueError:
                    s = None
                if s is not None:
                    with self._lock:
                        if s > self._pins.get(stream, -1):
                            self._pins[stream] = s
            dt = time.perf_counter() - t0
            telemetry.count("front.requests")
            telemetry.count(f"front.replica.{r.index}.requests")
            telemetry.observe(
                f"front.replica.{r.index}.request_seconds", dt
            )
            self._account(
                "ok" if status == 200 else "error_status", t0,
                status=status, replica=r.index,
            )
            return status, payload, out_headers, r.index

    # -- health ----------------------------------------------------------
    def health(self) -> dict:
        self.refresh()
        reg = telemetry.get_registry()
        # per-replica utilisation from the queueing estimator (fed by
        # the monitor's event stream): lets /healthz answer "which
        # replica is saturating" without a metrics scrape
        rho = reg.snapshot().get("gauges", {})
        with self._lock:
            replicas = [
                {
                    "index": r.index,
                    "pid": r.pid,
                    "port": r.port,
                    "state": r.state,
                    "model": r.model_path,
                    "stamp": r.stamp,
                    "outstanding": self._outstanding.get(r.index, 0),
                    "lease_age_s": round(
                        max(0.0, time.time() - r.lease_ts), 3
                    ),
                    "rho": rho.get(f"queueing.replica.{r.index}.rho"),
                }
                for _, r in sorted(self._replicas.items())
            ]
            pins = len(self._pins)
            inflight = self._inflight
        ready = [r for r in replicas if r["state"] == "ready"]
        firing: List[Dict] = []
        if self.alerts_file:
            # the replicas' contract: firing alerts (a burning error
            # budget, a replica down) say degraded while the fleet still
            # answers
            from ..telemetry.alerts import firing_alerts

            firing = firing_alerts(self.alerts_file)
        out = {
            "status": "ok" if ready and not firing else "degraded",
            "fleet_dir": self.fleet_dir,
            "replicas": replicas,
            "ready": len(ready),
            "requests": reg.counter("front.requests").value,
            "retries": reg.counter("front.retries").value,
            "pinned_streams": pins,
            "inflight": inflight,
            "max_pending": self.max_pending,
            "shed": reg.counter("front.shed_total").value,
            "rejected": reg.counter("front.rejected_total").value,
        }
        if self.alerts_file:
            out["alerts"] = {"source": self.alerts_file, "firing": firing}
        return out


# ---------------------------------------------------------------------------
# Front HTTP server (stdlib only, mirrors serving/server.py's handler)
# ---------------------------------------------------------------------------
class _FrontHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(
        self, code: int, body: bytes, ctype: str,
        extra: Optional[Dict[str, str]] = None,
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            if k.lower() != "content-type":
                self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, doc: dict) -> None:
        self._send(
            code, json.dumps(doc).encode("utf-8"), "application/json"
        )

    def do_GET(self):  # noqa: N802 (http.server API)
        from ..telemetry import prometheus

        router: FrontRouter = self.server.router
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._send_json(200, router.health())
        elif path == "/metrics":
            accept = self.headers.get("Accept", "")
            params = urllib.parse.parse_qs(query)
            want_buckets = params.get("buckets", ["0"])[-1] in (
                "1", "true", "yes"
            )
            if "prometheus" in params.get("format", []) or (
                not params.get("format")
                and prometheus.wants_prometheus(accept)
            ):
                self._send(
                    200,
                    prometheus.render(
                        telemetry.get_registry().snapshot(
                            include_buckets=want_buckets
                        ),
                        buckets=want_buckets,
                    ).encode("utf-8"),
                    prometheus.CONTENT_TYPE,
                )
            else:
                self._send_json(
                    200,
                    telemetry.get_registry().snapshot(
                        include_buckets=want_buckets
                    ),
                )
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        router: FrontRouter = self.server.router
        if self.path != "/score":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        stream = self.headers.get(STREAM_HEADER)
        priority = self.headers.get(PRIORITY_HEADER)
        if priority:
            priority = priority.strip().lower()
        try:
            status, payload, headers, replica = router.route(
                body,
                stream=stream,
                trace_header=self.headers.get("X-STC-Trace"),
                priority=priority,
            )
        except FrontOverloaded as exc:
            ra = max(1, int(exc.retry_after))
            self._send(
                429,
                json.dumps({
                    "error": str(exc),
                    "status": "shed",
                    "retry_after": ra,
                }).encode("utf-8"),
                "application/json",
                extra={"Retry-After": str(ra)},
            )
            return
        except NoReplicaAvailable as exc:
            self._send_json(
                503, {"error": str(exc), "status": "no_replica"}
            )
            return
        headers[REPLICA_HEADER] = str(replica)
        self._send(
            status, payload,
            headers.get("Content-Type", "application/json"),
            extra=headers,
        )


def make_front_server(
    router: FrontRouter, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    """Bind the front; ``port=0`` picks a free one.  The caller owns
    ``serve_forever`` (usually on a thread) and ``shutdown``."""
    # the stdlib listen backlog (5) overflows under a burst long before
    # the shedding tier can answer with a typed 429 — clients would see
    # raw connection resets, the exact untyped failure admission
    # control exists to prevent; overload must land on /score, not on
    # the SYN queue
    _FrontServer = type(
        "_FrontServer", (ThreadingHTTPServer,),
        {"request_queue_size": 128},
    )
    httpd = _FrontServer((host, port), _FrontHandler)
    httpd.router = router
    httpd.daemon_threads = True
    return httpd


def write_front_announce(
    fleet_dir: str, host: str, port: int
) -> str:
    """Publish the front's bound address into the fleet dir
    (``front.json``, atomic) so drills and clients discover it the
    same way the front discovers replicas."""
    from ..resilience.integrity import atomic_write_text

    path = os.path.join(fleet_dir, "front.json")
    os.makedirs(fleet_dir, exist_ok=True)
    atomic_write_text(
        path,
        json.dumps(
            {"host": host, "port": int(port), "pid": os.getpid(),
             "ts": time.time()},
            sort_keys=True,
        ) + "\n",
    )
    return path
