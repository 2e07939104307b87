"""Telemetry transport, the worker side: push-based event shipping.

Every ``metrics`` tool reads JSONL run streams on a *local* filesystem.
A multi-host fleet has no shared dir, so a run can also push its stream
to a collector daemon (the JAX package's ``stc collect``), which folds
each source into a manifested stream of the same schema.

:class:`EventShipper` hooks :class:`~.events.JsonlSink` (every record the
run stream writer appends locally is also offered to the shipper),
batches records, gzips them, and POSTs each batch to the collector's
``/ingest`` with a monotonically increasing sequence number.  Pushes
ride ``resilience.retry_call`` (fault site ``telemetry.ship``).  The
in-memory buffer is bounded: overflow drops are *counted*
(``telemetry.dropped``), never silent.  When the collector is
unreachable the batch is appended to a durable local spool (fsync'd,
checksummed lines — epoch-ledger discipline) and replayed in order on
reconnect, so a collector outage loses nothing.

A run ships when ``STC_SHIP_TO`` names the collector's ``host:port``.
The collector itself, and the ``--ship-to`` flag, come with the fleet's
telemetry (ROADMAP item 9c).

The module is import-light (stdlib only; resilience is imported
lazily).
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import re
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from .registry import MetricRegistry

ENV_SHIP_TO = "STC_SHIP_TO"

#: spool file kept next to the run stream (one checksummed line per
#: un-acked batch; replayed in seq order on reconnect)
SPOOL_NAME = "ship-spool.jsonl"

#: wire schema for the batch envelope
WIRE_SCHEMA = 1

# counters/gauges (declared in names.py; STC004 reverse check reads
# these literals)
SHIPPED = "telemetry.shipped"
SPOOLED = "telemetry.spooled"
DROPPED = "telemetry.dropped"
SHIP_ERRORS = "telemetry.ship_errors"
SHIP_REPLAYED = "telemetry.ship_replayed"

_SOURCE_ID_SAFE = re.compile(r"[^A-Za-z0-9._-]")


def sanitize_source_id(source_id: str) -> str:
    """Collapse a wire ``source_id`` to a filesystem-safe stem (it
    names the per-source stream file, so path metacharacters must
    never survive)."""
    out = _SOURCE_ID_SAFE.sub("_", str(source_id))[:120]
    return out or "unknown"


def default_source_id(stream_path: Optional[str]) -> str:
    """``<host>-<pid>-<stream stem>``: unique per writer incarnation
    (a respawned worker gets a new pid → a new collector-side stream,
    mirroring the local ``worker-wNNN-sK.jsonl`` per-spawn naming)."""
    host = socket.gethostname().split(".")[0] or "host"
    stem = "run"
    if stream_path:
        stem = os.path.splitext(os.path.basename(stream_path))[0]
    return sanitize_source_id(f"{host}-{os.getpid()}-{stem}")


def parse_ship_url(url: str) -> Tuple[str, int]:
    """``http://host:port`` or bare ``host:port`` → ``(host, port)``."""
    u = url.strip()
    if u.startswith("http://"):
        u = u[len("http://"):]
    elif u.startswith("https://"):
        raise ValueError("telemetry transport is plain HTTP (got https)")
    u = u.rstrip("/")
    host, sep, port = u.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"--ship-to expects host:port, got {url!r}")
    return host or "127.0.0.1", int(port)


def _batch_checksum(body: Dict) -> str:
    return hashlib.sha256(
        json.dumps(
            {k: v for k, v in body.items() if k != "crc"},
            sort_keys=True, separators=(",", ":"),
        ).encode("utf-8")
    ).hexdigest()[:16]


# ---------------------------------------------------------------------------
# durable spool (worker side)
# ---------------------------------------------------------------------------

class ShipSpool:
    """Durable on-disk queue of un-acked batches.

    Append-only ``ship-spool.jsonl``: one checksummed line per batch
    (``{"seq", "sent_ts", "events", "crc"}``).  Appends are fsync'd
    before the batch counts as spooled — a crash after the ship failure
    but before the fsync re-raises, and the drop is counted, never
    silent.  Replay reads tolerate a torn tail exactly like the epoch
    ledger (a crash mid-append corrupts only the final line).  After a
    successful replay the file is compacted by the atomic
    stage-then-``os.replace`` dance so a crash mid-compact leaves
    either the old spool (harmless duplicates, deduped by seq) or the
    new one.
    """

    def __init__(self, spool_dir: str) -> None:
        self.spool_dir = spool_dir
        self.path = os.path.join(spool_dir, SPOOL_NAME)

    def append(self, batch: Dict) -> None:
        rec = {
            "seq": int(batch["seq"]),
            "sent_ts": batch.get("sent_ts"),
            "events": list(batch["events"]),
        }
        rec["crc"] = _batch_checksum(rec)
        os.makedirs(self.spool_dir, exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def load(self) -> List[Dict]:
        """All intact spooled batches, seq order preserved.  A torn or
        checksum-failing FINAL line is ignored (crash window of the
        append itself); corruption before the tail raises — that is
        data loss, not a torn tail."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = [ln for ln in f.read().split("\n") if ln.strip()]
        except OSError:
            return []
        out: List[Dict] = []
        for i, ln in enumerate(lines):
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break                       # torn tail: ignore
                raise
            if _batch_checksum(rec) != rec.get("crc"):
                if i == len(lines) - 1:
                    break
                raise ValueError(
                    f"{self.path}: spool record {i + 1} checksum "
                    f"mismatch (not the final line)"
                )
            out.append(rec)
        return out

    def compact(self, remaining: List[Dict]) -> None:
        """Atomically rewrite the spool to hold only ``remaining``."""
        if not remaining and not os.path.exists(self.path):
            return
        os.makedirs(self.spool_dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in remaining:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def pending(self) -> int:
        return sum(len(r.get("events", [])) for r in self.load())


# ---------------------------------------------------------------------------
# worker-side shipper
# ---------------------------------------------------------------------------

class EventShipper:
    """Ships run-stream records to a collector in sequence-numbered,
    gzip'd HTTP batches.

    ``offer()`` is the hot path (called from ``JsonlSink.write`` for
    every record): it serialises the record and appends to a bounded
    in-memory buffer under a lock — no I/O, no blocking.  A background
    thread drains the buffer every ``flush_interval`` seconds; the HTTP
    round-trip never happens under any lock (protocol audit STC300
    forbids blocking under a held lock, and ``flush`` only ever runs on
    the shipper thread — ``close()`` joins the thread before the final
    caller-side flush, so the two never race).
    """

    def __init__(
        self,
        host: str,
        port: int,
        *,
        source_id: Optional[str] = None,
        registry: Optional[MetricRegistry] = None,
        spool_dir: Optional[str] = None,
        max_buffer: int = 4096,
        batch_events: int = 256,
        flush_interval: float = 0.25,
        timeout: float = 2.0,
        policy=None,
    ) -> None:
        self.host = host
        self.port = port
        self.source_id = source_id or default_source_id(None)
        self.registry = registry or MetricRegistry()
        self.spool = ShipSpool(spool_dir) if spool_dir else None
        self.max_buffer = int(max_buffer)
        self.batch_events = int(batch_events)
        self.flush_interval = float(flush_interval)
        self.timeout = float(timeout)
        self.policy = policy
        self._buf: List[str] = []           # pre-serialised JSON lines
        self._lock = threading.Lock()       # guards _buf only
        self._next_seq = 1
        self._down = False                  # collector unreachable
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def from_url(cls, url: str, **kw) -> "EventShipper":
        host, port = parse_ship_url(url)
        return cls(host, port, **kw)

    # -- hot path -----------------------------------------------------

    def offer(self, rec: Dict) -> None:
        """Queue one record for shipping.  Never raises, never blocks
        on I/O; a full buffer drops the record and counts the drop."""
        try:
            line = json.dumps(rec)
        except (TypeError, ValueError):
            self.registry.counter(DROPPED).inc()
            return
        with self._lock:
            if len(self._buf) >= self.max_buffer:
                full = True
            else:
                self._buf.append(line)
                full = False
        if full:
            self.registry.counter(DROPPED).inc()

    # -- background loop ----------------------------------------------

    def start(self) -> "EventShipper":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="stc-ship", daemon=True
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.flush_interval):
            try:
                self.flush()
            except Exception:  # stc-lint: disable=STC002 -- last-resort thread guard: ANY flush failure must leave the shipper thread alive (the loss is counted in telemetry.ship_errors, and per-batch failures are already handled typed inside flush)
                self.registry.counter(SHIP_ERRORS).inc()
        # drain once more on the way out so close() sees an empty buf
        try:
            self.flush()
        except Exception:  # stc-lint: disable=STC002 -- last-resort thread guard: the exit drain is best-effort; the loss is counted, never raised into interpreter shutdown
            self.registry.counter(SHIP_ERRORS).inc()

    def close(self) -> None:
        """Stop the flush thread, attempt one final flush, and spool
        whatever the collector did not acknowledge."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None
        try:
            self.flush()
        except Exception:  # stc-lint: disable=STC002 -- last-resort guard on the final close() flush: telemetry transport must never fail the process it observes; the loss is counted in telemetry.ship_errors
            self.registry.counter(SHIP_ERRORS).inc()

    # -- shipping -----------------------------------------------------

    def _take(self) -> List[str]:
        with self._lock:
            if not self._buf:
                return []
            n = min(len(self._buf), self.batch_events)
            lines, self._buf = self._buf[:n], self._buf[n:]
            return lines

    def flush(self) -> None:
        """Replay the spool first (order preserved), then drain the
        in-memory buffer.  Runs only on the shipper thread, or on the
        caller thread after ``close()`` joined it."""
        self._replay_spool()
        while True:
            lines = self._take()
            if not lines:
                return
            batch = {
                "seq": self._next_seq,
                "sent_ts": time.time(),
                "events": [json.loads(ln) for ln in lines],
            }
            self._next_seq += 1
            if self._down and self.spool is not None:
                # collector known down: spool directly instead of
                # paying the connect timeout once per batch
                self._spool_or_drop(batch)
            else:
                self._send_or_spool(batch)

    def _replay_spool(self) -> None:
        if self.spool is None:
            return
        try:
            batches = self.spool.load()
        except (OSError, ValueError):
            return
        if not batches:
            if self._down:
                # cheap liveness probe so a drained spool does not pin
                # _down forever
                self._down = not self._probe()
            return
        from http.client import HTTPException

        from ..resilience.retry import RetryGiveUp

        sent = 0
        for i, rec in enumerate(batches):
            try:
                self._ship(rec, replayed=True)
            except (OSError, RetryGiveUp, HTTPException):
                self.registry.counter(SHIP_ERRORS).inc()
                self._down = True
                if sent:
                    self.spool.compact(batches[i:])
                return
            self._down = False
            sent += 1
            self.registry.counter(SHIP_REPLAYED).inc(
                len(rec.get("events", []))
            )
        self.spool.compact([])

    def _send_or_spool(self, batch: Dict) -> bool:
        from http.client import HTTPException

        from ..resilience.retry import RetryGiveUp

        try:
            self._ship(batch, replayed=False)
        except (OSError, RetryGiveUp, HTTPException):
            self.registry.counter(SHIP_ERRORS).inc()
            self._down = True
            self._spool_or_drop(batch)
            return False
        self._down = False
        self.registry.counter(SHIPPED).inc(len(batch["events"]))
        return True

    def _spool_or_drop(self, batch: Dict) -> None:
        if self.spool is not None:
            try:
                self.spool.append(batch)
                self.registry.counter(SPOOLED).inc(len(batch["events"]))
                return
            except OSError:
                pass
        self.registry.counter(DROPPED).inc(len(batch["events"]))

    def _probe(self) -> bool:
        try:
            import http.client

            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            try:
                conn.request("GET", "/healthz")
                return conn.getresponse().status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def _ship(self, batch: Dict, *, replayed: bool) -> Dict:
        from ..resilience import faultinject
        from ..resilience.retry import RetryPolicy, retry_call

        body = json.dumps({
            "schema": WIRE_SCHEMA,
            "source_id": self.source_id,
            "seq": int(batch["seq"]),
            "sent_ts": batch.get("sent_ts"),
            "replayed": bool(replayed),
            "events": batch["events"],
        }).encode("utf-8")
        gz = gzip.compress(body)
        policy = self.policy
        if policy is None:
            # short fuse: a dead collector must not stall the shipper
            # thread (emit_events=False — retry events would recurse
            # into the very sink that feeds this shipper)
            policy = RetryPolicy(
                attempts=3, base_delay=0.05, max_delay=0.5,
                retry_on=(OSError,), emit_events=False,
            )

        def _post() -> Dict:
            import http.client

            faultinject.check("telemetry.ship")
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            try:
                conn.request(
                    "POST", "/ingest", body=gz,
                    headers={
                        "Content-Type": "application/json",
                        "Content-Encoding": "gzip",
                    },
                )
                resp = conn.getresponse()
                payload = resp.read()
                if resp.status != 200:
                    raise OSError(
                        f"collector {self.host}:{self.port} returned "
                        f"{resp.status}"
                    )
            finally:
                conn.close()
            try:
                return json.loads(payload.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return {}

        return retry_call(_post, site="telemetry.ship", policy=policy)


# ---------------------------------------------------------------------------
# module-global shipper (facade hook)
# ---------------------------------------------------------------------------

_shipper: Optional[EventShipper] = None


def offer(rec: Dict) -> None:
    """Hot-path hook called by ``JsonlSink.write`` for every record.
    With shipping unconfigured this is one global read + None check —
    the disabled-mode cost budgeted by check_telemetry_overhead.py."""
    s = _shipper
    if s is not None:
        s.offer(rec)


def get_shipper() -> Optional[EventShipper]:
    return _shipper


def configure_shipping(
    url: str,
    *,
    stream_path: Optional[str] = None,
    registry: Optional[MetricRegistry] = None,
) -> EventShipper:
    """Install the process-wide shipper (closing any previous one).

    The spool lives next to the run stream so a worker's un-shipped tail
    survives with the same durability as the stream itself."""
    global _shipper
    close_shipping()
    spool_dir = None
    if stream_path:
        spool_dir = os.path.join(
            os.path.dirname(os.path.abspath(stream_path)) or ".",
            "ship-spool",
        )
    s = EventShipper.from_url(
        url,
        source_id=default_source_id(stream_path),
        registry=registry,
        spool_dir=spool_dir,
    )
    _shipper = s.start()
    return s


def close_shipping() -> None:
    global _shipper
    s = _shipper
    _shipper = None
    if s is not None:
        s.close()
