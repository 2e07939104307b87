"""Telemetry transport plane: push-based event shipping and the collector.

Every ``metrics`` tool reads JSONL run streams on a *local* filesystem.
A multi-host fleet has no shared dir, so a run can also push its stream
to a collector daemon (``cli collect``, or the JAX package's ``stc
collect``: the two are interchangeable), which folds each source into a
manifested stream of the same schema.

Worker side: :class:`EventShipper` hooks :class:`~.events.JsonlSink` (every record the
run stream writer appends locally is also offered to the shipper),
batches records, gzips them, and POSTs each batch to the collector's
``/ingest`` with a monotonically increasing sequence number.  Pushes
ride ``resilience.retry_call`` (fault site ``telemetry.ship``).  The
in-memory buffer is bounded: overflow drops are *counted*
(``telemetry.dropped``), never silent.  When the collector is
unreachable the batch is appended to a durable local spool (fsync'd,
checksummed lines — epoch-ledger discipline) and replayed in order on
reconnect, so a collector outage loses nothing.

A run ships when ``STC_SHIP_TO`` names the collector's ``host:port``
(``supervise --ship-to`` sets it for a whole fleet).

Collector side: :class:`Collector` and ``cli collect``, a torch-free HTTP
daemon.  ``POST /ingest`` dedupes on ``(source_id, seq)`` and folds each
accepted batch into a per-source manifested JSONL stream in the same
schema, so the analysis tools work unchanged over the aggregated dir.
The commit point of a batch is its trailing ``collect_batch`` marker
line (fsync'd before the ack): a crash mid-append leaves un-markered
event lines that recovery truncates, and the worker, which never saw the
ack, re-ships the batch.  At-least-once shipping, seq dedupe and
marker-last appends give exactly-once folding.  The marker carries the
shipper's send stamp (``sent_ts``, the source host's clock) and the
ingest stamp (``recv_ts``, the collector's), the clock anchors of the
HTTP hop.

The module is import-light (stdlib only; resilience and prometheus are
imported lazily), so ``cli collect`` starts fast on a host without
torch.
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
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from .registry import MetricRegistry

ENV_SHIP_TO = "STC_SHIP_TO"

#: spool file kept next to the run stream (one checksummed line per
#: un-acked batch; replayed in seq order on reconnect)
SPOOL_NAME = "ship-spool.jsonl"

#: announce file the collector writes into its aggregation dir
COLLECT_ANNOUNCE_NAME = "collect.json"

#: wire schema for the batch envelope
WIRE_SCHEMA = 1

# counters/gauges (declared in names.py; STC004 reverse check reads
# these literals)
SHIPPED = "telemetry.shipped"
SPOOLED = "telemetry.spooled"
DROPPED = "telemetry.dropped"
SHIP_ERRORS = "telemetry.ship_errors"
SHIP_REPLAYED = "telemetry.ship_replayed"
COLLECT_BATCHES = "collect.batches"
COLLECT_INGESTED = "collect.ingested"
COLLECT_DUPLICATES = "collect.duplicates"
COLLECT_DUPLICATE_EVENTS = "collect.duplicate_events"
COLLECT_INGEST_ERRORS = "collect.ingest_errors"
COLLECT_RECOVERED = "collect.recovered_streams"
COLLECT_TRUNCATED = "collect.truncated_events"
COLLECT_SOURCES = "collect.sources"

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
    source_id: Optional[str] = None,
    registry: Optional[MetricRegistry] = None,
    spool_dir: Optional[str] = None,
    **kw,
) -> EventShipper:
    """Install the process-wide shipper (closing any previous one).

    The spool defaults to living next to the run stream so a worker's
    un-shipped tail survives with the same durability as the stream
    itself."""
    global _shipper
    close_shipping()
    if spool_dir is None and stream_path:
        spool_dir = os.path.join(
            os.path.dirname(os.path.abspath(stream_path)) or ".",
            "ship-spool",
        )
    s = EventShipper.from_url(
        url,
        source_id=source_id or default_source_id(stream_path),
        registry=registry,
        spool_dir=spool_dir,
        **kw,
    )
    _shipper = s.start()
    return s


def close_shipping() -> None:
    global _shipper
    s = _shipper
    _shipper = None
    if s is not None:
        s.close()


# ---------------------------------------------------------------------------
# collector (aggregation side)
# ---------------------------------------------------------------------------

def source_stream_path(collect_dir: str, source_id: str) -> str:
    """Per-source aggregated stream: ``<dir>/<source_id>.jsonl``."""
    return os.path.join(
        collect_dir, sanitize_source_id(source_id) + ".jsonl"
    )


class Collector:
    """Folds shipped batches into per-source manifested JSONL streams.

    Exactly-once discipline: an accepted batch's event lines are
    appended followed by ONE ``collect_batch`` marker line, then
    fsync'd, and only then acked.  The marker is the commit point —
    ``recover()`` rebuilds the seen-seq set from markers and truncates
    any un-markered tail (a crash between append and ack), and the
    shipper, which never saw the ack, re-ships that batch; the seq
    dedup then folds it exactly once.
    """

    def __init__(
        self,
        collect_dir: str,
        *,
        registry: Optional[MetricRegistry] = None,
    ) -> None:
        self.collect_dir = collect_dir
        self.registry = registry or MetricRegistry()
        self._lock = threading.Lock()   # guards _seen + stream appends
        self._seen: Dict[str, set] = {}
        os.makedirs(collect_dir, exist_ok=True)
        self.recover()

    # -- crash recovery ----------------------------------------------

    def recover(self) -> None:
        with self._lock:
            self._seen = {}
            for name in sorted(os.listdir(self.collect_dir)):
                if not name.endswith(".jsonl"):
                    continue
                self._recover_stream(
                    os.path.join(self.collect_dir, name)
                )
            self.registry.gauge(COLLECT_SOURCES).set(len(self._seen))

    def _recover_stream(self, path: str) -> None:
        try:
            with open(path, "r", encoding="utf-8") as f:
                data = f.read()
        except OSError:
            return
        seen: set = set()
        pending = 0                 # lines since last marker (torn ones
        source_id = os.path.splitext(os.path.basename(path))[0]
        for ln in data.split("\n"):     # included: they are uncommitted)
            if not ln.strip():
                continue
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                pending += 1        # torn tail line: uncommitted
                continue
            if isinstance(rec, dict) and (
                rec.get("event") == "collect_batch"
            ):
                seen.add(int(rec.get("seq", -1)))
                source_id = rec.get("source_id", source_id)
                pending = 0
            else:
                pending += 1
        if pending:
            # un-markered tail = batch that never got its ack: truncate
            # by atomic rewrite; the shipper re-sends it
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(_truncate_to_committed(data))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self.registry.counter(COLLECT_TRUNCATED).inc(pending)
            self.registry.counter(COLLECT_RECOVERED).inc()
        self._seen[source_id] = seen

    # -- ingest -------------------------------------------------------

    def ingest(
        self,
        raw: bytes,
        *,
        gzipped: bool = False,
        recv_ts: Optional[float] = None,
    ) -> Dict:
        """Fold one wire batch; returns the ack dict.  Raises
        ``ValueError`` on malformed input (the HTTP layer maps that to
        a 400, which the shipper treats as a ship error)."""
        from ..resilience import faultinject

        faultinject.check("collect.ingest")
        recv_ts = time.time() if recv_ts is None else recv_ts
        batch = _decode_envelope(raw, gzipped)
        source_id = sanitize_source_id(batch["source_id"])
        seq = int(batch["seq"])
        events = batch["events"]
        if not isinstance(events, list):
            raise ValueError("events must be a list")
        sent_ts = batch.get("sent_ts")
        replayed = bool(batch.get("replayed", False))
        with self._lock:
            seen = self._seen.setdefault(source_id, set())
            if seq in seen:
                self.registry.counter(COLLECT_DUPLICATES).inc()
                self.registry.counter(COLLECT_DUPLICATE_EVENTS).inc(
                    len(events)
                )
                return {
                    "status": "duplicate", "seq": seq,
                    "recv_ts": recv_ts,
                }
            path = source_stream_path(self.collect_dir, source_id)
            first = not os.path.exists(path)
            marker = {
                "ts": recv_ts,
                "event": "collect_batch",
                "source_id": source_id,
                "seq": seq,
                "sent_ts": sent_ts,
                "recv_ts": recv_ts,
                "events": len(events),
                "replayed": replayed,
            }
            with open(path, "a", encoding="utf-8") as f:
                for ev in events:
                    if first and isinstance(ev, dict) and (
                        ev.get("event") == "manifest"
                    ):
                        # manifest record: stamp the collector's view
                        # so merge/trace can pair this stream with its
                        # clock anchors even without a fleet index
                        ev = dict(ev)
                        ev["source_id"] = source_id
                        ev["collect_recv_ts"] = recv_ts
                    f.write(json.dumps(ev) + "\n")
                f.write(json.dumps(marker, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())    # marker durable BEFORE the ack
            seen.add(seq)
            self.registry.counter(COLLECT_BATCHES).inc()
            self.registry.counter(COLLECT_INGESTED).inc(len(events))
            self.registry.gauge(COLLECT_SOURCES).set(len(self._seen))
        return {"status": "ok", "seq": seq, "recv_ts": recv_ts}

    def stats(self) -> Dict:
        snap = self.registry.snapshot()
        counters = snap.get("counters", {})
        with self._lock:
            sources = len(self._seen)
        return {
            "sources": sources,
            "batches": counters.get(COLLECT_BATCHES, 0),
            "ingested": counters.get(COLLECT_INGESTED, 0),
            "duplicates": counters.get(COLLECT_DUPLICATES, 0),
        }


def _decode_envelope(raw: bytes, gzipped: bool) -> Dict:
    """Decode one wire batch envelope; ``ValueError`` on anything
    malformed (the HTTP layer answers 400, which the shipper counts as
    a ship error and spools the batch)."""
    if gzipped:
        try:
            raw = gzip.decompress(raw)
        except OSError as e:
            raise ValueError(f"bad gzip body: {e}")
    try:
        batch = json.loads(raw.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"bad batch json: {e}")
    if not isinstance(batch, dict):
        raise ValueError("batch envelope must be an object")
    return batch


def _truncate_to_committed(data: str) -> str:
    """Keep everything up to and including the LAST ``collect_batch``
    marker line; drop the un-markered tail."""
    lines = data.split("\n")
    last = -1
    for i, ln in enumerate(lines):
        if not ln.strip():
            continue
        try:
            rec = json.loads(ln)
        except json.JSONDecodeError:
            continue
        if isinstance(rec, dict) and rec.get("event") == "collect_batch":
            last = i
    if last < 0:
        return ""
    return "\n".join(lines[:last + 1]) + "\n"


# ---------------------------------------------------------------------------
# collector HTTP server
# ---------------------------------------------------------------------------

class _CollectorHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    collector: Collector = None  # type: ignore[assignment]

    def log_message(self, fmt, *args):          # silence stderr chatter
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Dict) -> None:
        self._send(
            code, json.dumps(obj).encode("utf-8"), "application/json"
        )

    def do_POST(self):                          # noqa: N802
        if self.path.split("?", 1)[0] != "/ingest":
            self._send_json(404, {"error": "unknown path"})
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(n)
            gzipped = (
                self.headers.get("Content-Encoding", "") == "gzip"
            )
            ack = self.collector.ingest(raw, gzipped=gzipped)
        except ValueError as e:
            self.collector.registry.counter(COLLECT_INGEST_ERRORS).inc()
            self._send_json(400, {"error": str(e)})
            return
        except Exception as e:
            self.collector.registry.counter(COLLECT_INGEST_ERRORS).inc()
            self._send_json(500, {"error": str(e)})
            return
        self._send_json(200, ack)

    def do_GET(self):                           # noqa: N802
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._send_json(200, {"status": "ok", **self.collector.stats()})
        elif path == "/metrics":
            self._metrics(query)
        else:
            self._send_json(404, {"error": "unknown path"})

    def _metrics(self, query: str) -> None:
        from urllib.parse import parse_qs

        from . import prometheus

        params = parse_qs(query)
        snap = self.collector.registry.snapshot()
        accept = self.headers.get("Accept", "")
        want_prom = (
            params.get("format", [""])[0] == "prometheus"
            or prometheus.wants_prometheus(accept)
        )
        if want_prom:
            labels = {}
            for kv in params.get("label", []):
                k, _, v = kv.partition("=")
                if k:
                    labels[k] = v
            body = prometheus.render(snap, labels=labels or None)
            self._send(
                200, body.encode("utf-8"), prometheus.CONTENT_TYPE
            )
        else:
            self._send_json(200, snap)


def make_collector_server(
    collector: Collector, host: str = "127.0.0.1", port: int = 0
) -> ThreadingHTTPServer:
    handler = type(
        "_BoundCollectorHandler", (_CollectorHandler,),
        {"collector": collector},
    )
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def write_collect_announce(
    collect_dir: str, host: str, port: int, **extra
) -> str:
    """Publish the collector's address into its own dir (atomic, like
    ``front.json``) so drills and operators can discover the bound
    port without racing the bind."""
    from ..resilience.integrity import atomic_write_text

    path = os.path.join(collect_dir, COLLECT_ANNOUNCE_NAME)
    os.makedirs(collect_dir, exist_ok=True)
    atomic_write_text(path, json.dumps({
        "schema": 1,
        "host": host,
        "port": int(port),
        "pid": os.getpid(),
        "ts": time.time(),
        **extra,
    }, sort_keys=True) + "\n")
    return path


def read_collect_announce(
    collect_dir: str, wait_s: float = 10.0
) -> Dict:
    """Poll for ``collect.json`` (the collector may still be binding);
    tolerates a torn write by retrying within the deadline."""
    from ..resilience.retry import sleep as _sleep

    path = os.path.join(collect_dir, COLLECT_ANNOUNCE_NAME)
    deadline = time.monotonic() + wait_s
    while True:
        try:
            with open(path, "r", encoding="utf-8") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no collector announce at {path} "
                    f"after {wait_s:.1f}s"
                )
            _sleep(0.05)
