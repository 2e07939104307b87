"""Chrome ``trace_event`` export of telemetry run streams.

``metrics trace`` converts one or more (per-process) JSONL run streams
into the Trace Event Format that Perfetto / ``chrome://tracing`` load
directly: one *process track* per telemetry stream (pid = the stream's
``process_index``), spans / training iterations / micro-batches as
complete ("X") duration events, everything else as instants.

Two timeline modes:

* **default** — clock skew is surfaced, not corrected: timestamps are
  re-based PER STREAM against that stream's manifest timestamp, so each
  host's track starts at t=0 and is internally consistent; cross-track
  alignment is structural.  The per-stream offset is recorded in the
  track's ``process_name`` metadata.
* **``--causal``** — one SHARED timeline with per-stream clock
  CORRECTIONS (``metrics_cli.clock_corrections``: min observed delta
  over the supervisor's ``lease_sync`` heartbeat anchors), plus
  Perfetto **flow events** (``ph: "s"``/``"f"``) joining the causal
  span chain across process tracks: trace-stamped events
  (``fleet_spawn`` -> ``trace_adopt`` -> ``ledger_commit`` ->
  ``trace_request``/``trace_span``) are rendered as slices carrying
  their ``trace_id``/``span_id`` and every parent->child (and
  publish->serve *lineage link*) edge becomes a flow arrow — the
  single-request-across-three-processes view docs/OBSERVABILITY.md
  "Causal tracing & lineage" describes.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional

__all__ = [
    "trace_events_from_streams",
    "trace_document",
    "causal_trace_document",
]

_US = 1e6  # trace_event timestamps/durations are microseconds

# events that carry their OWN causal span identity as flat fields
# (span_id/trace_id/parent_span_id) — rendered as zero-duration slices
# the flow pass can attach arrows to
_STAMPED_KINDS = (
    "fleet_spawn", "trace_adopt", "ledger_commit", "trace_request",
)


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def _base_ts(manifest: Dict, events: List[Dict]) -> float:
    ts = manifest.get("ts")
    if _num(ts):
        return float(ts)
    for e in events:
        if _num(e.get("ts")):
            return float(e["ts"])
    return 0.0


def _complete(name, cat, pid, start_us, dur_us, args=None) -> Dict:
    ev = {
        "name": str(name), "cat": cat, "ph": "X", "pid": pid, "tid": 0,
        "ts": round(max(0.0, start_us), 3), "dur": round(max(0.0, dur_us), 3),
    }
    if args:
        ev["args"] = args
    return ev


def _standard_event(e: Dict, pid: int, rel_us: float) -> Optional[Dict]:
    """The shared per-event conversion: duration kinds become "X"
    slices, manifests/registry snapshots are skipped, everything else is
    an instant.  ``rel_us`` is the event's (end) timestamp on the output
    timeline."""
    kind = e.get("event")
    secs = e.get("seconds")
    if kind == "span" and _num(secs):
        # span events are emitted at EXIT: ts is the end time
        return _complete(
            e.get("name", "span"), "span", pid,
            rel_us - float(secs) * _US, float(secs) * _US,
        )
    if kind == "train_iteration" and _num(secs):
        return _complete(
            f"{e.get('optimizer', '?')}[{e.get('iteration')}]",
            "train", pid,
            rel_us - float(secs) * _US, float(secs) * _US,
            {"kind": e.get("kind")},
        )
    if kind == "micro_batch" and _num(secs):
        args = {"docs": e.get("docs")}
        if e.get("trace_id"):
            args["trace_id"] = e["trace_id"]
        return _complete(
            f"micro_batch[{e.get('batch_id')}]",
            f"stream.{e.get('role', '?')}", pid,
            rel_us - float(secs) * _US, float(secs) * _US,
            args,
        )
    if kind == "phase" and _num(secs):
        return _complete(
            f"phase:{e.get('name', '?')}", "phase", pid,
            rel_us - float(secs) * _US, float(secs) * _US,
        )
    if kind in ("manifest", "registry"):
        return None
    return {
        "name": str(kind), "cat": "event", "ph": "i",
        "pid": pid, "tid": 0, "ts": round(max(0.0, rel_us), 3),
        "s": "p",
    }


def trace_events_from_streams(streams: List[Dict]) -> List[Dict]:
    """``streams``: [{"proc": pid, "manifest": ..., "events": [...]}]
    (the shape ``metrics_cli.load_process_streams`` returns).  Returns a
    flat trace_event list, one pid track per stream."""
    out: List[Dict] = []
    for s in streams:
        pid = int(s["proc"])
        manifest, events = s["manifest"], s["events"]
        base = _base_ts(manifest, events)
        host = manifest.get("host", "?")
        out.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {
                "name": f"p{pid} {host}"
                        f" (run {manifest.get('run_id', '?')})",
            },
        })
        out.append({
            "name": "process_sort_index", "ph": "M", "pid": pid,
            "tid": 0, "args": {"sort_index": pid},
        })
        for e in events:
            ts = e.get("ts")
            if not _num(ts):
                continue
            ev = _standard_event(e, pid, (float(ts) - base) * _US)
            if ev is not None:
                out.append(ev)
    return out


def trace_document(streams: List[Dict]) -> Dict:
    """The full Perfetto-loadable JSON object."""
    return {
        "traceEvents": trace_events_from_streams(streams),
        "displayTimeUnit": "ms",
    }


# ---------------------------------------------------------------------------
# causal mode: shared corrected timeline + flow events
# ---------------------------------------------------------------------------
def _flow_id(trace_id: str, span_id: str) -> int:
    """Stable non-zero flow id from a (trace, span) pair — the flow
    binds to the CHILD span, so one parent can fan out N arrows."""
    return zlib.crc32(f"{trace_id}/{span_id}".encode("utf-8")) or 1


def causal_trace_document(
    streams: List[Dict],
    corrections: Optional[Dict[str, float]] = None,
) -> Dict:
    """One shared-timeline document with cross-process flow arrows.

    ``corrections``: per-stream-label seconds ADDED to that stream's
    timestamps to express them on the anchor clock
    (``metrics_cli.clock_corrections``); missing labels correct by 0.
    Track pids are the stream's position in the argument list — the
    single-host fixtures this renders most often all report
    ``process_index`` 0, which would fold every track into one.
    """
    corrections = corrections or {}
    out: List[Dict] = []
    # span index: span_id -> {pid, ts (us), parent, trace_id, name}
    spans: Dict[str, Dict] = {}
    links: List[Dict] = []      # publish -> serve lineage edges

    bases = []
    for s in streams:
        corr = float(corrections.get(s["label"], 0.0))
        bases.append(_base_ts(s["manifest"], s["events"]) + corr)
    t0 = min((b for b in bases if b), default=0.0)

    for si, s in enumerate(streams):
        pid = si
        manifest, events = s["manifest"], s["events"]
        corr = float(corrections.get(s["label"], 0.0))
        host = manifest.get("host", "?")
        out.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {
                "name": (
                    f"{s.get('label', f'p{pid}')} {host} "
                    f"({manifest.get('kind', '?')}, "
                    f"clock{corr:+.3f}s)"
                ),
            },
        })
        out.append({
            "name": "process_sort_index", "ph": "M", "pid": pid,
            "tid": 0, "args": {"sort_index": pid},
        })

        def _register(span_id, parent, trace_id, name, ts_us):
            if not span_id or span_id in spans:
                return
            spans[span_id] = {
                "pid": pid, "ts": ts_us, "parent": parent,
                "trace_id": trace_id, "name": name,
            }

        for e in events:
            kind = e.get("event")
            if kind == "trace_span" and _num(e.get("start")) \
                    and _num(e.get("seconds")):
                start_us = (float(e["start"]) + corr - t0) * _US
                dur_us = float(e["seconds"]) * _US
                out.append(_complete(
                    e.get("name", "trace_span"), "trace", pid,
                    start_us, dur_us,
                    {
                        "trace_id": e.get("trace_id"),
                        "span_id": e.get("span_id"),
                        "parent_span_id": e.get("parent_span_id"),
                    },
                ))
                _register(
                    e.get("span_id"), e.get("parent_span_id"),
                    e.get("trace_id"), e.get("name", "trace_span"),
                    max(0.0, start_us),
                )
                continue
            ts = e.get("ts")
            if not _num(ts):
                continue
            rel_us = (float(ts) + corr - t0) * _US
            if kind in _STAMPED_KINDS and e.get("span_id"):
                # zero-duration slice the flow pass can bind arrows to
                out.append(_complete(
                    str(kind), "trace", pid, rel_us, 0.0,
                    {
                        "trace_id": e.get("trace_id"),
                        "span_id": e.get("span_id"),
                        "parent_span_id": e.get("parent_span_id"),
                        **(
                            {"worker": e.get("worker")}
                            if "worker" in e else {}
                        ),
                    },
                ))
                _register(
                    e.get("span_id"), e.get("parent_span_id"),
                    e.get("trace_id"), str(kind), max(0.0, rel_us),
                )
                if kind == "trace_request" and e.get("publish_span_id"):
                    links.append({
                        "src": e["publish_span_id"],
                        "dst": e["span_id"],
                        "trace_id": e.get("trace_id"),
                    })
                continue
            ev = _standard_event(e, pid, rel_us)
            if ev is not None:
                out.append(ev)

    # flow pass: every resolvable parent->child edge becomes one
    # s/f arrow pair; lineage links (model-publish span -> serve
    # request span) get their own category so the train->serve join
    # reads differently from in-trace parentage
    def _arrow(src: Dict, dst: Dict, fid: int, cat: str, name: str):
        s_ts = min(src["ts"], dst["ts"])
        f_ts = max(src["ts"], dst["ts"])
        return [
            {
                "name": name, "cat": cat, "ph": "s", "id": fid,
                "pid": src["pid"], "tid": 0, "ts": round(s_ts, 3),
            },
            {
                "name": name, "cat": cat, "ph": "f", "bp": "e",
                "id": fid, "pid": dst["pid"], "tid": 0,
                "ts": round(max(f_ts, s_ts + 0.001), 3),
            },
        ]

    for span_id, info in spans.items():
        parent = info.get("parent")
        if not parent or parent not in spans:
            continue
        fid = _flow_id(info.get("trace_id") or "?", span_id)
        out.extend(_arrow(
            spans[parent], info, fid, "trace", "causal",
        ))
    for link in links:
        src, dst = spans.get(link["src"]), spans.get(link["dst"])
        if src is None or dst is None:
            continue
        fid = _flow_id(link.get("trace_id") or "?", "lineage:" + link["dst"])
        out.extend(_arrow(src, dst, fid, "lineage", "lineage"))
    return {"traceEvents": out, "displayTimeUnit": "ms"}
