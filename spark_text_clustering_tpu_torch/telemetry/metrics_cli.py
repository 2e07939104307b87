"""``metrics`` CLI: summarize / diff / regression-check telemetry runs.

The JAX package's ``metrics`` verb, copied: the same subcommands, flags,
output and exit codes on the same streams, whichever package wrote them.
``scale-check`` (the measured-scale observatory) exits 2 naming ROADMAP
item 10.

Makes BENCH_* regression detection a first-class repo tool instead of
ad-hoc JSON spelunking:

    python -m spark_text_clustering_tpu_torch.cli metrics summarize run.jsonl
    python -m spark_text_clustering_tpu_torch.cli metrics diff a.jsonl b.jsonl
    python -m spark_text_clustering_tpu_torch.cli metrics check run.jsonl \
        --baseline base.json [--write-baseline] [--tolerance 0.25]
    python -m spark_text_clustering_tpu_torch.cli metrics merge \
        run/events-p0.jsonl run/events-p1.jsonl [--fail-on-skew]
    python -m spark_text_clustering_tpu_torch.cli metrics trace \
        run/events-p*.jsonl --out trace.json     # Perfetto-loadable
    python -m spark_text_clustering_tpu_torch.cli metrics roofline run.jsonl \
        [--peaks peaks.json]       # achieved-vs-peak per executable
    python -m spark_text_clustering_tpu_torch.cli metrics compile-check \
        train.jsonl score.jsonl --baseline \
        scripts/records/compile_baseline.json    # recompile sentinel

Accepted inputs: a telemetry JSONL stream (manifest-first, the format
``telemetry.TelemetryWriter`` emits) OR a plain one-object JSON file
(e.g. a BENCH_rNN.json tail record) whose numeric leaves are flattened
into dotted metric names under ``bench.`` — so ``metrics diff
BENCH_r04.json BENCH_r05.json`` works on the existing artifacts today.

Baseline format (``check``)::

    {"schema": 1, "source": "<run path>", "default_tolerance": 0.25,
     "metrics": {"train.em.s_per_iter_mean": {"value": 0.1,
                                              "tolerance": 0.5}, ...}}

A metric passes when ``|run - base| <= tolerance * max(|base|, 1e-12)``
(relative band).  Timing-like metrics (``seconds``/``_ms``/``s_per_iter``
in the name) capture with a wider default band — wall times on shared
hosts jitter in ways counters and quality metrics don't.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from .events import read_events

__all__ = [
    "load_run",
    "run_metrics",
    "flatten_numeric",
    "load_process_streams",
    "merge_metrics",
    "clock_corrections",
    "skew_findings",
    "ledger_health",
    "fleet_health",
    "serve_fleet_health",
    "serving_health",
    "alert_health",
    "slo_health",
    "compile_health",
    "memory_health",
    "transport_health",
    "cmd_summarize",
    "cmd_tail",
    "cmd_diff",
    "cmd_check",
    "cmd_slo",
    "cmd_merge",
    "cmd_trace",
    "cmd_roofline",
    "cmd_compile_check",
    "cmd_scale_check",
    "add_metrics_subparser",
]

_TIMING_HINTS = ("seconds", "_ms", "s_per_iter", "_s")
_EPS = 1e-12


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def _flatten(obj, prefix: str, out: Dict[str, float]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten(v, f"{prefix}.{i}", out)
    elif _is_num(obj):
        out[prefix] = float(obj)


def flatten_numeric(obj, prefix: str = "") -> Dict[str, float]:
    """Numeric leaves of a nested record as dotted metric names — how a
    BENCH tail JSON becomes diffable metrics."""
    out: Dict[str, float] = {}
    _flatten(obj, prefix, out)
    return out


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return math.nan
    idx = max(0, min(len(sorted_vals) - 1,
                     math.ceil(len(sorted_vals) * q / 100.0) - 1))
    return sorted_vals[idx]


def load_run(path: str) -> Tuple[Dict, List[Dict]]:
    """(manifest, events) from a JSONL stream or a plain JSON object."""
    # whole-file parse first: a (possibly pretty-printed) single JSON
    # object with no "event" key is a BENCH-style tail record —
    # synthesize a manifest + one bench_record event so the pipeline
    # below is uniform
    try:
        with open(path, "r", encoding="utf-8") as f:
            whole = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError):
        whole = None
    if isinstance(whole, dict) and "event" not in whole:
        manifest = {"event": "manifest", "source_format": "plain_json",
                    "path": path}
        return manifest, [{"event": "bench_record", "record": whole}]
    events = [e for e in read_events(path) if isinstance(e, dict)]
    manifest = next(
        (e for e in events if e.get("event") == "manifest"), {}
    )
    return manifest, [e for e in events if e.get("event") != "manifest"]


def run_metrics(events: List[Dict]) -> Dict[str, float]:
    """Flatten a run's events into scalar metrics (the unit summarize
    prints, diff aligns, and check gates on)."""
    out: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    iter_secs: Dict[str, List[float]] = {}
    batch_secs: Dict[str, List[float]] = {}
    stream_docs = 0
    probe_outcomes: Dict[str, int] = {}

    for e in events:
        name = e.get("event", "?")
        counts[name] = counts.get(name, 0) + 1
        if name == "train_iteration":
            iter_secs.setdefault(
                str(e.get("optimizer", "?")), []
            ).append(float(e.get("seconds", math.nan)))
        elif name == "train_fit":
            opt = e.get("optimizer", "?")
            for k, v in e.items():
                if k in ("event", "ts", "optimizer", "kind"):
                    continue
                if _is_num(v):
                    out[f"train.{opt}.{k}"] = float(v)
        elif name == "micro_batch":
            role = str(e.get("role", "stream"))
            if _is_num(e.get("seconds")):
                batch_secs.setdefault(role, []).append(
                    float(e["seconds"])
                )
            stream_docs += int(e.get("docs", 0) or 0)
        elif name == "phase":
            if _is_num(e.get("seconds")):
                out[f"phase.{e.get('name', '?')}.seconds"] = float(
                    e["seconds"]
                )
        elif name == "probe_attempt":
            oc = str(e.get("outcome", e.get("error_class", "?")))
            probe_outcomes[oc] = probe_outcomes.get(oc, 0) + 1
        elif name == "metric" and _is_num(e.get("value")):
            out[str(e.get("name", "?"))] = float(e["value"])
        elif name == "bench_record":
            _flatten(e.get("record", {}), "bench", out)
        elif name == "registry":
            snap = e.get("snapshot", {})
            for k, v in snap.get("counters", {}).items():
                if _is_num(v):
                    out[f"counter.{k}"] = float(v)
            for k, v in snap.get("gauges", {}).items():
                if _is_num(v):
                    out[f"gauge.{k}"] = float(v)
            for k, h in snap.get("histograms", {}).items():
                for f in ("count", "mean", "p50", "p95", "p99", "max"):
                    if _is_num(h.get(f)):
                        out[f"hist.{k}.{f}"] = float(h[f])
        elif name == "corpus":
            for k, v in e.items():
                if k not in ("event", "ts") and _is_num(v):
                    out[f"corpus.{k}"] = float(v)

    for name, c in counts.items():
        out[f"events.{name}.count"] = float(c)
    for opt, secs in iter_secs.items():
        ss = sorted(s for s in secs if math.isfinite(s))
        if not ss:
            continue
        out[f"train.{opt}.iterations"] = float(len(ss))
        out[f"train.{opt}.s_per_iter_mean"] = sum(ss) / len(ss)
        out[f"train.{opt}.s_per_iter_p50"] = _pct(ss, 50)
        out[f"train.{opt}.s_per_iter_p95"] = _pct(ss, 95)
        out[f"train.{opt}.seconds_total"] = sum(ss)
    for role, secs in batch_secs.items():
        ss = sorted(secs)
        out[f"stream.{role}.batches"] = float(len(ss))
        out[f"stream.{role}.batch_p50_ms"] = 1000 * _pct(ss, 50)
        out[f"stream.{role}.batch_p95_ms"] = 1000 * _pct(ss, 95)
    if stream_docs:
        out["stream.docs"] = float(stream_docs)
    for oc, c in probe_outcomes.items():
        out[f"probe.{oc}"] = float(c)
    return out


# ---------------------------------------------------------------------------
# merge: fold N per-process streams into one logical run + skew report
# ---------------------------------------------------------------------------
def load_process_streams(paths: List[str]):
    """Load N per-process run streams, degrading gracefully: a missing,
    unreadable, or manifest-less stream is reported and SKIPPED — a dead
    worker must not make the surviving 127 hosts' telemetry unreadable.

    Returns ``(streams, problems)``; each stream is ``{"path", "proc",
    "label", "manifest", "events", "metrics"}``, ordered by process
    index (falling back to argument order when a manifest carries none).
    """
    streams, problems = [], []
    for i, path in enumerate(paths):
        try:
            manifest, events = load_run(path)
        except OSError as exc:
            problems.append(f"{path}: unreadable ({exc})")
            continue
        if not manifest and not events:
            problems.append(f"{path}: empty stream (no manifest, no events)")
            continue
        if not manifest:
            problems.append(
                f"{path}: truncated stream (no manifest record) — "
                f"metrics from its {len(events)} events still merged"
            )
        pidx = manifest.get("process_index")
        proc = int(pidx) if isinstance(pidx, (int, float)) \
            and not isinstance(pidx, bool) else i
        streams.append({
            "path": path,
            "proc": proc,
            "manifest": manifest,
            "events": events,
            "metrics": run_metrics(events),
        })
    # duplicate process indices (e.g. two streams with no manifest) must
    # not silently shadow each other in the per-process tables
    seen: Dict[int, int] = {}
    for s in streams:
        n = seen.get(s["proc"], 0)
        seen[s["proc"]] = n + 1
        s["label"] = f"p{s['proc']}" + (f".{n}" if n else "")
    streams.sort(key=lambda s: (s["proc"], s["label"]))
    return streams, problems


def merge_metrics(streams) -> Dict[str, Dict]:
    """Per-metric cross-process statistics: min / median / max / spread
    (relative max-min width) + the per-process values themselves."""
    import statistics

    names = sorted({k for s in streams for k in s["metrics"]})
    out: Dict[str, Dict] = {}
    for name in names:
        per = {
            s["label"]: s["metrics"][name]
            for s in streams if name in s["metrics"]
        }
        vals = sorted(per.values())
        med = statistics.median(vals)
        spread = (vals[-1] - vals[0]) / max(abs(med), _EPS)
        out[name] = {
            "min": vals[0], "median": med, "max": vals[-1],
            "spread": spread, "per_process": per,
            "processes": len(per),
        }
    return out


# metric families the skew report inspects beyond generic timing spread
_RETRY_KEY = "counter.resilience.retries"
_QUEUE_KEY = "gauge.stream.queue_depth"


def skew_findings(streams, merged: Dict[str, Dict],
                  threshold: float) -> List[Dict]:
    """Cross-host skew report over merged per-process metrics.

    Three detectors (ROADMAP "multi-host telemetry aggregation"):
      * **straggler** — a timing metric (``span.*.seconds`` histograms,
        ``phase.*.seconds``, per-iteration means) whose max/median
        spread exceeds ``threshold``; names the slowest process.
      * **retries** — ``resilience.retries`` diverging across processes
        (one host absorbing transient faults the others never see).
      * **queue_depth** — ``stream.queue_depth`` divergence beyond the
        threshold (one host's source backing up).
    """
    import statistics

    finds: List[Dict] = []
    for name, stat in merged.items():
        if name in (_RETRY_KEY, _QUEUE_KEY):
            if len(streams) < 2:
                continue
            # counters/gauges are zero-initialized: a process whose
            # snapshot never mentions the metric reports 0, not
            # "unknown" — otherwise the one host absorbing all the
            # retries hides the divergence by being the only reporter
            per = {
                s["label"]: s["metrics"].get(name, 0.0) for s in streams
            }
            vals = sorted(per.values())
            med = statistics.median(vals)
            spread = (vals[-1] - vals[0]) / max(abs(med), _EPS)
            worst = max(per, key=lambda lbl: per[lbl])
            diverged = (
                vals[-1] > vals[0] if name == _RETRY_KEY
                else spread > threshold
            )
            if diverged:
                finds.append({
                    "kind": "retries" if name == _RETRY_KEY
                    else "queue_depth",
                    "metric": name, "process": worst,
                    "value": per[worst], "median": med, "spread": spread,
                })
            continue
        if stat["processes"] < 2:
            continue
        per = stat["per_process"]
        is_timing = any(h in name for h in _TIMING_HINTS)
        if is_timing and stat["spread"] > threshold and stat["max"] > 0:
            slowest = max(per, key=lambda lbl: per[lbl])
            finds.append({
                "kind": "straggler", "metric": name,
                "process": slowest, "value": per[slowest],
                "median": stat["median"], "spread": stat["spread"],
            })
    order = {"straggler": 0, "retries": 1, "queue_depth": 2}
    finds.sort(key=lambda f: (order[f["kind"]], -f["spread"], f["metric"]))
    return finds


def _clock_offsets(streams) -> Dict[str, float]:
    """Per-process manifest-timestamp offset from the earliest stream —
    the RAW reading (manifest ts includes process start order, not just
    clock skew), kept verbatim in the skew report."""
    ts = {
        s["label"]: s["manifest"].get("ts")
        for s in streams
        if _is_num(s["manifest"].get("ts"))
    }
    if not ts:
        return {}
    t0 = min(ts.values())
    return {lbl: round(t - t0, 6) for lbl, t in ts.items()}


def clock_corrections(streams) -> Dict[str, float]:
    """Per-stream clock CORRECTION in seconds: add it to a stream's
    timestamps to express them on the anchor (supervisor) clock.

    Sync anchors are the supervisor's ``lease_sync`` events — one
    (worker-clock ``lease_ts``, supervisor-clock ``observed_ts``) pair
    per heartbeat renewal.  ``observed - lease`` equals the true clock
    offset plus the lease write->read latency (bounded by one sweep
    interval), so the MINIMUM over all renewals is the tightest offset
    estimate the filesystem protocol admits.  Worker streams pair with
    their anchors by the ``worker_index`` manifest field.

    Collector-aggregated streams carry the SAME math at the HTTP hop:
    every ``collect_batch`` marker pairs a shipper-clock ``sent_ts``
    with a collector-clock ``recv_ts``, and ``recv - sent`` is the true
    offset plus one push's transport latency — so the minimum over a
    source's markers anchors that stream to the collector clock.
    Remote streams have no fleet ``worker_index``, so they pair by the
    ``source_id`` the collector injects into each manifest (falling
    back to the marker's own source_id inside the stream).  Streams
    with no anchor of either kind correct by 0 — correction is a
    refinement, never a requirement.
    """
    out: Dict[str, float] = {s["label"]: 0.0 for s in streams}
    anchors: Dict[int, List[float]] = {}
    source_anchors: Dict[str, List[float]] = {}
    for s in streams:
        for e in s["events"]:
            kind = e.get("event")
            if kind == "lease_sync":
                if not (_is_num(e.get("lease_ts"))
                        and _is_num(e.get("observed_ts"))):
                    continue
                try:
                    worker = int(e.get("worker", -1))
                except (TypeError, ValueError):
                    continue
                anchors.setdefault(worker, []).append(
                    float(e["observed_ts"]) - float(e["lease_ts"])
                )
            elif kind == "collect_batch":
                sid = e.get("source_id")
                if not (isinstance(sid, str)
                        and _is_num(e.get("sent_ts"))
                        and _is_num(e.get("recv_ts"))):
                    continue
                source_anchors.setdefault(sid, []).append(
                    float(e["recv_ts"]) - float(e["sent_ts"])
                )
    if not anchors and not source_anchors:
        return out
    for s in streams:
        widx = s["manifest"].get("worker_index")
        if _is_num(widx) and int(widx) in anchors:
            out[s["label"]] = round(min(anchors[int(widx)]), 6)
            continue
        sid = s["manifest"].get("source_id")
        if not isinstance(sid, str):
            # aggregated streams whose manifest predates the collector's
            # source_id stamp still carry markers of exactly one source
            sids = {
                e.get("source_id") for e in s["events"]
                if e.get("event") == "collect_batch"
            } - {None}
            sid = sids.pop() if len(sids) == 1 else None
        if sid is not None and sid in source_anchors:
            out[s["label"]] = round(min(source_anchors[sid]), 6)
    return out


def cmd_merge(args) -> int:
    try:
        return _cmd_merge(args)
    except BrokenPipeError:      # `... | head` closed the pipe
        return 0


def _cmd_merge(args) -> int:
    streams, problems = load_process_streams(args.runs)
    for p in problems:
        print(f"warning: {p}", file=sys.stderr)
    if not streams:
        print("no readable run streams to merge", file=sys.stderr)
        return 2
    merged = merge_metrics(streams)
    findings = skew_findings(streams, merged, args.skew_threshold)
    offsets = _clock_offsets(streams)
    corrections = clock_corrections(streams)

    if getattr(args, "json", False):
        doc = {
            "processes": [
                {
                    "label": s["label"], "path": s["path"],
                    "run_id": s["manifest"].get("run_id"),
                    "host": s["manifest"].get("host"),
                    "events": len(s["events"]),
                    "clock_offset_s": offsets.get(s["label"]),
                    "clock_correction_s": corrections.get(s["label"]),
                }
                for s in streams
            ],
            "metrics": {f"merge.{k}": v for k, v in merged.items()},
            "skew": [
                {**f, "name": f"skew.{f['kind']}"} for f in findings
            ],
            "skew_threshold": args.skew_threshold,
            "problems": problems,
        }
        print(json.dumps(doc, sort_keys=True))
    else:
        print(f"merged {len(streams)} process stream(s)")
        for s in streams:
            off = offsets.get(s["label"])
            off_s = f", clock_offset={off:+.3f}s" if off is not None else ""
            corr = corrections.get(s["label"], 0.0)
            # lease-anchored correction (0 = no anchor); the raw offset
            # above stays in the report untouched
            corr_s = f", clock_correction={corr:+.3f}s" if corr else ""
            print(
                f"  {s['label']}: {s['path']} "
                f"(run_id={s['manifest'].get('run_id', '?')}, "
                f"host={s['manifest'].get('host', '?')}, "
                f"events={len(s['events'])}{off_s}{corr_s})"
            )
        w = max((len(k) for k in merged), default=10)
        print(f"{'metric'.ljust(w)}  {'min':>12}  {'median':>12}  "
              f"{'max':>12}  {'spread':>7}")
        for k in sorted(merged):
            st = merged[k]
            mark = "  <<" if st["spread"] > args.skew_threshold \
                and st["processes"] > 1 else ""
            print(
                f"{k.ljust(w)}  {st['min']:>12.6g}  {st['median']:>12.6g}"
                f"  {st['max']:>12.6g}  {st['spread']:>7.2f}{mark}"
            )
        print(f"skew report (threshold {args.skew_threshold:g}):")
        if not findings:
            print("  no cross-host skew beyond threshold")
        for f in findings:
            print(
                f"  {f['kind'].upper()} {f['metric']}: {f['process']}="
                f"{f['value']:.6g} vs median {f['median']:.6g} "
                f"(spread {f['spread']:.2f})"
            )
        print(f"# {len(merged)} metrics, {len(findings)} skew finding(s)")
    if args.fail_on_skew and findings:
        return 1
    return 0


def cmd_trace(args) -> int:
    from .trace_export import causal_trace_document, trace_document

    streams, problems = load_process_streams(args.runs)
    for p in problems:
        print(f"warning: {p}", file=sys.stderr)
    if not streams:
        print("no readable run streams to export", file=sys.stderr)
        return 2
    if getattr(args, "causal", False):
        corrections = clock_corrections(streams)
        doc = causal_trace_document(streams, corrections)
        flows = sum(
            1 for e in doc["traceEvents"] if e.get("ph") == "s"
        )
        note = (
            f", {flows} flow edge(s), clock corrections "
            + " ".join(
                f"{lbl}{corr:+.3f}s"
                for lbl, corr in sorted(corrections.items()) if corr
            )
            if flows or any(corrections.values()) else ""
        )
    else:
        doc = trace_document(streams)
        note = ""
    payload = json.dumps(doc)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(payload)
        print(
            f"trace written: {args.out} "
            f"({len(doc['traceEvents'])} events, {len(streams)} track(s)"
            f"{note}) — load in Perfetto / chrome://tracing"
        )
    else:
        print(payload)
    return 0


def ledger_health(events: List[Dict]) -> Optional[Dict]:
    """Ledger-health summary from the ``ledger_*`` / replay events an
    epoch-committed stream emits (docs/RESILIENCE.md "Epoch commit
    ledger"): commit cadence, rollback rate, replays suppressed.  None
    when the run never touched a ledger."""
    commits = [e for e in events if e.get("event") == "ledger_commit"]
    rollbacks = [e for e in events if e.get("event") == "ledger_rollback"]
    replays = sum(
        int(e.get("files", 0) or 0)
        for e in events
        if e.get("event") == "replays_suppressed"
    )
    if not commits and not rollbacks and not replays:
        return None
    out: Dict = {
        "commits": len(commits),
        "rollbacks": len(rollbacks),
        "replays_suppressed": replays,
    }
    total = len(commits) + len(rollbacks)
    out["rollback_rate"] = round(len(rollbacks) / total, 4) if total else 0.0
    by_kind: Dict[str, int] = {}
    for e in commits:
        k = str(e.get("kind", "?"))
        by_kind[k] = by_kind.get(k, 0) + 1
    if by_kind:
        out["commits_by_kind"] = by_kind
    ts = sorted(
        float(e["ts"]) for e in commits if _is_num(e.get("ts"))
    )
    if len(ts) >= 2:
        out["commit_cadence_seconds"] = round(
            (ts[-1] - ts[0]) / (len(ts) - 1), 6
        )
    reasons: Dict[str, int] = {}
    for e in rollbacks:
        r = str(e.get("reason", "?"))
        reasons[r] = reasons.get(r, 0) + 1
    if reasons:
        out["rollbacks_by_reason"] = reasons
    return out


def fleet_health(events: List[Dict]) -> Optional[Dict]:
    """Fleet-health summary from the ``fleet_*`` events a supervisor
    run emits (docs/RESILIENCE.md "Fleet supervision"): worker count
    over time, resizes, preemptions survived, mean lease slack.  None
    when the run never supervised a fleet."""
    by = {}
    for e in events:
        n = e.get("event", "")
        if isinstance(n, str) and n.startswith("fleet_"):
            by.setdefault(n, []).append(e)
    if not by:
        return None
    out: Dict = {
        "spawns": len(by.get("fleet_spawn", ())),
        "respawns": len(by.get("fleet_respawn", ())),
        "crashes": len(by.get("fleet_crash", ())),
        "lease_expiries": len(by.get("fleet_lease_expired", ())),
        "preemptions": len(by.get("fleet_preempt", ()))
        + len(by.get("fleet_preempted_externally", ())),
    }
    resizes = [
        {
            "from": e.get("workers_from"),
            "to": e.get("workers_to"),
            "why": e.get("why"),
        }
        for e in by.get("fleet_resize", ())
    ]
    out["resizes"] = len(resizes)
    if resizes:
        out["resize_history"] = resizes
    sweeps = by.get("fleet_sweep", ())
    counts = [
        int(e["workers"]) for e in sweeps if _is_num(e.get("workers"))
    ]
    if counts:
        out["workers"] = {
            "min": min(counts), "max": max(counts),
            "final": counts[-1], "sweeps": len(counts),
        }
    slacks = [
        float(e["lease_slack_min"])
        for e in sweeps
        if _is_num(e.get("lease_slack_min"))
    ]
    if slacks:
        out["mean_lease_slack_seconds"] = round(
            sum(slacks) / len(slacks), 6
        )
        out["min_lease_slack_seconds"] = round(min(slacks), 6)
    conv = by.get("fleet_converged", ())
    if conv:
        out["converged"] = True
        if _is_num(conv[-1].get("committed_epochs")):
            out["committed_epochs"] = int(conv[-1]["committed_epochs"])
    # serve-role rolling swaps (fleet_swap_roll / fleet_replica_swapped
    # / fleet_swap_roll_done): per-roll swap lag between the FIRST and
    # LAST replica swap — the window a pinned client stream can still
    # land on the old generation
    rolls = by.get("fleet_swap_roll_done", ())
    if rolls:
        out["swap_rolls"] = len(rolls)
        out["replica_swaps"] = len(by.get("fleet_replica_swapped", ()))
        lags = [
            float(e["swap_lag_seconds"]) for e in rolls
            if _is_num(e.get("swap_lag_seconds"))
        ]
        if lags:
            out["swap_lag_seconds_max"] = round(max(lags), 6)
    if by.get("fleet_swap_stalled"):
        out["swap_stalls"] = len(by["fleet_swap_stalled"])
    return out


def serve_fleet_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """Serve-fleet-health summary for a routing-front run
    (docs/SERVING.md "Serve fleet"): request volume and retries, the
    per-replica request share and p99 spread (the load-balance view),
    and the observed swap lag per rolling publish.  None when the run
    never fronted a fleet."""
    if not any(k.startswith(("counter.front.", "hist.front."))
               for k in metrics) and not any(
        e.get("event") == "front_swap_observed" for e in events
    ):
        return None
    out: Dict = {
        "requests": int(metrics.get("counter.front.requests", 0)),
        "retries": int(metrics.get("counter.front.retries", 0)),
        "no_replica": int(metrics.get("counter.front.no_replica", 0)),
        "repins": int(metrics.get("counter.front.repins", 0)),
    }
    # overload control at the edge (docs/SERVING.md "Overload &
    # degradation"): typed sheds/rejections and the spent retry budget
    shed = int(metrics.get("counter.front.shed_total", 0))
    rejected = int(metrics.get("counter.front.rejected_total", 0))
    budget_x = int(
        metrics.get("counter.front.retry_budget_exhausted", 0)
    )
    if shed or rejected or budget_x:
        out["overload"] = {
            "shed": shed,
            "rejected": rejected,
            "retry_budget_exhausted": budget_x,
        }
    lat = {}
    for q in ("p50", "p99", "mean", "count"):
        v = metrics.get(f"hist.front.request_seconds.{q}")
        if v is not None:
            lat[q] = v
    if lat:
        out["request_seconds"] = lat
    # per-replica share + p99 spread from the front.replica.<i>.*
    # families (the Prometheus 'replica' label's run-stream twin)
    rep_re = re.compile(r"^counter\.front\.replica\.(\d+)\.requests$")
    replicas = []
    total = max(1, out["requests"])
    for k in sorted(metrics):
        m = rep_re.match(k)
        if not m:
            continue
        i = int(m.group(1))
        row = {
            "replica": i,
            "requests": int(metrics[k]),
            "share": round(metrics[k] / total, 4),
            "retries": int(metrics.get(
                f"counter.front.replica.{i}.retries", 0
            )),
        }
        p99 = metrics.get(
            f"hist.front.replica.{i}.request_seconds.p99"
        )
        if p99 is not None:
            row["p99_seconds"] = p99
        replicas.append(row)
    if replicas:
        out["replicas"] = replicas
        p99s = [r["p99_seconds"] for r in replicas
                if "p99_seconds" in r]
        if len(p99s) >= 2:
            out["p99_spread_seconds"] = round(max(p99s) - min(p99s), 6)
    # swap lag as the FRONT observed it: per target stamp, first vs
    # last replica whose lease crossed to the new generation
    swaps: Dict[str, List[float]] = {}
    for e in events:
        if e.get("event") != "front_swap_observed":
            continue
        if not _is_num(e.get("ts")):
            continue
        swaps.setdefault(str(e.get("to_stamp")), []).append(
            float(e["ts"])
        )
    if swaps:
        out["swaps_observed"] = [
            {
                "stamp": stamp,
                "replicas": len(ts),
                "swap_lag_seconds": round(max(ts) - min(ts), 6),
            }
            for stamp, ts in sorted(swaps.items())
        ]
    return out


def serving_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """Serving-health summary for a ``stc serve`` run (docs/SERVING.md):
    request volume, p50/p99 service latency, batch fill, hot-swaps,
    quarantined/refused documents, and the per-executable dispatch
    attribution of the ``serve.``-labeled executables.  Reads the
    registry-snapshot metrics (``hist.serve.*`` / ``counter.serve.*``)
    plus the ``serve_*`` events; None when the run never served."""
    served = any(
        e.get("event") in
        ("serve_warmup", "serve_swap", "serve_swap_failed",
         "serve_drained")
        for e in events
    )
    if not served and not any(k.startswith(
        ("counter.serve.", "hist.serve.", "gauge.serve.")
    ) for k in metrics):
        return None
    out: Dict = {
        "requests": int(metrics.get("counter.serve.requests", 0)),
        "batches": int(metrics.get("counter.serve.batches", 0)),
        "hot_swaps": int(metrics.get("counter.serve.swaps", 0)),
        "swap_failures": int(
            metrics.get("counter.serve.swap_failures", 0)
        ),
        "quarantined": int(metrics.get("counter.serve.quarantined", 0)),
        "rejected_while_draining": int(
            metrics.get("counter.serve.rejected", 0)
        ),
    }
    lat: Dict[str, float] = {}
    for q in ("p50", "p95", "p99", "mean", "max", "count"):
        v = metrics.get(f"hist.serve.request_seconds.{q}")
        if v is not None:
            lat[q] = v
    if lat:
        out["request_seconds"] = lat
    qs = metrics.get("hist.serve.queue_seconds.p50")
    if qs is not None:
        out["queue_seconds_p50"] = qs
    fill = metrics.get("hist.serve.batch_fill.mean")
    if fill is not None:
        out["batch_fill_mean"] = round(fill, 4)
    # bounded admission + degraded mode (docs/SERVING.md "Overload &
    # degradation"): the typed-429 ledger and the quality-for-capacity
    # trade, rendered only for runs that exercised them
    adm_re = re.compile(r"^counter\.admission\.(accepted|rejected)\.")
    admission: Dict[str, int] = {}
    for k in sorted(metrics):
        m = adm_re.match(k)
        if m:
            admission[k[len("counter.admission."):]] = int(metrics[k])
    evicted = int(metrics.get("counter.admission.evicted", 0))
    if admission or evicted:
        out["admission"] = dict(admission, evicted=evicted)
    degraded = int(metrics.get("counter.degrade.responses", 0))
    if degraded or metrics.get("counter.degrade.entered"):
        out["degraded"] = {
            "responses": degraded,
            "entered": int(metrics.get("counter.degrade.entered", 0)),
            "exited": int(metrics.get("counter.degrade.exited", 0)),
        }
    classes: Dict[str, Dict[str, float]] = {}
    for cls in ("interactive", "batch"):
        row = {}
        for q in ("p50", "p99", "count"):
            v = metrics.get(
                f"hist.serve.class.{cls}.request_seconds.{q}"
            )
            if v is not None:
                row[q] = v
        if row:
            classes[cls] = row
    if classes:
        out["classes"] = classes
    warm = next(
        (e for e in events if e.get("event") == "serve_warmup"), None
    )
    if warm is not None:
        out["warmup"] = {
            k: warm[k]
            for k in ("buckets", "warmup_seconds", "retraces_at_warmup",
                      "compile_cache", "cache_hits", "cache_misses",
                      "cache_stores")
            if k in warm
        }
    drained = next(
        (e for e in reversed(events)
         if e.get("event") == "serve_drained"), None
    )
    if drained is not None and _is_num(
        drained.get("retraces_after_warmup")
    ):
        out["retraces_after_warmup"] = int(
            drained["retraces_after_warmup"]
        )
    swaps = [
        {
            "from": e.get("from_model"), "to": e.get("to_model"),
            "epoch": e.get("epoch"),
        }
        for e in events if e.get("event") == "serve_swap"
    ]
    if swaps:
        out["swap_history"] = swaps
    # per-executable attribution: join the serve-labeled
    # dispatch_executable announcements to their live call counters
    executables = []
    for e in events:
        if e.get("event") != "dispatch_executable":
            continue
        label = str(e.get("label", ""))
        if not label.startswith("serve."):
            continue
        d = e.get("digest")
        executables.append({
            "label": label,
            "digest": d,
            "calls": int(metrics.get(f"counter.dispatch.{d}.calls", 0)),
            "compile_seconds": e.get("compile_seconds"),
            "signature": str(e.get("signature", ""))[:80],
        })
    if executables:
        executables.sort(key=lambda r: -r["calls"])
        out["executables"] = executables
    return out


def compile_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """Compile-health summary (docs/OBSERVABILITY.md "Executable
    cache"): executable-cache hit rate, this process's
    time-to-first-dispatch, and cold-vs-warm first-call seconds per
    dispatch label — the attribution that says where cold-start time
    went.  Reads the ``counter.compile.cache_*`` registry metrics, the
    ``compile_cache`` events, and the cache fields the
    ``dispatch_executable`` announcements carry.  None for streams
    that predate the cache (no cache counters, no time-to-first-
    dispatch gauge) so old fixtures render unchanged."""
    cache = {
        k: int(metrics.get(f"counter.compile.cache_{k}", 0))
        for k in ("hits", "misses", "stores", "invalidations")
    }
    have_cache = any(
        f"counter.compile.cache_{k}" in metrics for k in cache
    ) or any(e.get("event") == "compile_cache" for e in events)
    ttfd = metrics.get("gauge.compile.time_to_first_dispatch_seconds")
    if not have_cache and ttfd is None:
        return None
    out: Dict = {"cache": cache}
    consulted = cache["hits"] + cache["misses"]
    if consulted:
        out["cache"]["hit_rate"] = round(cache["hits"] / consulted, 4)
    if ttfd is not None:
        out["time_to_first_dispatch_seconds"] = round(ttfd, 6)
    retr = metrics.get("counter.compile.retraces")
    if retr is not None:
        out["retraces"] = int(retr)
    # cold-vs-warm first-call seconds by label: a dispatch_executable
    # with cache == "hit" paid deserialize+dispatch, anything else paid
    # trace+compile(+dispatch) — the per-label delta is the saving
    by_label: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") != "dispatch_executable":
            continue
        lbl = str(e.get("label", "?"))
        row = by_label.setdefault(
            lbl, {"cold_seconds": [], "warm_seconds": []}
        )
        cs = e.get("compile_seconds")
        if not _is_num(cs):
            continue
        if str(e.get("cache", "off")) == "hit":
            row["warm_seconds"].append(float(cs))
        else:
            row["cold_seconds"].append(float(cs))
    labels = {}
    for lbl, row in sorted(by_label.items()):
        rec = {}
        for kind in ("cold_seconds", "warm_seconds"):
            vals = row[kind]
            if vals:
                rec[kind] = round(sum(vals), 6)
                rec[f"{kind.split('_')[0]}_first_calls"] = len(vals)
        if rec:
            labels[lbl] = rec
    if labels:
        out["by_label"] = labels
    invalidated = [
        {
            "digest": e.get("digest"), "label": e.get("label"),
            "reason": e.get("reason"),
        }
        for e in events
        if e.get("event") == "compile_cache"
        and e.get("op") == "invalidate"
    ]
    if invalidated:
        out["invalidated"] = invalidated
    return out


def memory_health(metrics: Dict[str, float]) -> Optional[Dict]:
    """Memory-health summary from the live-sampling gauges
    (telemetry.memory): device totals, the per-device max/min/imbalance
    breakdown (the line that says one chip is carrying the model while
    the sum looks fine), host RSS, and the unavailable-device counter.
    None when the run never sampled memory."""
    sampled = _is_num(metrics.get("counter.mem.samples"))
    have_dev = any(
        k.startswith("gauge.mem.device.") for k in metrics
    )
    if not sampled and not have_dev:
        return None
    out: Dict = {}
    if sampled:
        out["samples"] = int(metrics["counter.mem.samples"])
    for k, name in (
        ("gauge.mem.device.bytes_in_use", "device_bytes_in_use"),
        ("gauge.mem.device.peak_bytes_in_use",
         "device_peak_bytes_in_use"),
        ("gauge.mem.device.bytes_limit", "device_bytes_limit"),
        ("gauge.mem.host.rss_bytes", "host_rss_bytes"),
    ):
        if _is_num(metrics.get(k)):
            out[name] = int(metrics[k])
    per_dev = {}
    for k, name in (
        ("gauge.mem.device.peak_bytes_in_use_max", "peak_max"),
        ("gauge.mem.device.peak_bytes_in_use_min", "peak_min"),
        ("gauge.mem.device.bytes_in_use_max", "in_use_max"),
        ("gauge.mem.device.bytes_in_use_min", "in_use_min"),
    ):
        if _is_num(metrics.get(k)):
            per_dev[name] = int(metrics[k])
    imb = metrics.get("gauge.mem.device.imbalance")
    if _is_num(imb):
        per_dev["imbalance"] = round(imb, 4)
    if per_dev:
        out["per_device"] = per_dev
    unavail = metrics.get("counter.mem.device_stats_unavailable")
    if _is_num(unavail):
        out["device_stats_unavailable"] = int(unavail)
    return out


def alert_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """Alert-health summary for an ``stc monitor`` run
    (docs/OBSERVABILITY.md "Live monitoring & alerting"): per-rule
    transition totals, the still-firing set (replayed from the
    ``alert_transition`` events), actions emitted, and the newest
    topic-drift probe reading.  None when the run never monitored."""
    trans = [
        e for e in events if e.get("event") == "alert_transition"
    ]
    actions = [
        e for e in events if e.get("event") == "action_emitted"
    ]
    drifts = [e for e in events if e.get("event") == "drift_probe"]
    monitored = bool(trans or actions or drifts) or any(
        k.startswith(("counter.alert.", "counter.monitor.",
                      "gauge.alert.", "gauge.drift."))
        for k in metrics
    )
    if not monitored:
        return None
    out: Dict = {
        "fired": int(metrics.get("counter.alert.firing", 0)),
        "resolved": int(metrics.get("counter.alert.resolved", 0)),
        "pending": int(metrics.get("counter.alert.pending", 0)),
        "actions_emitted": int(
            metrics.get("counter.monitor.actions", 0)
        ),
        "polls": int(metrics.get("counter.monitor.polls", 0)),
    }
    by_rule: Dict[str, Dict[str, int]] = {}
    firing: Dict[Tuple[str, str], Dict] = {}
    for e in trans:
        rule = str(e.get("rule", "?"))
        state = str(e.get("state", "?"))
        by_rule.setdefault(rule, {})
        by_rule[rule][state] = by_rule[rule].get(state, 0) + 1
        k = (rule, str(e.get("key", "")))
        if state == "firing":
            firing[k] = e
        elif state == "resolved":
            firing.pop(k, None)
    if by_rule:
        out["by_rule"] = by_rule
    out["still_firing"] = sorted(
        (
            {
                "rule": rule, "key": key,
                "value": rec.get("value"),
                "threshold": rec.get("threshold"),
            }
            for (rule, key), rec in firing.items()
        ),
        key=lambda r: (r["rule"], r["key"]),
    )
    if actions:
        out["actions"] = [
            {
                "kind": a.get("kind"), "alert": a.get("alert"),
                "key": a.get("key"), "id": a.get("id"),
            }
            for a in actions
        ]
    if drifts:
        last = drifts[-1]
        out["drift"] = {
            "ledger": last.get("ledger"),
            "epoch": last.get("epoch"),
            "kl": last.get("kl"),
            "hellinger": last.get("hellinger"),
            "probes": len(drifts),
        }
    elif _is_num(metrics.get("gauge.drift.kl")):
        out["drift"] = {
            "kl": metrics.get("gauge.drift.kl"),
            "hellinger": metrics.get("gauge.drift.hellinger"),
        }
    return out


_SLO_GAUGE_RE = re.compile(r"^gauge\.slo\.([a-z0-9_]+)\.total$")


def slo_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """SLO-health summary (docs/OBSERVABILITY.md "SLOs & error
    budgets"): per-objective latest status (from ``slo_status``
    transition events), budget remaining and burning flags (from the
    final ``slo.*`` gauges), and the evaluation count.  None when the
    run never evaluated an SLO."""
    statuses = [e for e in events if e.get("event") == "slo_status"]
    touched = bool(statuses) or any(
        k.startswith(("gauge.slo.", "counter.slo.")) for k in metrics
    )
    if not touched:
        return None
    latest: Dict[str, Dict] = {}
    for e in statuses:
        latest[str(e.get("objective", "?"))] = e
    names = set(latest)
    for k in metrics:
        m = _SLO_GAUGE_RE.match(k)
        if m:
            names.add(m.group(1))
    objectives: List[Dict] = []
    for name in sorted(names):
        rec: Dict = {"objective": name}
        e = latest.get(name)
        if e is not None:
            for f in ("status", "kind", "source", "good", "total",
                      "budget_remaining", "burning"):
                if e.get(f) is not None:
                    rec[f] = e[f]
        for f, g in (
            ("total", f"gauge.slo.{name}.total"),
            ("good_fraction", f"gauge.slo.{name}.good_fraction"),
            ("budget_remaining", f"gauge.slo.{name}.budget_remaining"),
        ):
            if _is_num(metrics.get(g)):
                rec[f] = metrics[g]
        if _is_num(metrics.get(f"gauge.slo.{name}.burning")):
            rec["burning"] = bool(metrics[f"gauge.slo.{name}.burning"])
        objectives.append(rec)
    return {
        "evaluations": int(metrics.get("counter.slo.evaluations", 0)),
        "objectives_burning": int(
            metrics.get("gauge.slo.objectives_burning", 0)
        ),
        "objectives": objectives,
    }


def transport_health(
    events: List[Dict], metrics: Dict[str, float]
) -> Optional[Dict]:
    """Telemetry-transport health (docs/OBSERVABILITY.md "Telemetry
    transport"): the shipper's delivery accounting (shipped/spooled/
    dropped/replayed off its ``telemetry.*`` counters), the collector's
    fold accounting (``collect.*`` counters), and a per-source view
    derived from ``collect_batch`` markers — batches, events, replay
    totals, and ship lag (the marker's collector-clock ``recv_ts``
    minus its shipper-clock ``sent_ts``, i.e. how far behind the
    collector's view of that source ran at the last push).  None when
    the run never touched the transport plane."""
    markers = [e for e in events if e.get("event") == "collect_batch"]
    ship_keys = (
        "telemetry.shipped", "telemetry.spooled", "telemetry.dropped",
        "telemetry.ship_errors", "telemetry.ship_replayed",
    )
    shipper = {
        k.split(".", 1)[1]: int(metrics[f"counter.{k}"])
        for k in ship_keys if _is_num(metrics.get(f"counter.{k}"))
    }
    collect_keys = (
        "collect.batches", "collect.ingested", "collect.duplicates",
        "collect.duplicate_events", "collect.ingest_errors",
        "collect.recovered_streams", "collect.truncated_events",
    )
    collector = {
        k.split(".", 1)[1]: int(metrics[f"counter.{k}"])
        for k in collect_keys if _is_num(metrics.get(f"counter.{k}"))
    }
    if _is_num(metrics.get("gauge.collect.sources")):
        collector["sources"] = int(metrics["gauge.collect.sources"])
    if not markers and not shipper and not collector:
        return None
    per_source: Dict[str, Dict] = {}
    for e in markers:
        sid = str(e.get("source_id", "?"))
        rec = per_source.setdefault(sid, {
            "batches": 0, "events": 0,
            "replayed_batches": 0, "replayed_events": 0,
        })
        rec["batches"] += 1
        n = e.get("events")
        rec["events"] += int(n) if _is_num(n) else 0
        if e.get("replayed"):
            rec["replayed_batches"] += 1
            rec["replayed_events"] += int(n) if _is_num(n) else 0
        if _is_num(e.get("recv_ts")):
            recv = float(e["recv_ts"])
            if recv >= rec.get("last_recv_ts", float("-inf")):
                rec["last_recv_ts"] = recv
                if _is_num(e.get("sent_ts")):
                    rec["ship_lag_s"] = round(
                        recv - float(e["sent_ts"]), 6
                    )
    out: Dict = {}
    if shipper:
        out["shipper"] = shipper
    if collector:
        out["collector"] = collector
    if per_source:
        out["sources"] = {
            sid: per_source[sid] for sid in sorted(per_source)
        }
        out["replayed_events"] = sum(
            r["replayed_events"] for r in per_source.values()
        )
    return out


def _print_transport_health(th: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("transport health:", file=file)
    sh = th.get("shipper")
    if sh:
        print(
            f"  shipper: shipped={sh.get('shipped', 0)}  "
            f"spooled={sh.get('spooled', 0)}  "
            f"replayed={sh.get('ship_replayed', 0)}  "
            f"dropped={sh.get('dropped', 0)}  "
            f"ship_errors={sh.get('ship_errors', 0)}", file=file,
        )
    co = th.get("collector")
    if co:
        extra = ""
        if co.get("recovered_streams"):
            extra = (
                f"  recovered={co['recovered_streams']} "
                f"(truncated {co.get('truncated_events', 0)} event(s))"
            )
        print(
            f"  collector: batches={co.get('batches', 0)}  "
            f"events={co.get('ingested', 0)}  "
            f"dedup_suppressed={co.get('duplicates', 0)} batch(es)/"
            f"{co.get('duplicate_events', 0)} event(s)  "
            f"ingest_errors={co.get('ingest_errors', 0)}"
            + extra, file=file,
        )
    for sid, rec in (th.get("sources") or {}).items():
        lag = rec.get("ship_lag_s")
        lag_s = f"  lag={lag:+.3f}s" if lag is not None else ""
        rp = (
            f"  replayed={rec['replayed_events']}"
            if rec.get("replayed_batches") else ""
        )
        print(
            f"  source {sid}: {rec['batches']} batch(es), "
            f"{rec['events']} event(s){rp}{lag_s}", file=file,
        )


def _print_slo_health(slh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("slo health:", file=file)
    print(
        f"  objectives burning: {slh['objectives_burning']}  "
        f"(over {slh['evaluations']} evaluation(s))", file=file,
    )
    for o in slh.get("objectives", ()):
        parts = [f"status={o.get('status', '?')}"]
        if "total" in o:
            parts.append(f"total={int(o['total'])}")
        if o.get("good_fraction") is not None:
            parts.append(f"good={o['good_fraction']:.4f}")
        if o.get("budget_remaining") is not None:
            parts.append(f"budget={o['budget_remaining']:.1%}")
        mark = "  <<BURNING" if o.get("burning") else ""
        print(
            f"  objective {o['objective']}: "
            + "  ".join(parts) + mark, file=file,
        )


def _print_compile_health(ch: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("compile health:", file=file)
    c = ch["cache"]
    rate = (
        f"  hit rate: {c['hit_rate']:.1%}" if "hit_rate" in c else ""
    )
    print(
        f"  executable cache: {c['hits']} hit(s), {c['misses']} "
        f"miss(es), {c['stores']} store(s), {c['invalidations']} "
        f"invalidation(s){rate}", file=file,
    )
    if "time_to_first_dispatch_seconds" in ch:
        print(
            f"  time to first dispatch: "
            f"{ch['time_to_first_dispatch_seconds']:.3f}s", file=file,
        )
    if "retraces" in ch:
        print(f"  retraces: {ch['retraces']}", file=file)
    for lbl, rec in sorted(ch.get("by_label", {}).items()):
        parts = []
        if "cold_seconds" in rec:
            parts.append(
                f"cold compile {rec['cold_seconds']:.3f}s over "
                f"{rec['cold_first_calls']} first call(s)"
            )
        if "warm_seconds" in rec:
            parts.append(
                f"warm load {rec['warm_seconds']:.3f}s over "
                f"{rec['warm_first_calls']} first call(s)"
            )
        print(f"  label {lbl}: {'  '.join(parts)}", file=file)
    for inv in ch.get("invalidated", ()):
        print(
            f"  INVALIDATED {inv['digest']} ({inv['label']}): "
            f"{inv['reason']}", file=file,
        )


def _print_memory_health(mh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("memory health:", file=file)
    parts = []
    if "device_bytes_in_use" in mh:
        parts.append(
            f"device in use {_fmt_bytes(mh['device_bytes_in_use'])}"
        )
    if "device_peak_bytes_in_use" in mh:
        parts.append(
            f"peak {_fmt_bytes(mh['device_peak_bytes_in_use'])}"
        )
    if "device_bytes_limit" in mh:
        parts.append(
            f"limit {_fmt_bytes(mh['device_bytes_limit'])}"
        )
    if "host_rss_bytes" in mh:
        parts.append(f"host rss {_fmt_bytes(mh['host_rss_bytes'])}")
    if parts:
        print(
            "  " + "  ".join(parts)
            + (f"  ({mh['samples']} sample(s))"
               if "samples" in mh else ""),
            file=file,
        )
    pd = mh.get("per_device")
    if pd:
        imb = pd.get("imbalance")
        print(
            f"  per-device peak: max "
            f"{_fmt_bytes(pd.get('peak_max'))}  min "
            f"{_fmt_bytes(pd.get('peak_min'))}  imbalance "
            + (f"{imb:.1%}" if imb is not None else "-")
            + ("  <<IMBALANCED" if (imb or 0) > 0.5 else ""),
            file=file,
        )
    if mh.get("device_stats_unavailable"):
        print(
            f"  device stats unavailable: "
            f"{mh['device_stats_unavailable']} sample(s) (backend "
            f"reports no memory_stats — no data, not no pressure)",
            file=file,
        )


def _print_alert_health(ah: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("alert health:", file=file)
    print(
        f"  fired: {ah['fired']}  resolved: {ah['resolved']}  "
        f"pending: {ah['pending']}  actions: {ah['actions_emitted']}  "
        f"(over {ah['polls']} poll(s))", file=file,
    )
    for rule, states in sorted(ah.get("by_rule", {}).items()):
        parts = "  ".join(
            f"{s}: {n}" for s, n in sorted(states.items())
        )
        print(f"  rule {rule}: {parts}", file=file)
    for f_ in ah.get("still_firing", ()):
        key = f" [{f_['key']}]" if f_.get("key") else ""
        print(
            f"  STILL FIRING: {f_['rule']}{key} value="
            f"{f_.get('value')} threshold={f_.get('threshold')}",
            file=file,
        )
    for a in ah.get("actions", ()):
        print(
            f"  action: {a['kind']} (alert {a['alert']}"
            + (f" [{a['key']}]" if a.get("key") else "") + ")",
            file=file,
        )
    d = ah.get("drift")
    if d:
        print(
            f"  drift: kl={d.get('kl')} hellinger="
            f"{d.get('hellinger')}"
            + (f" @ epoch {d['epoch']}" if "epoch" in d else ""),
            file=file,
        )


def _print_serving_health(sh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("serving health:", file=file)
    lat = sh.get("request_seconds", {})
    lat_s = (
        f"  p50 {lat['p50'] * 1000:.1f}ms  p99 {lat['p99'] * 1000:.1f}ms"
        if "p50" in lat and "p99" in lat else ""
    )
    print(
        f"  requests: {sh['requests']}  batches: {sh['batches']}"
        f"{lat_s}", file=file,
    )
    if "batch_fill_mean" in sh:
        print(
            f"  batch fill: {sh['batch_fill_mean']:.1%} mean"
            + (
                f"  coalescer wait p50: "
                f"{sh['queue_seconds_p50'] * 1000:.1f}ms"
                if "queue_seconds_p50" in sh else ""
            ),
            file=file,
        )
    print(
        f"  hot-swaps: {sh['hot_swaps']}  swap failures: "
        f"{sh['swap_failures']}  quarantined: {sh['quarantined']}  "
        f"refused while draining: {sh['rejected_while_draining']}",
        file=file,
    )
    adm = sh.get("admission")
    if adm:
        parts = [
            f"{k.replace('.', ' ')} {v}" for k, v in sorted(adm.items())
        ]
        print(f"  admission: {'  '.join(parts)}", file=file)
    deg = sh.get("degraded")
    if deg:
        print(
            f"  degraded mode: {deg['responses']} response(s)  "
            f"entered {deg['entered']}x  exited {deg['exited']}x",
            file=file,
        )
    for cls, row in sorted(sh.get("classes", {}).items()):
        lat_c = (
            f"  p50 {row['p50'] * 1000:.1f}ms  "
            f"p99 {row['p99'] * 1000:.1f}ms"
            if "p50" in row and "p99" in row else ""
        )
        print(
            f"  class {cls}: {int(row.get('count', 0))} doc(s)"
            f"{lat_c}", file=file,
        )
    for s in sh.get("swap_history", ()):
        print(
            f"  swap: {s['from']} -> {s['to']} (epoch {s['epoch']})",
            file=file,
        )
    w = sh.get("warmup")
    if w:
        print(
            f"  warmup: buckets {w.get('buckets')} in "
            f"{w.get('warmup_seconds')}s", file=file,
        )
    if "retraces_after_warmup" in sh:
        print(
            f"  recompiles after warmup: {sh['retraces_after_warmup']}",
            file=file,
        )
    for r in sh.get("executables", ()):
        print(
            f"  executable {r['label']} [{r['digest']}]: "
            f"{r['calls']} dispatch(es), compile "
            f"{r['compile_seconds']}s", file=file,
        )


def _print_serve_fleet_health(sfh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("serve fleet health (front):", file=file)
    lat = sfh.get("request_seconds", {})
    lat_s = (
        f"  p50 {lat['p50'] * 1000:.1f}ms  p99 {lat['p99'] * 1000:.1f}ms"
        if "p50" in lat and "p99" in lat else ""
    )
    print(
        f"  requests: {sfh['requests']}  retries: {sfh['retries']}  "
        f"no-replica: {sfh['no_replica']}  repins: {sfh['repins']}"
        f"{lat_s}",
        file=file,
    )
    ov = sfh.get("overload")
    if ov:
        print(
            f"  overload: shed {ov['shed']}  replica-429s propagated "
            f"{ov['rejected']}  retry budget exhausted "
            f"{ov['retry_budget_exhausted']}",
            file=file,
        )
    for r in sfh.get("replicas", ()):
        p99 = (
            f"  p99 {r['p99_seconds'] * 1000:.1f}ms"
            if "p99_seconds" in r else ""
        )
        print(
            f"  replica {r['replica']}: {r['requests']} request(s) "
            f"({r['share']:.1%} share)  retries {r['retries']}{p99}",
            file=file,
        )
    if "p99_spread_seconds" in sfh:
        print(
            f"  p99 spread across replicas: "
            f"{sfh['p99_spread_seconds'] * 1000:.1f}ms", file=file,
        )
    for s in sfh.get("swaps_observed", ()):
        print(
            f"  swap to {s['stamp']}: {s['replicas']} replica(s), "
            f"lag {s['swap_lag_seconds']:.3f}s first->last", file=file,
        )


def _print_fleet_health(fh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("fleet health:", file=file)
    w = fh.get("workers")
    if w:
        print(
            f"  workers over time: min {w['min']}  max {w['max']}  "
            f"final {w['final']}  ({w['sweeps']} sweeps)", file=file,
        )
    print(
        f"  spawns: {fh['spawns']}  respawns: {fh['respawns']}  "
        f"crashes: {fh['crashes']}", file=file,
    )
    print(
        f"  resizes: {fh['resizes']}  preemptions survived: "
        f"{fh['preemptions']}  lease expiries: {fh['lease_expiries']}",
        file=file,
    )
    for r in fh.get("resize_history", ()):
        print(
            f"  resize: {r['from']} -> {r['to']} ({r['why']})",
            file=file,
        )
    if "mean_lease_slack_seconds" in fh:
        print(
            f"  lease slack: mean {fh['mean_lease_slack_seconds']:.3f}s"
            f"  min {fh['min_lease_slack_seconds']:.3f}s", file=file,
        )
    if "swap_rolls" in fh:
        print(
            f"  rolling swaps: {fh['swap_rolls']}  replica swaps: "
            f"{fh['replica_swaps']}"
            + (
                f"  max swap lag {fh['swap_lag_seconds_max']:.3f}s "
                f"first->last"
                if "swap_lag_seconds_max" in fh else ""
            )
            + (
                f"  stalls: {fh['swap_stalls']}"
                if "swap_stalls" in fh else ""
            ),
            file=file,
        )
    if fh.get("converged"):
        print(
            f"  converged: yes"
            + (
                f" ({fh['committed_epochs']} committed epochs)"
                if "committed_epochs" in fh else ""
            ),
            file=file,
        )


def _print_ledger_health(lh: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    print("ledger health:", file=file)
    print(
        f"  commits: {lh['commits']}  rollbacks: {lh['rollbacks']}  "
        f"rollback_rate: {lh['rollback_rate']:.2%}", file=file,
    )
    if "commit_cadence_seconds" in lh:
        print(
            f"  commit cadence: {lh['commit_cadence_seconds']:.3f} "
            f"s/epoch (mean over {lh['commits']} commits)", file=file,
        )
    for k, n in sorted(lh.get("commits_by_kind", {}).items()):
        print(f"  commits[{k}]: {n}", file=file)
    for r, n in sorted(lh.get("rollbacks_by_reason", {}).items()):
        print(f"  rollbacks[{r}]: {n}", file=file)
    print(f"  replays suppressed: {lh['replays_suppressed']}", file=file)


def _print_manifest(manifest: Dict, file=None) -> None:
    file = file if file is not None else sys.stdout
    if not manifest:
        print("  (no manifest record)", file=file)
        return
    keys = ("run_id", "schema", "algorithm", "backend", "device_count",
            "mesh_shape", "vocab_width", "config_hash", "git_rev",
            "host", "kind", "source_format")
    for k in keys:
        if k in manifest:
            print(f"  {k}: {manifest[k]}", file=file)


def cmd_summarize(args) -> int:
    try:
        return _cmd_summarize(args)
    except BrokenPipeError:      # `... | head` closed the pipe
        return 0


def _cmd_summarize(args) -> int:
    manifest, events = load_run(args.run)
    metrics = run_metrics(events)
    lh = ledger_health(events)
    fh = fleet_health(events)
    sfh = serve_fleet_health(events, metrics)
    sh = serving_health(events, metrics)
    ah = alert_health(events, metrics)
    slh = slo_health(events, metrics)
    ch = compile_health(events, metrics)
    mh = memory_health(metrics)
    th = transport_health(events, metrics)
    if getattr(args, "json", False):
        doc = {"manifest": manifest, "metrics": metrics}
        if lh is not None:
            doc["ledger_health"] = lh
        if fh is not None:
            doc["fleet_health"] = fh
        if sfh is not None:
            doc["serve_fleet_health"] = sfh
        if sh is not None:
            doc["serving_health"] = sh
        if ah is not None:
            doc["alert_health"] = ah
        if slh is not None:
            doc["slo_health"] = slh
        if ch is not None:
            doc["compile_health"] = ch
        if mh is not None:
            doc["memory_health"] = mh
        if th is not None:
            doc["transport_health"] = th
        print(json.dumps(doc, sort_keys=True))
        return 0
    print(f"run: {args.run}")
    print("manifest:")
    _print_manifest(manifest)
    print(f"events: {len(events)}")
    if lh is not None:
        _print_ledger_health(lh)
    if fh is not None:
        _print_fleet_health(fh)
    if sfh is not None:
        _print_serve_fleet_health(sfh)
    if sh is not None:
        _print_serving_health(sh)
    if ah is not None:
        _print_alert_health(ah)
    if slh is not None:
        _print_slo_health(slh)
    if ch is not None:
        _print_compile_health(ch)
    if mh is not None:
        _print_memory_health(mh)
    if th is not None:
        _print_transport_health(th)
    print("metrics:")
    for k in sorted(metrics):
        v = metrics[k]
        vs = f"{v:.6g}" if abs(v) < 1e6 else f"{v:.4e}"
        print(f"  {k} = {vs}")
    return 0


def _render_event(e: Dict) -> str:
    """One compact line per tailed event (the `metrics tail` view)."""
    import datetime

    ts = e.get("ts")
    if _is_num(ts):
        stamp = datetime.datetime.fromtimestamp(float(ts)).strftime(
            "%H:%M:%S.%f"
        )[:-3]
    else:
        stamp = "--:--:--.---"
    name = str(e.get("event", "?"))
    stream = str(e.get("_stream", ""))
    parts = []
    for k in sorted(e):
        if k in ("event", "ts", "_stream"):
            continue
        v = e[k]
        if isinstance(v, float):
            vs = f"{v:.6g}"
        elif isinstance(v, (dict, list)):
            vs = json.dumps(v)
        else:
            vs = str(v)
        if len(vs) > 48:
            vs = vs[:45] + "..."
        parts.append(f"{k}={vs}")
    head = f"{stamp} [{stream}] {name}" if stream else f"{stamp} {name}"
    return f"{head}  " + " ".join(parts) if parts else head


def cmd_tail(args) -> int:
    """Live follow-mode rendering of run stream(s): the `stc top`-style
    operator view, sharing the monitor's torn-line/truncation tolerant
    tailing machinery.  Ctrl-C exits cleanly."""
    import time as _time

    from ..resilience.retry import sleep as _sleep
    from .alerts import StreamSet

    streams = StreamSet(list(args.runs), from_start=not args.end)
    deadline = (
        _time.monotonic() + args.max_seconds
        if args.max_seconds is not None else None
    )
    shown = 0
    try:
        while True:
            for e in streams.poll():
                print(_render_event(e), flush=False)
                shown += 1
            sys.stdout.flush()
            if args.once:
                break
            if deadline is not None and _time.monotonic() >= deadline:
                break
            _sleep(args.interval)
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    try:
        print(f"# tailed {shown} event(s)", file=sys.stderr)
    except BrokenPipeError:
        pass
    return 0


def cmd_diff(args) -> int:
    try:
        return _cmd_diff(args)
    except BrokenPipeError:      # `... | head` closed the pipe
        return 0


def _cmd_diff(args) -> int:
    _, ev_a = load_run(args.a)
    _, ev_b = load_run(args.b)
    ma, mb = run_metrics(ev_a), run_metrics(ev_b)
    keys = sorted(set(ma) | set(mb))
    rows = []
    for k in keys:
        a, b = ma.get(k), mb.get(k)
        if a is None or b is None:
            rows.append((k, a, b, None))
            continue
        ratio = b / a if abs(a) > _EPS else math.inf if b else 1.0
        rows.append((k, a, b, ratio))
    if getattr(args, "json", False):
        print(json.dumps(
            {k: {"a": a, "b": b, "ratio": r} for k, a, b, r in rows},
            sort_keys=True,
        ))
        return 0
    w = max((len(k) for k, *_ in rows), default=10)
    print(f"{'metric'.ljust(w)}  {'a':>14}  {'b':>14}  {'b/a':>8}")
    changed = 0
    for k, a, b, r in rows:
        fa = "-" if a is None else f"{a:.6g}"
        fb = "-" if b is None else f"{b:.6g}"
        fr = "-" if r is None else f"{r:.3f}"
        mark = ""
        if r is not None and abs(r - 1.0) > args.highlight:
            mark = "  <<"
            changed += 1
        elif r is None:
            mark = "  <<only-one-side"
            changed += 1
        print(f"{k.ljust(w)}  {fa:>14}  {fb:>14}  {fr:>8}{mark}")
    print(f"# {len(rows)} metrics, {changed} changed beyond "
          f"±{args.highlight:.0%} (or one-sided)")
    return 0


# bench-diff: name-hint direction heuristics — which way is "worse"?
# (unknown-direction metrics are reported but never gate)
_BENCH_LOWER_BETTER = (
    "seconds", "_ms", "_s_", "bytes", "errors", "failures", "dropped",
    "retries", "retraces", "giveups", "lag",
)
_BENCH_HIGHER_BETTER = (
    "per_s", "per_sec", "throughput", "docs_per", "hit_rate", "hits",
)


def _bench_direction(name: str) -> Optional[str]:
    """``"lower"``/``"higher"`` = which value is BETTER, None = no
    opinion.  Higher-better hints win ties ("cache_hits_per_s" is a
    rate even though "hits" alone would also match)."""
    n = name.lower()
    if any(h in n for h in _BENCH_HIGHER_BETTER):
        return "higher"
    if any(h in n for h in _BENCH_LOWER_BETTER):
        return "lower"
    return None


def cmd_bench_diff(args) -> int:
    try:
        return _cmd_bench_diff(args)
    except BrokenPipeError:      # `... | head` closed the pipe
        return 0


def _cmd_bench_diff(args) -> int:
    """Compare two BENCH_*.json records (or bench event streams) with
    per-section relative-change columns and an optional regression
    gate — the perf-trajectory view `metrics diff`'s flat ratio table
    was never built for."""
    _, ev_a = load_run(args.a)
    _, ev_b = load_run(args.b)
    ma, mb = run_metrics(ev_a), run_metrics(ev_b)
    # BENCH records flatten under "bench."; restrict to that namespace
    # when either side has it so stray events.* counts don't pollute
    # the perf table.  Plain event streams compare whole.
    if any(k.startswith("bench.") for k in (*ma, *mb)):
        ma = {k: v for k, v in ma.items() if k.startswith("bench.")}
        mb = {k: v for k, v in mb.items() if k.startswith("bench.")}
    rows = []
    for k in sorted(set(ma) | set(mb)):
        a, b = ma.get(k), mb.get(k)
        delta_pct = None
        if a is not None and b is not None:
            delta_pct = (
                (b - a) / abs(a) * 100.0 if abs(a) > _EPS
                else (0.0 if abs(b) <= _EPS else math.inf)
            )
        direction = _bench_direction(k)
        worse = None
        if delta_pct is not None and direction is not None:
            worse = (
                delta_pct if direction == "lower" else -delta_pct
            )
        # section = first meaningful component: strip the "bench."
        # namespace and the "record" wrapper whole-file BENCH JSON
        # flattens through, so `bench.record.assign.seconds` and a
        # bench-stream's `bench.assign.seconds` both land in [assign]
        parts = k.split(".")
        if parts and parts[0] == "bench":
            parts = parts[1:]
        if len(parts) > 1 and parts[0] == "record":
            parts = parts[1:]
        sec = parts[0] if len(parts) > 1 else "(top)"
        rows.append({
            "metric": k, "section": sec, "a": a, "b": b,
            "delta_pct": delta_pct, "direction": direction,
            "worse_pct": worse,
        })
    rows.sort(key=lambda r: (r["section"], r["metric"]))
    thresh = args.fail_on_regression
    regressions = [
        r for r in rows
        if thresh is not None and r["worse_pct"] is not None
        and r["worse_pct"] > thresh
    ]
    if getattr(args, "json", False):
        sections: Dict[str, List[Dict]] = {}
        for r in rows:
            sections.setdefault(r["section"], []).append({
                k: v for k, v in r.items() if k != "section"
            })
        print(json.dumps({
            "a": args.a, "b": args.b,
            "sections": sections,
            "regressions": [r["metric"] for r in regressions],
            "fail_on_regression_pct": thresh,
        }, sort_keys=True))
        return 1 if regressions else 0
    w = max((len(r["metric"]) for r in rows), default=10)
    print(f"bench diff: a={args.a}  b={args.b}")
    last_sec = None
    for r in rows:
        if r["section"] != last_sec:
            last_sec = r["section"]
            print(f"[{last_sec}]")
        fa = "-" if r["a"] is None else f"{r['a']:.6g}"
        fb = "-" if r["b"] is None else f"{r['b']:.6g}"
        if r["delta_pct"] is None:
            fd = "only-one-side"
        else:
            fd = f"{r['delta_pct']:+.1f}%"
        dirmark = {"lower": "v better", "higher": "^ better",
                   None: ""}[r["direction"]]
        mark = ""
        if thresh is not None and r["worse_pct"] is not None \
                and r["worse_pct"] > thresh:
            mark = "  <<REGRESSION"
        print(f"  {r['metric'].ljust(w)}  {fa:>14}  {fb:>14}  "
              f"{fd:>14}  {dirmark:<8}{mark}")
    if thresh is not None:
        print(
            f"# {len(rows)} metrics, {len(regressions)} regression(s) "
            f"beyond {thresh:g}% in the worse direction"
        )
        if regressions:
            return 1
    else:
        print(f"# {len(rows)} metrics")
    return 0


def _capture_baseline(
    run_path: str, metrics: Dict[str, float], default_tol: float,
    exclude: List[str],
) -> Dict:
    entries = {}
    for k, v in sorted(metrics.items()):
        if any(s in k for s in exclude):
            continue
        tol = default_tol
        if any(h in k for h in _TIMING_HINTS):
            tol = max(tol, 0.5)
        entries[k] = {"value": v, "tolerance": tol}
    return {
        "schema": 1,
        "source": run_path,
        "default_tolerance": default_tol,
        "metrics": entries,
    }


def cmd_check(args) -> int:
    _, events = load_run(args.run)
    metrics = run_metrics(events)
    exclude = list(args.exclude or [])
    include = list(getattr(args, "include", None) or [])

    def selected(name: str) -> bool:
        if include and not any(s in name for s in include):
            return False
        return not any(s in name for s in exclude)

    if args.write_baseline:
        base = _capture_baseline(
            args.run,
            {k: v for k, v in metrics.items() if selected(k)},
            args.tolerance, [],
        )
        if include and os.path.exists(args.baseline):
            # partial capture: refresh ONLY the included families inside
            # an existing baseline (how ci_check folds lint.* counters
            # into the shared ci_metrics_baseline.json without clobbering
            # the training-run entries)
            try:
                with open(args.baseline, "r", encoding="utf-8") as f:
                    prev = json.load(f)
            except (OSError, json.JSONDecodeError) as exc:
                print(f"cannot merge into baseline {args.baseline}: {exc}",
                      file=sys.stderr)
                return 2
            kept = {
                k: v for k, v in prev.get("metrics", {}).items()
                if not any(s in k for s in include)
            }
            kept.update(base["metrics"])
            prev["metrics"] = kept
            base = prev
        with open(args.baseline, "w", encoding="utf-8") as f:
            json.dump(base, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"baseline captured: {args.baseline} "
              f"({len(base['metrics'])} metrics)")
        return 0

    try:
        with open(args.baseline, "r", encoding="utf-8") as f:
            base = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"cannot read baseline {args.baseline}: {exc}",
              file=sys.stderr)
        return 2
    failures = []
    checked = 0
    for k, spec in sorted(base.get("metrics", {}).items()):
        if not selected(k):
            continue
        want = spec.get("value")
        tol = spec.get(
            "tolerance", base.get("default_tolerance", args.tolerance)
        )
        got = metrics.get(k)
        checked += 1
        if got is None:
            failures.append((k, want, None, tol, "missing from run"))
            continue
        if abs(got - want) > tol * max(abs(want), _EPS):
            failures.append((k, want, got, tol, "out of tolerance"))
    for k, want, got, tol, why in failures:
        gs = "-" if got is None else f"{got:.6g}"
        print(f"FAIL {k}: baseline {want:.6g}, run {gs} "
              f"(tolerance ±{tol:.0%}) — {why}")
    status = "FAIL" if failures else "PASS"
    print(f"{status}: {checked - len(failures)}/{checked} metrics "
          f"within tolerance vs {args.baseline}")
    return 1 if failures else 0


def cmd_slo(args) -> int:
    """``stc metrics slo``: evaluate the SLO set over recorded run
    stream(s) at event time — budget remaining, burn rates per window,
    and a status roll-up per objective.  ``--fail-on-burn`` exits 1
    when any objective is burning or exhausted (the CI gate)."""
    from .slo import builtin_config, config_from_dict, evaluate_all

    try:
        if args.slo:
            with open(args.slo, "r", encoding="utf-8") as f:
                cfg = config_from_dict(json.load(f))
            if args.compression is not None:
                cfg.compression = float(args.compression)
        else:
            cfg = builtin_config(
                compression=float(args.compression or 1.0)
            )
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    pairs: List[Tuple[float, Dict]] = []
    for path in args.runs:
        try:
            _, events = load_run(path)
        except OSError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        for e in events:
            if _is_num(e.get("ts")):
                pairs.append((float(e["ts"]), e))
    if not pairs:
        print("no timestamped events in the given run stream(s)",
              file=sys.stderr)
        return 2
    # event-time evaluation, same discipline as `monitor --once`: the
    # verdict depends on the recorded stream, not on when it runs
    now = max(ts for ts, _ in pairs) + 1e-6
    results = evaluate_all(cfg, pairs, now)
    bad = sorted(
        n for n, r in results.items()
        if r["burning"] or r["status"] == "exhausted"
    )
    if getattr(args, "json", False):
        print(json.dumps(
            {"now": now, "burning": bad, "objectives": results},
            sort_keys=True,
        ))
        return 1 if args.fail_on_burn and bad else 0
    wname = max(
        (len(n) for n in results), default=9
    )
    print(f"{'objective'.ljust(wname)}  {'status':>9}  {'good/total':>13}"
          f"  {'budget':>7}  burn(windows)")
    for name, r in sorted(results.items()):
        gt = f"{r['good']}/{r['total']}" if r["total"] else "-"
        budget = (
            f"{r['budget_remaining']:.1%}"
            if r["budget_remaining"] is not None else "-"
        )
        burns = "  ".join(
            f"{w['name']}={w['burn']:.2f}x"
            + ("!" if w["burning"] else "")
            if w["burn"] is not None else f"{w['name']}=-"
            for w in r["windows"]
        )
        mark = "  <<BURNING" if name in bad else ""
        print(f"{name.ljust(wname)}  {r['status']:>9}  {gt:>13}"
              f"  {budget:>7}  {burns}{mark}")
    if bad:
        print(f"# {len(bad)} objective(s) burning: {', '.join(bad)}")
    if args.fail_on_burn and bad:
        return 1
    return 0


def _fmt_rate(v: Optional[float], unit: str) -> str:
    if v is None:
        return "-"
    return f"{v / 1e9:.2f} G{unit}"


def _fmt_bytes(v) -> str:
    if not _is_num(v):
        return "-"
    for scale, suffix in ((2**30, "G"), (2**20, "M"), (2**10, "K")):
        if v >= scale:
            return f"{v / scale:.1f}{suffix}"
    return f"{int(v)}B"


def cmd_roofline(args) -> int:
    try:
        return _cmd_roofline(args)
    except BrokenPipeError:      # `... | head` closed the pipe
        return 0


def _cmd_roofline(args) -> int:
    from .roofline import resolve_peaks, rows_from_run

    manifest, events = load_run(args.run)
    metrics = run_metrics(events)
    override = None
    if args.peaks:
        try:
            with open(args.peaks, "r", encoding="utf-8") as f:
                override = json.load(f)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"cannot read peaks table {args.peaks}: {exc}",
                  file=sys.stderr)
            return 2
    key, peaks = resolve_peaks(
        str(manifest.get("backend", "")),
        str(manifest.get("device_kind", "")),
        override,
    )
    rows = rows_from_run(manifest, metrics, events, peaks)
    if getattr(args, "json", False):
        print(json.dumps({
            "run": args.run, "peaks_key": key, "peaks": peaks,
            "rows": rows,
        }, sort_keys=True))
        return 0
    if not rows:
        print(
            "no dispatch_executable events in this run — was the run "
            "produced with --telemetry-file by an instrumented command?",
            file=sys.stderr,
        )
        return 2
    print(f"run: {args.run}")
    hbm_note = (
        f", {peaks['hbm_bytes'] / 2**30:.0f} GiB HBM"
        if peaks.get("hbm_bytes") else ""
    )
    print(
        f"peaks [{key}]: {peaks['flops_per_s'] / 1e12:.1f} TFLOP/s, "
        f"{peaks['bytes_per_s'] / 1e9:.0f} GB/s{hbm_note} — "
        f"{peaks['note']}"
    )
    w = max(len(r["label"]) for r in rows)
    print(
        f"{'label'.ljust(w)}  {'digest':>10}  {'calls':>6}  "
        f"{'seconds':>9}  {'GFLOP/s':>9}  {'%peak':>6}  {'GB/s':>8}  "
        f"{'%bw':>6}  {'%roof':>6}  {'bound':>7}  {'peak_mem':>9}  "
        f"{'%hbm':>6}"
    )

    def _hbm_cell(r):
        hf = r.get("hbm_frac")
        return f"{hf:.1%}" if hf is not None else "-"

    for r in rows:
        mem = _fmt_bytes(r.get("mem_peak_bytes"))
        if not r["available"]:
            print(
                f"{r['label'].ljust(w)}  {r['digest']:>10}  "
                f"{r['calls']:>6}  {r['seconds']:>9.4f}  "
                f"[unavailable: {r['why_unavailable']}]  "
                f"peak_mem={mem}  %hbm={_hbm_cell(r)}"
            )
            continue
        fb = r.get("frac_peak_bytes")
        print(
            f"{r['label'].ljust(w)}  {r['digest']:>10}  {r['calls']:>6}  "
            f"{r['seconds']:>9.4f}  "
            f"{r['achieved_flops_per_s'] / 1e9:>9.2f}  "
            f"{r['frac_peak_flops']:>6.1%}  "
            f"{_fmt_rate(r.get('achieved_bytes_per_s'), 'B/s'):>8}  "
            f"{(f'{fb:.1%}' if fb is not None else '-'):>6}  "
            f"{r['roofline_frac']:>6.1%}"
            f"{'!' if r.get('overunity') else ' '}  "
            f"{r.get('bound', '-'):>6}  {mem:>9}  "
            f"{_hbm_cell(r):>6}"
        )
    n_avail = sum(1 for r in rows if r["available"])
    print(
        f"# {len(rows)} executable(s), {n_avail} with a full roofline "
        f"join (worst-first by % of attainable); '!' = over-unity: the "
        f"measured window missed device time (unsynced async dispatch) "
        f"or the peaks understate this host; %hbm = memory_analysis "
        f"peak vs the backend's per-chip HBM (same hbm_bytes column "
        f"the static scale audit budgets against)"
    )
    return 0


def cmd_compile_check(args) -> int:
    from .compilation import (
        check_counts,
        counts_from_run,
        load_baseline,
        write_baseline,
    )

    per_label: Dict[str, set] = {}
    for path in args.runs:
        try:
            _, events = load_run(path)
        except OSError as exc:
            print(f"cannot read run {path}: {exc}", file=sys.stderr)
            return 2
        for lbl, digests in counts_from_run(
            events, run_metrics(events)
        ).items():
            per_label.setdefault(lbl, set()).update(digests)
    counts = {lbl: len(ds) for lbl, ds in sorted(per_label.items())}

    if args.write_baseline:
        prev = None
        if os.path.exists(args.baseline):
            try:
                prev = load_baseline(args.baseline)
            except (OSError, json.JSONDecodeError, ValueError) as exc:
                print(
                    f"cannot merge into baseline {args.baseline}: {exc}",
                    file=sys.stderr,
                )
                return 2
        base = write_baseline(
            args.baseline, counts, source=" ".join(args.runs),
            previous=prev,
        )
        print(
            f"compile baseline captured: {args.baseline} "
            f"({len(base['labels'])} label(s))"
        )
        return 0

    try:
        baseline = load_baseline(args.baseline)
    except (OSError, json.JSONDecodeError, ValueError) as exc:
        print(f"cannot read baseline {args.baseline}: {exc}",
              file=sys.stderr)
        return 2
    finds = check_counts(counts, baseline)
    allowed = baseline.get("labels", {})
    w = max((len(x) for x in counts), default=5)
    print(f"{'label'.ljust(w)}  {'signatures':>10}  {'allowed':>7}")
    for lbl, n in counts.items():
        a = allowed.get(lbl)
        mark = ""
        if a is None:
            mark = "  <<unknown-label"
        elif n > int(a):
            mark = "  <<RETRACE STORM"
        print(f"{lbl.ljust(w)}  {n:>10}  "
              f"{('-' if a is None else a):>7}{mark}")
    for f in finds:
        if f["kind"] == "retrace_storm":
            print(
                f"FAIL {f['label']}: {f['signatures']} distinct compiled "
                f"signatures, baseline allows {f['allowed']} — an "
                f"unbucketed shape is re-tracing this hot loop"
            )
        else:
            print(
                f"FAIL {f['label']}: dispatch label not in "
                f"{args.baseline} — commit its expected signature count "
                f"deliberately (--write-baseline)"
            )
    status = "FAIL" if finds else "PASS"
    print(
        f"{status}: {len(counts) - len(finds)}/{len(counts)} label(s) "
        f"within the committed signature baseline"
    )
    return 1 if finds else 0


def cmd_scale_check(args) -> int:
    """Exit 2: the measured-scale observatory and its static scale record
    are ROADMAP item 10 (the port refuses what it has not ported)."""
    print("error: metrics scale-check is not ported yet (ROADMAP.md "
          "queue 1 item 10, the audit tiers)", file=sys.stderr)
    return 2


def add_metrics_subparser(sub) -> None:
    """Attach the ``metrics`` subcommand tree to the CLI's subparsers."""
    mt = sub.add_parser(
        "metrics",
        help="summarize / diff / regression-check telemetry runs",
    )
    msub = mt.add_subparsers(dest="metrics_cmd", required=True)

    sm = msub.add_parser("summarize", help="manifest + metrics of a run")
    sm.add_argument("run", help="telemetry .jsonl (or a BENCH_*.json)")
    sm.add_argument("--json", action="store_true")
    sm.set_defaults(fn=cmd_summarize)

    tl = msub.add_parser(
        "tail",
        help="live follow-mode rendering of run stream(s) — operator "
             "visibility without the alert engine (shares the "
             "monitor's torn-line tolerant tailing machinery)",
    )
    tl.add_argument(
        "runs", nargs="+",
        help="telemetry .jsonl stream(s) or glob patterns "
             "(re-expanded every poll)",
    )
    tl.add_argument(
        "--interval", type=float, default=0.5,
        help="seconds between polls",
    )
    tl.add_argument(
        "--end", action="store_true",
        help="start at the current end of each stream (default: "
             "render history first, then follow)",
    )
    tl.add_argument(
        "--once", action="store_true",
        help="render the current content and exit (no follow)",
    )
    tl.add_argument(
        "--max-seconds", type=float, default=None,
        help="stop following after this long (drills/tests); "
             "default: until Ctrl-C",
    )
    tl.set_defaults(fn=cmd_tail)

    df = msub.add_parser("diff", help="align two runs metric-by-metric")
    df.add_argument("a")
    df.add_argument("b")
    df.add_argument("--json", action="store_true")
    df.add_argument(
        "--highlight", type=float, default=0.1,
        help="mark metrics whose ratio moved beyond this fraction",
    )
    df.set_defaults(fn=cmd_diff)

    bd = msub.add_parser(
        "bench-diff",
        help="compare two BENCH_*.json records (or bench event "
             "streams) section by section with relative-change "
             "columns and a regression gate — the perf trajectory, "
             "not just a flat ratio table",
    )
    bd.add_argument("a", help="baseline BENCH record / run stream")
    bd.add_argument("b", help="candidate BENCH record / run stream")
    bd.add_argument("--json", action="store_true")
    bd.add_argument(
        "--fail-on-regression", type=float, default=None,
        metavar="PCT",
        help="exit 1 when any known-direction metric moved more than "
             "PCT%% in the WORSE direction (seconds/bytes/errors up, "
             "throughput down); unknown-direction metrics never gate",
    )
    bd.set_defaults(fn=cmd_bench_diff)

    ck = msub.add_parser(
        "check", help="gate a run against a baseline JSON"
    )
    ck.add_argument("run")
    ck.add_argument("--baseline", required=True)
    ck.add_argument(
        "--tolerance", type=float, default=0.25,
        help="default relative band for metrics without their own",
    )
    ck.add_argument(
        "--write-baseline", action="store_true",
        help="capture the run's metrics INTO --baseline instead of "
             "checking (timing-like metrics get a wider default band)",
    )
    ck.add_argument(
        "--exclude", action="append", default=[],
        help="skip metrics whose name contains this substring "
             "(repeatable)",
    )
    ck.add_argument(
        "--include", action="append", default=[],
        help="check ONLY metrics whose name contains this substring "
             "(repeatable); with --write-baseline and an existing "
             "baseline, refresh just these families in place",
    )
    ck.set_defaults(fn=cmd_check)

    sl = msub.add_parser(
        "slo",
        help="evaluate SLO objectives over recorded run stream(s) at "
             "event time: budget remaining, multi-window burn rates, "
             "per-objective status (docs/OBSERVABILITY.md \"SLOs & "
             "error budgets\")",
    )
    sl.add_argument(
        "runs", nargs="+",
        help="telemetry .jsonl stream(s) carrying front_request / "
             "probe_request events (front, probe, or monitor runs; "
             "evaluated together on one timeline)",
    )
    sl.add_argument(
        "--slo", default=None,
        help="JSON SLO objective file (same format as `stc monitor "
             "--slo`); default: the built-in objective set",
    )
    sl.add_argument(
        "--compression", type=float, default=None,
        help="divide every burn/budget window by N (must match the "
             "monitor run being reproduced)",
    )
    sl.add_argument("--json", action="store_true")
    sl.add_argument(
        "--fail-on-burn", action="store_true",
        help="exit 1 when any objective is burning or its budget is "
             "exhausted (the CI gate)",
    )
    sl.set_defaults(fn=cmd_slo)

    mg = msub.add_parser(
        "merge",
        help="fold N per-process run streams into one logical run "
             "with a cross-host skew report",
    )
    mg.add_argument(
        "runs", nargs="+",
        help="per-process telemetry .jsonl streams (events-p<idx>.jsonl)",
    )
    mg.add_argument("--json", action="store_true")
    mg.add_argument(
        "--skew-threshold", type=float, default=0.5,
        help="relative (max-min)/|median| width beyond which a "
             "cross-process metric counts as skewed",
    )
    mg.add_argument(
        "--fail-on-skew", action="store_true",
        help="exit 1 when the skew report is non-empty (the CI gate)",
    )
    mg.set_defaults(fn=cmd_merge)

    tc = msub.add_parser(
        "trace",
        help="export run stream(s) as Perfetto-loadable Chrome "
             "trace_event JSON (one track per process)",
    )
    tc.add_argument("runs", nargs="+")
    tc.add_argument(
        "--out", default=None,
        help="write the trace here (default: stdout)",
    )
    tc.add_argument(
        "--causal", action="store_true",
        help="one shared timeline with lease-anchored clock "
             "CORRECTIONS and Perfetto flow events joining the causal "
             "span chain (supervisor -> worker -> serve) across "
             "process tracks",
    )
    tc.set_defaults(fn=cmd_trace)

    rf = msub.add_parser(
        "roofline",
        help="achieved-vs-peak FLOP/s and bytes/s per compiled "
             "executable, worst-first (joins measured dispatch seconds "
             "with cost-analysis estimates and a per-backend peaks "
             "table)",
    )
    rf.add_argument("run", help="telemetry .jsonl from an instrumented run")
    rf.add_argument("--json", action="store_true")
    rf.add_argument(
        "--peaks", default=None,
        help="JSON file {flops_per_s, bytes_per_s[, note]} overriding "
             "the built-in per-backend peaks table",
    )
    rf.set_defaults(fn=cmd_roofline)

    cc = msub.add_parser(
        "compile-check",
        help="recompile sentinel gate: distinct compiled signatures "
             "per dispatch label checked against the committed "
             "scripts/records/compile_baseline.json",
    )
    cc.add_argument(
        "runs", nargs="+",
        help="telemetry .jsonl stream(s); label signature sets are "
             "unioned across them (e.g. one train + one score run)",
    )
    cc.add_argument("--baseline", required=True)
    cc.add_argument(
        "--write-baseline", action="store_true",
        help="capture the observed per-label signature counts INTO "
             "--baseline (merging over existing labels) instead of "
             "checking",
    )
    cc.set_defaults(fn=cmd_compile_check)

    sc = msub.add_parser(
        "scale-check",
        help="measured-scale observatory gate: run (or load) the "
             "dryrun-mesh probe of the vocab-sharded entry families "
             "and reconcile measured per-chip peak bytes, collective "
             "bytes, and executable shardings against the committed "
             "static scale record (scripts/records/"
             "scale_baseline.json), with a V=10M extrapolation row "
             "against the HBM budget",
    )
    sc.add_argument(
        "probe", nargs="?", default=None,
        help="probe evidence JSON from an earlier run "
             "(scale-check --run --probe-out writes one)",
    )
    sc.add_argument(
        "--run", action="store_true",
        help="execute the probe now on this process's devices "
             "(forces a model-sharded dryrun mesh; the CI gate runs "
             "this under the 8-virtual-device host platform)",
    )
    sc.add_argument(
        "--entries", action="append", default=[],
        help="probe only these entry families (repeatable; default: "
             "all vocab-sharded families)",
    )
    sc.add_argument(
        "--probe-out", default=None,
        help="with --run: also write the probe evidence JSON here",
    )
    sc.add_argument(
        "--baseline",
        default=os.path.join(
            "scripts", "records", "scale_baseline.json"
        ),
        help="the committed static scale record to reconcile against",
    )
    sc.add_argument(
        "--tolerance", type=float, default=None,
        help="relative band by which measured per-chip peak bytes may "
             "EXCEED the static estimate (default: the committed "
             "scale_probe.PEAK_TOLERANCE)",
    )
    sc.add_argument(
        "--collective-tolerance", type=float, default=None,
        help="same band for measured collective bytes per step",
    )
    sc.add_argument(
        "--fail-on-divergence", action="store_true",
        help="exit 1 on any divergence / sharding mismatch / retrace "
             "/ over-budget extrapolation / measured-record drift "
             "(the CI gate)",
    )
    sc.add_argument(
        "--write-record", action="store_true",
        help="commit the fresh measured section into --baseline "
             "(the measured twin of `stc lint --scale --rebaseline`)",
    )
    sc.add_argument("--json", action="store_true")
    sc.add_argument(
        "--telemetry-file", default=None,
        help="emit the check's own run stream (scale.* counters, "
             "scale_check event; with --run the probe's dispatch "
             "attribution and scale_probe_entry events land here too)",
    )
    sc.set_defaults(fn=cmd_scale_check)
