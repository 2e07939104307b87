"""Live alerting over live telemetry: the JAX package's
``telemetry/alerts.py``, copied, reporting through the port's telemetry
facade and reading the port's leases and epoch ledgers.

A declarative alert-rule registry is evaluated incrementally by
tail-following live JSONL run streams, a fleet's lease files and epoch
ledgers, and feeds a pending -> firing -> resolved state machine whose
transitions persist to a checksummed append-only ``alerts.jsonl`` (the
epoch ledger's append discipline).  Other parts read it back:

  * ``metrics summarize`` renders an alert-health section from the
    monitor's run stream;
  * ``serve``'s and ``front``'s ``/healthz`` say ``degraded`` while
    alerts are firing (``firing_alerts`` below is the reader);
  * a machine-readable **actions file** carries the scale and drain
    requests that the fleet supervisor polls
    (``FleetSupervisor(actions_file=...)``): a ``queue_depth`` or
    ``serve_p99`` alert asks for a resize, a ``worker_stale`` alert for
    the drain ladder.

Rule kinds:

  * ``threshold``: a windowed signal (last/rate/sum/mean/percentile/
    distinct, optionally grouped ``by`` a field) compared against a
    bound, sustained ``for_seconds`` before firing;
  * ``absence``: no matching event within ``value`` seconds;
  * ``divergence``: cross-stream skew, the ``metrics merge`` spread
    statistic ((max-min)/|median|) over per-key windowed values;
  * ``drift``: the symmetric KL / Hellinger distance, invariant to a
    permutation of the topics, between the lambdas of committed epochs
    read from an epoch ledger's shards (``drift.kl`` /
    ``drift.hellinger`` gauges);
  * ``burn_rate``: SLO error-budget burn (``telemetry.slo``), firing when
    both windows of a pair burn at or beyond the pair's factor times the
    rule's ``value``, one alert key per ``<objective>:<window-pair>``.

An engine whose rules read ``queueing_estimate`` events also runs a
``telemetry.queueing`` estimator over the tailed streams.

Tailing is torn-line and truncation tolerant: a partial trailing line
waits for the next poll, a rewritten or rotated file is read again from
the top, and a missing file is quiet.  The module imports neither torch
nor the port's device code: it reads files and can run far from the card
it watches.  The metric names (``monitor.*``, ``alert.*``, ``drift.*``),
the record layouts and their checksums are the JAX package's, so an
``alerts.jsonl`` or an actions file either package wrote reads in the
other.

Fault sites: ``monitor.poll`` (top of each evaluation cycle) and
``monitor.action`` (before the actions file write).
"""

from __future__ import annotations

import glob
import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ..resilience import faultinject
from ..resilience.errors import CorruptArtifactError, ResilienceError
from ..resilience.integrity import atomic_write_text, file_sha256
from ..resilience.ledger import EpochLedger, record_checksum
from ..resilience.retry import sleep as _sleep
from .. import telemetry
from . import slo as slo_defs
from .queueing import QueueingEstimator

__all__ = [
    "ALERTS_LOG_NAME",
    "JsonlTailer",
    "StreamSet",
    "AlertRule",
    "rule_from_dict",
    "builtin_rules",
    "BUILTIN_RULES",
    "AlertLog",
    "firing_alerts",
    "DriftProbe",
    "topic_distance",
    "ActionEmitter",
    "read_actions",
    "AlertEngine",
]

ALERTS_LOG_NAME = "alerts.jsonl"
ALERTS_SCHEMA = 1
ACTIONS_SCHEMA = 1

# metric names (the alert./drift./monitor. families declared as
# prefixes in telemetry/names.py)
POLLS_COUNTER = "monitor.polls"
POLL_ERRORS_COUNTER = "monitor.poll_errors"
EVENTS_COUNTER = "monitor.events"
ACTIONS_COUNTER = "monitor.actions"
STREAMS_GAUGE = "monitor.streams"
ACTIVE_GAUGE = "alert.active"
DRIFT_PROBES_COUNTER = "drift.probes"
DRIFT_KL_GAUGE = "drift.kl"
DRIFT_HELLINGER_GAUGE = "drift.hellinger"

RULE_KINDS = (
    "threshold", "absence", "divergence", "drift", "burn_rate",
)
AGGS = (
    "last", "count", "rate", "sum", "rate_sum", "mean", "max", "min",
    "p50", "p95", "p99", "distinct",
)
REDUCES = ("sum", "max", "min", "mean")
OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}
ACTION_KINDS = ("scale_out", "scale_in", "resize", "drain")

_EPS = 1e-12


# ---------------------------------------------------------------------------
# Tailing machinery (shared with `metrics tail`)
# ---------------------------------------------------------------------------
class JsonlTailer:
    """Incremental reader of ONE JSONL stream.

    Only COMPLETE lines (newline-terminated) are consumed — a torn
    trailing line (a writer mid-append) stays buffered until its
    newline arrives, so a record is never half-parsed.  A file whose
    size shrank below the read offset was truncated or rotated: the
    tailer restarts from the top (the stream's writer truncates on
    ``configure``, so this is a new run, not data loss).  Unparseable
    complete lines are skipped, like ``read_events``.
    """

    def __init__(self, path: str, *, from_start: bool = True) -> None:
        self.path = path
        self.offset = 0
        self._buf = b""
        if not from_start:
            try:
                self.offset = os.path.getsize(path)
            except OSError:
                self.offset = 0

    def poll(self) -> List[Dict]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []                   # missing/unreadable: quiet
        if size < self.offset:
            # truncation/rotation: the retained offset points past the
            # new end — restart from the top and drop the stale buffer
            self.offset = 0
            self._buf = b""
        try:
            with open(self.path, "rb") as f:
                f.seek(self.offset)
                chunk = f.read()
        except OSError:
            return []
        self.offset += len(chunk)
        data = self._buf + chunk
        lines = data.split(b"\n")
        self._buf = lines.pop()         # partial tail (or b"")
        out: List[Dict] = []
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out


class StreamSet:
    """Tail N streams named by glob patterns, re-expanded every poll so
    streams that appear mid-run (a respawned worker's
    ``events-p3.jsonl``) are picked up live.  Each event is tagged with
    its source stream under ``_stream`` (the skew rules' ``by`` key)."""

    def __init__(
        self, patterns: List[str], *, from_start: bool = True
    ) -> None:
        self.patterns = list(patterns)
        self.from_start = from_start
        self._tailers: Dict[str, JsonlTailer] = {}

    def paths(self) -> List[str]:
        out: List[str] = []
        for pat in self.patterns:
            out.extend(sorted(glob.glob(pat)))
            # a literal path that doesn't exist YET still gets a tailer
            # — it goes live the moment the writer creates it
            if not glob.has_magic(pat) and pat not in out:
                out.append(pat)
        seen, uniq = set(), []
        for p in out:
            if p not in seen:
                seen.add(p)
                uniq.append(p)
        return uniq

    def poll(self) -> List[Dict]:
        out: List[Dict] = []
        for p in self.paths():
            t = self._tailers.get(p)
            if t is None:
                t = JsonlTailer(p, from_start=self.from_start)
                self._tailers[p] = t
            label = os.path.basename(p)
            for e in t.poll():
                e["_stream"] = label
                out.append(e)
        return out

    def stream_count(self) -> int:
        return sum(
            1 for p in self.paths() if os.path.exists(p)
        )


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------
@dataclass
class AlertRule:
    """One declarative alert rule (see the module docstring for kinds).

    ``signal`` selects + aggregates window events::

        {"event": "lease", "field": "queue_depth", "agg": "last",
         "by": "worker", "reduce": "sum", "where": {"done": false},
         "window_seconds": 30}

    ``by`` groups the window per key — each key becomes its own alert
    instance; ``reduce`` folds the per-key values back into one (the
    fleet-total pattern).  ``action`` names what a FIRING transition
    asks the supervisor to do (``scale_out``/``scale_in``/``resize``/
    ``drain``)."""

    name: str
    kind: str = "threshold"
    signal: Optional[Dict] = None
    op: str = ">"
    value: float = 0.0
    for_seconds: float = 0.0
    resolve_seconds: float = 0.0
    action: Optional[Dict] = None
    description: str = ""
    ledger_dir: Optional[str] = None    # drift rules
    metric: str = "kl"                  # drift rules: kl | hellinger
    slo: Optional[str] = None           # burn_rate rules: objective
                                        # name (None = every objective)

    def __post_init__(self) -> None:
        if self.kind not in RULE_KINDS:
            raise ValueError(
                f"rule {self.name!r}: unknown kind {self.kind!r} "
                f"(one of {RULE_KINDS})"
            )
        if self.op not in OPS:
            raise ValueError(
                f"rule {self.name!r}: unknown op {self.op!r} "
                f"(one of {tuple(OPS)})"
            )
        if self.kind in ("threshold", "divergence", "absence"):
            if not isinstance(self.signal, dict) or \
                    "event" not in self.signal:
                raise ValueError(
                    f"rule {self.name!r}: {self.kind} rules need a "
                    f"signal dict with at least an 'event' selector"
                )
            agg = self.signal.get("agg", "last")
            if agg not in AGGS:
                raise ValueError(
                    f"rule {self.name!r}: unknown agg {agg!r} "
                    f"(one of {AGGS})"
                )
            red = self.signal.get("reduce")
            if red is not None and red not in REDUCES:
                raise ValueError(
                    f"rule {self.name!r}: unknown reduce {red!r} "
                    f"(one of {REDUCES})"
                )
        if self.kind == "divergence" and not self.signal.get("by"):
            raise ValueError(
                f"rule {self.name!r}: divergence rules need "
                f"signal['by'] (the cross-stream key)"
            )
        if self.kind == "burn_rate":
            # ``value`` is a MULTIPLIER on each window pair's burn
            # factor (1.0 = the SRE defaults); the unset-field default
            # of 0.0 reads as "the defaults", not "fire on any burn"
            if self.value <= 0:
                self.value = 1.0
        if self.kind == "drift" and self.metric not in (
            "kl", "hellinger"
        ):
            raise ValueError(
                f"rule {self.name!r}: drift metric must be kl or "
                f"hellinger, got {self.metric!r}"
            )
        if self.action is not None and \
                self.action.get("kind") not in ACTION_KINDS:
            raise ValueError(
                f"rule {self.name!r}: unknown action kind "
                f"{self.action.get('kind')!r} (one of {ACTION_KINDS})"
            )

    def window(self) -> float:
        if self.signal is None:
            return 300.0
        return float(self.signal.get("window_seconds", 300.0))


def rule_from_dict(spec: Dict) -> AlertRule:
    """An ``AlertRule`` from one JSON rule object (the ``--rules`` file
    format: a list of these)."""
    known = {
        "name", "kind", "signal", "op", "value", "for_seconds",
        "resolve_seconds", "action", "description", "ledger_dir",
        "metric", "slo",
    }
    extra = set(spec) - known
    if extra:
        raise ValueError(
            f"rule {spec.get('name', '?')!r}: unknown field(s) "
            f"{sorted(extra)}"
        )
    if "name" not in spec:
        raise ValueError("every rule needs a 'name'")
    return AlertRule(**spec)


# Built-in rules: one per layer the stack can hurt in.  Thresholds are
# conservative live defaults — override any field via the --rules file
# (same name wins) or builtin_rules(overrides=...).
BUILTIN_RULES: Dict[str, Dict] = {
    # compile sentinel, live: distinct compiled signatures per dispatch
    # label (the retrace storm `metrics compile-check` gates post-hoc)
    "retrace_storm": {
        "kind": "threshold",
        "signal": {"event": "dispatch_executable", "field": "digest",
                   "agg": "distinct", "by": "label",
                   "window_seconds": 600.0},
        "op": ">", "value": 8.0, "resolve_seconds": 30.0,
        "description": "an unbucketed shape is re-tracing a hot loop",
    },
    # fleet sweeps: the slack between heartbeats and the lease timeout
    "lease_slack_collapse": {
        "kind": "threshold",
        "signal": {"event": "fleet_sweep", "field": "lease_slack_min",
                   "agg": "last", "window_seconds": 60.0},
        "op": "<", "value": 0.5, "for_seconds": 2.0,
        "resolve_seconds": 5.0,
        "description": "workers are one hiccup from a lease expiry",
    },
    # lease files: a worker that stopped heartbeating (wedged or dead)
    "worker_stale": {
        "kind": "threshold",
        "signal": {"event": "lease", "field": "age", "agg": "last",
                   "by": "worker", "window_seconds": 30.0},
        "op": ">", "value": 10.0, "resolve_seconds": 1.0,
        "action": {"kind": "drain"},
        "description": "a live-but-silent worker needs the drain "
                       "ladder",
    },
    # lease files: fleet-total ingest backlog (the scale-out signal)
    "queue_depth": {
        "kind": "threshold",
        "signal": {"event": "lease", "field": "queue_depth",
                   "agg": "last", "by": "worker", "reduce": "sum",
                   "window_seconds": 30.0},
        "op": ">=", "value": 8.0, "for_seconds": 1.0,
        "resolve_seconds": 5.0,
        "action": {"kind": "scale_out"},
        "description": "sustained ingest backlog across the fleet",
    },
    # lease files: one worker's partition backing up vs the rest
    "fleet_skew": {
        "kind": "divergence",
        "signal": {"event": "lease", "field": "queue_depth",
                   "agg": "last", "by": "worker",
                   "window_seconds": 30.0},
        "op": ">", "value": 2.0, "for_seconds": 2.0,
        "resolve_seconds": 5.0,
        "action": {"kind": "scale_out"},
        "description": "one worker's partition is starving/flooding",
    },
    # worker run streams: per-stream micro-batch wall time divergence
    "straggler_skew": {
        "kind": "divergence",
        "signal": {"event": "micro_batch", "field": "seconds",
                   "agg": "mean", "by": "_stream",
                   "window_seconds": 120.0},
        "op": ">", "value": 1.0, "for_seconds": 5.0,
        "resolve_seconds": 10.0,
        "description": "one process is much slower than its peers",
    },
    # streaming: the stream went silent entirely
    "stream_stalled": {
        "kind": "absence",
        "signal": {"event": "micro_batch"},
        "op": ">", "value": 60.0, "resolve_seconds": 5.0,
        "description": "no micro-batch completed within the window",
    },
    # serve fleet: a replica's lease DISAPPEARED (the serve supervisor
    # retires a dead replica's lease file before respawning it, so the
    # gap between death and the respawned replica's first heartbeat is
    # an absence — fires on the kill, resolves on the fresh lease)
    "replica_down": {
        "kind": "absence",
        "signal": {"event": "lease", "by": "worker",
                   "where": {"role": "serve"}},
        "op": ">", "value": 3.0, "resolve_seconds": 0.5,
        "description": "a serve replica's lease vanished and no "
                       "respawn has heartbeat yet",
    },
    # serving: latency / fill / quarantine regressions
    "serve_p99": {
        "kind": "threshold",
        "signal": {"event": "serve_batch", "field": "seconds",
                   "agg": "p99", "window_seconds": 60.0},
        "op": ">", "value": 0.5, "for_seconds": 5.0,
        "resolve_seconds": 15.0,
        "action": {"kind": "scale_out"},
        "description": "serve batch p99 beyond the latency budget — "
                       "a serve fleet scales out a replica "
                       "(drain-free; docs/SERVING.md)",
    },
    "serve_batch_fill": {
        "kind": "threshold",
        "signal": {"event": "serve_batch", "field": "fill",
                   "agg": "mean", "window_seconds": 60.0},
        "op": "<", "value": 0.05, "for_seconds": 10.0,
        "resolve_seconds": 15.0,
        "action": {"kind": "scale_in"},
        "description": "batches dispatch nearly empty — linger/bucket "
                       "tuning is off for this traffic, or a serve "
                       "fleet is over-provisioned (scale in)",
    },
    "serve_quarantine_rate": {
        "kind": "threshold",
        "signal": {"event": "serve_quarantined", "field": "docs",
                   "agg": "rate_sum", "window_seconds": 60.0},
        "op": ">", "value": 0.5, "resolve_seconds": 15.0,
        "description": "documents are failing vectorize/score faster "
                       "than a stray poison doc explains",
    },
    # overload control: typed refusals are WORKING as designed, but a
    # sustained reject rate means the fleet is undersized for its
    # offered load — page a human (or let the autoscaler catch up)
    "reject_rate": {
        "kind": "threshold",
        "signal": {"event": "front_request", "agg": "rate",
                   "where": {"outcome": "rejected"},
                   "window_seconds": 60.0},
        "op": ">", "value": 1.0, "for_seconds": 5.0,
        "resolve_seconds": 15.0,
        "action": {"kind": "scale_out"},
        "description": "the front is propagating replica 429s faster "
                       "than one per second, sustained — admission "
                       "control is holding the line but the fleet is "
                       "undersized for the offered load",
    },
    # overload control: the fleet has been answering on the cheaper
    # degraded tier for most of the window — capacity bought back by
    # quality, which must not become the steady state silently
    "degraded_fraction": {
        "kind": "threshold",
        "signal": {"event": "serve_batch", "field": "degraded",
                   "agg": "mean", "window_seconds": 60.0},
        "op": ">", "value": 0.5, "for_seconds": 5.0,
        "resolve_seconds": 15.0,
        "description": "most serve batches are dispatching in "
                       "degraded mode (X-STC-Degraded answers) — "
                       "sustained pressure is being paid for with "
                       "answer quality",
    },
    # epoch ledger: rollbacks burning against commits
    "ledger_rollback_rate": {
        "kind": "threshold",
        "signal": {"event": "ledger_rollback", "agg": "rate",
                   "window_seconds": 300.0},
        "op": ">", "value": 0.02, "resolve_seconds": 30.0,
        "description": "epochs are rolling back repeatedly — crash "
                       "loop or torn storage",
    },
    # SLO engine: error-budget burn on any objective's window pair
    # (telemetry.slo; inert on streams with no typed request events —
    # no data means no keys, never a fire)
    "budget_burn": {
        "kind": "burn_rate",
        "op": ">=", "value": 1.0,
        "for_seconds": 0.0, "resolve_seconds": 15.0,
        "description": "an SLO error budget is burning fast enough to "
                       "exhaust (both windows of a pair over the "
                       "burn-rate factor — the Google-SRE "
                       "multi-window multi-burn-rate condition)",
    },
    # queueing observatory: the M/M/c model stopped describing the
    # fleet (measured coalescer wait far beyond the Erlang-C
    # prediction at the current lambda/S/c)
    "queue_wait_divergence": {
        "kind": "threshold",
        "signal": {"event": "queueing_estimate",
                   "field": "wait_divergence", "agg": "mean",
                   "window_seconds": 60.0},
        "op": ">", "value": 8.0, "for_seconds": 5.0,
        "resolve_seconds": 15.0,
        "description": "measured queue wait diverges from the M/M/c "
                       "prediction — routing skew, a stuck replica, "
                       "or non-Poisson arrivals the model can't see",
    },
    # model quality: topic drift between committed-epoch lambdas
    "topic_drift": {
        "kind": "drift", "metric": "kl",
        "op": ">", "value": 0.5, "resolve_seconds": 0.0,
        "description": "the committed topic-word distributions moved "
                       "(symmetric KL, permutation-invariant)",
    },
}


def builtin_rules(
    names: Optional[List[str]] = None,
    overrides: Optional[Dict[str, Dict]] = None,
) -> List[AlertRule]:
    """Instantiate built-in rules (all of them by default), with
    per-rule field overrides merged in (the ``--rules`` file may
    re-declare a built-in name to retune it)."""
    overrides = overrides or {}
    out = []
    for name in (names if names is not None else sorted(BUILTIN_RULES)):
        if name not in BUILTIN_RULES:
            raise ValueError(
                f"unknown builtin rule {name!r} "
                f"(one of {sorted(BUILTIN_RULES)})"
            )
        spec = dict(BUILTIN_RULES[name], name=name)
        spec.update(overrides.get(name, {}))
        out.append(rule_from_dict(spec))
    return out


# ---------------------------------------------------------------------------
# Signal evaluation over the event window
# ---------------------------------------------------------------------------
def _pctl(sorted_vals: List[float], q: float) -> float:
    idx = max(0, min(len(sorted_vals) - 1,
                     math.ceil(len(sorted_vals) * q / 100.0) - 1))
    return sorted_vals[idx]


def _matches(e: Dict, signal: Dict) -> bool:
    if e.get("event") != signal.get("event"):
        return False
    for f, want in (signal.get("where") or {}).items():
        if e.get(f) != want:
            return False
    return True


def eval_signal(
    signal: Dict, events: List[Tuple[float, Dict]], now: float
) -> Dict[Optional[str], float]:
    """Aggregate the window into per-key values (``{None: v}`` when the
    signal has no ``by``).  Keys with no usable data are absent — the
    caller treats absence as condition-false."""
    window = float(signal.get("window_seconds", 300.0))
    fld = signal.get("field")
    agg = signal.get("agg", "last")
    by = signal.get("by")
    lo = now - window
    groups: Dict[Optional[str], List[Tuple[float, float]]] = {}
    for ts, e in events:
        if ts < lo or not _matches(e, signal):
            continue
        key = str(e.get(by)) if by is not None else None
        if fld is None:
            v = 1.0
        else:
            raw = e.get(fld)
            if agg == "distinct":
                v = raw          # identity matters, not numeric value
            elif isinstance(raw, bool) or not isinstance(
                raw, (int, float)
            ) or not math.isfinite(raw):
                continue
            else:
                v = float(raw)
        groups.setdefault(key, []).append((ts, v))
    out: Dict[Optional[str], float] = {}
    for key, pairs in groups.items():
        vals = [v for _, v in pairs]
        if agg == "last":
            out[key] = max(pairs, key=lambda p: p[0])[1]
        elif agg == "count":
            out[key] = float(len(vals))
        elif agg == "rate":
            out[key] = len(vals) / max(window, _EPS)
        elif agg == "sum":
            out[key] = float(sum(vals))
        elif agg == "rate_sum":
            out[key] = float(sum(vals)) / max(window, _EPS)
        elif agg == "mean":
            out[key] = float(sum(vals)) / len(vals)
        elif agg == "max":
            out[key] = float(max(vals))
        elif agg == "min":
            out[key] = float(min(vals))
        elif agg == "distinct":
            out[key] = float(len({repr(v) for v in vals}))
        else:                    # p50 / p95 / p99
            out[key] = _pctl(sorted(vals), float(agg[1:]))
    red = signal.get("reduce")
    if red is not None and out:
        vals = list(out.values())
        folded = {
            "sum": sum(vals), "max": max(vals), "min": min(vals),
            "mean": sum(vals) / len(vals),
        }[red]
        return {None: float(folded)}
    return out


# ---------------------------------------------------------------------------
# Alert log (the epoch-ledger append discipline applied to alert state)
# ---------------------------------------------------------------------------
class AlertLog:
    """Append-only, checksummed ``alerts.jsonl``: one record per state
    transition.  Torn tails tolerated on read (a monitor killed
    mid-append), replay rebuilds the currently-firing set so a restart
    resumes instead of re-firing."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.seq = 0
        recs, _ = self.replay()
        if recs:
            self.seq = max(int(r.get("seq", 0)) for r in recs) + 1

    def replay(self) -> Tuple[List[Dict], int]:
        """(records, torn-line count); a checksum-invalid line is only
        tolerated as the final line, mirroring the epoch ledger."""
        if not os.path.exists(self.path):
            return [], 0
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = [ln for ln in f.read().split("\n") if ln.strip()]
        except OSError:
            return [], 0
        out: List[Dict] = []
        for i, ln in enumerate(lines):
            bad = False
            try:
                rec = json.loads(ln)
            except json.JSONDecodeError:
                bad = True
                rec = None
            if rec is not None and \
                    record_checksum(rec) != rec.get("checksum"):
                bad = True
            if bad:
                if i == len(lines) - 1:
                    return out, 1
                raise CorruptArtifactError(
                    self.path,
                    f"alert record {i + 1} is corrupt (not the final "
                    f"line — the log suffix cannot be trusted)",
                )
            out.append(rec)
        return out, 0

    def append(self, **fields) -> Dict:
        rec = {
            "schema": ALERTS_SCHEMA,
            "seq": self.seq,
            "ts": round(float(fields.pop("ts", time.time())), 6),
            **fields,
        }
        rec["checksum"] = record_checksum(rec)
        self.seq += 1
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return rec

    def firing(self) -> Dict[Tuple[str, str], Dict]:
        """(rule, key) -> newest record, for alerts whose latest
        transition is ``firing``."""
        state: Dict[Tuple[str, str], Dict] = {}
        for r in self.replay()[0]:
            k = (str(r.get("rule")), str(r.get("key", "")))
            if r.get("state") == "firing":
                state[k] = r
            else:
                state.pop(k, None)
        return state


_firing_cache: Dict[str, Tuple[Tuple[float, int], List[Dict]]] = {}


def firing_alerts(path: Optional[str]) -> List[Dict]:
    """Currently-firing alerts from an ``alerts.jsonl``, for consumers
    on a request path (serve's ``/healthz``): cached by (mtime, size)
    so a hot health endpoint doesn't re-read an unchanged log, and a
    missing/corrupt log reads as no alerts — health checks must never
    crash on their own telemetry."""
    if not path:
        return []
    try:
        st = os.stat(path)
        stamp = (st.st_mtime, st.st_size)
    except OSError:
        return []
    cached = _firing_cache.get(path)
    if cached is not None and cached[0] == stamp:
        return cached[1]
    try:
        firing = AlertLog(path).firing()
    except (CorruptArtifactError, OSError):
        return []
    out = sorted(
        (
            {
                "rule": rule, "key": key,
                "value": rec.get("value"),
                "threshold": rec.get("threshold"),
                "since": rec.get("ts"),
            }
            for (rule, key), rec in firing.items()
        ),
        key=lambda r: (r["rule"], r["key"]),
    )
    _firing_cache[path] = (stamp, out)
    return out


# ---------------------------------------------------------------------------
# Topic-drift probe
# ---------------------------------------------------------------------------
def _row_normalize(lam: np.ndarray) -> np.ndarray:
    lam = np.asarray(lam, np.float64)
    lam = np.maximum(lam, 0.0) + _EPS
    return lam / lam.sum(axis=1, keepdims=True)


def topic_distance(
    a: np.ndarray, b: np.ndarray
) -> Tuple[float, float]:
    """(symmetric KL, Hellinger) between two topic-word matrices,
    PERMUTATION-INVARIANT: each topic is matched to its nearest
    counterpart in the other model (both directions, averaged — the
    chamfer matching), so a re-ordered but otherwise identical lambda
    measures ~0 while a genuinely moved distribution does not."""
    p = _row_normalize(a)[:, None, :]        # [k, 1, V]
    q = _row_normalize(b)[None, :, :]        # [1, k, V]
    kl_pq = np.sum(p * np.log(p / q), axis=-1)
    kl_qp = np.sum(q * np.log(q / p), axis=-1)
    sym = 0.5 * (kl_pq + kl_qp)              # [k, k]
    hel = np.sqrt(
        np.maximum(
            0.5 * np.sum((np.sqrt(p) - np.sqrt(q)) ** 2, axis=-1), 0.0
        )
    )

    def chamfer(d: np.ndarray) -> float:
        return float(
            0.5 * (d.min(axis=1).mean() + d.min(axis=0).mean())
        )

    return chamfer(sym), chamfer(hel)


class DriftProbe:
    """Watch one epoch ledger for newly committed shard-bearing epochs
    and measure how far the topic-word distribution moved since the
    previous committed state (the ledger GCs older shard sets, so the
    probe keeps its own previous-distribution snapshot in memory).

    Each successful probe sets the ``drift.kl`` / ``drift.hellinger``
    gauges and returns a ``drift_probe`` pseudo-event; corrupt or
    mid-write shards are skipped (the next committed epoch probes
    clean) — the probe NEVER takes the monitor down."""

    def __init__(self, ledger_dir: str) -> None:
        self.ledger_dir = ledger_dir
        self.key = os.path.basename(os.path.abspath(ledger_dir)) or "?"
        self.last_epoch = -1
        self.kl: Optional[float] = None
        self.hellinger: Optional[float] = None
        self._prev: Optional[np.ndarray] = None

    def _load_lambda(self, rec: Dict) -> Optional[np.ndarray]:
        shards = sorted(
            rec.get("shards", ()), key=lambda s: tuple(s["cols"])
        )
        if not shards:
            return None
        parts: List[np.ndarray] = []
        for s in shards:
            path = os.path.join(self.ledger_dir, s["file"])
            try:
                want = s.get("sha256")
                if want and file_sha256(path) != want:
                    return None          # torn/bit-rotted shard
                with np.load(path) as z:
                    lam = np.asarray(z["lam"], np.float64)
            except (OSError, KeyError, ValueError):
                return None
            parts.append(lam)
        try:
            return np.concatenate(parts, axis=1)
        except ValueError:
            return None                  # mismatched shard shapes

    def poll(self, now: float) -> Optional[Dict]:
        try:
            records = EpochLedger(self.ledger_dir).records()
        except (CorruptArtifactError, ResilienceError, OSError):
            return None
        newest = None
        for r in records:
            if r.get("shards"):
                newest = r
        if newest is None or int(newest["epoch"]) <= self.last_epoch:
            return None
        lam = self._load_lambda(newest)
        if lam is None:
            return None
        telemetry.count(DRIFT_PROBES_COUNTER)
        ev: Optional[Dict] = None
        if self._prev is not None and self._prev.shape == lam.shape:
            self.kl, self.hellinger = topic_distance(self._prev, lam)
            telemetry.gauge(DRIFT_KL_GAUGE, self.kl)
            telemetry.gauge(DRIFT_HELLINGER_GAUGE, self.hellinger)
            ev = {
                "event": "drift_probe",
                "ts": now,
                "ledger": self.ledger_dir,
                "key": self.key,
                "epoch": int(newest["epoch"]),
                "from_epoch": self.last_epoch,
                "kl": round(self.kl, 9),
                "hellinger": round(self.hellinger, 9),
            }
            telemetry.event(
                "drift_probe",
                **{k: v for k, v in ev.items() if k != "event"},
            )
        self._prev = lam
        self.last_epoch = int(newest["epoch"])
        return ev


# ---------------------------------------------------------------------------
# Actions file (the supervisor's side of the loop)
# ---------------------------------------------------------------------------
class ActionEmitter:
    """Writes the machine-readable actions file firing alerts append
    to: ``{"schema": 1, "actions": [{"id": N, "kind": "scale_out",
    "alert": "queue_depth", ...}, ...]}`` — atomically, ids strictly
    increasing across monitor restarts (the supervisor acks the last
    applied id in ``<path>.ack``, so replays are idempotent)."""

    MAX_KEPT = 64

    def __init__(self, path: str) -> None:
        self.path = path
        self.actions: List[Dict] = list(
            read_actions(path).get("actions", ())
        )
        self.next_id = max(
            (int(a.get("id", -1)) for a in self.actions), default=-1
        ) + 1
        self._dirty = False

    def emit(self, kind: str, *, alert: str, key: str, value,
             **extra) -> Dict:
        act = {
            "id": self.next_id,
            "ts": round(time.time(), 6),
            "kind": kind,
            "alert": alert,
            "key": key,
            "value": value,
            **extra,
        }
        self.next_id += 1
        self.actions.append(act)
        self.actions = self.actions[-self.MAX_KEPT:]
        self._dirty = True
        telemetry.count(ACTIONS_COUNTER)
        telemetry.event("action_emitted", **act)
        return act

    def flush(self) -> bool:
        if not self._dirty:
            return False
        faultinject.check("monitor.action")
        atomic_write_text(
            self.path,
            json.dumps(
                {"schema": ACTIONS_SCHEMA, "actions": self.actions},
                sort_keys=True,
            ) + "\n",
        )
        self._dirty = False
        return True


def read_actions(path: Optional[str]) -> Dict:
    """The actions file's current content; missing/torn reads as empty
    (the supervisor polls this mid-write)."""
    if not path:
        return {"actions": []}
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {"actions": []}
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("actions"), list):
        return {"actions": []}
    return doc


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------
@dataclass
class _AlertState:
    state: str = "inactive"             # inactive | pending | firing
    since: float = 0.0
    clear_since: Optional[float] = None
    value: Optional[float] = None


class AlertEngine:
    """Tail, evaluate, transition, persist, act — one ``poll()`` per
    cycle.  ``run()`` is the follow loop; ``once()`` is the batch mode
    (full history, event-time evaluation, ``for_seconds`` collapsed to
    immediate — deterministic for CI gating)."""

    MAX_BUFFERED_EVENTS = 100_000

    def __init__(
        self,
        rules: List[AlertRule],
        streams: Optional[StreamSet] = None,
        *,
        fleet_dir: Optional[str] = None,
        ledger_dirs: Optional[List[str]] = None,
        alerts_path: Optional[str] = None,
        actions_path: Optional[str] = None,
        now_fn: Callable[[], float] = time.time,
        on_transition: Optional[Callable[[Dict], None]] = None,
        slo_config: Optional["slo_defs.SLOConfig"] = None,
        queueing: Optional[bool] = None,
    ) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.rules = list(rules)
        self.streams = streams
        self.fleet_dir = fleet_dir
        self.ledger_dirs = list(ledger_dirs or [])
        self._now = now_fn
        self._on_transition = on_transition
        self.log = AlertLog(alerts_path) if alerts_path else None
        self.actions = ActionEmitter(actions_path) \
            if actions_path else None

        # SLO evaluation: any burn_rate rule needs a config; the
        # built-in objective set is the default (same UX as rules)
        self.slo_config = slo_config
        if self.slo_config is None and any(
            r.kind == "burn_rate" for r in self.rules
        ):
            self.slo_config = slo_defs.builtin_config()
        self._slo_results: Dict[str, Dict] = {}
        self._slo_status: Dict[str, str] = {}
        # queueing estimator: auto-on when a rule consumes its
        # pseudo-events, so `queue_wait_divergence` works out of the
        # box without changing engines that never asked for it
        if queueing is None:
            queueing = any(
                isinstance(r.signal, dict)
                and r.signal.get("event") == "queueing_estimate"
                for r in self.rules
            )
        self.queueing = QueueingEstimator() if queueing else None

        self._buffer: Deque[Tuple[float, Dict]] = deque()
        self._max_window = max(
            [r.window() for r in self.rules], default=300.0
        )
        if self.slo_config is not None:
            self._max_window = max(
                self._max_window, self.slo_config.max_window_seconds()
            )
        # absence rules track last-seen OUTSIDE the window buffer so a
        # long-stale stream (older than every window) stays accusable
        self._last_seen: Dict[Tuple[str, Optional[str]], float] = {}
        self._started_at: Optional[float] = None
        self._states: Dict[Tuple[str, str], _AlertState] = {}
        self.transitions: List[Dict] = []

        # drift probes: explicit rule ledger_dir wins; otherwise one
        # probe per --ledger-dir (each dir is its own alert key)
        self._probes: List[Tuple[AlertRule, DriftProbe]] = []
        for r in self.rules:
            if r.kind != "drift":
                continue
            dirs = [r.ledger_dir] if r.ledger_dir else self.ledger_dirs
            for d in dirs:
                self._probes.append((r, DriftProbe(d)))

        # resume: the persisted firing set survives a monitor restart
        # (no duplicate firing record, resolution still lands)
        if self.log is not None:
            for (rule, key), rec in self.log.firing().items():
                if rule in set(names):
                    self._states[(rule, key)] = _AlertState(
                        state="firing",
                        since=float(rec.get("ts", 0.0)),
                        value=rec.get("value"),
                    )

    # -- ingest ----------------------------------------------------------
    def _lease_events(self, now: float) -> List[Dict]:
        """Synthesized ``lease`` pseudo-events from the fleet's lease
        files (one per live worker per poll, ``age`` recomputed each
        time).  Done leases emit nothing — a finished worker must age
        out of its rules' windows, not alert forever."""
        if not self.fleet_dir:
            return []
        from ..resilience.supervisor import LEASE_DIRNAME, read_lease

        lease_dir = os.path.join(self.fleet_dir, LEASE_DIRNAME)
        try:
            names = sorted(os.listdir(lease_dir))
        except OSError:
            return []
        out = []
        for n in names:
            if not n.endswith(".json"):
                continue
            lease = read_lease(os.path.join(lease_dir, n))
            if lease is None or lease.get("done"):
                continue
            out.append({
                "event": "lease",
                "ts": now,
                "worker": int(lease.get("worker", -1)),
                "age": round(
                    max(0.0, now - float(lease.get("ts", now))), 6
                ),
                "queue_depth": int(lease.get("queue_depth", 0)),
                "epoch": int(lease.get("epoch", -1)),
                "generation": lease.get("generation"),
                # serve-fleet identity: replica leases carry role=serve
                # (+ state/port) — the replica_down absence rule and
                # serve-aware dashboards filter on it
                "role": lease.get("role", "stream"),
                "state": lease.get("state"),
            })
        return out

    def _ingest(self, events: List[Dict], now: float) -> None:
        for e in events:
            ts = e.get("ts")
            ts = float(ts) if isinstance(ts, (int, float)) and \
                not isinstance(ts, bool) else now
            self._buffer.append((ts, e))
            for r in self.rules:
                if r.kind != "absence" or not _matches(e, r.signal):
                    continue
                by = r.signal.get("by")
                key = str(e.get(by)) if by is not None else None
                self._last_seen[(r.name, key)] = max(
                    self._last_seen.get((r.name, key), 0.0), ts
                )
        telemetry.count(EVENTS_COUNTER, len(events))
        lo = now - self._max_window
        while self._buffer and self._buffer[0][0] < lo:
            self._buffer.popleft()
        # hard cap behind the time window: an endless high-rate stream
        # must hold bounded memory no matter how wide a rule's window
        # is (the registry's bounded-memory discipline applied here)
        while len(self._buffer) > self.MAX_BUFFERED_EVENTS:
            self._buffer.popleft()

    def _observe_signals(self, events: List[Dict], now: float) -> None:
        """The derived-signal half of a cycle: feed the in-loop
        queueing estimator (its estimate joins the buffer as a
        pseudo-event for threshold rules) and re-evaluate the SLO set
        against the current buffer — both publish gauges, and an
        objective whose status changed emits one ``slo_status``
        event."""
        if self.queueing is not None:
            for e in events:
                ts = e.get("ts")
                ts = float(ts) if isinstance(ts, (int, float)) and \
                    not isinstance(ts, bool) else now
                self.queueing.observe_event(ts, e)
            est = self.queueing.estimate(now)
            if est is not None:
                self._buffer.append((now, est))
                telemetry.event(
                    "queueing_estimate",
                    **{k: v for k, v in est.items()
                       if k not in ("event", "ts")},
                )
        if self.slo_config is not None:
            self._slo_results = slo_defs.evaluate_all(
                self.slo_config, list(self._buffer), now
            )
            slo_defs.publish(self._slo_results)
            for name, res in sorted(self._slo_results.items()):
                prev = self._slo_status.get(name)
                if res["status"] == prev:
                    continue
                self._slo_status[name] = res["status"]
                if prev is None and res["status"] == "no_data":
                    continue             # nothing-yet is not a change
                telemetry.event(
                    "slo_status",
                    objective=name,
                    status=res["status"],
                    kind=res["kind"],
                    source=res["source"],
                    target=res["target"],
                    good=res["good"],
                    total=res["total"],
                    budget_remaining=res["budget_remaining"],
                    burning=res["burning"],
                )

    def slo_results(self) -> Dict[str, Dict]:
        """The newest per-objective evaluation (for CLIs and tests)."""
        return dict(self._slo_results)

    # -- evaluation ------------------------------------------------------
    def _conditions(
        self, rule: AlertRule, now: float
    ) -> Dict[str, Tuple[bool, Optional[float], Dict]]:
        """(condition, value, detail) per alert key for one rule."""
        cmp = OPS[rule.op]
        events = list(self._buffer)
        out: Dict[str, Tuple[bool, Optional[float], Dict]] = {}
        if rule.kind == "threshold":
            vals = eval_signal(rule.signal, events, now)
            for key, v in vals.items():
                out[key or ""] = (cmp(v, rule.value), v, {})
        elif rule.kind == "absence":
            by = rule.signal.get("by")
            keys = {
                k for (rn, k) in self._last_seen if rn == rule.name
            }
            if by is None:
                keys = {None}
            for key in keys:
                last = self._last_seen.get((rule.name, key))
                ref = last if last is not None else (
                    self._started_at if self._started_at is not None
                    else now
                )
                age = now - ref
                out[key or ""] = (cmp(age, rule.value), age, {})
        elif rule.kind == "divergence":
            vals = eval_signal(rule.signal, events, now)
            if len(vals) >= 2:
                ordered = sorted(vals.values())
                n = len(ordered)
                med = (
                    ordered[n // 2] if n % 2
                    else 0.5 * (ordered[n // 2 - 1] + ordered[n // 2])
                )
                spread = (ordered[-1] - ordered[0]) / max(
                    abs(med), _EPS
                )
                worst = max(vals, key=lambda k: vals[k])
                out[""] = (
                    cmp(spread, rule.value), spread,
                    {"worst": worst, "worst_value": vals[worst],
                     "median": med},
                )
            else:
                out[""] = (False, None, {})
        elif rule.kind == "burn_rate":
            # one alert key per <objective>:<window-pair>; the value
            # is min(long, short) burn, so `op value*factor` holds
            # exactly when BOTH windows are over (the SRE condition).
            # Objectives/pairs with no data emit no key — inert, never
            # a fire, and an earlier fire still resolves via the
            # missing-key sweep in _evaluate
            for oname, res in sorted(self._slo_results.items()):
                if rule.slo is not None and oname != rule.slo:
                    continue
                for w in res["windows"]:
                    if w["burn"] is None:
                        continue
                    threshold = w["factor"] * rule.value
                    out[f"{oname}:{w['name']}"] = (
                        cmp(w["burn"], threshold), w["burn"],
                        {"objective": oname, "window": w["name"],
                         "burn_long": round(w["burn_long"], 6),
                         "burn_short": round(w["burn_short"], 6),
                         "burn_threshold": round(threshold, 6),
                         "budget_remaining": res["budget_remaining"]},
                    )
        else:                            # drift
            for r, probe in self._probes:
                if r is not rule:
                    continue
                v = probe.kl if rule.metric == "kl" else probe.hellinger
                if v is None:
                    out[probe.key] = (False, None, {})
                else:
                    out[probe.key] = (
                        cmp(v, rule.value), v,
                        {"epoch": probe.last_epoch,
                         "metric": rule.metric},
                    )
        return out

    def _transition(
        self, rule: AlertRule, key: str, state: str,
        value: Optional[float], now: float, detail: Dict,
    ) -> None:
        rec = {
            "rule": rule.name, "key": key, "state": state,
            "value": value, "threshold": rule.value, "ts": now,
            "kind": rule.kind, **detail,
        }
        telemetry.count(f"alert.{state}")
        telemetry.event(
            "alert_transition",
            **{k: v for k, v in rec.items() if k != "ts"},
        )
        if self.log is not None:
            self.log.append(**rec)
        self.transitions.append(rec)
        if self._on_transition is not None:
            self._on_transition(rec)
        if state == "firing" and rule.action is not None \
                and self.actions is not None:
            kind = rule.action["kind"]
            extra = {
                k: v for k, v in rule.action.items() if k != "kind"
            }
            if kind == "drain" and key.isdigit():
                extra.setdefault("worker", int(key))
            self.actions.emit(
                kind, alert=rule.name, key=key, value=value, **extra
            )

    def _advance(
        self, rule: AlertRule, key: str, cond: bool,
        value: Optional[float], now: float, detail: Dict,
        immediate: bool = False,
    ) -> None:
        st = self._states.setdefault((rule.name, key), _AlertState())
        if st.state == "inactive":
            if not cond:
                return
            if immediate or rule.for_seconds <= 0:
                st.state, st.since, st.value = "firing", now, value
                st.clear_since = None
                self._transition(rule, key, "firing", value, now, detail)
            else:
                st.state, st.since, st.value = "pending", now, value
                self._transition(
                    rule, key, "pending", value, now, detail
                )
        elif st.state == "pending":
            if not cond:
                st.state = "inactive"    # silent cancel, never fired
                return
            st.value = value
            if now - st.since >= rule.for_seconds:
                st.state, st.since = "firing", now
                st.clear_since = None
                self._transition(rule, key, "firing", value, now, detail)
        else:                            # firing
            if cond:
                st.clear_since = None    # flap suppressed: still firing
                st.value = value
            else:
                if st.clear_since is None:
                    st.clear_since = now
                if now - st.clear_since >= rule.resolve_seconds:
                    st.state = "inactive"
                    st.clear_since = None
                    self._transition(
                        rule, key, "resolved", value, now, detail
                    )

    def _evaluate(self, rule: AlertRule, now: float,
                  immediate: bool) -> None:
        conds = self._conditions(rule, now)
        for key, (cond, value, detail) in sorted(conds.items()):
            self._advance(
                rule, key, cond, value, now, detail,
                immediate=immediate,
            )
        # a key whose signal data vanished entirely (done worker aged
        # out of the window, stream gone) is condition-FALSE, not
        # frozen: an active alert must still be able to resolve
        for (rn, key), st in list(self._states.items()):
            if rn == rule.name and key not in conds \
                    and st.state != "inactive":
                self._advance(rule, key, False, None, now, {})

    def firing(self) -> List[Tuple[str, str]]:
        return sorted(
            k for k, st in self._states.items()
            if st.state == "firing"
        )

    # -- the cycle -------------------------------------------------------
    def poll(
        self, now: Optional[float] = None, *, immediate: bool = False
    ) -> List[Dict]:
        """One evaluation cycle; returns the transitions it caused."""
        now = self._now() if now is None else now
        if self._started_at is None:
            self._started_at = now
        faultinject.check("monitor.poll")
        telemetry.count(POLLS_COUNTER)
        events: List[Dict] = []
        if self.streams is not None:
            events.extend(self.streams.poll())
            telemetry.gauge(STREAMS_GAUGE, self.streams.stream_count())
        events.extend(self._lease_events(now))
        self._ingest(events, now)
        for _, probe in self._probes:
            ev = probe.poll(now)
            if ev is not None:
                self._buffer.append((now, ev))
        self._observe_signals(events, now)
        before = len(self.transitions)
        for rule in self.rules:
            self._evaluate(rule, now, immediate)
        telemetry.gauge(ACTIVE_GAUGE, len(self.firing()))
        if self.actions is not None:
            self.actions.flush()
        return self.transitions[before:]

    def run(
        self,
        interval: float = 1.0,
        *,
        stop: Optional[Callable[[], bool]] = None,
        max_seconds: Optional[float] = None,
    ) -> List[Dict]:
        """The follow loop: poll every ``interval`` seconds until the
        stop callable fires (SIGTERM drain) or the deadline passes.  A
        failing poll (disk hiccup, armed ``monitor.poll`` fault) is
        counted and retried next cycle — the monitor itself must be the
        most boring process on the box."""
        deadline = (
            time.monotonic() + max_seconds
            if max_seconds is not None else None
        )
        while True:
            if stop is not None and stop():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            try:
                self.poll()
            except OSError:
                telemetry.count(POLL_ERRORS_COUNTER)
            _sleep(interval)
        return self.transitions

    def once(self) -> List[Dict]:
        """Batch mode: consume the streams' full current content, then
        evaluate ONCE at event time (now = the newest event timestamp,
        so windows behave identically no matter when the verb runs) with
        ``for_seconds`` collapsed — a rule whose condition holds fires
        immediately.  Deterministic; the CI drill's mode."""
        events: List[Dict] = []
        if self.streams is not None:
            events.extend(self.streams.poll())
        wall = self._now()
        ts_vals = [
            float(e["ts"]) for e in events
            if isinstance(e.get("ts"), (int, float))
            and not isinstance(e.get("ts"), bool)
        ]
        now = max(ts_vals) + 1e-6 if ts_vals else wall
        self._started_at = now
        faultinject.check("monitor.poll")
        telemetry.count(POLLS_COUNTER)
        if self.streams is not None:
            telemetry.gauge(STREAMS_GAUGE, self.streams.stream_count())
        events.extend(self._lease_events(now))
        self._ingest(events, now)
        for _, probe in self._probes:
            ev = probe.poll(now)
            if ev is not None:
                self._buffer.append((now, ev))
        self._observe_signals(events, now)
        for rule in self.rules:
            self._evaluate(rule, now, True)
        telemetry.gauge(ACTIVE_GAUGE, len(self.firing()))
        if self.actions is not None:
            self.actions.flush()
        return self.transitions
