"""Recompile sentinel: distinct signatures per dispatch label.

``telemetry.dispatch`` keys every instrumented call to a stable (label,
signature) digest.  This module watches that stream for the failure mode
the digests make visible: a hot loop whose operand shapes are not
bucketed meets a new signature on every new shape.  In the JAX package
that is a retrace and a recompile; in the port nothing is compiled, but a
new signature is still a new shape a warm process had not run (a serve
replica past its warmup, say), and the sentinel counts it as the JAX
package does.

Per first call of each digest it records:

  * ``compile.<label>.signatures``       (gauge) distinct signatures seen
    for this dispatch label so far
  * ``compile.<digest>.compile_seconds`` (gauge) the first call's wall
    time, where that call built or loaded a kernel library (the port's
    one compile; ``telemetry.dispatch``)
  * ``compile.retraces``                 (counter) signatures beyond the
    first per label — 0 in a perfectly bucketed run
  * ``compile.time_to_first_dispatch_seconds`` (gauge) from the telemetry
    package's import to the process's first instrumented call's end

and stamps ``compile_ordinal``/``compile_seconds`` onto the digest's
``dispatch_executable`` event.  ``metrics compile-check run.jsonl
--baseline base.json`` fails when a label exceeds its committed
signature count or a new label appears; ``--write-baseline`` captures
one.  A copy of the JAX package's module.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional, Set

__all__ = [
    "DEFAULT_BASELINE_PATH",
    "note_first_call",
    "signatures",
    "reset",
    "load_baseline",
    "write_baseline",
    "check_counts",
]

DEFAULT_BASELINE_PATH = "scripts/records/compile_baseline.json"

_lock = threading.Lock()
# label -> [digest, ...] in first-seen order (the ordinal is the index+1)
_label_digests: Dict[str, List[str]] = {}
_first_dispatch_seen = False


def _process_t0() -> float:
    """The time-to-first-dispatch anchor: the telemetry PACKAGE import
    (process start for every driver).  This module loads lazily at the
    first dispatch, so its own import time would measure ~0."""
    from . import PROCESS_T0

    return PROCESS_T0


def signatures() -> Dict[str, int]:
    """Live label -> distinct-signature count (tests / REPL triage)."""
    with _lock:
        return {lbl: len(ds) for lbl, ds in _label_digests.items()}


def reset() -> None:
    global _first_dispatch_seen
    with _lock:
        _label_digests.clear()
    _first_dispatch_seen = False


def note_first_call(rec) -> None:
    """Record a digest's first instrumented call (dispatch calls this
    once per ExecutableRecord, after the call that traced/compiled —
    or, under the executable cache, deserialized)."""
    global _first_dispatch_seen
    from . import get_registry

    with _lock:
        seen = _label_digests.setdefault(rec.label, [])
        if rec.digest in seen:
            return
        seen.append(rec.digest)
        ordinal = len(seen)
    rec.compile_ordinal = ordinal
    reg = get_registry()
    if not _first_dispatch_seen:
        # the cold-start metric the executable cache exists to shrink:
        # how long did THIS process take to complete its first
        # instrumented dispatch (compile- or deserialize-dominated)
        _first_dispatch_seen = True
        reg.gauge("compile.time_to_first_dispatch_seconds").set(
            round(time.perf_counter() - _process_t0(), 6)
        )
    reg.gauge(f"compile.{rec.label}.signatures").set(ordinal)
    if rec.compile_seconds is not None:
        reg.gauge(f"compile.{rec.digest}.compile_seconds").set(
            rec.compile_seconds
        )
    if ordinal > 1 and rec.cache_status != "hit":
        # a hit DESERIALIZED a committed executable — nothing traced,
        # nothing compiled, so the retrace counter (the sentinel's
        # live-compile alarm, and serve's zero-recompile steady-state
        # contract) must not move; the signature gauge above still
        # records the ordinal so compile-check sees the same
        # per-label signature multiplicity either way
        reg.counter("compile.retraces").inc()


# ---------------------------------------------------------------------------
# baseline (the committed expected-signature table)
# ---------------------------------------------------------------------------
def load_baseline(path: str) -> Dict:
    with open(path, "r", encoding="utf-8") as f:
        base = json.load(f)
    if not isinstance(base.get("labels"), dict):
        raise ValueError(
            f"{path}: compile baseline needs a 'labels' object "
            "(label -> max expected signatures)"
        )
    return base


def write_baseline(
    path: str, counts: Dict[str, int], source: str,
    previous: Optional[Dict] = None,
) -> Dict:
    """Capture ``counts`` into ``path``, merging over any existing
    baseline: labels observed now are refreshed (max of old/new — a
    partial run must not silently LOWER a committed expectation),
    labels not exercised by this capture stay put."""
    labels = dict((previous or {}).get("labels", {}))
    for lbl, n in counts.items():
        labels[lbl] = max(int(n), int(labels.get(lbl, 0)))
    base = {
        "schema": 1,
        "source": source,
        "labels": {k: labels[k] for k in sorted(labels)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(base, f, indent=2, sort_keys=True)
        f.write("\n")
    return base


def check_counts(
    counts: Dict[str, int], baseline: Dict
) -> List[Dict]:
    """Findings for labels beyond the committed expectation.

    Two failure kinds, both deliberate-commit-gated like lint waivers:
    ``retrace_storm`` (more distinct signatures than committed — an
    unbucketed shape is re-tracing) and ``unknown_label`` (a dispatch
    label with no committed expectation at all)."""
    allowed = baseline.get("labels", {})
    finds: List[Dict] = []
    for lbl in sorted(counts):
        n = counts[lbl]
        if lbl not in allowed:
            finds.append({
                "kind": "unknown_label", "label": lbl,
                "signatures": n, "allowed": None,
            })
        elif n > int(allowed[lbl]):
            finds.append({
                "kind": "retrace_storm", "label": lbl,
                "signatures": n, "allowed": int(allowed[lbl]),
            })
    return finds


def counts_from_run(events, metrics) -> Dict[str, Set[str]]:
    """Per-label distinct digest sets from one run's events, with the
    registry-snapshot gauges as a floor (an event-truncated stream must
    not under-report a storm its snapshot recorded)."""
    per_label: Dict[str, Set[str]] = {}
    for e in events:
        if e.get("event") != "dispatch_executable":
            continue
        per_label.setdefault(str(e.get("label")), set()).add(
            str(e.get("digest"))
        )
    for k, v in metrics.items():
        pre, suf = "gauge.compile.", ".signatures"
        if k.startswith(pre) and k.endswith(suf):
            lbl = k[len(pre):-len(suf)]
            have = per_label.setdefault(lbl, set())
            # synthesize placeholder digests up to the gauge count
            for i in range(len(have), int(v)):
                have.add(f"<snapshot-{i}>")
    return per_label
