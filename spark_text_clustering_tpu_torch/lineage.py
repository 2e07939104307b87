"""Model lineage walker: served byte -> publish epoch -> source files,
copied from the JAX package (the ``lineage`` verb of the CLI).

``lineage <target>`` answers the question a production incident starts
with: *which worker, epoch, and source files produced the model
generation that served this response?*  It walks the durable records the
tracing layer (``telemetry.tracing``) stamps end to end:

    response JSON / trace id
        -> model attribution (dir + ledger_ref + publish trace)
        -> model-publish ledger record (the model's birth certificate)
        -> contributing stream-train epochs (committed source set,
           worker / generation / spawn identity, per-epoch trace spans)
        -> the fleet's OTHER workers (``--fleet-dir``: every worker
           ledger joins the committed source union)
        -> the request's span chain + the serve-side dispatch digests
           (``--telemetry`` run streams)

Accepted targets, auto-detected (``resolve_target``):

* a **model dir** (has ``meta.json``),
* a **response JSON file** (a ``serve`` POST /score body: it carries
  ``model`` attribution and the request ``trace``),
* a **trace id** (32-hex or a full traceparent string) resolved through
  the ``trace_request`` events of the given ``--telemetry`` streams.

The records may come from either package: both write the same ledger,
``meta.json``, response and event formats, and the walk over them gives
the same report and the same tree.

Degradation is typed, never a crash: a torn/corrupt ledger tail, an
unreadable meta, or legacy pre-trace records produce ``degraded``
entries (counted in ``lineage.degraded``) and ``"unknown"`` trace
fields; the walk always returns a report.  Fault site ``lineage.read``
(``faultinject.SITES``) arms the read edges.  Neither torch nor jax is
imported here.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Sequence

from . import telemetry
from .resilience import CorruptArtifactError, faultinject

__all__ = [
    "resolve_target",
    "walk",
    "span_attribution",
    "render_tree",
]

_TRACE_ID_RE = re.compile(r"^[0-9a-f]{32}$")

UNKNOWN = "unknown"

WALKS_COUNTER = "lineage.walks"
DEGRADED_COUNTER = "lineage.degraded"


def _degrade(report: Dict, what: str) -> None:
    telemetry.count(DEGRADED_COUNTER)
    report.setdefault("degraded", []).append(what)


def _read_json(path: str) -> Dict:
    faultinject.check("lineage.read")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _trace_of(record: Optional[Dict]) -> Dict:
    trace = (record or {}).get("trace")
    if isinstance(trace, dict) and trace.get("trace_id"):
        return {
            "trace_id": trace.get("trace_id"),
            "span_id": trace.get("span_id"),
            "parent_span_id": trace.get("parent_span_id"),
        }
    return {"trace_id": UNKNOWN}


# ---------------------------------------------------------------------------
# target resolution
# ---------------------------------------------------------------------------
def resolve_target(
    target: str,
    *,
    telemetry_events: Optional[List[Dict]] = None,
) -> Dict:
    """Classify ``target`` and extract the walk's entry point.

    Returns ``{"kind": "model"|"response"|"trace", ...}`` with
    ``model_dir`` / ``ledger_ref`` / ``trace_id`` filled in as far as
    the target carries them.  Unresolvable targets return ``kind:
    "unknown"`` with a reason instead of raising.
    """
    from .telemetry import tracing

    parsed = tracing.parse(target)
    trace_id = None
    if parsed is not None:
        trace_id = parsed.trace_id
    elif _TRACE_ID_RE.match(target.strip().lower()):
        trace_id = target.strip().lower()
    if trace_id is not None:
        out: Dict = {"kind": "trace", "trace_id": trace_id}
        # a trace id alone names nothing durable — the trace_request
        # event in a serve run stream is the join to the model side
        for e in telemetry_events or []:
            if e.get("event") == "trace_request" \
                    and e.get("trace_id") == trace_id:
                out["model_dir"] = e.get("model")
                out["epoch"] = e.get("epoch")
                break
        else:
            if telemetry_events is not None:
                out["reason"] = (
                    "no trace_request event with this trace id in the "
                    "given --telemetry stream(s)"
                )
        return out
    if os.path.isdir(target):
        if os.path.exists(os.path.join(target, "meta.json")):
            return {"kind": "model", "model_dir": target}
        return {
            "kind": "unknown",
            "reason": f"{target}: directory without a meta.json "
                      f"(not a model artifact)",
        }
    if os.path.isfile(target):
        try:
            doc = _read_json(target)
        except (OSError, json.JSONDecodeError) as exc:
            return {
                "kind": "unknown",
                "reason": f"{target}: unreadable response JSON ({exc})",
            }
        attr = doc.get("model") if isinstance(doc, dict) else None
        if not isinstance(attr, dict) or not attr.get("model"):
            return {
                "kind": "unknown",
                "reason": f"{target}: JSON without serve 'model' "
                          f"attribution",
            }
        out = {
            "kind": "response",
            "model_dir": attr["model"],
            "ledger_ref": attr.get("ledger_ref"),
            "epoch": attr.get("epoch"),
        }
        trace = doc.get("trace")
        if isinstance(trace, dict) and trace.get("trace_id"):
            out["trace_id"] = trace["trace_id"]
        pub = attr.get("publish_trace")
        if isinstance(pub, dict) and pub.get("trace_id"):
            out["publish_trace_id"] = pub["trace_id"]
        return out
    return {
        "kind": "unknown",
        "reason": f"{target}: not a model dir, a response JSON file, "
                  f"or a trace id",
    }


# ---------------------------------------------------------------------------
# ledger walking
# ---------------------------------------------------------------------------
def _ledger_records(directory: str, report: Dict) -> List[Dict]:
    """Committed records of one ledger dir, degrading typed: a torn or
    checksum-corrupt suffix yields the readable prefix (or nothing)
    plus a ``degraded`` note — archaeology over a damaged dir must
    still print the epochs it CAN trust."""
    from .resilience.ledger import EpochLedger

    try:
        faultinject.check("lineage.read")
        return EpochLedger(directory).records()
    except (OSError, CorruptArtifactError, ValueError) as exc:
        _degrade(report, f"{directory}: unreadable ledger ({exc})")
        return []


def _walk_worker_ledger(
    directory: str,
    report: Dict,
    *,
    worker: Optional[int] = None,
    publish_epoch: Optional[int] = None,
    model_dir: Optional[str] = None,
) -> Dict:
    """One worker ledger -> its committed lineage contribution."""
    records = _ledger_records(directory, report)
    entry: Dict = {
        "ledger_dir": directory,
        "worker": worker,
        "epochs": [],
        "sources": set(),
    }
    for rec in records:
        kind = rec.get("kind")
        trace = _trace_of(rec)
        if kind == "model-publish":
            ref = rec.get("model_ref")
            ref_dir = ref.get("dir") if isinstance(ref, dict) else ref
            matches = (
                publish_epoch is not None
                and rec.get("epoch") == publish_epoch
            ) or (
                model_dir is not None
                and ref_dir is not None
                and os.path.abspath(str(ref_dir))
                == os.path.abspath(str(model_dir))
            )
            if matches or (publish_epoch is None and model_dir is None):
                entry["publish"] = {
                    "epoch": rec.get("epoch"),
                    "model_ref": ref,
                    **trace,
                    **{
                        k: rec[k]
                        for k in ("worker", "generation", "spawn_id")
                        if k in rec
                    },
                }
            continue
        srcs = list(rec.get("sources", ()))
        entry["sources"].update(srcs)
        epoch_row = {
            "epoch": rec.get("epoch"),
            "kind": kind,
            "sources": len(srcs),
            **trace,
        }
        for k in ("worker", "generation", "spawn_id"):
            if k in rec:
                epoch_row[k] = rec[k]
        if kind == "snapshot":
            # compaction folded per-epoch history: the source union,
            # the newest epoch, and the pinned model_ref survive;
            # per-epoch traces do not
            epoch_row["compacted_epochs"] = rec.get("compacted_epochs")
            ref = rec.get("model_ref")
            if ref is not None and "publish" not in entry:
                entry["publish"] = {
                    "epoch": rec.get("epoch"),
                    "model_ref": ref,
                    "compacted": True,
                    **trace,
                }
            _degrade(
                report,
                f"{directory}: epoch history compacted "
                f"({rec.get('compacted_epochs')} records folded) — "
                f"per-epoch traces reduced to the snapshot",
            )
        elif trace["trace_id"] == UNKNOWN:
            _degrade(
                report,
                f"{directory}: epoch {rec.get('epoch')} predates "
                f"causal tracing — unknown lineage for its span",
            )
        entry["epochs"].append(epoch_row)
    entry["sources"] = sorted(entry["sources"])
    return entry


# ---------------------------------------------------------------------------
# span attribution (the request side)
# ---------------------------------------------------------------------------
def span_attribution(
    events: List[Dict], trace_id: str
) -> Optional[Dict]:
    """The request trace's span graph health: every emitted span must
    attach to the chain.  A span is *unattributed* when its parent id
    resolves to no emitted span AND it is not the request root (whose
    parent is the caller's span, outside our streams by design)."""
    spans = [
        e for e in events
        if e.get("event") == "trace_span"
        and e.get("trace_id") == trace_id
    ]
    if not spans:
        return None
    roots = {
        e.get("span_id") for e in events
        if e.get("event") == "trace_request"
        and e.get("trace_id") == trace_id
    }
    ids = {s.get("span_id") for s in spans}
    unattributed = [
        s.get("name", "?") for s in spans
        if s.get("span_id") not in roots
        and s.get("parent_span_id") not in ids
    ]
    return {
        "total": len(spans),
        "names": sorted({str(s.get("name", "?")) for s in spans}),
        "unattributed": len(unattributed),
        "unattributed_names": sorted(unattributed),
    }


def _serve_digests(events: List[Dict]) -> List[Dict]:
    """The compile-cache / dispatch digests that served the bytes: the
    serve-labeled executable announcements of the given streams."""
    out, seen = [], set()
    for e in events:
        if e.get("event") != "dispatch_executable":
            continue
        label = str(e.get("label", ""))
        if not label.startswith("serve."):
            continue
        digest = e.get("digest")
        if digest in seen:
            continue
        seen.add(digest)
        out.append({
            "label": label,
            "digest": digest,
            "cache": e.get("cache"),
        })
    return sorted(out, key=lambda r: (r["label"], str(r["digest"])))


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------
def walk(
    target: str,
    *,
    fleet_dir: Optional[str] = None,
    ledger_dir: Optional[str] = None,
    telemetry_paths: Sequence[str] = (),
) -> Dict:
    """Full lineage report for ``target`` (see module docstring)."""
    from .telemetry.metrics_cli import load_run

    events: List[Dict] = []
    bad_streams: List[str] = []
    for path in telemetry_paths:
        try:
            faultinject.check("lineage.read")
            _, evs = load_run(path)
            events.extend(evs)
        except (OSError, json.JSONDecodeError) as exc:
            # keep walking with whatever streams DID read
            bad_streams.append(
                f"{path}: unreadable telemetry stream ({exc})"
            )

    resolved = resolve_target(target, telemetry_events=events)
    report: Dict = {
        "target": target,
        "kind": resolved["kind"],
        "degraded": [],
    }
    for note in bad_streams:
        _degrade(report, note)
    if "trace_id" in resolved:
        report["trace_id"] = resolved["trace_id"]
    if resolved["kind"] == "unknown":
        _degrade(report, resolved.get("reason", "unresolvable target"))
        report["lineage"] = UNKNOWN
        return report

    # -- model side ------------------------------------------------------
    model_dir = resolved.get("model_dir")
    ledger_ref = resolved.get("ledger_ref")
    publish_epoch = resolved.get("epoch")
    if model_dir and not ledger_ref:
        meta_path = os.path.join(str(model_dir), "meta.json")
        try:
            meta = _read_json(meta_path)
            ledger_ref = meta.get("ledger_ref")
            if publish_epoch is None:
                publish_epoch = (ledger_ref or {}).get("epoch")
        except (OSError, json.JSONDecodeError) as exc:
            _degrade(report, f"{meta_path}: unreadable meta ({exc})")
    if isinstance(ledger_ref, dict):
        if publish_epoch is None:
            publish_epoch = ledger_ref.get("epoch")
        if ledger_dir is None:
            ledger_dir = ledger_ref.get("dir")
    if model_dir:
        report["model"] = {
            "dir": model_dir,
            "publish_epoch": publish_epoch,
            "ledger_dir": ledger_dir,
        }

    # -- ledger side -----------------------------------------------------
    workers: List[Dict] = []
    if fleet_dir:
        from .resilience.supervisor import _worker_dirs

        wdirs = _worker_dirs(fleet_dir)
        if not wdirs:
            _degrade(report, f"{fleet_dir}: no worker ledger dirs")
        for wd in wdirs:
            try:
                widx = int(os.path.basename(wd)[1:])
            except ValueError:
                widx = None
            workers.append(_walk_worker_ledger(
                wd, report, worker=widx,
                publish_epoch=publish_epoch, model_dir=model_dir,
            ))
    elif ledger_dir:
        workers.append(_walk_worker_ledger(
            ledger_dir, report,
            publish_epoch=publish_epoch, model_dir=model_dir,
        ))
    elif resolved["kind"] in ("model", "response"):
        _degrade(
            report,
            "no ledger to walk (model has no ledger_ref and neither "
            "--ledger-dir nor --fleet-dir was given) — unknown lineage",
        )
    if workers:
        report["workers"] = workers
        report["sources"] = sorted(
            {src for w in workers for src in w["sources"]}
        )
        publish = next(
            (w.get("publish") for w in workers if w.get("publish")),
            None,
        )
        if publish is not None:
            report.setdefault("model", {})["publish"] = publish
            if report["model"].get("publish_epoch") is None:
                report["model"]["publish_epoch"] = publish.get("epoch")
        elif report.get("model") is not None:
            _degrade(
                report,
                "no model-publish record matched the target — the "
                "publish epoch could not be confirmed from the ledger",
            )

    # -- request side ----------------------------------------------------
    if events:
        trace_id = report.get("trace_id")
        if trace_id:
            spans = span_attribution(events, trace_id)
            if spans is not None:
                report["spans"] = spans
            else:
                _degrade(
                    report,
                    f"trace {trace_id}: no spans in the given "
                    f"--telemetry stream(s) (unsampled or wrong run?)",
                )
        digests = _serve_digests(events)
        if digests:
            report["compile_digests"] = digests

    report["lineage"] = (
        "resolved" if report.get("sources") else UNKNOWN
    )
    telemetry.count(WALKS_COUNTER)
    return report


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------
def render_tree(report: Dict) -> str:
    """The human tree (``--json`` prints the raw report instead)."""
    lines: List[str] = [f"lineage: {report['target']} "
                        f"[{report['kind']}, {report['lineage']}]"]
    if report.get("trace_id"):
        lines.append(f"├─ trace {report['trace_id']}")
        spans = report.get("spans")
        if spans:
            chain = " -> ".join(spans["names"])
            lines.append(
                f"│    spans: {spans['total']} total, "
                f"{spans['unattributed']} unattributed ({chain})"
            )
    model = report.get("model")
    if model:
        lines.append(f"├─ model {model['dir']}")
        pub = model.get("publish")
        if pub:
            who = ", ".join(
                f"{k} {pub[k]}"
                for k in ("worker", "generation", "spawn_id")
                if k in pub
            )
            lines.append(
                f"│    published by epoch {pub.get('epoch')} of "
                f"{model.get('ledger_dir')}"
                + (f"  [{who}]" if who else "")
            )
            lines.append(
                f"│    publish trace: {pub.get('trace_id', UNKNOWN)}"
            )
        elif model.get("publish_epoch") is not None:
            lines.append(
                f"│    publish epoch {model['publish_epoch']} "
                f"(unconfirmed by ledger)"
            )
    for w in report.get("workers", ()):
        head = (
            f"├─ worker {w['worker']}" if w.get("worker") is not None
            else "├─ ledger"
        )
        lines.append(
            f"{head} {w['ledger_dir']}: {len(w['epochs'])} committed "
            f"epoch(s), {len(w['sources'])} source file(s)"
        )
        for row in w["epochs"]:
            who = ", ".join(
                f"{k} {row[k]}"
                for k in ("generation", "spawn_id") if k in row
            )
            lines.append(
                f"│    epoch {row['epoch']} ({row['kind']}): "
                f"{row['sources']} source(s), trace "
                f"{row.get('trace_id', UNKNOWN)}"
                + (f"  [{who}]" if who else "")
            )
    sources = report.get("sources")
    if sources is not None:
        lines.append(f"├─ committed source set ({len(sources)}):")
        for src in sources:
            lines.append(f"│    {src}")
    for d in report.get("compile_digests", ()):
        cache = f", cache {d['cache']}" if d.get("cache") else ""
        lines.append(
            f"├─ served by executable {d['label']} "
            f"[{d['digest']}]{cache}"
        )
    for note in report.get("degraded", ()):
        lines.append(f"└─ DEGRADED: {note}")
    return "\n".join(lines)
