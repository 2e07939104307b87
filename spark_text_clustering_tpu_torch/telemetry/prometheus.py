"""Prometheus text exposition of a registry snapshot.

``stc serve``'s ``GET /metrics`` used to return only the ad-hoc JSON
registry dump; this module renders the SAME snapshot in the Prometheus
text exposition format (version 0.0.4) so standard scrapers work
against the service unmodified — content negotiation in the HTTP
handler picks the format from the ``Accept`` header.

Mapping:

  * counters -> ``# TYPE ... counter`` (name suffixed ``_total`` per
    convention);
  * gauges   -> ``# TYPE ... gauge``;
  * histograms -> ``# TYPE ... summary`` with ``quantile`` labels: the
    registry's fixed-bucket histograms snapshot p50/p95/p99 (+ sum and
    count), which maps exactly onto the summary type — by default
    bucket counts are not in the snapshot, and re-deriving ``le``
    buckets would invent data the registry never kept.  When the
    caller snapshots with ``include_buckets=True`` and renders with
    ``buckets=True`` (the serve endpoints' ``?format=prometheus&``
    ``buckets=1``), histograms become true ``# TYPE ... histogram``
    families with cumulative ``_bucket{le="..."}`` samples — enough
    for an external Prometheus to recompute latency-SLO burn rates
    with ``histogram_quantile`` / bucket ratios.

Metric names sanitize dots to underscores under an ``stc_`` namespace
(``serve.request_seconds`` -> ``stc_serve_request_seconds``); the
original dotted name travels in a ``# HELP`` line so dashboards can be
traced back to telemetry/names.py.

jax-free, stdlib-only, like every telemetry module.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["CONTENT_TYPE", "sanitize", "render", "wants_prometheus"]

# the 0.0.4 text format's canonical content type
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_]")

# per-replica dotted families (``front.replica.3.requests``) expose the
# index as a proper ``replica`` label instead of minting one series
# name per index — dashboards aggregate across the fleet with a single
# selector (docs/SERVING.md "Serve fleet")
_REPLICA_RE = re.compile(r"^(.*)\.replica\.(\d+)\.(.+)$")


def sanitize(name: str) -> str:
    """Dotted telemetry name -> Prometheus metric name."""
    return "stc_" + _SANITIZE_RE.sub("_", name)


def _labels_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _split(
    name: str, base: Optional[Dict[str, str]]
) -> Tuple[str, Dict[str, str]]:
    """(prometheus name, label set) for one dotted telemetry name."""
    labels = dict(base or {})
    m = _REPLICA_RE.match(name)
    if m:
        labels["replica"] = m.group(2)
        name = f"{m.group(1)}.replica.{m.group(3)}"
    return sanitize(name), labels


def _num(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(
    snapshot: Dict,
    labels: Optional[Dict[str, str]] = None,
    *,
    buckets: bool = False,
) -> str:
    """The exposition text for one ``MetricRegistry.snapshot()``.

    ``labels`` stamps every sample with a constant label set — a fleet
    replica passes ``{"replica": "2"}`` so N scraped replicas land as
    one labeled family instead of N colliding series.  Per-replica
    dotted names additionally surface their embedded index as the same
    ``replica`` label (see ``_REPLICA_RE``).  HELP/TYPE lines are
    emitted once per metric name (repeat label sets share them).

    ``buckets=True`` renders histograms whose snapshot carries bucket
    data (``MetricRegistry.snapshot(include_buckets=True)``) as native
    Prometheus histogram families: cumulative ``_bucket{le="<bound>"}``
    samples plus the mandatory ``le="+Inf"`` total, then ``_sum`` /
    ``_count``.  Histograms without bucket data still fall back to the
    summary mapping so mixed snapshots stay renderable.
    """
    lines: List[str] = []
    typed: set = set()

    def head(pn: str, kind: str, name: str, note: str = "") -> None:
        if pn in typed:
            return
        typed.add(pn)
        lines.append(f"# HELP {pn} {kind} {name}{note}")
        lines.append(f"# TYPE {pn} {kind}")

    for name, v in sorted(snapshot.get("counters", {}).items()):
        pn, lbl = _split(name, labels)
        pn += "_total"
        head(pn, "counter", name)
        lines.append(f"{pn}{_labels_text(lbl)} {_num(v)}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        pn, lbl = _split(name, labels)
        head(pn, "gauge", name)
        lines.append(f"{pn}{_labels_text(lbl)} {_num(v)}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        pn, lbl = _split(name, labels)
        bounds = h.get("buckets")
        counts = h.get("bucket_counts")
        if buckets and isinstance(bounds, list) \
                and isinstance(counts, list) \
                and len(counts) == len(bounds) + 1:
            head(pn, "histogram", name)
            acc = 0
            for bound, c in zip(bounds, counts):
                acc += int(c)
                blbl = dict(lbl)
                blbl["le"] = _num(bound)
                lines.append(
                    f"{pn}_bucket{_labels_text(blbl)} {acc}"
                )
            acc += int(counts[-1])
            blbl = dict(lbl)
            blbl["le"] = "+Inf"
            lines.append(f"{pn}_bucket{_labels_text(blbl)} {acc}")
        else:
            head(pn, "summary", name, note=" (histogram)")
            for q, fld in (
                ("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")
            ):
                qlbl = dict(lbl)
                qlbl["quantile"] = q
                lines.append(
                    f"{pn}{_labels_text(qlbl)} {_num(h.get(fld))}"
                )
        lines.append(
            f"{pn}_sum{_labels_text(lbl)} {_num(h.get('sum', 0.0))}"
        )
        lines.append(
            f"{pn}_count{_labels_text(lbl)} {_num(h.get('count', 0))}"
        )
    return "\n".join(lines) + "\n"


def wants_prometheus(accept: str) -> bool:
    """Content negotiation: a scraper asking for text exposition
    (Prometheus sends ``text/plain;version=...`` and/or
    ``application/openmetrics-text``) gets it; everything else —
    including the existing JSON consumers, which send no Accept or
    ``application/json`` — keeps the ad-hoc JSON dump."""
    accept = (accept or "").lower()
    if "application/json" in accept:
        return False
    return "text/plain" in accept or "openmetrics" in accept
