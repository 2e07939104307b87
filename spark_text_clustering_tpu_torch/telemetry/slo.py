"""Service-level objectives: declarative targets, error budgets, and
multi-window burn-rate evaluation (docs/OBSERVABILITY.md "SLOs & error
budgets").

The serve fleet answers requests; this module holds the *promises*
about them.  An objective declares what fraction of typed request
events must be good (``availability``) or fast (``latency``) over a
rolling budget window; the evaluator turns an event stream into:

  * **error-budget accounting** — the fraction of the budget window's
    allowance ``1 - target`` already consumed by bad events;
  * **multi-window multi-burn-rate signals** (the Google-SRE alerting
    recipe): a ``fast`` pair (5 m short / 1 h long, burn >= 14.4x) that
    pages on budget-in-hours incidents, and a ``slow`` pair (30 m / 6 h,
    burn >= 6x) that tickets sustained slow leaks.  An alert condition
    requires BOTH windows of a pair over threshold, so a short blip
    neither pages (long window dilutes it) nor lingers (short window
    resolves the moment the bleeding stops).

Objectives are declared in JSON with the same UX as alert rules (a
built-in set, a ``--slo`` file that retunes or replaces by name), and a
``compression`` knob divides every window so CI can drill hour-scale
burn behavior in seconds without forking the thresholds.

Event sources are the typed per-request records the serving layer
emits: ``front_request`` (inside-out, every exit path of the routing
front) and ``probe_request`` (outside-in, the ``stc probe`` canary).
Latency objectives classify per-event ``seconds`` against a threshold;
picking a threshold that is one of the registry's fixed bucket bounds
(``registry.DEFAULT_SECONDS_BUCKETS``) makes the same fraction exactly
recomputable from the histogram's cumulative ``_bucket`` counts on the
Prometheus exposition (``fraction_under``) — the stream and the
scrape agree by construction.

jax-free and stdlib-only, like every telemetry module.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import telemetry

__all__ = [
    "SLO_KINDS",
    "DEFAULT_WINDOWS",
    "DEFAULT_BUDGET_WINDOW_SECONDS",
    "SLOObjective",
    "SLOConfig",
    "BUILTIN_OBJECTIVES",
    "objective_from_dict",
    "config_from_dict",
    "builtin_config",
    "classify",
    "evaluate",
    "evaluate_all",
    "publish",
    "fraction_under",
]

SLO_KINDS = ("availability", "latency")

# The Google-SRE multi-window pairs: (long, short, burn-rate factor).
# A pair's condition holds only when BOTH windows burn >= factor; the
# factors are calibrated so `fast` exhausts ~2% of a 30-day budget in
# its hour and `slow` ~10% in its six.
DEFAULT_WINDOWS: Tuple[Dict, ...] = (
    {"name": "fast", "long_seconds": 3600.0, "short_seconds": 300.0,
     "factor": 14.4},
    {"name": "slow", "long_seconds": 21600.0, "short_seconds": 1800.0,
     "factor": 6.0},
)

DEFAULT_BUDGET_WINDOW_SECONDS = 30.0 * 24.0 * 3600.0

# one [a-z0-9_] segment: objective and window names mint gauge segments
# (slo.<objective>.burn_<window>), so they must be NAME_RE-clean
_SEGMENT_RE = re.compile(r"^[a-z0-9_]+$")

# a latency threshold equal to a registry bucket bound keeps the
# event-stream fraction and the histogram-bucket fraction identical;
# 1e-5 * 2**15 = 0.32768 s is the default "fast enough" line for a
# front-routed scoring request
DEFAULT_LATENCY_THRESHOLD = 1e-5 * (2.0 ** 15)

_EPS = 1e-12


@dataclass
class SLOObjective:
    """One declared promise over a typed request-event stream.

    ``availability``: an event is good when every ``good_where`` field
    matches (``{"outcome": "ok"}``).  ``latency``: an event is good
    when ``field`` (default ``seconds``) is <= ``threshold_seconds``;
    an event missing the field counts BAD — a request that never
    produced a latency did not meet the promise.  ``where`` pre-filters
    which events the objective sees at all; ``source`` labels the
    vantage point (``serve`` inside-out, ``probe`` outside-in) for
    rendering only.
    """

    name: str
    event: str
    kind: str = "availability"
    target: float = 0.99
    good_where: Optional[Dict] = None
    where: Optional[Dict] = None
    field: str = "seconds"
    threshold_seconds: Optional[float] = None
    source: str = "serve"
    description: str = ""

    def __post_init__(self) -> None:
        if not _SEGMENT_RE.match(self.name or ""):
            raise ValueError(
                f"objective name {self.name!r} must be one snake_case "
                f"segment (it mints slo.<name>.* gauges)"
            )
        if self.kind not in SLO_KINDS:
            raise ValueError(
                f"objective {self.name!r}: unknown kind {self.kind!r} "
                f"(one of {SLO_KINDS})"
            )
        if not self.event:
            raise ValueError(
                f"objective {self.name!r}: needs an 'event' selector"
            )
        if not (0.0 < float(self.target) < 1.0):
            raise ValueError(
                f"objective {self.name!r}: target must be in (0, 1), "
                f"got {self.target!r}"
            )
        self.target = float(self.target)
        if self.kind == "availability":
            if not isinstance(self.good_where, dict) or \
                    not self.good_where:
                raise ValueError(
                    f"objective {self.name!r}: availability objectives "
                    f"need a non-empty good_where field match"
                )
        else:
            if self.threshold_seconds is None:
                self.threshold_seconds = DEFAULT_LATENCY_THRESHOLD
            self.threshold_seconds = float(self.threshold_seconds)
            if self.threshold_seconds <= 0:
                raise ValueError(
                    f"objective {self.name!r}: threshold_seconds must "
                    f"be > 0"
                )


@dataclass
class SLOConfig:
    """The evaluated set: objectives + window pairs + budget window,
    with one ``compression`` knob dividing every window length (CI
    drills hour-scale burns in seconds; thresholds never change)."""

    objectives: List[SLOObjective] = field(default_factory=list)
    windows: List[Dict] = field(
        default_factory=lambda: [dict(w) for w in DEFAULT_WINDOWS]
    )
    budget_window_seconds: float = DEFAULT_BUDGET_WINDOW_SECONDS
    compression: float = 1.0

    def __post_init__(self) -> None:
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.compression = float(self.compression)
        if self.compression <= 0:
            raise ValueError("compression must be > 0")
        self.budget_window_seconds = float(self.budget_window_seconds)
        if self.budget_window_seconds <= 0:
            raise ValueError("budget_window_seconds must be > 0")
        for w in self.windows:
            if not _SEGMENT_RE.match(str(w.get("name", ""))):
                raise ValueError(
                    f"window name {w.get('name')!r} must be one "
                    f"snake_case segment"
                )
            long_s = float(w.get("long_seconds", 0.0))
            short_s = float(w.get("short_seconds", 0.0))
            if not (long_s > short_s > 0.0):
                raise ValueError(
                    f"window {w['name']!r}: need long_seconds > "
                    f"short_seconds > 0"
                )
            if float(w.get("factor", 0.0)) <= 0:
                raise ValueError(
                    f"window {w['name']!r}: factor must be > 0"
                )

    def scale(self, seconds: float) -> float:
        return float(seconds) / self.compression

    def max_window_seconds(self) -> float:
        """The widest span evaluation ever looks back — the alert
        engine's buffer-pruning horizon must cover it."""
        spans = [self.scale(self.budget_window_seconds)]
        spans += [self.scale(w["long_seconds"]) for w in self.windows]
        return max(spans)


# Built-ins: the serving layer's two request-event sources, each with
# an availability and a latency promise.  Targets are deliberately
# modest live defaults — retune per deployment via the --slo file.
BUILTIN_OBJECTIVES: Dict[str, Dict] = {
    "front_availability": {
        "kind": "availability", "event": "front_request",
        "target": 0.99, "good_where": {"outcome": "ok"},
        "source": "serve",
        "description": "front-routed requests that returned 200 "
                       "(every non-ok outcome spends budget: error "
                       "status, retry exhaustion, empty rotation)",
    },
    "front_latency": {
        "kind": "latency", "event": "front_request",
        "target": 0.99, "field": "seconds",
        "threshold_seconds": DEFAULT_LATENCY_THRESHOLD,
        "source": "serve",
        "description": "front-routed requests answered inside the "
                       "latency line (bucket-aligned: the Prometheus "
                       "_bucket export recomputes this fraction "
                       "exactly)",
    },
    "probe_availability": {
        "kind": "availability", "event": "probe_request",
        "target": 0.99, "good_where": {"outcome": "ok"},
        "source": "probe",
        "description": "outside-in: sentinel canary requests (stc "
                       "probe) that came back 200 through the front",
    },
    "probe_latency": {
        "kind": "latency", "event": "probe_request",
        "target": 0.99, "field": "seconds",
        "threshold_seconds": DEFAULT_LATENCY_THRESHOLD,
        "source": "probe",
        "description": "outside-in: sentinel canary requests answered "
                       "inside the latency line",
    },
    # per-priority-class promises (the overload drill's evidence):
    # interactive holds the strict line while batch sheds first, so its
    # objectives pre-filter on the priority the probe stamped
    "probe_interactive_availability": {
        "kind": "availability", "event": "probe_request",
        "target": 0.99, "good_where": {"outcome": "ok"},
        "where": {"priority": "interactive"},
        "source": "probe",
        "description": "outside-in, interactive class only: the "
                       "strict promise that must HOLD while the fleet "
                       "sheds batch under overload",
    },
    "probe_interactive_latency": {
        "kind": "latency", "event": "probe_request",
        "target": 0.99, "field": "seconds",
        "threshold_seconds": DEFAULT_LATENCY_THRESHOLD,
        "where": {"priority": "interactive"},
        "source": "probe",
        "description": "outside-in, interactive class only: p99 "
                       "inside the latency line even past fleet "
                       "saturation (admission control's job)",
    },
    "probe_batch_availability": {
        "kind": "availability", "event": "probe_request",
        "target": 0.5, "good_where": {"outcome": "ok"},
        "where": {"priority": "batch"},
        "source": "probe",
        "description": "outside-in, batch class: deliberately loose — "
                       "batch sheds FIRST under pressure (typed 429s "
                       "spend this budget by design), it just must "
                       "not starve outright",
    },
    "front_goodput": {
        "kind": "availability", "event": "front_request",
        "target": 0.9, "good_where": {"outcome": "ok"},
        "source": "serve",
        "description": "goodput: front requests that produced a real "
                       "answer — typed sheds/rejections spend this "
                       "budget, so a flat good fraction past "
                       "saturation is the overload-control win "
                       "condition (vs availability's stricter target)",
    },
}


def objective_from_dict(spec: Dict) -> SLOObjective:
    """An ``SLOObjective`` from one JSON object (the ``--slo`` file
    format mirrors the alert-rules file: a list of these)."""
    known = {
        "name", "kind", "event", "target", "good_where", "where",
        "field", "threshold_seconds", "source", "description",
    }
    extra = set(spec) - known
    if extra:
        raise ValueError(
            f"objective {spec.get('name', '?')!r}: unknown field(s) "
            f"{sorted(extra)}"
        )
    if "name" not in spec:
        raise ValueError("every objective needs a 'name'")
    return SLOObjective(**spec)


def config_from_dict(doc) -> SLOConfig:
    """A full ``SLOConfig`` from the ``--slo`` file: either a bare list
    of objective objects, or ``{"objectives": [...], "windows": [...],
    "budget_window_seconds": ..., "compression": ...}`` — a named
    built-in objective in the list retunes it (merge semantics, same as
    alert rules)."""
    if isinstance(doc, list):
        doc = {"objectives": doc}
    if not isinstance(doc, dict):
        raise ValueError(
            "SLO config: want a JSON list of objectives or an object "
            "with an 'objectives' list"
        )
    specs = doc.get("objectives", [])
    if not isinstance(specs, list):
        raise ValueError("SLO config: 'objectives' must be a list")
    objectives: List[SLOObjective] = []
    for spec in specs:
        if not isinstance(spec, dict) or "name" not in spec:
            raise ValueError("every objective needs a 'name'")
        name = str(spec["name"])
        if name in BUILTIN_OBJECTIVES:
            merged = dict(BUILTIN_OBJECTIVES[name], name=name)
            merged.update({k: v for k, v in spec.items()})
            objectives.append(objective_from_dict(merged))
        else:
            objectives.append(objective_from_dict(spec))
    kwargs: Dict = {"objectives": objectives}
    for k in ("windows", "budget_window_seconds", "compression"):
        if k in doc:
            kwargs[k] = doc[k]
    return SLOConfig(**kwargs)


def builtin_config(compression: float = 1.0) -> SLOConfig:
    return SLOConfig(
        objectives=[
            objective_from_dict(dict(spec, name=name))
            for name, spec in sorted(BUILTIN_OBJECTIVES.items())
        ],
        compression=compression,
    )


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------
def classify(obj: SLOObjective, e: Dict) -> Optional[bool]:
    """True good / False bad / None not-this-objective's-event."""
    if e.get("event") != obj.event:
        return None
    for f, want in (obj.where or {}).items():
        if e.get(f) != want:
            return None
    if obj.kind == "availability":
        return all(
            e.get(f) == want for f, want in obj.good_where.items()
        )
    v = e.get(obj.field)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return False                    # no latency recorded: not met
    return float(v) <= obj.threshold_seconds + _EPS


def _window_counts(
    matched: Sequence[Tuple[float, bool]], lo: float
) -> Tuple[int, int]:
    good = total = 0
    for ts, is_good in matched:
        if ts < lo:
            continue
        total += 1
        if is_good:
            good += 1
    return good, total


def _burn(good: int, total: int, target: float) -> Optional[float]:
    """bad-fraction / allowed-bad-fraction; None with no data."""
    if total <= 0:
        return None
    bad = (total - good) / total
    return bad / max(1.0 - target, _EPS)


def evaluate(
    obj: SLOObjective,
    cfg: SLOConfig,
    events: Iterable[Tuple[float, Dict]],
    now: float,
) -> Dict:
    """One objective over ``(ts, event)`` pairs at time ``now``:
    budget accounting over the (compressed) budget window, burn rates
    per window pair, and a single ``status`` roll-up."""
    matched: List[Tuple[float, bool]] = []
    for ts, e in events:
        g = classify(obj, e)
        if g is not None:
            matched.append((ts, g))

    b_good, b_total = _window_counts(
        matched, now - cfg.scale(cfg.budget_window_seconds)
    )
    good_fraction = (b_good / b_total) if b_total else None
    consumed = _burn(b_good, b_total, obj.target)
    budget_remaining = (
        max(0.0, 1.0 - consumed) if consumed is not None else None
    )

    windows: List[Dict] = []
    burning = False
    for w in cfg.windows:
        lg, lt = _window_counts(
            matched, now - cfg.scale(w["long_seconds"])
        )
        sg, st = _window_counts(
            matched, now - cfg.scale(w["short_seconds"])
        )
        burn_long = _burn(lg, lt, obj.target)
        burn_short = _burn(sg, st, obj.target)
        factor = float(w["factor"])
        w_burning = (
            burn_long is not None and burn_short is not None
            and burn_long >= factor and burn_short >= factor
        )
        burning = burning or w_burning
        windows.append({
            "name": str(w["name"]),
            "long_seconds": cfg.scale(w["long_seconds"]),
            "short_seconds": cfg.scale(w["short_seconds"]),
            "factor": factor,
            "burn_long": burn_long,
            "burn_short": burn_short,
            "burn": (
                min(burn_long, burn_short)
                if burn_long is not None and burn_short is not None
                else None
            ),
            "burning": w_burning,
        })

    if b_total == 0:
        status = "no_data"
    elif budget_remaining is not None and budget_remaining <= 0.0:
        status = "exhausted"
    elif burning:
        status = "burning"
    else:
        status = "ok"
    return {
        "objective": obj.name,
        "kind": obj.kind,
        "source": obj.source,
        "target": obj.target,
        "good": b_good,
        "total": b_total,
        "good_fraction": good_fraction,
        "budget_consumed": consumed,
        "budget_remaining": budget_remaining,
        "windows": windows,
        "burning": burning,
        "status": status,
    }


def evaluate_all(
    cfg: SLOConfig,
    events: Iterable[Tuple[float, Dict]],
    now: float,
) -> Dict[str, Dict]:
    """Every objective in one pass over the shared event list; counts
    one ``slo.evaluations`` per call (the engine's poll cadence)."""
    pairs = list(events)
    telemetry.count("slo.evaluations")
    return {
        obj.name: evaluate(obj, cfg, pairs, now)
        for obj in cfg.objectives
    }


def publish(results: Dict[str, Dict]) -> None:
    """Gauge the evaluation so run streams and the Prometheus
    exposition carry live budget state (``stc_slo_*``).  Objectives
    with no data publish nothing — a gauge pinned at a made-up value
    is worse than an absent one."""
    burning = 0
    for name, r in sorted(results.items()):
        if r["total"] == 0:
            continue
        if r["burning"] or r["status"] == "exhausted":
            burning += 1
        telemetry.gauge(f"slo.{name}.total", r["total"])
        if r["good_fraction"] is not None:
            telemetry.gauge(
                f"slo.{name}.good_fraction", r["good_fraction"]
            )
        if r["budget_remaining"] is not None:
            telemetry.gauge(
                f"slo.{name}.budget_remaining", r["budget_remaining"]
            )
        for w in r["windows"]:
            if w["burn"] is not None:
                telemetry.gauge(
                    f"slo.{name}.burn_{w['name']}", w["burn"]
                )
        telemetry.gauge(
            f"slo.{name}.burning",
            1.0 if (r["burning"] or r["status"] == "exhausted")
            else 0.0,
        )
    telemetry.gauge("slo.objectives_burning", burning)


# ---------------------------------------------------------------------------
# Histogram cross-check (the Prometheus _bucket satellite's other half)
# ---------------------------------------------------------------------------
def fraction_under(
    bounds: Sequence[float], counts: Sequence[int], threshold: float
) -> Optional[float]:
    """The fraction of observations <= ``threshold`` from a registry
    histogram's fixed buckets (``bounds`` ascending upper bounds,
    ``counts`` per-bucket with the overflow bucket last) — EXACT when
    ``threshold`` is one of the bounds, which is why the built-in
    latency thresholds are bucket-aligned.  None with no data."""
    total = sum(counts)
    if total <= 0:
        return None
    good = 0
    for b, c in zip(bounds, counts):
        if b <= threshold + _EPS:
            good += c
        else:
            break
    return good / total
