"""``monitor``, the live alerting verb over ``telemetry.alerts``: the JAX
package's ``telemetry/monitor_cli.py``, copied, with the same flags,
output and exit codes.

    # follow the replicas' streams and a fleet's leases, act on the
    # supervisor
    python -m spark_text_clustering_tpu_torch.cli monitor \
        --stream 'run/worker-*.jsonl' --fleet-dir fleet \
        --alerts-file fleet/alerts.jsonl \
        --actions-file fleet/actions.json --interval 0.5

    # batch mode over recorded streams (deterministic)
    python -m spark_text_clustering_tpu_torch.cli monitor --once \
        --stream run.jsonl --builtin retrace_storm --fail-on-alert

A host verb like ``front`` and ``metrics``: it reads files and makes no
CUDA context.  Follow mode drains on SIGTERM or Ctrl-C (its transitions
are already in the checksummed alerts log, and a restarted monitor
resumes the firing set from it instead of firing again).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

from .. import telemetry
from .alerts import (
    BUILTIN_RULES,
    AlertEngine,
    AlertRule,
    StreamSet,
    builtin_rules,
    rule_from_dict,
)
from .slo import SLOConfig, builtin_config, config_from_dict

__all__ = [
    "assemble_rules",
    "assemble_slo_config",
    "cmd_monitor",
    "add_monitor_subparser",
]


def assemble_slo_config(
    slo_path: Optional[str],
    compression: Optional[float],
) -> Optional[SLOConfig]:
    """The verb's SLO set: ``--slo FILE`` replaces/extends the built-in
    objectives (a file objective re-declaring a built-in name retunes
    it); ``--slo-compression`` divides every burn window for drills.
    None when neither flag is given — the engine then defaults to the
    built-in set only if a ``burn_rate`` rule asks for it."""
    if not slo_path and compression is None:
        return None
    if slo_path:
        with open(slo_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        cfg = config_from_dict(doc)
        if compression is not None:
            cfg.compression = float(compression)
        return cfg
    return builtin_config(compression=float(compression or 1.0))


def assemble_rules(
    builtins: Optional[List[str]],
    rules_path: Optional[str],
) -> List[AlertRule]:
    """The verb's rule set: the named built-ins (all of them when no
    ``--builtin``/``--rules`` narrows the set) plus/overridden-by the
    ``--rules`` file — a file rule that re-declares a built-in name
    replaces it wholesale, a file rule with only retuned fields merges
    over the built-in spec."""
    file_specs: Dict[str, Dict] = {}
    if rules_path:
        with open(rules_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        specs = doc.get("rules", doc) if isinstance(doc, dict) else doc
        if not isinstance(specs, list):
            raise ValueError(
                f"{rules_path}: want a JSON list of rule objects "
                f"(or {{'rules': [...]}})"
            )
        for spec in specs:
            if not isinstance(spec, dict) or "name" not in spec:
                raise ValueError(
                    f"{rules_path}: every rule needs a 'name'"
                )
            file_specs[str(spec["name"])] = spec

    names = list(builtins or [])
    if not names and not file_specs:
        names = sorted(BUILTIN_RULES)
    out: List[AlertRule] = []
    for name in names:
        override = file_specs.pop(name, None)
        out.extend(
            builtin_rules(
                [name],
                overrides={name: {
                    k: v for k, v in (override or {}).items()
                    if k != "name"
                }},
            )
        )
    for name, spec in sorted(file_specs.items()):
        if name in BUILTIN_RULES:
            # a file mention of a built-in not selected via --builtin
            # still enables it, retuned
            merged = dict(BUILTIN_RULES[name], name=name)
            merged.update({k: v for k, v in spec.items()})
            out.append(rule_from_dict(merged))
        else:
            out.append(rule_from_dict(spec))
    return out


def _print_transition(rec: Dict) -> None:
    state = str(rec.get("state", "?")).upper()
    key = rec.get("key") or "-"
    val = rec.get("value")
    vs = f"{val:.6g}" if isinstance(val, (int, float)) else "-"
    extra = ""
    if "worst" in rec:
        extra = f" worst={rec['worst']}={rec.get('worst_value'):.6g}"
    if "epoch" in rec:
        extra += f" epoch={rec['epoch']}"
    print(
        f"[{state}] {rec.get('rule')} key={key} value={vs} "
        f"threshold={rec.get('threshold')}{extra}",
        flush=True,
    )


def cmd_monitor(args) -> int:
    if getattr(args, "collect_dir", None):
        # an `stc collect` aggregation dir is just N manifested streams:
        # expand it onto --stream so the engine tail-follows sources
        # that connect mid-run (the glob re-expands every poll)
        args.stream = list(args.stream or []) + [
            os.path.join(args.collect_dir, "*.jsonl")
        ]
    own_telemetry = bool(getattr(args, "telemetry_file", None))
    telemetry.configure(args.telemetry_file if own_telemetry else None)
    if own_telemetry:
        telemetry.manifest(
            kind="monitor",
            streams=list(args.stream or []),
            fleet_dir=args.fleet_dir,
            ledger_dirs=list(args.ledger_dir or []),
        )
    try:
        rules = assemble_rules(args.builtin, args.rules)
        slo_config = assemble_slo_config(
            getattr(args, "slo", None),
            getattr(args, "slo_compression", None),
        )
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if not (args.stream or args.fleet_dir or args.ledger_dir):
        print(
            "monitor needs at least one of --stream / --fleet-dir / "
            "--ledger-dir to watch",
            file=sys.stderr,
        )
        return 2
    drift_rules = [r for r in rules if r.kind == "drift"]
    if drift_rules and not args.ledger_dir and not any(
        r.ledger_dir for r in drift_rules
    ):
        # drift rules without a ledger to probe are inert, not an error
        # (the default built-in set includes topic_drift)
        rules = [r for r in rules if r.kind != "drift"]

    streams = StreamSet(list(args.stream or [])) if args.stream else None
    engine = AlertEngine(
        rules,
        streams,
        fleet_dir=args.fleet_dir,
        ledger_dirs=list(args.ledger_dir or []),
        alerts_path=args.alerts_file,
        actions_path=args.actions_file,
        on_transition=None if args.quiet else _print_transition,
        slo_config=slo_config,
    )
    print(
        f"monitoring {len(rules)} rule(s) over "
        f"{len(args.stream or [])} stream pattern(s)"
        + (f", fleet {args.fleet_dir}" if args.fleet_dir else "")
        + (
            f", {len(args.ledger_dir)} ledger(s)"
            if args.ledger_dir else ""
        )
        + (f" -> alerts {args.alerts_file}" if args.alerts_file else "")
        + (
            f", actions {args.actions_file}"
            if args.actions_file else ""
        )
    )
    if args.once:
        transitions = engine.once()
    else:
        from ..resilience.supervisor import PreemptionNotice

        preempt = PreemptionNotice().install()
        try:
            transitions = engine.run(
                args.interval,
                stop=preempt,
                max_seconds=args.max_seconds,
            )
        except KeyboardInterrupt:
            transitions = engine.transitions
        finally:
            preempt.uninstall()
    firing = engine.firing()
    fired = sorted({
        (t["rule"], t["key"]) for t in transitions
        if t["state"] == "firing"
    })
    print(
        f"monitor done: {len(transitions)} transition(s), "
        f"{len(fired)} alert(s) fired, {len(firing)} still firing"
    )
    for rule, key in fired:
        print(f"  fired: {rule}" + (f" [{key}]" if key else ""))
    if own_telemetry:
        telemetry.shutdown()
    if args.fail_on_alert and fired:
        return 1
    return 0


def add_monitor_subparser(sub) -> None:
    mo = sub.add_parser(
        "monitor",
        help="live alerting engine: tail-follow run streams, lease "
             "files, and epoch ledgers; evaluate declarative alert "
             "rules (threshold/rate/absence/divergence/topic-drift); "
             "persist firing state and emit supervisor actions",
    )
    mo.add_argument(
        "--stream", action="append", default=[], metavar="GLOB",
        help="telemetry JSONL stream(s) to tail-follow (glob patterns "
             "re-expanded every poll, so per-process streams that "
             "appear mid-run are picked up live; repeatable)",
    )
    mo.add_argument(
        "--collect-dir", default=None,
        help="an `stc collect` aggregation dir: shorthand for "
             "--stream '<dir>/*.jsonl' — tail the whole fleet's "
             "shipped streams live off one collector",
    )
    mo.add_argument(
        "--fleet-dir", default=None,
        help="an `stc supervise` fleet dir: worker lease files become "
             "live `lease` pseudo-events (worker_stale / queue_depth / "
             "fleet_skew rules)",
    )
    mo.add_argument(
        "--ledger-dir", action="append", default=[],
        help="epoch-ledger checkpoint dir(s) the topic-drift probe "
             "watches for newly committed lambdas (repeatable)",
    )
    mo.add_argument(
        "--rules", default=None,
        help="JSON rule file (a list of rule objects; re-declaring a "
             "built-in name retunes it) — see docs/OBSERVABILITY.md",
    )
    mo.add_argument(
        "--builtin", action="append", default=[],
        metavar="NAME",
        help="enable ONLY these built-in rules (repeatable; default: "
             f"all of {', '.join(sorted(BUILTIN_RULES))})",
    )
    mo.add_argument(
        "--alerts-file", default=None,
        help="append-only checksummed alert-state log (alerts.jsonl); "
             "serve's /healthz degrades while it holds firing alerts, "
             "and a restarted monitor resumes its firing set from it",
    )
    mo.add_argument(
        "--actions-file", default=None,
        help="machine-readable actions file firing alerts write "
             "scale_out/scale_in/drain requests to — polled by "
             "`stc supervise --actions-file` (telemetry-driven fleet "
             "control)",
    )
    mo.add_argument(
        "--interval", type=float, default=1.0,
        help="seconds between evaluation cycles in follow mode",
    )
    mo.add_argument(
        "--once", action="store_true",
        help="batch mode: evaluate the full current stream content "
             "once at event time (for_seconds collapsed) and exit — "
             "deterministic, the CI drill's mode",
    )
    mo.add_argument(
        "--max-seconds", type=float, default=None,
        help="follow mode: stop after this long (drills); default: "
             "run until SIGTERM/Ctrl-C",
    )
    mo.add_argument(
        "--fail-on-alert", action="store_true",
        help="exit 1 when any alert fired during the run (the "
             "--fail-on-skew of the live engine)",
    )
    mo.add_argument(
        "--quiet", action="store_true",
        help="don't print transitions as they happen",
    )
    mo.add_argument(
        "--slo", default=None, metavar="FILE",
        help="JSON SLO objective file (a list of objective objects or "
             "{'objectives': [...], 'windows': [...], 'compression': "
             "N}; re-declaring a built-in objective name retunes it) — "
             "enables burn-rate evaluation even without a burn_rate "
             "rule selected",
    )
    mo.add_argument(
        "--slo-compression", type=float, default=None, metavar="N",
        help="divide every SLO burn window by N (a 3600 s window at "
             "N=400 drills in 9 s) — CI's knob; implies the built-in "
             "objective set when --slo is absent",
    )
    mo.add_argument(
        "--telemetry-file", default=None,
        help="the monitor's OWN run stream (alert_transition / "
             "action_emitted / drift_probe events + alert./monitor./"
             "drift. counters) — `metrics summarize` renders its "
             "alert-health section from this",
    )
    mo.set_defaults(fn=cmd_monitor)
