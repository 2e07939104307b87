"""The ``stc lint`` CLI verb (wired as ``cli.py lint``), the lint half of
the JAX package's ``analysis/cli.py`` pointed at the port.

Usage::

    python -m spark_text_clustering_tpu_torch.cli lint
    python -m spark_text_clustering_tpu_torch.cli lint --protocol
    python -m spark_text_clustering_tpu_torch.cli lint --scale
    python -m spark_text_clustering_tpu_torch.cli lint --no-jaxpr
    python -m spark_text_clustering_tpu_torch.cli lint --changed
    python -m spark_text_clustering_tpu_torch.cli lint --format json
    python -m spark_text_clustering_tpu_torch.cli lint --rebaseline

Layer 1 is the AST invariant rules (``analysis.ast_rules``, STC000-007
and STC101-102) over ``spark_text_clustering_tpu_torch/``; layer 2, on
by default (``--no-jaxpr`` skips it), is the trace audit
(``analysis.jaxpr_audit``, STC200-205): every entry point of
``analysis.entrypoints`` called once on CPU tensors under torch's
dispatch and function modes; ``--protocol`` adds layer 4, the protocol
audit (``analysis.protocol_audit``): STC300-305 over the
thread/shared-file coordination fabric, checked both directions against
the ``analysis.protocol_sites`` registry — pure AST; ``--scale`` adds
layer 3, the scale audit (``analysis.scale_audit``, STC210-215): every
entry point called at its declared scale shapes (k=500, V=10M, the pow2
bucket grids) on fake tensors, against the ``nvidia-h100`` memory budget
and the committed record ``analysis/scale_baseline.json``
(``--scale-baseline`` names another; ``--scale --rebaseline`` rewrites
it).  ``--changed`` scopes the AST layer to git-changed files, runs the
protocol tier exactly when a registry-watched module changed, and runs
layers 2 and 3 only when a traced surface changed, as the JAX verb does.

Exit codes mirror ``metrics check``: 0 = clean (no unwaived findings),
1 = findings, 2 = usage/config error.  Every run mirrors its outcome
into the telemetry registry (``lint.findings`` / ``lint.waived``, plus
``lint.scale_*`` under ``--scale`` and ``lint.protocol_*`` under
``--protocol``) and — with ``--telemetry-file`` — into a run stream the
``metrics`` verbs can diff (the ``lint_run`` event's ``entrypoints`` and
``scale_entries`` are the audited counts).  The verb imports no jax,
makes no CUDA context (layers 2 and 3 report one) and builds no kernel
library: the kernel wrappers take their plain versions on CPU tensors.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from .findings import (
    DEFAULT_BASELINE_PATH,
    Baseline,
    apply_waivers,
    render_json,
    render_text,
)

__all__ = [
    "add_lint_subparser",
    "changed_files",
    "cmd_lint",
    "run_lint",
]

# a --changed run skips the trace layers unless one of the traced
# surfaces changed: the analysis package, or the modules whose entry
# points (and kernels) the trace layers will run
_TRACED_PREFIXES = (
    "spark_text_clustering_tpu_torch/analysis/",
    "spark_text_clustering_tpu_torch/csrc/",
    "spark_text_clustering_tpu_torch/models/",
    "spark_text_clustering_tpu_torch/ops/",
    "spark_text_clustering_tpu_torch/parallel/",
)


def _repo_root() -> str:
    # the package's parent directory — where the checkout's files live;
    # lint is source-tree tooling, not an installed-dist feature
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def changed_files(root: str) -> List[str]:
    """Repo-relative paths with uncommitted changes (tracked diffs vs
    HEAD + untracked non-ignored files) — the ``--changed`` scope."""
    import subprocess

    paths: List[str] = []
    for cmd in (
        ["git", "-C", root, "diff", "--name-only", "HEAD"],
        ["git", "-C", root, "ls-files", "--others", "--exclude-standard"],
    ):
        proc = subprocess.run(
            cmd, capture_output=True, text=True, check=False
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"--changed needs a git work tree at {root}: "
                f"{(proc.stderr or '').strip()}"
            )
        paths.extend(p for p in proc.stdout.splitlines() if p)
    return sorted(set(paths))


def run_lint(
    root: Optional[str] = None,
    *,
    jaxpr: bool = True,
    scale: bool = False,
    protocol: bool = False,
    rules: Optional[List[str]] = None,
    baseline_path: Optional[str] = None,
    scale_baseline_path: Optional[str] = None,
    changed: Optional[Sequence[str]] = None,
):
    """Run the requested layers; returns
    (findings, audited names, baseline, scale report | None,
    protocol report | None), as the JAX package's ``run_lint`` does.

    Findings come back with pragma AND baseline waivers applied, plus
    any STC000 meta-findings (reasonless/stale waivers — stale checks
    are skipped under a ``changed`` scope, where most waivers
    legitimately match nothing).
    """
    from .ast_rules import run_ast_rules

    root = root or _repo_root()
    if changed is not None:
        keep_paths = set(changed)
        trace_surface_changed = any(
            p.startswith(_TRACED_PREFIXES) for p in keep_paths
        )
        jaxpr = jaxpr and trace_surface_changed
        scale = scale and trace_surface_changed
    findings = run_ast_rules(root, rules=rules)
    if changed is not None:
        findings = [f for f in findings if f.path in keep_paths]
        # protocol tier: cheap pure-AST, so under --changed it runs
        # exactly when the protocol surface (a registry-watched module
        # or the audit itself) changed — regardless of --protocol
        from .protocol_sites import SITES

        protocol_surface = SITES.watched_modules() | {
            "spark_text_clustering_tpu_torch/analysis/protocol_sites.py",
            "spark_text_clustering_tpu_torch/analysis/protocol_audit.py",
        }
        protocol = bool(keep_paths & protocol_surface)
    audited: List[str] = []
    if jaxpr:
        from .jaxpr_audit import run_jaxpr_audit

        jf, audited = run_jaxpr_audit()
        if rules:
            keep = set(rules)
            jf = [f for f in jf if f.rule in keep]
        findings.extend(jf)
    scale_report = None
    if scale:
        from .scale_audit import (
            DEFAULT_SCALE_BASELINE_PATH,
            compare_with_record,
            load_scale_record,
            run_scale_audit,
        )

        sf, scale_report = run_scale_audit()
        sb_path = scale_baseline_path or os.path.join(
            root, DEFAULT_SCALE_BASELINE_PATH
        )
        sf.extend(compare_with_record(
            scale_report, load_scale_record(sb_path),
            DEFAULT_SCALE_BASELINE_PATH,
        ))
        if rules:
            keep = set(rules)
            sf = [f for f in sf if f.rule in keep]
        findings.extend(sf)
    protocol_report = None
    if protocol:
        from .protocol_audit import run_protocol_audit

        pf, protocol_report = run_protocol_audit(root)
        if rules:
            keep = set(rules)
            pf = [f for f in pf if f.rule in keep]
        findings.extend(pf)
    bl_path = baseline_path or os.path.join(root, DEFAULT_BASELINE_PATH)
    baseline = Baseline.load(bl_path)
    exempt = tuple(
        p
        for p, ran in (
            ("jaxpr:", jaxpr),
            ("scale:", scale),
            ("protocol:", protocol),
        )
        if not ran
    )
    findings = apply_waivers(
        findings,
        baseline,
        check_stale=changed is None,
        stale_exempt_prefixes=exempt,
    )
    return findings, audited, baseline, scale_report, protocol_report


def cmd_lint(args: argparse.Namespace) -> int:
    from .. import telemetry

    root = _repo_root()
    bl_path = args.baseline or os.path.join(root, DEFAULT_BASELINE_PATH)
    rules = args.rules.split(",") if args.rules else None
    changed = None
    if args.changed:
        try:
            changed = changed_files(root)
        except RuntimeError as exc:
            print(f"stc lint: {exc}")
            return 2
        if not changed:
            print("stc lint --changed: no changed files — clean")
            return 0

    findings, audited, baseline, scale_report, protocol_report = \
        run_lint(
            root,
            jaxpr=not args.no_jaxpr,
            scale=args.scale,
            protocol=args.protocol,
            rules=rules,
            baseline_path=bl_path,
            scale_baseline_path=args.scale_baseline,
            changed=changed,
        )

    own_telemetry = bool(getattr(args, "telemetry_file", None))
    if own_telemetry:
        telemetry.configure(args.telemetry_file)
        telemetry.manifest(kind="lint")

    if args.rebaseline:
        # keep reasons for entries that still match; new findings get an
        # explicit review-me reason (a waiver must NEVER be reasonless)
        import datetime

        stamp = datetime.date.today().isoformat()
        # with --scale the record is rewritten below: its drift is gone
        drift = ()
        if args.scale and scale_report is not None:
            from .scale_audit import RECORD_DRIFT as drift
        new_waivers = []
        for f in findings:
            if f.rule == "STC000" or f.snippet in drift:
                continue
            if f.waived and f.waived_by == "pragma":
                continue  # pragmas live in source, not the baseline
            if f.waived and f.waived_by == "baseline":
                new_waivers.append({
                    "rule": f.rule, "path": f.path,
                    "match": f.snippet.strip()[:80],
                    "reason": f.reason,
                })
            elif not f.waived:
                new_waivers.append({
                    "rule": f.rule, "path": f.path,
                    "match": f.snippet.strip()[:80],
                    "reason": (
                        f"auto-rebaselined {stamp}; review before merge"
                    ),
                })
        Baseline(new_waivers).save(bl_path)
        print(
            f"lint baseline rewritten: {bl_path} "
            f"({len(new_waivers)} waiver(s))"
        )
        if args.scale and scale_report is not None:
            from .scale_audit import (
                DEFAULT_SCALE_BASELINE_PATH,
                save_scale_record,
            )

            sb_path = args.scale_baseline or os.path.join(
                root, DEFAULT_SCALE_BASELINE_PATH
            )
            save_scale_record(scale_report, sb_path)
            print(
                f"scale record rewritten: {sb_path} "
                f"({len(scale_report['entries'])} entries at "
                f"{scale_report['backend']})"
            )
        if own_telemetry:
            telemetry.shutdown()
        return 0

    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    telemetry.count("lint.findings", len(unwaived))
    telemetry.count("lint.waived", len(waived))
    if args.scale and scale_report is not None:
        scale_f = [f for f in findings if f.path.startswith("scale:")]
        telemetry.count(
            "lint.scale_entries", len(scale_report["entries"])
        )
        telemetry.count(
            "lint.scale_findings",
            len([f for f in scale_f if not f.waived]),
        )
        telemetry.count(
            "lint.scale_waived", len([f for f in scale_f if f.waived])
        )
    if protocol_report is not None:
        proto_f = [
            f for f in findings if f.path.startswith("protocol:")
        ]
        telemetry.count(
            "lint.protocol_sites", protocol_report["sites"]
        )
        telemetry.count(
            "lint.protocol_findings",
            len([f for f in proto_f if not f.waived]),
        )
        telemetry.count(
            "lint.protocol_waived",
            len([f for f in proto_f if f.waived]),
        )
    if own_telemetry:
        telemetry.event(
            "lint_run",
            findings=len(unwaived),
            waived=len(waived),
            entrypoints=len(audited),
            scale_entries=(
                len(scale_report["entries"]) if scale_report else 0
            ),
            protocol_sites=(
                protocol_report["sites"] if protocol_report else 0
            ),
        )
        telemetry.shutdown()

    out = (
        render_json(findings, audited, scale_report, protocol_report)
        if args.format == "json"
        else render_text(findings, audited, scale_report, protocol_report)
    )
    print(out)
    return 1 if unwaived else 0


def add_lint_subparser(sub) -> None:
    p = sub.add_parser(
        "lint",
        help="project-native static analysis: AST invariant rules + the "
             "layer-2 trace audit of the registered entry points (on "
             "by default) (+ --scale: the V=10M/k=500 scale audit on "
             "fake tensors) + the --protocol audit",
    )
    p.add_argument(
        "--format", default="text", choices=["text", "json"],
        help="report format (json is the machine-readable CI artifact)",
    )
    p.add_argument(
        "--rules", default=None,
        help="comma-separated rule subset (e.g. STC001,STC005)",
    )
    p.add_argument(
        "--no-jaxpr", action="store_true",
        help="skip layer 2 (the trace audit of the registered entry "
             "points: STC200-205) — AST-only fast mode",
    )
    p.add_argument(
        "--scale", action="store_true",
        help="add layer 3: call every registered entry point at its "
             "declared scale shapes (V=10M, k=500, pow2 bucket grids) on "
             "fake tensors and enforce STC210-215 against the "
             "nvidia-h100 budget and the committed scale record",
    )
    p.add_argument(
        "--protocol", action="store_true",
        help="add layer 4: the STC300-305 concurrency & shared-file "
             "protocol audit (lock graph, thread escapes, atomic "
             "publish, torn-read tolerance, fsync ordering, "
             "writer/reader schema conformance) against the "
             "analysis/protocol_sites.py registry — pure AST",
    )
    p.add_argument(
        "--changed", action="store_true",
        help="diff-scoped fast mode: AST rules on git-changed files "
             "only; the protocol tier exactly when a protocol-registry "
             "module changed; layers 2 and 3 only when a traced surface "
             "(analysis/csrc/models/ops/parallel) changed",
    )
    p.add_argument(
        "--baseline", default=None,
        help=f"waiver allowlist (default {DEFAULT_BASELINE_PATH})",
    )
    p.add_argument(
        "--scale-baseline", default=None,
        help="committed scale evidence record (default "
             "spark_text_clustering_tpu_torch/analysis/scale_baseline.json)",
    )
    p.add_argument(
        "--rebaseline", action="store_true",
        help="rewrite the baseline to waive every current finding "
             "(with --scale: also rewrite the scale record; commit the "
             "result deliberately — mirrors `metrics check "
             "--write-baseline`)",
    )
    p.add_argument(
        "--telemetry-file", default=None,
        help="emit a lint run stream (lint.findings / lint.waived / "
             "lint.scale_* / lint.protocol_*) consumable by the `metrics` "
             "verbs",
    )
    p.set_defaults(fn=cmd_lint)
