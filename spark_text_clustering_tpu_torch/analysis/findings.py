"""Finding/waiver/report model shared by the lint layers, a copy of the
JAX package's ``analysis/findings.py``.

A **finding** is one violation of a named rule (``STC001``..``STC1xx``
for the AST layer, ``STC3xx`` for the protocol audit; the JAX package's
docs/STATIC_ANALYSIS.md holds the catalog).  Findings can be **waived**
two ways:

  * an inline pragma on the flagged line::

        risky_call()  # stc-lint: disable=STC002 -- last-resort guard

    (several rules comma-separate; the ``--``/parenthesized reason is
    required — a bare waiver with no justification still fails lint);

  * a committed baseline entry in the port's own
    ``spark_text_clustering_tpu_torch/analysis/lint_baseline.json``::

        {"rule": "STC002",
         "path": "spark_text_clustering_tpu_torch/cli.py",
         "match": "except Exception", "reason": "cache is optional"}

    matched by rule + path + ``match`` substring of the flagged source
    line (NOT by line number, so unrelated edits above the site don't
    invalidate the waiver).

Stale baseline entries (matching no current finding) and waivers with
empty reasons are themselves findings (``STC000``) — the baseline can
only shrink or be deliberately regenerated with ``--rebaseline``, the
same contract as the metrics baseline gate.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "Baseline",
    "pragma_disables",
    "apply_waivers",
    "render_text",
    "render_json",
    "DEFAULT_BASELINE_PATH",
]

# the port's own allowlist; scripts/records/lint_baseline.json is the
# JAX package's
DEFAULT_BASELINE_PATH = os.path.join(
    "spark_text_clustering_tpu_torch", "analysis", "lint_baseline.json"
)

# ``# stc-lint: disable=STC001[,STC004] -- reason`` (or ``(reason)``)
_PRAGMA_RE = re.compile(
    r"#\s*stc-lint:\s*disable=([A-Z0-9,\s]+?)"
    r"(?:\s*(?:--\s*(?P<dash>.+?)|\((?P<paren>[^)]*)\)))?\s*$"
)


@dataclass
class Finding:
    rule: str
    path: str              # repo-relative posix path, or "jaxpr:<entry>"
    line: int              # 1-based; 0 = whole-file / registry finding
    message: str
    snippet: str = ""      # flagged source line (baseline match target)
    waived: bool = False
    waived_by: str = ""    # "pragma" | "baseline"
    reason: str = ""

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def to_dict(self) -> Dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "snippet": self.snippet,
        }
        if self.waived:
            d["waived"] = True
            d["waived_by"] = self.waived_by
            d["reason"] = self.reason
        return d


def pragma_disables(line_text: str) -> Optional[Tuple[List[str], str]]:
    """Parse an inline waiver pragma out of one source line.

    Returns (rule list, reason) or None.  An empty reason is returned as
    ``""`` — the caller turns that into an STC000 finding rather than a
    silent waiver.
    """
    m = _PRAGMA_RE.search(line_text)
    if not m:
        return None
    rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
    reason = (m.group("dash") or m.group("paren") or "").strip()
    return rules, reason


class Baseline:
    """The committed allowlist (see module docstring for the grammar)."""

    def __init__(self, waivers: Optional[List[Dict]] = None) -> None:
        self.waivers: List[Dict] = list(waivers or [])
        # filled by apply_waivers: indices of entries that matched
        self._hit: set = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        return cls(data.get("waivers", []))

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(
                {"version": 1, "waivers": self.waivers}, f, indent=2,
                sort_keys=True,
            )
            f.write("\n")

    def match(self, finding: Finding) -> Optional[Dict]:
        # one entry may waive several findings (e.g. a repeated guard
        # pattern in one file); prefer un-hit entries so duplicate
        # entries don't shadow each other into staleness
        candidates = []
        for i, w in enumerate(self.waivers):
            if w.get("rule") != finding.rule:
                continue
            if w.get("path") != finding.path:
                continue
            m = w.get("match", "")
            if m and m not in (finding.snippet or ""):
                continue
            candidates.append((i, w))
        if not candidates:
            return None
        i, w = next(
            ((i, w) for i, w in candidates if i not in self._hit),
            candidates[0],
        )
        self._hit.add(i)
        return w

    def stale_entries(self) -> List[Dict]:
        return [
            w for i, w in enumerate(self.waivers) if i not in self._hit
        ]


def apply_waivers(
    findings: Sequence[Finding],
    baseline: Baseline,
    *,
    check_stale: bool = True,
    stale_exempt_prefixes: Sequence[str] = (),
) -> List[Finding]:
    """Mark baseline-waived findings in place; append STC000 findings
    for reasonless waivers and stale baseline entries.  (Pragma waivers
    are applied at finding-construction time by the rule engine, which
    has the source line in hand.)  ``check_stale=False`` skips the
    stale-entry sweep — for partial runs (``lint --changed``) where
    most waivers legitimately match nothing; ``stale_exempt_prefixes``
    exempts waivers for layers that did not run this invocation
    (``"jaxpr:"`` under --no-jaxpr, ``"scale:"`` without --scale).
    Returns the full augmented list."""
    out = list(findings)
    for f in out:
        if f.waived:
            continue
        w = baseline.match(f)
        if w is not None:
            f.waived = True
            f.waived_by = "baseline"
            f.reason = str(w.get("reason", "")).strip()
    extra: List[Finding] = []
    for f in out:
        if f.waived and not f.reason:
            extra.append(Finding(
                rule="STC000",
                path=f.path,
                line=f.line,
                message=(
                    f"waiver for {f.rule} carries no reason string "
                    f"(via {f.waived_by})"
                ),
                snippet=f.snippet,
            ))
    for w in baseline.stale_entries() if check_stale else ():
        if any(
            str(w.get("path", "")).startswith(p)
            for p in stale_exempt_prefixes
        ):
            continue
        extra.append(Finding(
            rule="STC000",
            path=str(w.get("path", "?")),
            line=0,
            message=(
                f"stale baseline waiver (rule {w.get('rule')}, match "
                f"{w.get('match', '')!r}) no longer suppresses anything "
                f"— delete it or regenerate with --rebaseline"
            ),
        ))
    return out + extra


def _split(findings: Sequence[Finding]):
    unwaived = [f for f in findings if not f.waived]
    waived = [f for f in findings if f.waived]
    return unwaived, waived


def render_text(
    findings: Sequence[Finding],
    audited: Sequence[str],
    scale_report: Optional[Dict] = None,
    protocol_report: Optional[Dict] = None,
) -> str:
    unwaived, waived = _split(findings)
    lines: List[str] = []
    for f in sorted(unwaived, key=lambda f: (f.path, f.line, f.rule)):
        loc = f"{f.path}:{f.line}" if f.line else f.path
        lines.append(f"{loc}: {f.rule}: {f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet.strip()}")
    if waived:
        lines.append("")
        lines.append(f"waived ({len(waived)}):")
        for f in sorted(waived, key=lambda f: (f.path, f.line, f.rule)):
            loc = f"{f.path}:{f.line}" if f.line else f.path
            lines.append(
                f"  {loc}: {f.rule} [{f.waived_by}] {f.reason}"
            )
    if scale_report is not None:
        entries = scale_report.get("entries", {})
        worst = max(
            (
                (e.get("hbm_frac") or 0.0, name)
                for name, e in entries.items()
            ),
            default=(0.0, "-"),
        )
        lines.append("")
        lines.append(
            f"scale audit: {len(entries)} entry point(s) traced at "
            f"declared scale shapes against the "
            f"{scale_report.get('backend', '?')} HBM budget "
            f"(worst per-chip fraction {worst[0]:.2f} at {worst[1]})"
        )
    if protocol_report is not None:
        pairs = protocol_report.get("pairs", {})
        lines.append("")
        lines.append(
            f"protocol audit: {protocol_report.get('sites', 0)} "
            f"registered site(s) over "
            f"{protocol_report.get('modules', 0)} module(s), "
            f"{protocol_report.get('lock_edges', 0)} lock edge(s), "
            f"schema pairs "
            + ", ".join(
                f"{name} ({len(p.get('required', []))} required / "
                f"{len(p.get('emitted', []))} emitted)"
                for name, p in sorted(pairs.items())
            )
        )
    lines.append("")
    lines.append(
        f"stc lint: {len(unwaived)} finding(s), {len(waived)} waived, "
        f"{len(audited)} jitted entry point(s) audited"
    )
    return "\n".join(lines)


def render_json(
    findings: Sequence[Finding],
    audited: Sequence[str],
    scale_report: Optional[Dict] = None,
    protocol_report: Optional[Dict] = None,
) -> str:
    unwaived, waived = _split(findings)
    doc = {
        "version": 1,
        "findings": [f.to_dict() for f in unwaived],
        "waived": [f.to_dict() for f in waived],
        "counts": {
            "findings": len(unwaived),
            "waived": len(waived),
        },
        "entrypoints_audited": list(audited),
    }
    if scale_report is not None:
        doc["scale"] = scale_report
    if protocol_report is not None:
        doc["protocol"] = protocol_report
    return json.dumps(doc, indent=2, sort_keys=True)
