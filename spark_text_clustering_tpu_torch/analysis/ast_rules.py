"""Layer 1: AST invariant checkers over the package source, a copy of the
JAX package's ``analysis/ast_rules.py`` pointed at the port.

Project-native rules (the telemetry and resilience conventions, enforced
mechanically so later changes cannot erode them silently):

  STC001  no raw ``time.sleep`` outside ``resilience/retry.py`` — every
          wall-clock wait routes through the injectable ``retry.sleep``
          so chaos tests can drive a simulated clock.
  STC002  no bare/broad ``except`` that swallows the error: the handler
          must re-raise, reference the bound exception (re-wrap it,
          quarantine it, surface it), or carry a waiver.
  STC003  fault-injection site strings <-> ``faultinject.SITES``
          registry, both directions.
  STC004  telemetry metric names: literal, dotted snake.case, declared
          once in ``telemetry/names.py`` (dynamic families must match a
          declared prefix), both directions.
  STC005  no host syncs (``.item()``/``.cpu()``/``.tolist()``/
          ``.numpy()``/``torch.cuda.synchronize()``/``np.asarray``/
          ``float(arg)``) inside functions reachable from a callable
          wrapped by ``telemetry.instrument_dispatch`` — the port's
          counterpart of the JAX package's jitted steps, under the same
          labels.  ``telemetry.device_sync`` is the one sanctioned sync:
          the walk neither flags nor enters it.
  STC006  no mutable default arguments; persistence-layer
          ``json.dump(s)`` must pass ``sort_keys=True`` (manifest bytes
          must not depend on dict build order).
  STC007  lock discipline in the threaded modules (serving coalescer/
          server, alert engine, supervisor): an attribute the class
          writes under ``with self._lock`` anywhere is lock-guarded
          state — touching it outside a lock block in another method is
          a data race.  Deliberate lock-free reads (atomic reference
          swaps, monotonic flags) carry reasoned waivers.

Generic-Python tier (the ruff-equivalent checks, native so the gate
works in hermetic containers without ruff installed):

  STC101  unused module-level imports (``# noqa`` on the import line is
          honored — the repo already marks side-effect imports that way).
  STC102  f-string passed straight to a logging call (defeats lazy
          formatting).

The engine parses every module once, runs all rules over the shared
index, and applies inline-pragma waivers at construction time (the
baseline is applied later by ``findings.apply_waivers``).  The scoping
below names files relative to the package root, so ``run_ast_rules(root,
package=...)`` checks a tree under either package's directory name.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding, pragma_disables

__all__ = ["LintIndex", "run_ast_rules", "AST_RULES"]

PACKAGE = "spark_text_clustering_tpu_torch"

AST_RULES = (
    "STC001", "STC002", "STC003", "STC004", "STC005", "STC006",
    "STC007", "STC101", "STC102",
)

# rule-specific scoping, relative to the package root -----------------------
SLEEP_OWNER = "resilience/retry.py"
# the telemetry package owns the facade's dynamic name families and the
# registry internals — STC004 checks its CALLERS, not the facade itself
METRIC_EXEMPT_DIR = "telemetry"
PERSISTENCE_FILES = {
    "models/persistence.py",
    "resilience/integrity.py",
    "resilience/resume.py",
    "resilience/ledger.py",
}
# STC007 scope: the modules whose classes share mutable state across
# threads (the serve front + batch worker + model watcher, and the
# monitor/supervisor control loops)
LOCK_FILES = {
    "serving/coalescer.py",
    "serving/server.py",
    "telemetry/alerts.py",
    "resilience/supervisor.py",
}
_LOCK_FACTORIES = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
}
# receiver methods that mutate the receiver in place
_MUTATORS = {
    "append", "extend", "insert", "pop", "popitem", "remove", "clear",
    "update", "add", "discard", "setdefault", "appendleft", "sort",
}

# tensor methods that wait for the device and copy to the host
_HOST_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "asanyarray", "frombuffer"}
# the dispatch layer's wrapper (the STC005 roots) and the one sanctioned
# sync, telemetry.device_sync, which the walk neither flags nor enters
_DISPATCH_WRAPPERS = {"instrument_dispatch"}
_SANCTIONED_SYNCS = {"device_sync"}
_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
}


@dataclass
class ModuleInfo:
    relpath: str                 # repo-relative posix path
    tree: ast.Module
    lines: List[str]


@dataclass
class LintIndex:
    """Parsed package + cheap cross-module lookup tables."""

    root: str
    modules: Dict[str, ModuleInfo] = field(default_factory=dict)
    package: str = PACKAGE       # the package directory under root

    # ---- construction --------------------------------------------------
    @classmethod
    def build(cls, root: str, rel_package: str = PACKAGE) -> "LintIndex":
        idx = cls(root=root, package=rel_package)
        pkg_dir = os.path.join(root, rel_package)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [
                d for d in dirnames
                if d not in ("__pycache__", ".git")
            ]
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, root).replace(os.sep, "/")
                with open(path, "r", encoding="utf-8") as f:
                    src = f.read()
                idx.modules[rel] = ModuleInfo(
                    relpath=rel,
                    tree=ast.parse(src, filename=rel),
                    lines=src.splitlines(),
                )
        return idx

    # ---- helpers -------------------------------------------------------
    def rel(self, tail: str) -> str:
        """The repo-relative path of ``tail`` inside the package."""
        return f"{self.package}/{tail}"

    def line(self, rel: str, lineno: int) -> str:
        lines = self.modules[rel].lines
        return lines[lineno - 1] if 0 < lineno <= len(lines) else ""

    def finding(
        self, rule: str, rel: str, lineno: int, message: str
    ) -> Finding:
        snippet = self.line(rel, lineno) if lineno else ""
        f = Finding(
            rule=rule, path=rel, line=lineno, message=message,
            snippet=snippet,
        )
        pragma = pragma_disables(snippet) if snippet else None
        if pragma is not None and rule in pragma[0]:
            f.waived = True
            f.waived_by = "pragma"
            f.reason = pragma[1]
        # noqa compatibility: the repo predates stc-lint and marks
        # intentional side-effect imports with ``# noqa`` — honor it for
        # the unused-import rule only
        if rule == "STC101" and "# noqa" in snippet:
            f.waived = True
            f.waived_by = "pragma"
            f.reason = "noqa-marked import (side-effect / re-export)"
        return f


def _call_name(func: ast.AST) -> Tuple[Optional[str], Optional[str]]:
    """(base, attr) for ``base.attr(...)`` calls, (None, name) for bare
    ``name(...)`` calls, (None, None) otherwise."""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return func.value.id, func.attr
    if isinstance(func, ast.Name):
        return None, func.id
    return None, None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ---------------------------------------------------------------------------
# STC001 — raw sleeps
# ---------------------------------------------------------------------------
def _check_sleep(idx: LintIndex) -> List[Finding]:
    out = []
    for rel, mod in idx.modules.items():
        if rel == idx.rel(SLEEP_OWNER):
            continue
        # did this module do ``from time import sleep``?
        bare_sleep_is_time = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name == "sleep":
                        bare_sleep_is_time = True
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            hit = (base == "time" and attr == "sleep") or (
                base is None and attr == "sleep" and bare_sleep_is_time
            )
            if hit:
                out.append(idx.finding(
                    "STC001", rel, node.lineno,
                    "raw time.sleep — route delays through "
                    "resilience.retry.sleep / RetryPolicy so chaos "
                    "tests control the clock",
                ))
    return out


# ---------------------------------------------------------------------------
# STC002 — broad excepts that swallow
# ---------------------------------------------------------------------------
def _is_broad(handler_type: Optional[ast.AST]) -> bool:
    if handler_type is None:
        return True
    names = []
    if isinstance(handler_type, ast.Tuple):
        names = [
            e.id for e in handler_type.elts if isinstance(e, ast.Name)
        ]
    elif isinstance(handler_type, ast.Name):
        names = [handler_type.id]
    return any(n in ("Exception", "BaseException") for n in names)


def _check_excepts(idx: LintIndex) -> List[Finding]:
    out = []
    for rel, mod in idx.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not _is_broad(node.type):
                continue
            # compliant when the handler re-raises or actually USES the
            # caught exception (wraps it into the typed taxonomy,
            # quarantines it with the error attached, surfaces it)
            reraises = any(
                isinstance(n, ast.Raise) for n in ast.walk(node)
            )
            uses_exc = node.name is not None and any(
                isinstance(n, ast.Name) and n.id == node.name
                for child in node.body for n in ast.walk(child)
            )
            if reraises or uses_exc:
                continue
            out.append(idx.finding(
                "STC002", rel, node.lineno,
                "broad except swallows the error — narrow the type, "
                "re-wrap it in the resilience.errors taxonomy, or waive "
                "a genuine last-resort guard",
            ))
    return out


# ---------------------------------------------------------------------------
# STC003 — fault-injection site registry, both directions
# ---------------------------------------------------------------------------
def _check_fault_sites(idx: LintIndex) -> List[Finding]:
    from ..resilience.faultinject import SITES

    out: List[Finding] = []
    used: Set[str] = set()
    for rel, mod in idx.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            if base != "faultinject" or attr not in ("check", "corrupt"):
                continue
            if not node.args:
                continue
            site = _const_str(node.args[0])
            if site is None:
                out.append(idx.finding(
                    "STC003", rel, node.lineno,
                    "fault site must be a string literal (a computed "
                    "site can silently never match an armed plan)",
                ))
                continue
            used.add(site)
            if site not in SITES:
                out.append(idx.finding(
                    "STC003", rel, node.lineno,
                    f"fault site {site!r} is not registered in "
                    f"resilience.faultinject.SITES — register it in the "
                    f"same commit",
                ))
    registry_rel = idx.rel("resilience/faultinject.py")
    for site in sorted(SITES - used):
        out.append(idx.finding(
            "STC003", registry_rel, 0,
            f"registered fault site {site!r} has no check()/corrupt() "
            f"call site left in the package — stale chaos coverage",
        ))
    return out


# ---------------------------------------------------------------------------
# STC004 — telemetry metric names, both directions
# ---------------------------------------------------------------------------
def _module_str_consts(mod: ModuleInfo) -> Dict[str, str]:
    """Module-level ``NAME = "literal"`` assignments."""
    consts: Dict[str, str] = {}
    for node in mod.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
        ):
            v = _const_str(node.value)
            if v is not None:
                consts[node.targets[0].id] = v
    return consts


def _check_metric_names(idx: LintIndex) -> List[Finding]:
    from ..telemetry import names as metric_names

    out: List[Finding] = []
    used: Set[str] = set()
    for rel, mod in idx.modules.items():
        if rel.startswith(idx.rel(METRIC_EXEMPT_DIR) + "/"):
            continue
        consts = _module_str_consts(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            if base != "telemetry" or attr not in (
                "count", "gauge", "observe",
            ):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            name = _const_str(arg)
            if name is None and isinstance(arg, ast.Name):
                name = consts.get(arg.id)
            if name is not None:
                used.add(name)
                if not metric_names.is_valid_name(name):
                    out.append(idx.finding(
                        "STC004", rel, node.lineno,
                        f"metric name {name!r} is not dotted snake.case",
                    ))
                elif not metric_names.declared(name):
                    out.append(idx.finding(
                        "STC004", rel, node.lineno,
                        f"metric name {name!r} is not declared in "
                        f"telemetry/names.py — declare it once there",
                    ))
                continue
            if isinstance(arg, ast.JoinedStr):
                lead = ""
                if arg.values and isinstance(arg.values[0], ast.Constant):
                    lead = str(arg.values[0].value)
                prefix = next(
                    (
                        p for p in metric_names.PREFIXES
                        if lead.startswith(p)
                    ),
                    None,
                )
                if prefix is None:
                    out.append(idx.finding(
                        "STC004", rel, node.lineno,
                        f"dynamic metric name (leading text {lead!r}) "
                        f"matches no declared prefix family in "
                        f"telemetry/names.py",
                    ))
                continue
            out.append(idx.finding(
                "STC004", rel, node.lineno,
                "metric name is neither a literal nor a module-level "
                "string constant — STC004 cannot verify it",
            ))
    # reverse: every declared literal must still appear SOMEWHERE in the
    # package (any string constant — covers facade-internal constants in
    # the exempt telemetry dir too)
    names_rel = idx.rel("telemetry/names.py")
    all_strs: Set[str] = set()
    for rel, mod in idx.modules.items():
        if rel == names_rel:
            continue  # the declarations themselves don't count as use
        for node in ast.walk(mod.tree):
            s = _const_str(node)
            if s is not None:
                all_strs.add(s)
    for name in sorted(set(metric_names.METRICS) - all_strs - used):
        out.append(idx.finding(
            "STC004", names_rel, 0,
            f"declared metric {name!r} is no longer written anywhere — "
            f"remove the declaration or restore the instrumentation",
        ))
    return out


# ---------------------------------------------------------------------------
# STC005 — host syncs reachable from instrumented dispatches
# ---------------------------------------------------------------------------
@dataclass
class _FnEntry:
    rel: str
    node: ast.AST          # FunctionDef / AsyncFunctionDef
    params: Set[str]
    cls: Optional[str] = None   # enclosing class (qualname context)


def _fn_params(node) -> Set[str]:
    args = node.args
    return {
        a.arg
        for a in (args.posonlyargs + args.args + args.kwonlyargs)
    }


def _collect_functions(mod: ModuleInfo) -> Dict[str, _FnEntry]:
    """Function table keyed QUALNAME-AWARE: class methods register under
    ``Class.method`` (the key ``self.method(...)`` calls resolve to) AND
    under their simple name (first definition wins, so free functions
    keep shadowing like before).  Both keys share one entry object, so
    reachability marks and finding dedup see one function."""
    fns: Dict[str, _FnEntry] = {}
    by_node: Dict[int, _FnEntry] = {}
    for cls_node in ast.walk(mod.tree):
        if not isinstance(cls_node, ast.ClassDef):
            continue
        for node in cls_node.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                entry = _FnEntry(
                    mod.relpath, node, _fn_params(node), cls=cls_node.name
                )
                fns[f"{cls_node.name}.{node.name}"] = entry
                by_node[id(node)] = entry
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            entry = by_node.get(id(node))
            if entry is None:
                entry = _FnEntry(mod.relpath, node, _fn_params(node))
            fns.setdefault(node.name, entry)
    return fns


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for a chain of attributes over a name, else ``""``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return ""
    parts.append(node.id)
    return ".".join(reversed(parts))


def _is_dispatch_wrap(value: ast.AST) -> bool:
    """``telemetry.instrument_dispatch(label, fn)`` (or the bare name
    imported from the telemetry package)."""
    if not isinstance(value, ast.Call):
        return False
    base, attr = _call_name(value.func)
    return attr in _DISPATCH_WRAPPERS and base in ("telemetry", None)


def _wrapped_callable(call: ast.Call) -> Optional[ast.AST]:
    """The callable argument of an ``instrument_dispatch`` call."""
    if len(call.args) >= 2:
        return call.args[1]
    for kw in call.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


def _dispatch_target(
    expr: ast.AST, assigns: Dict[str, ast.AST], depth: int = 0
) -> Optional[str]:
    """The simple name of the function a wrapped callable runs, resolved
    the way the JAX package resolves ``jax.jit(X)``: a name (through an
    assignment chain that is not the wrapping itself), ``partial(X,
    ...)``, or a lambda whose body calls X (a lambda parameter that
    defaults to a name resolves to that name)."""
    if depth > 4:
        return None
    if isinstance(expr, ast.Name):
        nxt = assigns.get(expr.id)
        if nxt is not None and not _is_dispatch_wrap(nxt):
            hit = _dispatch_target(nxt, assigns, depth + 1)
            if hit is not None:
                return hit
        return expr.id
    if isinstance(expr, ast.Lambda):
        body = expr.body
        if not (isinstance(body, ast.Call)
                and isinstance(body.func, ast.Name)):
            return None
        args = expr.args
        positional = args.posonlyargs + args.args
        defaults = dict(zip(
            [a.arg for a in positional[len(positional)
                                       - len(args.defaults):]],
            args.defaults,
        ))
        defaults.update({
            a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults)
            if d is not None
        })
        callee = body.func.id
        if callee in defaults:
            return _dispatch_target(defaults[callee], assigns, depth + 1)
        if callee in {a.arg for a in positional + args.kwonlyargs}:
            return None   # a callable passed in at call time
        return _dispatch_target(body.func, assigns, depth + 1)
    if isinstance(expr, ast.Call):
        base, attr = _call_name(expr.func)
        if attr == "partial" and base in ("functools", None) and expr.args:
            return _dispatch_target(expr.args[0], assigns, depth + 1)
    return None


def _sync_message(
    node: ast.Call, params: Set[str]
) -> Optional[str]:
    """Why ``node`` waits for the device on the host, or None."""
    base, attr = _call_name(node.func)
    # a method on any receiver, a chain's too (``x.detach().cpu()``)
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _HOST_SYNC_ATTRS
    ):
        return f".{node.func.attr}() forces a host sync"
    if _dotted(node.func) == "torch.cuda.synchronize":
        return "torch.cuda.synchronize() waits for the whole card"
    if base in ("np", "numpy") and attr in _NP_SYNC_FUNCS:
        return f"np.{attr} materializes on host"
    if (
        base is None
        and attr in ("float", "int", "bool")
        and len(node.args) == 1
        and isinstance(node.args[0], ast.Name)
        and node.args[0].id in params
    ):
        return (
            f"{attr}() of an argument forces a host sync when it is a "
            f"card tensor (keep it a tensor, or pass a host scalar)"
        )
    return None


def _check_host_syncs(idx: LintIndex) -> List[Finding]:
    out: List[Finding] = []
    # package-wide function table keyed (module, name-or-qualname)
    fn_tables = {
        rel: _collect_functions(mod) for rel, mod in idx.modules.items()
    }
    # per-module import maps:
    #   import_maps:  local name  -> (target module rel, orig fn name)
    #   module_maps:  local alias -> target module rel (so the resolver
    #                 can walk through ``module.helper(x)`` calls)
    import_maps: Dict[str, Dict[str, Tuple[str, str]]] = {}
    module_maps: Dict[str, Dict[str, str]] = {}
    for rel, mod in idx.modules.items():
        imap: Dict[str, Tuple[str, str]] = {}
        mmap: Dict[str, str] = {}
        pkg_parts = rel.split("/")[:-1]  # dirs of this module
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                # import <pkg>.ops.sparse [as sp]
                for a in node.names:
                    cand = "/".join(a.name.split(".")) + ".py"
                    if a.asname and cand in idx.modules:
                        mmap[a.asname] = cand
                continue
            if not isinstance(node, ast.ImportFrom):
                continue
            if node.level:
                base_parts = pkg_parts[: len(pkg_parts) - (node.level - 1)]
            elif (node.module or "").split(".")[0] == idx.package:
                base_parts = []
            else:
                continue
            mod_parts = [p for p in (node.module or "").split(".") if p]
            target = "/".join(base_parts + mod_parts) + ".py"
            for a in node.names:
                # ``from .ops import sparse``: the bound name may be a
                # MODULE, not a function — check the file side first
                sub = "/".join(base_parts + mod_parts + [a.name]) + ".py"
                if sub in idx.modules:
                    mmap[a.asname or a.name] = sub
                elif target in idx.modules:
                    imap[a.asname or a.name] = (target, a.name)
        import_maps[rel] = imap
        module_maps[rel] = mmap

    def resolve(rel: str, name: str) -> Optional[Tuple[str, str]]:
        if name in _SANCTIONED_SYNCS:
            return None
        if name in fn_tables[rel]:
            return rel, name
        if name in import_maps[rel]:
            t_rel, t_name = import_maps[rel][name]
            if t_name in fn_tables.get(t_rel, {}):
                return t_rel, t_name
        return None

    # roots: every callable wrapped by telemetry.instrument_dispatch,
    # resolved in its module (or through its package-relative import)
    roots: List[Tuple[str, str]] = []
    for rel, mod in idx.modules.items():
        assigns: Dict[str, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                assigns[node.targets[0].id] = node.value
        for node in ast.walk(mod.tree):
            if not _is_dispatch_wrap(node):
                continue
            wrapped = _wrapped_callable(node)
            name = (
                _dispatch_target(wrapped, assigns)
                if wrapped is not None else None
            )
            hit = resolve(rel, name) if name else None
            if hit is not None:
                roots.append(hit)

    # BFS reachability over same-module defs + package-relative imports
    reached: Set[Tuple[str, str]] = set()
    frontier = list(roots)
    while frontier:
        rel, name = frontier.pop()
        if (rel, name) in reached:
            continue
        reached.add((rel, name))
        entry = fn_tables[rel].get(name)
        if entry is None:
            continue
        for node in ast.walk(entry.node):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                hit = resolve(rel, node.func.id)
                if hit is not None:
                    frontier.append(hit)
                continue
            # qualname-aware resolution: ``self.helper(x)`` /
            # ``cls.helper(x)`` resolve inside the enclosing class;
            # ``module.helper(x)`` resolves through the module-alias
            # import map
            if isinstance(node.func, ast.Attribute) and isinstance(
                node.func.value, ast.Name
            ):
                base, attr = node.func.value.id, node.func.attr
                if attr in _SANCTIONED_SYNCS:
                    continue
                if base in ("self", "cls") and entry.cls:
                    qkey = f"{entry.cls}.{attr}"
                    if qkey in fn_tables[rel]:
                        frontier.append((rel, qkey))
                elif base in module_maps[rel]:
                    t_rel = module_maps[rel][base]
                    if attr in fn_tables.get(t_rel, {}):
                        frontier.append((t_rel, attr))

    seen_nodes: Set[int] = set()
    for rel, name in sorted(reached):
        entry = fn_tables[rel][name]
        if id(entry.node) in seen_nodes:
            continue  # reached under both its qualname and simple name
        seen_nodes.add(id(entry.node))
        for node in ast.walk(entry.node):
            if not isinstance(node, ast.Call):
                continue
            msg = _sync_message(node, entry.params)
            if msg:
                out.append(idx.finding(
                    "STC005", rel, node.lineno,
                    f"{msg} — {name} is reachable from an instrumented "
                    f"dispatch (route a needed wait through "
                    f"telemetry.device_sync)",
                ))
    return out


# ---------------------------------------------------------------------------
# STC006 — mutable defaults + persistence key order
# ---------------------------------------------------------------------------
def _check_defaults_and_manifests(idx: LintIndex) -> List[Finding]:
    out: List[Finding] = []
    for rel, mod in idx.modules.items():
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defaults = list(node.args.defaults) + [
                    d for d in node.args.kw_defaults if d is not None
                ]
                for d in defaults:
                    mutable = isinstance(
                        d, (ast.List, ast.Dict, ast.Set)
                    ) or (
                        isinstance(d, ast.Call)
                        and isinstance(d.func, ast.Name)
                        and d.func.id in ("list", "dict", "set")
                    )
                    if mutable:
                        out.append(idx.finding(
                            "STC006", rel, d.lineno,
                            f"mutable default argument in {node.name}() "
                            f"— shared across calls; default to None",
                        ))
        if rel in {idx.rel(t) for t in PERSISTENCE_FILES}:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                base, attr = _call_name(node.func)
                if base != "json" or attr not in ("dump", "dumps"):
                    continue
                sorted_kw = any(
                    kw.arg == "sort_keys"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords
                )
                if not sorted_kw:
                    out.append(idx.finding(
                        "STC006", rel, node.lineno,
                        "persistence-layer json write without "
                        "sort_keys=True — manifest bytes would depend "
                        "on dict build order",
                    ))
    return out


# ---------------------------------------------------------------------------
# STC007 — lock discipline in the threaded modules
# ---------------------------------------------------------------------------
def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    """Attributes initialized to a ``threading`` synchronizer
    (``self._lock = threading.Lock()`` and friends)."""
    locks: Set[str] = set()
    for node in ast.walk(cls):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Attribute)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id == "self"
            and isinstance(node.value, ast.Call)
        ):
            continue
        base, attr = _call_name(node.value.func)
        if base == "threading" and attr in _LOCK_FACTORIES:
            locks.add(node.targets[0].attr)
    return locks


def _self_attr_accesses(
    method, locks: Set[str]
) -> List[Tuple[str, str, bool, int]]:
    """Every ``self.<attr>`` touch in one method as (attr, kind,
    under_lock, lineno), kind ∈ {"read", "write"}.  ``with self.<lock>``
    bodies (any nesting, any lock attr of the class) mark their
    accesses as locked; an in-place mutator call
    (``self.queue.append(x)``) counts as a write to the receiver."""
    acc: List[Tuple[str, str, bool, int]] = []

    def visit(node: ast.AST, locked: bool) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            body_locked = locked
            for item in node.items:
                visit(item.context_expr, locked)
                ce = item.context_expr
                if (
                    isinstance(ce, ast.Attribute)
                    and isinstance(ce.value, ast.Name)
                    and ce.value.id == "self"
                    and ce.attr in locks
                ):
                    body_locked = True
            for stmt in node.body:
                visit(stmt, body_locked)
            return
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            kind = (
                "write"
                if isinstance(node.ctx, (ast.Store, ast.Del))
                else "read"
            )
            acc.append((node.attr, kind, locked, node.lineno))
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ):
            f = node.func
            if (
                f.attr in _MUTATORS
                and isinstance(f.value, ast.Attribute)
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "self"
            ):
                acc.append((f.value.attr, "write", locked, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, locked)

    for stmt in method.body:
        visit(stmt, False)
    return acc


def _check_lock_discipline(idx: LintIndex) -> List[Finding]:
    out: List[Finding] = []
    for rel, mod in idx.modules.items():
        if rel not in {idx.rel(t) for t in LOCK_FILES}:
            continue
        for cls in (
            n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)
        ):
            locks = _class_lock_attrs(cls)
            if not locks:
                continue
            methods = [
                n for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            per_method = {
                m.name: _self_attr_accesses(m, locks) for m in methods
            }
            # pass 1: anything the class ever WRITES under a lock is
            # lock-guarded state
            guarded: Set[str] = set()
            for accesses in per_method.values():
                for attr, kind, locked, _ in accesses:
                    if kind == "write" and locked and attr not in locks:
                        guarded.add(attr)
            if not guarded:
                continue
            # pass 2: touching guarded state WITHOUT the lock in any
            # method that can run on a different thread than the
            # writer.  __init__ runs before the instance is shared.
            seen: Set[Tuple[int, str]] = set()
            for m in methods:
                if m.name == "__init__":
                    continue
                for attr, kind, locked, lineno in per_method[m.name]:
                    if locked or attr not in guarded:
                        continue
                    if (lineno, attr) in seen:
                        continue
                    seen.add((lineno, attr))
                    out.append(idx.finding(
                        "STC007", rel, lineno,
                        f"attribute {attr!r} is written under "
                        f"`with self.<lock>` elsewhere in "
                        f"{cls.name} but {kind} here without the "
                        f"lock — a data race once threads share the "
                        f"instance; take the lock or waive a "
                        f"deliberate lock-free access with a reason",
                    ))
    return out


# ---------------------------------------------------------------------------
# STC101 — unused imports
# ---------------------------------------------------------------------------
def _check_unused_imports(idx: LintIndex) -> List[Finding]:
    out: List[Finding] = []
    for rel, mod in idx.modules.items():
        if rel.endswith("/__init__.py"):
            continue  # re-export surface; __all__ governs
        bindings: List[Tuple[str, int]] = []
        for node in mod.tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = (a.asname or a.name).split(".")[0]
                    bindings.append((local, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for a in node.names:
                    if a.name == "*":
                        continue
                    bindings.append((a.asname or a.name, node.lineno))
        if not bindings:
            continue
        used: Set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Constant) and isinstance(
                node.value, str
            ):
                used.add(node.value)  # __all__ entries and friends
        for name, lineno in bindings:
            if name not in used:
                out.append(idx.finding(
                    "STC101", rel, lineno,
                    f"import {name!r} is unused",
                ))
    return out


# ---------------------------------------------------------------------------
# STC102 — f-string into logging
# ---------------------------------------------------------------------------
def _check_fstring_logging(idx: LintIndex) -> List[Finding]:
    out: List[Finding] = []
    log_bases = {"logging", "logger", "log", "LOG", "LOGGER"}
    for rel, mod in idx.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            if attr not in _LOG_METHODS or base not in log_bases:
                continue
            if node.args and isinstance(node.args[0], ast.JoinedStr):
                out.append(idx.finding(
                    "STC102", rel, node.lineno,
                    "f-string evaluated eagerly in a logging call — "
                    "pass a %-format string and args instead",
                ))
    return out


_CHECKS = (
    _check_sleep,
    _check_excepts,
    _check_fault_sites,
    _check_metric_names,
    _check_host_syncs,
    _check_defaults_and_manifests,
    _check_lock_discipline,
    _check_unused_imports,
    _check_fstring_logging,
)


def run_ast_rules(
    root: str,
    rules: Optional[Sequence[str]] = None,
    package: str = PACKAGE,
) -> List[Finding]:
    """Run layer 1 over the package directory ``package`` under ``root``;
    returns findings with inline-pragma waivers already applied."""
    idx = LintIndex.build(root, package)
    out: List[Finding] = []
    for check in _CHECKS:
        out.extend(check(idx))
    if rules:
        keep = set(rules)
        out = [f for f in out if f.rule in keep]
    return out
