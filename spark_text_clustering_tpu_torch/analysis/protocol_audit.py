"""Protocol audit — layer 4 of `stc lint` (STC300-series), a copy of the
JAX package's ``analysis/protocol_audit.py`` pointed at the port.

Statically proves the fleet's coordination fabric — threads plus
shared files — safe before the protocols go multi-host:

* STC300  lock-order deadlocks: the cross-module lock-acquisition
          graph over the threaded modules must be acyclic, and no
          blocking call (sleep, HTTP, thread join, event wait) may run
          while a lock is held.
* STC301  shared-state escape: an attribute reachable from a
          ``threading.Thread`` target that is also written on the
          other side must be lock-guarded at every touch, a threading
          synchronizer, or a registered atomically-swapped immutable
          snapshot.
* STC302  atomic-publish discipline: every write route to a protocol
          path must be a registered writer using stage-then-
          ``os.replace`` (or sanctioned append); a bare
          ``open(path, "w")`` is a torn read waiting for a second host.
* STC303  torn-read tolerance: every reader of a protocol path must be
          a registered tolerant reader — mid-write must read as "not
          there yet", never as a crash.
* STC304  durability ordering: durability-critical appenders (fence
          ledger, epoch ledger, alert log) must ``os.fsync`` before
          their record counts as published.
* STC305  writer/reader schema conformance: the field set each
          registered reader *requires* must be a subset of what its
          paired writers provably emit — lease/control schema drift
          between supervisor and front fails at lint time.

All rules are pure AST (no jax, no imports of the audited modules) and
checked BOTH directions against ``analysis/protocol_sites.SITES``: a
stale registry entry is a finding just like an unregistered touchpoint.
Findings carry ``protocol:<path>`` so baseline waivers stay scoped to
this tier (the ``jaxpr:`` / ``scale:`` convention).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .ast_rules import (
    PACKAGE,
    LintIndex,
    _call_name,
    _const_str,
    _self_attr_accesses,
)
from .findings import Finding
from .protocol_sites import SITES, ProtocolSites

__all__ = ["PROTOCOL_RULES", "run_protocol_audit"]

PROTOCOL_PREFIX = "protocol:"

PROTOCOL_RULES = (
    "STC300", "STC301", "STC302", "STC303", "STC304", "STC305",
)

# threading factories by reentrancy: re-acquiring a held non-reentrant
# primitive on the same thread deadlocks immediately
_SYNC_FACTORIES = {
    "Lock": "lock", "RLock": "rlock", "Condition": "condition",
    "Semaphore": "semaphore", "BoundedSemaphore": "semaphore",
    "Event": "event", "Thread": "thread",
}
_NON_REENTRANT = {"lock", "semaphore"}
_LOCKLIKE = {"lock", "rlock", "condition", "semaphore"}

# calls that block the calling thread (STC300 forbids them under a lock)
_BLOCKING_BARE = {"sleep", "_sleep", "_idle_sleep", "urlopen",
                  "retry_call"}
_BLOCKING_QUAL = {("time", "sleep"), ("urllib", "urlopen")}
_BLOCKING_ATTRS = {"getresponse"}       # http.client response read

_TOLERANT_WRITERS = {"atomic_write_text"}
_PUBLISH_CALLS = {"replace", "rename"}  # os.replace / os.rename

_MAX_WALK_DEPTH = 8


# ---------------------------------------------------------------------------
# cross-module tables (functions, classes, imports)
# ---------------------------------------------------------------------------
@dataclass
class _FnInfo:
    rel: str
    qualname: str                   # "func" or "Class.method"
    node: ast.AST                   # FunctionDef / AsyncFunctionDef
    cls: Optional[str] = None


@dataclass
class _ClassInfo:
    name: str
    node: ast.ClassDef
    bases: Tuple[str, ...]
    sync: Dict[str, str] = field(default_factory=dict)  # attr -> kind
    thread_targets: Tuple[str, ...] = ()                # Thread method names


def _class_sync_attrs(cls: ast.ClassDef) -> Dict[str, str]:
    """self.<attr> slots initialized to a ``threading`` primitive,
    mapped to their reentrancy kind (see _SYNC_FACTORIES)."""
    sync: Dict[str, str] = {}
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
        if base == "threading" and attr in _SYNC_FACTORIES:
            sync[node.targets[0].attr] = _SYNC_FACTORIES[attr]
    return sync


def _thread_targets(cls: ast.ClassDef) -> Tuple[str, ...]:
    """Method names this class hands to ``threading.Thread(target=...)``
    — the entry points of its background threads."""
    out: List[str] = []
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        base, attr = _call_name(node.func)
        if not (base == "threading" and attr == "Thread"):
            continue
        for kw in node.keywords:
            if (
                kw.arg == "target"
                and isinstance(kw.value, ast.Attribute)
                and isinstance(kw.value.value, ast.Name)
                and kw.value.value.id == "self"
            ):
                out.append(kw.value.attr)
    return tuple(out)


def _module_rel_for(parts: Sequence[str], idx: LintIndex) -> Optional[str]:
    """A parsed module rel for dotted ``parts`` (module file first,
    package __init__ second), or None when outside the package."""
    for cand in ("/".join(parts) + ".py",
                 "/".join(parts) + "/__init__.py"):
        if cand in idx.modules:
            return cand
    return None


def _import_map(
    rel: str, tree: ast.Module, idx: LintIndex
) -> Dict[str, Tuple[str, str]]:
    """local name -> (defining module rel, original name) for every
    ``from X import y`` (module-level or function-local) resolvable
    inside the package."""
    pkg_parts = rel[:-3].split("/")[:-1]   # directory of this module
    out: Dict[str, Tuple[str, str]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level > 0:
            base = pkg_parts[: len(pkg_parts) - (node.level - 1)]
        elif node.module and node.module.split(".")[0] == idx.package:
            base = []
        else:
            continue
        mod_parts = list(base) + (
            node.module.split(".") if node.module else []
        )
        target = _module_rel_for(mod_parts, idx)
        for alias in node.names:
            name = alias.asname or alias.name
            if target is not None:
                out[name] = (target, alias.name)
            else:
                # maybe `from .serving import front` style: the alias
                # itself names a submodule
                sub = _module_rel_for(mod_parts + [alias.name], idx)
                if sub is not None:
                    out[name] = (sub, "")
    return out


class _Tables:
    """Cheap cross-module lookup: functions by qualname, classes with
    their synchronizer attrs, and per-module import maps."""

    def __init__(self, idx: LintIndex) -> None:
        self.idx = idx
        self.funcs: Dict[Tuple[str, str], _FnInfo] = {}
        self.by_module: Dict[str, Dict[str, _FnInfo]] = {}
        self.classes: Dict[str, Dict[str, _ClassInfo]] = {}
        self.imports: Dict[str, Dict[str, Tuple[str, str]]] = {}
        for rel, mod in idx.modules.items():
            mod_fns: Dict[str, _FnInfo] = {}
            cls_map: Dict[str, _ClassInfo] = {}
            for node in mod.tree.body:
                if isinstance(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    info = _FnInfo(rel, node.name, node)
                    mod_fns[node.name] = info
                elif isinstance(node, ast.ClassDef):
                    bases = tuple(
                        b.id for b in node.bases
                        if isinstance(b, ast.Name)
                    )
                    cls_map[node.name] = _ClassInfo(
                        name=node.name, node=node, bases=bases,
                        sync=_class_sync_attrs(node),
                        thread_targets=_thread_targets(node),
                    )
                    for item in node.body:
                        if isinstance(
                            item, (ast.FunctionDef, ast.AsyncFunctionDef)
                        ):
                            info = _FnInfo(
                                rel, f"{node.name}.{item.name}",
                                item, cls=node.name,
                            )
                            mod_fns[info.qualname] = info
            self.by_module[rel] = mod_fns
            self.classes[rel] = cls_map
            for info in mod_fns.values():
                self.funcs[(rel, info.qualname)] = info
            self.imports[rel] = _import_map(rel, mod.tree, idx)

    # -- inheritance-aware lookups (single module scope) ----------------
    def mro(self, rel: str, cls_name: str) -> List[_ClassInfo]:
        out: List[_ClassInfo] = []
        seen: Set[str] = set()
        stack = [cls_name]
        while stack:
            name = stack.pop(0)
            if name in seen:
                continue
            seen.add(name)
            info = self.classes.get(rel, {}).get(name)
            if info is None:
                continue
            out.append(info)
            stack.extend(info.bases)
        return out

    def class_sync(self, rel: str, cls_name: str) -> Dict[str, str]:
        sync: Dict[str, str] = {}
        for info in reversed(self.mro(rel, cls_name)):
            sync.update(info.sync)
        return sync

    def resolve_method(
        self, rel: str, cls_name: str, method: str
    ) -> Optional[_FnInfo]:
        for info in self.mro(rel, cls_name):
            hit = self.funcs.get((rel, f"{info.name}.{method}"))
            if hit is not None:
                return hit
        return None

    def resolve_call(
        self, rel: str, cls_name: Optional[str], func: ast.AST
    ) -> Optional[_FnInfo]:
        """Resolve a call expression to a package function: self.m(),
        a bare local/imported name, or module.func() through an
        imported submodule."""
        if (
            isinstance(func, ast.Attribute)
            and isinstance(func.value, ast.Name)
        ):
            if func.value.id == "self" and cls_name is not None:
                return self.resolve_method(rel, cls_name, func.attr)
            imp = self.imports.get(rel, {}).get(func.value.id)
            if imp is not None and imp[1] == "":     # submodule alias
                return self.by_module.get(imp[0], {}).get(func.attr)
            return None
        if isinstance(func, ast.Name):
            local = self.by_module.get(rel, {}).get(func.id)
            if local is not None and local.cls is None:
                return local
            imp = self.imports.get(rel, {}).get(func.id)
            if imp is not None and imp[1]:
                return self.by_module.get(imp[0], {}).get(imp[1])
        return None


def _pfind(
    idx: LintIndex, rule: str, rel: str, lineno: int, message: str
) -> Finding:
    if rel in idx.modules:
        f = idx.finding(rule, rel, lineno, message)
    else:
        # a registry entry can point at a module absent from this scan
        # root (fixture runs, or a deleted file) — still a finding,
        # just with no snippet/pragma to consult
        f = Finding(rule=rule, path=rel, line=lineno, message=message)
    f.path = PROTOCOL_PREFIX + f.path
    return f


# ---------------------------------------------------------------------------
# STC300 — lock-order deadlock detection
# ---------------------------------------------------------------------------
class _LockWalk:
    """Walks methods of the threaded modules carrying the held-lock
    stack across resolvable calls; records acquisition edges and flags
    blocking calls / non-reentrant re-entry under a held lock."""

    def __init__(
        self, idx: LintIndex, tables: _Tables, sites: ProtocolSites
    ) -> None:
        self.idx = idx
        self.tables = tables
        self.sites = sites
        # (held_lock, acquired_lock) -> first (rel, lineno) seen
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.findings: List[Finding] = []
        self._visited: Set[Tuple[str, str, frozenset]] = set()

    def lock_id(self, rel: str, cls: Optional[str], attr: str) -> str:
        return f"{rel.rsplit('/', 1)[-1]}:{cls or '?'}.{attr}"

    def run(self) -> None:
        for rel in self.sites.threaded_modules:
            for info in self.tables.by_module.get(rel, {}).values():
                self._walk_fn(info, held=())

    # -- one function under one held-lock context -----------------------
    def _walk_fn(self, info: _FnInfo, held: Tuple[str, ...]) -> None:
        key = (info.rel, info.qualname, frozenset(held))
        if key in self._visited or len(held) > _MAX_WALK_DEPTH:
            return
        self._visited.add(key)
        sync = (
            self.tables.class_sync(info.rel, info.cls)
            if info.cls else {}
        )
        self._walk_stmts(info, info.node.body, held, sync)

    def _self_sync_attr(
        self, node: ast.AST, sync: Dict[str, str]
    ) -> Optional[str]:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in sync
        ):
            return node.attr
        return None

    def _walk_stmts(
        self,
        info: _FnInfo,
        stmts: Sequence[ast.AST],
        held: Tuple[str, ...],
        sync: Dict[str, str],
    ) -> None:
        for stmt in stmts:
            self._walk_node(info, stmt, held, sync)

    def _walk_node(
        self,
        info: _FnInfo,
        node: ast.AST,
        held: Tuple[str, ...],
        sync: Dict[str, str],
    ) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not info.node:
            # nested def: body runs when called, not here — walk it
            # with the same held context (closures share the locks)
            self._walk_stmts(info, node.body, held, sync)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = held
            for item in node.items:
                self._walk_node(info, item.context_expr, held, sync)
                attr = self._self_sync_attr(item.context_expr, sync)
                if attr is not None and sync[attr] in _LOCKLIKE:
                    new_held = self._acquire(
                        info, attr, sync, new_held,
                        item.context_expr.lineno,
                    )
            self._walk_stmts(info, node.body, new_held, sync)
            return
        if isinstance(node, ast.Call):
            self._check_call(info, node, held, sync)
        for child in ast.iter_child_nodes(node):
            self._walk_node(info, child, held, sync)

    def _acquire(
        self,
        info: _FnInfo,
        attr: str,
        sync: Dict[str, str],
        held: Tuple[str, ...],
        lineno: int,
    ) -> Tuple[str, ...]:
        lid = self.lock_id(info.rel, info.cls, attr)
        if lid in held and sync[attr] in _NON_REENTRANT:
            self.findings.append(_pfind(
                self.idx, "STC300", info.rel, lineno,
                f"re-acquiring held non-reentrant {lid} in "
                f"{info.qualname} — self-deadlock",
            ))
            return held
        for h in held:
            if h != lid:
                self.edges.setdefault((h, lid), (info.rel, lineno))
        return held + (lid,) if lid not in held else held

    def _check_call(
        self,
        info: _FnInfo,
        node: ast.Call,
        held: Tuple[str, ...],
        sync: Dict[str, str],
    ) -> None:
        base, attr = _call_name(node.func)
        if attr is None and isinstance(node.func, ast.Attribute):
            # _call_name gives (None, None) for two-level receivers
            # like self._ev.wait — the method name still matters here
            attr = node.func.attr
        # explicit .acquire() on a lock attr: record the edge even
        # though we don't track its release scope
        recv = (
            node.func.value
            if isinstance(node.func, ast.Attribute) else None
        )
        recv_attr = (
            self._self_sync_attr(recv, sync) if recv is not None
            else None
        )
        if attr == "acquire" and recv_attr is not None and held:
            self._acquire(info, recv_attr, sync, held, node.lineno)
            return
        if not held:
            # no lock held: descend so a callee that takes a lock and
            # then calls back up still builds the full graph
            callee = self.tables.resolve_call(
                info.rel, info.cls, node.func
            )
            if callee is not None and (
                callee.rel in self.sites.threaded_modules
            ):
                self._walk_fn(callee, held)
            return
        held_s = ", ".join(held)
        blocking = None
        if (base, attr) in _BLOCKING_QUAL or (
            base is None and attr in _BLOCKING_BARE
        ):
            blocking = attr
        elif attr in _BLOCKING_ATTRS:
            blocking = attr
        elif attr == "join" and recv_attr is not None and \
                sync.get(recv_attr) == "thread":
            blocking = f"{recv_attr}.join"
        elif attr == "wait" and recv_attr is not None:
            kind = sync.get(recv_attr)
            lid = self.lock_id(info.rel, info.cls, recv_attr)
            if kind == "condition" and lid in held:
                blocking = None     # cond.wait RELEASES the held lock
            elif kind in ("event", "condition") or kind in _LOCKLIKE:
                blocking = f"{recv_attr}.wait"
        if blocking is not None:
            self.findings.append(_pfind(
                self.idx, "STC300", info.rel, node.lineno,
                f"blocking call {blocking}() in {info.qualname} while "
                f"holding {held_s} — stalls every thread queued on the "
                f"lock",
            ))
            return
        callee = self.tables.resolve_call(info.rel, info.cls, node.func)
        if callee is not None:
            self._walk_fn(callee, held)

    # -- cycles over the acquisition graph ------------------------------
    def cycle_findings(self) -> List[Finding]:
        adj: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
        out: List[Finding] = []
        seen_cycles: Set[frozenset] = set()
        for start in sorted(adj):
            stack = [(start, (start,))]
            while stack:
                cur, path = stack.pop()
                for nxt in sorted(adj.get(cur, ())):
                    if nxt == start:
                        cyc = frozenset(path)
                        if cyc in seen_cycles:
                            continue
                        seen_cycles.add(cyc)
                        rel, lineno = self.edges[(cur, nxt)]
                        chain = " -> ".join(path + (start,))
                        out.append(_pfind(
                            self.idx, "STC300", rel, lineno,
                            f"lock-order cycle: {chain} — two threads "
                            f"taking these in opposite order deadlock",
                        ))
                    elif nxt not in path and len(path) <= 6:
                        stack.append((nxt, path + (nxt,)))
        return out


def _check_lock_graph(
    idx: LintIndex, tables: _Tables, sites: ProtocolSites
) -> Tuple[List[Finding], Dict]:
    walk = _LockWalk(idx, tables, sites)
    walk.run()
    findings = walk.findings + walk.cycle_findings()
    return findings, {
        "lock_edges": len(walk.edges),
        "locks": len({l for e in walk.edges for l in e}),
    }


# ---------------------------------------------------------------------------
# STC301 — shared-state escape from thread targets
# ---------------------------------------------------------------------------
def _check_thread_escape(
    idx: LintIndex, tables: _Tables, sites: ProtocolSites
) -> List[Finding]:
    out: List[Finding] = []
    for rel in sites.threaded_modules:
        for cinfo in tables.classes.get(rel, {}).values():
            if not cinfo.thread_targets:
                continue
            sync = tables.class_sync(rel, cinfo.name)
            locks = {a for a, k in sync.items() if k in _LOCKLIKE}
            # methods reachable from the thread entry points
            reach: Set[str] = set()
            stack = list(cinfo.thread_targets)
            while stack:
                m = stack.pop()
                if m in reach:
                    continue
                reach.add(m)
                fn = tables.resolve_method(rel, cinfo.name, m)
                if fn is None:
                    continue
                for node in ast.walk(fn.node):
                    if (
                        isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                    ):
                        stack.append(node.func.attr)
            # accesses per attr, split by side
            per_attr: Dict[str, Dict[str, List[Tuple[bool, int, str]]]]
            per_attr = {}
            for minfo in tables.mro(rel, cinfo.name):
                for item in minfo.node.body:
                    if not isinstance(
                        item, (ast.FunctionDef, ast.AsyncFunctionDef)
                    ):
                        continue
                    if item.name == "__init__":
                        continue
                    side = (
                        "thread" if item.name in reach else "main"
                    )
                    for attr, kind, locked, lineno in \
                            _self_attr_accesses(item, locks):
                        slot = per_attr.setdefault(
                            attr, {"thread": [], "main": []}
                        )
                        slot[side].append((locked, lineno, kind))
            for attr in sorted(per_attr):
                if attr in sync:        # synchronizers are the fences
                    continue
                key = (rel, cinfo.name, attr)
                acc = per_attr[attr]
                t_any = bool(acc["thread"])
                m_write = any(k == "write" for _, _, k in acc["main"])
                t_write = any(k == "write" for _, _, k in acc["thread"])
                m_any = bool(acc["main"])
                if not ((t_any and m_write) or (t_write and m_any)):
                    continue
                if key in sites.atomic_snapshots:
                    continue
                unlocked = [
                    (lineno, side)
                    for side in ("thread", "main")
                    for locked, lineno, _k in acc[side]
                    if not locked
                ]
                if not unlocked:
                    continue
                lineno, side = min(unlocked)
                out.append(_pfind(
                    idx, "STC301", rel, lineno,
                    f"{cinfo.name}.{attr} crosses the "
                    f"{cinfo.name} thread boundary but this {side}-"
                    f"side access holds no lock — guard every touch, "
                    f"or register it in protocol_sites."
                    f"atomic_snapshots if it is an immutable-snapshot "
                    f"rebind",
                ))
    # registry -> code: snapshots must still name a real attribute
    for (rel, cls_name, attr) in sorted(sites.atomic_snapshots):
        cinfo = tables.classes.get(rel, {}).get(cls_name)
        found = cinfo is not None and any(
            isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name)
            and n.value.id == "self" and n.attr == attr
            for m in tables.mro(rel, cls_name)
            for n in ast.walk(m.node)
        )
        if not found:
            out.append(_pfind(
                idx, "STC301", rel, 1,
                f"stale atomic_snapshots entry "
                f"{cls_name}.{attr} — no such attribute; prune the "
                f"registry",
            ))
    return out


# ---------------------------------------------------------------------------
# STC302/303/304 — protocol-path write/read discipline
# ---------------------------------------------------------------------------
def _tagged_names(
    fn: ast.AST, rel: str, cls: Optional[str], sites: ProtocolSites,
    rel_attrs: Set[str],
) -> Set[str]:
    """Local names assigned (directly or through one chain) from a
    protocol-path expression."""
    tagged: Set[str] = set()
    for _ in range(2):                 # fixpoint over short chains
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and _expr_tagged(
                    node.value, sites, rel_attrs, tagged
                )
            ):
                tagged.add(node.targets[0].id)
    return tagged


def _expr_tagged(
    expr: ast.AST,
    sites: ProtocolSites,
    rel_attrs: Set[str],
    tagged: Set[str],
) -> bool:
    for node in ast.walk(expr):
        s = _const_str(node)
        if s is not None and any(
            lit in s for lit in sites.path_literals
        ):
            return True
        if isinstance(node, ast.Name) and (
            node.id in sites.path_constants or node.id in tagged
        ):
            return True
        if isinstance(node, ast.Attribute):
            if node.attr in sites.path_constants:
                return True
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
                and node.attr in rel_attrs
            ):
                return True
        if isinstance(node, ast.Call):
            _b, a = _call_name(node.func)
            if a in sites.path_helpers:
                return True
    return False


def _open_mode(node: ast.Call) -> str:
    if len(node.args) >= 2:
        return _const_str(node.args[1]) or "?"
    for kw in node.keywords:
        if kw.arg == "mode":
            return _const_str(kw.value) or "?"
    return "r"


def _has_tolerant_try(fn: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Try) and n.handlers for n in ast.walk(fn)
    )


def _contains_call(fn: ast.AST, bare: Set[str], attrs: Set[str]) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            _b, a = _call_name(node.func)
            if a in bare or a in attrs:
                return True
    return False


def _check_file_protocols(
    idx: LintIndex, tables: _Tables, sites: ProtocolSites
) -> List[Finding]:
    out: List[Finding] = []
    writer_keys = {(w.module, w.qualname): w for w in sites.writers}
    reader_keys = {(r.module, r.qualname) for r in sites.readers}
    attrs_by_rel: Dict[str, Set[str]] = {}
    for (rel, _cls, attr) in sites.path_attrs:
        attrs_by_rel.setdefault(rel, set()).add(attr)

    # code -> registry: scan every function for protocol-path touches
    for (rel, qual), info in sorted(tables.funcs.items()):
        rel_attrs = attrs_by_rel.get(rel, set())
        tagged = _tagged_names(info.node, rel, info.cls, sites, rel_attrs)
        is_writer = (rel, qual) in writer_keys
        is_reader = (rel, qual) in reader_keys
        for node in ast.walk(info.node):
            if not isinstance(node, ast.Call):
                continue
            base, attr = _call_name(node.func)
            if attr in _TOLERANT_WRITERS and node.args and \
                    _expr_tagged(node.args[0], sites, rel_attrs, tagged):
                if not is_writer:
                    out.append(_pfind(
                        idx, "STC302", rel, node.lineno,
                        f"{qual} publishes a protocol path via "
                        f"{attr}() but is not a registered writer — "
                        f"add it to protocol_sites.WRITERS so its "
                        f"discipline stays audited",
                    ))
                continue
            if base is None and attr == "open" and node.args and \
                    _expr_tagged(node.args[0], sites, rel_attrs, tagged):
                mode = _open_mode(node)
                writes = any(c in mode for c in "wax+") or mode == "?"
                if writes and not is_writer:
                    out.append(_pfind(
                        idx, "STC302", rel, node.lineno,
                        f"bare open(..., \"{mode}\") on a protocol "
                        f"path in {qual} — a reader on another host "
                        f"can observe the torn write; stage then "
                        f"os.replace (resilience.integrity."
                        f"atomic_write_text) via a registered writer",
                    ))
                elif not writes and not (is_reader or is_writer):
                    out.append(_pfind(
                        idx, "STC303", rel, node.lineno,
                        f"bare read of a protocol path in {qual} — "
                        f"route it through a registered tolerant "
                        f"reader (protocol_sites.READERS) so a "
                        f"mid-write file reads as absent, not a crash",
                    ))

    # registry -> code: writers must exist and keep their shape
    for (rel, qual), site in sorted(writer_keys.items()):
        info = tables.funcs.get((rel, qual))
        if info is None:
            out.append(_pfind(
                idx, "STC302", rel, 1,
                f"stale WRITERS entry {qual} — function not found; "
                f"prune or update protocol_sites",
            ))
            continue
        if site.kind == "atomic":
            ok = _contains_call(
                info.node, _TOLERANT_WRITERS,
                _TOLERANT_WRITERS | _PUBLISH_CALLS,
            )
            if not ok:
                out.append(_pfind(
                    idx, "STC302", rel, info.node.lineno,
                    f"registered atomic writer {qual} has no "
                    f"atomic_write_text / os.replace publish step — "
                    f"its writes are no longer atomic",
                ))
        else:                           # append
            ok = any(
                isinstance(n, ast.Call)
                and _call_name(n.func) == (None, "open")
                and "a" in _open_mode(n)
                for n in ast.walk(info.node)
            )
            if not ok:
                out.append(_pfind(
                    idx, "STC302", rel, info.node.lineno,
                    f"registered append writer {qual} no longer opens "
                    f"its path in append mode",
                ))
        if site.durable and not _contains_call(
            info.node, set(), {"fsync"}
        ):
            out.append(_pfind(
                idx, "STC304", rel, info.node.lineno,
                f"durability-critical writer {qual} does not "
                f"os.fsync before publishing — a power cut can "
                f"reorder the rename ahead of the data",
            ))

    # registry -> code: readers must exist, read, and tolerate
    for (rel, qual) in sorted(reader_keys):
        info = tables.funcs.get((rel, qual))
        if info is None:
            out.append(_pfind(
                idx, "STC303", rel, 1,
                f"stale READERS entry {qual} — function not found; "
                f"prune or update protocol_sites",
            ))
            continue
        reads = any(
            isinstance(n, ast.Call) and (
                (_call_name(n.func) == (None, "open")
                 and not any(c in _open_mode(n) for c in "wax+"))
                or _call_name(n.func)[1] in ("load", "loads")
            )
            for n in ast.walk(info.node)
        )
        if not reads:
            out.append(_pfind(
                idx, "STC303", rel, info.node.lineno,
                f"stale READERS entry {qual} — it no longer reads "
                f"anything; prune or update protocol_sites",
            ))
            continue
        if not _has_tolerant_try(info.node):
            out.append(_pfind(
                idx, "STC303", rel, info.node.lineno,
                f"registered reader {qual} has no try/except around "
                f"its reads — a torn or missing protocol file "
                f"crashes it instead of reading as absent",
            ))

    # registry -> code: path attrs must name a real slot
    for (rel, cls_name, attr) in sorted(sites.path_attrs):
        found = any(
            isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name)
            and n.value.id == "self" and n.attr == attr
            for m in tables.mro(rel, cls_name)
            for n in ast.walk(m.node)
        )
        if not found:
            out.append(_pfind(
                idx, "STC302", rel, 1,
                f"stale PATH_ATTRS entry {cls_name}.{attr} — no such "
                f"attribute; prune the registry",
            ))
    return out


# ---------------------------------------------------------------------------
# STC305 — writer/reader schema conformance
# ---------------------------------------------------------------------------
def _emitted_fields(
    tables: _Tables, pair, idx: LintIndex
) -> Tuple[Set[str], List[Finding]]:
    findings: List[Finding] = []
    emitted: Set[str] = set(pair.extra_fields)
    for (rel, qual) in pair.writers:
        info = tables.funcs.get((rel, qual))
        if info is None:
            findings.append(_pfind(
                idx, "STC305", rel, 1,
                f"stale schema pair '{pair.name}': writer {qual} not "
                f"found",
            ))
            continue
        for node in ast.walk(info.node):
            if isinstance(node, ast.Dict):
                for k in node.keys:
                    s = _const_str(k) if k is not None else None
                    if s is not None:
                        emitted.add(s)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Subscript):
                        s = _const_str(t.slice)
                        if s is not None:
                            emitted.add(s)
    if pair.field_call_names or pair.field_dict_kwargs:
        for rel, mod_fns in tables.by_module.items():
            mod = tables.idx.modules[rel]
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                _b, attr = _call_name(node.func)
                if attr in pair.field_call_names:
                    for kw in node.keywords:
                        if kw.arg and kw.arg not in pair.exclude_fields:
                            emitted.add(kw.arg)
                for kw in node.keywords:
                    if kw.arg in pair.field_dict_kwargs and \
                            isinstance(kw.value, ast.Dict):
                        for k in kw.value.keys:
                            s = _const_str(k) if k is not None else None
                            if s is not None:
                                emitted.add(s)
    return emitted, findings


def _required_fields(
    tables: _Tables, pair, idx: LintIndex
) -> Tuple[Dict[str, List[Tuple[str, str, int]]], List[Finding]]:
    """field -> [(reader qualname, rel, lineno)] for every field a
    pair reader requires (subscript, or .get with no default)."""
    findings: List[Finding] = []
    required: Dict[str, List[Tuple[str, str, int]]] = {}
    for (rel, qual) in pair.readers:
        info = tables.funcs.get((rel, qual))
        if info is None:
            findings.append(_pfind(
                idx, "STC305", rel, 1,
                f"stale schema pair '{pair.name}': reader {qual} not "
                f"found",
            ))
            continue
        tainted: Set[str] = set()
        for _ in range(2):
            for node in ast.walk(info.node):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    continue
                v = node.value
                if isinstance(v, ast.Call) and _call_name(v.func)[1] \
                        in pair.reader_seed_calls:
                    tainted.add(node.targets[0].id)
                elif isinstance(v, ast.Name) and v.id in tainted:
                    tainted.add(node.targets[0].id)
        if not tainted:
            findings.append(_pfind(
                idx, "STC305", rel, info.node.lineno,
                f"stale schema pair '{pair.name}': reader {qual} no "
                f"longer reads via "
                f"{'/'.join(pair.reader_seed_calls)} — update "
                f"protocol_sites so schema drift stays caught",
            ))
            continue
        for node in ast.walk(info.node):
            fld: Optional[str] = None
            if (
                isinstance(node, ast.Subscript)
                and isinstance(node.value, ast.Name)
                and node.value.id in tainted
                and isinstance(node.ctx, ast.Load)
            ):
                fld = _const_str(node.slice)
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in tainted
                and len(node.args) == 1
                and not node.keywords
            ):
                fld = _const_str(node.args[0])
            if fld is not None:
                required.setdefault(fld, []).append(
                    (qual, rel, node.lineno)
                )
    return required, findings


def _check_schemas(
    idx: LintIndex, tables: _Tables, sites: ProtocolSites
) -> Tuple[List[Finding], Dict]:
    out: List[Finding] = []
    pairs_report: Dict[str, Dict] = {}
    for pair in sites.schema_pairs:
        emitted, f1 = _emitted_fields(tables, pair, idx)
        required, f2 = _required_fields(tables, pair, idx)
        out.extend(f1)
        out.extend(f2)
        missing = sorted(set(required) - emitted)
        for fld in missing:
            qual, rel, lineno = required[fld][0]
            out.append(_pfind(
                idx, "STC305", rel, lineno,
                f"schema drift in pair '{pair.name}': reader {qual} "
                f"requires field '{fld}' that no registered writer "
                f"emits — a cross-host reader would see it vanish",
            ))
        pairs_report[pair.name] = {
            "emitted": sorted(emitted),
            "required": sorted(required),
            "missing": missing,
        }
    return out, pairs_report


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------
def run_protocol_audit(
    root: str, sites: ProtocolSites = SITES, package: str = PACKAGE
) -> Tuple[List[Finding], Dict]:
    """Run STC300-305 over the package directory ``package`` under
    ``root``; returns (findings, report).  Pure AST — safe anywhere the
    repo checks out."""
    idx = LintIndex.build(root, package)
    tables = _Tables(idx)
    findings: List[Finding] = []
    lock_findings, lock_stats = _check_lock_graph(idx, tables, sites)
    findings += lock_findings
    findings += _check_thread_escape(idx, tables, sites)
    findings += _check_file_protocols(idx, tables, sites)
    schema_findings, pairs_report = _check_schemas(idx, tables, sites)
    findings += schema_findings
    findings.sort(key=lambda f: (f.rule, f.path, f.line))
    rules: Dict[str, int] = {r: 0 for r in PROTOCOL_RULES}
    for f in findings:
        rules[f.rule] = rules.get(f.rule, 0) + 1
    report = {
        "sites": sites.site_count(),
        "modules": len(sites.watched_modules()),
        "rules": rules,
        "pairs": pairs_report,
        **lock_stats,
    }
    return findings, report
