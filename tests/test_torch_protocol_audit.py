"""The port's ``lint --protocol`` (``analysis.protocol_audit`` and
``analysis.protocol_sites``, STC300-305) held against the JAX package's.

Every fixture of the JAX package's ``tests/test_protocol_audit.py`` (the
planted STC300-305 violations and their compliant twins, stale registry
entries, the pragma and baseline round trips over ``protocol:`` paths) is
written under each package's own directory, in two roots, with a registry
naming each package's own module; both audits must report the same
(rule, path below the package, line) findings with the same messages,
and the same report.  Then the port's own tree: protocol-clean against
its registry, whose schema pairs cover the lease and control contracts,
and the ``--changed`` gating.
"""

from __future__ import annotations

import os
import textwrap

import pytest

from spark_text_clustering_tpu.analysis import ast_rules as jrules
from spark_text_clustering_tpu.analysis import findings as jfind
from spark_text_clustering_tpu.analysis import protocol_audit as jaudit
from spark_text_clustering_tpu.analysis import protocol_sites as jsites
from spark_text_clustering_tpu_torch.analysis import ast_rules as trules
from spark_text_clustering_tpu_torch.analysis import cli as tlint
from spark_text_clustering_tpu_torch.analysis import findings as tfind
from spark_text_clustering_tpu_torch.analysis import protocol_audit as taudit
from spark_text_clustering_tpu_torch.analysis import protocol_sites as tsites

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jrules.PACKAGE, jaudit, jsites, jfind),
            "port": (trules.PACKAGE, taudit, tsites, tfind)}


def _sites(mod, **kw):
    base = dict(
        threaded_modules=(),
        path_literals=frozenset(),
        path_constants=frozenset(),
        path_helpers=frozenset(),
        path_attrs=frozenset(),
    )
    base.update(kw)
    return mod.ProtocolSites(**base)


# the JAX package's fixture sources -----------------------------------------
_CYCLE = """
    import threading
    import time

    class Cycler:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def fwd(self):
            with self._a:
                with self._b:
                    pass

        def back(self):
            with self._b:
                self.helper()

        def helper(self):
            with self._a:
                time.sleep(1)
"""
_ORDERED = """
    import threading

    class Ordered:
        def __init__(self):
            self._a = threading.Lock()
            self._b = threading.Lock()

        def one(self):
            with self._a:
                with self._b:
                    pass

        def two(self):
            with self._a:
                self.helper()

        def helper(self):
            with self._b:
                pass
"""
_REENTRY = """
    import threading

    class Bad:
        def __init__(self):
            self._l = threading.Lock()

        def outer(self):
            with self._l:
                self.inner()

        def inner(self):
            with self._l:
                pass

    class Ok:
        def __init__(self):
            self._l = threading.RLock()

        def outer(self):
            with self._l:
                self.inner()

        def inner(self):
            with self._l:
                pass
"""
_WAITS = """
    import threading

    class W:
        def __init__(self):
            self._cond = threading.Condition()
            self._ev = threading.Event()

        def ok(self):
            with self._cond:
                self._cond.wait()

        def bad(self):
            with self._cond:
                self._ev.wait()
"""
_ESCAPE = """
    import threading

    class Worker:
        def __init__(self):
            self._lock = threading.Lock()
            self.x = 0
            self._t = threading.Thread(target=self._run)

        def _run(self):
            self.x = self.x + 1

        def bump(self):
            self.x = 2

    class Guarded:
        def __init__(self):
            self._lock = threading.Lock()
            self.y = 0
            self._t = threading.Thread(target=self._run)

        def _run(self):
            with self._lock:
                self.y = self.y + 1

        def bump(self):
            with self._lock:
                self.y = 2
"""
_BARE_VS_ATOMIC = """
    import json

    def bare_write(d):
        p = d + "/lease.json"
        with open(p, "w") as f:
            f.write("{}")

    def good_write(d, doc):
        from .integrity import atomic_write_text
        atomic_write_text(d + "/lease.json", json.dumps(doc))
"""
_ROGUE = """
    import json

    def rogue(d, doc):
        from .integrity import atomic_write_text
        atomic_write_text(d + "/lease.json", json.dumps(doc))
"""
_LOST_ATOMICITY = """
    def writes(d):
        with open(d + "/lease.json", "w") as f:
            f.write("{}")
"""
_READS = """
    import json
    import os

    def bare_read(d):
        with open(os.path.join(d, "lease.json")) as f:
            return json.load(f)

    def good_read(d):
        try:
            with open(os.path.join(d, "lease.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None
"""
_BRITTLE = """
    import json

    def brittle(path):
        with open(path) as f:
            return json.load(f)
"""
_UNRELATED = """
    def unrelated():
        return 1
"""
_TAGGING = """
    import json

    def lease_path(d, w):
        return d + "/" + w + ".json"

    class Ledger:
        def __init__(self, path):
            self.path = path

        def rewrite(self):
            with open(self.path, "w") as f:
                f.write("{}")

    def write_via_helper(d, w):
        p = lease_path(d, w)
        with open(p, "w") as f:
            f.write("{}")
"""
_DURABLE = """
    import json
    import os

    class Led:
        def __init__(self, path):
            self.path = path

        def append(self, rec):
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + chr(10))
                f.flush()

    class DurableLed:
        def __init__(self, path):
            self.path = path

        def append(self, rec):
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + chr(10))
                f.flush()
                os.fsync(f.fileno())
"""
_SCHEMA = """
    import json

    def write_lease(path, worker):
        from .integrity import atomic_write_text
        doc = {"worker": worker, "ts": 1.0}
        atomic_write_text(path, json.dumps(doc))

    def beat(**fields):
        return fields

    def caller():
        beat(queue_depth=3, force=True)

    def read_lease(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def consume(path):
        lease = read_lease(path)
        if lease is None:
            return None
        return (
            lease["queue_depth"],
            lease.get("worker"),
            lease.get("optional", 0.0),
        )
"""
_BARE_WRITE = """
    def bare_write(d):
        p = d + "/lease.json"
        with open(p, "w") as f:{pragma}
            f.write("{{}}")
"""


def _schema_sites(m, rel, **pair_kw):
    kw = dict(
        name="lease",
        writers=((rel, "write_lease"),),
        readers=((rel, "consume"),),
        reader_seed_calls=("read_lease",),
    )
    kw.update(pair_kw)
    return _sites(
        m,
        writers=(m.WriterSite(rel, "write_lease"),),
        readers=(m.ReaderSite(rel, "read_lease"),),
        schema_pairs=(m.SchemaPair(**kw),),
    )


_LEASE = frozenset({"lease.json"})
# each case: (source, registry built from a protocol_sites module and the
# planted module's repo-relative path, the rules the JAX test expects)
CASES = {
    "stc300_cycle_and_blocking_call_under_lock": (
        _CYCLE, lambda m, rel: _sites(m, threaded_modules=(rel,)),
        ["STC300", "STC300", "STC300"]),
    "stc300_consistent_order_is_clean": (
        _ORDERED, lambda m, rel: _sites(m, threaded_modules=(rel,)), []),
    "stc300_nonreentrant_self_deadlock_rlock_twin_clean": (
        _REENTRY, lambda m, rel: _sites(m, threaded_modules=(rel,)),
        ["STC300"]),
    "stc300_condition_wait_exempt_event_wait_flagged": (
        _WAITS, lambda m, rel: _sites(m, threaded_modules=(rel,)),
        ["STC300"]),
    "stc301_thread_escape_and_locked_twin": (
        _ESCAPE, lambda m, rel: _sites(m, threaded_modules=(rel,)),
        ["STC301"]),
    "stc301_atomic_snapshot_exemption": (
        _ESCAPE, lambda m, rel: _sites(
            m, threaded_modules=(rel,),
            atomic_snapshots={(rel, "Worker", "x"): "rebind-only fixture"}),
        []),
    "stc301_stale_atomic_snapshot": (
        _ESCAPE, lambda m, rel: _sites(
            m, threaded_modules=(rel,),
            atomic_snapshots={
                (rel, "Worker", "x"): "rebind-only fixture",
                (rel, "Worker", "gone"): "points at nothing",
            }),
        ["STC301"]),
    "stc302_bare_write_vs_registered_atomic_writer": (
        _BARE_VS_ATOMIC, lambda m, rel: _sites(
            m, path_literals=_LEASE,
            writers=(m.WriterSite(rel, "good_write"),)),
        ["STC302"]),
    "stc302_unregistered_atomic_write_text_is_flagged": (
        _ROGUE, lambda m, rel: _sites(m, path_literals=_LEASE), ["STC302"]),
    "stc302_registered_writer_that_lost_atomicity": (
        _LOST_ATOMICITY, lambda m, rel: _sites(
            m, path_literals=_LEASE, writers=(m.WriterSite(rel, "writes"),)),
        ["STC302"]),
    "stc303_bare_read_vs_registered_tolerant_reader": (
        _READS, lambda m, rel: _sites(
            m, path_literals=_LEASE,
            readers=(m.ReaderSite(rel, "good_read"),)),
        ["STC303"]),
    "stc303_registered_reader_without_try_is_flagged": (
        _BRITTLE, lambda m, rel: _sites(
            m, readers=(m.ReaderSite(rel, "brittle"),)), ["STC303"]),
    "stale_registry_entries_are_findings": (
        _UNRELATED, lambda m, rel: _sites(
            m, writers=(m.WriterSite(rel, "gone_writer"),),
            readers=(m.ReaderSite(rel, "gone_reader"),),
            path_attrs=frozenset({(rel, "Gone", "path")})),
        ["STC302", "STC302", "STC303"]),
    "stc302_path_attr_and_helper_tagging": (
        _TAGGING, lambda m, rel: _sites(
            m, path_helpers=frozenset({"lease_path"}),
            path_attrs=frozenset({(rel, "Ledger", "path")})),
        ["STC302", "STC302"]),
    "stc304_durable_append_requires_fsync": (
        _DURABLE, lambda m, rel: _sites(
            m,
            path_attrs=frozenset({
                (rel, "Led", "path"), (rel, "DurableLed", "path")}),
            writers=(
                m.WriterSite(rel, "Led.append", kind="append", durable=True),
                m.WriterSite(rel, "DurableLed.append", kind="append",
                             durable=True),
            )),
        ["STC304"]),
    "stc305_kwarg_funnel_satisfies_reader": (
        _SCHEMA, lambda m, rel: _schema_sites(
            m, rel, field_call_names=("beat",), exclude_fields=("force",)),
        []),
    "stc305_missing_field_is_schema_drift": (
        _SCHEMA, lambda m, rel: _schema_sites(m, rel), ["STC305"]),
    "stc305_unresolvable_pair_is_stale": (
        _UNRELATED, lambda m, rel: _sites(m, schema_pairs=(
            m.SchemaPair(
                name="ghost",
                writers=((rel, "gone_writer"),),
                readers=((rel, "gone_reader"),),
                reader_seed_calls=("read_ghost",),
            ),
        )), ["STC305", "STC305"]),
    "protocol_pragma_waiver": (
        _BARE_WRITE.format(
            pragma="  # stc-lint: disable=STC302 -- fixture stays torn"),
        lambda m, rel: _sites(m, path_literals=_LEASE), ["STC302"]),
    "protocol_pragma_without_reason": (
        _BARE_WRITE.format(pragma="  # stc-lint: disable=STC302"),
        lambda m, rel: _sites(m, path_literals=_LEASE), ["STC302"]),
    "protocol_bare_write_unwaived": (
        _BARE_WRITE.format(pragma=""),
        lambda m, rel: _sites(m, path_literals=_LEASE), ["STC302"]),
}


def _key(f, package):
    path = f.path.replace(package + "/", "")
    return (f.rule, path, f.line, f.message.replace(package + "/", ""),
            f.waived, f.waived_by, f.reason)


def _strip(obj, package):
    if isinstance(obj, str):
        return obj.replace(package + "/", "")
    if isinstance(obj, dict):
        return {k: _strip(v, package) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_strip(v, package) for v in obj]
    return obj


def _run_both(tmp_path, case):
    source, make_sites, _ = CASES[case]
    got = {}
    for name, (package, audit, sites, find) in PACKAGES.items():
        pkg = tmp_path / name / package
        pkg.mkdir(parents=True)
        (pkg / "planted.py").write_text(textwrap.dedent(source))
        rel = f"{package}/planted.py"
        findings, report = audit.run_protocol_audit(
            str(tmp_path / name), make_sites(sites, rel))
        augmented = find.apply_waivers(findings, find.Baseline())
        got[name] = ([_key(f, package) for f in findings],
                     _strip(report, package),
                     [_key(f, package) for f in augmented])
    return got


@pytest.mark.parametrize("case", sorted(CASES))
def test_protocol_fixture_parity(tmp_path, case):
    """Both audits give the same findings (rule, path, line, message,
    waiver), the same report and the same STC000 meta-findings, and the
    rules are the ones the JAX package's test expects."""
    got = _run_both(tmp_path, case)
    assert got["port"] == got["jax"]
    assert sorted(k[0] for k in got["port"][0]) == CASES[case][2]
    assert all(k[1] == "protocol:planted.py" for k in got["port"][0]
               if k[2])
    if case == "protocol_pragma_waiver":
        assert got["port"][0][0][4:] == (True, "pragma",
                                         "fixture stays torn")
    if case == "protocol_pragma_without_reason":
        assert [k[0] for k in got["port"][2] if not k[4]] == ["STC000"]


def _baseline_round_trip(package, find, findings):
    bl = find.Baseline([{
        "rule": "STC302", "path": f"protocol:{package}/planted.py",
        "match": "open(p", "reason": "fixture documents the hazard",
    }])
    out = find.apply_waivers(findings, bl)
    stale = [{"rule": "STC302", "path": f"protocol:{package}/gone.py",
              "match": "open(", "reason": "tier skipped this run"}]
    exempt = find.apply_waivers([], find.Baseline(stale),
                                stale_exempt_prefixes=("protocol:",))
    flagged = find.apply_waivers([], find.Baseline(stale))
    return ([_key(f, package) for f in out], exempt,
            [_key(f, package) for f in flagged])


def test_protocol_baseline_waiver_and_stale_exemption(tmp_path):
    """A ``protocol:`` baseline entry waives the bare write; an entry for
    a tier that did not run is exempt from the stale sweep, and flagged
    stale when it ran: the same in both packages."""
    got = {}
    for name, (package, audit, sites, find) in PACKAGES.items():
        pkg = tmp_path / name / package
        pkg.mkdir(parents=True)
        (pkg / "planted.py").write_text(
            textwrap.dedent(_BARE_WRITE.format(pragma="")))
        findings, _ = audit.run_protocol_audit(
            str(tmp_path / name), _sites(sites, path_literals=_LEASE))
        got[name] = _baseline_round_trip(package, find, findings)
    assert got["port"] == got["jax"]
    waived, exempt, flagged = got["port"]
    assert [k[4:6] for k in waived] == [(True, "baseline")]
    assert exempt == [] and [k[0] for k in flagged] == ["STC000"]


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def test_port_is_protocol_clean():
    """Zero findings against the port's registry: every protocol
    touchpoint of the port's fleet is registered with the right shape, and
    no registry entry is stale."""
    findings, report = taudit.run_protocol_audit(REPO_ROOT)
    assert findings == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule}: {f.message}" for f in findings)
    assert report["sites"] == tsites.SITES.site_count()
    assert report["rules"] == {r: 0 for r in taudit.PROTOCOL_RULES}


def test_port_registry_names_the_port_and_mirrors_jax():
    """Every registry entry names a module of the port; entry for entry
    (writers, readers, path attributes, snapshots, schema pairs) it is the
    JAX package's registry with the package directory renamed."""
    t, j = tsites.SITES, jsites.SITES
    assert all(m.startswith(trules.PACKAGE + "/")
               for m in t.watched_modules())
    for m in t.watched_modules():
        assert os.path.exists(os.path.join(REPO_ROOT, m)), m

    def norm(sites, package):
        return _strip({
            "threaded": list(sites.threaded_modules),
            "literals": sorted(sites.path_literals),
            "constants": sorted(sites.path_constants),
            "helpers": sorted(sites.path_helpers),
            "attrs": sorted(sites.path_attrs),
            "snapshots": sorted(sites.atomic_snapshots),
            "writers": [(w.module, w.qualname, w.kind, w.durable)
                        for w in sites.writers],
            "readers": [(r.module, r.qualname) for r in sites.readers],
            "pairs": [(p.name, p.writers, p.readers, p.reader_seed_calls,
                       p.field_call_names, p.field_dict_kwargs,
                       p.exclude_fields, p.extra_fields)
                      for p in sites.schema_pairs],
        }, package)

    assert norm(t, trules.PACKAGE) == norm(j, jrules.PACKAGE)


def test_port_stc305_covers_lease_and_control_pairs():
    """The supervisor<->front lease contract, the supervisor<->replica
    control contract and the shipper<->collector envelope resolve in the
    port, every required field provably emitted (the JAX package's
    acceptance pins)."""
    _, report = taudit.run_protocol_audit(REPO_ROOT)
    pairs = report["pairs"]
    assert sorted(pairs) == ["control", "lease", "ship_envelope"]
    lease = pairs["lease"]
    assert lease["missing"] == []
    assert set(lease["required"]) >= {
        "done", "generation", "model_path", "model_stamp", "role",
        "state",
    }
    assert set(lease["emitted"]) >= {
        "worker", "ts", "pid", "port", "epoch", "requests",
    }
    control = pairs["control"]
    assert control["missing"] == []
    assert set(control["required"]) == {"id", "stamp"}
    assert set(control["emitted"]) == {"id", "stamp", "swap_to"}
    ship = pairs["ship_envelope"]
    assert ship["missing"] == []
    assert set(ship["required"]) == {
        "events", "sent_ts", "seq", "source_id",
    }
    assert set(ship["emitted"]) >= {
        "events", "replayed", "schema", "sent_ts", "seq", "source_id",
    }


def test_changed_scope_gates_the_protocol_tier():
    """``lint --changed`` runs the protocol tier exactly when a
    registry-watched module changed."""
    watched = f"{trules.PACKAGE}/resilience/supervisor.py"
    assert watched in tsites.SITES.watched_modules()
    _, _, _, _, report = tlint.run_lint(REPO_ROOT, jaxpr=False,
                                        changed=[watched])
    assert report is not None
    assert report["sites"] == tsites.SITES.site_count()
    unwatched = f"{trules.PACKAGE}/streaming.py"
    assert unwatched not in tsites.SITES.watched_modules()
    _, _, _, _, report = tlint.run_lint(REPO_ROOT, jaxpr=False,
                                        changed=[unwatched])
    assert report is None
