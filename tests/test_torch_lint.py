"""The port's ``lint`` layer 1 (``analysis.ast_rules``, ``analysis.findings``
and the verb) held against the JAX package's.

Four groups:

  * parity: every fixture source of the JAX package's ``tests/test_lint.py``
    outside STC005 is written under each package's own directory, in two
    roots, and both checkers must report the same (rule, path below the
    package, line, waiver) findings — the planted lines JAX's tests
    expect, and the registry findings of STC003/STC004's reverse
    direction too (the port's ``faultinject.SITES`` and
    ``telemetry/names.py`` equal the JAX package's, so the fixture trees
    see equal registries); the waiver model (pragmas, baseline, STC000)
    and the JSON report on equal inputs, key for key;
  * STC005 read for torch: planted fixtures whose roots are the callables
    ``telemetry.instrument_dispatch`` wraps (JAX's fixtures root at
    ``jax.jit`` and cannot be parity cases);
  * the port's own tree is clean under its own baseline, every waiver
    with a reason;
  * the verb's exit codes: 0 clean, 1 findings; bare ``lint`` runs layer 2, the trace audit of the registered entry
    points, as the JAX verb's does, and ``--scale`` layer 3, the scale
    audit, against the committed scale record (default, ``--rules``,
    ``--changed``, ``--rebaseline`` into temp paths).
"""

from __future__ import annotations

import json
import os
import textwrap

import pytest

from spark_text_clustering_tpu.analysis import ast_rules as jrules
from spark_text_clustering_tpu.analysis import findings as jfind
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch.analysis import ast_rules as trules
from spark_text_clustering_tpu_torch.analysis import cli as tlint
from spark_text_clustering_tpu_torch.analysis import findings as tfind
from spark_text_clustering_tpu_torch.analysis.entrypoints import (
    entrypoint_names,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jrules.PACKAGE, jrules.run_ast_rules),
            "port": (trules.PACKAGE, trules.run_ast_rules)}


def _plant(root, package, files):
    for rel, src in files.items():
        path = root / package / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def _strip(path, package):
    return path[len(package) + 1:] if path.startswith(package + "/") else path


def _keys(findings, package):
    return sorted((f.rule, _strip(f.path, package), f.line, f.waived,
                   f.waived_by, f.reason) for f in findings)


def _both(tmp_path, files, rules):
    """Each checker's findings on the same sources, planted under its own
    package directory, keyed without the package prefix."""
    out = {}
    for name, (package, run) in PACKAGES.items():
        root = _plant(tmp_path / name, package, files)
        out[name] = _keys(run(root, rules=rules), package)
    return out


# ---------------------------------------------------------------------------
# parity: the JAX package's fixture sources (tests/test_lint.py), each with
# the planted lines its test expects (unwaived findings in the planted file)
# ---------------------------------------------------------------------------
CASES = {
    "stc001_raw_sleep": ({"planted.py": """
        import time
        from time import sleep

        def bad_direct():
            time.sleep(1.0)

        def bad_imported():
            sleep(2.0)

        def ok_injected(sleep_fn):
            sleep_fn(1.0)
    """}, ["STC001"], "planted.py", [6, 9]),
    "stc002_swallowing_vs_rewrapping": ({"planted.py": """
        def bad_bare():
            try:
                work()
            except:
                pass

        def bad_broad():
            try:
                work()
            except Exception:
                return None

        def ok_rewrap():
            try:
                work()
            except Exception as exc:
                raise RuntimeError("typed") from exc

        def ok_uses_exc(q):
            try:
                work()
            except Exception as exc:
                q.put("doc", exc)

        def ok_narrow():
            try:
                work()
            except OSError:
                pass
    """}, ["STC002"], "planted.py", [5, 11]),
    "stc003_unregistered_and_dynamic_sites": ({"planted.py": """
        from .resilience import faultinject

        def bad_typo():
            faultinject.check("ckpt.wrte")

        def bad_dynamic(site):
            faultinject.check(site)

        def ok_registered():
            faultinject.check("ckpt.write")
    """}, ["STC003"], "planted.py", [5, 8]),
    "stc004_metric_name_rules": ({"planted.py": """
        from . import telemetry

        BAD_CONST = "no.such.metric"

        def bad_undeclared():
            telemetry.count("totally.undeclared.name")

        def bad_case():
            telemetry.count("BadCase.Name")

        def bad_const():
            telemetry.count(BAD_CONST)

        def bad_prefix(kind):
            telemetry.count(f"unknown.family.{kind}")

        def bad_opaque(name):
            telemetry.count(name)

        def ok_declared():
            telemetry.count("resilience.retries")

        def ok_prefix(err):
            telemetry.count(f"probe.accelerator.{err}")
    """}, ["STC004"], "planted.py", [7, 10, 13, 16, 19]),
    "stc006_mutable_defaults": ({"planted.py": """
        def bad_list(a=[]):
            return a

        def bad_dict_call(b=dict()):
            return b

        def ok_none(c=None):
            return c or []
    """}, ["STC006"], "planted.py", [2, 5]),
    "stc006_persistence_sort_keys": ({"models/persistence.py": """
        import json

        def bad(meta, f):
            json.dump(meta, f, indent=2)

        def ok(meta, f):
            json.dump(meta, f, indent=2, sort_keys=True)
    """}, ["STC006"], "models/persistence.py", [5]),
    "stc007_planted_race": ({"serving/coalescer.py": """
        import threading

        class Worker:
            def __init__(self):
                self._lock = threading.Lock()
                self._queue = []
                self._count = 0        # init runs before threads: exempt

            def put(self, item):
                with self._lock:
                    self._queue.append(item)
                    self._count = self._count + 1

            def bad_read(self):
                return len(self._queue)

            def bad_write(self):
                self._count = 0

            def ok_locked_read(self):
                with self._lock:
                    return self._count

            def ok_unrelated(self):
                return 42

        class Unthreaded:
            def __init__(self):
                self.x = 0

            def bump(self):
                self.x += 1
    """}, ["STC007"], "serving/coalescer.py", [16, 19]),
    "stc007_outside_the_threaded_set": ({"planted.py": """
        import threading

        class Elsewhere:
            def __init__(self):
                self._lock = threading.Lock()
                self._n = 0

            def locked(self):
                with self._lock:
                    self._n = 1

            def unlocked(self):
                return self._n
    """}, ["STC007"], "planted.py", []),
    "stc101_unused_imports_and_noqa": ({"planted.py": """
        import os
        import sys  # noqa: F401  (kept for side effects)
        from typing import List, Optional

        def use():
            return os.getcwd(), List
    """}, ["STC101"], "planted.py", [4]),
    "stc102_fstring_logging": ({"planted.py": """
        import logging

        logger = logging.getLogger(__name__)

        def bad(x):
            logger.info(f"value {x}")

        def ok(x):
            logger.info("value %s", x)
    """}, ["STC102"], "planted.py", [7]),
    "pragma_with_reason": ({"planted.py": """
        import time

        def guarded():
            time.sleep(1.0)  # stc-lint: disable=STC001 -- test drives a real clock here
    """}, ["STC001"], "planted.py", []),
    "pragma_without_reason": ({"planted.py": """
        import time

        def guarded():
            time.sleep(1.0)  # stc-lint: disable=STC001
    """}, ["STC001"], "planted.py", []),
    "pragma_for_other_rule": ({"planted.py": """
        import time

        def guarded():
            time.sleep(1.0)  # stc-lint: disable=STC999 -- wrong rule
    """}, ["STC001"], "planted.py", [5]),
    "every_rule_on_one_tree": ({
        "planted.py": """
            import os
            import time
            import logging
            from .resilience import faultinject
            from . import telemetry

            def f(a=[]):
                time.sleep(1)
                try:
                    faultinject.check("ckpt.wrte")
                except Exception:
                    pass
                telemetry.count("BadCase.Name")
                logging.info(f"{a}")
        """,
        "serving/server.py": """
            import threading

            class S:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.n = 0

                def w(self):
                    with self._lock:
                        self.n = 1

                def r(self):
                    return self.n
        """,
    }, None, "planted.py", [2, 8, 9, 11, 12, 14, 15]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fixture_parity(tmp_path, case):
    """Both checkers give the same findings on the JAX package's fixture
    sources (registry findings included), and the planted lines are the
    ones the JAX package's tests expect."""
    files, rules, planted, want_lines = CASES[case]
    got = _both(tmp_path, files, rules)
    assert got["port"] == got["jax"]
    lines = sorted(line for rule, path, line, waived, *_ in got["port"]
                   if path == planted and not waived)
    assert lines == want_lines, got["port"]


@pytest.mark.parametrize("case", ["pragma_with_reason",
                                  "pragma_without_reason",
                                  "stc101_unused_imports_and_noqa"])
def test_pragma_waivers_and_stc000_parity(tmp_path, case):
    """Pragma waivers, the noqa import waiver and the STC000 a reasonless
    pragma turns into, through each package's ``apply_waivers``."""
    files, rules, _, _ = CASES[case]
    got = {}
    for name, (package, run) in PACKAGES.items():
        find = jfind if name == "jax" else tfind
        root = _plant(tmp_path / name, package, files)
        got[name] = _keys(find.apply_waivers(run(root, rules=rules),
                                             find.Baseline()), package)
    assert got["port"] == got["jax"]
    if case == "pragma_without_reason":
        assert [k[0] for k in got["port"] if not k[3]] == ["STC000"]
    else:
        assert all(k[0] != "STC000" for k in got["port"])


def _baseline_cases(find):
    """The JAX package's baseline round trips, on one findings module."""
    f1 = find.Finding("STC001", "pkg/a.py", 10, "m", snippet="time.sleep(1)")
    f2 = find.Finding("STC001", "pkg/b.py", 20, "m", snippet="time.sleep(2)")
    round_trip = find.apply_waivers([f1, f2], find.Baseline([
        {"rule": "STC001", "path": "pkg/a.py", "match": "time.sleep",
         "reason": "legacy poll loop"},
        {"rule": "STC002", "path": "pkg/gone.py", "match": "except",
         "reason": "file was deleted"},
    ]))
    g = find.Finding("STC001", "pkg/a.py", 10, "m", snippet="time.sleep(1)")
    reasonless = find.apply_waivers([g], find.Baseline([
        {"rule": "STC001", "path": "pkg/a.py", "match": "time.sleep",
         "reason": ""},
    ]))
    h1 = find.Finding("STC002", "pkg/a.py", 10, "m",
                      snippet="except Exception:")
    h2 = find.Finding("STC002", "pkg/a.py", 30, "m",
                      snippet="except Exception:")
    repeated = find.apply_waivers([h1, h2], find.Baseline([
        {"rule": "STC002", "path": "pkg/a.py", "match": "except Exception",
         "reason": "both guards are best-effort"},
    ]))
    exempt = find.apply_waivers([], find.Baseline([
        {"rule": "STC302", "path": "protocol:pkg/gone.py", "match": "open(",
         "reason": "tier skipped this run"},
    ]), stale_exempt_prefixes=("protocol:",))
    partial = find.apply_waivers([], find.Baseline([
        {"rule": "STC001", "path": "pkg/x.py", "match": "", "reason": "r"},
    ]), check_stale=False)
    return {name: [f.to_dict() for f in out] for name, out in (
        ("round_trip", round_trip), ("reasonless", reasonless),
        ("repeated", repeated), ("exempt", exempt), ("partial", partial))}


def test_baseline_round_trips_parity():
    """Baseline matches, reasonless and stale entries (STC000), one entry
    over a repeated pattern, and the stale-sweep exemptions: the same
    augmented findings from both ``apply_waivers``."""
    want = _baseline_cases(jfind)
    got = _baseline_cases(tfind)
    assert got == want
    assert [d["rule"] for d in got["round_trip"]] == [
        "STC001", "STC001", "STC000"]
    assert "stale" in got["round_trip"][-1]["message"]
    assert [d["rule"] for d in got["reasonless"]] == ["STC001", "STC000"]
    assert got["repeated"][0]["waived"] and got["repeated"][1]["waived"]
    assert got["exempt"] == [] and got["partial"] == []


@pytest.mark.parametrize("line", [
    "x()  # stc-lint: disable=STC001 -- why",
    "x()  # stc-lint: disable=STC001,STC004 (r)",
    "x()  # stc-lint: disable=STC002",
    "x()  # a normal comment",
])
def test_pragma_grammar_parity(line):
    assert tfind.pragma_disables(line) == jfind.pragma_disables(line)


def test_baseline_save_load_parity(tmp_path):
    """The baseline file's bytes (``version``, ``waivers``: rule, path,
    match, reason) are the JAX package's."""
    waivers = [{"rule": "STC002", "path": "p/a.py", "match": "except",
                "reason": "guard"}]
    jfind.Baseline(waivers).save(str(tmp_path / "j.json"))
    tfind.Baseline(waivers).save(str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()
    assert tfind.Baseline.load(str(tmp_path / "t.json")).waivers == waivers


@pytest.mark.parametrize("render", ["render_json", "render_text"])
def test_report_parity(tmp_path, render):
    """``render_json`` (key for key) and ``render_text`` on each checker's
    findings of one fixture, a pragma-waived finding among them, with a
    protocol report, are the same once the package prefix is dropped."""
    files = {"planted.py": """
        import time

        def bad():
            time.sleep(1.0)

        def guarded():
            time.sleep(1.0)  # stc-lint: disable=STC001 -- real clock
    """}
    proto = {"sites": 3, "modules": 2, "lock_edges": 1,
             "pairs": {"lease": {"required": ["a"], "emitted": ["a", "b"]}}}
    got = {}
    for name, (package, run) in PACKAGES.items():
        find = jfind if name == "jax" else tfind
        root = _plant(tmp_path / name, package, files)
        text = getattr(find, render)(run(root, rules=["STC001"]), ["a.b"],
                                     None, proto)
        got[name] = text.replace(package + "/", "")
    assert got["port"] == got["jax"]
    if render == "render_json":
        doc = json.loads(got["port"])
        assert doc["counts"] == {"findings": 1, "waived": 1}
        assert doc["entrypoints_audited"] == ["a.b"]
        assert doc["findings"][0]["rule"] == "STC001"
        assert doc["findings"][0]["line"] == 5


def test_package_is_a_parameter(tmp_path):
    """The port's checker, pointed at the JAX package's directory name,
    reports exactly what the JAX checker reports on the same root."""
    files, _, _, _ = CASES["every_rule_on_one_tree"]
    root = _plant(tmp_path, jrules.PACKAGE, files)
    want = _keys(jrules.run_ast_rules(root), jrules.PACKAGE)
    got = _keys(trules.run_ast_rules(root, package=jrules.PACKAGE),
                jrules.PACKAGE)
    assert got == want


# ---------------------------------------------------------------------------
# STC005, read for torch: roots are the callables instrument_dispatch wraps
# ---------------------------------------------------------------------------
_STC005_FILES = {
    "planted.py": """
        import functools

        import numpy as np
        import torch

        from . import helpers
        from . import telemetry
        from .helpers import pull_imported

        def _pull(y):
            return y.item()

        def step(x):
            return _pull(x) + helpers.pull(x) + pull_imported(x)

        run = telemetry.instrument_dispatch("fixture.step", step)

        def outside(y):
            return y.item()

        def synced(x):
            telemetry.device_sync(x, "fixture")
            return x

        synced_run = telemetry.instrument_dispatch("fixture.synced", synced)

        def via_lambda(a, b):
            return a.detach().cpu()

        lam_run = telemetry.instrument_dispatch(
            "fixture.lambda", lambda a, b: via_lambda(a, b))

        def scalar(n, x):
            torch.cuda.synchronize()
            return float(x) + int(n)

        part_run = telemetry.instrument_dispatch(
            "fixture.partial", functools.partial(scalar, 2))

        def host(x):
            return np.asarray(x)

        chained = host
        chain_run = telemetry.instrument_dispatch("fixture.chain", chained)

        def given(lam, work):
            return work(lam).tolist()

        given_run = telemetry.instrument_dispatch(
            "fixture.given", lambda lam, work: work(lam))
    """,
    "helpers.py": """
        def pull(y):
            return y.tolist()

        def pull_imported(y):
            return y.numpy()

        def unreached(y):
            return y.item()
    """,
    "telemetry.py": """
        import torch

        def instrument_dispatch(label, fn):
            return fn

        def device_sync(x, label):
            torch.cuda.synchronize()
            return x
    """,
}
# (file, line) of each planted sync the rule must flag
_STC005_WANT = [
    ("helpers.py", 3),            # module alias: helpers.pull
    ("helpers.py", 6),            # imported name: pull_imported
    ("planted.py", 12),           # helper of the wrapped step: .item()
    ("planted.py", 29),           # through a lambda's call: .cpu()
    ("planted.py", 35),           # partial(...): torch.cuda.synchronize()
    ("planted.py", 36),           # partial(...): float() of an argument
    ("planted.py", 36),           # partial(...): int() of an argument
    ("planted.py", 42),           # assignment chain: np.asarray
]


def test_stc005_roots_at_instrumented_dispatches(tmp_path):
    """The rule flags what the fixture plants below a wrapped callable
    (through a helper, a module alias, an imported name, a lambda's call,
    ``partial`` and an assignment chain), and passes the same call outside
    any instrumented function, a helper nothing reaches, a callable passed
    in at call time, and ``telemetry.device_sync`` (the sanctioned sync,
    neither flagged nor entered)."""
    root = _plant(tmp_path, trules.PACKAGE, _STC005_FILES)
    findings = trules.run_ast_rules(root, rules=["STC005"])
    got = sorted((_strip(f.path, trules.PACKAGE), f.line) for f in findings)
    assert got == _STC005_WANT, [(f.path, f.line, f.message)
                                 for f in findings]
    assert all("instrumented dispatch" in f.message for f in findings)


def test_stc005_without_a_wrapper_flags_nothing(tmp_path):
    """The same sources with the wrapping calls taken out: nothing is a
    root, so nothing is flagged (JAX's jit roots mean nothing here)."""
    files = dict(_STC005_FILES)
    files["planted.py"] = files["planted.py"].replace(
        "telemetry.instrument_dispatch", "dict")
    files["jitted.py"] = """
        import jax

        @jax.jit
        def step(x):
            return x.item()
    """
    root = _plant(tmp_path, trules.PACKAGE, files)
    assert trules.run_ast_rules(root, rules=["STC005"]) == []


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def test_port_tree_is_ast_lint_clean():
    """The port's package carries zero unwaived AST-layer findings under
    its own baseline, and every waiver (pragma or baseline) has a reason;
    the protocol tier's waivers are exempt here, as in the JAX package's
    test."""
    findings = trules.run_ast_rules(REPO_ROOT)
    baseline = tfind.Baseline.load(
        os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH))
    out = tfind.apply_waivers(
        findings, baseline,
        stale_exempt_prefixes=("jaxpr:", "scale:", "protocol:"))
    unwaived = [f for f in out if not f.waived]
    assert unwaived == [], "\n".join(
        f"{f.path}:{f.line}: {f.rule}: {f.message}" for f in unwaived)
    assert all(f.reason for f in out if f.waived)
    assert all(f.path.startswith(trules.PACKAGE + "/") for f in out)


def test_committed_port_baseline_reasons_nonempty():
    """The port's own baseline file (the JAX package's record,
    scripts/records/lint_baseline.json, is not the port's)."""
    path = os.path.join(REPO_ROOT, tfind.DEFAULT_BASELINE_PATH)
    assert path.endswith(os.path.join(
        "spark_text_clustering_tpu_torch", "analysis", "lint_baseline.json"))
    with open(path) as f:
        data = json.load(f)
    assert data["version"] == 1 and data["waivers"]
    for w in data["waivers"]:
        assert set(w) == {"rule", "path", "match", "reason"}, w
        assert w["reason"].strip(), w
        assert w["path"].startswith(
            ("spark_text_clustering_tpu_torch/", "jaxpr:")), w


def test_changed_scope_skips_stale_sweep_and_filters_paths():
    """``lint --changed`` semantics, as in the JAX package: findings
    scoped to the changed set, no stale-waiver meta-findings, the trace
    layers not refused where no traced surface changed, and the protocol
    tier run because cli.py holds the control-file reader."""
    findings, audited, _, scale_report, protocol_report = tlint.run_lint(
        REPO_ROOT, scale=True,
        changed=["spark_text_clustering_tpu_torch/cli.py"])
    assert audited == [] and scale_report is None
    assert protocol_report is not None
    assert all(f.path == "spark_text_clustering_tpu_torch/cli.py"
               for f in findings), [f.path for f in findings]
    assert not [f for f in findings if f.rule == "STC000"]
    assert not [f for f in findings if not f.waived]


@pytest.mark.parametrize("changed", [
    "spark_text_clustering_tpu_torch/ops/estep.py",
    "spark_text_clustering_tpu_torch/csrc/estep.cu",
])
def test_changed_traced_surface_refuses_the_trace_layers(changed):
    """A diff that touches a traced surface runs the trace layers, as in
    the JAX package: layer 2 (every registered entry, each finding
    waived) and, asked for, layer 3 (every entry at scale, against the
    committed record); the name is the one this test had while the port
    refused layer 3."""
    findings, audited, _, scale_report, _ = tlint.run_lint(
        REPO_ROOT, scale=True, changed=[changed])
    assert audited == entrypoint_names()
    assert sorted(scale_report["entries"]) == sorted(entrypoint_names())
    assert not [f for f in findings if not f.waived]
    assert not [f for f in findings if f.rule == "STC000"]


# ---------------------------------------------------------------------------
# the verb's exit codes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv,planted,rc", [
    (["--no-jaxpr", "--rules", "STC001"], False, 0),
    (["--no-jaxpr", "--rules", "STC001"], True, 1),
    (["--no-jaxpr", "--rules", "STC001", "--format", "json"], True, 1),
    (["--no-jaxpr", "--rules", "STC001", "--protocol"], False, 0),
    ([], None, 0),
    (["--rules", "STC001"], False, 0),
    (["--no-jaxpr", "--scale"], None, 0),
    (["--no-jaxpr", "--scale", "--scale-baseline", "x.json"], None, 1),
    (["--rules", "STC001"], True, 1),
    (["--rules", "STC201"], True, 0),
    (["--rules", "STC201", "--format", "json"], False, 0),
    (["--scale", "--rules", "STC210", "--format", "json"], False, 1),
])
def test_lint_exit_codes(tmp_path, monkeypatch, capsys, argv, planted, rc):
    """0 clean, 1 for an unwaived finding.  Bare ``lint`` runs layer 2
    over the port's registry, as the JAX verb does:
    over the port's own tree (``planted=None``) it is clean under the
    port's baseline; over a planted tree a rule filter keeps layer 2
    running and its findings out.  ``--scale`` adds layer 3: clean over
    the port's tree and its committed record, one STC210 where the
    record is missing (a named one that does not exist, or a planted
    tree's)."""
    if planted is not None:
        src = ("import time\n\ndef f():\n    time.sleep(1)\n" if planted
               else "def f():\n    return 1\n")
        root = _plant(tmp_path, trules.PACKAGE, {"planted.py": src})
        monkeypatch.setattr(tlint, "_repo_root", lambda: root)
    assert tcli.main(["lint", *argv]) == rc
    out = capsys.readouterr()
    if "json" in argv:
        doc = json.loads(out.out)
        assert doc["counts"]["findings"] == rc
        if "--no-jaxpr" not in argv:
            assert doc["entrypoints_audited"] == entrypoint_names()
        if "--scale" in argv:
            assert sorted(doc["scale"]["entries"]) == sorted(
                entrypoint_names())
            assert [f["path"] for f in doc["findings"]] == [
                "scale:baseline"]
        elif rc:
            assert doc["findings"][0]["path"] == (
                f"{trules.PACKAGE}/planted.py")
    else:
        assert "stc lint: %d finding(s)" % rc in out.out


def test_lint_telemetry_stream_parity(tmp_path, monkeypatch):
    """``--telemetry-file`` writes the JAX verb's run stream: a manifest of
    kind "lint", the ``lint_run`` event and the lint counters in the final
    registry snapshot, with the same values on the same planted source."""
    from spark_text_clustering_tpu import cli as jcli
    from spark_text_clustering_tpu.analysis import cli as jlint

    src = "import time\n\ndef f():\n    time.sleep(1)\n"
    got = {}
    for name, main, mod in (("jax", jcli.main, jlint),
                            ("port", tcli.main, tlint)):
        package = PACKAGES[name][0]
        root = _plant(tmp_path / name, package, {"planted.py": src})
        monkeypatch.setattr(mod, "_repo_root", lambda root=root: root)
        stream = tmp_path / f"{name}.jsonl"
        assert main(["lint", "--no-jaxpr", "--rules", "STC001",
                     "--telemetry-file", str(stream)]) == 1
        recs = [json.loads(line)
                for line in stream.read_text().splitlines() if line]
        got[name] = (
            [r["event"] for r in recs],
            recs[0].get("kind"),
            {k: v for k, v in recs[1].items() if k != "ts"},
            recs[-1]["snapshot"]["counters"],
        )
    assert got["port"] == got["jax"]
    assert got["port"][0] == ["manifest", "lint_run", "registry"]
    assert got["port"][3] == {"lint.findings": 1, "lint.waived": 0}


def test_lint_json_report_keys_parity(tmp_path, monkeypatch, capsys):
    """``lint --format json`` of both verbs on one planted tree has the
    same top-level keys; the port's default run (layer 2 on) lists its
    audited entries and writes them into the ``lint_run`` event.  (The
    JAX verb's layer 2 does not run in this sandbox: its side runs with
    ``--no-jaxpr``.)"""
    from spark_text_clustering_tpu import cli as jcli
    from spark_text_clustering_tpu.analysis import cli as jlint

    src = "import time\n\ndef f():\n    time.sleep(1)\n"
    docs = {}
    for name, main, mod, extra in (
            ("jax", jcli.main, jlint, ["--no-jaxpr"]),
            ("port", tcli.main, tlint, [])):
        root = _plant(tmp_path / name, PACKAGES[name][0],
                      {"planted.py": src})
        monkeypatch.setattr(mod, "_repo_root", lambda root=root: root)
        stream = tmp_path / f"{name}.jsonl"
        assert main(["lint", *extra, "--rules", "STC001", "--format",
                     "json", "--telemetry-file", str(stream)]) == 1
        docs[name] = json.loads(capsys.readouterr().out)
        recs = [json.loads(line)
                for line in stream.read_text().splitlines() if line]
        docs[name]["_event"] = recs[1]
    assert sorted(docs["port"]) == sorted(docs["jax"])
    assert docs["port"]["entrypoints_audited"] == entrypoint_names()
    assert docs["port"]["_event"]["entrypoints"] == len(entrypoint_names())
    assert docs["jax"]["entrypoints_audited"] == []


# ---------------------------------------------------------------------------
# layer 3 through the verb
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rules", [None, ["STC212"]])
def test_lint_scale_layer_runs_clean(rules):
    """``lint --scale`` over the port's tree: every registered entry at
    scale, no unwaived or stale finding against the committed record;
    ``--rules STC212`` keeps only that rule's findings (none) and the
    report whole."""
    findings, audited, _, report, _ = tlint.run_lint(
        REPO_ROOT, jaxpr=False, scale=True, rules=rules)
    assert audited == []
    assert sorted(report["entries"]) == sorted(entrypoint_names())
    assert report["backend"] == "nvidia-h100"
    scale = [f for f in findings if f.path.startswith("scale:")]
    assert not [f for f in scale if not f.waived], [
        (f.path, f.rule, f.message) for f in scale if not f.waived]
    if rules:
        # the rule filter leaves the other waivers matching nothing
        assert {f.rule for f in findings} <= {"STC212", "STC000"}
    else:
        assert not [f for f in findings if not f.waived]


def test_lint_scale_rebaseline_writes_the_record(tmp_path, capsys):
    """``lint --scale --rebaseline`` with temp paths writes both files: the
    waiver baseline (no waiver for the record's drift, which the rewrite
    resolves) and the scale record, equal to the committed record entry
    for entry, the measured section kept; the next run is clean, its
    counters in the ``lint_run`` event and the registry."""
    from spark_text_clustering_tpu_torch.analysis import scale_audit

    bl = tmp_path / "lint_baseline.json"
    bl.write_text(open(os.path.join(
        REPO_ROOT, tfind.DEFAULT_BASELINE_PATH)).read())
    rec = tmp_path / "scale.json"
    rec.write_text(json.dumps({"entries": {}, "measured": {"m": 1}}))
    assert tcli.main(["lint", "--no-jaxpr", "--scale", "--rebaseline",
                      "--baseline", str(bl), "--scale-baseline",
                      str(rec)]) == 0
    assert "scale record rewritten" in capsys.readouterr().out
    fresh = scale_audit.load_scale_record(str(rec))
    committed = scale_audit.load_scale_record(os.path.join(
        REPO_ROOT, scale_audit.DEFAULT_SCALE_BASELINE_PATH))
    assert fresh["measured"] == {"m": 1}
    assert fresh["entries"] == committed["entries"]
    stream = tmp_path / "lint.jsonl"
    assert tcli.main(["lint", "--no-jaxpr", "--scale", "--baseline",
                      str(bl), "--scale-baseline", str(rec),
                      "--telemetry-file", str(stream)]) == 0
    recs = [json.loads(line)
            for line in stream.read_text().splitlines() if line]
    assert recs[1]["scale_entries"] == len(entrypoint_names())
    counters = recs[-1]["snapshot"]["counters"]
    assert counters["lint.scale_entries"] == len(entrypoint_names())
    assert counters["lint.scale_findings"] == 0
