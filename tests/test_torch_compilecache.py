"""The port's compile cache (spark_text_clustering_tpu_torch.compilecache)
against the JAX package's executable store, on the CPU.

The port's one compile is ``ops._build``'s nvcc run, and the store keeps
the libraries it makes.  Here a fake ``nvcc`` stands in for the CUDA
toolkit: it answers ``--version`` and turns ``csrc/<name>.cu`` into a stub
library with g++ that exports ``_build.SIGNATURES``' symbols, and it logs
every call, so a test can tell a load from the store from a compile.

* maintenance parity: the same store trees through JAX's
  ``ExecutableStore`` and the port's, and through both CLIs' ``ls
  --json``, ``verify`` and ``gc`` (the ``stale`` mark aside: it compares
  each package's own live fingerprint);
* misses, never crashes: a torn stage, a missing COMMIT, a corrupt or
  truncated payload, mismatched metadata, a stale fingerprint and both
  fault sites, each a counted miss (quarantined where JAX quarantines);
  a write race leaves one entry;
* a second process loads every library from the store and makes no
  compile call;
* the dispatch layer's ``cache_status`` and the serve warmup's report
  keys, armed and unarmed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import compilecache as jcompilecache
from spark_text_clustering_tpu import telemetry as jtelemetry
from spark_text_clustering_tpu.compilecache import store as jstore
from spark_text_clustering_tpu.telemetry import dispatch as jdispatch
from spark_text_clustering_tpu_torch import cli as tcli
from spark_text_clustering_tpu_torch import compilecache, telemetry
from spark_text_clustering_tpu_torch.compilecache import store as tstore
from spark_text_clustering_tpu_torch.ops import _build
from spark_text_clustering_tpu_torch.resilience import faultinject
from spark_text_clustering_tpu_torch.resilience.integrity import (
    COMMIT_NAME,
    finalize_artifact_dir,
)
from spark_text_clustering_tpu_torch.telemetry import dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the fake nvcc builds stubs with g++")

FAKE_NVCC = '''#!{python}
import json, os, subprocess, sys
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
if "--version" in sys.argv:
    print("nvcc: NVIDIA (R) Cuda compiler")
    print("Cuda compilation tools, release 12.4, V12.4.131")
    sys.exit(0)
out = sys.argv[sys.argv.index("-o") + 1]
name = os.path.basename(sys.argv[-1])[:-3]
symbols = json.loads(os.environ["FAKE_NVCC_SYMBOLS"])[name]
src = out + ".cpp"
with open(src, "w") as f:
    for s in symbols:
        f.write('extern "C" int %s() {{ return %d; }}\\n' % (s, len(name)))
rc = subprocess.call(["g++", "-shared", "-fPIC", "-o", out, src])
os.unlink(src)
sys.exit(rc)
'''


def _fake_env(tmp_path) -> dict:
    """PATH led by a fake nvcc, its log and the stubs' symbols."""
    bin_dir = tmp_path / "fakebin"
    bin_dir.mkdir(exist_ok=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = {
        "PATH": f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}",
        "CUDA_HOME": str(tmp_path / "no-cuda"),
        "FAKE_NVCC_LOG": str(tmp_path / "nvcc.log"),
        "FAKE_NVCC_SYMBOLS": json.dumps(
            {n: sorted(sig) for n, sig in _build.SIGNATURES.items()}),
    }
    return env


def _nvcc_calls(tmp_path):
    log = tmp_path / "nvcc.log"
    if not log.exists():
        return []
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def _compiles(tmp_path):
    return [c for c in _nvcc_calls(tmp_path) if "--version" not in c]


def _disarm():
    """Both packages' caches disarmed (the JAX CLI's verb arms the JAX
    package's store, whose dispatch layer records while it is armed),
    their telemetry shut down and reset, the port's fault plan reset."""
    for tel, disp, cc in ((telemetry, dispatch, compilecache),
                          (jtelemetry, jdispatch, jcompilecache)):
        tel.shutdown()
        tel.get_registry().reset()
        disp.reset()
        cc.reset()
    faultinject.reset()


@pytest.fixture(autouse=True)
def _reset(monkeypatch):
    monkeypatch.setenv(compilecache.ENV_DIR, "unset")
    monkeypatch.delenv(compilecache.ENV_DIR)
    _disarm()
    yield
    _disarm()


@pytest.fixture
def toolchain(tmp_path, monkeypatch):
    """This process's ``_build`` on the fake nvcc and an empty build
    directory, with no library loaded."""
    for k, v in _fake_env(tmp_path).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_LIB_PATHS", {})
    monkeypatch.setattr(_build, "_RELEASES", {})
    return tmp_path


@pytest.fixture
def cache_dir(tmp_path):
    root = str(tmp_path / "compile_cache")
    compilecache.configure(root)
    return root


def _counters():
    snap = telemetry.get_registry().snapshot()
    return {
        k.replace("compile.cache_", ""): int(v)
        for k, v in snap["counters"].items()
        if k.startswith("compile.cache_")
    }


def _fresh_process_sim():
    """A respawned process: no library loaded, a new registry and store
    object; only the files on disk survive."""
    root = compilecache.get_store().root
    _build._LIBS.clear()
    _build._LIB_PATHS.clear()
    dispatch.reset()
    telemetry.get_registry().reset()
    compilecache.reset()
    compilecache.configure(root)


def _entry(name="estep"):
    """The committed store entry of library ``name``."""
    sig = _build._digest()
    return compilecache.get_store().entry_dir(_build.entry_digest(name, sig))


# -- a round trip ------------------------------------------------------------
@needs_gxx
def test_miss_publishes_then_a_fresh_load_hits(toolchain, cache_dir):
    lib = _build.load_library("estep")
    assert lib.stc_estep_max_k() == len("estep")
    assert _counters() == {"misses": 1, "stores": 1}
    assert len(_compiles(toolchain)) == 1
    entry = _entry()
    assert sorted(os.listdir(entry)) == sorted(
        ["entry.json", "estep.so", "MANIFEST.json", COMMIT_NAME])
    meta = json.load(open(os.path.join(entry, "entry.json")))
    assert meta["label"] == "estep"
    assert meta["signature"] == _build._digest()
    assert meta["fingerprint"] == _build.toolchain_fingerprint()
    assert meta["fingerprint"].startswith("nvcc12.4-sm_90a-")
    assert meta["compile_seconds"] > 0
    _fresh_process_sim()
    shutil.rmtree(_build.BUILD_DIR)
    lib = _build.load_library("estep")
    assert lib.stc_estep_max_k() == len("estep")
    assert _counters() == {"hits": 1}
    assert len(_compiles(toolchain)) == 1          # nothing built again
    assert _build._LIB_PATHS["estep"] == Path(entry) / "estep.so"
    assert _build.library_bytes("gamma_fixed_point_bkl") == os.path.getsize(
        os.path.join(entry, "estep.so"))


@needs_gxx
def test_a_miss_takes_the_build_directorys_library(toolchain, cache_dir):
    """Unarmed the library builds; armed afterwards, the miss publishes the
    build directory's library without compiling it again."""
    compilecache.configure(None)
    _build.load_library("nmf")
    assert _counters() == {} and len(_compiles(toolchain)) == 1
    _build._LIBS.clear()
    compilecache.configure(cache_dir)
    _build.load_library("nmf")
    assert _counters() == {"misses": 1, "stores": 1}
    assert len(_compiles(toolchain)) == 1
    meta = json.load(open(os.path.join(_entry("nmf"), "entry.json")))
    assert meta["compile_seconds"] is None


def test_unarmed_load_is_the_old_path(tmp_path, monkeypatch):
    """Without the cache a load never asks the store: no nvcc, no store,
    the build's own error."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    compilecache.configure(None)
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.load_library("estep")
    assert _counters() == {} and not dispatch.cache_armed()


def test_armed_without_nvcc_is_a_miss_then_the_build_error(
        tmp_path, monkeypatch, cache_dir):
    """The store's read never crashes: without nvcc it has no fingerprint,
    so the lookup is a counted miss, and the build raises as unarmed."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        _build.load_library("estep")
    assert _counters() == {"misses": 1}


# -- misses, never crashes ---------------------------------------------------
def _corrupt_payload(entry):
    p = os.path.join(entry, "estep.so")
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(blob)


def _drop_commit(entry):
    os.remove(os.path.join(entry, COMMIT_NAME))


def _lie_in_metadata(entry):
    p = os.path.join(entry, "entry.json")
    meta = json.load(open(p))
    meta["label"] = "somebody.else"
    json.dump(meta, open(p, "w"))
    finalize_artifact_dir(entry)         # checksums verify, meta lies


def _stale_fingerprint_inside(entry):
    p = os.path.join(entry, "entry.json")
    meta = json.load(open(p))
    meta["fingerprint"] = "nvcc11.8-sm_90a-x86_64-000000000000"
    json.dump(meta, open(p, "w"))
    finalize_artifact_dir(entry)


def _truncate_sealed(entry):
    p = os.path.join(entry, "estep.so")
    open(p, "r+b").truncate(100)
    finalize_artifact_dir(entry)         # sealed, but not a library


def _rehome_under_foreign_fingerprint(entry):
    fdir = os.path.dirname(entry)
    foreign = os.path.join(os.path.dirname(fdir),
                           "nvcc11.8-sm_90a-x86_64-deadbeef0000")
    os.makedirs(foreign)
    os.rename(entry, os.path.join(foreign, os.path.basename(entry)))


def _torn_stage(entry):
    """A crash mid-publish of another writer: a stage beside the entry,
    and this entry gone."""
    fdir = os.path.dirname(entry)
    stage = os.path.join(fdir, f".stage-{os.path.basename(entry)}-999")
    shutil.copytree(entry, stage)
    os.remove(os.path.join(stage, COMMIT_NAME))
    shutil.rmtree(entry)


# (damage, quarantined, expected counters of the fresh load)
BAD_ENTRIES = {
    "corrupt_payload": (_corrupt_payload, True),
    "missing_commit": (_drop_commit, True),
    "metadata_mismatch": (_lie_in_metadata, True),
    "stale_fingerprint_in_entry": (_stale_fingerprint_inside, True),
    "payload_not_a_library": (_truncate_sealed, True),
    "stale_fingerprint_dir": (_rehome_under_foreign_fingerprint, False),
    "torn_stage": (_torn_stage, False),
}


@needs_gxx
@pytest.mark.parametrize("case", sorted(BAD_ENTRIES))
def test_a_bad_entry_is_a_miss_never_a_crash(toolchain, cache_dir, case):
    """Each damaged entry is a counted miss (and, where JAX quarantines,
    an invalidation with the entry under ``.quarantine/``); the load goes
    on from the build directory and publishes a good entry again."""
    damage, quarantined = BAD_ENTRIES[case]
    _build.load_library("estep")
    entry = _entry()
    damage(entry)
    _fresh_process_sim()
    lib = _build.load_library("estep")
    assert lib.stc_estep_max_k() == len("estep")
    c = _counters()
    assert c["misses"] == 1 and c["stores"] == 1 and "hits" not in c
    qdir = os.path.join(os.path.dirname(entry), ".quarantine")
    if quarantined:
        assert c["invalidations"] == 1
        assert os.listdir(qdir) == [f"{os.path.basename(entry)}.1"]
    else:
        assert "invalidations" not in c and not os.path.exists(qdir)
    assert len(_compiles(toolchain)) == 1          # the build dir's library
    _fresh_process_sim()
    _build.load_library("estep")
    assert _counters() == {"hits": 1}


@needs_gxx
def test_read_fault_is_a_miss_and_the_entry_survives(toolchain, cache_dir):
    _build.load_library("estep")
    _fresh_process_sim()
    faultinject.configure("compilecache.read:ioerror@1.0")
    _build.load_library("estep")
    c = _counters()
    assert c["misses"] == 1 and "hits" not in c and "invalidations" not in c
    faultinject.configure(None)
    _fresh_process_sim()
    _build.load_library("estep")
    assert _counters() == {"hits": 1}              # fine once I/O heals


@needs_gxx
@pytest.mark.parametrize("spec,stored", [("compilecache.write:fail@1", 0),
                                         ("compilecache.write:partial@1", 1)])
def test_write_faults_never_stop_the_load(toolchain, cache_dir, spec,
                                          stored):
    """A failed publish leaves no entry; a partial one commits a truncated
    payload that the next reader quarantines.  The load goes on."""
    faultinject.configure(spec)
    lib = _build.load_library("estep")
    assert lib.stc_estep_max_k() == len("estep")
    assert _counters().get("stores", 0) == stored
    faultinject.configure(None)
    entries = compilecache.get_store().entries()
    assert len(entries) == stored
    _fresh_process_sim()
    _build.load_library("estep")
    c = _counters()
    assert "hits" not in c and c["misses"] == 1 and c["stores"] == 1
    assert c.get("invalidations", 0) == stored


@needs_gxx
def test_store_race_leaves_one_entry(toolchain, cache_dir):
    _build.load_library("estep")
    store = compilecache.get_store()
    sig = _build._digest()
    assert store.store("estep", sig, _build.entry_digest("estep", sig),
                       str(_build._lib_path("estep"))) is False
    assert _counters()["stores"] == 1
    # a second writer that staged before the first committed: its rename
    # fails, and it discards its stage
    fdir = os.path.dirname(_entry())
    other = tstore.ExecutableStore(store.root)
    entry = _entry()
    os.rename(entry, entry + ".aside")
    orig = os.rename

    def rename(src, dst):
        if dst == entry:
            orig(entry + ".aside", entry)        # the rival commits first
        return orig(src, dst)

    try:
        os.rename = rename
        assert other.store("estep", sig, os.path.basename(entry),
                           str(_build._lib_path("estep"))) is False
    finally:
        os.rename = orig
    assert sorted(os.listdir(fdir)) == [os.path.basename(entry)]


def test_fault_sites_are_registered():
    assert {"compilecache.read", "compilecache.write"} <= faultinject.SITES


# -- a second process --------------------------------------------------------
_LOAD_ALL = """
import json, os, sys
from pathlib import Path
from spark_text_clustering_tpu_torch import telemetry
from spark_text_clustering_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
for name in _build.SOURCES:
    lib = _build.load_library(name)
    assert all(hasattr(lib, s) for s in _build.SIGNATURES[name])
snap = telemetry.get_registry().snapshot()["counters"]
print(json.dumps({k: v for k, v in snap.items()
                  if k.startswith("compile.cache_")}))
"""


@needs_gxx
def test_a_second_process_builds_nothing(tmp_path):
    """Process A builds the six stub libraries and publishes them; process
    B, with an empty build directory and the same store, loads all six
    from it: its nvcc log holds ``--version`` only, and its build
    directory stays empty."""
    root = str(tmp_path / "cc")
    env = {**os.environ, **_fake_env(tmp_path),
           compilecache.ENV_DIR: root, "PYTHONPATH": REPO}

    def run(build_dir):
        os.makedirs(build_dir)
        out = subprocess.run([sys.executable, "-c", _LOAD_ALL, build_dir],
                             env=env, capture_output=True, text=True,
                             timeout=300, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    n = len(_build.SOURCES)
    a = run(str(tmp_path / "build_a"))
    assert a == {"compile.cache_misses": n, "compile.cache_stores": n}
    assert len(_compiles(tmp_path)) == n
    (tmp_path / "nvcc.log").unlink()
    b = run(str(tmp_path / "build_b"))
    assert b == {"compile.cache_hits": n}
    calls = _nvcc_calls(tmp_path)
    assert calls and all(c == ["--version"] for c in calls)
    assert os.listdir(tmp_path / "build_b") == []


# -- the dispatch layer and the serve warmup --------------------------------
@needs_gxx
def test_dispatch_cache_status(toolchain, cache_dir):
    """A first call that published a library says "miss", one that loaded
    it from the store "hit"; unarmed, or loading nothing, "off"."""
    telemetry.configure(None)

    def call(name):
        fn = telemetry.instrument_dispatch(f"t.{name}",
                                           lambda: _build.load_library(name))
        fn()
        return dispatch.records()[
            next(d for d, r in dispatch.records().items()
                 if r.label == f"t.{name}")]

    assert call("estep").cache_status == "miss"
    _fresh_process_sim()
    telemetry.configure(None)
    rec = call("estep")
    assert rec.cache_status == "hit" and rec.cache_load_seconds >= 0
    assert call("estep").cache_status == "hit"    # the same record
    compilecache.configure(None)
    assert call("packed").cache_status == "off"


def _warmup_report(pkg):
    if pkg == "jax":
        jcc, jtel = jcompilecache, jtelemetry
        from spark_text_clustering_tpu.models.base import LDAModel
        from spark_text_clustering_tpu.serving.server import ServeScorer
        kw = {}
    else:
        jcc, jtel = compilecache, telemetry
        from spark_text_clustering_tpu_torch.models.base import LDAModel
        from spark_text_clustering_tpu_torch.serving.server import (
            ServeScorer,
        )
        kw = {"device": "cpu"}
    rng = np.random.default_rng(0)
    model = LDAModel(lam=rng.random((3, 128)).astype(np.float32) + 0.1,
                     vocab=[f"h{i}" for i in range(128)],
                     alpha=np.full(3, 0.5, np.float32), eta=0.1, **kw)
    jtel.configure(None)
    try:
        return ServeScorer(model, "/nowhere", generation=0, max_batch=8,
                           token_buckets=(64, 256), **kw).warmup()
    finally:
        jtel.shutdown()
        jcc.reset()


@pytest.mark.parametrize("armed", [False, True])
def test_warmup_report_keys_match_jax(tmp_path, armed):
    """The warmup report has the JAX package's keys, armed ("on" and the
    cache deltas) and unarmed ("off", no deltas).  On the CPU nothing
    loads a library, so the port's deltas are 0."""
    reports = {}
    for pkg, cc in (("jax", jcompilecache), ("port", compilecache)):
        cc.configure(str(tmp_path / pkg) if armed else None)
        reports[pkg] = _warmup_report(pkg)
    assert set(reports["port"]) == set(reports["jax"])
    assert reports["port"]["compile_cache"] == reports["jax"][
        "compile_cache"] == ("on" if armed else "off")
    if armed:
        assert {reports["port"][f"cache_{k}"]
                for k in ("hits", "misses", "stores")} == {0}


# -- maintenance parity ------------------------------------------------------
def _entry_dir(root, fp, digest, label, created, payload=b"\x7fELF" * 64,
               commit=True):
    path = os.path.join(root, fp, digest)
    os.makedirs(path)
    with open(os.path.join(path, tstore.payload_name(label)), "wb") as f:
        f.write(payload)
    meta = {"schema": 1, "label": label, "signature": "s" * 16,
            "digest": digest, "fingerprint": fp, "compile_seconds": 4.5,
            "payload_bytes": len(payload), "created_at": created}
    with open(os.path.join(path, "entry.json"), "w") as f:
        json.dump(meta, f)
    finalize_artifact_dir(path)
    if not commit:
        os.remove(os.path.join(path, COMMIT_NAME))
    return path


FP_A = "nvcc12.4-sm_90a-x86_64-0123456789ab"
FP_B = "nvcc12.6-sm_90a-x86_64-ba9876543210"


def _tree(root, kind):
    """Store trees the maintenance verbs see: clean, with every kind of
    bad entry, and over two fingerprints."""
    for i, name in enumerate(_build.SOURCES):
        _entry_dir(root, FP_A, f"{i:010x}", name, 1000.0 + i)
    if kind == "clean":
        return
    fdir = os.path.join(root, FP_A)
    with open(os.path.join(fdir, f"{1:010x}", "estep.so"), "ab") as f:
        f.write(b"rot")
    _entry_dir(root, FP_A, "torn000000", "nmf", 2000.0, commit=False)
    os.makedirs(os.path.join(fdir, ".stage-dead000000-123"))
    os.makedirs(os.path.join(fdir, ".quarantine", "old0000000.1"))
    bad = os.path.join(fdir, "badmeta000")
    os.makedirs(bad)
    with open(os.path.join(bad, "entry.json"), "w") as f:
        f.write("{not json")
    if kind == "two_fingerprints":
        for i, name in enumerate(_build.SOURCES[:3]):
            _entry_dir(root, FP_B, f"b{i:09x}", name, 3000.0 + i)


def _masked(obj):
    """Drop the ``stale`` mark: it compares each package's own fingerprint."""
    if isinstance(obj, dict):
        return {k: _masked(v) for k, v in obj.items() if k != "stale"}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _listing(root):
    out = []
    for d, dirs, files in os.walk(root):
        dirs.sort()
        out += [os.path.relpath(os.path.join(d, f), root) for f in sorted(files)]
        out += [os.path.relpath(os.path.join(d, x), root) + "/" for x in dirs]
    return sorted(out)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _jax_main(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


@pytest.mark.parametrize("kind", ["clean", "damaged", "two_fingerprints"])
def test_entries_and_verify_equal_jaxs(tmp_path, kind, capsys):
    root = str(tmp_path / "cc")
    _tree(root, kind)
    before = _listing(root)
    j, t = jstore.ExecutableStore(root), tstore.ExecutableStore(root)
    assert _masked(t.entries()) == _masked(j.entries())
    assert _masked(t.verify()) == _masked(j.verify())
    for argv in (["ls", "--json"], ["verify", "--json"], ["verify"]):
        argv = ["compile-cache", *argv, "--cache-dir", root]
        jrc, jout = _run(_jax_main, argv, capsys)
        trc, tout = _run(tcli.main, argv, capsys)
        assert trc == jrc == (1 if argv[1] == "verify" and kind != "clean"
                              else 0)
        if "--json" in argv:
            assert _masked(json.loads(tout)) == _masked(json.loads(jout))
        else:
            assert tout == jout
    assert _listing(root) == before            # reads only


@pytest.mark.parametrize("kind,keep", [("clean", 2), ("damaged", 1),
                                       ("damaged", 8),
                                       ("two_fingerprints", 1)])
def test_gc_equals_jaxs(tmp_path, kind, keep, capsys):
    """The same removals and the same tree left, in the library and in
    both CLIs' ``gc``."""
    roots = {}
    for who in ("jax", "port", "jax_cli", "port_cli"):
        roots[who] = str(tmp_path / who)
        _tree(roots[who], kind)
    removed_j = jstore.ExecutableStore(roots["jax"]).gc(keep)
    removed_t = tstore.ExecutableStore(roots["port"]).gc(keep)
    assert removed_t == removed_j
    assert _listing(roots["port"]) == _listing(roots["jax"])
    argv = ["compile-cache", "gc", "--keep-newest", str(keep), "--cache-dir"]
    jrc, jout = _run(_jax_main, [*argv, roots["jax_cli"]], capsys)
    trc, tout = _run(tcli.main, [*argv, roots["port_cli"]], capsys)
    assert trc == jrc == 0 and tout == jout
    assert _listing(roots["port_cli"]) == _listing(roots["jax"])


def test_cli_requires_a_cache_dir(capsys):
    for main in (_jax_main, tcli.main):
        rc, _ = _run(main, ["compile-cache", "ls"], capsys)
        assert rc == 2


# -- warm --------------------------------------------------------------------
@needs_gxx
def test_warm_publishes_every_library_then_hits(tmp_path):
    """``compile-cache warm`` builds the libraries the store and the build
    directory lack (all at once), publishes all six and warms the serve
    grid; a second warm in a fresh process finds all six stored."""
    from spark_text_clustering_tpu_torch.models.base import LDAModel
    from spark_text_clustering_tpu_torch.models.persistence import save_model

    rng = np.random.default_rng(0)
    model = LDAModel(lam=rng.random((3, 64)).astype(np.float32) + 0.1,
                     vocab=[f"h{i}" for i in range(64)],
                     alpha=np.full(3, 0.5, np.float32), eta=0.1,
                     device="cpu")
    mdir = str(tmp_path / "models" / "LdaModel_EN_1000")
    save_model(model, mdir)
    root = str(tmp_path / "cc")
    env = {**os.environ, **_fake_env(tmp_path), "PYTHONPATH": REPO}
    code = ("import sys\nfrom pathlib import Path\n"
            "from spark_text_clustering_tpu_torch import cli\n"
            "from spark_text_clustering_tpu_torch.ops import _build\n"
            "_build.BUILD_DIR = Path(sys.argv[1])\n"
            "sys.exit(cli.main(['compile-cache', 'warm', '--cache-dir', "
            f"{root!r}, '--model', {mdir!r}, '--device', 'cpu', "
            "'--token-bucket', '64', '--baseline', '']))\n")

    def warm(build_dir):
        out = subprocess.run([sys.executable, "-c", code, build_dir],
                             env=env, capture_output=True, text=True,
                             timeout=300, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        return out.stdout

    n = len(_build.SOURCES)
    first = warm(str(tmp_path / "build_a"))
    assert f"— {n} stored, 0 already cached, {n} miss(es)" in first
    assert first.startswith(f"warmed {mdir} buckets [64] in ")
    assert len(_compiles(tmp_path)) == n
    second = warm(str(tmp_path / "build_b"))
    assert f"— 0 stored, {n} already cached, 0 miss(es)" in second
    assert len(_compiles(tmp_path)) == n
    entries = tstore.ExecutableStore(root).entries()
    assert sorted(e["label"] for e in entries) == sorted(_build.SOURCES)
    assert {e["status"] for e in entries} == {"committed"}
