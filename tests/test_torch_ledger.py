"""The port's resilience layer held against the JAX package's: the epoch
commit ledger, the dead-letter quarantine, retry with backoff, seeded fault
injection, and the fault sites of the artifact, checkpoint and report
writers.

Each test runs one script through both packages, each in a directory of
its own, and compares what they leave: ledger records field by field with
the directory, the timestamps and the digests of npz shards masked (a zip
entry carries its write time), each package's checksums verified by the
other's ``record_checksum``, recovery reports, file listings, and the
decisions of the fault plans and retry loops.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import pytest

from spark_text_clustering_tpu.models import persistence as jpersist
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.resilience import integrity as jintegrity
from spark_text_clustering_tpu.resilience import ledger as jledger
from spark_text_clustering_tpu.resilience import quarantine as jquar
from spark_text_clustering_tpu.resilience import retry as jretry
from spark_text_clustering_tpu.utils import report as jreport
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.models import persistence as tpersist
from spark_text_clustering_tpu_torch.resilience import faultinject as tfault
from spark_text_clustering_tpu_torch.resilience import integrity as tintegrity
from spark_text_clustering_tpu_torch.resilience import ledger as tledger
from spark_text_clustering_tpu_torch.resilience import quarantine as tquar
from spark_text_clustering_tpu_torch.resilience import retry as tretry
from spark_text_clustering_tpu_torch.utils import report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": (jledger, jintegrity, jpersist, jfault, jretry, jquar, jreport),
    "port": (tledger, tintegrity, tpersist, tfault, tretry, tquar, treport),
}
K, V = 3, 40


@pytest.fixture(autouse=True)
def no_faults():
    """Both packages' fault plans disarmed around every test."""
    jfault.configure(None)
    tfault.configure(None)
    yield
    jfault.reset()
    tfault.reset()


def _lam(seed):
    return np.random.default_rng(seed).gamma(1.0, 1.0, (K, V)).astype(
        np.float32)


def _masked(records, root):
    """Records as JSON with the dir, the timestamps, the record checksums
    and the npz digests masked."""
    out = []
    for rec in records:
        rec = json.loads(json.dumps(rec).replace(root, "<d>"))
        rec.pop("ts", None)
        rec.pop("checksum", None)
        for s in rec.get("shards", ()):
            s["sha256"] = "<npz>"
        out.append(rec)
    return out


def _listing(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) for f in files)


def _ledger_script(pkg, root):
    """Epochs 0-3 committed through one package's ledger (a state epoch,
    a scoring epoch with its report outside the dir, a state epoch staged
    by two processes and committed after the coordinator's rendezvous, a
    model-publish record), then a crash: an intent and a shard staged for
    epoch 4 and half a line appended.  Returns (ledger, recovery report,
    records after recovery, snapshot)."""
    ledger_mod, integrity, persist = PACKAGES[pkg][:3]
    d = os.path.join(root, "ck")
    led = ledger_mod.EpochLedger(d)
    name0 = ledger_mod.shard_filename(0, 0)
    led.begin(0, kind="stream-train", sources=["b.txt", "a.txt"],
              payloads=[name0])
    lo, hi = ledger_mod.shard_span(V, 0, 1)
    spec = led.stage_shard(0, 0, 1, cols=(lo, hi), step=2, lam=_lam(0),
                           docs_seen=np.int64(4), batches_seen=np.int64(2))
    led.commit(0, kind="stream-train", sources=["b.txt", "a.txt"],
               shards=[spec], step=2, docs_seen=4, batches_seen=2)

    report = os.path.join(root, "out", "Result_EN_epoch-000001")
    led.begin(1, kind="stream-score", sources=["c.txt"], payloads=[report])
    os.makedirs(os.path.dirname(report))
    with open(report, "w") as f:
        f.write("report\n")
    led.commit(1, kind="stream-score", sources=["c.txt"],
               payloads={os.path.basename(report): report}, model_ref="m")

    # two processes: both stage, the coordinator collects and commits
    led.begin(2, kind="stream-train", sources=["d.txt"],
              payloads=[ledger_mod.shard_filename(2, p) for p in (0, 1)],
              process_count=2)
    for p in (0, 1):
        lo, hi = ledger_mod.shard_span(V, p, 2)
        led.stage_shard(2, p, 2, cols=(lo, hi), step=3,
                        lam=_lam(2)[:, lo:hi], docs_seen=np.int64(5))
    specs = led.await_shards(2, 2, timeout_s=5.0, poll_s=0.01)
    led.commit(2, kind="stream-train", sources=["d.txt"], shards=specs,
               process_count=2, step=3, docs_seen=5, batches_seen=3)
    assert led.await_committed(2, timeout_s=5.0, poll_s=0.01)["epoch"] == 2

    model_dir = os.path.join(root, "model")
    os.makedirs(model_dir)
    with open(os.path.join(model_dir, "meta.json"), "w") as f:
        f.write("{}")
    integrity.finalize_artifact_dir(model_dir)
    led.begin(3, kind="model-publish", sources=[], payloads=[])
    led.commit(3, kind="model-publish", sources=[],
               model_ref=integrity.artifact_ref(model_dir))

    # a crash mid-epoch 4, then half a commit line
    led.begin(4, kind="stream-train", sources=["e.txt"],
              payloads=[ledger_mod.shard_filename(4, 0)])
    led.stage_shard(4, 0, 1, cols=(0, V), step=4, lam=_lam(4))
    with open(led.path, "a") as f:
        f.write('{"epoch": 4, "kind": "stream-tr')
    before = led.records()
    rep = led.recover()
    after = led.records()
    assert after == before
    with pytest.raises(Exception, match="staged intent|out of order"):
        led.begin(7, kind="x", sources=[], payloads=[])
    return led, rep, after, led.compact()


def test_ledger_script_matches_jax(tmp_path):
    """The same script of commits, a two-process rendezvous, a publish
    record, a crash (an uncommitted intent with its shard, a torn append)
    and recovery, then compaction: records equal field by field (masked),
    each checksum valid under the other package's ``record_checksum``,
    recovery reports and the files left equal, the snapshot equal, and
    the compacted dir read back alike by both packages."""
    out = {}
    for pkg in PACKAGES:
        root = str(tmp_path / pkg)
        os.makedirs(root)
        out[pkg] = (root, *_ledger_script(pkg, root))
    (jroot, jled, jrep, jrecs, jsnap), (troot, tled, trep, trecs, tsnap) = (
        out["jax"], out["port"])
    assert [r["epoch"] for r in trecs] == [0, 1, 2, 3]
    assert _masked(trecs, troot) == _masked(jrecs, jroot)
    for rec in jrecs:
        assert tledger.record_checksum(rec) == rec["checksum"]
    for rec in trecs:
        assert jledger.record_checksum(rec) == rec["checksum"]
    assert (trep.last_epoch, trep.rolled_back, trep.truncated_lines) == (
        jrep.last_epoch, jrep.rolled_back, jrep.truncated_lines) == (
        3, [4], 1)
    assert [os.path.relpath(p, troot) for p in trep.quarantined] == [
        os.path.relpath(p, jroot) for p in jrep.quarantined]
    assert _listing(troot) == _listing(jroot)
    assert _masked([tsnap], troot) == _masked([jsnap], jroot)
    assert tsnap["compacted_epochs"] == 4 and tsnap["epoch"] == 3
    assert tledger.record_checksum(jsnap) == jsnap["checksum"]
    # each package reads the other's compacted dir
    assert tledger.EpochLedger(jled.directory).records() == [jsnap]
    assert jledger.EpochLedger(tled.directory).records() == [tsnap]
    assert tledger.EpochLedger(jled.directory).committed_sources() == {
        "a.txt", "b.txt", "c.txt", "d.txt"}
    assert tled.next_epoch() == jled.next_epoch() == 4


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_recover_of_the_other_packages_dir(tmp_path, reader):
    """A dir the other package wrote and crashed in: the reader's
    recover() gives the writer's own recovery report and leaves the same
    files."""
    writer = "port" if reader == "jax" else "jax"
    root = str(tmp_path / "w")
    os.makedirs(root)
    led = PACKAGES[writer][0].EpochLedger(os.path.join(root, "ck"))
    led.begin(0, kind="stream-train", sources=["a"],
              payloads=["stream_state-e000000-p0.npz"])
    spec = led.stage_shard(0, 0, 1, cols=(0, V), step=1, lam=_lam(1))
    led.commit(0, kind="stream-train", sources=["a"], shards=[spec], step=1)
    led.begin(1, kind="stream-train", sources=["b"],
              payloads=["stream_state-e000001-p0.npz"])
    led.stage_shard(1, 0, 1, cols=(0, V), step=2, lam=_lam(2))
    with open(led.path, "a") as f:
        f.write("{torn")
    copies = {}
    for pkg in PACKAGES:
        d = str(tmp_path / pkg)
        shutil.copytree(root, d)
        rep = PACKAGES[pkg][0].EpochLedger(os.path.join(d, "ck")).recover()
        copies[pkg] = (rep.last_epoch, rep.rolled_back, rep.truncated_lines,
                       [os.path.relpath(p, d) for p in rep.quarantined],
                       _listing(d))
    assert copies[reader] == copies[writer]
    assert copies[reader][:3] == (0, [1], 1)


@pytest.mark.parametrize("v_pad,count", [(40, 1), (40, 3), (7, 4), (1, 2)])
def test_shard_plan_matches_jax(v_pad, count):
    spans = [tledger.shard_span(v_pad, p, count) for p in range(count)]
    assert spans == [jledger.shard_span(v_pad, p, count)
                     for p in range(count)]
    rec = {"epoch": 3, "shards": [{"cols": list(c), "p": p}
                                  for p, c in enumerate(spans)][::-1]}
    assert tledger.validate_shard_plan(rec, v_pad) == \
        jledger.validate_shard_plan(rec, v_pad)
    torn = {"epoch": 3, "shards": rec["shards"][:-1]}  # no column 0
    if count > 1:
        for mod in (tledger, jledger):
            with pytest.raises(Exception, match="shard plan"):
                mod.validate_shard_plan(torn, v_pad)


def test_quarantine_and_requeue_match_jax(tmp_path):
    """Dead-lettered docs land under the same names with the same sidecars;
    requeue (dry run, then for real) makes the same moves."""
    seen = {}
    for pkg in PACKAGES:
        quar = PACKAGES[pkg][5]
        root = tmp_path / pkg
        q = quar.Quarantine(str(root / "q"))
        for name, text in (("/in/book 1.txt", "alpha"), ("b?.txt", "beta"),
                           ("", "gamma")):
            q.put(name, text, ValueError("bad doc"), stage="vectorize",
                  batch_id=4)
        assert quar.Quarantine(None).put("x", "y", OSError(),
                                         stage="score") is None
        dry = quar.requeue(str(root / "q"), str(root / "w"), dry_run=True)
        real = quar.requeue(str(root / "q"), str(root / "w"))
        rel = {k: [os.path.relpath(p, root) for p in v]
               for res in (dry, real) for k, v in res.items()}
        side = json.loads((root / "q" / ".archive" /
                           "q-000001-book_1.txt.error.json").read_text())
        seen[pkg] = (q.count, rel, _listing(str(root)), side,
                     (root / "w" / "q-000002-b_.txt.txt").read_text())
    assert seen["port"] == seen["jax"]
    assert tquar.QUARANTINED_COUNTER == jquar.QUARANTINED_COUNTER


FAULT_SPECS = [
    ("stream.poll:ioerror@0.3;ckpt.write:fail@3", 7),
    ("report.write:ioerror@0.5;report.write:fail@2", 0),
    ("ledger.commit:ioerror@1.0", 11),
    ("artifact.file:partial@2;ledger.stage:fail@1", 3),
]


@pytest.mark.parametrize("spec,seed", FAULT_SPECS,
                         ids=[s for s, _ in FAULT_SPECS])
def test_fault_decisions_match_jax(spec, seed):
    """One spec and seed make the same decision at every hit of every
    site in both packages, through ``configure`` and through the
    environment."""
    sites = ["stream.poll", "ckpt.write", "report.write", "ledger.commit",
             "ledger.stage", "artifact.file"]

    def decisions(fault):
        out = []
        for i in range(40):
            site = sites[i % len(sites)]
            try:
                fault.check(site)
                out.append(0)
            except OSError as exc:
                assert type(exc).__name__ == "InjectedIOError"
                out.append(1)
        return out

    jfault.configure(spec, seed)
    tfault.configure(spec, seed)
    want = decisions(jfault)
    assert decisions(tfault) == want and 0 < sum(want)
    os.environ[tfault.ENV_SPEC], os.environ[tfault.ENV_SEED] = spec, str(seed)
    try:
        tfault.reset()
        jfault.reset()
        assert tfault.active() and jfault.active()
        assert decisions(tfault) == decisions(jfault) == want
    finally:
        del os.environ[tfault.ENV_SPEC], os.environ[tfault.ENV_SEED]
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfault.configure("x:explode")


def test_fault_sites_are_the_ports_calls():
    """``faultinject.SITES`` names exactly the sites the port's code
    checks or corrupts, each one also a site of the JAX package."""
    calls = set()
    pat = re.compile(r"faultinject\.(?:check|corrupt)\(\s*\"([a-z.]+)\"")
    port = os.path.join(REPO, "spark_text_clustering_tpu_torch")
    for d, _, files in os.walk(port):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f), encoding="utf-8") as fh:
                    calls |= set(pat.findall(fh.read()))
    assert calls == set(tfault.SITES)
    assert tfault.SITES <= jfault.SITES


@pytest.mark.parametrize("site", ["serve.accept", "serve.admit",
                                  "serve.batch", "serve.swap"])
def test_serve_fault_sites_are_registered_and_checked(site):
    """The scoring service's four sites are in ``SITES`` (and so, by the
    both-ways check above, each is a ``check`` call of the port), and are
    sites of the JAX package."""
    assert site in tfault.SITES and site in jfault.SITES


@pytest.mark.parametrize("failures", [0, 1, 3, 4, 6])
def test_retry_attempts_and_giveups_match_jax(failures):
    """A call failing its first ``failures`` times: the same attempts, the
    same backoff delays and the same give-up in both packages; errors
    outside ``retry_on`` pass straight through."""
    def run(retry):
        delays, calls = [], []

        def fn():
            calls.append(1)
            if len(calls) <= failures:
                raise OSError(f"flaky {len(calls)}")
            return "done"

        try:
            res = retry.retry_call(fn, site="ckpt.write", sleep=delays.append)
        except retry.RetryGiveUp as exc:
            res = (exc.attempts, exc.deadline_exceeded, str(exc))
        return res, delays, len(calls)

    assert run(tretry) == run(jretry)
    for retry in (tretry, jretry):
        with pytest.raises(KeyError):
            retry.retry_call(lambda: {}["x"], site="s", sleep=lambda s: None)
        with pytest.raises(retry.RetryGiveUp) as info:
            retry.retry_call(lambda: 1, site="s", policy=retry.RetryPolicy(
                deadline_seconds=0.0))
        assert info.value.deadline_exceeded and info.value.attempts == 0


def test_lease_deadline_caps_every_retry(monkeypatch):
    for retry in (tretry, jretry):
        monkeypatch.setattr(retry, "_lease_deadline", None)
        retry.configure_lease_deadline(0.0)
        assert retry.lease_deadline() == 0.0
        with pytest.raises(retry.RetryGiveUp) as info:
            retry.retry_call(lambda: 1, site="s")
        assert info.value.deadline_exceeded
        retry.configure_lease_deadline(None)


@pytest.mark.parametrize("site", ["ckpt.write", "report.write",
                                  "artifact.file", "artifact.commit"])
def test_injected_write_faults_end_alike(tmp_path, site):
    """One injected transient failure at a writer's site: the checkpoint
    and report writes retry it and end in the same artifact in both
    packages (arrays equal, the report byte for byte); the model dir's
    sites are not retried, in either package, and leave an uncommitted
    dir that neither loads."""
    lam = _lam(9)
    vocab = [f"w{i}" for i in range(V)]
    models = {
        "jax": JLDAModel(lam=lam, vocab=vocab, alpha=np.full(K, 0.5,
                                                             np.float32),
                         eta=0.3, algorithm="online", step=4),
        "port": lda_model_from_numpy(lam, 0.5, 0.3, vocab,
                                     algorithm="online", step=4,
                                     device="cpu"),
    }
    got = {}
    for pkg, mods in PACKAGES.items():
        persist, fault, report = mods[2], mods[3], mods[6]
        fault.configure(f"{site}:fail@1")
        root = tmp_path / pkg
        if site == "ckpt.write":
            path = str(root / "train_state.npz")
            persist.save_train_state(path, 7, lam=lam,
                                     docs_seen=np.int64(3))
            st = persist.load_train_state(path, require=("lam",))
            got[pkg] = (st["step"], st["lam"].tobytes(), int(st["docs_seen"]))
        elif site == "report.write":
            path = report.write_scoring_report("a\nreport\n", str(root),
                                               "EN", filename="Result_EN_x")
            got[pkg] = (os.path.basename(path), open(path).read())
        else:
            path = str(root / "LdaModel_EN_1")
            with pytest.raises(OSError, match=f"injected fault at {site}"):
                persist.save_model(models[pkg], path)
            got[pkg] = (PACKAGES[pkg][1].artifact_status(path),
                        sorted(os.listdir(path)))
            for loader in (jpersist.load_model, tpersist.load_model):
                with pytest.raises(Exception, match="uncommitted"):
                    loader(path)
        fault.configure(None)
    assert got["port"] == got["jax"]


def test_save_model_ledger_ref_matches_jax(tmp_path):
    """``save_model(..., ledger_ref=)`` writes the same meta.json in both
    packages, and ``artifact_ref`` pins the same manifest digest."""
    lam = _lam(3)
    vocab = [f"w{i}" for i in range(V)]
    ref = {"dir": "/ck", "epoch": 6}
    jm = JLDAModel(lam=lam, vocab=vocab, alpha=np.full(K, 0.5, np.float32),
                   eta=0.3, algorithm="online", step=4)
    tm = lda_model_from_numpy(lam, 0.5, 0.3, vocab, algorithm="online",
                              step=4, device="cpu")
    jpersist.save_model(jm, str(tmp_path / "j"), ledger_ref=ref)
    tpersist.save_model(tm, str(tmp_path / "t"), ledger_ref=ref)
    for name in ("meta.json", "vocab.txt"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    assert json.loads((tmp_path / "t" / "meta.json").read_text())[
        "ledger_ref"] == ref
    jref = jintegrity.artifact_ref(str(tmp_path / "j"))
    tref = tintegrity.artifact_ref(str(tmp_path / "j"))
    assert tref == jref and "manifest_sha256" in tref
    assert tpersist.load_model(str(tmp_path / "j"), device="cpu").step == 4
