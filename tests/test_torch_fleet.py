"""The port's supervised stream fleet end to end, on the CPU: ``python -m
spark_text_clustering_tpu_torch.cli supervise`` runs ``stream-score`` and
``stream-train`` workers of the port's CLI (``--device cpu`` passed on to
them) under the JAX package's chaos drills, with its assertions: kills at
spawn, mid-epoch and at a heartbeat leave the report tree byte-equal to an
uninterrupted run's; resizes out and in under a kill keep every file
committed exactly once with the same report contents; a train fleet under
a kill at commit publishes a loadable model per worker; a bare
``stream-score`` drains on SIGTERM and resumes.  Two drills resume a
fleet dir one package's ``supervise`` started in the other package's.

The JAX drill that reads the supervisor's telemetry stream is left out:
the fleet's telemetry is ROADMAP.md queue 1 item 9c.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.resilience import EpochLedger, faultinject
from spark_text_clustering_tpu_torch.resilience.supervisor import (
    FleetLedger,
    fleet_committed_sources,
)
from spark_text_clustering_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOLS = ["piano violin orchestra symphony concerto melody",
         "electron proton neutron quantum particle physics"]


def _env():
    env = dict(os.environ)
    env.pop(faultinject.ENV_SPEC, None)
    env.pop(faultinject.ENV_SEED, None)
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


def _run_cli(args, module="spark_text_clustering_tpu_torch.cli",
             timeout=240):
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=timeout,
    )


def _write_docs(watch, ids):
    for i in ids:
        (watch / f"doc{i:02d}.txt").write_text(f"{POOLS[i % 2]} tok{i}")


@pytest.fixture(scope="module")
def fleet_fixture(tmp_path_factory):
    """One model and a 6-file watch dir shared by every fleet run of the
    module; the text library is built once, before any worker starts."""
    try:
        native.build()
    except RuntimeError:
        pass  # the workers take the Python text path
    root = tmp_path_factory.mktemp("fleet")
    rng = np.random.default_rng(0)
    v = 64
    model = lda_model_from_numpy(
        rng.random((2, v)).astype(np.float32) + 0.1,
        np.full(2, 0.5, np.float32), 0.1, [f"h{i}" for i in range(v)],
        algorithm="online", device="cpu")
    model_dir = str(root / "models" / "LdaModel_EN_1000")
    model.save(model_dir)
    watch = root / "watch"
    watch.mkdir()
    _write_docs(watch, range(6))
    return {"root": root, "watch": str(watch), "model": model_dir}


def _supervise_args(fx, tag, workers=2, extra=(), watch=None):
    root = fx["root"]
    return [
        "supervise", "--role", "stream-score",
        "--watch-dir", watch or fx["watch"],
        "--fleet-dir", str(root / f"fleet_{tag}"),
        "--workers", str(workers),
        "--heartbeat-interval", "0.2", "--lease-timeout", "2.5",
        "--grace-seconds", "1.0", "--sweep-interval", "0.15",
        "--poll-interval", "0.05", "--idle-timeout", "0.8",
        "--max-files-per-trigger", "1", "--no-lemmatize",
        "--model", fx["model"],
        "--output-dir", str(root / f"out_{tag}"),
        *extra,
    ]


def _port_supervise(fx, tag, **kw):
    return _run_cli(_supervise_args(fx, tag, **kw) + ["--device", "cpu"])


def _out_tree(root, tag):
    base = str(root / f"out_{tag}")
    tree = {}
    for d, _, files in os.walk(base):
        for n in files:
            p = os.path.join(d, n)
            tree[os.path.relpath(p, base)] = open(p).read()
    return tree


def _assert_exactly_once(fx, tag, watch=None):
    fleet = str(fx["root"] / f"fleet_{tag}")
    watch = watch or fx["watch"]
    srcs = sorted(fleet_committed_sources(fleet))
    per = []
    for n in sorted(os.listdir(fleet)):
        wd = os.path.join(fleet, n)
        if n.startswith("w") and os.path.isdir(wd):
            for r in EpochLedger(wd).records():
                per.extend(r.get("sources", ()))
    assert len(per) == len(set(per)), f"{tag}: a source committed twice"
    watched = {os.path.join(watch, n) for n in os.listdir(watch)}
    assert set(srcs) == watched, f"{tag}: sources lost or foreign"


_NAME = re.compile(r"^Book's name: (.+)$", re.M)
_DIST = re.compile(r"^Nr\.: (\d+) \t\t\|\t (\S+)$", re.M)


def _distributions(tree):
    """{book name: topic distribution} over a tree of one-book reports."""
    out = {}
    for text in tree.values():
        (name,) = _NAME.findall(text)
        out[name] = np.array([float(p) for _, p in _DIST.findall(text)])
    return out


@pytest.fixture(scope="module")
def uninterrupted(fleet_fixture):
    r = _port_supervise(fleet_fixture, "ref")
    assert r.returncode == 0, r.stderr[-2000:]
    return _out_tree(fleet_fixture["root"], "ref")


class TestFleetChaosSweep:
    def test_uninterrupted_fleet_splits_the_files(self, fleet_fixture,
                                                  uninterrupted):
        """Both workers score their partition: one report a file, none
        twice, each worker's reports in its own subdir."""
        _assert_exactly_once(fleet_fixture, "ref")
        assert len(uninterrupted) == 6
        assert {p.split(os.sep)[0] for p in uninterrupted} == {
            "w000", "w001"}
        first = FleetLedger(str(fleet_fixture["root"] / "fleet_ref")
                            ).records()[0]
        assert first["kind"] == "spawn" and first["worker_count"] == 2

    @pytest.mark.parametrize(
        "phase,chaos",
        [
            # killed before any work: dies at the very first lease beat
            ("spawn", "0:worker.heartbeat:kill@1"),
            # killed mid-epoch: at the commit append (the commit point)
            ("mid_epoch", "0:ledger.commit:kill@1"),
            # live but stuck: stops heartbeating, ignores the drain; only
            # the SIGKILL escalation reclaims it
            ("heartbeat", "0:worker.heartbeat:hang@3"),
        ],
    )
    def test_kill_sweep_byte_identical(
        self, fleet_fixture, uninterrupted, phase, chaos
    ):
        """For every injected fault the fleet reconverges and the final
        report tree is byte for byte the uninterrupted run's."""
        fx = fleet_fixture
        r = _port_supervise(fx, phase, extra=["--chaos-worker", chaos])
        assert r.returncode == 0, (phase, r.stderr[-2000:])
        assert _out_tree(fx["root"], phase) == uninterrupted, phase
        _assert_exactly_once(fx, phase)
        summary = r.stdout.strip().splitlines()[-1]
        assert "fleet converged" in summary, (phase, summary)
        if phase == "heartbeat":
            assert "1 lease expiry" in summary, summary

    @pytest.mark.parametrize(
        "tag,workers,plan,chaos",
        [
            # scale-out 2->3 with a worker hung when the drain arrives:
            # the resize SIGKILLs it mid-drain, rolls its epoch back, and
            # the new partition takes up the lost files
            ("resize_out", 2, "2:3", "0:worker.heartbeat:hang@4"),
            # scale-in 3->2, kill at a commit append on the way
            ("resize_in", 3, "2:2", "1:ledger.commit:kill@1"),
        ],
    )
    def test_resize_sweep_exactly_once(
        self, fleet_fixture, uninterrupted, tag, workers, plan, chaos
    ):
        """Kill during a resize, both directions.  Which worker scores
        which file depends on when the resize lands, so the check is on
        content: one file a trigger makes each report's bytes a function
        of its document, and the multiset of report contents must be the
        uninterrupted run's (no duplicates, no losses, no zombie
        merges)."""
        fx = fleet_fixture
        r = _port_supervise(
            fx, tag, workers=workers,
            extra=["--resize-at", plan, "--chaos-worker", chaos,
                   "--grace-seconds", "0.6"],
        )
        assert r.returncode == 0, (tag, r.stderr[-2000:])
        got = sorted(_out_tree(fx["root"], tag).values())
        want = sorted(uninterrupted.values())
        assert got == want, tag
        _assert_exactly_once(fx, tag)
        assert "1 resize" in r.stdout, r.stdout.splitlines()[-1:]
        fleet = str(fx["root"] / f"fleet_{tag}")
        kinds = [rec["kind"] for rec in FleetLedger(fleet).records()]
        assert "resize" in kinds


class TestTrainFleet:
    def test_supervised_train_fleet_chaos_exactly_once(
        self, fleet_fixture
    ):
        """A stream-train fleet under a kill at commit: the supervisor
        respawns the crashed worker, no file is trained twice, and every
        worker publishes a loadable model at convergence."""
        from spark_text_clustering_tpu_torch.models.persistence import (
            latest_model_dir,
            load_model,
        )

        fx = fleet_fixture
        root = fx["root"]
        r = _run_cli([
            "supervise", "--role", "stream-train",
            "--watch-dir", fx["watch"],
            "--fleet-dir", str(root / "fleet_train"),
            "--workers", "2",
            "--heartbeat-interval", "0.2", "--lease-timeout", "2.5",
            "--grace-seconds", "1.0", "--sweep-interval", "0.15",
            "--poll-interval", "0.05", "--idle-timeout", "0.8",
            "--max-files-per-trigger", "1", "--no-lemmatize",
            "--k", "2", "--hash-features", "64",
            "--checkpoint-interval", "1",
            "--chaos-worker", "0:ledger.commit:kill@1",
            "--models-dir", str(root / "models_train"),
            "--device", "cpu",
        ])
        assert r.returncode == 0, r.stderr[-2000:]
        assert "fleet converged" in r.stdout
        _assert_exactly_once(fx, "train")
        for w in ("w000", "w001"):
            d = latest_model_dir(str(root / "models_train" / w), "EN")
            assert d is not None
            assert load_model(d, device="cpu").k == 2


class TestStandalonePreemption:
    def test_sigterm_drains_and_resume_completes(self, fleet_fixture):
        """The preemption notice against a bare (unsupervised)
        stream-score: SIGTERM ends the stream cleanly after the in-flight
        trigger; a resumed run emits exactly the reports the
        uninterrupted run would."""
        fx = fleet_fixture
        root = fx["root"]
        out = str(root / "out_preempt")
        ckpt = str(root / "ck_preempt")
        args = [
            "stream-score", "--watch-dir", fx["watch"],
            "--model", fx["model"], "--output-dir", out,
            "--checkpoint-dir", ckpt, "--no-lemmatize",
            "--max-files-per-trigger", "1", "--device", "cpu",
            "--poll-interval", "0.05", "--idle-timeout", "30",
        ]
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             *args],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        # preempt once the first report landed (the stream is live)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if os.path.isdir(out) and os.listdir(out):
                break
            time.sleep(0.05)
        else:
            proc.kill()
            proc.communicate()
            pytest.fail("stream never produced a first report")
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
        assert proc.returncode == 0, stderr[-2000:]
        assert "preemption notice honored" in stdout
        emitted = set(os.listdir(out))
        assert emitted                      # partial output, committed
        # resume with a short idle timeout: finishes the remainder
        r2 = _run_cli(args[:-1] + ["0.5"])
        assert r2.returncode == 0, r2.stderr[-2000:]
        assert len(os.listdir(out)) == 6    # 6 files, 1 per trigger
        assert emitted <= set(os.listdir(out))
        led = EpochLedger(ckpt)
        srcs = [
            s for rec in led.records() for s in rec.get("sources", ())
        ]
        assert len(srcs) == len(set(srcs)) == 6


class TestCrossPackageFleet:
    @pytest.mark.parametrize("first,then", [("jax", "port"),
                                            ("port", "jax")])
    def test_fleet_dir_resumes_in_the_other_package(self, fleet_fixture,
                                                    first, then):
        """One package's ``supervise`` scores 3 files; 3 more arrive and
        the other package's ``supervise`` resumes the same fleet dir and
        report root: every file is committed once, the first fleet's
        reports stay as they were, and every book's distribution is
        within 1e-4 of the JAX package's own scoring of it (a pinned
        [8, row_len] batch, one live row, as a trigger of one file)."""
        from spark_text_clustering_tpu.models.persistence import (
            load_model as j_load,
        )
        from spark_text_clustering_tpu.streaming import (
            MicroBatch as JMicroBatch,
        )
        from spark_text_clustering_tpu.streaming import (
            StreamingScorer as JScorer,
        )

        def supervise(package, tag, watch):
            args = _supervise_args(fx, tag, watch=watch)
            if package == "port":
                return _run_cli(args + ["--device", "cpu"])
            return _run_cli(args, module="spark_text_clustering_tpu.cli")

        fx = fleet_fixture
        tag = f"{first}_{then}"
        watch = fx["root"] / f"watch_{tag}"
        watch.mkdir()
        _write_docs(watch, range(3))
        r = supervise(first, tag, str(watch))
        assert r.returncode == 0, r.stderr[-2000:]
        before = _out_tree(fx["root"], tag)
        assert len(before) == 3
        _write_docs(watch, range(3, 6))
        r = supervise(then, tag, str(watch))
        assert r.returncode == 0, r.stderr[-2000:]
        assert "fleet converged: 6 committed epoch(s)" in r.stdout
        _assert_exactly_once(fx, tag, watch=str(watch))
        recs = FleetLedger(str(fx["root"] / f"fleet_{tag}")).records()
        kinds = [x["kind"] for x in recs]
        assert kinds[0] == "spawn" and "resume" in kinds
        assert recs[kinds.index("resume")]["generation"] == 1
        tree = _out_tree(fx["root"], tag)
        assert len(tree) == 6
        assert {k: tree[k] for k in before} == before
        got = _distributions(tree)
        scorer = JScorer(j_load(fx["model"]), lemmatize=False,
                         batch_capacity=8, keep_results=False)
        for i, name in enumerate(sorted(got)):
            text = (watch / name).read_text()
            (sd,) = scorer.process(JMicroBatch(i, [name], [text]))
            np.testing.assert_allclose(got[name], sd.distribution,
                                       atol=1e-4)
