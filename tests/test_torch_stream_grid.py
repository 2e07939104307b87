"""The port's streaming trainer on its (data, model) process grid, held
against the JAX package's ``StreamingOnlineLDA`` over a mesh on the CPU.

As in ``test_torch_sharding_online.py``, ``parallel.run_grid`` spawns each
grid shape once, (1, 2), (2, 1) and (2, 2), over gloo, one torch thread a
rank, and every rank runs ``torch_grid_stream_worker.suite``: rank 0 feeds
the micro-batches, the other ranks receive them.  The JAX package trains
the same micro-batches as one process over a mesh of as many of the 8
virtual CPU devices.  Torch cannot replay JAX's threefry draws, so the
port starts from JAX's lambda0 [k, V_pad] and its gamma inits of each
step, injected whole (``init_lam``, ``gamma0_fn``) and sliced by the grid.
Both packages take their Python text path in the trainer checks; the CLI
checks run the port's native text library on both sides.

Then: checkpoint dirs across the packages at (2, 2), the grid against one
device from a seed, the CLI on a grid against the CLI on one device, the
resume gate at another shape, flags that cannot run, a fenced grid
stream, SIGTERM through a grid stream, a supervised fleet of grid workers
whose killed worker leaves no rank behind, and ranks that end with their
parent.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

import chip_smoke
from spark_text_clustering_tpu import cli as jcli
from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu import streaming as js
from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.ops.lda_math import (
    init_gamma as j_init_gamma,
    init_lambda as j_init_lambda,
)
from spark_text_clustering_tpu.parallel import make_mesh
from spark_text_clustering_tpu_torch import Params, cli as tcli
from spark_text_clustering_tpu_torch import pipeline as tpipeline
from spark_text_clustering_tpu_torch.models.persistence import (
    latest_model_dir,
    load_train_state,
)
from spark_text_clustering_tpu_torch.parallel import run_grid
from spark_text_clustering_tpu_torch.resilience import EpochLedger, faultinject
from spark_text_clustering_tpu_torch.resilience.supervisor import FleetLedger
from spark_text_clustering_tpu_torch.streaming import (
    MicroBatch,
    StreamingOnlineLDA,
)
from spark_text_clustering_tpu_torch.utils import native as tnative

import torch_grid_stream_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, SEED, CAPACITY, V, V_ODD = 3, 0, 8, 400, 401
SHAPES = [(1, 2), (2, 1), (2, 2)]
# (case, shape): every shape on an even V; the odd V (V_pad 402) where the
# vocabulary is cut in two
CASES = {"even": (V, SHAPES), "odd": (V_ODD, [(1, 2)])}
PAIRS = [(name, shape) for name, (_, shapes) in CASES.items()
         for shape in shapes]
WORDS = [f"{a}{b}{c}{d}" for a in "bcdfgklmnprstvz" for b in "aeiu"
         for c in "lmnrst" for d in "aeiou"]     # 1,800 pseudo-words


def _texts(n, seed, lo=20, hi=160):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(lo, hi))))
            + "." for _ in range(n)]


def _batches():
    """Three triggers of eight documents."""
    return [MicroBatch(b, [f"doc-{b}-{i}" for i in range(8)],
                       _texts(8, 100 + b)) for b in range(3)]


def _jax_draws(v_pad, steps=6):
    """JAX's lambda0 [K, v_pad] and its gamma inits [steps, CAPACITY, K]."""
    key = jax.random.PRNGKey(SEED)
    lam0 = np.asarray(j_init_lambda(jax.random.fold_in(key, 0xFFFF), K,
                                    v_pad, 100.0))
    g0 = np.stack([np.asarray(j_init_gamma(jax.random.fold_in(key, s),
                                           CAPACITY, K, 100.0))
                   for s in range(steps)])
    return lam0, g0


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_grid")
    cases = {}
    for name, (v, shapes) in CASES.items():
        lam0 = {m: _jax_draws(-(-v // m) * m)[0] for m in (1, 2)}
        cases[name] = {"v": v, "shapes": shapes, "lam0": lam0,
                       "g0": _jax_draws(v)[1],
                       "written": {(2, 2): str(root / "port_dir")}
                       if name == "even" else {}}
    return {"k": K, "seed": SEED, "capacity": CAPACITY,
            "checkpoint_every": 2, "v": V, "batches": _batches(),
            "cases": cases, "root": str(root),
            "jax_dir": str(root / "jax_dir_copy")}


_RUNS: dict = {}
_JAX: dict = {}


@contextlib.contextmanager
def _jax_python_text():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipeline.TextPreprocessor, "_use_native",
                   lambda self: False)
        yield


def jax_trainer(shape, v, checkpoint_dir=None):
    d, m = shape
    return js.StreamingOnlineLDA(
        JParams(k=K, seed=SEED, data_shards=d, model_shards=m,
                checkpoint_dir=checkpoint_dir),
        num_features=v, batch_capacity=CAPACITY, checkpoint_every=2,
        mesh=make_mesh(d, m, devices=jax.devices("cpu")[:d * m]))


def jax_run(spec, name, shape):
    """JAX's trainer over the spec's micro-batches on a ``shape`` mesh
    (the (2, 2) run with a checkpoint dir): (lambda [K, V_pad], docs_seen,
    step)."""
    key = (name, shape)
    if key not in _JAX:
        ckpt = (os.path.join(spec["root"], "jax_dir")
                if key == ("even", (2, 2)) else None)
        with _jax_python_text():
            jt = jax_trainer(shape, CASES[name][0], ckpt)
            jt.run(spec["batches"])
        _JAX[key] = (np.asarray(jt.state.lam), jt.docs_seen,
                     int(jt.state.step))
    return _JAX[key]


def ranks(spec, shape):
    """Every rank's ``suite`` results for ``shape``, spawned once (the
    (2, 2) spawn after JAX wrote the dir it resumes, copied)."""
    if shape not in _RUNS:
        if shape == (2, 2):
            jax_run(spec, "even", shape)
            shutil.copytree(os.path.join(spec["root"], "jax_dir"),
                            spec["jax_dir"])
        _RUNS[shape] = run_grid(worker.suite, *shape, (spec,),
                                device="cpu", timeout=300)
    return _RUNS[shape]


def _shard_lam(ck):
    """The newest committed state shard of a stream checkpoint dir: (its
    record, its lambda)."""
    led = EpochLedger(ck)
    rec = [r for r in led.records() if r.get("shards")][-1]
    (shard,) = rec["shards"]
    return rec, load_train_state(led.resolve(shard["file"]))["lam"]


# ---- the trainer against JAX's on the same mesh ---------------------------
@pytest.mark.parametrize("name,shape", PAIRS,
                         ids=[f"{n}-{d}x{m}" for n, (d, m) in PAIRS])
def test_trainer_matches_jax_on_the_same_mesh(spec, name, shape):
    """Three triggers of eight documents on the grid against the JAX
    package's trainer on a mesh of the same shape, from JAX's draws:
    lambda [k, V_pad] within rtol 1e-4 on every rank (the pad columns of
    V=401 at two vocabulary shards included), the model cut to V, the
    same counters."""
    want, docs, step = jax_run(spec, name, shape)
    v = CASES[name][0]
    assert want.shape == (K, -(-v // shape[1]) * shape[1])
    for r in ranks(spec, shape):
        got = r["jax_draws"][name]
        assert got["lam"].shape == want.shape
        np.testing.assert_allclose(got["lam"], want, rtol=1e-4)
        np.testing.assert_array_equal(got["model_lam"], got["lam"][:, :v])
        assert (got["docs_seen"], got["step"], got["batches_seen"]) == (
            docs, step, 3)


# ---- checkpoint dirs across the packages -----------------------------------
def _one_shard_records(ck, v_pad):
    """Every state record of ``ck`` holds one shard over [0, v_pad) with
    ``process_count`` 1: the dir JAX's one process writes."""
    recs = [r for r in EpochLedger(ck).records() if r.get("shards")]
    assert recs
    for rec in recs:
        assert rec["process_count"] == 1
        assert [(s["p"], s["cols"]) for s in rec["shards"]] == [
            (0, [0, v_pad])]
    return recs


def test_grid_dir_resumes_in_jax_bit_for_bit(spec):
    """The dir the port's 2x2 grid wrote (a checkpoint after the second
    trigger and one at the end) resumes in JAX's trainer on a (2, 2)
    mesh: lambda bit-equal to the shard written, the same counters."""
    ranks(spec, (2, 2))
    ck = spec["cases"]["even"]["written"][(2, 2)]
    recs = _one_shard_records(ck, V)
    rec, lam = _shard_lam(ck)
    assert (rec["step"], rec["docs_seen"], len(recs)) == (3, 24, 2)
    copy = os.path.join(spec["root"], "port_dir_copy")
    shutil.copytree(ck, copy)
    with _jax_python_text():
        jt = jax_trainer((2, 2), V, copy)
    np.testing.assert_array_equal(np.asarray(jt.state.lam), lam)
    assert (int(jt.state.step), jt.docs_seen) == (3, 24)


def test_jax_dir_resumes_on_the_grid_bit_for_bit(spec):
    """A dir JAX's trainer wrote on a (2, 2) mesh resumes on the port's
    2x2 grid: every rank's lambda bit-equal to the shard written."""
    jax_run(spec, "even", (2, 2))
    _one_shard_records(os.path.join(spec["root"], "jax_dir"), V)
    rec, lam = _shard_lam(spec["jax_dir"])
    for r in ranks(spec, (2, 2)):
        np.testing.assert_array_equal(r["resumed"]["lam"], lam)
        assert (r["resumed"]["step"], r["resumed"]["docs_seen"],
                r["resumed"]["batches_seen"]) == (
                    rec["step"], rec["docs_seen"], rec["batches_seen"])


# ---- the grid against one device --------------------------------------------
def test_grid_from_a_seed_matches_one_device(spec, monkeypatch):
    """The 2x2 grid from the seed (its draws made whole and sliced; rank 0
    calling ``process(mb)``, the others ``process()``) against the port's
    one-device trainer from the same seed: lambda within rtol 1e-4, the
    same counters."""
    monkeypatch.setattr(tpipeline.TextPreprocessor, "_resolve_backend",
                        lambda self: "python")
    one = StreamingOnlineLDA(Params(k=K, seed=SEED), num_features=V,
                             batch_capacity=CAPACITY, device="cpu")
    for mb in spec["batches"]:
        one.process(mb)
    want = one.lam.numpy()
    for r in ranks(spec, (2, 2)):
        got = r["seeded"]
        np.testing.assert_allclose(got["lam"], want, rtol=1e-4)
        assert (got["docs_seen"], got["step"]) == (one.docs_seen, one.step)


# ---- the CLI ---------------------------------------------------------------
def run(main, argv):
    """(exit code, stdout, stderr) of ``main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_main(argv):
    args = jcli.build_parser().parse_args(argv)
    return args.fn(args)


GRID = ["--data-shards", "2", "--model-shards", "2", "--dist-backend",
        "gloo"]


@pytest.fixture(scope="module")
def books(tmp_path_factory):
    """The port's text library, and ten small books of chip_smoke's recipe
    with their mtimes one second apart in name order."""
    tnative.build()
    root = tmp_path_factory.mktemp("grid_books")
    stop = chip_smoke.en_books_dir(11, str(root), n_books=10,
                                   words=(300, 1500))
    path = str(root / "books")
    for i, name in enumerate(sorted(os.listdir(path))):
        os.utime(os.path.join(path, name), (1e9 + i, 1e9 + i))
    return path, stop, root


def stream_train(books_dir, stop, root, *extra):
    """``stream-train`` of the port's CLI on the CPU: (exit code, stdout,
    stderr, the published model's lambda or None)."""
    models = os.path.join(root, "m")
    rc, so, se = run(tcli.main, [
        "stream-train", "--watch-dir", books_dir, "--stop-words", stop,
        "--k", str(K), "--hash-features", "1024", "--checkpoint-dir",
        os.path.join(root, "ck"), "--checkpoint-interval", "2",
        "--max-files-per-trigger", "4", "--models-dir", models,
        "--poll-interval", "0.01", "--idle-timeout", "0.2", "--device",
        "cpu", *extra])
    lam = None
    if os.path.isdir(models):
        with np.load(os.path.join(latest_model_dir(models, "EN"),
                                  "arrays.npz")) as z:
            lam = z["lam"]
    return rc, so, se, lam


@pytest.fixture(scope="module")
def cli_runs(books):
    path, stop, root = books
    return {name: (stream_train(path, stop, str(root / name), *extra),
                   str(root / name))
            for name, extra in (("1x1", []), ("2x2", GRID))}


def _masked(text, root):
    return re.sub(r"\d+", "#", text.replace(root, "<root>"))


def test_stream_train_cli_grid_matches_one_device(cli_runs):
    """``stream-train --data-shards 2 --model-shards 2 --dist-backend gloo
    --device cpu`` over ten books (three triggers, checkpoints after the
    second and at the end) against the one-device command on the same
    files: exit 0, the published lambda within rtol 1e-4, stdout equal
    with numbers and paths masked, one state shard an epoch."""
    (rc1, out1, err1, lam1), root1 = cli_runs["1x1"]
    (rc2, out2, err2, lam2), root2 = cli_runs["2x2"]
    assert rc1 == 0 and rc2 == 0, err1 + err2
    assert "stream ended: 10 docs / 3 micro-batches" in out2
    np.testing.assert_allclose(lam2, lam1, rtol=1e-4)
    assert _masked(out2, root2) == _masked(out1, root1)
    _one_shard_records(os.path.join(root2, "ck"), 1024)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_resume_at_another_shape_exits_2(cli_runs, books, tmp_path,
                                         package):
    """``stream-train --resume`` at 1x1 on the 2x2 grid's dir exits 2 with
    the config-hash message, in the port's CLI and in the JAX package's
    (the grid's shape is structural); the dir is left as it was."""
    path, stop, _ = books
    ck = os.path.join(cli_runs["2x2"][1], "ck")
    before = open(os.path.join(ck, "epochs.jsonl")).read()
    argv = ["stream-train", "--watch-dir", path, "--stop-words", stop,
            "--k", str(K), "--hash-features", "1024", "--checkpoint-dir",
            ck, "--models-dir", str(tmp_path / "m"), "--resume"]
    handler = signal.getsignal(signal.SIGTERM)
    try:
        if package == "port":
            rc, so, se = run(tcli.main, [*argv, "--device", "cpu"])
        else:
            rc, so, se = run(jax_main, argv)
    finally:
        signal.signal(signal.SIGTERM, handler)
    assert rc == 2
    assert "checkpoint was written by config" in se
    assert not os.path.exists(tmp_path / "m")
    assert open(os.path.join(ck, "epochs.jsonl")).read() == before


GRID_REFUSED = [
    (["--data-shards", "0"], "--data-shards 0 --model-shards 1: shards "
                             "must be >= 1"),
    (["--model-shards", "0"], "--data-shards 1 --model-shards 0: shards "
                              "must be >= 1"),
    (["--data-shards", "2", "--model-shards", "2", "--dist-backend",
      "nccl"], "backend='nccl' takes one rank a card, and 4 ranks share 0 "
               "visible card(s); use backend='gloo'"),
    (["--model-shards", "2", "--dist-backend", "nccl", "--device", "cpu"],
     "backend='nccl' reduces CUDA tensors only; use backend='gloo'"),
]


@pytest.mark.parametrize("argv,message", GRID_REFUSED,
                         ids=[" ".join(a) for a, _ in GRID_REFUSED])
def test_stream_train_grid_flags_that_cannot_run_exit_2(tmp_path, argv,
                                                        message):
    """A grid ``stream-train`` cannot run exits 2 before it touches the
    watch dir, saying why, as ``train`` does; the nccl case keeps the
    default device and counts this host's cards: none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card count differs")
    rc, so, se = run(tcli.main, ["stream-train", "--watch-dir",
                                 str(tmp_path / "none"), *argv])
    assert rc == 2 and so == ""
    assert f"error: {message}" in se
    assert os.listdir(tmp_path) == []


def test_grid_stream_train_defaults_to_the_card(tmp_path):
    """Without a card and without --device cpu, a grid ``stream-train``
    raises before it spawns a rank or touches the watch dir; a trainer
    asked for shards outside a started grid refuses, naming the ranks it
    needs."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["stream-train", "--watch-dir", str(tmp_path / "w"),
                   "--checkpoint-dir", str(tmp_path / "ck"), *GRID])
    assert os.listdir(tmp_path) == []
    with pytest.raises(ValueError, match="not divisible by model_shards"):
        StreamingOnlineLDA(Params(k=2, model_shards=2), num_features=8)


@pytest.mark.parametrize("main", [tcli.main, jax_main],
                         ids=["port", "jax"])
def test_stream_score_takes_no_grid_flags(tmp_path, main):
    """``stream-score`` has no grid flags in either CLI."""
    with pytest.raises(SystemExit) as exc, \
            contextlib.redirect_stderr(io.StringIO()):
        main(["stream-score", "--watch-dir", str(tmp_path),
              "--data-shards", "2"])
    assert exc.value.code == 2


def test_fenced_grid_stream_exits_3(books, tmp_path):
    """A grid worker whose fence token was superseded: rank 0's first
    ledger write raises ``FencedEpochError``, it tells the other rank the
    stream is over, and the command exits 3 with the error, nothing
    committed and no model published."""
    path, stop, _ = books
    fleet = str(tmp_path / "fleet")
    FleetLedger(fleet).append(kind="resize", generation=1, worker_count=1,
                              spawn_ids={0: 5})
    rc, so, se, lam = stream_train(
        path, stop, str(tmp_path), "--model-shards", "2", "--dist-backend",
        "gloo", "--fleet-dir", fleet, "--worker-index", "0",
        "--fleet-generation", "0", "--fleet-spawn-id", "0")
    assert rc == 3 and lam is None
    assert "error: fenced ledger write" in se
    assert EpochLedger(str(tmp_path / "ck")).records() == []


def _env():
    env = dict(os.environ)
    env.pop(faultinject.ENV_SPEC, None)
    env.pop(faultinject.ENV_SEED, None)
    return env


def test_sigterm_reaches_rank_0_and_resume_completes(books, tmp_path):
    """SIGTERM to a grid ``stream-train`` (1x2) is passed on to rank 0:
    the in-flight trigger finishes on both ranks, the epoch commits, the
    command exits 0 without publishing; ``--resume`` then trains the rest
    and every book is committed once."""
    path, stop, _ = books
    ck = str(tmp_path / "ck")
    argv = [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
            "stream-train", "--watch-dir", path, "--stop-words", stop,
            "--k", str(K), "--hash-features", "1024", "--checkpoint-dir",
            ck, "--checkpoint-interval", "1", "--max-files-per-trigger", "1",
            "--models-dir", str(tmp_path / "m"), "--poll-interval", "0.05",
            "--model-shards", "2", "--dist-backend", "gloo", "--device",
            "cpu"]
    proc = subprocess.Popen([*argv, "--idle-timeout", "60"], cwd=REPO,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    ledger = EpochLedger(ck)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not ledger.records():
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert "preemption notice honored" in out
    assert not os.path.exists(tmp_path / "m")
    first = ledger.committed_sources()
    assert first
    done = subprocess.run([*argv, "--idle-timeout", "0.3", "--resume"],
                          cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "model saved to" in done.stdout
    srcs = [s for r in ledger.records() for s in r.get("sources", ())]
    assert len(srcs) == len(set(srcs)) == 10
    assert first <= set(srcs)


def test_supervised_grid_workers_leave_no_rank_behind(books, tmp_path):
    """``supervise --role stream-train`` with two workers, each a 1x2 grid
    (``--worker-arg=--model-shards=2 --worker-arg=--dist-backend=gloo``)
    on the CPU, worker 0 killed at its first commit (rank 0 dies): the
    supervisor respawns it, no process of the killed worker (its command
    or its ranks) is alive once the respawn commits, every book is
    committed once, and each worker publishes a model."""
    path, stop, _ = books
    fleet = str(tmp_path / "fleet")
    with chip_smoke.rank_watch(fleet) as procs:
        r = subprocess.run([
            sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
            "supervise", "--role", "stream-train", "--watch-dir", path,
            "--fleet-dir", fleet, "--workers", "2",
            "--heartbeat-interval", "0.2", "--lease-timeout", "5.0",
            "--grace-seconds", "1.0", "--sweep-interval", "0.15",
            "--poll-interval", "0.05", "--idle-timeout", "0.8",
            "--max-files-per-trigger", "1", "--stop-words", stop,
            "--k", str(K), "--hash-features", "1024",
            "--checkpoint-interval", "1",
            "--chaos-worker", "0:ledger.commit:kill@1",
            "--models-dir", str(tmp_path / "m"), "--device", "cpu",
            "--worker-arg=--model-shards=2",
            "--worker-arg=--dist-backend=gloo"],
            cwd=REPO, env=_env(), capture_output=True, text=True,
            timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    assert re.search(r"1 respawn\(s\)", r.stdout), r.stdout
    chip_smoke.fleet_exactly_once("grid fleet", fleet, path)
    killed = chip_smoke.orphans_after_respawn(fleet, procs, worker=0)
    assert killed["ranks"] >= 2, killed
    assert killed["alive_after_respawn_commit"] == [], killed
    for w in ("w000", "w001"):
        assert latest_model_dir(str(tmp_path / "m" / w), "EN") is not None


def test_ranks_end_with_their_parent(tmp_path):
    """A grid's ranks end when the process that spawned them is SIGKILLed
    (a supervised worker killed after a hang): none is left blocked."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "import torch_grid_stream_worker as w\n"
        "from spark_text_clustering_tpu_torch.parallel import run_grid\n"
        f"run_grid(w.wait_forever, 1, 2, ({str(tmp_path)!r},), "
        "backend='gloo', device='cpu')\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=_env())
    files = [tmp_path / f"rank{r}" for r in range(2)]
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and not all(f.exists()
                                                  for f in files):
        time.sleep(0.05)
    pids = [int(f.read_text()) for f in files]
    proc.kill()
    proc.wait()
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and any(
            chip_smoke.pid_alive(p) for p in pids):
        time.sleep(0.05)
    assert not any(chip_smoke.pid_alive(p) for p in pids)
