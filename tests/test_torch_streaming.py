"""The port's streaming (sources, the streaming scorer and trainer) held
against the JAX package's ``streaming.py`` on the CPU.

Both packages run their Python text path (nltk), so no native library is
built.  The trainer's random draws are the JAX package's, injected
(``init_lam``, ``gamma0_fn``): torch cannot reproduce threefry.  The JAX
step runs its XLA gamma loop on the CPU and the port the padded E-step
kernel's plain version; with one tile of ``batch_capacity`` rows both stop
the batch together.  No test waits on the wall clock: sources are polled,
and ``stream()`` runs with its sleep replaced.
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np
import pytest

from spark_text_clustering_tpu import pipeline as jpipeline
from spark_text_clustering_tpu import streaming as js
from spark_text_clustering_tpu.config import Params as JParams
from spark_text_clustering_tpu.models.base import LDAModel as JLDAModel
from spark_text_clustering_tpu.models.persistence import (
    save_train_state as j_save_state,
)
from spark_text_clustering_tpu.ops.lda_math import init_gamma as j_init_gamma
from spark_text_clustering_tpu.resilience import faultinject as jfault
from spark_text_clustering_tpu.resilience import vocab_fingerprint
from spark_text_clustering_tpu_torch import pipeline as tpipeline
from spark_text_clustering_tpu_torch import streaming as ts
from spark_text_clustering_tpu_torch.config import Params as TParams
from spark_text_clustering_tpu_torch.interop import lda_model_from_numpy
from spark_text_clustering_tpu_torch.resilience import faultinject as tfault

K = 3
WORDS = [f"{a}{b}{c}{d}" for a in "bcdfgklmnprstvz" for b in "aeiu"
         for c in "lmnrst" for d in "aeiou"]     # 1,800 pseudo-words


@pytest.fixture(autouse=True)
def python_text_paths(monkeypatch):
    """Both packages' Python text path; no fault plan armed."""
    monkeypatch.setattr(jpipeline.TextPreprocessor, "_use_native",
                        lambda self: False)
    monkeypatch.setattr(tpipeline.TextPreprocessor, "_resolve_backend",
                        lambda self: "python")
    jfault.configure(None)
    tfault.configure(None)
    yield
    jfault.reset()
    tfault.reset()


def _texts(n, seed, lo=20, hi=160, words=WORDS):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi))))
            + "." for _ in range(n)]


def _mb(mod, batch_id, names, texts):
    return mod.MicroBatch(batch_id, list(names), list(texts))


def _batches(mb_list):
    return [(mb.batch_id, mb.names, mb.texts) for mb in mb_list]


# ---- sources ---------------------------------------------------------------
@pytest.fixture()
def watch_dir(tmp_path):
    """Nine .txt files and one .md with mtimes 100 s apart, out of name
    order, and two files written just now."""
    d = tmp_path / "watch"
    d.mkdir()
    now = time.time()
    order = [4, 1, 7, 0, 8, 2, 6, 3, 5]
    for rank, i in enumerate(order):
        p = d / f"book_{i}.txt"
        p.write_text(f"text of book {i}")
        os.utime(p, (now - 5000 + 100 * rank,) * 2)
    (d / "notes.md").write_text("markdown")
    os.utime(d / "notes.md", (now - 6000,) * 2)
    for name in ("fresh_a.txt", "fresh_b.txt"):
        (d / name).write_text("fresh")
    return str(d)


SOURCE_CASES = {
    "cap3": dict(max_files_per_trigger=3),
    "uncapped": {},
    "min_age": dict(max_files_per_trigger=4, min_file_age_s=600.0),
    "include_all": dict(include_all=True, max_files_per_trigger=5),
    "preseen": dict(max_files_per_trigger=2, preseen="first3"),
}


@pytest.mark.parametrize("case", sorted(SOURCE_CASES))
def test_file_source_micro_batches_match_jax(watch_dir, tmp_path, case):
    """Micro-batch ids, names (oldest first), texts, caps, queue depths,
    min-age deferral and preseen suppression, exactly as the JAX
    package's; the state_path commit log reloads into both packages'
    sources, which then see nothing new."""
    kw = dict(SOURCE_CASES[case])
    if kw.get("preseen") == "first3":
        kw["preseen"] = [os.path.join(watch_dir, f"book_{i}.txt")
                         for i in (4, 1, 7)]
    got = {}
    for name, mod in (("jax", js), ("port", ts)):
        state = str(tmp_path / f"{name}_seen.txt")
        src = mod.FileStreamSource(watch_dir, state_path=state, **kw)
        out, depths = [], []
        while (mb := src.poll()) is not None:
            out.append(mb)
            depths.append(src.last_queue_depth)
        src.commit()
        again = mod.FileStreamSource(watch_dir, state_path=state, **kw)
        got[name] = (_batches(out), depths, again.poll(),
                     open(state).read().splitlines())
    assert got["port"] == got["jax"]
    assert got["port"][0] and got["port"][2] is None
    if case == "min_age":
        assert not any("fresh" in n for _, names, _ in got["port"][0]
                       for n in names)


def test_file_source_stream_and_poll_faults_match_jax(watch_dir, monkeypatch):
    """``stream()`` with its sleep replaced ends after the idle timeout,
    stops at once on a drain notice, and calls its heartbeat each poll; an
    injected poll failure is retried, and a poll that gives up yields an
    empty trigger, in both packages alike."""
    for mod in (js, ts):
        monkeypatch.setattr(mod, "_sleep", lambda s: None)
    got = {}
    for name, mod, fault in (("jax", js, jfault), ("port", ts, tfault)):
        beats = []
        src = mod.FileStreamSource(watch_dir, max_files_per_trigger=4)
        fault.configure("stream.poll:fail@2")
        streamed = _batches(src.stream(poll_interval=0.0, idle_timeout=0.0,
                                       heartbeat=beats.append))
        fault.configure("stream.poll:ioerror@1.0")
        gave_up = mod.FileStreamSource(watch_dir).poll()
        fault.configure(None)
        stopped = list(mod.FileStreamSource(watch_dir).stream(
            stop=lambda: True))
        got[name] = (streamed, beats, gave_up, stopped)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 3 and got["port"][2] is None


def test_memory_source_and_trigger_controller_match_jax():
    """MemoryStreamSource's micro-batches and AIMDTriggerController's caps
    over one sequence of observations are equal."""
    got = {}
    for name, mod in (("jax", js), ("port", ts)):
        src = mod.MemoryStreamSource(max_docs_per_trigger=3)
        src.add(["a", "b", "c", "d"])
        src.add(["e", "f"], names=["x.txt", "y.txt"])
        out = []
        while (mb := src.poll()) is not None:
            out.append((mb.batch_id, mb.names, mb.texts, len(mb),
                        src.last_queue_depth))
        ctl = mod.AIMDTriggerController(target_batch_seconds=1.0,
                                        initial_cap=4, max_cap=6)
        caps = [ctl.update(q, s) for q, s in ((10, 0.5), (10, 0.2),
                                              (10, 0.1), (2, 3.0),
                                              (1, 0.1), (9, 0.4))]
        fsrc = mod.FileStreamSource("/nonexistent")
        ctl.apply(fsrc)
        got[name] = (out, caps, fsrc.max_files)
        with pytest.raises(ValueError):
            mod.AIMDTriggerController(backoff=1.5)
    assert got["port"] == got["jax"]


# ---- the scorer ------------------------------------------------------------
def _models(vocab, seed):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(0.4, 5.0, (K, len(vocab))).astype(np.float32)
    jm = JLDAModel(lam=lam, vocab=list(vocab),
                   alpha=np.full(K, 1.0 / K, np.float32), eta=1.0 / K,
                   algorithm="online")
    tm = lda_model_from_numpy(lam, 1.0 / K, 1.0 / K, vocab,
                              algorithm="online", device="cpu")
    return jm, tm


SCORER_CASES = {"exact": False, "hashed": True}


@pytest.mark.parametrize("case", sorted(SCORER_CASES))
@pytest.mark.parametrize("keep", [True, False], ids=["keep", "no_keep"])
def test_scorer_matches_jax(case, keep):
    """Three triggers (5, 11 and 3 docs; a chunk of 8 pads 3 rows; the
    third brings a longer doc that grows row_len) scored against one
    model: distributions within 5e-3 (the padded scoring tolerance), main
    topics equal wherever the top two differ by more than 1e-2, tallies
    equal; the port's width after every trigger is its last chunk's own
    (the next power of two of its longest doc, a deliberate difference:
    the JAX package pins and only grows it), never wider than the JAX
    package's; with keep_results=False no results are kept and the
    report is empty in both."""
    texts = _texts(16, 1) + [" ".join(WORDS[:300]) + "."] + _texts(2, 2)
    if SCORER_CASES[case]:
        vocab = [f"h{i}" for i in range(2048)]
    else:
        vocab = tpipeline.CountVectorizer().fit(tpipeline.TextPreprocessor(
        ).transform({"texts": texts})).vocab
    jm, tm = _models(vocab, 3)
    jsc = js.StreamingScorer(jm, batch_capacity=8, keep_results=keep)
    tsc = ts.StreamingScorer(tm, batch_capacity=8, keep_results=keep)
    assert tsc.hashed == jsc.hashed == SCORER_CASES[case]
    cuts = [(0, 5), (5, 16), (16, 19)]
    for b, (lo, hi) in enumerate(cuts):
        names = [f"d{i}.txt" for i in range(lo, hi)]
        want = jsc.process(_mb(js, b, names, texts[lo:hi]))
        got = tsc.process(_mb(ts, b, names, texts[lo:hi]))
        last = got[(len(got) - 1) // 8 * 8:]
        assert tsc.row_len == max(8, 1 << (max(len(d.row[0])
                                                for d in last) - 1
                                            ).bit_length())
        assert tsc.row_len <= jsc.row_len
        assert [d.name for d in got] == [d.name for d in want]
        gd = np.stack([d.distribution for d in got])
        wd = np.stack([d.distribution for d in want])
        np.testing.assert_allclose(gd, wd, atol=5e-3)
        top2 = np.sort(wd, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-2
        assert (gd.argmax(1) == wd.argmax(1))[clear].all()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.row[0], w.row[0])
    assert tsc.row_len > 128 and tsc.batches_seen == jsc.batches_seen == 3
    np.testing.assert_array_equal(tsc.tallies, jsc.tallies)
    assert len(tsc.results) == len(jsc.results) == (19 if keep else 0)
    if not keep:
        assert tsc.report() == jsc.report()


def test_scorer_quarantines_failing_docs_alike(tmp_path, monkeypatch):
    """A document whose vectorization raises, and a chunk whose scoring
    raises, go to the quarantine in both packages under the same names;
    the stream goes on."""
    texts = _texts(5, 4)
    texts[2] = "POISON " + texts[2]
    vocab = [f"h{i}" for i in range(512)]
    got = {}
    for name, mod, model in (("jax", js, _models(vocab, 5)[0]),
                             ("port", ts, _models(vocab, 5)[1])):
        sc = mod.StreamingScorer(model, batch_capacity=2,
                                 quarantine_dir=str(tmp_path / name))
        rows_for = sc._rows_for

        def picky(tokens, rows_for=rows_for):
            if any(t.lower() == "poison" for doc in tokens for t in doc):
                raise ValueError("poisoned doc")
            return rows_for(tokens)

        sc._rows_for = picky
        first = sc.process(_mb(mod, 0, [f"n{i}" for i in range(5)], texts))
        score = model.topic_distribution

        def broken(batch, *a, **k):
            raise RuntimeError("device fault")

        model.topic_distribution = broken
        second = sc.process(_mb(mod, 1, ["m0", "m1", "m2"], texts[:2] + [
            texts[3]]))
        model.topic_distribution = score
        got[name] = ([d.name for d in first], second, sc.quarantine.count,
                     sorted(os.listdir(tmp_path / name)))
    assert got["port"] == got["jax"]
    assert got["port"][2] == 4


@pytest.mark.parametrize("fault", ["kernel", "accelerator"])
def test_scorer_lets_a_card_failure_through(tmp_path, fault):
    """A kernel that fails to build or launch (``KernelError``), or a CUDA
    error of the card, is no fault of the documents: the port's scorer
    raises it, quarantining nothing, so a fleet worker exits non-zero and
    its supervisor sees a crash."""
    import torch

    from spark_text_clustering_tpu_torch.ops import _build

    err = (_build.KernelError("gamma_fixed_point_bkl: CUDA error 700")
           if fault == "kernel" else torch.AcceleratorError("CUDA error"))
    model = _models([f"h{i}" for i in range(512)], 5)[1]
    sc = ts.StreamingScorer(model, batch_capacity=2,
                            quarantine_dir=str(tmp_path / "q"))

    def broken(batch, *a, **k):
        raise err

    model.topic_distribution = broken
    with pytest.raises(type(err), match="CUDA error"):
        sc.process(_mb(ts, 0, ["n0", "n1"], _texts(2, 4)))
    assert sc.quarantine.count == 0 and sc.tallies.sum() == 0


# ---- the trainer -----------------------------------------------------------
def _jax_draws(seed):
    key = jax.random.PRNGKey(seed)

    def gamma0(step, n):
        return np.asarray(j_init_gamma(jax.random.fold_in(key, step), n, K,
                                       100.0))
    return gamma0


def _trainers(case, tmp_path=None, seed=4, **kw):
    """The JAX package's trainer and the port's on one vocabulary and one
    set of draws (JAX's lambda0 and gamma inits injected into the
    port)."""
    if case == "hashed":
        vocab_kw = dict(num_features=4096)
    else:
        vocab_kw = dict(vocab=sorted(WORDS))
    jp = dict(k=K, seed=seed)
    tp = dict(k=K, seed=seed)
    if tmp_path is not None:
        jp["checkpoint_dir"] = str(tmp_path / "jax")
        tp["checkpoint_dir"] = str(tmp_path / "port")
    jt = js.StreamingOnlineLDA(JParams(**jp), batch_capacity=8, **vocab_kw,
                               **kw)
    tt = ts.StreamingOnlineLDA(TParams(**tp), batch_capacity=8, **vocab_kw,
                               device="cpu", init_lam=np.asarray(jt.state.lam),
                               gamma0_fn=_jax_draws(seed), **kw)
    return jt, tt


def _feed(trainers, triggers, start=0):
    for b, texts in enumerate(triggers, start):
        names = [f"b{b}_{i}.txt" for i in range(len(texts))]
        for t in trainers:
            t.process(_mb(js if isinstance(t, js.StreamingOnlineLDA) else ts,
                          b, names, texts))


def _lam_of(t):
    if isinstance(t, js.StreamingOnlineLDA):
        return np.asarray(t.state.lam), int(t.state.step)
    return t.lam.numpy(), t.step


TRIGGERS = [_texts(6, 10), _texts(11, 11) + [""],
            _texts(3, 12, 3000, 4000)]


@pytest.mark.parametrize("case", ["hashed", "vocab"])
def test_trainer_matches_jax(case):
    """Three micro-batches (6 docs; 11 and an empty one, two chunks; 3
    long docs that grow row_len) from JAX's lambda0 and gamma inits:
    lambda within rtol 1e-4 (the online tolerance); docs_seen, step,
    batches_seen and row_len equal; the models' lambda, alpha and eta
    equal."""
    jt, tt = _trainers(case)
    _feed((jt, tt), TRIGGERS)
    (jl, jstep), (tl, tstep) = _lam_of(jt), _lam_of(tt)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert (tt.docs_seen, tstep, tt.batches_seen, tt.row_len) == (
        jt.docs_seen, jstep, jt.batches_seen, jt.row_len) == (20, 4, 3, 2048)
    jm, tm = jt.model(), tt.model()
    assert tm.vocab == jm.vocab and tm.step == jm.step
    np.testing.assert_allclose(tm.lam, np.asarray(jm.lam), rtol=1e-4)
    np.testing.assert_array_equal(tm.alpha, np.asarray(jm.alpha))
    assert tm.eta == pytest.approx(jm.eta) and tm.algorithm == "online"


@pytest.mark.parametrize("writer", ["jax", "port", "legacy"])
def test_resume_across_packages(tmp_path, writer):
    """A checkpoint dir after two micro-batches, resumed by the other
    package for the third: lambda within rtol 1e-4 of the JAX package's
    uninterrupted three, the counters equal.  ``legacy``: a pre-ledger
    stream_state.npz resumes in both packages alike."""
    case = "hashed"
    ref, _ = _trainers(case)
    _feed((ref,), TRIGGERS)
    jt, tt = _trainers(case, tmp_path)
    first = {"jax": jt, "port": tt, "legacy": jt}[writer]
    _feed((first,), TRIGGERS[:2])
    first.checkpoint()
    src = str(tmp_path / ("jax" if first is jt else "port"))
    dst = {"jax": "port", "port": "jax"}.get(writer, "both")
    if writer == "legacy":
        lam, step = _lam_of(jt)
        for name in ("jax", "port"):
            d = tmp_path / f"legacy_{name}"
            j_save_state(str(d / "stream_state.npz"), step, lam=lam,
                         docs_seen=np.int64(jt.docs_seen),
                         batches_seen=np.int64(jt.batches_seen),
                         vocab_fp=np.int64(vocab_fingerprint(
                             [f"h{i}" for i in range(4096)])))
    resumed = []
    for name in (("jax", "port") if dst == "both" else (dst,)):
        ck = (str(tmp_path / f"legacy_{name}") if writer == "legacy"
              else src)
        if name == "jax":
            t = js.StreamingOnlineLDA(JParams(k=K, seed=4,
                                              checkpoint_dir=ck),
                                      batch_capacity=8, num_features=4096)
        else:
            t = ts.StreamingOnlineLDA(TParams(k=K, seed=4,
                                              checkpoint_dir=ck),
                                      batch_capacity=8, num_features=4096,
                                      device="cpu",
                                      gamma0_fn=_jax_draws(4))
        assert (t.docs_seen, t.batches_seen) == (first.docs_seen, 2)
        _feed((t,), TRIGGERS[2:], start=2)
        resumed.append(t)
    want, want_step = _lam_of(ref)
    for t in resumed:
        lam, step = _lam_of(t)
        np.testing.assert_allclose(lam, want, rtol=1e-4)
        assert (t.docs_seen, step, t.batches_seen) == (
            ref.docs_seen, want_step, ref.batches_seen)


def test_run_commits_sources_alike(tmp_path):
    """``run`` over a MemoryStreamSource (two docs a trigger, a checkpoint
    every second micro-batch and one at the end): the two ledgers hold the
    same records with ``ts`` and digests masked, and the same committed
    sources; a second run on the same dir commits nothing new."""
    jt, tt = _trainers("hashed", tmp_path, checkpoint_every=2)
    texts = _texts(7, 20)
    recs = {}
    for name, t, mod in (("jax", jt, js), ("port", tt, ts)):
        src = mod.MemoryStreamSource(max_docs_per_trigger=2)
        src.add(texts)
        t.run(src)
        assert t.checkpoint() is False
        recs[name] = t.ledger.records()
    for rec in (*recs["jax"], *recs["port"]):
        rec.pop("ts"), rec.pop("checksum")
        for s in rec["shards"]:
            s.pop("sha256")
    assert recs["port"] == recs["jax"]
    assert [r["step"] for r in recs["port"]] == [2, 4]
    assert tt.ledger.committed_sources() == {f"doc-{i}" for i in range(7)}
    np.testing.assert_allclose(_lam_of(tt)[0], _lam_of(jt)[0], rtol=1e-4)


def test_trainer_refuses_what_jax_refuses(tmp_path):
    """Exactly one of vocab/num_features; a checkpoint of another
    vocabulary of the same size is refused; shards name ROADMAP item 7c.
    (A fleet partition, refused until the fleet was ported, is held to
    the JAX package's in ``test_torch_supervisor.py``.)"""
    with pytest.raises(ValueError, match="exactly one"):
        ts.StreamingOnlineLDA(TParams(k=K), device="cpu")
    _, tt = _trainers("vocab", tmp_path)
    _feed((tt,), TRIGGERS[:1])
    tt.checkpoint()
    other = [w + "x" for w in sorted(WORDS)]
    for mod, params, extra in ((js, JParams, {}), (ts, TParams,
                                                   {"device": "cpu"})):
        with pytest.raises(ValueError, match="DIFFERENT vocabulary"):
            mod.StreamingOnlineLDA(
                params(k=K, checkpoint_dir=str(tmp_path / "port")),
                vocab=other, **extra)
    with pytest.raises(NotImplementedError, match="item 7c"):
        ts.StreamingOnlineLDA(TParams(k=K, model_shards=2),
                              num_features=8, device="cpu")
