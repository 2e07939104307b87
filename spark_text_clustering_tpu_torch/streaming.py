"""Micro-batch streaming: sources, the streaming scorer and the streaming
trainer (the JAX package's ``streaming.py``).

A stream is a host-side source yielding micro-batches of documents.  Each
trigger packs its documents into ``[batch_capacity, row_len]``
``DocTermBatch`` chunks of pinned rows, pad rows included, so the scorer's
convergence test sees the same batch-mates as the JAX package's and every
chunk is one launch of the padded E-step kernel on the card.

* Sources: ``FileStreamSource`` (each ``poll()`` returns the files of a
  watched directory not yet seen, up to ``max_files_per_trigger``, oldest
  first) and ``MemoryStreamSource`` (documents enqueued by the caller).
  ``AIMDTriggerController`` adapts a source's cap from each trigger's
  queue depth and seconds.
* ``StreamingScorer``: each micro-batch vectorized over the model's
  vocabulary (counts, or murmur3 buckets for a hashed model) and scored
  by ``LDAModel.topic_distribution`` on those chunks; per-topic tallies
  and report rows accumulate.
* ``StreamingOnlineLDA``: continuous online VB, one ``padded_iteration``
  a chunk (on a grid, each rank's block of its rows), the corpus size the
  running count of documents seen; state
  checkpointed through the epoch commit ledger (``resilience.ledger``)
  with the JAX package's records and shard files, so a checkpoint dir
  either package wrote resumes in the other.

The trainer also runs on a (data, model) grid of ranks (``parallel``),
rank 0 reading the source and sharing each micro-batch.  Every trigger
reports through ``telemetry`` under the JAX package's names: the
``stream.score_batch`` / ``stream.train_batch`` spans, the
``stream.{score,train}.micro_batch_seconds`` histograms, one
``micro_batch`` event stamped with the trace context, a memory sample, and
the ``stream.queue_depth`` / ``stream.trigger_cap`` gauges.  A supervised
fleet of stream workers (``resilience.supervisor``) gives each worker a
``FileStreamSource`` partition and a fenced ledger.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import telemetry
from .config import Params
from .device import resolve_device
from .models.base import LDAModel
from .models.online_lda import _GAMMA_KEY, _LAMBDA_KEY, padded_iteration
from .models.persistence import load_train_state
from .ops import _build
from .ops.lda_math import init_gamma, init_lambda, seeded_generator
from .ops.sparse import batch_from_rows, next_pow2, pad_rows
from .parallel.collectives import data_shard_rows, fetch_global
from .parallel.mesh import MODEL_AXIS, agree_ledger_epoch, make_grid
from .pipeline import TextPreprocessor, is_hashed_vocab, make_vectorizer
from .resilience import (
    CorruptArtifactError,
    EpochLedger,
    Quarantine,
    RetryGiveUp,
    faultinject,
    file_sha256,
    retry_call,
    shard_filename,
    shard_span,
    validate_shard_plan,
)
from .resilience.resume import vocab_fingerprint as _vocab_fingerprint
from .resilience.supervisor import partition_of
from .resilience.retry import sleep as _sleep
from .telemetry import tracing
from .utils.report import format_scoring_report, write_scoring_report

# one micro-batch's update, under the JAX package's label: the step, its
# docs and the corpus size ride as tensors, so every trigger of one width
# shares a signature
_online_step = telemetry.instrument_dispatch(
    "stream.online_step",
    lambda lam, step_docs, ids, wts, gamma0, corpus, **kw: padded_iteration(
        lam, int(step_docs[0]), ids, wts, gamma0, int(step_docs[1]),
        corpus_size=float(corpus), **kw))

__all__ = [
    "AIMDTriggerController",
    "FileStreamSource",
    "MemoryStreamSource",
    "MicroBatch",
    "ScoredDoc",
    "StreamingOnlineLDA",
    "StreamingScorer",
]


class AIMDTriggerController:
    """Adaptive ``max_files_per_trigger``: additive increase while the
    source backs up with latency to spare, multiplicative decrease when a
    trigger overruns ``target_batch_seconds``.  The consumer measures each
    trigger, calls ``update`` and applies the returned cap to its
    source."""

    def __init__(
        self,
        *,
        target_batch_seconds: float = 2.0,
        initial_cap: int = 8,
        min_cap: int = 1,
        max_cap: int = 1024,
        increase: int = 1,
        backoff: float = 0.5,
    ) -> None:
        if target_batch_seconds <= 0:
            raise ValueError("target_batch_seconds must be > 0")
        if not (0.0 < backoff < 1.0):
            raise ValueError("backoff must be in (0, 1)")
        self.target = float(target_batch_seconds)
        self.min_cap = max(1, int(min_cap))
        self.max_cap = max(self.min_cap, int(max_cap))
        self.increase = max(1, int(increase))
        self.backoff = float(backoff)
        self.cap = min(self.max_cap, max(self.min_cap, int(initial_cap)))

    def update(self, queue_depth: int, batch_seconds: float) -> int:
        """One AIMD step from the latest trigger; returns the new cap."""
        if batch_seconds > self.target:
            self.cap = max(self.min_cap, int(self.cap * self.backoff))
        elif queue_depth > self.cap:
            # a true backlog with latency headroom: one step wider
            self.cap = min(self.max_cap, self.cap + self.increase)
        telemetry.gauge("stream.trigger_cap", self.cap)
        return self.cap

    def apply(self, source) -> None:
        """Push the current cap onto a source that takes one."""
        if hasattr(source, "max_files"):
            source.max_files = self.cap


@dataclass
class MicroBatch:
    """One trigger's worth of raw documents."""

    batch_id: int
    names: List[str]       # display names / paths
    texts: List[str]

    def __len__(self) -> int:
        return len(self.texts)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------
class FileStreamSource:
    """Directory-watching source: each ``poll()`` returns a micro-batch of
    the files that appeared since the last trigger (ordered by mtime, then
    path, capped at ``max_files_per_trigger``), or None.

    Files are keyed by path: a rewritten file is not emitted again.
    Producers should drop files atomically (write elsewhere, rename into
    the directory); where they cannot, ``min_file_age_s`` defers a file
    until its mtime has settled that long.

    Source progress: ``poll()`` only stages paths; ``commit()`` appends
    the staged ones to ``state_path`` once the consumer has accounted for
    them, and a new source reads that file back into its seen-set.  A
    ledgered stream passes its committed sources as ``preseen`` instead.

    ``partition=(index, count)`` restricts the source to a fleet worker's
    files: those whose basename ``partition_of`` assigns to ``index``.
    """

    def __init__(
        self,
        directory: str,
        *,
        suffix: str = ".txt",
        include_all: bool = False,
        max_files_per_trigger: Optional[int] = None,
        encoding: str = "utf-8",
        min_file_age_s: float = 0.0,
        state_path: Optional[str] = None,
        preseen: Optional[Sequence[str]] = None,
        partition: Optional[Tuple[int, int]] = None,
    ) -> None:
        self.directory = directory
        self.suffix = suffix
        self.include_all = include_all
        self.max_files = max_files_per_trigger
        self.encoding = encoding
        self.min_file_age_s = min_file_age_s
        self.state_path = state_path
        self.partition = partition
        self._seen: set = set(preseen or ())
        self._pending: List[str] = []
        self._next_id = 0
        # new-but-unconsumed files the last poll() saw: the queue depth
        self.last_queue_depth = 0
        if state_path and os.path.exists(state_path):
            with open(state_path, "r", encoding="utf-8") as f:
                self._seen |= {
                    line.rstrip("\n") for line in f if line.strip()
                }

    def commit(self) -> None:
        """Durably record every path staged since the last commit (the
        append is retried under the I/O policy; a persistent failure
        raises)."""
        if not self.state_path or not self._pending:
            return

        def _append() -> None:
            os.makedirs(
                os.path.dirname(self.state_path) or ".", exist_ok=True
            )
            with open(self.state_path, "a", encoding="utf-8") as f:
                for p in self._pending:
                    f.write(p + "\n")
                f.flush()
                os.fsync(f.fileno())

        retry_call(_append, site="source.commit")
        self._pending.clear()

    def _list_new(self) -> List[str]:
        try:
            entries = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for name in sorted(entries):
            if not self.include_all and not name.endswith(self.suffix):
                continue
            if self.partition is not None:
                idx, count = self.partition
                if partition_of(name, count) != idx:
                    continue
            p = os.path.join(self.directory, name)
            if os.path.isfile(p) and p not in self._seen:
                out.append(p)

        def mtime_or_inf(p: str) -> float:
            # a writer may unlink or rename a file after the listing
            try:
                return os.path.getmtime(p)
            except OSError:
                return float("inf")

        if self.min_file_age_s > 0:
            settled = time.time() - self.min_file_age_s
            out = [p for p in out if mtime_or_inf(p) <= settled]
        out.sort(key=lambda p: (mtime_or_inf(p), p))
        return out

    def poll(self) -> Optional[MicroBatch]:
        # the listing is retried; a poll that exhausts the policy yields
        # an empty trigger and the next one starts afresh
        def _list() -> List[str]:
            faultinject.check("stream.poll")
            return self._list_new()

        try:
            new = retry_call(_list, site="stream.poll")
        except RetryGiveUp:
            telemetry.event("stream_poll_giveup", directory=self.directory)
            return None
        self.last_queue_depth = len(new)
        telemetry.gauge("stream.queue_depth", len(new))
        if not new:
            return None
        if self.max_files is not None:
            new = new[: self.max_files]
        names, texts = [], []
        for p in new:
            # an unreadable file is skipped without being marked seen, so
            # the next trigger tries it again
            try:
                with open(
                    p, "r", encoding=self.encoding, errors="replace"
                ) as f:
                    texts.append(f.read())
            except OSError:
                continue
            names.append(p)
        if not names:
            return None
        self._seen.update(names)
        self._pending.extend(names)
        mb = MicroBatch(self._next_id, names, texts)
        self._next_id += 1
        return mb

    def stream(
        self,
        poll_interval: float = 1.0,
        idle_timeout: Optional[float] = 30.0,
        heartbeat=None,
        stop=None,
    ) -> Iterator[MicroBatch]:
        """Micro-batches until ``idle_timeout`` seconds pass without new
        data (None: forever).  ``heartbeat(queue_depth)`` is called once a
        poll; ``stop()`` is checked before each poll, so a preemption
        notice ends the stream after the in-flight trigger."""
        last_data = time.monotonic()
        while True:
            if stop is not None and stop():
                return
            mb = self.poll()
            if heartbeat is not None:
                heartbeat(self.last_queue_depth)
            if mb is not None:
                last_data = time.monotonic()
                yield mb
                continue
            if (
                idle_timeout is not None
                and time.monotonic() - last_data >= idle_timeout
            ):
                return
            _sleep(poll_interval)


class MemoryStreamSource:
    """In-memory source for tests and programmatic feeds: ``add()``
    enqueues documents, ``poll()`` drains one micro-batch."""

    def __init__(self, max_docs_per_trigger: Optional[int] = None) -> None:
        self.max_docs = max_docs_per_trigger
        self._queue: List[Tuple[str, str]] = []
        self._next_id = 0
        self._docs_added = 0    # monotonic: auto-names never collide
        self.last_queue_depth = 0

    def add(self, texts: Sequence[str], names: Optional[Sequence[str]] = None):
        if names is None:
            names = [
                f"doc-{self._docs_added + i}" for i in range(len(texts))
            ]
        self._docs_added += len(texts)
        self._queue.extend(zip(names, texts))

    def poll(self) -> Optional[MicroBatch]:
        self.last_queue_depth = len(self._queue)
        telemetry.gauge("stream.queue_depth", len(self._queue))
        if not self._queue:
            return None
        n = len(self._queue) if self.max_docs is None else self.max_docs
        take, self._queue = self._queue[:n], self._queue[n:]
        mb = MicroBatch(
            self._next_id, [n_ for n_, _ in take], [t for _, t in take]
        )
        self._next_id += 1
        return mb


def _vectorize_texts(pre: TextPreprocessor, rows_for, texts: Sequence[str]):
    """The one preprocessing -> rows path of scorer and trainer."""
    return rows_for(pre.transform({"texts": list(texts)})["tokens"])


def _vectorize_quarantined(
    pre: TextPreprocessor,
    rows_for,
    mb: MicroBatch,
    quarantine: Quarantine,
    stage: str,
):
    """Vectorize a micro-batch with per-document fault isolation: one
    whole-batch transform, and where it raises, one document at a time,
    each failing document to the quarantine.  Returns aligned ``(names,
    texts, rows)`` of the documents that survive."""
    try:
        rows = _vectorize_texts(pre, rows_for, mb.texts)
        return list(mb.names), list(mb.texts), rows
    except Exception:
        names, texts, rows = [], [], []
        for name, text in zip(mb.names, mb.texts):
            try:
                (row,) = _vectorize_texts(pre, rows_for, [text])
            except Exception as exc:
                quarantine.put(
                    name, text, exc, stage=stage, batch_id=mb.batch_id
                )
                continue
            names.append(name)
            texts.append(text)
            rows.append(row)
        return names, texts, rows


# ---------------------------------------------------------------------------
# Streaming scorer
# ---------------------------------------------------------------------------
# Failures of the card rather than of a document's data.
_DEVICE_FAULTS = (_build.KernelError,
                  getattr(torch, "AcceleratorError", _build.KernelError))


@dataclass
class ScoredDoc:
    name: str
    topic: int
    distribution: np.ndarray            # [k]
    row: Tuple[np.ndarray, np.ndarray]  # (ids, weights) over the model vocab


class StreamingScorer:
    """Score micro-batches against a trained model, accumulating results.

    Per trigger: preprocess on the host, vectorize over the model's
    vocabulary (raw counts, no IDF, as ``score``), score each chunk of
    ``batch_capacity`` documents as one ``[batch_capacity, row_len]``
    batch, pad rows included, through ``model.topic_distribution`` (on
    the model's device: the E-step kernel on the card), tally argmax
    topics.  Each
    chunk is as wide as the next power of two of its longest document (at
    least ``row_len`` when one is given), so a document's distribution
    depends on its chunk alone and not on what the stream scored before:
    a fleet worker that is respawned, or takes over another's files after
    a resize, writes the reports an uninterrupted run writes, byte for
    byte.  (The JAX package pins the width on the first trigger and only
    grows it, to reuse one XLA compilation; a hand kernel has none to
    reuse.)  ``row_len`` afterwards is the last chunk's width.

    A chunk whose scoring raises goes to the quarantine, as in the JAX
    package, unless the card failed (a kernel that did not build or
    launch, a CUDA error): that raises, so a fleet worker exits non-zero
    and its supervisor sees a crash instead of a stream that quarantines
    every document.
    """

    def __init__(
        self,
        model,
        *,
        stop_words: frozenset = frozenset(),
        lemmatize: bool = True,
        batch_capacity: int = 8,
        row_len: Optional[int] = None,
        keep_results: bool = True,
        quarantine_dir: Optional[str] = None,
    ) -> None:
        self.model = model
        self.pre = TextPreprocessor(stop_words=stop_words, lemmatize=lemmatize)
        self.quarantine = Quarantine(quarantine_dir)
        self.hashed = is_hashed_vocab(model.vocab)
        self._rows_for = make_vectorizer(model.vocab)
        self.batch_capacity = batch_capacity
        self.min_row_len = row_len or 8
        self.row_len = row_len
        self.tallies = np.zeros(model.k, np.int64)
        # keep_results=False keeps only the tallies (constant memory for
        # endless streams); process() still returns each trigger's docs
        self.keep_results = keep_results
        self.results: List[ScoredDoc] = []
        self.batches_seen = 0

    def process(self, mb: MicroBatch) -> List[ScoredDoc]:
        t0 = time.perf_counter()
        with telemetry.span("stream.score_batch", emit=False):
            out = self._score(mb)
        dt = time.perf_counter() - t0
        telemetry.observe("stream.score.micro_batch_seconds", dt)
        telemetry.event(
            "micro_batch", role="score", batch_id=mb.batch_id,
            docs=len(mb), seconds=round(dt, 6), **tracing.fields(),
        )
        # a trigger boundary is a memory sample point
        telemetry.sample_memory("stream.score")
        return out

    def _score(self, mb: MicroBatch) -> List[ScoredDoc]:
        all_names, all_texts, rows = _vectorize_quarantined(
            self.pre, self._rows_for, mb, self.quarantine, "vectorize"
        )
        out: List[ScoredDoc] = []
        for at in range(0, len(rows), self.batch_capacity):
            chunk = rows[at : at + self.batch_capacity]
            names = all_names[at : at + self.batch_capacity]
            max_nnz = max((len(i) for i, _ in chunk), default=1)
            self.row_len = max(self.min_row_len, next_pow2(max_nnz))
            batch = batch_from_rows(
                pad_rows(chunk, self.batch_capacity), row_len=self.row_len
            )
            try:
                dist = self.model.topic_distribution(batch)[: len(chunk)]
            except _DEVICE_FAULTS:
                raise   # the card failed, not the documents: stop here
            except Exception as exc:
                # a score-time failure: the chunk's docs to the
                # quarantine, and the stream goes on
                for name, text in zip(
                    names, all_texts[at : at + self.batch_capacity]
                ):
                    self.quarantine.put(
                        name, text, exc, stage="score", batch_id=mb.batch_id
                    )
                continue
            for name, d, row in zip(names, dist, chunk):
                sd = ScoredDoc(name, int(np.argmax(d)), np.asarray(d), row)
                self.tallies[sd.topic] += 1
                out.append(sd)
        if self.keep_results:
            self.results.extend(out)
        self.batches_seen += 1
        return out

    def report(self) -> str:
        """The accumulated report in the golden ``Result_<lang>_*``
        format."""
        return format_scoring_report(
            self.model,
            [r.name for r in self.results],
            np.stack([r.distribution for r in self.results])
            if self.results
            else np.zeros((0, self.model.k)),
            [r.row for r in self.results],
        )

    def write_report(self, output_dir: str, lang: str) -> str:
        return write_scoring_report(self.report(), output_dir, lang)


# ---------------------------------------------------------------------------
# Streaming trainer
# ---------------------------------------------------------------------------
class StreamingOnlineLDA:
    """Continuous online-VB LDA over a micro-batch stream, on one device
    or on a (data, model) grid of ranks.

    Each chunk of ``batch_capacity`` nonempty documents is one online
    update (``models.online_lda.padded_iteration``: the padded E-step
    kernel on the card), its rows padded to ``[batch_capacity, row_len]``
    (``row_len`` from 1024, grown to the next power of two by a longer
    document); the corpus size in ``lambda_hat = eta + (D/|B|) sstats`` is
    ``max(docs seen, corpus_size_hint)``.

    The vocabulary is fixed up front: an explicit ``vocab`` or hashing
    into ``num_features`` buckets.  Random draws come from CPU
    ``torch.Generator``s seeded from ``params.seed``, so a run on the
    card and one on the CPU start alike: lambda0 [k, V_pad] from (seed,
    0xFFFF), step t's gamma inits [batch_capacity, k] from (seed, 0x6A33,
    t), the keys of ``OnlineLDA``.  ``init_lam`` and ``gamma0_fn(step,
    n)`` replace them (the JAX package's threefry draws, say); both are
    numpy-valued and whole (every column, every row of the chunk).

    On a ``grid`` (a ``parallel.ProcessGrid``; without one, a ``params``
    that asks for shards takes the grid of the started world), as the JAX
    package's trainer on a mesh: lambda is kept at V_pad = ceil(V / M) M
    columns, each rank holding its vocabulary shard [k, V_pad / M];
    ``batch_capacity`` is rounded up to a multiple of the data shards, and
    each chunk is cut into consecutive blocks, one a data shard, with the
    gamma inits of its rows.  Both draws are made whole and sliced, so a
    grid starts from the draws of one device.  Rank 0 alone reads the
    source and runs the text front end: ``process(mb)`` and ``run(source)``
    on rank 0 share each micro-batch's names and nonempty rows with the
    other ranks (one broadcast), where ``process()`` and ``run()`` receive
    them, so every rank counts the same documents, steps and checkpoints.

    With ``params.checkpoint_dir`` the state (lambda, step, docs and
    micro-batches seen, the vocabulary fingerprint) commits through the
    epoch ledger every ``checkpoint_every`` micro-batches and at the end
    of ``run``; a new trainer on the dir resumes from the newest committed
    shard set, or from a pre-ledger ``stream_state.npz``.  On a grid every
    rank joins the fetch of lambda, and rank 0 alone recovers the ledger
    and commits one shard over [0, V_pad) with ``process_count`` 1: the
    dir the JAX package's one process writes over its mesh, which either
    package resumes at the same shape.
    """

    def __init__(
        self,
        params: Params,
        *,
        vocab: Optional[List[str]] = None,
        num_features: Optional[int] = None,
        stop_words: frozenset = frozenset(),
        lemmatize: bool = True,
        batch_capacity: int = 8,
        row_len: int = 1024,
        corpus_size_hint: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        quarantine_dir: Optional[str] = None,
        device="cuda",
        init_lam: Optional[np.ndarray] = None,
        gamma0_fn: Optional[Callable[[int, int], np.ndarray]] = None,
        fence=None,
        grid=None,
    ) -> None:
        if (vocab is None) == (num_features is None):
            raise ValueError("exactly one of vocab / num_features required")
        if params.algorithm != "online":
            params = params.replace(algorithm="online")
        if grid is None and (params.model_shards != 1
                             or params.data_shards not in (None, 1)):
            grid = make_grid(params.data_shards, params.model_shards,
                             device=device)
        if grid is not None:
            device = grid.device
        self.grid = grid if grid is not None and grid.size > 1 else None
        self._leader = self.grid is None or self.grid.rank == 0
        self.params = params
        self.device = resolve_device(device)
        self.pre = TextPreprocessor(stop_words=stop_words, lemmatize=lemmatize)
        self.quarantine = Quarantine(quarantine_dir)
        if vocab is not None:
            self.vocab = list(vocab)
            self.num_features = None
        else:
            self.num_features = num_features
            self.vocab = [f"h{i}" for i in range(num_features)]
        self._rows_for = make_vectorizer(self.vocab)
        self._v = len(self.vocab)
        n_data, n_model = ((1, 1) if self.grid is None else
                           (self.grid.data_shards, self.grid.model_shards))
        self._v_pad = -(-self._v // n_model) * n_model
        self._shard_v = self._v_pad // n_model
        self.batch_capacity = -(-batch_capacity // n_data) * n_data
        self.row_len = row_len
        self.corpus_size_hint = corpus_size_hint
        self.checkpoint_every = checkpoint_every
        self.docs_seen = 0
        self.batches_seen = 0
        self.step = 0
        # how the last ``run`` ended: on its ``stop()`` (a preemption
        # notice), or, off rank 0, because rank 0 failed
        self.stopped = False
        self.aborted = False
        self._busy = False          # inside a collective of the update
        k = params.k
        self._alpha = np.full((k,), params.resolved_alpha(), np.float32)
        self._alpha_dev = torch.from_numpy(self._alpha).to(self.device)
        self._gamma0_fn = gamma0_fn

        # ``fence``: a supervised fleet worker's token
        # (``resilience.supervisor.FleetFence``), verified before every
        # ledger write, so a worker superseded by a respawn or a resize
        # stops with ``FencedEpochError`` instead of committing
        self.ledger = (
            EpochLedger(params.checkpoint_dir,
                        fence=fence if self._leader else None)
            if params.checkpoint_dir else None
        )
        self._pending_sources: List[str] = []
        self._last_committed_step = -1
        self._ckpt_path = (
            os.path.join(params.checkpoint_dir, "stream_state.npz")
            if params.checkpoint_dir else None
        )
        if self.ledger is not None:
            if self._leader:
                # a consistent dir before reading it: torn appends
                # truncated, uncommitted payloads quarantined
                self.ledger.recover()
            if self.grid is not None:
                # no rank reads the ledger while rank 0 rolls it back, and
                # a rank that reads another epoch raises
                dist.barrier()
                agree_ledger_epoch(params.checkpoint_dir)
        # the resume point: the newest committed epoch carrying state
        # shards (model-publish records carry none)
        resume_rec = None
        if self.ledger is not None:
            for rec in self.ledger.records():
                if rec.get("shards"):
                    resume_rec = rec
        if resume_rec is not None:
            lam = self._restore_ledger(resume_rec)
        elif self._ckpt_path and os.path.exists(self._ckpt_path):
            lam = self._restore()             # the pre-ledger format
        else:
            if init_lam is None:
                lam = init_lambda(
                    seeded_generator("cpu", params.seed, _LAMBDA_KEY), k,
                    self._v_pad, params.gamma_shape).numpy()
            else:
                lam = np.array(init_lam, np.float32).reshape(k, self._v_pad)
            self._last_committed_step = 0
        lo = 0 if self.grid is None else self.grid.m * self._shard_v
        self.lam = torch.from_numpy(np.ascontiguousarray(
            lam[:, lo:lo + self._shard_v])).to(self.device)

    # -- the grid's messages ---------------------------------------------
    def _share(self, msg=None):
        """Rank 0's ``msg`` on every rank: one broadcast of the pickled
        object over the grid."""
        box = [msg]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _tell(self, *msg) -> None:
        """Rank 0: ``msg`` to the other ranks of a grid."""
        if self.grid is not None:
            self._share(msg)

    # -- the per-trigger update -----------------------------------------
    def _gamma0(self) -> torch.Tensor:
        """This step's gamma inits for this rank's rows: the chunk's whole
        [batch_capacity, k] draw, cut to this data shard's block."""
        n = self.batch_capacity
        if self._gamma0_fn is not None:
            g = torch.from_numpy(np.array(self._gamma0_fn(self.step, n),
                                          np.float32).reshape(n, -1))
        else:
            gen = seeded_generator("cpu", self.params.seed, _GAMMA_KEY,
                                   self.step)
            g = init_gamma(gen, n, self.params.k, self.params.gamma_shape)
        if self.grid is not None:
            per = n // self.grid.data_shards
            g = g[self.grid.d * per:(self.grid.d + 1) * per]
        return g.contiguous().to(self.device)

    def process(self, mb: Optional[MicroBatch] = None) -> bool:
        """Train on one micro-batch.  Returns True when this call committed
        a checkpoint: the caller's cue to commit source progress.  On a
        grid, rank 0 vectorizes ``mb`` and shares it; every other rank
        passes nothing and receives it."""
        t0 = time.perf_counter()
        with telemetry.span("stream.train_batch", emit=False):
            if self._leader:
                _, _, raw_rows = _vectorize_quarantined(
                    self.pre, self._rows_for, mb, self.quarantine,
                    "vectorize"
                )
                names = list(mb.names)
                rows = [(i, w) for i, w in raw_rows if len(i) > 0]
                batch_id = mb.batch_id
                self._tell("batch", names, rows, batch_id)
            else:
                msg = self._share()
                if msg[0] != "batch":
                    raise RuntimeError(f"rank 0 sent {msg[0]!r} where a "
                                       "micro-batch was due")
                _, names, rows, batch_id = msg
            return self._train(names, rows, batch_id, t0)

    def _train(self, names: List[str], rows, batch_id=None,
               t0: Optional[float] = None) -> bool:
        if t0 is None:
            t0 = time.perf_counter()
        # every consumed path joins the next epoch's record, whether or
        # not its docs survive vectorization (else it would replay forever)
        self._pending_sources.extend(names)
        if not rows:
            return False
        self.docs_seen += len(rows)
        for at in range(0, len(rows), self.batch_capacity):
            self._update(rows[at : at + self.batch_capacity])
        self.batches_seen += 1
        wrote_ckpt = bool(
            self._ckpt_path
            and self.checkpoint_every
            and self.batches_seen % self.checkpoint_every == 0
        )
        if wrote_ckpt:
            self.checkpoint()
        if telemetry.enabled():
            dt = time.perf_counter() - t0
            telemetry.observe("stream.train.micro_batch_seconds", dt)
            telemetry.event(
                "micro_batch", role="train", batch_id=batch_id,
                docs=len(rows), seconds=round(dt, 6),
                docs_seen=self.docs_seen, step=self.step,
                **tracing.fields(),
            )
            # a trigger boundary is a memory sample point
            telemetry.sample_memory("stream.train")
        return wrote_ckpt

    def _update(self, chunk) -> None:
        max_nnz = max(len(i) for i, _ in chunk)
        if max_nnz > self.row_len:
            self.row_len = next_pow2(max_nnz)
        rows = pad_rows(chunk, self.batch_capacity)
        if self.grid is None:
            batch = batch_from_rows(rows, row_len=self.row_len,
                                    device=self.device)
        else:
            batch, _, _ = data_shard_rows(self.grid, rows, self.row_len,
                                          self.device)
        p = self.params
        self._busy = True
        self.lam = _online_step(
            self.lam, torch.tensor([self.step, sum(
                1 for _, w in chunk if np.sum(w) > 0)]),
            batch.token_ids, batch.token_weights, self._gamma0(),
            torch.tensor(float(max(self.docs_seen,
                                   self.corpus_size_hint or 0)),
                         dtype=torch.float32),
            alpha=self._alpha_dev, eta=p.resolved_eta(), tau0=p.tau0,
            kappa=p.kappa, grid=self.grid,
        )
        self._busy = False
        self.step += 1

    # -- lifecycle -------------------------------------------------------
    def run(self, source=None, controller=None,
            **stream_kw) -> "StreamingOnlineLDA":
        """Drain a source (``stream``-able, ``poll``-able or an iterable of
        MicroBatch), committing source progress each time a checkpoint
        lands and once more, after a final checkpoint, at the end.
        ``controller`` (an ``AIMDTriggerController``) retunes the source's
        cap after each trigger.  ``stopped`` then says whether the stream
        ended on its ``stop()``.

        On a grid, rank 0 drains the source and the other ranks pass none:
        they train on what rank 0 shares, until it tells them the stream
        ended (``stopped`` is then rank 0's) or that it left it
        (``aborted``)."""
        if not self._leader:
            return self._follow()
        if hasattr(source, "stream"):
            it = source.stream(**stream_kw)
        elif hasattr(source, "poll"):
            def _drain():
                while True:
                    mb = source.poll()
                    if mb is None:
                        return
                    yield mb
            it = _drain()
        else:
            it = iter(source)
        commit = getattr(source, "commit", None)
        stop = stream_kw.get("stop")
        try:
            for mb in it:
                t0 = time.perf_counter()
                wrote_ckpt = self.process(mb)
                if controller is not None:
                    controller.update(
                        getattr(source, "last_queue_depth", 0),
                        time.perf_counter() - t0,
                    )
                    controller.apply(source)
                if wrote_ckpt and commit is not None:
                    commit()
            self.stopped = bool(stop is not None and stop())
            if self._ckpt_path:
                self._tell("final")
                self.checkpoint()
            self._tell("end", self.stopped)
        except BaseException:
            # the other ranks wait for rank 0's next message, unless this
            # failed inside a collective (the grid then ends with it)
            if self.grid is not None and not self._busy:
                with contextlib.suppress(Exception):
                    self._share(("abort",))
            raise
        if commit is not None:
            commit()
        return self

    def _follow(self) -> "StreamingOnlineLDA":
        """``run`` on a rank other than 0: rank 0's messages, to the end."""
        while True:
            msg = self._share()
            if msg[0] == "batch":
                with telemetry.span("stream.train_batch", emit=False):
                    self._train(*msg[1:])
            elif msg[0] == "final":
                self.checkpoint()
            elif msg[0] == "end":
                self.stopped = bool(msg[1])
                return self
            else:
                self.aborted = True
                return self

    def _host_lam(self) -> np.ndarray:
        """lambda [k, V_pad] on the host (on a grid, of every rank: a
        fetch over the vocabulary shards)."""
        if self.grid is None:
            return self.lam.cpu().numpy()
        self._busy = True
        lam = fetch_global(self.grid, self.lam, MODEL_AXIS)
        self._busy = False
        return lam

    def checkpoint(self) -> bool:
        """Commit one epoch: stage the intent (the consumed sources and the
        state shard about to land), write the shard durably, append the
        commit record.  Returns False when there was nothing new since the
        last commit.  On a grid every rank calls it (the fetch of lambda
        is collective) and rank 0 writes."""
        sources = self._pending_sources
        step = self.step
        if not sources and step == self._last_committed_step:
            return False
        lam = self._host_lam()
        if self._leader:
            epoch = self.ledger.next_epoch()
            lo, hi = shard_span(self._v_pad, 0, 1)
            self.ledger.begin(
                epoch, kind="stream-train", sources=sources,
                payloads=[shard_filename(epoch, 0)], process_count=1,
            )
            spec = self.ledger.stage_shard(
                epoch, 0, 1,
                cols=(lo, hi), step=step,
                lam=lam[:, lo:hi],
                docs_seen=np.int64(self.docs_seen),
                batches_seen=np.int64(self.batches_seen),
                vocab_fp=np.int64(_vocab_fingerprint(self.vocab)),
            )
            self.ledger.commit(
                epoch, kind="stream-train", sources=sources, shards=[spec],
                process_count=1, step=step, docs_seen=int(self.docs_seen),
                batches_seen=int(self.batches_seen),
            )
        self._pending_sources = []
        self._last_committed_step = step
        return True

    def _check_vocab(self, path: str, st: dict) -> None:
        fp = int(st.get("vocab_fp", -1))
        if fp not in (-1, _vocab_fingerprint(self.vocab)):
            raise ValueError(
                f"checkpoint {path} was trained with a DIFFERENT "
                f"vocabulary of the same size — term columns would "
                f"misalign; use the original vocab/num_features or a "
                f"fresh checkpoint dir"
            )

    def _restore_ledger(self, record) -> np.ndarray:
        """Resume from a committed epoch: every shard verified against its
        recorded digest (a mismatch is a torn checkpoint: refused), then
        the vocabulary-column shards merged into one lambda [k, V_pad].
        The shard plan is checked against this run's padded width, so
        shards of any process count merge."""
        shards = validate_shard_plan(record, self._v_pad)
        lam = np.empty((self.params.k, self._v_pad), np.float32)
        for s in shards:
            path = self.ledger.resolve(s["file"])
            if not os.path.exists(path) or file_sha256(path) != s["sha256"]:
                raise CorruptArtifactError(
                    path,
                    f"committed epoch {record['epoch']} shard p{s['p']} "
                    f"is missing or does not match its ledger digest — "
                    f"torn cross-host checkpoint; refusing to load",
                )
            st = load_train_state(path, require=("lam",))
            self._check_vocab(path, st)
            lo, hi = s["cols"]
            if st["lam"].shape != (self.params.k, hi - lo):
                raise ValueError(
                    f"checkpoint lam {st['lam'].shape} != "
                    f"{(self.params.k, hi - lo)}"
                )
            lam[:, lo:hi] = st["lam"]
        self.step = int(record["step"])
        self.docs_seen = int(record.get("docs_seen", 0))
        self.batches_seen = int(record.get("batches_seen", 0))
        self._last_committed_step = self.step
        return lam

    def _restore(self) -> np.ndarray:
        st = load_train_state(self._ckpt_path, require=("lam",))
        lam = st["lam"]
        if lam.shape != (self.params.k, self._v_pad):
            raise ValueError(
                f"checkpoint lam {lam.shape} != "
                f"{(self.params.k, self._v_pad)}"
            )
        self._check_vocab(self._ckpt_path, st)
        self.step = int(st["step"])
        self.docs_seen = int(st.get("docs_seen", 0))
        self.batches_seen = int(st.get("batches_seen", 0))
        self._last_committed_step = self.step
        return np.asarray(lam, np.float32)

    def model(self):
        """The current topics as an ``LDAModel`` on the trainer's device
        (on a grid, on every rank: a fetch over the vocabulary shards)."""
        return LDAModel(
            lam=self._host_lam()[:, : self._v],
            vocab=list(self.vocab),
            alpha=self._alpha,
            eta=float(self.params.resolved_eta()),
            gamma_shape=self.params.gamma_shape,
            algorithm="online",
            step=self.step,
            device=str(self.device),
        )
