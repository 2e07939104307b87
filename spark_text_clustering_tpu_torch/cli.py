"""Command-line entry points of the port: ``train`` and ``score``, the
streaming verbs ``stream-score``, ``stream-train``, ``stream requeue`` and
``stream compact``, ``supervise``, a fleet of stream workers or of serve
replicas, ``serve``, one resident scoring replica, ``front``, the serve
fleet's routing front, ``probe``, its black-box canary, ``collect``, the
telemetry collector, ``monitor``, the live alerting engine, ``lineage``,
the walk from a served byte back to its source files, ``doctor``, the
environment's health report, ``compile-cache``, the kernel-library
store's maintenance, and ``lint``, the port's static analysis.

The reference's two entry points (LDATraining.scala, LDALoader.scala) as
subcommands, with the JAX package's flags, defaults, console output and
exit codes:

    python -m spark_text_clustering_tpu_torch.cli train --books <dir> \
        --stop-words <file> --lang EN --algorithm em --k 5
    python -m spark_text_clustering_tpu_torch.cli score --books <dir> \
        --lang EN --models-dir <dir> --output-dir <dir>
    python -m spark_text_clustering_tpu_torch.cli stream-train \
        --watch-dir <dir> --checkpoint-dir <dir> --idle-timeout 5
    python -m spark_text_clustering_tpu_torch.cli supervise \
        --role stream-score --watch-dir <dir> --fleet-dir <dir> --workers 2
    python -m spark_text_clustering_tpu_torch.cli serve \
        --models-dir <dir> --port 0
    python -m spark_text_clustering_tpu_torch.cli supervise --role serve \
        --fleet-dir <dir> --models-dir <dir> --workers 2 --front-port 0
    python -m spark_text_clustering_tpu_torch.cli front --fleet-dir <dir>
    python -m spark_text_clustering_tpu_torch.cli probe --fleet-dir <dir>
    python -m spark_text_clustering_tpu_torch.cli collect --dir <dir>
    python -m spark_text_clustering_tpu_torch.cli monitor \
        --fleet-dir <dir> --stream '<dir>/*.jsonl' --alerts-file <file>
    python -m spark_text_clustering_tpu_torch.cli lineage <model dir> \
        --fleet-dir <dir>
    python -m spark_text_clustering_tpu_torch.cli doctor
    python -m spark_text_clustering_tpu_torch.cli compile-cache warm \
        --cache-dir <dir> --models-dir <dir>
    python -m spark_text_clustering_tpu_torch.cli lint --protocol

Two flags are the port's own: ``--device`` (default ``cuda``) names the
device that IDF, training and scoring run on (without a card, pass
``--device cpu``), and ``--dist-backend`` the ``torch.distributed``
backend of a grid (default ``nccl`` on CUDA, ``gloo`` on the CPU).

``--compile-cache DIR`` (on ``train``, ``score``, ``serve``, ``supervise``
and the stream verbs; or ``STC_COMPILE_CACHE=DIR``) arms the compile cache
(``compilecache``): the CUDA kernel libraries load from the store's
committed entries instead of building, and a library built (or found in
the build directory) is published there.  The flag is exported to the
environment, so fleet workers, serve replicas and grid ranks share the
store.  ``compile-cache warm|ls|verify|gc`` keeps it.

``--data-shards D --model-shards M`` run training (IDF included; EM,
online VB or NMF), scoring and ``stream-train`` on a grid of D x M ranks
(``parallel``).  Unlike the JAX package, where one process drives every
local device, each rank is one process on one device (rank r on
``cuda:(r mod cards)``).  Without ``--coordinator`` the command spawns the
D x M ranks on this host itself, and they end with it; with
``--coordinator host:port --num-processes N --process-id i`` (``train``
and ``score``) it is rank i of N = D x M processes started by the caller.
Every rank of ``train`` and ``score`` reads and preprocesses the whole
book directory, as every JAX process does; only rank 0 prints, saves the
model and writes the report, and the exit code is the worst of the
ranks'.

The stream verbs watch a directory and score or train on the files that
arrive, one trigger at a time, on ``--device``; with ``--checkpoint-dir``
each trigger commits through the epoch ledger (``resilience.ledger``), so
a restarted stream emits each report and trains each file exactly once.
A SIGTERM ends a stream after its in-flight trigger.  ``stream-train`` on
a grid (the JAX package's one process over a mesh, as D x M ranks) reads
the source and runs the text front end on rank 0, which shares each
micro-batch's rows with the other ranks, holds the lease and the SIGTERM
drain, and commits one state shard an epoch, as the JAX process does;
the command's SIGTERM is passed on to rank 0.  ``stream-score`` takes no
grid flags, as in the JAX package.

``serve`` keeps one scoring replica resident (``serving``): it loads the
newest verified model once, runs one dispatch per token bucket, coalesces
concurrent ``POST /score`` requests into one launch of the per-document
kernel, hot-swaps a newer published model, answers ``/healthz`` and
``/metrics``, and drains on SIGTERM; ``--device`` as on the other verbs.

``supervise --role stream-score|stream-train`` runs N stream workers of
this CLI as subprocesses (``resilience.supervisor``): each takes its
partition of the watch dir, heartbeats a lease and writes through a
fenced epoch ledger, and the supervisor respawns, escalates and resizes
between committed epochs.  Its ``--device`` is passed on to every worker
when given; without it the workers run on the card, as the stream verbs
do.  ``--telemetry-file`` writes the supervisor's own stream (``fleet_*``
events, ``fleet.*`` counters), ``--worker-telemetry-dir`` gives every
worker incarnation a stream (``worker-wNNN-sSS.jsonl``), all on the
supervisor's trace, and ``--ship-to host:port`` pushes every stream of
the fleet to a collector.  ``--actions-file`` applies a ``monitor``'s
scale and drain requests, each once (``FleetSupervisor``).

``supervise --role serve`` runs N ``serve`` replicas of this CLI as one
service (``resilience.supervisor.ServeFleetSupervisor``): each replica
serves on a port of its own, on ``--device`` (passed on when given; the
card otherwise), through the per-document kernel, and announces its port,
state and model in its lease; the supervisor brings them up staggered,
respawns a dead one, rolls a newly published model through them one at a
time and drains them on SIGTERM or after ``--max-seconds``.
``--front-port`` runs the routing front in the supervisor's process and
announces it in ``<fleet-dir>/front.json``; the ``front`` verb runs it
alone.  ``probe`` scores a sentinel document through the front at a fixed
rate and reports what a client saw.  Neither ``front`` nor ``probe``
touches the card.  A serve fleet resizes from ``--actions-file`` only, as
the JAX package's does: ``--resize-at`` and the ``--scale-*`` flags exit 2
with ``--role serve`` (the JAX verb accepts and ignores them).
``--autoscale`` (with ``--front-port`` and ``--actions-file``; it exits 2
without them, where the JAX verb ignores it) feeds the front's queueing
estimate to a ``PredictiveAutoscaler``, whose decisions go to the actions
file beside the monitor's.

``monitor`` tail-follows run streams, a fleet's leases and epoch ledgers,
evaluates alert rules, writes their transitions to a checksummed
``--alerts-file`` and their scale and drain requests to
``--actions-file``; ``serve --alerts-file`` and ``front --alerts-file``
answer ``/healthz`` with ``degraded`` while that log holds a firing
alert.  Like ``front`` it never touches the card.

``collect`` is the telemetry collector those shippers push to (the JAX
package's shippers too): one manifested stream a source, folded exactly
once.

``lineage`` walks what the stream trainers, the fleet and the serve
replicas wrote (``meta.json``, the epoch ledgers, a saved ``/score``
response, the run streams), whichever package wrote them, from a model
dir, a response or a trace id back to the publish epoch and the committed
source files (``lineage``).  ``doctor`` reports whether the card, the CPU
path, the text library and the CUDA kernels' toolchain are usable; it
probes the card in a throwaway subprocess (``utils.env``), so a wedged
card can only time out, and it builds nothing.  Neither makes a CUDA
context in its own process.

``--telemetry-file F`` on ``train``, ``score``, ``stream-score`` and
``stream-train`` writes the run's telemetry stream to ``F``: a manifest,
then the JAX package's events (``corpus``, ``phase``, ``span``,
``train_iteration``, ``train_fit``, ``micro_batch``, ``ledger_commit``,
``model_saved``, ...), then a final ``registry`` snapshot, on every exit
path, with the dispatch layer's families (``dispatch.*`` by call site and
kernel, ``compile.*``, ``mem.<digest>.*``).  Each rank of a grid writes
its own stream, ``<stem>-p<rank><ext>``.  ``metrics`` reads them, as the
JAX package's verb does (``summarize``, ``merge`` of a grid's streams,
``trace``, ``tail``, ``diff``, ``bench-diff``, ``check``, ``slo``,
``roofline`` against the card's peaks, ``compile-check``,
``scale-check``: ``--run`` spawns the measured-scale probe on a 2x2 grid
of ranks on ``--device`` and reconciles it with the committed scale
record ``analysis/scale_baseline.json``).

``lint`` runs the JAX package's static analysis over the port's source:
the AST invariant rules (STC000-007, STC101-102; STC005 roots at the
callables ``telemetry.instrument_dispatch`` wraps), the trace audit of
the registered entry points (STC200-205, each called once on CPU
tensors; ``--no-jaxpr`` skips it), and with ``--protocol`` also the
STC300-305 protocol audit, against the port's own waiver baseline
``analysis/lint_baseline.json``; ``--scale`` adds the STC210-215 scale
audit (every entry point at k=500, V=10M on fake tensors) against the
committed record ``analysis/scale_baseline.json``.  It makes no CUDA
context and builds nothing.

Exit codes: 0 on success; 1 for a fleet that spent its respawn budget,
for a ``compile-cache verify`` with findings and for a ``lint`` with
unwaived findings, and for a ``metrics scale-check
--fail-on-divergence`` with a divergence; 2 for a usage error, a missing
or corrupt model and a resume mismatch; 3 for
a stream whose ledger write was fenced and for a ``lineage`` target that
names nothing.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import List, Optional

import numpy as np

from . import telemetry
from .config import Params
from .device import resolve_device
from .models.persistence import (
    load_model,
    model_dir_name,
    resolve_latest_model,
    save_model,
    train_state_valid,
)
from .ops import _build
from .parallel.mesh import (
    agree_ledger_epoch,
    check_backend,
    default_backend,
    initialize_distributed,
    is_coordinator,
    make_grid,
    run_grid,
)
from .pipeline import (
    IDF,
    LDA,
    CountVectorizer,
    Estimator,
    TextPreprocessor,
    make_vectorizer,
)
from .resilience import (
    CorruptArtifactError,
    EpochLedger,
    FencedEpochError,
    FleetFence,
    FleetSupervisor,
    PreemptionNotice,
    ResilienceError,
    ResumeMismatchError,
    WorkerLease,
    artifact_ref,
    configure_lease_deadline,
    fleet_committed_sources,
    lease_path,
    requeue,
    validate_resume_meta,
    vocab_fingerprint,
    worker_dir,
    write_resume_meta,
)
from .streaming import (
    AIMDTriggerController,
    FileStreamSource,
    StreamingOnlineLDA,
    StreamingScorer,
)
from .telemetry import tracing
from .utils import native
from .utils.profiling import MetricsLogger, trace
from .utils.readers import read_stop_word_file, read_text_dir
from .utils.report import format_scoring_report, write_scoring_report
from .utils.textproc import parse_stop_words
from .utils.timing import PhaseTimer

__all__ = [
    "LANG_DIRS",
    "build_parser",
    "cmd_collect",
    "cmd_doctor",
    "cmd_front",
    "cmd_lineage",
    "cmd_probe",
    "cmd_score",
    "cmd_serve",
    "cmd_stream_compact",
    "cmd_stream_requeue",
    "cmd_stream_score",
    "cmd_stream_train",
    "cmd_supervise",
    "cmd_train",
    "main",
]

# LDALoader.scala:46-56 routing
LANG_DIRS = {
    "EN": "English",
    "GE": "German",
    "FR": "French",
    "IT": "Italian",
    "RU": "Russian",
    "SP": "Spanish",
    "UKR": "Ukrainian",
    "DU": "Dutch",
}

def _grid_shape(args: argparse.Namespace):
    """(data_shards, model_shards, backend) of the command's grid, or an
    error message for a combination of flags that cannot run."""
    coord, procs, pid = args.coordinator, args.num_processes, args.process_id
    if coord is None and (procs is not None or pid is not None):
        return ("--num-processes/--process-id require --coordinator "
                "(pass --coordinator host:port on every process)")
    if coord is not None and (procs is None or pid is None):
        return "--coordinator requires --num-processes and --process-id"
    m = args.model_shards
    d = args.data_shards
    if d is None:
        d = procs // m if coord is not None and procs % m == 0 else 1
    if d < 1 or m < 1:
        return f"--data-shards {d} --model-shards {m}: shards must be >= 1"
    if coord is not None and procs != d * m:
        return (f"--num-processes {procs} != --data-shards {d} x "
                f"--model-shards {m}: every rank of the grid is a process")
    if d * m > 1:
        if getattr(args, "per_doc_convergence", False):
            return ("--per-doc-convergence does not support sharded "
                    "scoring (--data-shards/--model-shards)")
    backend = args.dist_backend or default_backend(args.device)
    if d * m > 1 or coord is not None:
        try:
            check_backend(backend, args.device, d * m)
        except ValueError as exc:
            return str(exc)
    return d, m, backend


def _on_grid(args: argparse.Namespace, body, stream: bool = False) -> int:
    """Run ``body(args, grid)``: on one device (grid None), as rank
    ``--process-id`` of a ``--coordinator`` world, or on ranks spawned
    here for a grid larger than 1x1.  A ``stream``'s ranks run without a
    time limit, end a second after one fails (they wait on each other),
    and get this process's SIGTERM on rank 0."""
    shape = _grid_shape(args)
    if isinstance(shape, str):
        print(f"error: {shape}", file=sys.stderr)
        return 2
    d, m, backend = shape
    resolve_device(args.device)  # no card and no --device cpu: raise now
    if args.coordinator is not None:
        import torch.distributed as dist

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id, backend=backend,
                               device=args.device)
        try:
            return body(args, make_grid(d, m, backend, args.device))
        finally:
            dist.destroy_process_group()
    if d * m == 1:
        return body(args, None)
    # the ranks load the kernels and the text library: build them here,
    # once, before they start
    if args.device != "cpu":
        _build.build_all()
    try:
        native.build()
    except RuntimeError:
        pass  # the ranks take the Python text path, as "auto" does
    limits = ({"timeout": None, "grace": 1.0,
               "forward_signals": (signal.SIGTERM,)} if stream else {})
    try:
        codes = run_grid(_grid_rank, d, m, (body.__name__, args),
                         backend=backend, device=args.device, **limits)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return max(codes)


def _grid_rank(grid, body_name: str, args: argparse.Namespace) -> int:
    """One spawned rank of ``_on_grid``."""
    return globals()[body_name](args, grid)


def _quiet(*args, **kwargs) -> None:
    """``print`` on a rank other than the coordinator."""


def _with_telemetry(args: argparse.Namespace, device, run) -> int:
    """``run()`` with ``--telemetry-file`` configured for this process (on
    a grid, its rank's ``-p<rank>`` stream) on ``device``; the stream's
    final registry snapshot is written on every way out, an exception
    included."""
    if not args.telemetry_file:
        return run()
    telemetry.configure(telemetry.per_process_path(args.telemetry_file),
                        device=device)
    try:
        return run()
    finally:
        telemetry.shutdown()


def _worker_manifest_fields(args: argparse.Namespace) -> dict:
    """A supervised worker's fleet index, for its stream's manifest."""
    return {"worker_index": args.worker_index} if args.fleet_dir else {}


def _note_replays_suppressed(preseen: list, ledger_dir: str) -> None:
    if preseen:
        telemetry.count("ledger.replays_suppressed", len(preseen))
        telemetry.event("replays_suppressed", files=len(preseen),
                        ledger=ledger_dir)


def _load_stop_words(path: Optional[str]) -> frozenset:
    if not path:
        return frozenset()
    return parse_stop_words(read_stop_word_file(path))


def _resume_gate(
    params: Params,
    vocab,
    resume_requested: bool,
    state_name: Optional[str] = None,
    ledgered: bool = False,
) -> Optional[int]:
    """Checkpoint-dir compatibility gate: validates any recorded
    ``resume_meta.json`` against this run's config hash and vocabulary
    fingerprint (a mismatch is fatal whether or not --resume was passed),
    announces the resume point when --resume asked for one, and records
    this run's envelope for the next resume.  Returns an exit code to
    abort with, or None to proceed.  On a grid every rank validates and
    the coordinator speaks and writes.

    ``ledgered`` marks a stream dir with an epoch commit ledger: the
    envelope records the process count and the ledger flag (a restart
    with another process count is then an elastic resume through the
    ledger's shards), and --resume announces the last committed epoch,
    agreed across ranks, rather than a state file.  The process count is
    1 on a grid too: rank 0 commits one state shard, as the JAX package's
    one process over its mesh does (``jax.process_count()`` is 1 there),
    and the grid's shape is in the config hash."""
    if not params.checkpoint_dir:
        if resume_requested:
            print("--resume requires --checkpoint-dir", file=sys.stderr)
            return 2
        return None
    vocab_fp = vocab_fingerprint(vocab)
    say = print if is_coordinator() else _quiet
    try:
        validate_resume_meta(params.checkpoint_dir, params, vocab_fp,
                             process_count=1 if ledgered else None)
    except ResumeMismatchError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if resume_requested:
        epoch = agree_ledger_epoch(
            params.checkpoint_dir if ledgered else None)
        if state_name is None:
            state_name = {
                "em": "em_state.npz", "online": "train_state.npz"
            }.get(params.algorithm)
        state = (
            os.path.join(params.checkpoint_dir, state_name)
            if state_name else None
        )
        if epoch >= 0:
            say(
                f"resuming from checkpoint {params.checkpoint_dir} "
                f"(epoch ledger, committed epoch {epoch})"
            )
        elif state and train_state_valid(state):
            say(f"resuming from checkpoint {state}")
        else:
            say(
                f"--resume: no valid checkpoint under "
                f"{params.checkpoint_dir}; starting fresh"
            )
    if is_coordinator():
        write_resume_meta(
            params.checkpoint_dir, params, vocab_fp,
            **({"process_count": 1, "ledger": True} if ledgered else {}),
        )
    return None


def cmd_train(args: argparse.Namespace) -> int:
    return _on_grid(args, _train)


def _train(args: argparse.Namespace, grid) -> int:
    device = args.device if grid is None else grid.device
    return _with_telemetry(args, device,
                           lambda: _train_run(args, grid, device))


def _train_run(args: argparse.Namespace, grid, device) -> int:
    coordinator = is_coordinator()
    say = print if coordinator else _quiet
    timer = PhaseTimer()
    sw = _load_stop_words(args.stop_words)
    with timer.phase("read"):
        docs = list(read_text_dir(args.books, include_all=args.include_all))
    texts = [d.text for d in docs]

    params = Params(
        input=args.books,
        k=args.k,
        max_iterations=args.max_iterations,
        doc_concentration=args.doc_concentration,
        topic_concentration=args.topic_concentration,
        vocab_size=args.vocab_size,
        algorithm=args.algorithm,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_interval=args.checkpoint_interval,
        sampling=args.sampling,
        token_layout=args.token_layout,
        seed=args.seed,
        data_shards=args.data_shards,
        model_shards=args.model_shards,
        keep_doc_topic_counts=args.export_mllib,
        record_iteration_times=args.record_iteration_times,
    )

    feat_stages: List[object] = [
        TextPreprocessor(stop_words=sw, lemmatize=not args.no_lemmatize),
        # one counting process: the same vocabulary as the JAX CLI's
        # sharded count, without spawning interpreters that import torch
        CountVectorizer(vocab_size=params.vocab_size, num_workers=1),
    ]
    if not args.no_tfidf:
        # the reference trains LDA on TF-IDF pseudo-counts
        # (LDAClustering.scala:180-192)
        feat_stages.append(IDF(min_doc_freq=params.min_doc_freq,
                               idf_floor=params.idf_floor,
                               device=device, grid=grid))

    # one writer: a second rank opening --metrics-file would truncate it
    metrics = MetricsLogger(args.metrics_file if coordinator else None)
    metrics.log("corpus", documents=len(texts), books_dir=args.books)

    with timer.phase("preprocess"):
        # fit and transform each featurization stage once: preprocessing
        # is the dominant host cost, and Pipeline.fit followed by a
        # transform would run it twice
        ds: dict = {"texts": texts}
        for stage in feat_stages:
            with telemetry.span(f"pipeline.fit.{type(stage).__name__}"):
                t = stage.fit(ds) if isinstance(stage, Estimator) else stage
                ds = t.transform(ds)
    rows = ds["rows"]
    n_docs = sum(1 for i, _ in rows if len(i) > 0)
    # the reference's "token" count is DISTINCT terms per doc summed
    # (Sum of numActives, LDAClustering.scala:195-197)
    n_tokens = sum(len(i) for i, _ in rows)
    rc = _resume_gate(params, ds["vocab"], args.resume)
    if rc is not None:
        return rc
    # the manifest (the stream's first record; earlier spans were
    # buffered): what a later `metrics diff` needs to judge two runs
    # comparable
    telemetry.manifest(
        params=params,
        mesh=grid if grid is not None else {"data": 1, "model": 1},
        vocab_width=len(ds["vocab"]), kind="train", books_dir=args.books,
    )
    telemetry.event("corpus", documents=n_docs, tokens=n_tokens,
                    vocab_width=len(ds["vocab"]))

    # corpus summary, reference format (LDAClustering.scala:28-34);
    # timings print full precision like Scala's Double.toString
    say()
    say("Corpus summary:")
    say(f"\t Training set size: {n_docs} documents")
    say(f"\t Vocabulary size: {len(ds['vocab'])} terms")
    say(f"\t Training set size: {n_tokens} tokens")
    say(f"\t Preprocessing time: {timer.phases['preprocess']} sec")
    say()
    say("LDA model training started")

    with trace(args.profile_dir if coordinator else None):
        with timer.phase("train"):
            lda_stage = LDA(params, device=device, grid=grid).fit(ds)
    model = lda_stage.model
    if not coordinator:
        return 0

    # LDAClustering.scala:63-78 prints
    print("Finished training LDA model.  Summary:")
    print(f"\t Training time: {timer.phases['train']} sec")
    # avg log-likelihood, the reference's single quality metric (EM
    # only), over the docs actually trained on (corpus.count())
    if lda_stage.log_likelihood is not None and lda_stage.corpus_size:
        print(f"\t Training data average log likelihood: "
              f"{lda_stage.log_likelihood / lda_stage.corpus_size}")
        print()

    # top-10 terms per topic (LDAClustering.scala:81-92)
    print(f"{model.k} topics:")
    for i, topic in enumerate(model.describe_topics_terms(10)):
        print(f"TOPIC {i}")
        for term, w in topic:
            print(f"{term}\t{w}")
        print()

    out_dir = model_dir_name(args.lang, base=args.models_dir)
    model.save(out_dir)
    print(f"model saved to {out_dir}")

    if args.export_mllib:
        if lda_stage.doc_topic_counts is None:
            # DistributedLDAModel is MLlib's EM artifact: without doc
            # vertices (N_dk) Spark would load doc nodes without counts
            print(
                "--export-mllib requires --algorithm em "
                "(DistributedLDAModel is MLlib's EM artifact class); "
                "skipping export"
            )
        else:
            from .models.reference_export import save_reference_model

            mllib_dir = out_dir + "_mllib"
            save_reference_model(
                model,
                mllib_dir,
                doc_topic_counts=lda_stage.doc_topic_counts,
                doc_rows=[(i, w) for i, w in rows if len(i) > 0],
            )
            print(f"MLlib-format model exported to {mllib_dir}")

    metrics.log_phases(timer.phases)
    metrics.log_iteration_times(
        model.iteration_times, kind=model.iteration_times_kind
    )
    metrics.log(
        "model_saved",
        path=out_dir,
        k=model.k,
        vocab_size=model.vocab_size,
        algorithm=params.algorithm,
    )
    for name, seconds in timer.phases.items():
        telemetry.event("phase", name=name, seconds=round(seconds, 6))
    telemetry.event("model_saved", path=out_dir, k=model.k,
                    vocab_size=model.vocab_size, algorithm=params.algorithm)
    return 0


def cmd_score(args: argparse.Namespace) -> int:
    return _on_grid(args, _score)


def _score(args: argparse.Namespace, grid) -> int:
    device = args.device if grid is None else grid.device
    return _with_telemetry(args, device, lambda: _score_run(args, grid))


def _score_run(args: argparse.Namespace, grid) -> int:
    say = print if is_coordinator() else _quiet
    # a missing or truncated/uncommitted artifact fails here with a typed
    # error and exit code 2, never a partial report
    try:
        model_path, model = resolve_latest_model(
            args.models_dir, args.lang, explicit=args.model,
            verify_deep=args.verify_deep, device=args.device,
        )
    except CorruptArtifactError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    say(f"loaded model {model_path}: k={model.k}, V={model.vocab_size}")
    telemetry.manifest(kind="score", model=model_path,
                       vocab_width=model.vocab_size)

    books_dir = args.books
    if books_dir is None and args.books_root:
        books_dir = os.path.join(args.books_root, LANG_DIRS[args.lang])
    if books_dir is None:
        print("score requires --books or --books-root", file=sys.stderr)
        return 2
    sw = _load_stop_words(args.stop_words)

    docs = list(read_text_dir(books_dir, include_all=args.include_all))
    # BuildCountVector semantics: count vectors over the TRAINED vocab, no
    # IDF (LDALoader.scala:83-106); hash-trained models hash instead
    pre = TextPreprocessor(stop_words=sw, lemmatize=not args.no_lemmatize)
    ds = pre.transform({"texts": [d.text for d in docs]})
    rows = make_vectorizer(model.vocab)(ds["tokens"])
    dist = model.topic_distribution(
        rows,
        convergence="per_doc" if args.per_doc_convergence else "batch",
        grid=grid,
    )
    if not is_coordinator():
        return 0

    text = format_scoring_report(model, [d.path for d in docs], dist, rows)
    # the reference prints every report block to the console as it goes;
    # the report text IS the console output
    print(text)
    path = write_scoring_report(text, args.output_dir, args.lang)
    print(f"report written to {path}")
    telemetry.sample_memory("score")
    telemetry.event("scored", documents=len(docs), report=path)
    return 0


# ---- serving ---------------------------------------------------------------
def _serve_replica_loop(args: argparse.Namespace, service, lease, preempt,
                        port: int, deadline) -> None:
    """A supervised serve replica's main loop: renew the ``role=serve``
    lease with the routing front's discovery fields (port, state, the
    served model's path and stamp), and poll the replica's control file
    for the supervisor's rolling-swap commands; the replica acks a swap
    by reporting the new ``model_stamp`` in its lease.  The kernels'
    launches so far go to the run stream as a ``kernel_launches`` event
    when they changed, at most once a second."""
    from .resilience import sleep as _idle_sleep
    from .resilience.supervisor import control_path, read_control

    ctrl = control_path(args.fleet_dir, args.worker_index)
    ctrl_stamp = None
    cmd = None
    last_ctrl_id = 0
    last_attempt = 0.0
    launches, launches_at = dict(_build.LAUNCHES), time.monotonic()
    reg = telemetry.get_registry()
    telemetry.gauge("serve.replica.index", args.worker_index)
    telemetry.gauge("serve.replica.draining", 0)
    while not preempt:
        if deadline is not None and time.monotonic() >= deadline:
            break
        scorer = service.scorer
        telemetry.gauge(
            "serve.replica.stamp",
            scorer.stamp if scorer.stamp is not None else -1,
        )
        lease.beat(
            queue_depth=service.coalescer.queue_depth(),
            state="draining" if service.draining else "ready",
            port=port,
            model_path=scorer.path,
            model_stamp=scorer.stamp,
            swap_id=last_ctrl_id,
            requests=int(reg.counter("serve.requests").value),
        )
        # control poll (mtime-cached): a new swap command re-resolves the
        # selection path until the commanded stamp serves
        try:
            st = os.stat(ctrl)
            stamp = (st.st_mtime, st.st_size)
        except OSError:
            stamp = None
        if stamp is not None and stamp != ctrl_stamp:
            ctrl_stamp = stamp
            cmd = read_control(ctrl)
            if cmd is None:             # mid-write; the next loop re-reads
                ctrl_stamp = None
        if isinstance(cmd, dict) and isinstance(cmd.get("id"), int) \
                and cmd["id"] > last_ctrl_id:
            want = cmd.get("stamp")
            cur = scorer.stamp if scorer.stamp is not None else -1
            if want is None or cur >= int(want):
                last_ctrl_id = cmd["id"]
            elif time.monotonic() - last_attempt > 0.25:
                last_attempt = time.monotonic()
                service.poll_model_once()
                new = service.scorer.stamp
                if new is not None and new >= int(want):
                    last_ctrl_id = cmd["id"]
        if (_build.LAUNCHES != launches
                and time.monotonic() - launches_at >= 1.0):
            launches, launches_at = dict(_build.LAUNCHES), time.monotonic()
            telemetry.event("kernel_launches", phase="serving", **launches)
        _idle_sleep(0.05)


def cmd_serve(args: argparse.Namespace) -> int:
    """Persistent scoring service: load the newest verified model ONCE,
    run one dispatch per token bucket, coalesce concurrent requests into
    one launch each (continuous batching), hot-swap atomically when a
    ``stream-train`` fleet publishes a newer model, and drain cleanly on
    SIGTERM — the LDALoader flow as a resident process instead of a cold
    batch job.  The URL line is printed once the service is warm.

    With ``--fleet-dir`` (``supervise --role serve`` passes it) the
    service is a fleet replica: its first lease beat (``state`` starting,
    ``port`` 0) lands before the CUDA context, the per-document kernel's
    load and the model's load and warmup, so those fall under the
    supervisor's startup grace; it then serves on the port its lease
    announces, swaps only when the supervisor's control file says so, and
    reports ``draining`` in its lease before it drains."""
    import threading

    from .resilience import sleep as _idle_sleep

    device = resolve_device(args.device)  # no card, no --device cpu: raise
    # registry-only when no run stream is asked for: /metrics and the
    # serve histograms need a live registry
    telemetry.configure(args.telemetry_file or None, device=args.device)
    # the fleet wiring first: the replica's starting beat must land before
    # the slow work below, or a supervisor with a tight startup grace
    # would declare a warming replica stuck
    preempt, lease, _fence, _ = _fleet_worker_context(
        args, lease_fields={"role": "serve"})
    try:
        if lease is not None:
            lease.beat(force=True, state="starting", port=0)
            if device.type == "cuda" and args.emulate_doc_ms is None:
                # the CUDA context and the kernel every dispatch launches
                # (built if missing), under the startup grace
                import torch

                torch.zeros(1, device=device)
                _build.load_library("segments")
        from .serving import ScoringService, make_http_server

        buckets = tuple(args.token_bucket) or None
        try:
            service = ScoringService(
                args.models_dir,
                args.lang,
                model=args.model,
                verify_deep=not args.no_verify_deep,
                stop_words=_load_stop_words(args.stop_words),
                lemmatize=not args.no_lemmatize,
                max_batch=args.max_batch,
                linger_s=args.linger_ms / 1000.0,
                **({"token_buckets": buckets} if buckets else {}),
                model_poll_interval=args.model_poll_interval,
                quarantine_dir=args.quarantine_dir,
                # a supervised replica swaps when the supervisor says so
                # (one replica at a time), never on its own
                watch_model=lease is None,
                replica_index=(args.worker_index if lease is not None
                               else None),
                emulate_doc_seconds=(args.emulate_doc_ms / 1000.0
                                     if args.emulate_doc_ms is not None
                                     else None),
                max_queue=args.max_queue,
                batch_weight=args.batch_weight,
                device=device,
                alerts_file=args.alerts_file,
            )
        except CorruptArtifactError as exc:
            if lease is not None:
                lease.mark_done("corrupt_model")
            print(f"error: {exc}", file=sys.stderr)
            return 2
        scorer = service.scorer
        # the writer buffers pre-manifest events (serve_warmup), so the
        # manifest still lands first in the stream
        telemetry.manifest(kind="serve", model=scorer.path, lang=args.lang,
                           vocab_width=scorer.model.vocab_size,
                           **_worker_manifest_fields(args))
        telemetry.event("kernel_launches", phase="warmup", **_build.LAUNCHES)
        httpd = make_http_server(service, args.host, args.port)
        host, port = httpd.server_address[:2]
        wr = service.warmup_report
        print(
            f"serving {scorer.path} (k={scorer.model.k}, "
            f"V={scorer.model.vocab_size}) on http://{host}:{port} — "
            f"warmed buckets {wr['buckets']} in {wr['warmup_seconds']}s; "
            f"POST /score, GET /healthz /metrics", flush=True
        )
        http_thread = threading.Thread(
            target=httpd.serve_forever, name="stc-serve-http", daemon=True
        )
        http_thread.start()
        deadline = (time.monotonic() + args.max_seconds
                    if args.max_seconds else None)
        if lease is not None:
            _serve_replica_loop(args, service, lease, preempt, port,
                                deadline)
        else:
            while not preempt:
                if deadline is not None and time.monotonic() >= deadline:
                    break
                _idle_sleep(0.1)
        # preemption notice (or drill deadline): finish queued documents,
        # refuse new ones (503), then take the port down.  A fleet replica
        # shows the draining state in its lease first, so the front stops
        # routing to it before any 503.
        if lease is not None:
            lease.beat(force=True, state="draining", port=port,
                       model_path=service.scorer.path,
                       model_stamp=service.scorer.stamp)
            telemetry.gauge("serve.replica.draining", 1)
        report = service.begin_drain()
        httpd.shutdown()
        httpd.server_close()
        telemetry.event("serve_drained", **report)
        telemetry.event("kernel_launches", phase="drain", **_build.LAUNCHES)
        if lease is not None:
            lease.mark_done("preempted")
        print(
            f"drain complete: {report['requests']} request(s) in "
            f"{report['batches']} batch(es), {report['swaps']} hot-swap(s), "
            f"{report['rejected']} refused while draining, "
            f"{report['retraces_after_warmup']} recompile(s) after warmup",
            flush=True,
        )
        return 0
    finally:
        preempt.uninstall()
        if lease is not None and args.lease_timeout:
            configure_lease_deadline(None)
        telemetry.shutdown()


# ---- streaming -----------------------------------------------------------
def _make_trigger_controller(args: argparse.Namespace):
    """The AIMD controller of ``max_files_per_trigger`` behind
    ``--adaptive-trigger`` (None when the flag is off)."""
    if not args.adaptive_trigger:
        return None
    return AIMDTriggerController(
        target_batch_seconds=args.target_batch_seconds,
        initial_cap=args.max_files_per_trigger or 8,
    )


def _fleet_worker_context(args: argparse.Namespace,
                          lease_fields: Optional[dict] = None):
    """A worker's wiring, shared by the stream verbs and ``serve``: the
    SIGTERM drain notice (every stream ends after its in-flight trigger on
    SIGTERM, and a server drains), and with ``--fleet-dir`` the heartbeat
    lease (``lease_fields`` ride every renewal: a serve replica's
    ``role``), the fence token every ledger write verifies, the worker's
    file partition and the lease-bounded retry deadline.

    A supervised stream worker on the card also makes its CUDA context and
    loads the E-step kernel (building it if missing) and the text library
    here, before its first lease beat, so that they fall under the
    supervisor's startup grace and not between two beats.  A serve
    replica beats first and does that work after (``cmd_serve``).

    Returns ``(preempt, lease, fence, partition)``; the last three are
    None for an unsupervised worker."""
    # a spawner's causal context (STC_TRACE) first: the first lease beat
    # and every ledger record of this worker hang off it
    tracing.adopt_env()
    preempt = PreemptionNotice().install()
    if not args.fleet_dir:
        return preempt, None, None, None
    idx = args.worker_index
    count = max(1, getattr(args, "worker_count", 1))
    lease = WorkerLease(
        lease_path(args.fleet_dir, idx),
        interval=args.heartbeat_interval,
        worker_index=idx,
        generation=args.fleet_generation,
        spawn_id=args.fleet_spawn_id,
        static_fields=lease_fields,
    )
    fence = FleetFence(
        fleet_dir=args.fleet_dir,
        generation=args.fleet_generation,
        worker_index=idx,
        spawn_id=args.fleet_spawn_id,
    )
    partition = (idx, count) if count > 1 else None
    if args.lease_timeout:
        configure_lease_deadline(args.lease_timeout)
    if lease_fields is None:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            import torch

            torch.zeros(1, device=dev)
            _build.load_library("estep")
        try:
            native.load()
        except RuntimeError:
            pass  # the Python text path, as "auto" takes it
    lease.beat(force=True)
    return preempt, lease, fence, partition


def _stream(args: argparse.Namespace, body) -> int:
    """A stream verb's frame: the device (no card and no --device cpu
    raises before any file is read), the worker wiring for the stream's
    lifetime, and a fenced ledger write as exit code 3.  The
    lease ends marked ``fenced``, ``preempted`` or ``idle``; the SIGTERM
    handler and the retry deadline are put back at the end.  A worker
    that ends with another code writes no done lease, so its supervisor
    counts a crash."""
    resolve_device(args.device)
    preempt, lease, fence, partition = _fleet_worker_context(args)
    try:
        rc = body(args, preempt, lease, fence, partition)
        if lease is not None and rc == 0:
            lease.mark_done("preempted" if preempt else "idle")
        return rc
    except FencedEpochError as exc:
        # the staged epoch stays uncommitted; the next recover() rolls
        # it back
        print(f"error: {exc}", file=sys.stderr)
        if lease is not None:
            lease.mark_done("fenced")
        return 3
    finally:
        preempt.uninstall()
        if lease is not None and args.lease_timeout:
            configure_lease_deadline(None)


def _preseen(args: argparse.Namespace, ledger) -> list:
    """The files a stream never reads again: its ledger's committed
    sources, or in a fleet every worker's (a file committed by a worker
    a resize retired must not replay)."""
    if args.fleet_dir:
        return sorted(fleet_committed_sources(args.fleet_dir))
    return sorted(ledger.committed_sources())


def cmd_stream_score(args: argparse.Namespace) -> int:
    """Watch a directory and score arriving books incrementally (the
    LDALoader flow as a micro-batch stream)."""
    return _stream(args, lambda *frame: _with_telemetry(
        args, args.device, lambda: _stream_score(*frame)))


def _stream_score(args: argparse.Namespace, preempt, lease, fence,
                  partition) -> int:
    try:
        model_path, model = resolve_latest_model(
            args.models_dir, args.lang, explicit=args.model,
            verify_deep=args.verify_deep, device=args.device,
        )
    except CorruptArtifactError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(f"loaded model {model_path}: k={model.k}, V={model.vocab_size}")
    telemetry.manifest(kind="stream-score", model=model_path,
                       vocab_width=model.vocab_size, watch_dir=args.watch_dir,
                       **_worker_manifest_fields(args))
    tracing.emit_adopt()

    # with --checkpoint-dir every trigger is one committed epoch: its
    # report and its consumed files commit in one ledger append, so a
    # restarted stream emits each report exactly once
    ledger = None
    preseen: list = []
    if args.checkpoint_dir:
        ledger = EpochLedger(args.checkpoint_dir, fence=fence)
        ledger.recover()
        preseen = _preseen(args, ledger)
        _note_replays_suppressed(preseen, args.checkpoint_dir)
    src = FileStreamSource(
        args.watch_dir,
        include_all=args.include_all,
        max_files_per_trigger=args.max_files_per_trigger,
        min_file_age_s=args.min_file_age,
        preseen=preseen,
        partition=partition,
    )
    controller = _make_trigger_controller(args)
    scorer = StreamingScorer(
        model,
        stop_words=_load_stop_words(args.stop_words),
        lemmatize=not args.no_lemmatize,
        batch_capacity=args.batch_capacity,
        # ledgered streams write a report an epoch and keep nothing
        keep_results=not args.no_report and ledger is None,
        quarantine_dir=args.quarantine_dir,
    )
    for mb in src.stream(
            poll_interval=args.poll_interval, idle_timeout=args.idle_timeout,
            heartbeat=lease.heartbeat_callback() if lease else None,
            stop=preempt):
        t0 = time.perf_counter()
        out = scorer.process(mb)
        for sd in out:
            print(f"[batch {mb.batch_id}] "
                  f"{os.path.basename(sd.name)} -> topic {sd.topic}")
        if ledger is not None:
            epoch = ledger.next_epoch()
            fname = f"Result_{args.lang}_epoch-{epoch:06d}"
            path = os.path.join(args.output_dir, fname)
            ledger.begin(epoch, kind="stream-score", sources=mb.names,
                         payloads=[path])
            text = format_scoring_report(
                model,
                [sd.name for sd in out],
                np.stack([sd.distribution for sd in out])
                if out else np.zeros((0, model.k)),
                [sd.row for sd in out],
            )
            write_scoring_report(text, args.output_dir, args.lang,
                                 filename=fname)
            ledger.commit(epoch, kind="stream-score", sources=mb.names,
                          payloads={fname: path}, model_ref=model_path)
            print(f"[epoch {epoch}] report committed: {path}")
            if lease is not None:
                lease.beat(queue_depth=src.last_queue_depth, epoch=epoch)
        if controller is not None:
            controller.update(src.last_queue_depth, time.perf_counter() - t0)
            controller.apply(src)
    for t, c in enumerate(scorer.tallies):
        print(f"topic {t}: {c} books")
    if scorer.results and not args.no_report and ledger is None:
        path = scorer.write_report(args.output_dir, args.lang)
        print(f"report written to {path}")
    if preempt:
        print("preemption notice honored: in-flight trigger drained, "
              "stream stopped cleanly")
    return 0


def cmd_stream_train(args: argparse.Namespace) -> int:
    """Continuous online-VB training over a watched directory, on one
    device or a (data, model) grid of ranks; saves the final model as
    ``train`` does."""
    return _on_grid(args, _stream_train_on, stream=True)


def _stream_train_on(args: argparse.Namespace, grid) -> int:
    """``stream-train`` on one device (grid None) or one rank of a grid:
    the stream's frame (the lease, the fence, the SIGTERM drain) in the
    process that polls and commits, rank 0; the other ranks follow it.
    Each rank writes its own telemetry stream, and each adopts the
    spawner's ``STC_TRACE``, so every rank's triggers hang off it."""
    device = args.device if grid is None else grid.device
    if grid is None or grid.rank == 0:
        return _stream(args, lambda *frame: _with_telemetry(
            args, device, lambda: _stream_train(*frame, grid=grid)))
    tracing.adopt_env()
    return _with_telemetry(args, device, lambda: _stream_train(
        args, None, None, None, None, grid=grid))


def _stream_train(args: argparse.Namespace, preempt, lease, fence,
                  partition, grid=None) -> int:
    device = args.device if grid is None else grid.device
    params = Params(
        input=args.watch_dir,
        k=args.k,
        algorithm="online",
        checkpoint_dir=args.checkpoint_dir,
        seed=args.seed,
        data_shards=args.data_shards,
        model_shards=args.model_shards,
    )
    vocab = None
    num_features = args.hash_features
    if args.vocab_from_model:
        try:
            vocab = load_model(args.vocab_from_model, device=device).vocab
        except CorruptArtifactError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        num_features = None
    # the gate runs before the trainer restores from the ledger (or a
    # pre-ledger stream_state.npz)
    rc = _resume_gate(
        params,
        vocab if vocab is not None else [f"h{i}" for i in range(num_features)],
        args.resume,
        state_name="stream_state.npz",
        ledgered=bool(params.checkpoint_dir),
    )
    if rc is not None:
        return rc
    telemetry.manifest(
        params=params, kind="stream-train",
        vocab_width=len(vocab) if vocab is not None else num_features,
        watch_dir=args.watch_dir, **({} if grid is None else {"mesh": grid}),
        **_worker_manifest_fields(args),
    )
    tracing.emit_adopt()
    trainer = StreamingOnlineLDA(
        params,
        vocab=vocab,
        num_features=num_features,
        stop_words=_load_stop_words(args.stop_words),
        lemmatize=not args.no_lemmatize,
        batch_capacity=args.batch_capacity,
        corpus_size_hint=args.corpus_size_hint,
        checkpoint_every=args.checkpoint_interval,
        quarantine_dir=args.quarantine_dir,
        device=device,
        fence=fence,
        grid=grid,
    )
    if grid is not None and grid.rank != 0:
        # rank 0 reads the source and shares each micro-batch
        trainer.run()
        if trainer.aborted:
            return 0            # rank 0 failed: its exit code tells
        return _stream_train_end(args, params, trainer, trainer.stopped)
    # source progress is exactly-once through the trainer's ledger: its
    # committed paths are never ingested again; the pre-ledger
    # seen_files.txt is still read and written
    preseen = [] if trainer.ledger is None else _preseen(args, trainer.ledger)
    _note_replays_suppressed(preseen, params.checkpoint_dir)
    src = FileStreamSource(
        args.watch_dir,
        include_all=args.include_all,
        max_files_per_trigger=args.max_files_per_trigger,
        min_file_age_s=args.min_file_age,
        preseen=preseen,
        partition=partition,
        state_path=(os.path.join(args.checkpoint_dir, "seen_files.txt")
                    if args.checkpoint_dir else None),
    )
    trainer.run(src, controller=_make_trigger_controller(args),
                poll_interval=args.poll_interval,
                idle_timeout=args.idle_timeout,
                heartbeat=lease.heartbeat_callback() if lease else None,
                stop=preempt)
    # on a grid, the stop every rank was told of
    return _stream_train_end(args, params, trainer, bool(
        preempt if grid is None else trainer.stopped))


def _stream_train_end(args: argparse.Namespace, params: Params, trainer,
                      preempted: bool) -> int:
    """The end of ``stream-train``: the summary, then (unless preempted)
    the model, fetched on every rank of a grid, published by rank 0."""
    leader = trainer.grid is None or trainer.grid.rank == 0
    say = print if leader else _quiet
    say(f"stream ended: {trainer.docs_seen} docs / "
        f"{trainer.batches_seen} micro-batches")
    if preempted:
        # the in-flight epoch is committed (or rolls back); the resumed
        # run publishes the model
        say("preemption notice honored: epoch committed, model "
            "publish deferred to the resumed worker")
        return 0
    model = trainer.model()
    if not leader:
        return 0
    for i, topic in enumerate(model.describe_topics_terms(10)):
        print(f"TOPIC {i}: " + ", ".join(t for t, _ in topic))
    out_dir = model_dir_name(args.lang, base=args.models_dir)
    if trainer.ledger is not None:
        # the model dir names its publishing epoch in meta.json, and a
        # model-publish record pins the sealed dir (its manifest digest)
        publish_epoch = trainer.ledger.next_epoch()
        save_model(model, out_dir, ledger_ref={
            "dir": params.checkpoint_dir, "epoch": publish_epoch})
        trainer.ledger.begin(publish_epoch, kind="model-publish",
                             sources=[], payloads=[])
        trainer.ledger.commit(publish_epoch, kind="model-publish",
                              sources=[], model_ref=artifact_ref(out_dir))
    else:
        model.save(out_dir)
    print(f"model saved to {out_dir}")
    telemetry.event("model_saved", path=out_dir, k=model.k,
                    vocab_size=model.vocab_size, algorithm="online")
    return 0


def cmd_stream_requeue(args: argparse.Namespace) -> int:
    """Replay a quarantine dir into a watch directory: payloads move into
    the watch dir, error sidecars to ``<quarantine-dir>/.archive/``;
    ``--dry-run`` lists without moving."""
    res = requeue(args.quarantine_dir, args.watch_dir, dry_run=args.dry_run)
    verb = "would replay" if args.dry_run else "replayed"
    for p in res["replayed"]:
        print(f"{verb}: {os.path.basename(p)} -> {args.watch_dir}")
    averb = "would archive" if args.dry_run else "archived"
    for p in res["archived"]:
        print(f"{averb}: {os.path.basename(p)}")
    for p in res["skipped"]:
        print(f"skipped (move failed, still quarantined): {p}",
              file=sys.stderr)
    print(
        f"{len(res['replayed'])} {verb}, "
        f"{len(res['archived'])} {averb}, {len(res['skipped'])} skipped"
    )
    return 1 if res["skipped"] else 0


def cmd_stream_compact(args: argparse.Namespace) -> int:
    """Fold a stream checkpoint dir's committed ``epochs.jsonl`` history
    into one checksummed snapshot record (resume then reads one line):
    the seen-set, the newest shard plan and the training counters
    survive; per-epoch report digests go."""
    led = EpochLedger(args.checkpoint_dir)
    rep = led.recover()
    if rep.rolled_back or rep.truncated_lines:
        print(
            f"recover: rolled back {len(rep.rolled_back)} uncommitted "
            f"epoch(s), truncated {rep.truncated_lines} torn append(s)"
        )
    try:
        snap = led.compact()
    except CorruptArtifactError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if snap is None:
        print(
            f"nothing to compact in {args.checkpoint_dir} "
            f"(fewer than two committed records)"
        )
        return 0
    print(
        f"compacted {snap['compacted_epochs']} committed records into "
        f"one snapshot (epoch {snap['epoch']}, "
        f"{len(snap['sources'])} sources"
        + (f", {len(snap['shards'])} shard(s)" if snap.get("shards")
           else "")
        + ")"
    )
    return 0


# ---- the supervised fleet -------------------------------------------------
def _worker_argv(args: argparse.Namespace, index: int, count: int,
                 generation: int, spawn_id: int) -> List[str]:
    """One ``supervise`` worker's command line: a stream verb of this CLI
    with the fleet flags, its partition's checkpoint dir, and
    ``--device`` where the supervisor was given one."""
    argv = [
        sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
        args.role,
    ]
    if args.worker_telemetry_dir:
        # one run stream an incarnation (the spawn id in the name): a
        # respawn must not truncate the dead incarnation's stream
        argv += ["--telemetry-file", os.path.join(
            args.worker_telemetry_dir,
            f"worker-w{index:03d}-s{spawn_id}.jsonl")]
    argv += [
        "--watch-dir", args.watch_dir,
        "--checkpoint-dir", worker_dir(args.fleet_dir, index),
        "--fleet-dir", args.fleet_dir,
        "--worker-index", str(index),
        "--worker-count", str(count),
        "--fleet-generation", str(generation),
        "--fleet-spawn-id", str(spawn_id),
        "--heartbeat-interval", str(args.heartbeat_interval),
        "--lease-timeout", str(args.lease_timeout),
        "--poll-interval", str(args.poll_interval),
        "--idle-timeout", str(args.idle_timeout),
        "--lang", args.lang,
    ]
    if args.max_files_per_trigger is not None:
        argv += ["--max-files-per-trigger", str(args.max_files_per_trigger)]
    if args.no_lemmatize:
        argv.append("--no-lemmatize")
    if args.include_all:
        argv.append("--include-all")
    if args.stop_words:
        argv += ["--stop-words", args.stop_words]
    if args.quarantine_dir:
        argv += ["--quarantine-dir", args.quarantine_dir]
    if args.role == "stream-score":
        argv += ["--output-dir",
                 os.path.join(args.output_dir, f"w{index:03d}")]
        if args.model:
            argv += ["--model", args.model]
        else:
            argv += ["--models-dir", args.models_dir]
    else:
        argv += [
            "--k", str(args.k),
            "--hash-features", str(args.hash_features),
            "--seed", str(args.seed),
            "--checkpoint-interval", str(args.checkpoint_interval),
            "--models-dir", os.path.join(args.models_dir, f"w{index:03d}"),
        ]
    if args.device is not None:
        argv += ["--device", args.device]
    return argv + args.worker_arg


def cmd_supervise(args: argparse.Namespace) -> int:
    """Run an elastic, preemption-tolerant fleet of ``stream-score`` or
    ``stream-train`` workers over a watch directory: partitioned over the
    arriving files, heartbeat-leased, SIGTERM then SIGKILL on lease
    expiry, resized between committed epochs with fence tokens so that a
    zombie's writes are refused.  ``--role serve`` runs ``serve`` replicas
    behind the routing front instead (``_supervise_serve``)."""
    unused = _unused_supervise_flags(args)
    if unused:
        for flag, why in unused:
            print(f"error: {flag}: {why}", file=sys.stderr)
        return 2
    if args.role != "serve" and not args.watch_dir:
        print("--watch-dir is required for stream roles", file=sys.stderr)
        return 2
    worker_faults = {}
    for spec in args.chaos_worker:
        idx_s, _, fault = spec.partition(":")
        if not fault:
            print(f"bad --chaos-worker {spec!r} "
                  f"(want <index>:<site>:<kind>[@arg])", file=sys.stderr)
            return 2
        worker_faults[int(idx_s)] = fault
    resize_plan = []
    for spec in args.resize_at:
        at_s, _, n_s = spec.partition(":")
        try:
            resize_plan.append({"at_epochs": int(at_s), "workers": int(n_s)})
        except ValueError:
            print(f"bad --resize-at {spec!r} (want <epochs>:<workers>)",
                  file=sys.stderr)
            return 2
    # no card and no --device cpu: raise before any worker starts; the
    # workers load the text library, so build it here, once
    resolve_device(args.device)
    try:
        native.build()
    except RuntimeError:
        pass  # the workers take the Python text path, as "auto" does
    if args.ship_to:
        # the environment, not the argv: every worker inherits it (the
        # supervisor copies this environment) and the supervisor's own
        # stream ships through configure(): one knob, every stream
        os.environ[telemetry.transport.ENV_SHIP_TO] = args.ship_to
    own_telemetry = args.telemetry_file is not None
    if own_telemetry:
        telemetry.configure(args.telemetry_file)
        telemetry.manifest(kind="supervise", role=args.role,
                           watch_dir=args.watch_dir,
                           fleet_dir=args.fleet_dir)
    try:
        if args.role == "serve":
            return _supervise_serve(args, worker_faults)
        return _run_fleet(args, worker_faults, resize_plan)
    finally:
        if own_telemetry:
            telemetry.shutdown()


def _unused_supervise_flags(args: argparse.Namespace) -> List[tuple]:
    """(flag, reason) for each ``supervise`` flag the given role would
    ignore, where the JAX verb accepts it and does nothing: a serve fleet
    resizes from ``--actions-file`` only, and the autoscaler runs only in
    a serve fleet's front and acts only through the actions file."""
    out = []
    if args.role == "serve":
        out += [(flag, "a serve fleet resizes from --actions-file only")
                for flag, given in (
                    ("--resize-at", bool(args.resize_at)),
                    ("--scale-out-depth", args.scale_out_depth is not None),
                    ("--scale-out-sweeps", args.scale_out_sweeps != 3),
                    ("--scale-in-sweeps", args.scale_in_sweeps is not None),
                ) if given]
    if args.autoscale and (args.role != "serve" or args.front_port is None
                           or args.actions_file is None):
        out.append(("--autoscale", "requires --role serve, --front-port "
                                   "and --actions-file"))
    return out


def _run_fleet(args: argparse.Namespace, worker_faults, resize_plan) -> int:
    """``supervise``'s fleet, run to convergence; its exit code."""
    sup = FleetSupervisor(
        args.fleet_dir,
        lambda *ids: _worker_argv(args, *ids),
        workers=args.workers,
        min_workers=args.min_workers,
        max_workers=args.max_workers,
        lease_timeout=args.lease_timeout,
        grace_seconds=args.grace_seconds,
        startup_grace_seconds=args.startup_grace,
        sweep_interval=args.sweep_interval,
        scale_out_depth=args.scale_out_depth,
        scale_out_sweeps=args.scale_out_sweeps,
        scale_in_sweeps=args.scale_in_sweeps,
        max_respawns=args.max_respawns,
        resize_plan=resize_plan,
        worker_faults=worker_faults,
        actions_file=args.actions_file,
    )
    try:
        rep = sup.run()
    except ResilienceError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(
        f"fleet converged: {rep.committed_epochs} committed epoch(s) "
        f"across {rep.final_workers} worker(s) — "
        f"{rep.spawns} spawn(s), {rep.respawns} respawn(s), "
        f"{rep.resizes} resize(s), {rep.lease_expiries} lease "
        f"expiry(ies), {rep.preemptions} preemption(s) survived, "
        f"{rep.crashes} crash(es)"
    )
    return 0


def _serve_replica_argv(args: argparse.Namespace, index: int, count: int,
                        generation: int, spawn_id: int) -> List[str]:
    """One ``supervise --role serve`` replica's command line: ``serve`` of
    this CLI on an auto-picked port with the fleet flags (the JAX
    package's argv, this package's module), then ``--device`` where the
    supervisor was given one and the ``--worker-arg`` extras."""
    argv = [
        sys.executable, "-m", "spark_text_clustering_tpu_torch.cli", "serve",
    ]
    if args.worker_telemetry_dir:
        argv += ["--telemetry-file", os.path.join(
            args.worker_telemetry_dir,
            f"worker-w{index:03d}-s{spawn_id}.jsonl")]
    argv += [
        "--models-dir", args.models_dir,
        "--lang", args.lang,
        "--port", "0",              # auto-picked; announced in the lease
        "--max-batch", str(args.serve_max_batch),
        "--linger-ms", str(args.serve_linger_ms),
        "--fleet-dir", args.fleet_dir,
        "--worker-index", str(index),
        "--fleet-generation", str(generation),
        "--fleet-spawn-id", str(spawn_id),
        "--heartbeat-interval", str(args.heartbeat_interval),
        "--lease-timeout", str(args.lease_timeout),
    ]
    if args.model:
        argv += ["--model", args.model]
    if args.no_lemmatize:
        argv.append("--no-lemmatize")
    if args.stop_words:
        argv += ["--stop-words", args.stop_words]
    if args.quarantine_dir:
        argv += ["--quarantine-dir", args.quarantine_dir]
    if args.serve_emulate_doc_ms is not None:
        argv += ["--emulate-doc-ms", str(args.serve_emulate_doc_ms)]
    if args.serve_max_queue is not None:
        argv += ["--max-queue", str(args.serve_max_queue)]
    if args.serve_batch_weight is not None:
        argv += ["--batch-weight", str(args.serve_batch_weight)]
    if args.device is not None:
        argv += ["--device", args.device]
    return argv + args.worker_arg


def _queueing_tick(est, streams, seen: float, now: float, scaler=None,
                   emitter=None) -> float:
    """One pass of ``supervise --role serve``'s queueing loop: the front's
    request outcomes counted since ``seen`` as arrivals, the replicas'
    streams as service, one ``queueing_estimate`` event, and the
    autoscaler's decision on it (``_autoscale``); returns the outcome
    total to pass as ``seen`` next time."""
    snap = telemetry.get_registry().snapshot()["counters"]
    total = sum(v for k, v in snap.items()
                if k.startswith("front.request_outcomes."))
    if total > seen:
        est.note_arrivals(total - seen, now)
        seen = total
    if streams is not None:
        for e in streams.poll():
            ts = e.get("ts")
            est.observe_event(float(ts) if isinstance(ts, (int, float))
                              and not isinstance(ts, bool) else now, e)
    ev = est.estimate(now)
    if ev is not None:
        telemetry.event("queueing_estimate", **{
            k: v for k, v in ev.items() if k not in ("event", "ts")})
        if scaler is not None:
            _autoscale(scaler, emitter, ev, now)
    return seen


def _autoscale(scaler, emitter, estimate: dict, now: float):
    """The autoscaler's decision on one queueing estimate, written to the
    actions file as a one-replica ``scale_out`` or ``scale_in`` request
    (the JAX loop's fields); returns the decision or None."""
    decision = scaler.decide(estimate, now)
    if decision is None:
        return None
    emitter.emit(decision["action"], alert="autoscale_rho",
                 key="queueing.rho", value=decision["rho"], workers_delta=1)
    try:
        emitter.flush()
    except OSError:
        pass  # the next decision writes the file again
    return decision


def _supervise_serve(args: argparse.Namespace, worker_faults) -> int:
    """``supervise --role serve``: N ``serve`` replicas on auto-picked
    ports, with the routing front in this process under ``--front-port``,
    until SIGTERM or ``--max-seconds``; its exit code.  The front's
    outcome counters and the replicas' streams under
    ``--worker-telemetry-dir`` feed a queueing estimate
    (``queueing_estimate`` events) twice a second, and with
    ``--autoscale`` the autoscaler's requests on ``--actions-file``
    (``_queueing_tick``)."""
    import threading

    from .resilience.supervisor import ServeFleetSupervisor

    preempt = PreemptionNotice().install()
    sup = ServeFleetSupervisor(
        args.fleet_dir,
        lambda *ids: _serve_replica_argv(args, *ids),
        models_dir=args.models_dir,
        lang=args.lang,
        stop=preempt,
        max_seconds=args.max_seconds,
        swap_timeout=args.swap_timeout,
        worker_faults=worker_faults,
        workers=args.workers,
        min_workers=args.min_workers,
        max_workers=args.max_workers,
        lease_timeout=args.lease_timeout,
        grace_seconds=args.grace_seconds,
        startup_grace_seconds=args.startup_grace,
        sweep_interval=args.sweep_interval,
        max_respawns=args.max_respawns,
        actions_file=args.actions_file,
    )
    front_httpd = None
    queue_stop = threading.Event()
    queue_thread = None
    if args.front_port is not None:
        from .serving.front import (
            FrontRouter,
            make_front_server,
            write_front_announce,
        )
        from .telemetry.alerts import ActionEmitter, StreamSet
        from .telemetry.queueing import PredictiveAutoscaler, QueueingEstimator

        router = FrontRouter(
            args.fleet_dir, lease_timeout=max(5.0, 2.0 * args.lease_timeout))
        front_httpd = make_front_server(router, "127.0.0.1", args.front_port)
        fhost, fport = front_httpd.server_address[:2]
        write_front_announce(args.fleet_dir, fhost, fport)
        threading.Thread(target=front_httpd.serve_forever,
                         name="stc-front-http", daemon=True).start()
        print(f"serve-fleet front on http://{fhost}:{fport}", flush=True)
        # the queueing estimate: arrivals from the front's own outcome
        # counters, service from the replicas' run streams; its
        # queueing.* gauges live in this registry, on the front's /metrics
        est = QueueingEstimator()
        qstreams = (StreamSet([os.path.join(args.worker_telemetry_dir,
                                            "worker-*.jsonl")])
                    if args.worker_telemetry_dir else None)
        scaler = emitter = None
        if args.autoscale:
            # the decisions ride the actions file the monitor's alerts
            # use: the supervisor applies them, acked and clamped
            scaler = PredictiveAutoscaler(
                min_replicas=args.min_workers,
                max_replicas=args.max_workers,
                high_rho=args.autoscale_high_rho,
                low_rho=args.autoscale_low_rho,
                confirm=args.autoscale_confirm,
                cooldown_seconds=args.autoscale_cooldown)
            emitter = ActionEmitter(args.actions_file)

        def _queue_loop() -> None:
            seen = 0
            while not queue_stop.is_set():
                seen = _queueing_tick(est, qstreams, seen, time.time(),
                                      scaler, emitter)
                queue_stop.wait(0.5)

        queue_thread = threading.Thread(target=_queue_loop,
                                        name="stc-queueing", daemon=True)
        queue_thread.start()
    try:
        rep = sup.run()
    except ResilienceError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    finally:
        preempt.uninstall()
        queue_stop.set()
        if queue_thread is not None:
            queue_thread.join(timeout=2.0)
        if front_httpd is not None:
            front_httpd.shutdown()
            front_httpd.server_close()
    print(
        f"serve fleet drained: {rep.final_workers} replica(s) — "
        f"{rep.spawns} spawn(s), {rep.respawns} respawn(s), "
        f"{rep.resizes} resize(s), {rep.swap_rolls} rolling swap(s), "
        f"{rep.crashes} crash(es)", flush=True
    )
    return 0


def cmd_front(args: argparse.Namespace) -> int:
    """The serve fleet's routing front alone: one port spreading ``/score``
    over the replicas a ``supervise --role serve`` fleet leases
    (least-outstanding routing, drain-aware, retry on another replica,
    per-stream generation pinning), its address announced in
    ``<fleet-dir>/front.json``, until SIGTERM or ``--max-seconds``.  It
    never touches the card."""
    import threading

    from .resilience import sleep as _idle_sleep
    from .serving.front import (
        FrontRouter,
        make_front_server,
        write_front_announce,
    )

    own_telemetry = args.telemetry_file is not None
    telemetry.configure(args.telemetry_file)
    if own_telemetry:
        telemetry.manifest(kind="front", fleet_dir=args.fleet_dir)
    preempt = PreemptionNotice().install()
    try:
        router = FrontRouter(
            args.fleet_dir,
            lease_timeout=args.lease_timeout,
            wait_for_replica_s=args.wait_for_replica,
            alerts_file=args.alerts_file,
            max_pending=args.max_pending,
            retry_budget=args.retry_budget,
        )
        httpd = make_front_server(router, args.host, args.port)
        host, port = httpd.server_address[:2]
        write_front_announce(args.fleet_dir, host, port)
        print(f"fronting fleet {args.fleet_dir} on http://{host}:{port} — "
              f"POST /score, GET /healthz /metrics", flush=True)
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="stc-front-http", daemon=True)
        thread.start()
        deadline = (time.monotonic() + args.max_seconds
                    if args.max_seconds else None)
        while not preempt:
            if deadline is not None and time.monotonic() >= deadline:
                break
            _idle_sleep(0.1)
        httpd.shutdown()
        httpd.server_close()
        h = router.health()
        print(f"front drained: {h['requests']} request(s) routed across "
              f"{len(h['replicas'])} replica(s), {h['retries']} retried",
              flush=True)
        return 0
    finally:
        preempt.uninstall()
        telemetry.shutdown()


def cmd_probe(args: argparse.Namespace) -> int:
    """The black-box canary: score one fixed sentinel document through the
    serve front at a fixed rate (or, with ``--ramp-to``, an open-loop
    ramp) and record what a client saw (outcome, latency, and whether
    the generations it was answered with ever went backward) in the
    probe's own run stream.  It never touches the card."""
    from .serving.probe import SENTINEL_TEXT, Prober, read_front_announce

    if not args.url and not args.fleet_dir:
        print("probe needs --fleet-dir or --url", file=sys.stderr)
        return 2
    ship_env = telemetry.transport.ENV_SHIP_TO
    before = os.environ.get(ship_env)
    if args.ship_to:
        # the port's telemetry ships where this variable says
        os.environ[ship_env] = args.ship_to
    own_telemetry = args.telemetry_file is not None
    telemetry.configure(args.telemetry_file)
    try:
        try:
            if args.url:
                part = args.url.split("//")[-1].rstrip("/")
                host, _, port_s = part.partition(":")
                host, port = host or "127.0.0.1", int(port_s or 80)
            else:
                host, port = read_front_announce(args.fleet_dir,
                                                 wait_s=args.wait_front)
        except (RuntimeError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        if own_telemetry:
            telemetry.manifest(
                kind="probe", host=host, port=port,
                fleet_dir=args.fleet_dir, stream=args.stream,
                count=args.count, rate=args.rate,
                priority=args.priority, ramp_to=args.ramp_to,
            )
        prober = Prober(host, port, stream=args.stream, timeout=args.timeout,
                        text=args.text or SENTINEL_TEXT,
                        priority=args.priority)
        if args.ramp_to is not None:
            # open loop: an overload generator, not a canary; the send
            # rate climbs however slowly the fleet answers
            rep = prober.run_ramp(count=args.count, rate=args.rate,
                                  ramp_to=args.ramp_to)
        else:
            rep = prober.run(count=args.count, rate=args.rate)
        print(
            f"probe done: {rep['sent']} probe(s) against "
            f"http://{host}:{port}, {rep['failures']} failure(s), "
            f"{rep['rejected']} rejected (typed 429), "
            f"{rep['degraded']} degraded answer(s), "
            f"{rep['pin_violations']} pin violation(s)", flush=True
        )
        bad = rep["failures"] + rep["pin_violations"]
        return 1 if args.fail_on_error and bad else 0
    finally:
        telemetry.shutdown()
        if before is None:
            os.environ.pop(ship_env, None)
        else:
            os.environ[ship_env] = before


def cmd_collect(args: argparse.Namespace) -> int:
    """The telemetry collector daemon: receives sequence-numbered batches
    from shippers (this package's or the JAX package's) on ``POST
    /ingest``, dedupes on ``(source_id, seq)`` and folds each source into
    a manifested JSONL stream under ``--dir``, so the ``metrics`` tools
    read the aggregated dir as they read a local one.  Serves
    ``/healthz`` and ``/metrics`` (Prometheus by content negotiation),
    announces its bound address in ``<dir>/collect.json``, and drains on
    SIGTERM or after ``--max-seconds``."""
    import threading

    from .telemetry import transport

    # a collector never ships its own run stream to itself: an inherited
    # STC_SHIP_TO would loop every folded event back in
    os.environ.pop(transport.ENV_SHIP_TO, None)
    own_telemetry = args.telemetry_file is not None
    telemetry.configure(args.telemetry_file)
    collector = transport.Collector(args.dir,
                                    registry=telemetry.get_registry())
    try:
        httpd = transport.make_collector_server(collector, args.host,
                                                args.port)
    except OSError as exc:
        print(f"error: cannot bind {args.host}:{args.port}: {exc}",
              file=sys.stderr)
        telemetry.shutdown()
        return 1
    host, port = httpd.server_address[:2]
    transport.write_collect_announce(args.dir, host, port)
    if own_telemetry:
        telemetry.manifest(kind="collect", collect_dir=args.dir, host=host,
                           port=port)
    serve_thread = threading.Thread(target=httpd.serve_forever,
                                    name="stc-collect-http", daemon=True)
    serve_thread.start()
    print(f"collector on http://{host}:{port} -> {args.dir}", flush=True)
    preempt = PreemptionNotice().install()
    stop = threading.Event()
    deadline = (time.monotonic() + args.max_seconds
                if args.max_seconds is not None else None)
    try:
        while not preempt():
            if deadline is not None and time.monotonic() >= deadline:
                break
            stop.wait(0.2)
    finally:
        preempt.uninstall()
        httpd.shutdown()
        httpd.server_close()
        serve_thread.join(timeout=5.0)
    stats = collector.stats()
    print(
        f"collector drained: {stats['sources']} source(s), "
        f"{stats['batches']} batch(es), {stats['ingested']} event(s), "
        f"{stats['duplicates']} duplicate batch(es) suppressed"
    )
    telemetry.shutdown()
    return 0


def _fmt_entry_size(n) -> str:
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB"):
        if n < 1024 or unit == "MiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}MiB"


def cmd_compile_cache(args: argparse.Namespace) -> int:
    """Maintenance verbs of the compile cache (``compilecache``), with the
    JAX package's flags, messages and exit codes: ``warm`` publishes the
    kernel libraries and warms the serve bucket grid, ``ls`` lists
    entries, ``gc`` prunes, ``verify`` re-hashes every committed entry."""
    import json as _json

    from . import compilecache

    root = args.cache_dir or os.environ.get(compilecache.ENV_DIR)
    if not root:
        print(
            "compile-cache requires --cache-dir or the "
            f"{compilecache.ENV_DIR} environment variable",
            file=sys.stderr,
        )
        return 2
    store = compilecache.configure(root)

    if args.cc_cmd == "ls":
        entries = store.entries()
        if getattr(args, "json", False):
            print(_json.dumps(
                {"root": root, "entries": entries}, sort_keys=True
            ))
            return 0
        print(f"executable cache {root}: {len(entries)} entry(ies)")
        for e in entries:
            mark = " STALE-FP" if e.get("stale") else ""
            print(
                f"  [{e['fingerprint']}] {e['digest']} "
                f"{e.get('label', '?')}: {e['status']}{mark}, "
                f"{_fmt_entry_size(e.get('payload_bytes'))}, "
                f"compiled in {e.get('compile_seconds')}s"
            )
        return 0

    if args.cc_cmd == "verify":
        entries = store.entries()
        findings = store.verify()
        if getattr(args, "json", False):
            print(_json.dumps(
                {
                    "root": root,
                    "entries": len(entries),
                    "findings": findings,
                },
                sort_keys=True,
            ))
        else:
            for f_ in findings:
                print(
                    f"  BAD [{f_['fingerprint']}] {f_['digest']}: "
                    f"{f_['finding']}"
                )
            print(
                f"verify: {len(entries) - len(findings)}/{len(entries)} "
                f"entry(ies) loadable"
            )
        return 1 if findings else 0

    if args.cc_cmd == "gc":
        removed = store.gc(args.keep_newest)
        print(
            f"gc: kept the {args.keep_newest} newest committed "
            f"entry(ies) per fingerprint — removed "
            f"{removed['entries']} entry(ies), {removed['stages']} "
            f"stale stage(s), {removed['quarantined']} quarantined"
        )
        return 0

    # warm: every kernel library into the store (built where neither the
    # store nor the build directory holds it), then the deterministic
    # serve bucket grid, so replicas and workers spawned later load
    # instead of building
    own_telemetry = bool(getattr(args, "telemetry_file", None))
    if own_telemetry:
        telemetry.configure(args.telemetry_file, device=args.device)
        telemetry.manifest(kind="compile-cache-warm", cache=root)
    from .serving.server import DEFAULT_TOKEN_BUCKETS, ServeScorer

    try:
        model_path, model = resolve_latest_model(
            args.models_dir, args.lang, explicit=args.model,
            verify_deep=True, device=args.device,
        )
    except CorruptArtifactError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    reg = telemetry.get_registry()
    cache0 = {k: reg.counter(f"compile.cache_{k}").value
              for k in ("hits", "misses", "stores")}
    _build.publish_all()
    buckets = tuple(args.token_bucket) or DEFAULT_TOKEN_BUCKETS
    scorer = ServeScorer(
        model, model_path, generation=0,
        stop_words=_load_stop_words(args.stop_words),
        lemmatize=not args.no_lemmatize,
        max_batch=args.max_batch,
        token_buckets=buckets,
        device=args.device,
    )
    report = scorer.warmup()
    # the libraries load before the warmup: count the whole verb
    report.update({f"cache_{k}": int(reg.counter(f"compile.cache_{k}").value
                                     - v0) for k, v0 in cache0.items()})
    print(
        f"warmed {model_path} buckets {report['buckets']} in "
        f"{report['warmup_seconds']}s — "
        f"{report.get('cache_stores', 0)} stored, "
        f"{report.get('cache_hits', 0)} already cached, "
        f"{report.get('cache_misses', 0)} miss(es)"
    )
    # coverage vs the committed signature expectation: which baseline
    # labels did this warm populate, and which need a real corpus-shaped
    # run (their signatures depend on document shapes we cannot invent)
    if args.baseline and os.path.exists(args.baseline):
        from .telemetry import compilation

        with open(args.baseline, encoding="utf-8") as f:
            expected = sorted(_json.load(f).get("labels", {}))
        warmed = set(compilation.signatures())
        for lbl in expected:
            state = (
                "populated" if lbl in warmed
                else "needs a corpus-shaped run (stc score/train "
                     "--compile-cache)"
            )
            print(f"  baseline label {lbl}: {state}")
    if own_telemetry:
        telemetry.event("compile_cache_warm", model=model_path, **{
            k: v for k, v in report.items() if k != "signatures"
        })
        telemetry.shutdown()
    return 0


def cmd_lineage(args: argparse.Namespace) -> int:
    """Walk the causal chain behind a served byte: from a model dir, a
    serve response JSON, or a trace id, resolve the publish epoch, every
    contributing worker's committed source set, the request's span chain,
    and the dispatch digests that served it (``lineage.walk``, the JAX
    package's walk).  Degrades typed on torn/corrupt/legacy records: exit
    0 with DEGRADED notes, never a crash; exit 3 only when the target
    itself is unresolvable.  It never touches the card."""
    import json as _json

    from . import lineage

    report = lineage.walk(
        args.target,
        fleet_dir=args.fleet_dir,
        ledger_dir=args.ledger_dir,
        telemetry_paths=args.telemetry or (),
    )
    if args.json:
        print(_json.dumps(report, sort_keys=True))
    else:
        print(lineage.render_tree(report))
    return 3 if report["kind"] == "unknown" else 0


def _kernel_toolchain() -> str:
    """The doctor's line on the CUDA kernels: the nvcc found (and its
    release) or missing, and how many of ``_build.SOURCES``'s libraries
    are built for the current sources and toolchain (``_build._digest``).
    Reads only: it builds nothing."""
    try:
        nvcc = _build._nvcc()
    except _build.KernelError:
        found = "nvcc missing"
    else:
        try:
            line = _build.nvcc_release()
        except _build.KernelError:
            line = ""
        release = (line.split("release", 1)[1].strip()
                   if "release" in line else "version unknown")
        found = f"{nvcc} ({release})"
    built = sum(_build._lib_path(name).exists() for name in _build.SOURCES)
    return (f"{found}, {built}/{len(_build.SOURCES)} libraries built for "
            f"{_build._digest()} in {_build.BUILD_DIR}")


def cmd_doctor(args: argparse.Namespace) -> int:
    """Environment health report: whether torch sees the card (probed in
    a throwaway subprocess, so a wedged card can only time out, never
    hang this process), the CPU path, the native text library, and the
    CUDA kernels' toolchain and built libraries.  This process makes no
    CUDA context and builds no kernel; the text library is built on first
    use, as every verb that preprocesses builds it.  Always exit 0."""
    from .utils.env import probe_accelerator, scrubbed_cpu_env

    print("spark_text_clustering_tpu_torch doctor")

    acc = probe_accelerator(
        attempts=1, probe_timeout=args.probe_timeout,
        require_accelerator=False,
    )
    if acc["ok"] and acc["backend"] != "cpu":
        print(f"  accelerator: OK — torch {acc['version']}, cuda "
              f"{acc.get('cuda')}, {acc['devices']} device(s) "
              f"({acc.get('name')})")
    elif acc["ok"]:
        # torch came up without a CUDA device: no reachable card
        print(f"  accelerator: NONE — torch {acc['version']} sees no CUDA "
              f"device ({acc['devices']} device(s))")
    else:
        print(f"  accelerator: UNREACHABLE ({acc['error']})")

    cpu = probe_accelerator(
        attempts=1, probe_timeout=120, require_accelerator=False,
        env=scrubbed_cpu_env(),
    )
    if not cpu["ok"]:
        state = f"FAILED ({cpu['error']})"
    elif not cpu.get("gloo"):
        state = "FAILED (torch.distributed has no gloo backend)"
    else:
        state = "OK"
    print(f"  cpu path (--device cpu, gloo): {state}")

    text_ok = native._load() is not None
    print(f"  native textproc (C++ ctypes): "
          f"{'OK' if text_ok else 'unavailable — Python path'}")

    print(f"  kernels (nvcc, sm_90a): {_kernel_toolchain()}")
    return 0


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device for IDF, training and scoring "
                        "(default cuda; cpu runs the kernels' plain "
                        "PyTorch versions on the host)")


def _add_grid_args(p: argparse.ArgumentParser, data_default) -> None:
    p.add_argument("--data-shards", type=int, default=data_default,
                   help="document shards of the grid")
    p.add_argument("--model-shards", type=int, default=1,
                   help="vocabulary shards of the grid")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0: join a grid started by the "
                        "caller instead of spawning its ranks here")
    p.add_argument("--num-processes", type=int, default=None,
                   help="ranks of the grid (data x model shards)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend of a grid (default "
                        "nccl on cuda, gloo on cpu; nccl takes one rank a "
                        "card)")


def _add_compile_cache_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--compile-cache", default=None, metavar="DIR",
        help="compile cache root: the CUDA kernel libraries load from "
             "its committed entries instead of building, and libraries "
             "built or found in the build directory publish back "
             "(equivalent to STC_COMPILE_CACHE=DIR; exported to the "
             "environment so spawned workers, replicas and grid ranks "
             "inherit it)",
    )


def _add_stream_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's stream flags, with their defaults."""
    _add_compile_cache_arg(p)
    p.add_argument("--watch-dir", required=True,
                   help="directory to watch for arriving .txt files")
    p.add_argument("--poll-interval", type=float, default=1.0)
    p.add_argument("--idle-timeout", type=float, default=30.0,
                   help="stop after this many idle seconds")
    p.add_argument("--max-files-per-trigger", type=int, default=None)
    p.add_argument("--adaptive-trigger", action="store_true",
                   help="AIMD-adapt max_files_per_trigger from queue "
                        "depth and per-batch seconds")
    p.add_argument("--target-batch-seconds", type=float, default=2.0,
                   help="per-trigger latency budget the adaptive "
                        "controller steers toward")
    p.add_argument("--min-file-age", type=float, default=0.0,
                   help="seconds a file's mtime must settle before pickup "
                        "(use when producers don't rename atomically)")
    p.add_argument("--batch-capacity", type=int, default=8,
                   help="device batch rows per trigger (pinned shape)")
    p.add_argument("--stop-words", default=None)
    p.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    p.add_argument("--no-lemmatize", action="store_true")
    p.add_argument("--include-all", action="store_true")
    p.add_argument("--telemetry-file", default=None,
                   help="write the run's telemetry stream (JSONL: manifest, "
                        "events, final registry snapshot) here; each rank "
                        "of a grid writes <stem>-p<rank><ext>")
    p.add_argument("--quarantine-dir", default=None,
                   help="dead-letter dir for per-document failures: the "
                        "offending doc and a structured .error.json "
                        "sidecar land here instead of killing the stream")
    # a fleet worker's flags (passed by ``supervise``): identity, fence
    # token and lease cadence
    p.add_argument("--fleet-dir", default=None,
                   help="fleet dir of a supervising `supervise` process: "
                        "enables the heartbeat lease, the fence-token "
                        "check on every ledger write, and the file "
                        "partition")
    p.add_argument("--worker-index", type=int, default=0,
                   help="this worker's index in the fleet")
    p.add_argument("--worker-count", type=int, default=1,
                   help="fleet width (files partition by "
                        "sha256(basename) %% count)")
    p.add_argument("--fleet-generation", type=int, default=0,
                   help="fence token: topology generation at spawn")
    p.add_argument("--fleet-spawn-id", type=int, default=0,
                   help="fence token: this incarnation's spawn id")
    p.add_argument("--heartbeat-interval", type=float, default=0.5,
                   help="seconds between lease renewals")
    p.add_argument("--lease-timeout", type=float, default=None,
                   help="the supervisor's lease timeout, installed as the "
                        "process-wide retry deadline so no retry loop "
                        "outlives the lease")
    _add_device_arg(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spark_text_clustering_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train an LDA topic model on a book dir")
    tr.add_argument("--books", required=True)
    tr.add_argument("--stop-words", default=None)
    tr.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    tr.add_argument("--k", type=int, default=5)
    tr.add_argument("--max-iterations", type=int, default=50)
    tr.add_argument("--doc-concentration", type=float, default=-1)
    tr.add_argument("--topic-concentration", type=float, default=-1)
    tr.add_argument("--vocab-size", type=int, default=2_900_000)
    tr.add_argument(
        "--algorithm", default="em", choices=["em", "online", "nmf"]
    )
    tr.add_argument(
        "--sampling", default="bernoulli",
        choices=["bernoulli", "fixed", "epoch"],
        help="online minibatch sampling: MLlib's per-doc Bernoulli(f) "
             "(default), fixed-size round(f*N), or shuffled epochs (the "
             "one the port runs today)",
    )
    tr.add_argument(
        "--token-layout", default="auto", dest="token_layout",
        choices=["padded", "packed", "tiles", "auto"],
        help="training token layout: padded [B, L] grids, packed flat "
             "[T] token batches, tiles (online + --sampling epoch only), "
             "or auto (decided as the JAX package decides)",
    )
    tr.add_argument(
        "--record-iteration-times", action="store_true",
        help="one sync per iteration, so the saved model carries true "
             "per-iteration wall times instead of interval means",
    )
    tr.add_argument("--checkpoint-dir", default=None)
    tr.add_argument("--checkpoint-interval", type=int, default=10)
    tr.add_argument("--resume", action="store_true",
                    help="continue from the newest VALID checkpoint in "
                         "--checkpoint-dir (config-hash + vocab-fingerprint "
                         "validated; starts fresh when none is found)")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--models-dir", default="models")
    tr.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of training here "
                         "(Chrome trace JSON)")
    tr.add_argument("--metrics-file", default=None,
                    help="append structured JSONL metrics (phases, "
                         "per-iteration times) to this file")
    tr.add_argument("--telemetry-file", default=None,
                    help="write the run's telemetry stream (JSONL: "
                         "manifest, events, final registry snapshot) here; "
                         "each rank of a grid writes <stem>-p<rank><ext>")
    tr.add_argument("--no-tfidf", action="store_true",
                    help="train on raw counts instead of TF-IDF pseudo-counts")
    tr.add_argument("--export-mllib", action="store_true",
                    help="also write the model in Spark MLlib's "
                         "DistributedLDAModel layout to <model dir>_mllib "
                         "(EM only; needs pyarrow)")
    tr.add_argument("--no-lemmatize", action="store_true")
    tr.add_argument("--include-all", action="store_true",
                    help="ingest non-.txt files too (reference behavior)")
    _add_compile_cache_arg(tr)
    _add_grid_args(tr, None)
    _add_device_arg(tr)
    tr.set_defaults(fn=cmd_train)

    sc = sub.add_parser("score", help="score books against a saved model")
    sc.add_argument("--books", default=None)
    sc.add_argument("--books-root", default=None,
                    help="root containing per-language dirs (LDALoader routing)")
    sc.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    sc.add_argument("--stop-words", default=None)
    sc.add_argument("--models-dir", default="models")
    sc.add_argument("--model", default=None, help="explicit model dir")
    sc.add_argument("--output-dir", default="TestOutput")
    sc.add_argument("--no-lemmatize", action="store_true")
    sc.add_argument("--include-all", action="store_true")
    _add_grid_args(sc, 1)
    sc.add_argument("--verify-deep", action="store_true",
                    help="re-verify each candidate model's SHA256 "
                         "manifest at selection time instead of trusting "
                         "its COMMIT marker; corrupt dirs fall back to "
                         "the next newest committed one")
    sc.add_argument("--per-doc-convergence", action="store_true",
                    help="freeze each document's gamma the iteration ITS "
                         "OWN change drops below tol, so each distribution "
                         "depends on its own document only")
    sc.add_argument("--telemetry-file", default=None,
                    help="write the run's telemetry stream (JSONL) here; "
                         "each rank of a grid writes <stem>-p<rank><ext>")
    _add_compile_cache_arg(sc)
    _add_device_arg(sc)
    sc.set_defaults(fn=cmd_score)

    ss = sub.add_parser(
        "stream-score",
        help="watch a directory, score arriving books incrementally",
    )
    _add_stream_args(ss)
    ss.add_argument("--models-dir", default="models")
    ss.add_argument("--model", default=None, help="explicit model dir")
    ss.add_argument("--output-dir", default="TestOutput")
    ss.add_argument("--no-report", action="store_true",
                    help="per-doc output only; no accumulated report "
                         "(constant memory for endless streams)")
    ss.add_argument("--checkpoint-dir", default=None,
                    help="epoch commit ledger dir: every trigger commits "
                         "its report and consumed files transactionally, "
                         "so a restarted stream emits each report exactly "
                         "once")
    ss.add_argument("--verify-deep", action="store_true",
                    help="re-verify the selected model's SHA256 manifest "
                         "at selection time")
    ss.set_defaults(fn=cmd_stream_score)

    st = sub.add_parser(
        "stream-train",
        help="continuous online-VB LDA over a watched directory",
    )
    _add_stream_args(st)
    st.add_argument("--k", type=int, default=5)
    st.add_argument("--hash-features", type=int, default=1 << 18,
                    help="HashingTF buckets (streams have no vocab pass)")
    st.add_argument("--vocab-from-model", default=None,
                    help="reuse a saved model's vocabulary instead of hashing")
    st.add_argument("--corpus-size-hint", type=int, default=None)
    st.add_argument("--checkpoint-dir", default=None)
    st.add_argument("--checkpoint-interval", type=int, default=10)
    st.add_argument("--resume", action="store_true",
                    help="continue from the newest committed epoch in "
                         "--checkpoint-dir (config-hash and "
                         "vocab-fingerprint validated)")
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--data-shards", type=int, default=None,
                    help="document shards of the grid (ranks spawned "
                         "here; rank 0 reads the source)")
    st.add_argument("--model-shards", type=int, default=1,
                    help="vocabulary shards of the grid")
    st.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of a grid (default "
                         "nccl on cuda, gloo on cpu; nccl takes one rank a "
                         "card)")
    st.add_argument("--models-dir", default="models")
    # spawned here, never joined: the JAX verb has no --coordinator
    st.set_defaults(fn=cmd_stream_train, coordinator=None,
                    num_processes=None, process_id=None)

    stream = sub.add_parser(
        "stream",
        help="stream maintenance verbs (requeue quarantined documents, "
             "compact a long-lived epoch ledger)",
    )
    stream_sub = stream.add_subparsers(dest="stream_cmd", required=True)
    rq = stream_sub.add_parser(
        "requeue",
        help="replay a quarantine dir into a watch directory, archiving "
             "the error sidecars under .archive/",
    )
    rq.add_argument("--quarantine-dir", required=True)
    rq.add_argument("--watch-dir", required=True)
    rq.add_argument("--dry-run", action="store_true",
                    help="list what would move without touching anything")
    rq.set_defaults(fn=cmd_stream_requeue)
    cp = stream_sub.add_parser(
        "compact",
        help="fold a stream checkpoint dir's committed epochs.jsonl "
             "history into one checksummed snapshot record",
    )
    cp.add_argument("--checkpoint-dir", required=True,
                    help="epoch-ledger checkpoint dir to compact")
    cp.set_defaults(fn=cmd_stream_compact)

    se = sub.add_parser(
        "serve",
        help="persistent scoring service: load once, warm each token "
             "bucket, continuous batching, atomic model hot-swap, SIGTERM "
             "drain",
    )
    se.add_argument("--models-dir", default="models")
    se.add_argument("--model", default=None,
                    help="pin an explicit model dir (disables hot-swap "
                         "discovery)")
    se.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    se.add_argument("--host", default="127.0.0.1",
                    help="bind address (localhost by design; put a real "
                         "proxy in front for anything else)")
    se.add_argument("--port", type=int, default=8765,
                    help="TCP port (0 picks a free one and prints it)")
    se.add_argument("--max-batch", type=int, default=64,
                    help="coalescer batch capacity = the pinned doc axis "
                         "of every serve dispatch")
    se.add_argument("--linger-ms", type=float, default=5.0,
                    help="max milliseconds a batch waits to fill after "
                         "its first document arrives")
    se.add_argument("--max-queue", type=int, default=None,
                    help="bounded admission: refuse intake beyond this "
                         "many queued documents with a typed 429 + "
                         "Retry-After (default 8x --max-batch; 0 "
                         "disables the bound)")
    se.add_argument("--batch-weight", type=float, default=0.25,
                    help="fraction of every dispatch reserved for "
                         "batch-class documents while any wait "
                         "(anti-starvation floor under interactive "
                         "pressure)")
    se.add_argument("--token-bucket", action="append", type=int,
                    default=[], metavar="T",
                    help="warmed pow2 token-bucket sizes (repeatable; "
                         "default 256 1024 4096); a request beyond the "
                         "largest bucket runs at its own pow2 width")
    se.add_argument("--model-poll-interval", type=float, default=2.0,
                    help="seconds between hot-swap discovery polls of "
                         "--models-dir")
    se.add_argument("--no-verify-deep", action="store_true",
                    help="trust COMMIT markers instead of re-verifying "
                         "SHA256 manifests at model selection "
                         "(verify-deep is the serve default)")
    se.add_argument("--stop-words", default=None)
    se.add_argument("--no-lemmatize", action="store_true")
    se.add_argument("--quarantine-dir", default=None,
                    help="dead-letter dir for documents that fail "
                         "vectorize/score (they get error responses "
                         "either way; this keeps the payloads)")
    se.add_argument("--max-seconds", type=float, default=None,
                    help="drain + exit after this many seconds (drills); "
                         "default: run until SIGTERM")
    se.add_argument("--alerts-file", default=None,
                    help="a `monitor` alerts.jsonl: while it holds firing "
                         "alerts, GET /healthz reports status 'degraded' "
                         "and lists them")
    se.add_argument("--telemetry-file", default=None,
                    help="telemetry run stream (serve.* histograms, "
                         "hot-swap events) as JSONL — `metrics summarize` "
                         "renders its serving-health section from this")
    se.add_argument("--emulate-doc-ms", type=float, default=None,
                    help="the fleet drill's emulated dispatch: sleep this "
                         "many milliseconds a document instead of "
                         "launching the kernel, and answer a fixed "
                         "distribution (lets a CPU host run N replicas)")
    # a fleet replica's flags (passed by `supervise --role serve`):
    # identity and lease cadence; the replica announces its auto-picked
    # port through the lease and obeys the supervisor's control file
    se.add_argument("--fleet-dir", default=None,
                    help="fleet dir of a supervising `supervise --role "
                         "serve`: enables the role=serve heartbeat lease "
                         "(port, state and model for the routing front) "
                         "and the replica's swap control file")
    se.add_argument("--worker-index", type=int, default=0,
                    help="this replica's index in the serve fleet")
    se.add_argument("--fleet-generation", type=int, default=0,
                    help="fence token: topology generation at spawn")
    se.add_argument("--fleet-spawn-id", type=int, default=0,
                    help="fence token: this incarnation's spawn id")
    se.add_argument("--heartbeat-interval", type=float, default=0.5,
                    help="seconds between lease renewals")
    se.add_argument("--lease-timeout", type=float, default=None,
                    help="the supervisor's lease timeout, installed as the "
                         "process-wide retry deadline")
    _add_compile_cache_arg(se)
    _add_device_arg(se)
    se.set_defaults(fn=cmd_serve)

    sv = sub.add_parser(
        "supervise",
        help="run an elastic, preemption-tolerant stream worker fleet "
             "(heartbeat leases, SIGTERM/SIGKILL escalation, ledger-gated "
             "resize with zombie fencing)",
    )
    sv.add_argument("--role", default="stream-score",
                    choices=["stream-score", "stream-train", "serve"],
                    help="worker verb the fleet runs (serve: N hot scoring "
                         "replicas behind the lease-discovered routing "
                         "front instead of partitioned stream workers)")
    sv.add_argument("--watch-dir", default=None,
                    help="directory the stream workers watch (required for "
                         "the stream roles; unused by --role serve)")
    sv.add_argument("--fleet-dir", required=True,
                    help="fleet state dir: fleet.jsonl (fence records), "
                         "leases/, and per-worker checkpoint dirs w000/, "
                         "w001/, ...")
    sv.add_argument("--workers", type=int, default=2,
                    help="initial worker count")
    sv.add_argument("--min-workers", type=int, default=1)
    sv.add_argument("--max-workers", type=int, default=8)
    sv.add_argument("--heartbeat-interval", type=float, default=0.5)
    sv.add_argument("--lease-timeout", type=float, default=5.0,
                    help="seconds without a lease renewal before a worker "
                         "counts as stuck or dead (escalation starts)")
    sv.add_argument("--grace-seconds", type=float, default=3.0,
                    help="drain window between SIGTERM and SIGKILL")
    sv.add_argument("--startup-grace", type=float, default=60.0,
                    help="lease budget before the first heartbeat (covers "
                         "the torch import, the CUDA context and the "
                         "kernel load)")
    sv.add_argument("--sweep-interval", type=float, default=0.25)
    sv.add_argument("--scale-out-depth", type=int, default=None,
                    help="scale out when the fleet's total queue depth "
                         "stays at or above this for --scale-out-sweeps "
                         "sweeps")
    sv.add_argument("--scale-out-sweeps", type=int, default=3)
    sv.add_argument("--scale-in-sweeps", type=int, default=None,
                    help="scale in after this many consecutive all-idle "
                         "sweeps (default: never)")
    sv.add_argument("--max-respawns", type=int, default=5,
                    help="fleet-wide respawn budget before supervision "
                         "aborts (a crash loop fails loudly)")
    sv.add_argument("--actions-file", default=None,
                    help="poll this `monitor` actions file every sweep: a "
                         "firing alert's scale request resizes the fleet "
                         "(a stream fleet between committed epochs, a "
                         "serve fleet beside its serving replicas), a "
                         "drain request runs the escalation ladder "
                         "(applied ids acked in <file>.ack, exactly once)")
    sv.add_argument("--resize-at", action="append", default=[],
                    metavar="EPOCHS:WORKERS",
                    help="scripted resize: once the fleet's total committed "
                         "epochs reach EPOCHS, resize to WORKERS "
                         "(repeatable)")
    sv.add_argument("--chaos-worker", action="append", default=[],
                    metavar="INDEX:SITE:KIND[@ARG]",
                    help="arm an STC_FAULTS spec on one generation-0 worker "
                         "(respawns always run clean)")
    sv.add_argument("--poll-interval", type=float, default=1.0)
    sv.add_argument("--idle-timeout", type=float, default=30.0,
                    help="workers exit cleanly after this many idle "
                         "seconds; the fleet converges when every worker "
                         "has finished")
    sv.add_argument("--max-files-per-trigger", type=int, default=None)
    sv.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    sv.add_argument("--stop-words", default=None)
    sv.add_argument("--no-lemmatize", action="store_true")
    sv.add_argument("--include-all", action="store_true")
    sv.add_argument("--quarantine-dir", default=None)
    sv.add_argument("--models-dir", default="models")
    sv.add_argument("--model", default=None,
                    help="explicit model dir for stream-score workers")
    sv.add_argument("--output-dir", default="TestOutput",
                    help="stream-score report root (per-worker subdirs "
                         "w000/, w001/, ...)")
    sv.add_argument("--k", type=int, default=5)
    sv.add_argument("--hash-features", type=int, default=1 << 18)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--checkpoint-interval", type=int, default=1)
    sv.add_argument("--telemetry-file", default=None,
                    help="the supervisor's telemetry run stream (fleet_* "
                         "events, fleet.* counters): `metrics summarize` "
                         "renders its fleet health")
    sv.add_argument("--worker-telemetry-dir", default=None,
                    help="give every worker incarnation its own telemetry "
                         "run stream under this dir "
                         "(worker-wNNN-sSS.jsonl)")
    sv.add_argument("--ship-to", default=None, metavar="HOST:PORT",
                    help="push every run stream of the fleet (supervisor "
                         "and workers) to a `collect` daemon at this "
                         "address; the workers inherit it through the "
                         "STC_SHIP_TO environment variable")
    sv.add_argument("--worker-arg", action="append", default=[],
                    help="extra argv appended to every worker command "
                         "(repeatable)")
    # the serve role's flags
    sv.add_argument("--front-port", type=int, default=None,
                    help="--role serve: also run the routing front in this "
                         "process on this port (0 picks one; announced in "
                         "<fleet-dir>/front.json)")
    sv.add_argument("--max-seconds", type=float, default=None,
                    help="--role serve: drain the fleet and exit after "
                         "this long (drills); default: run until SIGTERM")
    sv.add_argument("--swap-timeout", type=float, default=60.0,
                    help="--role serve: seconds one replica may take to ack "
                         "a rolling swap before the roll skips it "
                         "(fleet.swap_stalls)")
    sv.add_argument("--serve-max-batch", type=int, default=64,
                    help="--role serve: replica coalescer capacity")
    sv.add_argument("--serve-linger-ms", type=float, default=5.0,
                    help="--role serve: replica batch linger")
    sv.add_argument("--serve-emulate-doc-ms", type=float, default=None,
                    help="--role serve: pass `serve --emulate-doc-ms` on to "
                         "every replica (the fleet drill)")
    sv.add_argument("--serve-max-queue", type=int, default=None,
                    help="--role serve: pass `serve --max-queue` (bounded "
                         "admission, typed 429s) on to every replica")
    sv.add_argument("--serve-batch-weight", type=float, default=None,
                    help="--role serve: pass `serve --batch-weight` on to "
                         "every replica")
    sv.add_argument("--autoscale", action="store_true",
                    help="--role serve: predictive autoscaling, the "
                         "front's queueing estimate of rho into "
                         "scale_out/scale_in requests on --actions-file "
                         "(requires --front-port and --actions-file; "
                         "exits 2 without them), clamped to "
                         "--min/--max-workers")
    sv.add_argument("--autoscale-high-rho", type=float, default=0.8,
                    help="scale out after --autoscale-confirm consecutive "
                         "estimates at or above this utilization")
    sv.add_argument("--autoscale-low-rho", type=float, default=0.3,
                    help="scale in after sustained utilization at or "
                         "below this (dead band between low and high)")
    sv.add_argument("--autoscale-confirm", type=int, default=2,
                    help="consecutive estimates beyond a threshold before "
                         "a decision (hysteresis)")
    sv.add_argument("--autoscale-cooldown", type=float, default=30.0,
                    help="seconds to hold after any decision (a fresh "
                         "replica must warm before the signal is trusted "
                         "again)")
    _add_compile_cache_arg(sv)
    sv.add_argument("--device", default=None,
                    help="torch device passed to every worker (default: "
                         "none passed, so the workers run on cuda)")
    sv.set_defaults(fn=cmd_supervise)

    fr = sub.add_parser(
        "front",
        help="the serve fleet's routing front: one port spreading /score "
             "over a `supervise --role serve` fleet (least-outstanding "
             "routing, drain-aware, retry on another replica, per-stream "
             "generation pinning)",
    )
    fr.add_argument("--fleet-dir", required=True,
                    help="the serve fleet's state dir (replicas are "
                         "discovered from its role=serve lease files)")
    fr.add_argument("--host", default="127.0.0.1")
    fr.add_argument("--port", type=int, default=8766,
                    help="TCP port (0 picks a free one, announced in "
                         "<fleet-dir>/front.json)")
    fr.add_argument("--lease-timeout", type=float, default=10.0,
                    help="seconds without a lease renewal before a replica "
                         "leaves the rotation")
    fr.add_argument("--wait-for-replica", type=float, default=30.0,
                    help="seconds a request waits for any ready replica "
                         "before failing 503")
    fr.add_argument("--max-pending", type=int, default=128,
                    help="front-side shedding: 429 new requests once this "
                         "many are in flight (batch-class sheds at half; 0 "
                         "disables)")
    fr.add_argument("--retry-budget", type=int, default=3,
                    help="most retries a request on connection-level "
                         "failures and 503s, with jittered backoff; a typed "
                         "429 never spends one")
    fr.add_argument("--max-seconds", type=float, default=None,
                    help="drain and exit after this many seconds (drills); "
                         "default: run until SIGTERM")
    fr.add_argument("--telemetry-file", default=None,
                    help="the front's run stream (front.* counters, the "
                         "front.replica.<i>.* families, swap observations)")
    fr.add_argument("--alerts-file", default=None,
                    help="a `monitor --alerts-file` log: /healthz reports "
                         "degraded while it holds firing alerts")
    fr.set_defaults(fn=cmd_front)

    pb = sub.add_parser(
        "probe",
        help="black-box canary: score a fixed sentinel document through "
             "the serve front at a fixed rate and record what a client "
             "saw (outcome, latency, generation pinning)",
    )
    pb.add_argument("--fleet-dir", default=None,
                    help="discover the front from <fleet-dir>/front.json")
    pb.add_argument("--url", default=None,
                    help="probe this front address (http://host:port) "
                         "instead of discovering it")
    pb.add_argument("--count", type=int, default=60,
                    help="number of probes to send")
    pb.add_argument("--rate", type=float, default=1.0,
                    help="probes per second (fixed wall-clock pacing)")
    pb.add_argument("--ramp-to", type=float, default=None,
                    help="open-loop overload mode: ramp the send rate "
                         "linearly from --rate to this over --count "
                         "requests, each on its own thread at its "
                         "scheduled time")
    pb.add_argument("--priority", default=None,
                    choices=("interactive", "batch"),
                    help="send X-STC-Priority on every probe")
    pb.add_argument("--timeout", type=float, default=5.0,
                    help="per-probe HTTP timeout (a timeout is an `error` "
                         "outcome, not a crash)")
    pb.add_argument("--stream", default="stc-probe",
                    help="X-STC-Stream header value: the pinned stream the "
                         "generation check rides")
    pb.add_argument("--text", default=None,
                    help="override the sentinel document")
    pb.add_argument("--wait-front", type=float, default=10.0,
                    help="seconds to wait for front.json to appear")
    pb.add_argument("--fail-on-error", action="store_true",
                    help="exit 1 when any probe failed or saw a generation "
                         "go backward")
    pb.add_argument("--telemetry-file", default=None,
                    help="the probe's run stream (probe_request events and "
                         "probe.* counters)")
    pb.add_argument("--ship-to", default=None, metavar="HOST:PORT",
                    help="also push the probe's run stream to a `collect` "
                         "daemon at this address")
    pb.set_defaults(fn=cmd_probe)

    co = sub.add_parser(
        "collect",
        help="telemetry collector: HTTP ingest of shipped run-stream "
             "batches, exactly once on (source_id, seq), one manifested "
             "JSONL stream a source under --dir",
    )
    co.add_argument("--dir", required=True,
                    help="aggregation dir: one <source_id>.jsonl a "
                         "shipper, and the collect.json announce")
    co.add_argument("--host", default="127.0.0.1")
    co.add_argument("--port", type=int, default=0,
                    help="ingest port (0 picks one; announced in "
                         "<dir>/collect.json)")
    co.add_argument("--max-seconds", type=float, default=None,
                    help="exit after this long (drills); default: run "
                         "until SIGTERM")
    co.add_argument("--telemetry-file", default=None,
                    help="the collector's own run stream (collect.* "
                         "counters; never shipped to itself)")
    co.set_defaults(fn=cmd_collect)

    li = sub.add_parser(
        "lineage",
        help="walk the causal chain behind a served byte: model dir / "
             "serve response JSON / trace id -> publish epoch, "
             "committed source sets, request span chain, compile "
             "digests",
    )
    li.add_argument("target",
                    help="a model artifact dir, a saved serve response "
                         "JSON, or a trace id (32-hex or traceparent)")
    li.add_argument("--fleet-dir", default=None,
                    help="walk EVERY worker ledger of this fleet dir "
                         "(w000/, w001/, ...) into the committed "
                         "source union")
    li.add_argument("--ledger-dir", default=None,
                    help="explicit epoch-ledger checkpoint dir "
                         "(default: the model meta.json's ledger_ref)")
    li.add_argument("--telemetry", action="append", default=[],
                    metavar="RUN.JSONL",
                    help="run stream(s) to resolve the request's trace "
                         "spans and the serve-side compile digests "
                         "(repeatable)")
    li.add_argument("--json", action="store_true")
    li.set_defaults(fn=cmd_lineage)

    cc = sub.add_parser(
        "compile-cache",
        help="compile cache maintenance: warm (publish the kernel "
             "libraries and warm the serve bucket grid), ls, gc, verify",
    )
    cc_sub = cc.add_subparsers(dest="cc_cmd", required=True)
    ccw = cc_sub.add_parser(
        "warm",
        help="publish every CUDA kernel library to the cache (built if "
             "the store and the build directory lack it) and run the "
             "serve warmup over the bucket grid, so replicas and workers "
             "spawned later load instead of building",
    )
    ccw.add_argument("--cache-dir", default=None,
                     help="store root (default: $STC_COMPILE_CACHE)")
    ccw.add_argument("--models-dir", default="models")
    ccw.add_argument("--model", default=None, help="explicit model dir")
    ccw.add_argument("--lang", default="EN", choices=sorted(LANG_DIRS))
    ccw.add_argument("--stop-words", default=None)
    ccw.add_argument("--no-lemmatize", action="store_true")
    ccw.add_argument("--max-batch", type=int, default=64)
    ccw.add_argument("--token-bucket", action="append", type=int,
                     default=[], metavar="T",
                     help="pow2 buckets to warm (repeatable; default "
                          "the serve grid 256 1024 4096)")
    ccw.add_argument("--baseline",
                     default="scripts/records/compile_baseline.json",
                     help="compile sentinel baseline to report label "
                          "coverage against ('' disables)")
    ccw.add_argument("--telemetry-file", default=None)
    _add_device_arg(ccw)
    ccw.set_defaults(fn=cmd_compile_cache)
    for name, hlp in (
        ("ls", "list every cache entry with status/size/age"),
        ("verify", "re-hash every committed entry; exit 1 if any "
                   "entry would not load"),
        ("gc", "prune to the newest N committed entries per toolchain "
               "fingerprint; drop stages + quarantined entries"),
    ):
        p = cc_sub.add_parser(name, help=hlp)
        p.add_argument("--cache-dir", default=None,
                       help="store root (default: $STC_COMPILE_CACHE)")
        if name == "gc":
            p.add_argument("--keep-newest", type=int, required=True)
        else:
            p.add_argument("--json", action="store_true")
        p.set_defaults(fn=cmd_compile_cache)

    dr = sub.add_parser(
        "doctor", help="environment health report (hang-proof probes)"
    )
    dr.add_argument("--probe-timeout", type=int, default=60)
    dr.set_defaults(fn=cmd_doctor)

    # the JAX package's `metrics`, `monitor` and `lint` verbs, copied
    # (telemetry.metrics_cli, telemetry.monitor_cli, analysis.cli)
    from .analysis.cli import add_lint_subparser
    from .telemetry.metrics_cli import add_metrics_subparser
    from .telemetry.monitor_cli import add_monitor_subparser

    add_metrics_subparser(sub)
    add_monitor_subparser(sub)
    add_lint_subparser(sub)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # the compile cache: --compile-cache is exported to the environment,
    # so every process this one spawns (fleet workers, serve replicas,
    # grid ranks) inherits the same store; the env alone also works
    cc_dir = getattr(args, "compile_cache", None)
    if cc_dir:
        from . import compilecache

        os.environ[compilecache.ENV_DIR] = cc_dir
        compilecache.configure(cc_dir)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
