"""Command-line entry points of the port: ``train`` and ``score``.

The reference's two entry points (LDATraining.scala, LDALoader.scala) as
subcommands, with the JAX package's flags, defaults, console output and
exit codes:

    python -m spark_text_clustering_tpu_torch.cli train --books <dir> \
        --stop-words <file> --lang EN --algorithm em --k 5
    python -m spark_text_clustering_tpu_torch.cli score --books <dir> \
        --lang EN --models-dir <dir> --output-dir <dir>

Two flags are the port's own: ``--device`` (default ``cuda``) names the
device that IDF, training and scoring run on (without a card, pass
``--device cpu``), and ``--dist-backend`` the ``torch.distributed``
backend of a grid (default ``nccl`` on CUDA, ``gloo`` on the CPU).  Flags
whose machinery the port has not ported yet exit with code 2 and name the
ROADMAP item that brings it; none is accepted and then ignored.

``--data-shards D --model-shards M`` run training (IDF included; EM,
online VB or NMF) and scoring on a grid of D x M ranks (``parallel``).  Unlike the JAX package,
where one process drives every local device, each rank is one process on
one device (rank r on ``cuda:(r mod cards)``).  Without ``--coordinator``
the command spawns the D x M ranks on this host itself; with
``--coordinator host:port --num-processes N --process-id i`` it is rank i
of N = D x M processes started by the caller.  Every rank reads and
preprocesses the whole book directory, as every JAX process does; only
rank 0 prints, saves the model and writes the report, and the exit code
is the worst of the ranks'.

Exit codes: 0 on success; 2 for a usage error, a missing or corrupt model,
a resume mismatch and a flag not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import Params
from .device import resolve_device
from .models.persistence import (
    model_dir_name,
    resolve_latest_model,
    train_state_valid,
)
from .ops import _build
from .parallel.mesh import (
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
    ResumeMismatchError,
    validate_resume_meta,
    vocab_fingerprint,
    write_resume_meta,
)
from .utils import native
from .utils.profiling import MetricsLogger, trace
from .utils.readers import read_stop_word_file, read_text_dir
from .utils.report import format_scoring_report, write_scoring_report
from .utils.textproc import parse_stop_words
from .utils.timing import PhaseTimer

__all__ = ["LANG_DIRS", "build_parser", "cmd_score", "cmd_train", "main"]

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

# The ROADMAP.md queue 1 item that ports the machinery behind each flag
# the port refuses for now.
_NOT_PORTED = {
    "telemetry_file": ("--telemetry-file", "queue 1 item 9, telemetry"),
    "compile_cache": ("--compile-cache",
                      "queue 1 item 10, a compile cache"),
}


def _refuse_unported(args: argparse.Namespace) -> Optional[int]:
    """Exit code 2, with a message, for a flag the port cannot honour."""
    hits = [
        (flag, item) for dest, (flag, item) in _NOT_PORTED.items()
        if getattr(args, dest, None) is not None
    ]
    for flag, item in hits:
        print(f"error: {flag} is not ported yet (ROADMAP.md {item})",
              file=sys.stderr)
    return 2 if hits else None


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


def _on_grid(args: argparse.Namespace, body) -> int:
    """Run ``body(args, grid)``: on one device (grid None), as rank
    ``--process-id`` of a ``--coordinator`` world, or on ranks spawned
    here for a grid larger than 1x1."""
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
    try:
        codes = run_grid(_grid_rank, d, m, (body.__name__, args),
                         backend=backend, device=args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return max(codes)


def _grid_rank(grid, body_name: str, args: argparse.Namespace) -> int:
    """One spawned rank of ``_on_grid``."""
    return globals()[body_name](args, grid)


def _quiet(*args, **kwargs) -> None:
    """``print`` on a rank other than the coordinator."""


def _load_stop_words(path: Optional[str]) -> frozenset:
    if not path:
        return frozenset()
    return parse_stop_words(read_stop_word_file(path))


def _resume_gate(
    params: Params, vocab, resume_requested: bool
) -> Optional[int]:
    """Checkpoint-dir compatibility gate: validates any recorded
    ``resume_meta.json`` against this run's config hash and vocabulary
    fingerprint (a mismatch is fatal whether or not --resume was passed),
    announces the resume point when --resume asked for one, and records
    this run's envelope for the next resume.  Returns an exit code to
    abort with, or None to proceed.  On a grid every rank validates and
    the coordinator speaks and writes.  No epoch ledger."""
    if not params.checkpoint_dir:
        if resume_requested:
            print("--resume requires --checkpoint-dir", file=sys.stderr)
            return 2
        return None
    vocab_fp = vocab_fingerprint(vocab)
    say = print if is_coordinator() else _quiet
    try:
        validate_resume_meta(params.checkpoint_dir, params, vocab_fp)
    except ResumeMismatchError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if resume_requested:
        state_name = {
            "em": "em_state.npz", "online": "train_state.npz"
        }.get(params.algorithm)
        state = (
            os.path.join(params.checkpoint_dir, state_name)
            if state_name else None
        )
        if state and train_state_valid(state):
            say(f"resuming from checkpoint {state}")
        else:
            say(
                f"--resume: no valid checkpoint under "
                f"{params.checkpoint_dir}; starting fresh"
            )
    if is_coordinator():
        write_resume_meta(params.checkpoint_dir, params, vocab_fp)
    return None


def cmd_train(args: argparse.Namespace) -> int:
    rc = _refuse_unported(args)
    if rc is not None:
        return rc
    return _on_grid(args, _train)


def _train(args: argparse.Namespace, grid) -> int:
    coordinator = is_coordinator()
    say = print if coordinator else _quiet
    device = args.device if grid is None else grid.device
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
        CountVectorizer(vocab_size=params.vocab_size),
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
    return 0


def cmd_score(args: argparse.Namespace) -> int:
    rc = _refuse_unported(args)
    if rc is not None:
        return rc
    return _on_grid(args, _score)


def _score(args: argparse.Namespace, grid) -> int:
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
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="not ported yet (exits 2)")


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
                    help="not ported yet (exits 2)")
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
                    help="not ported yet (exits 2)")
    _add_compile_cache_arg(sc)
    _add_device_arg(sc)
    sc.set_defaults(fn=cmd_score)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
