"""Command-line entry points of the port: ``train`` and ``score``.

The reference's two entry points (LDATraining.scala, LDALoader.scala) as
subcommands, with the JAX package's flags, defaults, console output and
exit codes:

    python -m spark_text_clustering_tpu_torch.cli train --books <dir> \
        --stop-words <file> --lang EN --algorithm em --k 5
    python -m spark_text_clustering_tpu_torch.cli score --books <dir> \
        --lang EN --models-dir <dir> --output-dir <dir>

One flag is the port's own: ``--device`` (default ``cuda``) names the
device that IDF, training and scoring run on; without a card, pass
``--device cpu``.  Flags whose machinery the port has not ported yet exit
with code 2 and name the ROADMAP item that brings it; none is accepted and
then ignored.

Exit codes: 0 on success; 2 for a usage error, a missing or corrupt model,
a resume mismatch, a flag not ported yet, and a ``NotImplementedError``
from an estimator (a path the port does not run yet).
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
_SHARDING = "queue 1 item 6, sharding"
_NOT_PORTED = {
    "telemetry_file": ("--telemetry-file", "queue 1 item 9, telemetry"),
    "compile_cache": ("--compile-cache",
                      "queue 1 item 10, a compile cache"),
    "coordinator": ("--coordinator", _SHARDING),
    "num_processes": ("--num-processes", _SHARDING),
    "process_id": ("--process-id", _SHARDING),
}


def _refuse_unported(args: argparse.Namespace) -> Optional[int]:
    """Exit code 2, with a message, for a flag the port cannot honour."""
    hits = [
        (flag, item) for dest, (flag, item) in _NOT_PORTED.items()
        if getattr(args, dest, None) is not None
        and getattr(args, dest) is not False
    ]
    default_data = None if args.cmd == "train" else 1
    for dest in ("data_shards", "model_shards"):
        value = getattr(args, dest)
        if value not in (1, default_data):
            flag = "--" + dest.replace("_", "-")
            hits.append((f"{flag} {value}", _SHARDING))
    if not hits:
        return None
    for flag, item in hits:
        print(f"error: {flag} is not ported yet (ROADMAP.md {item})",
              file=sys.stderr)
    return 2


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
    abort with, or None to proceed.  One process: no epoch ledger."""
    if not params.checkpoint_dir:
        if resume_requested:
            print("--resume requires --checkpoint-dir", file=sys.stderr)
            return 2
        return None
    vocab_fp = vocab_fingerprint(vocab)
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
            print(f"resuming from checkpoint {state}")
        else:
            print(
                f"--resume: no valid checkpoint under "
                f"{params.checkpoint_dir}; starting fresh"
            )
    write_resume_meta(params.checkpoint_dir, params, vocab_fp)
    return None


def cmd_train(args: argparse.Namespace) -> int:
    rc = _refuse_unported(args)
    if rc is not None:
        return rc
    resolve_device(args.device)  # no card and no --device cpu: raise now
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
                               device=args.device))

    metrics = MetricsLogger(args.metrics_file)
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
    print()
    print("Corpus summary:")
    print(f"\t Training set size: {n_docs} documents")
    print(f"\t Vocabulary size: {len(ds['vocab'])} terms")
    print(f"\t Training set size: {n_tokens} tokens")
    print(f"\t Preprocessing time: {timer.phases['preprocess']} sec")
    print()
    print("LDA model training started")

    try:
        with trace(args.profile_dir):
            with timer.phase("train"):
                lda_stage = LDA(params, device=args.device).fit(ds)
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    model = lda_stage.model

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
    resolve_device(args.device)
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
    print(f"loaded model {model_path}: k={model.k}, V={model.vocab_size}")

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
    )

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
    tr.add_argument("--data-shards", type=int, default=None,
                    help="only 1 (or unset) until sharding is ported")
    tr.add_argument("--model-shards", type=int, default=1,
                    help="only 1 until sharding is ported")
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
    tr.add_argument("--coordinator", default=None,
                    help="not ported yet (exits 2)")
    tr.add_argument("--num-processes", type=int, default=None,
                    help="not ported yet (exits 2)")
    tr.add_argument("--process-id", type=int, default=None,
                    help="not ported yet (exits 2)")
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
    sc.add_argument("--data-shards", type=int, default=1,
                    help="only 1 until sharding is ported")
    sc.add_argument("--model-shards", type=int, default=1,
                    help="only 1 until sharding is ported")
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
