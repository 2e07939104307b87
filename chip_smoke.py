#!/usr/bin/env python3
"""The PyTorch port's main path on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--seed 0] [--profile] [--out DIR] [--kernels-only]

1. builds the six CUDA kernels from ``spark_text_clustering_tpu_torch/
   csrc`` and the native text library from ``.../native`` (one ``nvcc``
   per source and one ``g++``, in parallel, into build/torch_kernels;
   ``--kernels-only`` skips the text library); then, beside the
   corpora's generation, ``python -m spark_text_clustering_tpu_torch.cli
   doctor`` as a subprocess: exit 0, the accelerator OK and naming this
   card, the CPU path and the text library OK, nvcc found and all six
   libraries built for the current sources, the build directory's
   listing unchanged by it;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it and at the edges of its contract, and
   times kernel, plain version, and (for the scatter) the one PyTorch call
   that computes the same function.  The fused sweep is also held against
   its plain version at 512 docs with k=40 and 8 docs with k=500, which
   the gate (d <= 512 at every k) lets through, and timed by graph replay
   and by host enqueue.  The tile gamma kernel is held against its
   plain version on every launch of one config C fit, and timed on
   iteration 5's minibatch and on the fit's heaviest launch.  The NMF
   kernel is also timed by graph replay and by host enqueue, beside the
   sweep's H-side ``index_add_``, with its placement, CTAs an SM and
   ptxas registers and spills recorded.  The per-document kernel of
   scoring (``csrc/segments.cu``) is held against its plain version on 8
   of config A's rows at the widest serve bucket (262,144 slots, 8 doc
   slots), repeated bit for bit, a doc's bytes held equal alone, in a
   batch at other widths and in the whole-corpus launch, and the batch's
   bytes equal at forced clusters of 1-16 CTAs a doc; timed at the serve
   dispatch, a book alone and the whole corpus, with each launch's cluster,
   shared memory and staged share of tokens; and again at k = 100 (its
   Large instance) and k = 500 (its Wide one) on the same rows, bytes
   equal at forced clusters of 1-16 and alone.  The padded E-step's edge
   geometries include k = 65, 100, 129 and 500 at L = 1024 and 16384 (its
   wide instance), each timed beside its bound;
3. config A, the EN books shape: 51 docs of 2,000-20,000 distinct terms,
   V=39,380, k=5.  IDF -> EM fit (fused sweep, resumed from one random
   start) -> save -> load -> padded-bucket scoring -> scoring report.  The
   fit is re-run with device="cpu" (the plain versions) from the same
   start; the average log-likelihoods must agree within 1e-4;
4. config B, the 20 Newsgroups shape: 11,314 docs, V=2^18 hashed Zipf
   terms, k=20.  IDF -> EM fit (two-stage sweep: 11,314 docs > 512) ->
   save -> load -> scoring of every doc;
5. config C, the online-VB north star on the same corpus as raw counts:
   k=20, sampling="epoch", 60 iterations (3 epochs of ~567-doc tiled
   minibatches), tau0=1024, kappa=0.51, alpha=eta=1/k.  One warm-up fit,
   then a timed fit -> save -> load -> log-perplexity of the first 512
   docs.  Ten iterations are re-run with device="cpu" (the plain
   versions) from the same lambda and gamma draws; lambda must agree
   within 1e-3 relative and the log-perplexity within 1e-4;
6. config D, NMF (the estimator swap) on the same raw counts: k=20, 40
   Lee-Seung sweeps, token_layout="auto" (the tile layout on this
   corpus).  One warm-up fit, then a timed fit -> save -> load ->
   topic_distribution of the first 512 docs.  Ten sweeps are re-run with
   device="cpu" from the same W0/H0; H must agree within 1e-3 relative
   and the loss within 1e-4;
7. config E, the CLI on the card: a synthetic EN book directory (51
   books of 8,000-120,000 pseudo-words, ~42k terms after the text front
   end) -> ``cli.main(["train", ...])`` with the defaults (native text
   library, TF-IDF, EM k=5, 50 iterations: exactly 50 fused-sweep
   launches) -> the fused sweep held against its plain version on E's
   own TF-IDF rows from the fit's kind of start -> ``train --device cpu``
   from the same seeded start (average log-likelihoods within 1e-4) ->
   ``cli.main(["score", ...])`` (padded buckets through the E-step
   kernel) -> ``score --device cpu`` of the card's model; the two
   reports' distributions must agree within 5e-3;
8. config F, the padded EM layout and the MLlib artifacts through the
   CLI: 51 synthetic EN books of one length (60,000 pseudo-words, ~10,500
   distinct terms each, so EM's "auto" layout is one padded bucket of
   16,384 slots a book) -> ``train --export-mllib`` on the card (the
   padded sweep, plain PyTorch: no sweep-kernel launch) -> ``train
   --device cpu`` and ``train --token-layout packed`` on the card (50
   fused-sweep launches) from the same seed (avg logLik within 1e-4,
   lambda within 1e-3) -> ``score`` on the card (E-step kernel) against
   ``score --device cpu`` (5e-3) -> ``score --model <dir>_mllib`` on the
   card: the same report byte for byte (where pyarrow is installed; else
   a line says it is not);
9. config G, online VB with the defaults on C's rows (MLlib's Bernoulli
   minibatches of ~567 docs padded to 661, ``token_layout="auto"``): the
   host-streaming packed path, each chunk's minibatches cut into tiles
   (``plan_tile_pack_uniform``) for the tile kernel, one launch an
   iteration.  Every launch of one fit is held against the plain version,
   iteration 5's and the heaviest timed; one warm-up fit, then the timed
   fit -> save -> load -> log-perplexity of 512 docs; ten iterations
   against the same ten through the same tiles iteration with CPU
   tensors (``rule="card"``), from the same draws: lambda within 1e-3
   relative, log-perplexity within 1e-4;
10. config H, online VB through the CLI on E's books: ``train
   --algorithm online`` with the defaults takes the padded layout with
   the corpus resident on the card, one [12, 5, 16384] E-step launch an
   iteration that draws a book -> ``score`` on the card against
   ``score --device cpu`` (5e-3) -> ten iterations of the library fit on
   E's TF-IDF rows on the card (every E-step launch held against the
   plain version) against the same ten on the CPU from the same draws:
   lambda within 1e-3 relative; then ``train --algorithm online --k 100``
   (5 iterations, the E-step's wide instance) -> ``score`` and ``score
   --per-doc-convergence`` on the card against ``--device cpu`` (5e-3),
   the two ``--device cpu`` runs on every third book (``H_WIDE_CPU_EVERY``;
   k=100 on the host is ~0.5 s a book), compared on those books' rows;
11. config I, EM and scoring on a 2x2 grid of 4 ranks on the one card
   (``parallel.run_grid``, gloo with CUDA tensors: NCCL takes one rank a
   card).  Each rank first holds the fused sweep (its (data, model) pair
   of A's TF-IDF rows: shard_v = V/2, its pair's doc stream in
   shard-local columns), the scatter (its pair of B's, shard_v = 2^17)
   and the E-step (its block of B's most populated scoring bucket,
   gathered from the vocabulary shards) against their plain versions;
   then with the counts at 0: I-A (A's corpus: grid IDF -> EM fit, the
   fused sweep on every rank) and I-B (B's: grid IDF -> EM fit, the
   two-stage sweep -> grid scoring of 512 docs), each against the 1x1
   card fit from the same seed (avg logLik 1e-4, lambda 1e-3 relative
   or twice the 1x1 fit's spread, the largest pairwise distance of five
   1x1 card fits of B from the seed, whose N_dk adds with atomics;
   scoring 5e-3, the grid's EM log-likelihood of the 512 docs 1e-4),
   with ms a sweep and the share of it spent in the collectives; I-CLI:
   ``train --data-shards 2 --model-shards 2 --dist-backend gloo`` and
   ``score --model-shards 2`` on E's books against config E's 1x1 card
   CLI (distributions 5e-3, main topics where the top two differ by
   1e-2); beside them, a 1x1 NCCL grid initializes and reduces;
12. config J, online VB and NMF on a 2x2 grid of 4 ranks on the one card
   (gloo).  Each rank first holds the tile kernel (its data shard's tiles
   of J-C's iteration 5, eb gathered from the vocabulary shards), the NMF
   kernel (its block of D's tiles) and the E-step (its 6 rows of a J-CLI
   minibatch, [6, 5, L]) against their plain versions; then with the
   counts at 0: J-C (C's corpus tiles-resident on the grid, 60
   iterations; its first 10 replayed at 1x1 on the grid's tiles from the
   same draws, lambda 1e-3; log-perplexity of 512 docs within 3% of C's),
   J-G (G's defaults on the grid, bsz 661 -> 662; lambda against the 1x1
   card fit 1e-3, or twice that fit's own spread) and J-D (D's NMF on the
   grid; against the 1x1 card fits, after D's ten check sweeps H 1e-3
   and the loss 1e-4, after the 40 the loss 1e-4), each with ms an
   iteration or sweep and its collectives' share; J-CLI: ``train
   --algorithm online`` at 2x2 and ``score`` on the grid against config
   H's card report (5e-3), ``train --algorithm nmf`` at 1x1 and 2x2, the
   grid model's report equal to the 1x1 report with floats masked.  The
   four 2x2 commands run as ``--coordinator`` ranks of one pool of four
   processes (``GridPool``: one start-up, beside J's 1x1 fits and the 1x1
   NMF pair); the timed grid runs alone;
13. config K, one-process streaming through the CLI on config E's 51
   books with the stream verbs' defaults (batch capacity 8, 2^18 hash
   features, k=5) and 8 files a trigger (7 triggers): ``stream-score`` of
   E's card model with a ledger (7 committed epochs, every E-step launch
   held against its plain version) against ``stream-score --device cpu``
   and E's ``score`` (5e-3), then again (nothing new is committed);
   ``stream-train`` on the card against ``--device cpu`` from the same
   seed (lambda 1e-3), an interrupted run (24 books, idle, 27 more,
   ``--resume``: the same micro-batches, lambda 1e-3, every book
   committed once), ``stream compact`` and a resume that loads the same
   lambda bit for bit, and ``score`` of the published model on the card;
   ms a trigger, docs/s and the text front end's share.  K-lineage:
   ``cli lineage <published model> --json`` before and after the
   compaction: the wave's committed sources, the publish epoch of the
   model's ``ledger_ref``, every epoch on the wave's trace, nothing
   degraded but the one compaction note after it.  K-serve-lineage: the
   published model served in this process on the card (the ``serving``
   library with N's buckets and a run stream), one book POSTed under a
   minted ``X-STC-Trace``: its distribution equal in bytes to the card's
   per-doc scoring, and ``lineage`` of the saved response and of the
   bare trace id, with the stream, back to the same epoch and sources,
   the request's spans all attributed and the dispatch digest of
   ``serve.topic_inference``;
14. config L, the supervised stream fleet on config E's books (the same
   widths, one file a trigger): ``python -m spark_text_clustering_tpu_torch
   .cli supervise`` as a subprocess, its workers on the card.  L-score (2
   workers: every book committed once, distributions within 5e-3 of K's
   and E's), L-kill (a kill at a commit) and L-hang (a hung heartbeat: the
   SIGKILL escalation), both in one fleet, with a report tree byte equal
   to L-score's, L-resize
   (2 -> 3 workers, a hung worker: the same reports, exactly once) and
   L-train (2 ``stream-train`` workers under a kill: each worker's lambda
   within 1e-3 relative of one process training its partition, each
   published model scoring on the card; L-lineage: ``cli lineage`` of
   worker 0's model with ``--fleet-dir``, both workers' committed
   sources, every book once, the publish by worker 0's respawned
   incarnation, every epoch on the supervisor's trace), the four fleets
   at once; then
   worker 0's own command in
   this process with the counts at 0, every E-step launch held against its
   plain version and its reports byte equal to the fleet's worker 0; each
   fleet's seconds, books/s, seconds from spawn to first lease beat and
   time to recover.  L-score's and L-kill/L-hang's fleets run with
   ``--telemetry-file``, ``--worker-telemetry-dir`` and ``--ship-to`` a
   ``cli collect`` subprocess: one stream a worker incarnation, the
   supervisor's fleet events equal to the report's counts, every stream
   on the supervisor's trace, and one collected stream a worker
   incarnation plus the supervisor's, each its local one folded exactly
   once (L-score's whole; the killed and hung incarnations' up to what
   their shippers had sent);
15. config M, streaming on a 2x2 gloo grid of 4 ranks on the one card, on
   config E's books with config K's widths and 8 files a trigger: M-train
   (``stream-train --data-shards 2 --model-shards 2 --dist-backend gloo``
   against K's 1x1 run with the grid's numerics, its row sums' order and
   its E-step tiles: lambda within 1e-3 relative or twice that run's
   spread over a repeat; every book committed once; one state shard an
   epoch, ``process_count`` 1), M-resume (24 books, idle, 27 more,
   ``--resume``: lambda within 1e-3 of M-train's, docs_seen 51 and step
   7; the port's 1x1 trainer loads the dir's lambda bit for bit, and a
   1x1 ``--resume`` exits 2), M-fleet (``supervise --role stream-train``,
   2 workers each a 2x1 grid, worker 0 killed at its first commit: every
   book committed once, no process of the killed
   worker alive once its respawn commits, each partition's lambda within
   1e-3 of one 2x1 grid training it; time to recover; it runs beside
   the untimed rest of M, after M-train and M-resume); each rank's E-step
   launches held against the plain version; ms a trigger, docs/s, the
   front end's share, the collectives' ms a trigger and share, and the
   grid's seconds from spawn to result;
16. config N, one serve replica on config E's 51 books and card model
   (``run_config_n``): the per-document kernel's check again on the
   model's own rows (the plain version run the same ways, its bytes
   recorded); ``cli serve`` as subprocesses on the card, on ``--device
   cpu`` and with ``--max-queue 8``: the books one a request from 8
   threads and as 6 requests of 8-9, every served distribution equal in
   bytes to this process's per-doc scoring on the card (the CPU server's
   within 1e-4), a hot swap mid-traffic (each response equal to its
   model's bytes), a 429 with Retry-After in [1, 60], ``/healthz`` and
   Prometheus ``/metrics``, SIGTERM drains with no retrace after warmup;
   then ``score --per-doc-convergence`` (its report equal to the served
   bytes' report) and the same ``serve`` in this process, its launches
   counted; spawn to first response, warmup, request p50/p99, docs/s;
17. the compile cache (``run_compile_cache``), on an empty store:
   ``cli compile-cache warm --model <N's model>`` stores all six
   libraries, none already cached; ``ls --json`` lists six committed
   entries under the live toolchain fingerprint and ``verify`` exits 0;
   ``cli score`` of E's books with ``--compile-cache`` under an nvcc shim
   that refuses any compile: its report equal in bytes to E's card
   report, cache hits and no miss in its stream, no compile, the build
   directory unchanged; one byte of a loaded entry's payload flipped and
   the same ``score`` again: the same report, one miss and one
   invalidation, the entry quarantined; a line with the phase's seconds;
18. config O, the serve fleet on config E's books, N's card models and
   N's per-document bytes (``run_config_o``), on the store 17 warmed:
   ``cli supervise --role serve --device cuda --workers 2 --front-port 0
   --compile-cache <store>`` as a subprocess, 8
   client streams sending one book a request through the front for two
   passes, N's newer model published mid-way through the first (rolled
   through both replicas) and replica 1 killed mid-way through the second
   (respawned while the front retries on replica 0), then ``cli probe``
   and SIGTERM: no failed request, every stream's generations monotone,
   every response equal in bytes to its generation's per-document
   scoring, both replicas serving, every replica incarnation on the card
   with per-document kernel launches and its kernel loaded from the
   store (a hit, no miss), one complete roll, one respawn
   after the lease's retirement, a clean probe and a clean drain; spawn
   to the front's announce and to each replica's ready, request p50/p99,
   docs/s, the roll's seconds and swap lag, time to recover, drain
   seconds, each replica's share and launches (``spawn_to_ready_s`` also
   on a line of its own).  O-alerts on the same
   fleet: a ``cli monitor`` (``replica_down``) and a standalone ``cli
   front --alerts-file`` beside the fleet; the kill fires replica_down
   for replica 1 and the respawn's first beat resolves it in the
   checksummed alerts log, the standalone front's ``/healthz`` degraded
   while it fires and ok after; a second monitor's ``serve_p99`` action
   scales the fleet out to 3 (``supervise --actions-file --max-workers
   3``) exactly once, replica 2 beside the serving two, and a third pass
   goes through the three replicas, each response its generation's bytes;
19. telemetry (``--telemetry-file``) on commands the configs already run:
   E's card ``train`` and ``score`` run again with the flag (their launch
   counts equal to the runs without it) and its ``train --device cpu``
   takes it: the card stream's names equal the CPU stream's (less
   ``mem.device.*``), the card manifest says ``backend: "gpu"`` with the
   CPU run's ``config_hash``, ``mem.device.bytes_in_use`` is above 0, 50
   ``train_iteration`` events and ``train_fit``'s log-likelihood over the
   documents equal to the printed average; the two card streams read by
   the port's ``metrics summarize``, ``roofline`` and ``compile-check``:
   every kernel launch attributed to a call (per kernel, the launches
   summed over the digests equal the wrappers' counts), every call that
   launched a kernel on the ``nvidia-h100`` peaks at a roofline fraction
   in (0, 1.05] (the rows on a ``config_E_roofline`` line), and one
   ``score.topic_inference`` signature a length bucket; N-inproc's
   ``serve`` stream: ``serve.topic_inference``'s calls equal the
   per-document kernel's launches, and the sentinel counts no retrace
   after warmup; K's uninterrupted card
   ``stream-train`` (with a spawner's ``STC_TRACE``): one ``micro_batch``
   a trigger, their trace id on every committed ledger record,
   ``ledger.commits`` equal to the records; M-train: each rank's
   ``-p<rank>`` stream with ``process_index``/``process_count`` r/4,
   ``mesh_shape`` {"data": 2, "model": 2}, ``collective.*`` above 0 and,
   under a spawner's ``STC_TRACE``, its trace id on every rank's
   ``micro_batch`` events;
   and, on config A's in-process fit, the disabled facade's estimated
   cost (telemetry calls of one enabled fit x each disabled primitive's
   time in a tight loop, the dispatch wrapper among them) within 2% of
   the fit, beside the enabled and
   disabled ms a sweep.  A ``telemetry`` line sums the seconds these
   phases added;
20. a ``total`` line with the run's seconds, then a ``kernels`` line: per
   kernel, the launches of the main-path runs of 3-18 (each must be > 0),
   the largest difference from the plain version, and the times beside
   the card's bound (the E-step's entry also M's own, as ``config_M``).

Every phase prints one JSON line; the first line is ``nvidia-smi``'s name
and power limit, and the last is ``{"ok": true, "device": {...}}``.  Any
failure raises: nothing falls back to the CPU.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.  Imports only the port, torch, numpy and the standard library.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores

EN_DOCS, EN_V, EN_K = 51, 39_380, 5
NG_DOCS, NG_V, NG_K = 11_314, 1 << 18, 20
SWEEPS = 50                    # MLlib's maxIterations for both configs
ONLINE_ITERS = 60              # bench.py's online protocol: 3 epochs
ONLINE_CHECK_ITERS = 10        # card vs CPU iterations of config C
EVAL_DOCS = 512                # bench.py's log-perplexity batch
NMF_ITERS = 40                 # bench.py's NMF row
NMF_CHECK_ITERS = 10           # card vs CPU sweeps of config D
EN_LEXICON, EN_ZIPF = 28_000, 1.2  # config E's pseudo-word books
F_WORDS = 60_000               # config F's books: one length, ~10.5k terms


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# ---- corpora: the two shapes of bench.py, made from the seed -------------
def en_books_rows(seed: int):
    """EN-shaped corpus: 51 books of 2,000-20,000 distinct terms."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(EN_DOCS):
        nnz = int(rng.integers(2000, 20000))
        ids = np.sort(rng.choice(EN_V, size=nnz, replace=False)).astype(np.int32)
        rows.append((ids, rng.integers(1, 50, nnz).astype(np.float32)))
    return rows


def newsgroups_rows(seed: int):
    """20NG-shaped corpus: Zipf-distributed hashed ids, ~110 distinct
    terms per doc."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(NG_V)
    rows = []
    for _ in range(NG_DOCS):
        nnz = min(max(4, int(rng.lognormal(mean=4.4, sigma=0.8))), 2048)
        ranks = rng.zipf(1.3, size=nnz * 2) - 1
        ranks = ranks[ranks < NG_V][:nnz]
        ids = np.unique(perm[ranks]).astype(np.int32)
        rows.append((ids, rng.integers(1, 6, size=ids.size).astype(np.float32)))
    return rows


def en_books_dir(seed: int, root: str, n_books: int = EN_DOCS,
                 words=(8_000, 120_000)) -> str:
    """A directory of ``n_books`` plain-text EN-shaped books, made from the
    seed: pseudo-words from a lexicon of EN_LEXICON consonant-vowel strings
    of 2-5 syllables, drawn Zipf(EN_ZIPF) by rank with a shift for each
    book, in sentences of 8-20 words that start capitalized and end with
    '.'.  Book lengths are spaced geometrically over ``words`` (shuffled),
    so the shortest and the longest book are the same on every draw.
    Writes ``<root>/books/*.txt`` and a one-line stop-word file of 20
    lexicon words; returns the stop-word file's path."""
    rng = np.random.default_rng(seed)
    cons, vows = np.array(list("bcdfghklmnprstvz")), np.array(list("aeiou"))
    lexicon, seen = [], set()
    while len(lexicon) < EN_LEXICON:
        syl = rng.integers(2, 6, EN_LEXICON)
        c = cons[rng.integers(0, len(cons), (EN_LEXICON, 5))]
        v = vows[rng.integers(0, len(vows), (EN_LEXICON, 5))]
        for j in range(EN_LEXICON):
            w = "".join(c[j, s] + v[j, s] for s in range(syl[j]))
            if w not in seen and len(lexicon) < EN_LEXICON:
                seen.add(w)
                lexicon.append(w)
    lexicon = np.array(lexicon, dtype=object)
    capital = np.array([w.capitalize() for w in lexicon], dtype=object)
    books = os.path.join(root, "books")
    os.makedirs(books, exist_ok=True)
    sizes = rng.permutation(
        np.geomspace(words[0], words[1], n_books).round().astype(int))
    for b, n in enumerate(sizes):
        idx = ((rng.zipf(EN_ZIPF, n) - 1) % EN_LEXICON
               + rng.integers(0, EN_LEXICON)) % EN_LEXICON
        ends = np.cumsum(rng.integers(8, 21, n // 8 + 1))
        ends = ends[ends < n]
        toks = lexicon[idx]
        starts = np.concatenate([[0], ends])
        toks[starts] = capital[idx[starts]]
        toks[np.append(ends - 1, n - 1)] += "."
        with open(os.path.join(books, f"book_{b:02d}.txt"), "w") as f:
            f.write(" ".join(toks))
    stop = os.path.join(root, "stop_words.txt")
    with open(stop, "w") as f:
        f.write(",".join(lexicon[:20]))
    return stop


def flat_rows(rows):
    """(ids, weights, doc offsets) of ``rows`` as flat arrays, the tile
    planner's input."""
    offsets = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(i) for i, _ in rows], out=offsets[1:])
    return (np.concatenate([i for i, _ in rows]),
            np.concatenate([w for _, w in rows]), offsets)


# ---- timing ----------------------------------------------------------------
def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(torch, fn, reps: int) -> float:
    """Mean device milliseconds per call: ``fn`` captured once in a CUDA
    graph and replayed ``reps`` times, so the host's launch overhead
    drops out."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(torch, graph.replay, reps)


def host_ms(torch, fn, reps: int) -> float:
    """Mean host milliseconds to enqueue one call of ``fn`` over ``reps``
    back-to-back calls, after one warm-up: the wrapper's Python and the
    launch, with the card left to catch up afterwards.  Where it exceeds
    the device time, ``cuda_ms`` reads the host's rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 2: each kernel against its plain version ------------------------
def sorted_layout(torch, rows, v, dev):
    """The fit's packed, vocab-sorted token layout for ``rows``."""
    from spark_text_clustering_tpu_torch.models.em_lda import packed_plan
    from spark_text_clustering_tpu_torch.ops.emscatter import plan_em_scatter

    ids, cts, seg, _, d_max = packed_plan(rows)
    plan = plan_em_scatter(ids[None], cts[None], 1, v)
    so = plan.sort_order[0]

    def srt(a):
        return torch.from_numpy(np.concatenate([a, a[:1] * 0])[so]).to(dev)

    return plan, srt(ids), srt(cts), srt(seg), d_max


def soft_start(torch, rows, k, v, seed):
    """(N_wk [k, V], N_dk [docs, k]) on the CPU: each token's weight
    spread over the topics by a Dirichlet(1) draw, as the EM fit starts."""
    gen = torch.Generator().manual_seed(seed)
    n_wk = torch.zeros((k, v))
    n_dk = torch.zeros((len(rows), k))
    for d, (ids, w) in enumerate(rows):
        e = torch.empty((len(ids), k)).exponential_(generator=gen)
        wphi = torch.from_numpy(w)[:, None] * e / e.sum(1, keepdim=True)
        n_dk[d] = wphi.sum(0)
        n_wk.index_add_(1, torch.from_numpy(ids).long(), wphi.T)
    return n_wk.numpy(), n_dk.numpy()


def sweep_args(torch, plan, cts_s, seg_s, d_max, k, v, dev, rng,
               start=None):
    """The fused sweep's inputs on the sorted layout: the counts ``start``
    gives as (N_wk, N_dk), else random ones, the EM priors' factors, and
    the doc stream ``doc_stream`` builds."""
    from spark_text_clustering_tpu_torch.ops import emsweep

    d_pad = emsweep.fused_d_pad(d_max)
    alpha, eta = 50.0 / k + 1.0, 1.1
    if start is None:
        start = (rng.gamma(1.0, 20.0, (k, v)).astype(np.float32),
                 rng.gamma(1.0, 2000.0, (d_max, k)).astype(np.float32))
    n_wk, n_dk = (torch.from_numpy(a).to(dev) for a in start)
    inv_denom = 1.0 / (n_wk.sum(1) + (eta * v - v))
    docf = torch.zeros((k, d_pad), device=dev)
    docf[:, :d_max] = (n_dk + (alpha - 1.0)).T
    blk = (plan.nb, 1, plan.tb)
    sorted_ = (torch.from_numpy(plan.lids[0, 0]).to(dev), seg_s.reshape(blk),
               cts_s.reshape(blk),
               torch.from_numpy(plan.block_vtile[0, 0]).to(dev))
    args = (n_wk, docf, inv_denom, *sorted_,
            *emsweep.doc_stream(*sorted_, plan.vt))
    geo = dict(n_vtiles=plan.n_vtiles, nb=plan.nb, vt=plan.vt, tb=plan.tb,
               d_pad=d_pad, shard_v=v, eta_m1=eta - 1.0)
    return args, geo


def sweep_against_plain(torch, args, geo):
    """The kernel against its plain version (rtol 1e-4, atol 1e-5) and
    against itself (bit for bit): (kernel's outputs, max abs error, max
    error relative to max(|plain|, 1))."""
    from spark_text_clustering_tpu_torch.ops import emsweep

    got = emsweep.em_sweep_fused(*args, **geo)
    want = emsweep.em_sweep_fused_plain(*args, **geo)
    again = emsweep.em_sweep_fused(*args, **geo)
    torch.cuda.synchronize()
    err = rel = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g - w).abs().max()))
        rel = max(rel, float(((g - w).abs() / w.abs().clamp(min=1.0)).max()))
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-5):
            raise AssertionError(
                f"em_sweep_fused differs from its plain version by {err} "
                f"at k={args[0].shape[0]}, d_pad={geo['d_pad']}")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("em_sweep_fused does not repeat bit for bit")
    return got, err, rel


def sweep_edge_rows(seed, n_docs, nnz, v=EN_V):
    """``n_docs`` docs of ``nnz`` distinct terms of V=39,380, counts 1-49."""
    rng = np.random.default_rng(seed)
    return [(np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32),
             rng.integers(1, 50, nnz).astype(np.float32))
            for _ in range(n_docs)]


def check_sweep_start(torch, rows, k, v, dev, seed):
    """The fused sweep against its plain version on ``rows`` (a main
    path's own weights) from the fit's kind of start."""
    plan, _, cts_s, seg_s, d_max = sorted_layout(torch, rows, v, dev)
    start = soft_start(torch, rows, k, v, seed)
    args, geo = sweep_args(torch, plan, cts_s, seg_s, d_max, k, v, dev,
                           None, start=start)
    _, err, rel = sweep_against_plain(torch, args, geo)
    return {"docs": d_max, "k": k, "shard_v": v, "d_pad": geo["d_pad"],
            "tokens": int((cts_s > 0).sum()),
            "min_weight": float(min(w.min() for _, w in rows)),
            "max_weight": float(max(w.max() for _, w in rows)),
            "max_abs_err": err, "max_rel_err": rel,
            "tolerance": "rtol 1e-4, atol 1e-5", "bitwise_repeatable": True}


def check_sweep(torch, rows, dev, rng, seed):
    """The fused sweep on config A's inputs, and on the geometries the
    first kernel refused: 512 docs at k=40 (the doc factor read through
    L1/L2) and 8 docs at k=500 (16 topic slices)."""
    from spark_text_clustering_tpu_torch.ops import emsweep

    k, v = EN_K, EN_V
    plan, _, cts_s, seg_s, d_max = sorted_layout(torch, rows, v, dev)
    args, geo = sweep_args(torch, plan, cts_s, seg_s, d_max, k, v, dev, rng)
    # the gate: d <= 512 at every k, as on the CPU
    gate = {f"d{d}_k{kk}": emsweep.fused_eligible(d)
            for d, kk in ((d_max, k), (8, 500), (512, 40), (513, 5))}
    if gate != {f"d{d_max}_k{k}": True, "d8_k500": True, "d512_k40": True,
                "d513_k5": False}:
        raise AssertionError(f"fused gate: {gate}")
    got, err, rel = sweep_against_plain(torch, args, geo)
    edges = []
    edge_rng = np.random.default_rng(seed + 5)
    for n_docs, nnz, kk in ((512, 200, 40), (8, 2000, 500)):
        e_rows = sweep_edge_rows(seed + 6 + kk, n_docs, nnz)
        e_plan, _, e_cts, e_seg, e_d = sorted_layout(torch, e_rows, v, dev)
        e_args, e_geo = sweep_args(torch, e_plan, e_cts, e_seg, e_d, kk, v,
                                   dev, edge_rng)
        _, e_err, e_rel = sweep_against_plain(torch, e_args, e_geo)
        edges.append({"docs": e_d, "k": kk, "d_pad": e_geo["d_pad"],
                      "tokens": int(e_args[8].shape[0]),
                      "docf_in_smem": kk * e_geo["d_pad"] <= 4096,
                      "max_abs_err": e_err, "max_rel_err": e_rel,
                      "bitwise_repeatable": True})

    def kernel():
        return emsweep.em_sweep_fused(*args, **geo)

    # the kernel's cost (emsweep.cost) at the live slots
    live = int((cts_s > 0).sum())
    t_bytes, by = bound(*emsweep.cost(*args, **geo, live=live))
    return {
        "name": "em_sweep_fused", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/emsweep.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_emsweep.py:203",
        "shape": {"k": k, "shard_v": v, "tokens": live, "nb": plan.nb,
                  "d_pad": geo["d_pad"]},
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": "rtol 1e-4, atol 1e-5",
        "bitwise_repeatable": True, "gate": gate, "edges": edges,
        "registers": ptxas_report("emsweep"),
        "ms": cuda_ms(torch, kernel, 20),
        "graph_ms": cuda_graph_ms(torch, kernel, 50),
        "host_ms": host_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: emsweep.em_sweep_fused_plain(
            *args, **geo), 5),
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
    }


SCATTER_EDGE_V = 1000           # 4 vocab tiles of 256, the last 232 wide


def scatter_edge_case(torch, dev, rng, k, spread_pads=False):
    """The scatter on a plan built for its edges (vt=256, tb=1024): tile 0
    holds a hot column of 13,000 tokens (a run across >= 3 blocks) and
    6,000 more, so it spans >= 16 blocks; tile 1 one partial block; tile 2
    no token (an all-pad block); tile 3 is 232 columns wide (shard_v=1000
    is no multiple of vt).  With ``spread_pads``, every block that is at
    most half live has its live slots moved to even slots, so its pieces'
    live slots are no prefix."""
    from spark_text_clustering_tpu_torch.ops import emscatter

    v = SCATTER_EDGE_V
    ids = np.concatenate([
        np.full(13_000, 7), rng.integers(0, 256, 6_000),
        rng.integers(256, 512, 300), rng.integers(768, v, 700),
    ]).astype(np.int32)
    cts = (rng.random(ids.size) + 0.1).astype(np.float32)
    cts[rng.random(ids.size) < 0.1] = 0.0
    plan = emscatter.plan_em_scatter(ids[None], cts[None], 1, v)
    nb, tb = plan.nb, plan.tb
    cts_s = np.concatenate([cts, [0.0]])[plan.sort_order[0]]
    wphi = (cts_s[:, None] * rng.random((nb * tb, k))).astype(np.float32)
    lids = plan.lids[0, 0].reshape(nb, tb).copy()
    wphi3 = wphi.reshape(nb, tb, k)
    if spread_pads:
        for blk in range(nb):
            m = int((lids[blk] >= 0).sum())
            if 0 < m <= tb // 2:
                live_l, live_w = lids[blk, :m].copy(), wphi3[blk, :m].copy()
                lids[blk], wphi3[blk] = -1, 0.0
                lids[blk, 0:2 * m:2], wphi3[blk, 0:2 * m:2] = live_l, live_w
    bv = plan.block_vtile[0, 0]
    hot = (lids == 7) & (bv[:, None] == 0)
    args = (torch.from_numpy(wphi).to(dev),
            torch.from_numpy(lids.reshape(nb, 1, tb)).to(dev),
            torch.from_numpy(bv).to(dev))
    geo = dict(n_vtiles=plan.n_vtiles, vt=plan.vt, tb=tb, shard_v=v)
    got = emscatter.scatter_add_vtiles(*args, nb=nb, **geo)
    want = emscatter.scatter_add_vtiles_plain(*args, **geo)
    again = emscatter.scatter_add_vtiles(*args, nb=nb, **geo)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    case = {"k": k, "shard_v": v, "nb": nb,
            "tile0_blocks": int((bv == 0).sum()),
            "hot_run_blocks": int(hot.any(1).sum()),
            "all_pad_blocks": int((lids < 0).all(1).sum()),
            "pads_inside_blocks": spread_pads, "max_abs_err": err,
            "bitwise_repeatable": bool(torch.equal(got, again))}
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5) or not (
        case["bitwise_repeatable"] and case["tile0_blocks"] >= 16
        and case["hot_run_blocks"] >= 3 and case["all_pad_blocks"] >= 1
    ):
        raise AssertionError(f"scatter_add_vtiles edge geometry: {case}")
    return case


def check_scatter(torch, rows, dev, rng, edge_rng, profile=False):
    """The scatter on config B's inputs and the edge geometries; with
    ``profile``, also the all-slot ``index_add_`` calls and the live-slot
    one by CUDA-graph replay."""
    from spark_text_clustering_tpu_torch.ops import emscatter

    k, v = NG_K, NG_V
    plan, ids_s, cts_s, _, _ = sorted_layout(torch, rows, v, dev)
    t = ids_s.shape[0]
    phi = torch.from_numpy(rng.exponential(size=(t, k)).astype(np.float32)).to(dev)
    wphi = (cts_s[:, None] * phi / phi.sum(1, keepdim=True)).contiguous()
    lids = torch.from_numpy(plan.lids[0, 0]).to(dev)
    bv = torch.from_numpy(plan.block_vtile[0, 0]).to(dev)
    geo = dict(n_vtiles=plan.n_vtiles, vt=plan.vt, tb=plan.tb, shard_v=v)
    got = emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)
    want = emscatter.scatter_add_vtiles_plain(wphi, lids, bv, **geo)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(
            f"scatter_add_vtiles differs from its plain version by {err}")
    again = emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)
    if not torch.equal(got, again):
        raise AssertionError("scatter_add_vtiles does not repeat bit for bit")
    ids_l = ids_s.long()

    def kernel():
        return emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)

    # the same sums by one PyTorch call: index_add_ of the live slots into
    # a [V, k] table (k contiguous values an id) is the fastest; over all
    # slots, every pad slot adds 0 to id 0
    sel = (cts_s > 0).nonzero().squeeze(1)
    ids_live, wphi_live = ids_l[sel], wphi[sel].contiguous()

    def library():
        return torch.zeros((v, k), device=dev).index_add_(0, ids_live,
                                                          wphi_live)

    def library_cols():
        return torch.zeros((k, v), device=dev).index_add_(1, ids_l, wphi.T)

    def library_rows():
        return torch.zeros((v, k), device=dev).index_add_(0, ids_l, wphi)

    edges = [scatter_edge_case(torch, dev, edge_rng, kk) for kk in (5, 20, 500)]
    edges.append(scatter_edge_case(torch, dev, edge_rng, NG_K,
                                   spread_pads=True))
    # the kernel's cost (emscatter.cost) at the live slots
    live = int((cts_s > 0).sum())
    t_bytes, by = bound(*emscatter.cost(wphi, lids, bv, shard_v=v,
                                        live=live))
    extra = {}
    if profile:
        extra = {
            "library_graph_ms": cuda_graph_ms(torch, library, 50),
            "library_cols_ms": cuda_ms(torch, library_cols, 20),
            "library_rows_ms": cuda_ms(torch, library_rows, 20),
            "library_all_slots_max_abs_err": max(
                float((library_cols() - got).abs().max()),
                float((library_rows().T - got).abs().max())),
        }
    return {
        "name": "scatter_add_vtiles", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/emscatter.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_emscatter.py:236",
        "shape": {"k": k, "shard_v": v, "tokens": live, "nb": plan.nb,
                  "piece": emscatter.scatter_piece(plan.tb)},
        "max_abs_err": max([err] + [e["max_abs_err"] for e in edges]),
        "main_max_abs_err": err, "max_rel_err": rel,
        "library_max_abs_err": float((library().T - got).abs().max()),
        "tolerance": "rtol 1e-5, atol 1e-5",
        "bitwise_repeatable": True,
        "geometries": edges,
        "ms": cuda_ms(torch, kernel, 20),
        "graph_ms": cuda_graph_ms(torch, kernel, 50),
        "plain_ms": cuda_ms(torch, lambda: emscatter.scatter_add_vtiles_plain(
            wphi, lids, bv, **geo), 5),
        "bound_ms": t_bytes, "bound_by": by,
        "library_ms": cuda_ms(torch, library, 20),
        "pad_slots": t - live, **extra,
    }


ESTEP_SMEM_LIMIT = 232448       # 227 KB a block on the H100
ESTEP_MAX_K = 1752              # stc_estep_max_k: the wide state in 227 KB
# The wide instance (k > 64) is held to 1e-5 on normalized gamma, not E's
# 5e-3 band, which at k = 500 is 2.5 times a topic's typical 1/k: on the
# H100 its cases differed from the plain version by at most 1.09e-6.
ESTEP_WIDE_ATOL = 1e-5


def estep_atol(k):
    """The bound on normalized gamma of an E-step launch at ``k``."""
    return ESTEP_WIDE_ATOL if k > 64 else 5e-3
ESTEP_INSTANCES = {"slab_k8", "l2_k8", "phase_k32", "l2_k32", "phase_k64",
                   "l2_k64", "wide"}


def estep_instance(k, l, tile_b, cs):
    """Which of ``csrc/estep.cu``'s seven kernel instances a launch takes:
    the wide one for k > 64, else a copy of its ``geometry()``, which
    keeps a CTA's slab share in shared memory wherever it fits (two-phase
    for k > 8, the register loop for k <= 8) and otherwise streams it from
    L2 (the register loop of the k <= 8, <= 32 or <= 64 instance)."""
    if k > 64:
        return "wide"
    tk = tile_b * k
    ls = (-(-l // cs) + 31) // 32 * 32
    state = 4 * (k + (2 + (2 if cs > 1 else 1)) * tk + 8)
    kmax = 8 if k <= 8 else 32 if k <= 32 else 64
    if k > 8:
        threads = max(256, (-(-tile_b * ls // 8) + 31) // 32 * 32)
        chunks = 1 if tk >= threads else min(32, threads // tk)
        slab = 4 * (tk * ls + tile_b * ls + (tk * chunks if chunks > 1 else 0))
        if threads <= 1024 and state + slab <= ESTEP_SMEM_LIMIT:
            return f"phase_k{kmax}"
    else:
        wpd = min(1024 // 32 // tile_b, -(-ls // 128))
        if state + 4 * tk * wpd + 4 * tile_b * ls * (k + 1) <= ESTEP_SMEM_LIMIT:
            return "slab_k8"
    return f"l2_k{kmax}"


def estep_wide_chunks(k, l, tile_b, cs):
    """The wide instance's ratio chunk (slots a doc) and the chunks a CTA
    walks: a copy of ``csrc/estep.cu``'s ``wide_geometry()``, whose chunk
    is a CTA's slice of L, at most 1,024 slots and at most what the tile
    state leaves of shared memory."""
    ls = (-(-l // cs) + 31) // 32 * 32
    state = 4 * (k + (2 + (2 if cs > 1 else 1)) * tile_b * k + 8)
    room = (ESTEP_SMEM_LIMIT - state) // (4 * tile_b) // 32 * 32
    rc = min(ls, 1024, room)
    return rc, -(-ls // rc)


def estep_case(torch, eb, cts, alpha, g0, label, timed=True):
    """The gamma kernel against its plain version on (eb [B, k, L], cts,
    alpha, gamma0): normalized gamma within ``estep_atol(k)`` with equal
    argmax, a bit-for-bit repeat; its cluster size and instance, bound,
    and (where ``timed``) times."""
    from spark_text_clustering_tpu_torch.ops import estep

    b, k, width = eb.shape
    got = estep.gamma_fixed_point_bkl(eb, cts, alpha, g0)
    want, iters = estep.gamma_fixed_point_bkl_plain(eb, cts, alpha, g0,
                                                   with_iters=True)
    again = estep.gamma_fixed_point_bkl(eb, cts, alpha, g0)
    torch.cuda.synchronize()
    gn = got / got.sum(1, keepdim=True)
    wn = want / want.sum(1, keepdim=True)
    err = float((gn - wn).abs().max())
    rel = float(((got - want).abs() / want.abs()).max())
    if not err <= estep_atol(k) or not torch.equal(gn.argmax(1),
                                                   wn.argmax(1)):
        raise AssertionError(
            f"gamma_fixed_point_bkl differs from its plain version by {err}")
    if not torch.equal(got, again):
        raise AssertionError(f"gamma_fixed_point_bkl does not repeat bit for "
                             f"bit on {label}'s batch [{b}, {k}, {width}]")
    tile_b = min(8, b)
    n_tiles = -(-b // tile_b)
    cluster = estep.cluster_size(n_tiles, width, estep._sm_count(eb.device))
    t_bytes, by = estep_bound(eb, cts, alpha, g0, iters, tile_b)
    return {
        "shape": [b, k, width], "tiles": n_tiles, "cluster": cluster,
        "instance": estep_instance(k, width, tile_b, cluster),
        "live_slots": int((cts > 0).sum()),
        "tile_iterations_max": int(iters.max()),
        "max_abs_err": err, "max_rel_err": rel,
        "tolerance": f"normalized gamma atol {estep_atol(k)}, argmax equal",
        "bitwise_repeatable": True,
        "ms": cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl(
            eb, cts, alpha, g0), 5) if timed else None,
        "plain_ms": cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl_plain(
            eb, cts, alpha, g0), 2) if timed else None,
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
    }


def check_estep(torch, rows, k, v, dev, rng, label, pick):
    """The gamma kernel on one scoring bucket of ``rows``: the most
    populated (``pick="docs"``) or the widest (``pick="width"``)."""
    from spark_text_clustering_tpu_torch.ops.lda_math import dirichlet_expectation
    from spark_text_clustering_tpu_torch.ops.sparse import bucket_by_length

    buckets = bucket_by_length(rows, device=dev)
    if pick == "docs":
        width = max(buckets, key=lambda w: len(buckets[w][1]))
    else:
        width = max(buckets)
    batch, idxs = buckets[width]
    lam = torch.from_numpy(rng.gamma(1.0, 20.0, (k, v)).astype(np.float32)).to(dev)
    eb_full = torch.exp(dirichlet_expectation(lam))
    eb = eb_full.T[batch.token_ids.long()].permute(0, 2, 1).contiguous()
    cts = batch.token_weights.contiguous()
    alpha = torch.full((k,), 50.0 / k + 1.0, device=dev)
    g0 = torch.ones((len(idxs), k), device=dev)
    return {"name": "gamma_fixed_point_bkl", "config": label, "bucket": pick,
            **estep_case(torch, eb, cts, alpha, g0, label)}


# (b, k, L, max_inner): b=21 and 13 are no multiple of tile_b=8 (three
# and two tiles); L=128-2048 makes cluster_size return 1, 2, 4, 8 and 16;
# together they reach all seven kernel instances (estep_instance); k = 65,
# 100, 129 and 500 at L = 1024 and 16384 take the wide one (k > 64), in
# one ratio chunk a CTA; 17 tiles at L = 16384 give clusters of 8, so a
# CTA's 2,048 slots take two chunks of 1,024; at k = 1,700 the tile state
# leaves room for chunks of 224 slots (four, then one of 128), and at the
# largest k for chunks of 32
ESTEP_WIDE_K = (65, 100, 129, 500)
ESTEP_EDGES = (
    [(21, 5, l, 100) for l in (128, 256, 512, 1024, 2048)]
    + [(21, 5, 8192, 100), (21, 5, 32768, 100), (21, 20, 2048, 100),
       (13, 20, 16384, 100), (13, 64, 64, 100), (13, 64, 1024, 100),
       (13, 64, 8192, 100), (13, 20, 1024, 0)]
    + [(13, k, l, 100) for k in ESTEP_WIDE_K for l in (1024, 16384)]
    + [(136, 100, 16384, 100), (13, 1700, 16384, 100),
       (13, ESTEP_MAX_K, 1024, 100)]
)


def estep_bound(eb, cts, alpha, g0, iters, tile_b):
    """The least time of one padded E-step call on the card: its cost
    (``estep.cost``) at each doc's live slots and each tile's iterations
    ``iters``."""
    from spark_text_clustering_tpu_torch.ops import estep

    return bound(*estep.cost(eb, cts, alpha, g0, tile_b=tile_b, iters=iters,
                             live=(cts > 0).sum(1)))


def check_estep_edges(torch, dev, rng):
    """The gamma kernel against its plain version at the edges of its
    contract: every cluster size, b no multiple of tile_b, k = 5, 20, 64
    and the wide instance's 65, 100, 129, 500, 1,700 and largest k (one
    ratio chunk a CTA, two, and chunks cut short by the tile state),
    max_inner = 0, every kernel instance, and in every case one doc whose
    cts are all zero and docs whose live slots are a prefix of random
    length.  The wide cases are timed beside their bound and the plain
    version."""
    from spark_text_clustering_tpu_torch.ops import estep

    max_k = estep._build.load_library("estep").stc_estep_max_k()
    if max_k != ESTEP_MAX_K:
        raise AssertionError(f"stc_estep_max_k is {max_k}, not {ESTEP_MAX_K}")
    cases = []
    for b, k, l, max_inner in ESTEP_EDGES:
        eb = torch.from_numpy(rng.gamma(1.0, 1.0, (b, k, l)).astype(np.float32)).to(dev)
        lens = rng.integers(1, l + 1, b)
        lens[1] = 0
        cts_np = rng.integers(1, 6, (b, l)).astype(np.float32)
        cts_np[np.arange(l)[None, :] >= lens[:, None]] = 0.0
        cts = torch.from_numpy(cts_np).to(dev)
        alpha = torch.full((k,), 1.0 / k, device=dev)
        g0 = torch.from_numpy(rng.gamma(100.0, 0.01, (b, k)).astype(np.float32)).to(dev)
        got = estep.gamma_fixed_point_bkl(eb, cts, alpha, g0, max_inner)
        again = estep.gamma_fixed_point_bkl(eb, cts, alpha, g0, max_inner)
        want, iters = estep.gamma_fixed_point_bkl_plain(
            eb, cts, alpha, g0, max_inner, with_iters=True)
        torch.cuda.synchronize()
        gn = got / got.sum(1, keepdim=True)
        wn = want / want.sum(1, keepdim=True)
        cs = estep.cluster_size(-(-b // 8), l, estep._sm_count(dev))
        case = {"shape": [b, k, l], "max_inner": max_inner, "cluster": cs,
                "instance": estep_instance(k, l, 8, cs),
                "max_abs_err": float((gn - wn).abs().max()),
                "bitwise_repeatable": bool(torch.equal(got, again))}
        ok = (case["max_abs_err"] <= estep_atol(k) and case["bitwise_repeatable"]
              and torch.equal(gn.argmax(1), wn.argmax(1)))
        if max_inner == 0:
            ok = ok and bool(torch.equal(got, g0))
        if not ok:
            raise AssertionError(f"gamma_fixed_point_bkl edge geometry: {case}")
        if k > 64:
            b_ms, b_by = estep_bound(eb, cts, alpha, g0, iters, 8)
            rc, chunks = estep_wide_chunks(k, l, 8, cs)
            case.update(
                ratio_chunk=rc, chunks=chunks,
                tile_iterations_max=int(iters.max()),
                ms=cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl(
                    eb, cts, alpha, g0, max_inner), 3),
                plain_ms=cuda_ms(torch, lambda: estep.gamma_fixed_point_bkl_plain(
                    eb, cts, alpha, g0, max_inner), 1),
                bound_ms=b_ms, bound_by=b_by)
        del eb
        cases.append(case)
    if sorted({c["cluster"] for c in cases}) != [1, 2, 4, 8, 16] or (
        {c["instance"] for c in cases} != ESTEP_INSTANCES
    ):
        raise AssertionError(f"edge geometries missed a cluster size or a "
                             f"kernel instance: {cases}")
    wide = [c for c in cases if "chunks" in c]
    if not any(c["chunks"] > 1 and c["ratio_chunk"] == 1024 for c in wide) or (
        not any(c["chunks"] > 1 and c["ratio_chunk"] < 1024 for c in wide)
    ):
        raise AssertionError(f"edge geometries missed the wide instance's "
                             f"chunks: {wide}")
    return cases


def online_params(seed: int, iters=None):
    """Config C: bench.py's online protocol (tau0, kappa and the 1/k
    priors are the Params defaults for algorithm="online")."""
    from spark_text_clustering_tpu_torch import Params

    return Params(k=NG_K, algorithm="online",
                  max_iterations=ONLINE_ITERS if iters is None else iters,
                  sampling="epoch", seed=seed)


def tiles_case(torch, packed, args, d, label, doc_ids=None, b=None,
               max_inner=100):
    """The tile kernel against its plain version on ``args`` (eb, cts,
    seg, alpha, gamma0): normalized gamma within 5e-3, a bit-for-bit
    repeat, pad slots (``doc_ids == b``) at exactly alpha once an
    iteration ran, and gamma0 as it is at max_inner=0.  Returns the
    plain version's iterations per tile and the case's record."""
    got = packed.gamma_fixed_point_tiles(*args, d, max_inner)
    again = packed.gamma_fixed_point_tiles(*args, d, max_inner)
    want, iters = packed.gamma_fixed_point_tiles_plain(
        *args, d, max_inner, with_iters=True)
    torch.cuda.synchronize()
    gn = got / got.sum(0, keepdim=True)
    wn = want / want.sum(0, keepdim=True)
    k = args[0].shape[0]
    n_tiles, tt = args[1].shape
    warps = packed.tile_warps(tt)
    scratch = packed._build.load_library("packed").stc_tiles_scratch_floats(
        k, d, tt, warps)
    case = {"case": label, "k": k, "d": d, "tt": tt, "tiles": n_tiles,
            "max_inner": max_inner, "warps": warps,
            "state": "global" if scratch else "shared",
            "tile_iterations_max": int(iters.max()) if n_tiles else 0,
            "tile_iterations_mean": float(iters.to(torch.float64).mean()),
            "max_abs_err": float((gn - wn).abs().max()),
            "max_rel_err": float(((got - want).abs() / want.abs()).max()),
            "bitwise_repeatable": bool(torch.equal(got, again))}
    if doc_ids is not None:
        pad = torch.from_numpy(doc_ids.reshape(-1) == b).to(got.device)
        case["pad_slots"] = int(pad.sum())
        alpha = args[3][:, None].expand(k, case["pad_slots"])
        case["pad_slots_exactly_alpha"] = bool(torch.equal(
            got[:, pad], args[4][:, pad] if max_inner == 0 else alpha))
    ok = case["max_abs_err"] <= 5e-3 and case["bitwise_repeatable"] and (
        case.get("pad_slots_exactly_alpha", True))
    if max_inner == 0:
        ok = ok and bool(torch.equal(got, args[4]))
    if not ok:
        raise AssertionError(f"gamma_fixed_point_tiles, {label}: {case}")
    return iters, case


def tiles_bound(torch, args, d, iters, live_slots):
    """The least time for one launch on ``args``: its cost
    (``packed.cost``) at each tile's live tokens, the live slots and each
    tile's iterations ``iters``."""
    from spark_text_clustering_tpu_torch.ops import packed

    return bound(*packed.cost(*args, d, iters=iters,
                              live_tokens=(args[2] < d).sum(1),
                              live_slots=live_slots))


# (label, k, doc lengths or a corpus name, n_shards, max_inner, tiles):
# k past 32 and 64 run the lane loop over topics; "one_doc_512" is a tile
# holding one 512-token doc; n_shards=4 pads the tile axis with all-pad
# tiles; "empty_slots" has token-less docs between live ones; one-token
# docs give d=512 (state in shared memory), the NMF geometry rows d=2048
# (state in the global scratch, as for k=64 and k=200); "uniform" is a
# minibatch of the host-streaming path as its planner cuts it: 20NG-shaped
# docs and 200 pad picks in the last tiles, d=256, and the tile count
# rounded up to a power of two with all-pad tiles
TILES_EDGES = (
    ("k5", 5, "ng", 1, 100, 2), ("k20", 20, "ng", 1, 100, 3),
    ("k33", 33, "ng", 1, 100, 2), ("k64", 64, "ng", 1, 100, 2),
    ("k200", 200, "ng", 1, 100, 1),
    ("one_doc_512", 20, [512, 30, 40], 1, 100, 2),
    ("all_pad_tiles", 20, [30, 40, 50], 4, 100, 4),
    ("empty_slots", 20, "empty", 1, 100, 1),
    ("max_inner_0", 20, "ng", 1, 0, 2), ("max_inner_1", 20, "ng", 1, 1, 2),
    ("d512", 20, [1] * 600, 1, 100, 1), ("d2048", 20, "nmf", 1, 100, 1),
    ("uniform", 20, "uniform", 1, 100, None),
)


def uniform_minibatch(packed, rng, lens, v, k, pads=200):
    """One minibatch of ``len(lens)`` docs and ``pads`` pad picks, packed
    and planned as the host-streaming online fit plans a chunk
    (``plan_tile_pack_uniform``): its (ids, cts, seg, doc_ids) [n_tiles,
    ...] and its doc count b."""
    b = len(lens) + pads
    ids = np.concatenate([np.sort(rng.choice(v, size=int(m), replace=False))
                          for m in lens]).astype(np.int32)
    seg = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    cts = rng.integers(1, 6, ids.size).astype(np.float32)
    plan = packed.plan_tile_pack_uniform([(ids, cts, seg)], b=b,
                                         tile_tokens=512, k=k)
    return plan.ids[0], plan.cts[0], plan.seg[0], plan.doc_ids[0], plan.d, b


def check_tiles_edges(torch, dev, rng, seed):
    """The tile kernel at the edges of its contract (TILES_EDGES), each
    on a tile plan of its own corpus, eb from a random lambda."""
    from spark_text_clustering_tpu_torch.ops import packed

    v = 4096
    ng = np.minimum(np.maximum(4, rng.lognormal(4.4, 0.8, 300).astype(int)),
                    400)
    empty = rng.integers(5, 60, 20)
    empty[[3, 4, 9]] = 0
    cases = []
    for label, k, lens, n_shards, max_inner, n_tiles in TILES_EDGES:
        uniform = isinstance(lens, str) and lens == "uniform"
        if uniform:
            t_ids, t_cts, t_seg, t_doc, d, b = uniform_minibatch(
                packed, rng, ng[:200], v, k)
        else:
            if lens == "nmf":
                rows = nmf_geometry_rows(seed)
            else:
                lens = {"ng": ng, "empty": empty}[lens] if isinstance(
                    lens, str) else lens
                rows = [(np.sort(rng.choice(v, size=int(m), replace=False)).astype(np.int32),
                         rng.integers(1, 6, int(m)).astype(np.float32)) for m in lens]
            plan = packed.plan_corpus_tiles(*flat_rows(rows),
                                            n_shards=n_shards, k=k)
            sel = np.arange(min(n_tiles, plan.ids.shape[0]))
            t_ids, t_cts, t_seg, t_doc = (
                a[sel] for a in (plan.ids, plan.cts, plan.seg, plan.doc_ids))
            d, b = plan.d, plan.b
        lam = torch.from_numpy(rng.gamma(1.0, 1.0, (k, v)).astype(np.float32)).to(dev)
        flat = torch.from_numpy(t_ids).to(dev).reshape(-1).long()
        eb = torch.exp(torch.digamma(lam[:, flat])
                       - torch.digamma(lam.sum(1))[:, None]).contiguous()
        args = (eb, torch.from_numpy(t_cts).to(dev),
                torch.from_numpy(t_seg).to(dev),
                torch.full((k,), 1.0 / k, device=dev),
                torch.from_numpy(rng.gamma(100.0, 0.01, (k, len(t_ids) * d))
                                 .astype(np.float32)).to(dev))
        iters, case = tiles_case(torch, packed, args, d, label, t_doc, b,
                                 max_inner)
        if uniform:
            # all-pad tiles: the first iteration sets their slots to
            # alpha, the second sees no change
            all_pad = torch.from_numpy(t_doc[:, 0] == b)
            case["all_pad_tiles"] = int(all_pad.sum())
            case["all_pad_tile_iterations"] = sorted(
                set(iters[all_pad.to(iters.device)].tolist()))
            if not (case["all_pad_tiles"] and d > 128 and
                    case["all_pad_tile_iterations"] == [2]):
                raise AssertionError(f"gamma_fixed_point_tiles, uniform "
                                     f"plan: {case}")
        cases.append(case)
    return cases


def fit_launches(torch, rows, seed):
    """Every tile-kernel launch of one online fit (config C) on the card:
    its inputs (eb, cts, seg, alpha, gamma0) and output, recorded around
    the fit's call of the kernel (one launch an iteration), and the
    estimator (its ``tile_pick``)."""
    from spark_text_clustering_tpu_torch import OnlineLDA
    from spark_text_clustering_tpu_torch.models import online_lda

    opt = OnlineLDA(online_params(seed))
    with recorded(online_lda, "gamma_fixed_point_tiles") as seen:
        opt.fit(rows, [f"h{i}" for i in range(NG_V)])
    return [(args[:5], out) for args, out in seen], opt


def check_tiles(torch, rows, dev, rng, seed):
    """The tile kernel on two minibatches of config C: iteration 5's, with
    eb from lambda after five iterations on the card and random gamma
    inits, and the fit's heaviest launch (most inner iterations in its
    slowest tile) as the fit ran it.  Every launch of one fit is held
    against the plain version; the gate is asked on the card."""
    from spark_text_clustering_tpu_torch import OnlineLDA
    from spark_text_clustering_tpu_torch.ops import _build, packed

    k, v, n = NG_K, NG_V, len(rows)
    warm = 5
    opt = OnlineLDA(online_params(seed, warm))
    lam = opt.fit(rows, [f"h{i}" for i in range(v)]).lam
    lam = torch.from_numpy(lam).to(dev)
    plan = packed.plan_corpus_tiles(*flat_rows(rows), k=k)
    pick = opt.tile_pick(warm)[0]
    d, tb = plan.d, len(pick)
    ids = torch.from_numpy(plan.ids[pick]).to(dev)
    cts = torch.from_numpy(plan.cts[pick]).to(dev)
    seg = torch.from_numpy(plan.seg[pick]).to(dev)
    flat = ids.reshape(-1).long()
    eb = torch.exp(torch.digamma(lam[:, flat].clamp(min=1e-30))
                   - torch.digamma(lam.sum(1))[:, None]).contiguous()
    alpha = torch.full((k,), 1.0 / k, device=dev)
    g0 = torch.from_numpy(
        rng.gamma(100.0, 0.01, (k, tb * d)).astype(np.float32)).to(dev)
    args = (eb, cts, seg, alpha, g0)

    # the gate: the main path's state fits shared memory; a d or k past
    # shared memory keeps it in the global scratch instead of refusing
    lib = _build.load_library("packed")
    gate = {}
    for kk, dd, t in ((k, d, plan.tt), (k, 2048, 512), (200, 128, 512)):
        w = packed.tile_warps(t)
        gate[f"k{kk}_d{dd}_tt{t}"] = {
            "smem": lib.stc_tiles_smem_bytes(kk, dd, t, w),
            "scratch_floats": lib.stc_tiles_scratch_floats(kk, dd, t, w)}
    main_gate = gate[f"k{k}_d{d}_tt{plan.tt}"]
    if not (main_gate["smem"] > 0 and main_gate["scratch_floats"] == 0
            and all(g["smem"] > 0 and g["scratch_floats"] > 0
                    for key, g in gate.items() if g is not main_gate)):
        raise AssertionError(f"tile kernel gate on the card: {gate}")

    iters, main = tiles_case(torch, packed, args, d, "iteration_5",
                                  plan.doc_ids[pick], n)
    live_slots = int((plan.doc_ids[pick] < n).sum())
    t_bytes, by = tiles_bound(torch, args, d, iters, live_slots)

    # every launch of one fit, held against the plain version; the
    # heaviest becomes the second timed case
    launches, fit_opt = fit_launches(torch, rows, seed)
    fit_iters, fit_err = [], 0.0
    for largs, lout in launches:
        want, it = packed.gamma_fixed_point_tiles_plain(*largs, d,
                                                        with_iters=True)
        wn = want / want.sum(0, keepdim=True)
        fit_err = max(fit_err, float(
            (lout / lout.sum(0, keepdim=True) - wn).abs().max()))
        fit_iters.append((int(it.max()), float(it.to(torch.float64).mean())))
    heavy_at = max(range(len(fit_iters)), key=lambda i: fit_iters[i])
    if not fit_err <= 5e-3:
        raise AssertionError(f"gamma_fixed_point_tiles differs from its plain "
                             f"version by {fit_err} in the fit's launches")
    hargs = launches[heavy_at][0]
    hdocs = plan.doc_ids[fit_opt.tile_pick(heavy_at)[0]]
    hiters, heavy = tiles_case(torch, packed, hargs, d,
                                  f"fit_launch_{heavy_at}", hdocs, n)
    heavy.update(
        launch=heavy_at,
        ms=cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles(*hargs, d), 20),
        graph_ms=cuda_graph_ms(
            torch, lambda: packed.gamma_fixed_point_tiles(*hargs, d), 20),
        plain_ms=cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles_plain(
            *hargs, d), 2),
        bound_ms=tiles_bound(torch, hargs, d, hiters,
                             int((hdocs < n).sum()))[0])
    del launches

    edges = check_tiles_edges(torch, dev, np.random.default_rng(seed + 5), seed)
    work = [packed.tile_work(row, d, packed.tile_warps(plan.tt))
            for row in plan.seg[pick]]
    return {
        "name": "gamma_fixed_point_tiles", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/packed.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_packed.py:456",
        "shape": {"k": k, "tiles": tb, "tt": plan.tt, "d": d,
                  "live_tokens": int((seg < d).sum()),
                  "live_slots": live_slots,
                  "warps": packed.tile_warps(plan.tt),
                  "tokens_per_warp_max": max(w.tokens_per_warp for w in work),
                  "pieces_max": max(len(w.pieces) for w in work)},
        "tile_iterations_max": main["tile_iterations_max"],
        "tile_iterations_mean": main["tile_iterations_mean"],
        "max_abs_err": max([main["max_abs_err"], heavy["max_abs_err"],
                            fit_err] + [e["max_abs_err"] for e in edges]),
        "main_max_abs_err": main["max_abs_err"],
        "max_rel_err": main["max_rel_err"],
        "tolerance": "normalized gamma atol 5e-3; pad slots exactly alpha",
        "bitwise_repeatable": True, "gate": gate,
        "ms": cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles(*args, d), 20),
        "graph_ms": cuda_graph_ms(
            torch, lambda: packed.gamma_fixed_point_tiles(*args, d), 50),
        "plain_ms": cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles_plain(
            *args, d), 3),
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
        "heavy": heavy,
        "fit_launches": {
            "launches": len(fit_iters), "max_abs_err": fit_err,
            "tile_iterations_max": [m for m, _ in fit_iters],
            "tile_iterations_mean": [round(a, 2) for _, a in fit_iters],
            "mean_of_max": float(np.mean([m for m, _ in fit_iters]))},
        "geometries": edges,
    }


def nmf_params(seed: int, iters=None):
    """Config D: bench.py's NMF row (k=20, 40 sweeps, auto layout)."""
    from spark_text_clustering_tpu_torch import Params

    return Params(k=NG_K, algorithm="nmf",
                  max_iterations=NMF_ITERS if iters is None else iters,
                  seed=seed)


def nmf_kernel_case(torch, rows, k, dev, w_doc, h):
    """The NMF kernel's inputs for one sweep over ``rows``' tile plan from
    doc-ordered W ``w_doc`` and H ``h``; runs kernel and plain version
    and checks that pad tokens and token-less slots come out exactly 0."""
    from spark_text_clustering_tpu_torch.models.nmf import docs_w_to_tiles
    from spark_text_clustering_tpu_torch.ops import nmf, packed

    plan = packed.plan_corpus_tiles(*flat_rows(rows), k=k)
    d, n_tiles = plan.d, plan.ids.shape[0]
    ids, cts, seg = (torch.from_numpy(a).to(dev)
                     for a in (plan.ids, plan.cts, plan.seg))
    args = (h.index_select(1, ids.reshape(-1).long()).contiguous(), cts, seg,
            docs_w_to_tiles(w_doc, plan.doc_ids), h @ h.T)
    got = nmf.nmf_mu_update_tiles(*args, d)
    want = nmf.nmf_mu_update_tiles_plain(*args, d)
    torch.cuda.synchronize()
    err = rel = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g - w).abs().max()))
        rel = max(rel, float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()))
        if not torch.allclose(g, w, rtol=1e-4, atol=1e-8):
            raise AssertionError(
                f"nmf_mu_update_tiles differs from its plain version by {err} "
                f"at k={k}, d={d}, tt={plan.tt}")
    live = seg < d
    tile = torch.arange(n_tiles, device=dev)[:, None]
    reached = torch.zeros(n_tiles * d, dtype=torch.bool, device=dev)
    reached[(tile * d + seg.long())[live]] = True
    if got[1][~live.reshape(-1)].any() or got[0][~reached].any():
        raise AssertionError("nmf_mu_update_tiles: a pad token or a slot no "
                             "token reaches is not exactly 0")
    return plan, args, got, err, rel


def nmf_geometry_rows(seed: int, n: int = 3000, v: int = 4096):
    """Docs whose tokens are mostly zero-weight: one in eight has 1-3
    live tokens, so the planner packs its widest doc axis (2,048 slots at
    tt=512) and most slots are reached by no token."""
    rng = np.random.default_rng(seed)
    rows = []
    for doc in range(n):
        nnz = int(rng.integers(1, 4))
        ids = np.sort(rng.choice(v, size=nnz, replace=False)).astype(np.int32)
        live = doc % 8 == 0
        rows.append((ids, (rng.integers(1, 5, nnz) * live).astype(np.float32)))
    return rows


def nmf_placement(lib, k, d, tt):
    """Where the NMF kernel keeps a tile's piece table, slab and w_new at
    (k, d, tt): "shared" memory, or the "scratch" buffer in device memory;
    whether H H^T is cached in shared memory; and how many CTAs an SM
    holds (the card's occupancy calculator)."""
    from spark_text_clustering_tpu_torch.ops import packed

    warps = packed.tile_warps(tt)
    smem = lib.stc_nmf_smem_bytes(k, d, tt, warps)
    scratch = lib.stc_nmf_scratch_floats(k, d, tt, warps)
    per_sm = lib.stc_nmf_blocks_per_sm(k, d, tt, warps)
    if smem <= 0 or per_sm <= 0:
        raise AssertionError(f"the NMF kernel refuses k={k}, d={d}, tt={tt}: "
                             f"smem {smem}, CTAs an SM {per_sm}")
    return {"placement": "scratch" if scratch else "shared",
            "smem_bytes": smem, "scratch_floats_per_tile": scratch,
            "hht_in_smem": smem >= 4 * k * k, "ctas_per_sm": per_sm}


def ptxas_report(name):
    """Registers, stack and spills of each kernel instance in
    ``csrc/<name>.cu``, from the compiler's ``-Xptxas -v`` report kept
    beside the built library: {mangled name: {...}}."""
    import re

    from spark_text_clustering_tpu_torch.ops import _build

    log = _build._lib_path(name).with_suffix(".log")
    out, cur = {}, None
    for line in log.read_text().splitlines() if log.exists() else ():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    if not out:
        raise AssertionError(f"no ptxas report for {name}.cu at {log}")
    return out


def check_nmf(torch, rows, dev, seed):
    """The NMF kernel on config D's first sweep (the tile plan, and W and H
    as the fit draws them), and on geometries the planner allows beyond
    it: d=2048 at k=20, and k=200 and k=300 (H H^T past shared memory),
    all three with the piece table in the scratch buffer, and D's tiles
    at k=33 (vals a word at a time, not as float4).  Times the
    kernel by CUDA events, by graph replay and by host enqueue, and the
    sweep's H-side ``index_add_`` of the kernel's vals beside it."""
    from spark_text_clustering_tpu_torch import NMF
    from spark_text_clustering_tpu_torch.models.nmf import _scatter_vocab
    from spark_text_clustering_tpu_torch.ops import _build, nmf

    k, v, n = NG_K, NG_V, len(rows)
    weight_sum = float(sum(w.sum() for _, w in rows))
    w_doc, h = NMF(nmf_params(seed))._init(n, k, v, weight_sum)
    plan, args, got, err, rel = nmf_kernel_case(torch, rows, k, dev, w_doc, h)
    again = nmf.nmf_mu_update_tiles(*args, plan.d)
    deterministic = all(torch.equal(a, b) for a, b in zip(got, again))
    if not deterministic:
        raise AssertionError("nmf_mu_update_tiles does not repeat bit for bit")
    lib = _build.load_library("nmf")
    placement = nmf_placement(lib, k, plan.d, plan.tt)
    if placement["placement"] != "shared":
        raise AssertionError(f"config D's NMF tiles left shared memory: "
                             f"{placement}")

    geo_rows = nmf_geometry_rows(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    geometries = []
    for kk in (20, 200, 300):
        gh = torch.rand((kk, 4096), generator=gen, device=dev) + 0.1
        gw = torch.rand((len(geo_rows), kk), generator=gen, device=dev) + 0.1
        gplan, gargs, gout, gerr, grel = nmf_kernel_case(
            torch, geo_rows, kk, dev, gw, gh)
        gagain = nmf.nmf_mu_update_tiles(*gargs, gplan.d)
        if not all(torch.equal(a, b) for a, b in zip(gout, gagain)):
            raise AssertionError(f"nmf_mu_update_tiles does not repeat bit "
                                 f"for bit at k={kk}, d={gplan.d}")
        geometries.append({"k": kk, "d": gplan.d, "tt": gplan.tt,
                           "tiles": int(gplan.ids.shape[0]),
                           "max_abs_err": gerr, "max_rel_err": grel,
                           **nmf_placement(lib, kk, gplan.d, gplan.tt)})
    if geometries[0]["d"] != 2048 or any(
        g["placement"] != "scratch" for g in geometries
    ):
        raise AssertionError(f"geometry rows planned {geometries}")
    # D's tiles at k=33: the shared layout with k % 4 != 0, where vals go
    # out a word at a time rather than as float4
    kk = 33
    sh = torch.rand((kk, v), generator=gen, device=dev) + 0.1
    sw = torch.rand((n, kk), generator=gen, device=dev) + 0.1
    splan, sargs, sout, serr, srel = nmf_kernel_case(torch, rows, kk, dev,
                                                     sw, sh)
    sagain = nmf.nmf_mu_update_tiles(*sargs, splan.d)
    if not all(torch.equal(a, b) for a, b in zip(sout, sagain)):
        raise AssertionError("nmf_mu_update_tiles does not repeat bit for "
                             "bit at k=33")
    geometries.append({"k": kk, "d": splan.d, "tt": splan.tt,
                       "tiles": int(splan.ids.shape[0]),
                       "max_abs_err": serr, "max_rel_err": srel,
                       **nmf_placement(lib, kk, splan.d, splan.tt)})
    if geometries[-1]["placement"] != "shared":
        raise AssertionError(f"D's tiles at k=33 planned {geometries[-1]}")

    # bytes the kernel needs: hg's k values, cts and seg of live tokens,
    # their k vals written; W read and written for live slots; H H^T.
    # Operations: per live token k products and k scan adds, per live
    # slot the k x k denominator and the update.
    live_tok = int((plan.seg < plan.d).sum())
    live_slots = int((plan.doc_ids < n).sum())
    flat_ids = args[0].new_tensor(plan.ids.reshape(-1), dtype=torch.long)
    t_bytes, by = bound(*nmf.cost(*args, plan.d, live_tokens=live_tok,
                                  live_slots=live_slots))
    return {
        "name": "nmf_mu_update_tiles", "route": "cuda",
        "source": "spark_text_clustering_tpu_torch/csrc/nmf.cu",
        "replaces": "spark_text_clustering_tpu/ops/pallas_nmf.py:118",
        "shape": {"k": k, "tiles": int(plan.ids.shape[0]), "tt": plan.tt,
                  "d": plan.d, "live_tokens": live_tok,
                  "live_slots": live_slots},
        "max_abs_err": max([err] + [g["max_abs_err"] for g in geometries]),
        "main_max_abs_err": err, "max_rel_err": rel,
        "tolerance": "rtol 1e-4, atol 1e-8; pad tokens and slots no token "
                     "reaches exactly 0",
        "bitwise_repeatable": deterministic, **placement,
        "ptxas": ptxas_report("nmf"), "geometries": geometries,
        "ms": cuda_ms(torch, lambda: nmf.nmf_mu_update_tiles(
            *args, plan.d), 50),
        "graph_ms": cuda_graph_ms(torch, lambda: nmf.nmf_mu_update_tiles(
            *args, plan.d), 100),
        "host_ms": host_ms(torch, lambda: nmf.nmf_mu_update_tiles(
            *args, plan.d), 50),
        "plain_ms": cuda_ms(torch, lambda: nmf.nmf_mu_update_tiles_plain(
            *args, plan.d), 5),
        "bound_ms": t_bytes, "bound_by": by, "library_ms": None,
        # the same sweep's H side: the kernel's vals added into [V, k]
        "h_index_add_ms": cuda_ms(torch, lambda: _scatter_vocab(
            flat_ids, got[1], v), 50),
        "h_index_add_graph_ms": cuda_graph_ms(torch, lambda: _scatter_vocab(
            flat_ids, got[1], v), 100),
    }


# ---- phases 3 and 4: the main path ----------------------------------------
def check_distribution(dist, n, k, label):
    if dist.shape != (n, k) or not np.isfinite(dist).all():
        raise AssertionError(f"{label}: bad topic distribution {dist.shape}")
    if not np.allclose(dist.sum(1), 1.0, atol=1e-4):
        raise AssertionError(f"{label}: distributions do not sum to 1")


def run_config(torch, label, rows, vocab, k, seed, workdir,
               resume_state=None):
    """IDF -> EM fit -> save -> load -> padded scoring -> report, on the
    card, through the library's entry points.  Returns the summary and
    what the CPU re-run needs."""
    from spark_text_clustering_tpu_torch import (
        IDF, LDA, Params, load_model,
    )
    from spark_text_clustering_tpu_torch.interop import em_state_from_numpy
    from spark_text_clustering_tpu_torch.models.persistence import model_dir_name
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.utils.report import (
        format_scoring_report,
    )

    ds = {"rows": rows, "vocab": vocab}
    _build.reset_launches()
    t0 = time.perf_counter()
    idf = IDF(min_doc_freq=2, idf_floor=1e-4).fit(ds)
    tfidf = idf.transform(ds)
    t_idf = time.perf_counter() - t0
    ckpt = None
    if resume_state is not None:
        ckpt = os.path.join(workdir, f"{label}_ckpt_cuda")
        em_state_from_numpy(ckpt, *resume_state(tfidf["rows"]), step=0)
    params = Params(k=k, max_iterations=SWEEPS, seed=seed,
                    checkpoint_dir=ckpt, checkpoint_interval=10 * SWEEPS)
    t0 = time.perf_counter()
    fitted = LDA(params).fit(tfidf)
    t_fit = time.perf_counter() - t0
    model = fitted.model
    path = model_dir_name(label, os.path.join(workdir, "models"))
    model.save(path)
    loaded = load_model(path)
    t0 = time.perf_counter()
    dist = loaded.topic_distribution(tfidf["rows"], layout="padded")
    torch.cuda.synchronize()
    t_score = time.perf_counter() - t0
    report = format_scoring_report(
        loaded, [f"doc{i}" for i in range(len(rows))], dist, tfidf["rows"])
    launches = dict(_build.LAUNCHES)
    check_distribution(dist, len(rows), k, label)
    n = fitted.corpus_size
    summary = {
        "phase": f"config_{label}", "docs": len(rows), "vocab": len(vocab),
        "k": k, "sweeps": SWEEPS,
        "tokens": int(sum(len(i) for i, _ in rows)),
        "idf_s": t_idf, "fit_s": t_fit,
        "fit_ms_per_sweep": 1e3 * float(np.mean(model.iteration_times)),
        "avg_log_likelihood": fitted.log_likelihood / n,
        "argmax_histogram": np.bincount(dist.argmax(1), minlength=k).tolist(),
        "score_s": t_score, "report_bytes": len(report.encode()),
        # the sweep the fit ran, read from its launches
        "last_sweep": ("fused" if launches["em_sweep_fused"] else
                       "two_stage" if launches["scatter_add_vtiles"] else
                       "none"),
        "launches": launches,
    }
    return summary, tfidf, ckpt, model


def run_config_c(torch, rows, seed, workdir):
    """Online VB on the card: a warm-up fit, then the timed fit -> save ->
    load -> log-perplexity of the first EVAL_DOCS docs, through the
    library's entry points; then ten iterations on the card against the
    same ten with device="cpu" and the card's rule, from the same lambda
    and gamma draws."""
    from spark_text_clustering_tpu_torch import OnlineLDA, load_model
    from spark_text_clustering_tpu_torch.models.persistence import model_dir_name
    from spark_text_clustering_tpu_torch.ops import _build

    vocab = [f"h{i}" for i in range(NG_V)]
    eval_rows = rows[:EVAL_DOCS]
    opt = OnlineLDA(online_params(seed))
    opt.fit(rows, vocab)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    model = opt.fit(rows, vocab)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    path = model_dir_name("C", os.path.join(workdir, "models"))
    model.save(path)
    loaded = load_model(path)
    t0 = time.perf_counter()
    log_perp = loaded.log_perplexity(eval_rows)
    t_eval = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    if not np.isfinite(log_perp) or model.lam.shape != (NG_K, NG_V) or (
        not np.isfinite(model.lam).all() or not (model.lam > 0).all()
    ):
        raise AssertionError(f"config C: bad model (logPerp {log_perp})")
    for name in ("gamma_fixed_point_tiles", "gamma_fixed_point_bkl"):
        if launches[name] == 0:
            raise AssertionError(f"config C skipped a kernel: {launches}")

    # card vs CPU: the CPU fit draws lambda and gamma on the card's
    # generators, so both runs start from the same numbers, and takes the
    # card's decisions (rule="card": the same tiles path, the plain
    # version of the kernel)
    m = ONLINE_CHECK_ITERS
    card_opt = OnlineLDA(online_params(seed, m))
    card = card_opt.fit(rows, vocab)
    cpu_opt = OnlineLDA(online_params(seed, m), device="cpu",
                        rng_device="cuda", rule="card")
    t0 = time.perf_counter()
    cpu = cpu_opt.fit(rows, vocab)
    t_cpu = time.perf_counter() - t0
    if not card_opt.last_layout == cpu_opt.last_layout == "tiles_resident":
        raise AssertionError(f"config C: card {card_opt.last_layout}, CPU "
                             f"{cpu_opt.last_layout}")
    lam_rel = float(np.max(np.abs(card.lam - cpu.lam) / np.abs(cpu.lam)))
    lp_card = card.log_perplexity(eval_rows)
    lp_cpu = cpu.log_perplexity(eval_rows, device="cpu")
    lp_rel = abs(lp_card - lp_cpu) / abs(lp_cpu)
    summary = {
        "phase": "config_C", "docs": len(rows), "vocab": NG_V, "k": NG_K,
        "iterations": ONLINE_ITERS, "sampling": "epoch",
        "tokens": int(sum(len(i) for i, _ in rows)),
        "batch_size": opt.last_batch_size, "tiles": opt.last_tiles,
        "fit_s": t_fit, "ms_per_iteration": 1e3 * t_fit / ONLINE_ITERS,
        "docs_per_s": ONLINE_ITERS * opt.last_batch_size / t_fit,
        "log_perplexity": log_perp, "eval_docs": len(eval_rows),
        "eval_s": t_eval, "launches": launches,
        "check_iterations": m, "lam_max_rel_diff": lam_rel,
        "log_perplexity_card": lp_card, "log_perplexity_cpu": lp_cpu,
        "log_perplexity_rel_diff": lp_rel, "cpu_fit_s": t_cpu,
        "bounds": {"lam_max_rel_diff": 1e-3, "log_perplexity_rel_diff": 1e-4},
    }
    if not lam_rel <= 1e-3 or not lp_rel <= 1e-4:
        raise AssertionError(
            f"config C: card vs CPU lambda rel {lam_rel}, logPerp rel {lp_rel}")
    return summary


def run_config_d(torch, rows, seed, workdir):
    """NMF on the card: a warm-up fit, then the timed fit -> save -> load
    -> topic_distribution of the first EVAL_DOCS docs, through the
    library's entry points; then ten sweeps on the card against the same
    ten with device="cpu", from the same W0/H0."""
    from spark_text_clustering_tpu_torch import NMF, load_model
    from spark_text_clustering_tpu_torch.models.persistence import model_dir_name
    from spark_text_clustering_tpu_torch.ops import _build

    vocab = [f"h{i}" for i in range(NG_V)]
    eval_rows = rows[:EVAL_DOCS]
    opt = NMF(nmf_params(seed))
    opt.fit(rows, vocab)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    model = opt.fit(rows, vocab)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    path = model_dir_name("D", os.path.join(workdir, "models"))
    model.save(path)
    loaded = load_model(path)
    t0 = time.perf_counter()
    dist = loaded.topic_distribution(eval_rows)
    t_eval = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check_distribution(dist, len(eval_rows), NG_K, "config D")
    if model.h.shape != (NG_K, NG_V) or not np.isfinite(model.h).all() or (
        (model.h < 0).any() or not np.isfinite(model.loss)
    ):
        raise AssertionError(f"config D: bad model (loss {model.loss})")
    if opt.last_mu_backend != "cuda_tiles" or (
        launches["nmf_mu_update_tiles"] != NMF_ITERS
    ):
        raise AssertionError(f"config D skipped the kernel: "
                             f"{opt.last_mu_backend}, {launches}")

    # card vs CPU: the CPU fit draws W0/H0 on the card's generator, so
    # both runs start from the same numbers.  H is compared relative to
    # each entry, floored at 1e-6 of the largest (a term seen by no doc
    # goes to exactly 0 on both)
    m = NMF_CHECK_ITERS
    card = NMF(nmf_params(seed, m)).fit(rows, vocab)
    t0 = time.perf_counter()
    cpu = NMF(nmf_params(seed, m), device="cpu", rng_device="cuda").fit(
        rows, vocab)
    t_cpu = time.perf_counter() - t0
    floor = 1e-6 * float(np.abs(cpu.h).max())
    h_rel = float(np.max(np.abs(card.h - cpu.h)
                         / np.maximum(np.abs(cpu.h), floor)))
    loss_rel = abs(card.loss - cpu.loss) / abs(cpu.loss)
    summary = {
        "phase": "config_D", "docs": len(rows), "vocab": NG_V, "k": NG_K,
        "sweeps": NMF_ITERS, "tokens": int(sum(len(i) for i, _ in rows)),
        "layout": opt.last_layout, "mu_backend": opt.last_mu_backend,
        "cells": opt.last_cells, "tiles": opt.last_tiles,
        "fit_s": t_fit,
        "fit_ms_per_sweep": 1e3 * float(np.mean(model.iteration_times)),
        "docs_per_s": NMF_ITERS * len(rows) / t_fit,
        "loss": model.loss, "frobenius_err": float(np.sqrt(model.loss)),
        "eval_docs": len(eval_rows), "eval_s": t_eval,
        "argmax_histogram": np.bincount(dist.argmax(1), minlength=NG_K).tolist(),
        "launches": launches,
        "check_sweeps": m, "h_max_rel_diff": h_rel,
        "loss_card": card.loss, "loss_cpu": cpu.loss,
        "loss_rel_diff": loss_rel, "cpu_fit_s": t_cpu,
        "bounds": {"h_max_rel_diff": 1e-3, "loss_rel_diff": 1e-4},
    }
    if not h_rel <= 1e-3 or not loss_rel <= 1e-4:
        raise AssertionError(
            f"config D: card vs CPU H rel {h_rel}, loss rel {loss_rel}")
    return summary


def report_distributions(text: str, k: int) -> np.ndarray:
    """[books, k] topic distributions read back from a scoring report."""
    vals = [float(line.rsplit("|", 1)[1]) for line in text.splitlines()
            if line.startswith("Nr.: ")]
    return np.asarray(vals, np.float64).reshape(-1, k)


_POOL_RANK = """
import contextlib, json, os, sys
reply = os.fdopen(os.dup(1), "w")
os.dup2(os.open(os.devnull, os.O_WRONLY), 1)   # the replies' pipe alone
from spark_text_clustering_tpu_torch import cli
from spark_text_clustering_tpu_torch.ops import _build
rank, size = sys.argv[1], sys.argv[2]
for line in sys.stdin:
    cmd = json.loads(line)
    _build.reset_launches()
    with open(cmd["out"] if rank == "0" else os.devnull, "w") as f, \\
            contextlib.redirect_stdout(f):
        rc = cli.main(cmd["argv"] + ["--coordinator", cmd["rdv"],
                                     "--num-processes", size,
                                     "--process-id", rank])
    reply.write(json.dumps({"rc": rc, "launches": _build.LAUNCHES}) + "\\n")
    reply.flush()
"""


class GridPool:
    """``size`` processes of the port's CLI that stay up between commands:
    each command runs as rank i of a ``--coordinator`` world of ``size``
    (a ``file://`` rendezvous of its own), so a run of grid commands pays
    one start-up of Python, torch and the CUDA context, not one a
    command.  Rank 0's stdout is the command's; each rank's stderr goes
    to ``<root>/rank<i>.err``."""

    def __init__(self, size, root, timeout=600.0):
        here = os.path.dirname(os.path.abspath(__file__))
        env = {k: v for k, v in os.environ.items()
               if k not in ("STC_FAULTS", "STC_FAULT_SEED")}
        env["PYTHONPATH"] = os.pathsep.join(
            [here] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep)
                      if q])
        os.makedirs(root)
        self.root, self.timeout, self.commands = root, timeout, 0
        self.procs = []
        for r in range(size):
            with open(os.path.join(root, f"rank{r}.err"), "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _POOL_RANK, str(r), str(size)],
                    cwd=here, env=env, stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=err, text=True))

    def run(self, argv, out_path):
        """``argv`` on every rank: (the worst exit code, the kernel
        launches summed over the ranks)."""
        import select

        rdv = "file://" + os.path.join(self.root, f"rdv{self.commands}")
        self.commands += 1
        for p in self.procs:
            p.stdin.write(json.dumps({"argv": argv, "out": out_path,
                                      "rdv": rdv}) + "\n")
            p.stdin.flush()
        deadline = time.monotonic() + self.timeout
        replies = []
        for r, p in enumerate(self.procs):
            ready = select.select([p.stdout], [], [], max(
                0.0, deadline - time.monotonic()))[0]
            line = p.stdout.readline() if ready else ""
            if not line:
                with open(os.path.join(self.root, f"rank{r}.err")) as f:
                    raise AssertionError(f"grid pool rank {r} on {argv[0]}:"
                                         f" exit {p.poll()}: "
                                         f"{f.read()[-2000:]}")
            replies.append(json.loads(line))
        launches = {}
        for reply in replies:
            for name, count in reply["launches"].items():
                launches[name] = launches.get(name, 0) + count
        return max(reply["rc"] for reply in replies), launches

    def close(self):
        for p in self.procs:
            with contextlib.suppress(OSError):
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


@contextlib.contextmanager
def grid_pool(size, root):
    """A ``GridPool`` for the block, closed (its ranks ended) after it."""
    pool = GridPool(size, root)
    try:
        yield pool
    finally:
        pool.close()


def run_cli(argv, out_path, launches=None, pool=None):
    """``cli.main(argv)`` in this process, its stdout sent to
    ``out_path``; returns (exit code, stdout text, wall seconds).  With
    ``pool`` (a ``GridPool``) it runs on the pool's ranks instead, and
    their kernel launches are added to ``launches``."""
    t0 = time.perf_counter()
    if pool is not None:
        rc, counted = pool.run(argv, out_path)
        for name, count in counted.items():
            launches[name] = launches.get(name, 0) + count
    else:
        from spark_text_clustering_tpu_torch import cli

        with open(out_path, "w") as f, contextlib.redirect_stdout(f):
            rc = cli.main(argv)
    secs = time.perf_counter() - t0
    with open(out_path) as f:
        return rc, f.read(), secs


def telemetry_stream(path):
    """(manifest, events, final registry snapshot) of a port run stream,
    read with the port's own reader; fails unless the stream starts with
    its manifest and ends with the registry."""
    from spark_text_clustering_tpu_torch.telemetry import read_events

    events = read_events(path)
    if not events or events[0]["event"] != "manifest" or (
            events[-1]["event"] != "registry"):
        ends = [e["event"] for e in events[:1] + events[-1:]]
        raise AssertionError(f"telemetry stream {path}: {ends}")
    return events[0], events[1:-1], events[-1]["snapshot"]


_DIGEST_NAME = re.compile(r"^(dispatch|mem|compile)\.[0-9a-f]{10}\.")
# the dispatch layer's names a call carries only where it launched a
# kernel (none on the CPU, whose wrappers run their plain versions), and
# the gauge only a process's first instrumented stream carries
_KERNEL_ONLY = re.compile(r"^dispatch\.<digest>\.(est_|device_.*_total$|"
                          r"launches\.)|^mem\.<digest>\.code_bytes$|"
                          r"^compile\.time_to_first_dispatch_seconds$")


def stream_names(events, snapshot):
    """The event types and registry names of a stream, digests masked,
    less the device memory families a CPU run cannot report and the
    dispatch names of kernel launches (``_KERNEL_ONLY``)."""
    names = {f"event:{e['event']}" for e in events}
    for kind in ("counters", "gauges", "histograms"):
        names |= {f"{kind}:" + _DIGEST_NAME.sub(r"\1.<digest>.", n)
                  for n in snapshot[kind]}
    return {n for n in names if not (
        n.split(":", 1)[1].startswith("mem.device.")
        or n.endswith(":mem.device_stats_unavailable")
        or _KERNEL_ONLY.match(n.split(":", 1)[1]))}


def port_metrics(argv):
    """``metrics <argv>`` through the port's CLI in this process: (exit
    code, stdout)."""
    from spark_text_clustering_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["metrics", *argv])
    return rc, out.getvalue()


def attributed_launches(summary):
    """{kernel: launches} summed over a stream's digests, from ``metrics
    summarize --json``'s metrics."""
    out = {}
    for name, value in summary["metrics"].items():
        m = re.match(r"^counter\.dispatch\.[0-9a-f]{10}\.launches\.(\w+)$",
                     name)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + int(value)
    return out


def dispatch_attribution(label, paths, launches, baseline):
    """The card streams ``paths`` of one command each, read by the port's
    ``metrics summarize --json``, ``roofline --json`` and
    ``compile-check``: every hand-written kernel launch of each command
    attributed to a call (per kernel, the launches summed over its digests
    equal ``launches[i]``, the wrappers' counts over that command), the
    ``nvidia-h100`` peaks, every call that launched a kernel joined with a
    roofline fraction in (0, 1.05] and every other call with no cost, and
    the labels' signatures within ``baseline`` ({label: count})."""
    rows, per_path = [], []
    for path, counts in zip(paths, launches):
        rc1, summ = port_metrics(["summarize", path, "--json"])
        rc2, roof = port_metrics(["roofline", path, "--json"])
        summ, roof = json.loads(summ), json.loads(roof)
        seen = attributed_launches(summ)
        want = {k: v for k, v in counts.items() if v}
        bad = [r for r in roof["rows"] if (
            r["cost_source"] == "kernels" and not (
                r["available"] and 0.0 < r["roofline_frac"] <= 1.05))
            or r["cost_source"] not in ("kernels", "none")]
        if rc1 or rc2 or seen != want or roof["peaks_key"] != "nvidia-h100" \
                or bad or not any(r["cost_source"] == "kernels"
                                  for r in roof["rows"]):
            raise AssertionError(
                f"config {label} dispatch attribution of {path}: launches "
                f"{seen} against {want}, peaks {roof['peaks_key']}, rows "
                f"outside (0, 1.05]: {bad}")
        per_path.append(seen)
        rows += [{key: r.get(key) for key in (
            "label", "calls", "warm_calls", "seconds", "est_bytes",
            "est_flops", "roofline_frac", "frac_peak_bytes", "bound",
            "cost_source", "mem_peak_bytes")} for r in roof["rows"]]
    base = os.path.join(os.path.dirname(paths[0]), "compile_baseline.json")
    with open(base, "w") as f:
        json.dump({"schema": 1, "labels": baseline}, f)
    rc, text = port_metrics(["compile-check", *paths, "--baseline", base])
    if rc != 0:
        raise AssertionError(f"config {label} compile-check: {text}")
    return {"rows": rows, "launches": per_path,
            "compile_check": text.strip().splitlines()[-1]}


def telemetry_overhead(torch, tfidf, ckpt, seed):
    """The disabled facade's cost on config A's in-process fit, by the JAX
    package's method (scripts/check_telemetry_overhead.py): the telemetry
    calls of one enabled fit (registry only; a dispatch counts one call of
    its ``dispatch.*.calls``) times each disabled primitive's seconds in a
    tight loop (the dispatch wrapper among them), against the fit's wall
    time (the median of three disabled fits).  Fails above 2%."""
    from spark_text_clustering_tpu_torch import LDA, Params, telemetry
    from spark_text_clustering_tpu_torch.telemetry import tracing, transport

    params = Params(k=EN_K, max_iterations=SWEEPS, seed=seed,
                    checkpoint_dir=ckpt, checkpoint_interval=10 * SWEEPS)

    def fit():
        t0 = time.perf_counter()
        model = LDA(params).fit(tfidf).model
        torch.cuda.synchronize()
        return time.perf_counter() - t0, 1e3 * float(
            np.mean(model.iteration_times))

    t_start = time.perf_counter()
    telemetry.shutdown()
    disabled = sorted(fit() for _ in range(3))
    fit_s, disabled_ms = disabled[1]
    telemetry.configure(None, device="cuda")
    try:
        enabled_s, enabled_ms = fit()
        snap = telemetry.get_registry().snapshot()
    finally:
        telemetry.shutdown()
    calls = (sum(snap["counters"].values()) + len(snap["gauges"])
             + sum(h["count"] for h in snap["histograms"].values()))
    if telemetry.enabled() or tracing.current() is not None or (
            transport.get_shipper() is not None):
        raise AssertionError("telemetry overhead: the facade is not off")
    x, rec, loop = torch.ones(1), {"event": "overhead.probe"}, 100_000
    probe = telemetry.instrument_dispatch("overhead.probe", lambda y: y)
    t0 = time.perf_counter()
    for _ in range(loop):
        with telemetry.span("overhead.probe"):
            pass
        telemetry.count("overhead.probe")
        telemetry.observe("overhead.probe", 0.0)
        telemetry.event("overhead.probe", seconds=0.0)
        telemetry.device_sync(x, "overhead")
        tracing.fields()
        transport.offer(rec)
        probe(x)
    per_call = (time.perf_counter() - t0) / (8 * loop)
    share = calls * per_call / fit_s
    if not share <= 0.02:
        raise AssertionError(f"telemetry overhead: {calls} calls x "
                             f"{per_call * 1e9:.0f} ns is {share:.4%} of "
                             f"the {fit_s * 1e3:.1f} ms fit")
    return {"phase": "telemetry_overhead", "config": "A", "sweeps": SWEEPS,
            "fit_s": fit_s, "enabled_fit_s": enabled_s,
            "disabled_ms_per_sweep": disabled_ms,
            "enabled_ms_per_sweep": enabled_ms,
            "calls_per_fit": calls, "disabled_ns_per_call": per_call * 1e9,
            "estimated_overhead_share": share, "budget": 0.02,
            "seconds": time.perf_counter() - t_start}


def cli_train(label, books, stop, device, models_dir, v, out_path,
              extra=(), launches=None, pool=None):
    """``train`` (k=EN_K, the defaults, plus ``extra``) on ``device``
    through ``cli.main`` (on a ``pool``'s ranks where one is given:
    ``run_cli``): (its console numbers and wall seconds, the one
    committed model dir it saved).  Fails unless it exits 0, saves one
    committed model, prints a finite average log-likelihood (EM) and the
    vocabulary size ``v`` (any, where ``v`` is None)."""
    from spark_text_clustering_tpu_torch.resilience import artifact_status

    rc, out, secs = run_cli(
        ["train", "--books", books, "--stop-words", stop, "--lang", "EN",
         "--k", str(EN_K), "--models-dir", models_dir, "--device", device,
         *extra], out_path, launches, pool)
    nums = {"train_s": secs}
    for line in out.splitlines():
        for key, text in (("preprocess_s", "Preprocessing time:"),
                          ("fit_s", "Training time:"),
                          ("avg_log_likelihood", "average log likelihood:"),
                          ("cli_vocab", "Vocabulary size:")):
            if text in line:
                nums[key] = float(line.split(text)[1].split()[0])
    saved = [d for d in os.listdir(models_dir) if d.startswith("LdaModel_EN_")
             and not d.endswith("_mllib")]
    if rc != 0 or len(saved) != 1 or artifact_status(
            os.path.join(models_dir, saved[0])) != "committed":
        raise AssertionError(f"config {label} train on {device}: rc {rc}, "
                             f"models {saved}")
    # online VB and NMF print no average log-likelihood (MLlib's EM
    # metric)
    if not {"online", "nmf"} & set(extra) and not np.isfinite(
            nums.get("avg_log_likelihood", np.nan)):
        raise AssertionError(f"config {label} train on {device}: average "
                             f"logLik {nums.get('avg_log_likelihood')}")
    if v is not None and nums["cli_vocab"] != v:
        raise AssertionError(f"config {label}: the CLI's V "
                             f"{nums['cli_vocab']} != {v}")
    del nums["cli_vocab"]
    return nums, os.path.join(models_dir, saved[0])


@contextlib.contextmanager
def em_fits():
    """Inside the block, each EM fit is recorded as (estimator, distinct
    terms of each doc it fit, V, padded cells): where the CLI's fit ran,
    and on what."""
    from spark_text_clustering_tpu_torch.models import em_lda

    fits, fit = [], em_lda.EMLDA.fit

    def spy(self, rows, vocab, *args, **kwargs):
        fits.append((self, [len(i) for i, _ in rows], len(vocab),
                     em_lda.em_padded_cells(rows,
                                            self.params.bucket_by_length)))
        return fit(self, rows, vocab, *args, **kwargs)

    em_lda.EMLDA.fit = spy
    try:
        yield fits
    finally:
        em_lda.EMLDA.fit = fit


@contextlib.contextmanager
def online_fits():
    """Inside the block, each online fit is recorded as (estimator, its
    rows): which path the CLI's fit took, and on what."""
    from spark_text_clustering_tpu_torch.models import online_lda

    fits, fit = [], online_lda.OnlineLDA.fit

    def spy(self, rows, vocab, *args, **kwargs):
        fits.append((self, rows))
        return fit(self, rows, vocab, *args, **kwargs)

    online_lda.OnlineLDA.fit = spy
    try:
        yield fits
    finally:
        online_lda.OnlineLDA.fit = fit


@contextlib.contextmanager
def recorded(module, name):
    """Inside the block, every call of ``module.name`` (a kernel wrapper as
    a fit's module sees it) is recorded as (args, output), cloned."""
    kernel, seen = getattr(module, name), []

    def record(*args):
        out = kernel(*args)
        seen.append((tuple(a.clone() if hasattr(a, "clone") else a
                           for a in args), out.clone()))
        return out

    setattr(module, name, record)
    try:
        yield seen
    finally:
        setattr(module, name, kernel)


def cli_score(label, books, stop, device, out_dir, out_path, model_args,
              extra=(), launches=None, pool=None):
    """``score`` on ``device`` through ``cli.main`` (on a ``pool``'s ranks
    where one is given: ``run_cli``) with ``model_args``
    (``--models-dir DIR`` or ``--model DIR``) and ``extra``: (the report's
    text, wall seconds).  Fails unless it exits 0 and writes one report."""
    rc, _, secs = run_cli(
        ["score", "--books", books, "--stop-words", stop, *model_args,
         "--output-dir", out_dir, "--device", device, *extra], out_path,
        launches, pool)
    written = os.listdir(out_dir) if os.path.isdir(out_dir) else []
    if rc != 0 or len(written) != 1:
        raise AssertionError(f"config {label} score on {device}: rc {rc}")
    with open(os.path.join(out_dir, written[0])) as f:
        return f.read(), secs


def distributions_agree(label, card_report, cpu_report, k=EN_K, books=None):
    """The card's report against the CPU's: (largest difference of the
    distributions, main-topic agreement, books whose CPU top two differ by
    more than 1e-2).  Fails beyond 5e-3, or where such a book's main topic
    differs.  ``books``: the CPU scored only these of the card's books,
    whose rows are compared."""
    card = report_distributions(card_report, k)
    cpu = report_distributions(cpu_report, k)
    if books is not None and card.shape == (EN_DOCS, k):
        card_d, cpu_d = (book_distributions(card_report, k),
                         book_distributions(cpu_report, k))
        if sorted(cpu_d) != sorted(books):
            raise AssertionError(f"config {label}: the CPU scored "
                                 f"{sorted(cpu_d)}, not {sorted(books)}")
        card = np.stack([card_d[b] for b in books])
        cpu = np.stack([cpu_d[b] for b in books])
    elif card.shape != (EN_DOCS, k) or cpu.shape != card.shape:
        raise AssertionError(f"config {label}: reports hold {card.shape}, "
                             f"{cpu.shape}")
    diff = float(np.abs(card - cpu).max())
    top2 = np.sort(cpu, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    agree = card.argmax(1) == cpu.argmax(1)
    if not diff <= 5e-3 or not agree[clear].all():
        raise AssertionError(f"config {label}: card vs CPU distributions "
                             f"differ by {diff}, main topics {agree.mean()}")
    return diff, float(agree.mean()), int(clear.sum())


def run_config_e(torch, seed, workdir):
    """The CLI on the card: a synthetic EN book directory -> ``train``
    (EM, k=5, 50 iterations, TF-IDF, the defaults) -> ``score``; then
    ``score --device cpu`` of the same model (the plain versions, packed),
    whose distributions must agree with the card's within 5e-3 and whose
    main topics must agree wherever its top two differ by more than
    1e-2."""
    from spark_text_clustering_tpu_torch import Params, load_model
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.pipeline import (
        IDF, CountVectorizer, TextPreprocessor,
    )
    from spark_text_clustering_tpu_torch.telemetry import dispatch
    from spark_text_clustering_tpu_torch.utils.readers import (
        read_stop_word_file, read_text_dir,
    )
    from spark_text_clustering_tpu_torch.utils.textproc import (
        parse_stop_words,
    )

    root = os.path.join(workdir, "E")
    t0 = time.perf_counter()
    stop = en_books_dir(seed, root)
    t_corpus = time.perf_counter() - t0
    books = os.path.join(root, "books")
    models = os.path.join(root, "models")

    # the corpus's shape and TF-IDF rows, through the stages the CLI's
    # train runs with its defaults
    pre = TextPreprocessor(stop_words=parse_stop_words(
        read_stop_word_file(stop)))
    texts = [d.text for d in read_text_dir(books)]
    t0 = time.perf_counter()
    ds = pre.transform({"texts": texts})
    t_pre = time.perf_counter() - t0
    defaults = Params()
    ds = CountVectorizer(defaults.vocab_size, num_workers=1).fit(
        ds).transform(ds)
    ds = IDF(min_doc_freq=defaults.min_doc_freq, idf_floor=defaults.idf_floor,
             device="cuda").fit(ds).transform(ds)
    tokens, tf_rows = ds["tokens"], ds["rows"]
    distinct = [len(set(t)) for t in tokens]
    v = len(ds["vocab"])
    if pre.last_backend != "native":
        raise AssertionError(f"config E: text backend {pre.last_backend}")
    if not 30_000 <= v <= 50_000 or min(distinct) < 2_000:
        raise AssertionError(f"config E: V={v}, distinct terms a book "
                             f"{min(distinct)}-{max(distinct)}")

    tel = os.path.join(root, "telemetry")

    def train(device, models_dir, extra=(), tag=""):
        """``train`` on ``device``: (its console numbers, saved model)."""
        nums, path = cli_train("E", books, stop, device, models_dir, v,
                               os.path.join(root, f"train_{device}{tag}.out"),
                               extra)
        return nums, load_model(path, device="cpu")

    _build.reset_launches()
    summary, card_model = train("cuda", models)
    train_launches = dict(_build.LAUNCHES)
    if train_launches["em_sweep_fused"] != SWEEPS:
        raise AssertionError(f"config E train: {train_launches}")

    # the sweep against its plain version on E's own TF-IDF rows (the
    # idf floor's 1e-4 weights included), from the fit's kind of start
    sweep_check = check_sweep_start(torch, tf_rows, EN_K, v,
                                    torch.device("cuda"), seed)
    # the whole train again on the CPU (the plain versions) from the same
    # seeded start: the average log-likelihoods must agree within 1e-4
    # (with --telemetry-file: the CPU stream the card's is held to, its
    # dispatch records and sentinel empty, as in a process of its own)
    dispatch.reset()
    cpu_train, cpu_model = train("cpu", os.path.join(root, "models_cpu"),
                                 ["--telemetry-file",
                                  os.path.join(tel, "train_cpu.jsonl")])
    ll_rel = abs(cpu_train["avg_log_likelihood"]
                 - summary["avg_log_likelihood"]) / abs(
                     cpu_train["avg_log_likelihood"])
    lam_rel = float(np.max(np.abs(cpu_model.lam - card_model.lam)
                           / np.maximum(np.abs(cpu_model.lam), 1.0)))
    if not ll_rel <= 1e-4:
        raise AssertionError(f"config E: card and CPU train avg logLik "
                             f"differ by {ll_rel}")

    reports = {}
    score_launches, t_score = None, {}
    for device in ("cuda", "cpu"):
        _build.reset_launches()
        reports[device], t_score[device] = cli_score(
            "E", books, stop, device,
            os.path.join(root, f"TestOutput_{device}"),
            os.path.join(root, f"score_{device}.out"),
            ["--models-dir", models])
        if device == "cuda":
            score_launches = dict(_build.LAUNCHES)
    blocks = reports["cuda"].count("Book's number:")
    if blocks != EN_DOCS or score_launches["gamma_fixed_point_bkl"] == 0:
        raise AssertionError(f"config E score: {blocks} books, "
                             f"{score_launches}")
    diff, agreement, clear = distributions_agree("E", reports["cuda"],
                                                 reports["cpu"])
    telemetry = check_e_telemetry(books, stop, tel, root, models, train,
                                  train_launches, score_launches, tokens,
                                  ds["vocab"])
    summary.update({
        "phase": "config_E", "docs": EN_DOCS, "vocab": v, "k": EN_K,
        "sweeps": SWEEPS, "tokens": int(sum(distinct)),
        "words": int(sum(len(t.split()) for t in texts)),
        "distinct_per_book": [min(distinct), max(distinct)],
        "backend": pre.last_backend, "corpus_s": t_corpus,
        "front_end_s": t_pre,
        "score_s": t_score["cuda"], "cpu_score_s": t_score["cpu"],
        "launches": {name: train_launches[name] + score_launches[name]
                     for name in train_launches},
        "train_launches": train_launches, "score_launches": score_launches,
        "sweep_check": sweep_check,
        "cpu_plain_avg_log_likelihood": cpu_train["avg_log_likelihood"],
        "cpu_plain_train_s": cpu_train["train_s"],
        "avg_log_likelihood_rel_diff": ll_rel, "lam_max_rel_diff": lam_rel,
        "max_dist_diff": diff,
        "main_topic_agreement": agreement,
        "main_topic_clear_docs": clear,
        "report_bytes": len(reports["cuda"].encode()),
        "telemetry": telemetry,
        "bounds": {"max_dist_diff": 5e-3,
                   "avg_log_likelihood_rel_diff": 1e-4},
    })
    return summary, {"root": root, "books": books, "stop": stop,
                     "rows": tf_rows, "vocab": ds["vocab"],
                     "card_report": reports["cuda"],
                     "avg_log_likelihood": summary["avg_log_likelihood"]}


def check_e_telemetry(books, stop, tel, root, models, train,
                      train_launches, score_launches, tokens, vocab):
    """Config E's ``train`` and ``score`` on the card again with
    ``--telemetry-file``: the same launch counts as without it; the card
    train's stream against the CPU train's (the same names less the device
    memory families and the names of kernel launches, ``backend`` "gpu"
    against "cpu", one ``config_hash``), live device memory above 0, one
    ``train_iteration`` a sweep, and ``train_fit``'s log-likelihood over
    the corpus's documents equal to the average the CLI printed; then the
    two card streams through the port's ``metrics``
    (``dispatch_attribution``): every launch attributed, the roofline rows
    on the ``nvidia-h100`` peaks, printed on a line of their own, and the
    sentinel's signatures, one ``score.topic_inference`` a length
    bucket."""
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.telemetry import dispatch

    t0 = time.perf_counter()
    # each command's dispatch records and sentinel start empty, as in a
    # process of its own
    dispatch.reset()
    _build.reset_launches()
    card_nums, _ = train("cuda", os.path.join(root, "models_telemetry"),
                         ["--telemetry-file",
                          os.path.join(tel, "train_cuda.jsonl")], "_tel")
    tel_train = dict(_build.LAUNCHES)
    dispatch.reset()
    _build.reset_launches()
    cli_score("E", books, stop, "cuda", os.path.join(root, "TestOutput_tel"),
              os.path.join(root, "score_tel.out"), ["--models-dir", models],
              ["--telemetry-file", os.path.join(tel, "score_cuda.jsonl")])
    tel_score = dict(_build.LAUNCHES)
    if tel_train != train_launches or tel_score != score_launches:
        raise AssertionError(f"config E telemetry: launches {tel_train}, "
                             f"{tel_score} against {train_launches}, "
                             f"{score_launches} without the flag")
    card = telemetry_stream(os.path.join(tel, "train_cuda.jsonl"))
    cpu = telemetry_stream(os.path.join(tel, "train_cpu.jsonl"))
    score_man, score_events, score_snap = telemetry_stream(
        os.path.join(tel, "score_cuda.jsonl"))
    from spark_text_clustering_tpu_torch.ops.sparse import (
        bucket_indices_by_length,
    )
    from spark_text_clustering_tpu_torch.pipeline import make_vectorizer

    only_card = stream_names(*card[1:]) - stream_names(*cpu[1:])
    only_cpu = stream_names(*cpu[1:]) - stream_names(*card[1:])
    (fit,) = [e for e in card[1] if e["event"] == "train_fit"]
    (corpus,) = [e for e in card[1] if e["event"] == "corpus"]
    iterations = sum(1 for e in card[1] if e["event"] == "train_iteration")
    avg = fit["log_likelihood"] / corpus["documents"]
    # the dispatch layer: every launch attributed, the roofline on the
    # card's peaks, the sentinel's signatures (one a length bucket of the
    # rows the score vectorizes)
    buckets = len(bucket_indices_by_length(make_vectorizer(vocab)(tokens)))
    roofline = dispatch_attribution(
        "E", [os.path.join(tel, "train_cuda.jsonl"),
              os.path.join(tel, "score_cuda.jsonl")],
        [tel_train, tel_score],
        {"em.packed_chunk": 1, "em.packed_loglik": 1,
         "score.topic_inference": buckets})
    emit({"phase": "config_E_roofline", "peaks": "nvidia-h100",
          "rows": roofline["rows"]})
    in_use = card[2]["gauges"].get("mem.device.bytes_in_use", 0)
    peak = card[2]["gauges"].get("mem.device.peak_bytes_in_use", 0)
    if (only_card or only_cpu or card[0]["backend"] != "gpu"
            or cpu[0]["backend"] != "cpu" or score_man["backend"] != "gpu"
            or card[0]["config_hash"] != cpu[0]["config_hash"]
            or not in_use > 0
            or not score_snap["gauges"].get("mem.device.bytes_in_use", 0) > 0
            or iterations != SWEEPS
            or abs(avg - card_nums["avg_log_likelihood"]) > 1e-12 * abs(avg)):
        raise AssertionError(
            f"config E telemetry: names only on the card {sorted(only_card)}"
            f", only on the CPU {sorted(only_cpu)}; backends "
            f"{card[0]['backend']}/{cpu[0]['backend']}, config_hash "
            f"{card[0]['config_hash']}/{cpu[0]['config_hash']}, "
            f"bytes_in_use {in_use}, {iterations} iterations, train_fit avg "
            f"{avg} against {card_nums['avg_log_likelihood']}")
    return {"train_launches": tel_train, "score_launches": tel_score,
            "dispatch": {"launches": roofline["launches"],
                         "compile_check": roofline["compile_check"],
                         "score_buckets": buckets,
                         "roofline": roofline["rows"]},
            "names": len(stream_names(*card[1:])),
            "events": len(card[1]), "score_events": len(score_events),
            "config_hash": card[0]["config_hash"],
            "device_count": card[0]["device_count"],
            "bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "bytes_limit": card[2]["gauges"].get("mem.device.bytes_limit"),
            "train_iterations": iterations,
            "train_fit_avg_log_likelihood": avg,
            "train_s": card_nums["train_s"],
            "seconds": time.perf_counter() - t0}


def run_config_f(torch, seed, workdir, smi):
    """The padded EM layout and the MLlib artifacts through the CLI on the
    card: 51 synthetic EN books of F_WORDS words each, so every book holds
    ~10,000 distinct terms and EM's "auto" layout is one padded bucket of
    16,384 slots a book.

    1. ``train --export-mllib`` on the card (the padded sweep: no sweep
       kernel launches);
    2. ``train --device cpu`` from the same seed (avg logLik within 1e-4
       relative, lambda within 1e-3, floored at 1);
    3. ``train --token-layout packed`` on the card from the same seed (50
       fused-sweep launches; the same limits against step 1);
    4. ``score`` on the card (the E-step kernel) against ``score --device
       cpu`` (5e-3, main topics where the CPU's top two differ by 1e-2);
    5. ``score --model <step 1's dir>_mllib`` on the card: the same report
       byte for byte, from the same lam, alpha and eta.
    Where pyarrow is not installed, steps 1 and 5 run without the MLlib
    export and a line says so."""
    import importlib.util

    from spark_text_clustering_tpu_torch import load_model
    from spark_text_clustering_tpu_torch.ops import _build

    root = os.path.join(workdir, "F")
    t0 = time.perf_counter()
    stop = en_books_dir(seed, root, words=(F_WORDS, F_WORDS))
    t_corpus = time.perf_counter() - t0
    books = os.path.join(root, "books")
    mllib = importlib.util.find_spec("pyarrow") is not None
    if not mllib:
        emit({"config_F_mllib": "not run: pyarrow is not installed"})

    def train(tag, device, extra=()):
        """One ``train``: (console numbers, model dir, layout, launches,
        fit record)."""
        models = os.path.join(root, f"models_{tag}")
        _build.reset_launches()
        with em_fits() as fits:
            nums, path = cli_train("F", books, stop, device, models, None,
                                   os.path.join(root, f"train_{tag}.out"),
                                   extra)
        launches = dict(_build.LAUNCHES)
        (fit,) = fits
        model = load_model(path, device="cpu")
        nums["fit_ms_per_sweep"] = 1e3 * float(np.mean(model.iteration_times))
        return nums, path, model, fit, launches

    # 1. the padded fit on the card
    card, card_path, card_model, (opt, distinct, v, cells), train_launches = (
        train("card", "cuda", ["--export-mllib"] if mllib else []))
    tokens = int(sum(distinct))
    if opt.last_layout != "padded" or opt.last_sweep != "padded":
        raise AssertionError(f"config F: the card's fit ran "
                             f"{opt.last_layout}/{opt.last_sweep}")
    if train_launches["em_sweep_fused"] or train_launches[
            "scatter_add_vtiles"]:
        raise AssertionError(f"config F padded train: {train_launches}")
    if not 30_000 <= v <= 50_000 or len(distinct) != EN_DOCS or not (
            8_192 < min(distinct) and max(distinct) <= 16_384) or (
            cells != EN_DOCS * 16_384):
        raise AssertionError(f"config F: V={v}, {len(distinct)} books of "
                             f"{min(distinct)}-{max(distinct)} terms, "
                             f"{cells} padded cells")
    mllib_dir = card_path + "_mllib"
    if mllib and not os.path.isdir(mllib_dir):
        raise AssertionError(f"config F: no MLlib export at {mllib_dir}")

    def close(label, other, other_model, ll_limit=1e-4, lam_limit=1e-3):
        """Avg logLik relative and lambda (floored at 1) differences of
        ``other`` from the card's padded fit."""
        ll = abs(other["avg_log_likelihood"] - card["avg_log_likelihood"]) / \
            abs(card["avg_log_likelihood"])
        lam = float(np.max(np.abs(other_model.lam - card_model.lam)
                           / np.maximum(np.abs(card_model.lam), 1.0)))
        if not ll <= ll_limit or not lam <= lam_limit:
            raise AssertionError(f"config F: {label} avg logLik rel {ll}, "
                                 f"lambda rel {lam}")
        return ll, lam

    # 2. the same fit on the CPU, the padded sweep in plain PyTorch there too
    cpu, _, cpu_model, (cpu_opt, *_), _ = train("cpu", "cpu")
    if cpu_opt.last_layout != "padded":
        raise AssertionError(f"config F: CPU layout {cpu_opt.last_layout}")
    cpu_ll, cpu_lam = close("card vs CPU", cpu, cpu_model)
    # 3. the same fit packed on the card: the fused sweep kernel
    packed, _, packed_model, (pk_opt, *_), packed_launches = train(
        "packed", "cuda", ["--token-layout", "packed"])
    if pk_opt.last_sweep != "fused" or packed_launches[
            "em_sweep_fused"] != SWEEPS:
        raise AssertionError(f"config F packed train: {pk_opt.last_sweep}, "
                             f"{packed_launches}")
    pk_ll, pk_lam = close("padded vs packed", packed, packed_model)

    # 4. score the padded-trained model on the card and on the CPU
    models = os.path.dirname(card_path)
    reports, secs, score_launches = {}, {}, {}
    for device in ("cuda", "cpu"):
        _build.reset_launches()
        reports[device], secs[device] = cli_score(
            "F", books, stop, device, os.path.join(root, f"out_{device}"),
            os.path.join(root, f"score_{device}.out"),
            ["--models-dir", models])
        score_launches[device] = dict(_build.LAUNCHES)
    blocks = reports["cuda"].count("Book's number:")
    if blocks != EN_DOCS or score_launches["cuda"][
            "gamma_fixed_point_bkl"] == 0:
        raise AssertionError(f"config F score: {blocks} books, "
                             f"{score_launches['cuda']}")
    diff, agreement, clear = distributions_agree("F", reports["cuda"],
                                                 reports["cpu"])

    # 5. the MLlib export scored on the card: the same report
    mllib_launches = {name: 0 for name in _build.LAUNCHES}
    summary_mllib = None
    if mllib:
        imported = load_model(mllib_dir, device="cpu")
        for field in ("lam", "alpha", "vocab"):
            if not np.array_equal(np.asarray(getattr(imported, field)),
                                  np.asarray(getattr(card_model, field))):
                raise AssertionError(f"config F: the MLlib model's {field} "
                                     "differs from the saved model's")
        if imported.eta != card_model.eta:
            raise AssertionError(f"config F: the MLlib model's eta "
                                 f"{imported.eta} != {card_model.eta}")
        _build.reset_launches()
        report, secs["mllib"] = cli_score(
            "F", books, stop, "cuda", os.path.join(root, "out_mllib"),
            os.path.join(root, "score_mllib.out"), ["--model", mllib_dir])
        mllib_launches = dict(_build.LAUNCHES)
        if report != reports["cuda"] or not np.array_equal(
                report_distributions(report, EN_K),
                report_distributions(reports["cuda"], EN_K)):
            raise AssertionError("config F: the MLlib model's report "
                                 "differs from the saved model's")
        if mllib_launches["gamma_fixed_point_bkl"] == 0:
            raise AssertionError(f"config F MLlib score: {mllib_launches}")
        summary_mllib = {"score_s": secs["mllib"],
                         "report_equal": True, "launches": mllib_launches}

    main_path = (train_launches, packed_launches, score_launches["cuda"],
                 mllib_launches)
    return {
        "phase": "config_F", "card": smi, "docs": EN_DOCS, "vocab": v,
        "k": EN_K, "sweeps": SWEEPS, "words_per_book": F_WORDS,
        "tokens": tokens, "distinct_per_book": [min(distinct), max(distinct)],
        "padded_cells": cells, "padded_cells_per_token": cells / tokens,
        "corpus_s": t_corpus,
        "train_s": card["train_s"], "preprocess_s": card["preprocess_s"],
        "fit_s": card["fit_s"], "score_s": secs["cuda"],
        "padded_ms_per_sweep": card["fit_ms_per_sweep"],
        "packed_ms_per_sweep": packed["fit_ms_per_sweep"],
        "packed_train_s": packed["train_s"], "packed_fit_s": packed["fit_s"],
        "avg_log_likelihood": card["avg_log_likelihood"],
        "cpu_avg_log_likelihood": cpu["avg_log_likelihood"],
        "packed_avg_log_likelihood": packed["avg_log_likelihood"],
        "cpu_vs_card": {"avg_log_likelihood_rel_diff": cpu_ll,
                        "lam_max_rel_diff": cpu_lam},
        "packed_vs_padded": {"avg_log_likelihood_rel_diff": pk_ll,
                             "lam_max_rel_diff": pk_lam},
        "cpu_train_s": cpu["train_s"], "cpu_fit_s": cpu["fit_s"],
        "cpu_score_s": secs["cpu"], "max_dist_diff": diff,
        "main_topic_agreement": agreement, "main_topic_clear_docs": clear,
        "mllib": summary_mllib or "not run: pyarrow is not installed",
        "launches": {name: sum(run[name] for run in main_path)
                     for name in train_launches},
        "train_launches": train_launches, "packed_launches": packed_launches,
        "score_launches": score_launches["cuda"],
        "bounds": {"avg_log_likelihood_rel_diff": 1e-4,
                   "lam_max_rel_diff": 1e-3, "max_dist_diff": 5e-3},
    }


def online_defaults(k, seed, iters=None):
    """Configs G and H: online VB with the defaults the CLI's ``train
    --algorithm online`` runs (MLlib's Bernoulli minibatches of
    0.05 + 1/n of the corpus, ``token_layout="auto"``), 60 iterations as
    C; H's CLI keeps its own default of 50."""
    from spark_text_clustering_tpu_torch import Params

    return Params(k=k, algorithm="online", seed=seed,
                  max_iterations=ONLINE_ITERS if iters is None else iters)


def live_slots(torch, seg, d):
    """Doc slots holding tokens in the tile slabs ``seg`` [n_tiles, tt]."""
    tile = torch.arange(seg.shape[0], device=seg.device)[:, None]
    return int((tile * d + seg.long())[seg < d].unique().numel())


def check_tiles_launches(torch, packed, seen, label):
    """Every recorded tile-kernel launch of a fit against the plain
    version (normalized gamma within 5e-3), with the plain version's
    inner iterations; the launch of iteration 5 and the heaviest timed
    and bounded."""
    errs, its = [], []
    for args, out in seen:
        want, it = packed.gamma_fixed_point_tiles_plain(*args,
                                                        with_iters=True)
        wn = want / want.sum(0, keepdim=True)
        errs.append(float((out / out.sum(0, keepdim=True) - wn).abs().max()))
        its.append(it)
    if not max(errs) <= 5e-3:
        raise AssertionError(f"gamma_fixed_point_tiles differs from its plain "
                             f"version by {max(errs)} in {label}'s launches")
    heavy_at = max(range(len(its)), key=lambda i: (int(its[i].max()),
                                                   float(its[i].float().mean())))

    def timed(i):
        args = seen[i][0][:5]
        d = seen[i][0][5]
        _, case = tiles_case(torch, packed, args, d, f"{label}_launch_{i}")
        t_bytes, by = tiles_bound(torch, args, d, its[i],
                                  live_slots(torch, args[2], d))
        case.update(
            launch=i, ms=cuda_ms(
                torch, lambda: packed.gamma_fixed_point_tiles(*args, d), 20),
            graph_ms=cuda_graph_ms(
                torch, lambda: packed.gamma_fixed_point_tiles(*args, d), 20),
            plain_ms=cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles_plain(
                *args, d), 2),
            bound_ms=t_bytes, bound_by=by, library_ms=None)
        return case

    return {
        "launches": len(seen), "max_abs_err": max(errs),
        "tile_iterations_max": [int(i.max()) for i in its],
        "iteration_5": timed(min(5, len(seen) - 1)),
        "heavy": timed(heavy_at),
    }


def run_config_g(torch, rows, seed, workdir):
    """Online VB with the defaults on config C's rows (raw counts, k=20):
    MLlib's Bernoulli minibatches, so "auto" takes the host-streaming
    packed path, each chunk's minibatches cut into tiles for the tile
    kernel.  Every kernel launch of one fit is held against the plain
    version; then a warm-up fit and the timed fit -> save -> load ->
    log-perplexity of the first EVAL_DOCS docs, through the library's
    entry points; then ten iterations on the card against the same ten
    through the same tiles iteration with CPU tensors (``rule="card"``:
    the plain versions), from the same lambda and gamma draws: lambda
    within 1e-3 relative, the log-perplexity within 1e-4."""
    from spark_text_clustering_tpu_torch import OnlineLDA, load_model
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.models.persistence import model_dir_name
    from spark_text_clustering_tpu_torch.ops import _build, packed

    vocab = [f"h{i}" for i in range(NG_V)]
    eval_rows = rows[:EVAL_DOCS]
    with recorded(online_lda, "gamma_fixed_point_tiles") as seen:
        OnlineLDA(online_defaults(NG_K, seed)).fit(rows, vocab)
    kernel = check_tiles_launches(torch, packed, seen, "G")
    del seen

    opt = OnlineLDA(online_defaults(NG_K, seed))
    opt.fit(rows, vocab)                                    # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    model = opt.fit(rows, vocab)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    path = model_dir_name("G", os.path.join(workdir, "models"))
    model.save(path)
    loaded = load_model(path)
    t0 = time.perf_counter()
    log_perp = loaded.log_perplexity(eval_rows)
    t_eval = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    docs = [opt.sample_pick(i).size for i in range(ONLINE_ITERS)]
    updates = sum(1 for d in docs if d)
    if (opt.last_layout, opt.last_gamma_backend) != ("packed",
                                                     "pallas_tiles"):
        raise AssertionError(f"config G ran {opt.last_layout}/"
                             f"{opt.last_gamma_backend}")
    if launches["gamma_fixed_point_tiles"] != updates or kernel[
            "launches"] != updates:
        raise AssertionError(f"config G: {updates} updates, {launches}")
    if not np.isfinite(log_perp) or not np.isfinite(model.lam).all() or (
            not (model.lam > 0).all()):
        raise AssertionError(f"config G: bad model (logPerp {log_perp})")

    m = ONLINE_CHECK_ITERS
    card = OnlineLDA(online_defaults(NG_K, seed, m)).fit(rows, vocab)
    cpu_opt = OnlineLDA(online_defaults(NG_K, seed, m), device="cpu",
                        rng_device="cuda", rule="card")
    t0 = time.perf_counter()
    cpu = cpu_opt.fit(rows, vocab)
    t_cpu = time.perf_counter() - t0
    if cpu_opt.last_gamma_backend != "pallas_tiles":
        raise AssertionError(f"config G CPU: {cpu_opt.last_gamma_backend}")
    lam_rel = float(np.max(np.abs(card.lam - cpu.lam) / np.abs(cpu.lam)))
    lp_card = card.log_perplexity(eval_rows)
    lp_cpu = cpu.log_perplexity(eval_rows, device="cpu")
    lp_rel = abs(lp_card - lp_cpu) / abs(lp_cpu)
    summary = {
        "phase": "config_G", "docs": len(rows), "vocab": NG_V, "k": NG_K,
        "iterations": ONLINE_ITERS, "sampling": "bernoulli",
        "token_layout": "auto", "layout": opt.last_layout,
        "gamma_backend": opt.last_gamma_backend,
        "tokens": int(sum(len(i) for i, _ in rows)),
        "batch_size": opt.last_batch_size,
        "docs_per_iteration_mean": float(np.mean(docs)),
        "batch_cells": opt.last_batch_cells,
        "tile_chunks": opt.last_tile_chunks,
        "fit_s": t_fit, "ms_per_iteration": 1e3 * t_fit / ONLINE_ITERS,
        "docs_per_s": sum(docs) / t_fit,
        "log_perplexity": log_perp, "eval_docs": len(eval_rows),
        "eval_s": t_eval, "launches": launches, "kernel": kernel,
        "check_iterations": m, "lam_max_rel_diff": lam_rel,
        "log_perplexity_card": lp_card, "log_perplexity_cpu": lp_cpu,
        "log_perplexity_rel_diff": lp_rel, "cpu_fit_s": t_cpu,
        "bounds": {"lam_max_rel_diff": 1e-3, "log_perplexity_rel_diff": 1e-4},
    }
    if not lam_rel <= 1e-3 or not lp_rel <= 1e-4:
        raise AssertionError(
            f"config G: card vs CPU lambda rel {lam_rel}, logPerp rel {lp_rel}")
    return summary


def run_config_h(torch, seed, e):
    """Online VB through the CLI with its defaults on config E's book
    directory: ``train --algorithm online`` on the card (Bernoulli
    minibatches of ~3.6 of the 51 books padded to 12; "auto" pads them,
    and the padded corpus stays on the card: one [12, 5, 16384] E-step
    kernel launch an iteration that draws a book) -> ``score`` on the
    card against ``score --device cpu`` of the same model (5e-3, main
    topics where the CPU's top two differ by 1e-2) -> ten iterations of
    the library fit on E's TF-IDF rows on the card, every E-step launch
    held against the plain version, against the same ten with CPU
    tensors from the same lambda and gamma draws (lambda within 1e-3
    relative)."""
    from spark_text_clustering_tpu_torch import OnlineLDA, load_model
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.ops import _build

    root, books, stop = e["root"], e["books"], e["stop"]
    rows, vocab = e["rows"], e["vocab"]
    models = os.path.join(root, "models_online")
    _build.reset_launches()
    with online_fits() as fits:
        nums, path = cli_train("H", books, stop, "cuda", models, len(vocab),
                               os.path.join(root, "train_online.out"),
                               ["--algorithm", "online"])
    train_launches = dict(_build.LAUNCHES)
    ((opt, fit_rows),) = fits
    p = opt.params
    iters = p.max_iterations
    updates = sum(1 for i in range(iters) if opt.sample_pick(i).size)
    resident = len(fit_rows) * opt.last_row_len * 8 <= p.resident_budget_bytes
    if (opt.last_layout, opt.last_gamma_backend, p.sampling,
            p.token_layout, resident) != ("padded", "pallas", "bernoulli",
                                          "auto", True):
        raise AssertionError(f"config H ran {opt.last_layout}/"
                             f"{opt.last_gamma_backend} ({p.sampling}, "
                             f"{p.token_layout}, resident {resident})")
    if train_launches["gamma_fixed_point_bkl"] != updates:
        raise AssertionError(f"config H train: {updates} updates, "
                             f"{train_launches}")

    reports, secs, score_launches = {}, {}, None
    for device in ("cuda", "cpu"):
        _build.reset_launches()
        reports[device], secs[device] = cli_score(
            "H", books, stop, device, os.path.join(root, f"out_online_{device}"),
            os.path.join(root, f"score_online_{device}.out"),
            ["--models-dir", models])
        if device == "cuda":
            score_launches = dict(_build.LAUNCHES)
    diff, agreement, clear = distributions_agree("H", reports["cuda"],
                                                 reports["cpu"])
    e["online_card_report"] = reports["cuda"]

    m = ONLINE_CHECK_ITERS
    card_opt = OnlineLDA(online_defaults(EN_K, seed, m))
    with recorded(online_lda, "gamma_fixed_point_bkl") as seen:
        card = card_opt.fit(rows, vocab)
    check_updates = sum(1 for i in range(m) if card_opt.sample_pick(i).size)
    cases = [estep_case(torch, *args[:4], f"H_launch_{i}")
             for i, (args, _) in enumerate(seen)]
    del seen
    cpu_opt = OnlineLDA(online_defaults(EN_K, seed, m), device="cpu",
                        rng_device="cuda", rule="card")
    t0 = time.perf_counter()
    cpu = cpu_opt.fit(rows, vocab)
    t_cpu = time.perf_counter() - t0
    if cpu_opt.last_layout != "padded" or len(cases) != check_updates:
        raise AssertionError(f"config H: CPU {cpu_opt.last_layout}, "
                             f"{len(cases)} card launches")
    lam_rel = float(np.max(np.abs(card.lam - cpu.lam) / np.abs(cpu.lam)))
    if not lam_rel <= 1e-3:
        raise AssertionError(f"config H: card vs CPU lambda rel {lam_rel}")
    model = load_model(path, device="cpu")
    if model.algorithm != "online" or not np.isfinite(model.lam).all():
        raise AssertionError("config H: bad model")
    wide = run_h_wide(torch, root, books, stop, len(vocab))
    launches = {name: train_launches[name] + score_launches[name]
                + sum(run[name] for run in wide["launches"].values())
                for name in train_launches}
    return {
        "phase": "config_H", "docs": len(fit_rows), "vocab": len(vocab),
        "k": EN_K, "iterations": iters, "updates": updates,
        "sampling": p.sampling, "token_layout": p.token_layout,
        "layout": opt.last_layout, "resident": resident,
        "row_len": opt.last_row_len, "batch_size": opt.last_batch_size,
        "batch_cells": opt.last_batch_cells,
        "train_s": nums["train_s"], "preprocess_s": nums["preprocess_s"],
        "fit_s": nums["fit_s"],
        "ms_per_iteration": 1e3 * float(np.mean(model.iteration_times)),
        "score_s": secs["cuda"], "cpu_score_s": secs["cpu"],
        "max_dist_diff": diff, "main_topic_agreement": agreement,
        "main_topic_clear_docs": clear,
        "launches": launches,
        "train_launches": train_launches, "score_launches": score_launches,
        "k100": wide,
        "kernel": {"launches": len(cases),
                   "max_abs_err": max(c["max_abs_err"] for c in cases),
                   "first": cases[0],
                   "ms": [c["ms"] for c in cases]},
        "check_iterations": m, "lam_max_rel_diff": lam_rel,
        "cpu_fit_s": t_cpu,
        "bounds": {"max_dist_diff": 5e-3, "lam_max_rel_diff": 1e-3},
    }


H_WIDE_K = 100                 # the JAX bench's online k
H_WIDE_ITERS = 5
H_WIDE_CPU_EVERY = 3           # the k=100 CPU scorings: every third book


def run_h_wide(torch, root, books, stop, v):
    """Config H at k = 100: ``train --algorithm online --k 100`` for a few
    iterations on E's books on the card (the E-step's wide instance), then
    ``score`` (padded buckets: the wide E-step) and ``score
    --per-doc-convergence`` (the per-document kernel at k = 100) on the
    card, each against the same ``score --device cpu`` within 5e-3 (E's
    band), each card run's launches counted.  Every E-step launch of the
    card's ``train`` and ``score`` is held against the plain version, the
    widest of each timed beside its bound."""
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.ops import _build, estep

    models = os.path.join(root, "models_online_k100")
    _build.reset_launches()
    with recorded(online_lda, "gamma_fixed_point_bkl") as seen_train:
        nums, _ = cli_train("H-k100", books, stop, "cuda", models, v,
                            os.path.join(root, "train_online_k100.out"),
                            ["--algorithm", "online", "--k", str(H_WIDE_K),
                             "--max-iterations", str(H_WIDE_ITERS)])
    launches = {"train": dict(_build.LAUNCHES)}
    seen = {"train": seen_train, "score": []}
    res = {"k": H_WIDE_K, "iterations": H_WIDE_ITERS,
           "train_s": nums["train_s"]}
    # the CPU scores every H_WIDE_CPU_EVERY-th book (k=100 on the host is
    # ~0.5 s a book); the card scores them all
    names = sorted(os.listdir(books))[::H_WIDE_CPU_EVERY]
    cpu_books = os.path.join(root, "books_k100_cpu")
    os.makedirs(cpu_books)
    for name in names:
        shutil.copy(os.path.join(books, name), cpu_books)
    for tag, extra in (("score", []),
                       ("score_per_doc", ["--per-doc-convergence"])):
        reports, secs = {}, {}
        for device in ("cuda", "cpu"):
            _build.reset_launches()
            with recorded(estep, "gamma_fixed_point_bkl") as seen_score:
                reports[device], secs[device] = cli_score(
                    f"H-k100 {tag}", books if device == "cuda" else
                    cpu_books, stop, device,
                    os.path.join(root, f"out_k100_{tag}_{device}"),
                    os.path.join(root, f"k100_{tag}_{device}.out"),
                    ["--models-dir", models], extra)
            if device == "cuda" and tag == "score":
                seen["score"] = seen_score
            if device == "cuda":
                launches[tag] = dict(_build.LAUNCHES)
        diff, agreement, clear = distributions_agree(
            f"H-k100 {tag}", reports["cuda"], reports["cpu"], H_WIDE_K,
            books=names)
        res[tag] = {"s": secs["cuda"], "cpu_s": secs["cpu"],
                    "cpu_books": len(names),
                    "max_dist_diff": diff, "main_topic_agreement": agreement,
                    "main_topic_clear_docs": clear}
    kernel_of = {"train": "gamma_fixed_point_bkl",
                 "score": "gamma_fixed_point_bkl",
                 "score_per_doc": "topic_inference_segments"}
    if any(launches[run][name] == 0 for run, name in kernel_of.items()):
        raise AssertionError(f"config H-k100 skipped a kernel: {launches}")
    res["launches"] = launches
    for run, calls in seen.items():
        widest = max(range(len(calls)),
                     key=lambda i: calls[i][0][0].numel())
        cases = [estep_case(torch, *args[:4], f"H_k100_{run}_{i}",
                            timed=i == widest)
                 for i, (args, _) in enumerate(calls)]
        res[f"{run}_kernel"] = {
            "launches": len(cases),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "shapes": [c["shape"] for c in cases],
            "widest": cases[widest]}
    del seen
    res["bounds"] = {"max_dist_diff": 5e-3}
    return res


GRID_I = (2, 2)                # config I: data x model shards, gloo


def grid_pair(torch, grid, rows, v):
    """This rank's (data, model) pair of ``rows``'s scatter plan, as the
    grid fit lays it out (shard_v = V_pad / model shards): (plan, the
    pair's lids, block map, seg and cts on the card, d_max, shard_v)."""
    from spark_text_clustering_tpu_torch.models.em_lda import packed_shard_plan
    from spark_text_clustering_tpu_torch.ops.emscatter import plan_em_scatter

    dev, d, m = grid.device, grid.d, grid.m
    ids, cts, seg, _, d_max = packed_shard_plan(rows, grid.data_shards)
    shard_v = -(-v // grid.model_shards)
    plan = plan_em_scatter(ids, cts, grid.model_shards, shard_v)
    seg_len = plan.nb * plan.tb
    so = plan.sort_order[d][m * seg_len:(m + 1) * seg_len]
    blk = (plan.nb, 1, plan.tb)

    def srt(a):
        return torch.from_numpy(np.concatenate(
            [a[d], a[d, :1] * 0])[so].reshape(blk)).to(dev)

    return (plan, torch.from_numpy(plan.lids[d, m]).to(dev),
            torch.from_numpy(plan.block_vtile[d, m]).to(dev), srt(seg),
            srt(cts), d_max, shard_v)


def grid_sweep_check(torch, grid, rows, k, v):
    """The fused sweep against its plain version on this rank's pair
    (``grid_pair``), with the data shard's doc slots and the pair's doc
    stream in shard-local columns, from a random start."""
    from spark_text_clustering_tpu_torch.ops import emsweep
    from spark_text_clustering_tpu_torch.parallel import model_row_sum

    dev = grid.device
    plan, lids, bv, seg, cts, d_max, shard_v = grid_pair(torch, grid, rows, v)
    rng = np.random.default_rng(100 + grid.rank)
    d_pad = emsweep.fused_d_pad(d_max)
    alpha, eta = 50.0 / k + 1.0, 1.1
    n_wk = torch.from_numpy(
        rng.gamma(1.0, 20.0, (k, shard_v)).astype(np.float32)).to(dev)
    n_dk = torch.from_numpy(
        rng.gamma(1.0, 2000.0, (d_max, k)).astype(np.float32)).to(dev)
    inv_denom = 1.0 / (model_row_sum(grid, n_wk) + (eta * v - v))
    docf = torch.zeros((k, d_pad), device=dev)
    docf[:, :d_max] = (n_dk + (alpha - 1.0)).T
    stream = emsweep.doc_stream(lids, seg, cts, bv, plan.vt)
    if int(stream[0].max()) >= shard_v:
        raise AssertionError("config I: the doc stream holds global columns")
    args = (n_wk, docf, inv_denom, lids, seg, cts, bv, *stream)
    geo = dict(n_vtiles=plan.n_vtiles, nb=plan.nb, vt=plan.vt, tb=plan.tb,
               d_pad=d_pad, shard_v=shard_v, eta_m1=eta - 1.0)
    got, err, rel = sweep_against_plain(torch, args, geo)
    # the kernel's cost (emsweep.cost) at the live slots, as check_sweep
    live = int((cts > 0).sum())
    t_bytes, by = bound(*emsweep.cost(*args, **geo, live=live))
    return {"pair": [grid.d, grid.m], "docs": d_max, "k": k,
            "shard_v": shard_v, "nb": plan.nb, "tokens": live,
            "doc_stream": int(stream[0].shape[0]),
            "max_abs_err": err, "max_rel_err": rel,
            "tolerance": "rtol 1e-4, atol 1e-5",
            "ms": cuda_ms(torch, lambda: emsweep.em_sweep_fused(*args, **geo),
                          20),
            "plain_ms": cuda_ms(torch, lambda: emsweep.em_sweep_fused_plain(
                *args, **geo), 5),
            "bound_ms": t_bytes, "bound_by": by}


def grid_scatter_check(torch, grid, rows, k, v):
    """The scatter against its plain version on this rank's pair
    (``grid_pair``), random posteriors on the pair's live slots."""
    from spark_text_clustering_tpu_torch.ops import emscatter

    plan, lids, bv, _, cts, _, shard_v = grid_pair(torch, grid, rows, v)
    cts = cts.reshape(-1)
    rng = np.random.default_rng(200 + grid.rank)
    phi = torch.from_numpy(rng.exponential(
        size=(cts.shape[0], k)).astype(np.float32)).to(grid.device)
    wphi = (cts[:, None] * phi / phi.sum(1, keepdim=True)).contiguous()
    geo = dict(n_vtiles=plan.n_vtiles, vt=plan.vt, tb=plan.tb,
               shard_v=shard_v)
    got = emscatter.scatter_add_vtiles(wphi, lids, bv, nb=plan.nb, **geo)
    want = emscatter.scatter_add_vtiles_plain(wphi, lids, bv, **geo)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"config I: scatter_add_vtiles differs from its "
                             f"plain version by {err} on pair "
                             f"{(grid.d, grid.m)}")
    # the kernel's cost (emscatter.cost) at the live slots, as
    # check_scatter
    live = int((cts > 0).sum())
    t_bytes, by = bound(*emscatter.cost(wphi, lids, bv, shard_v=shard_v,
                                        live=live))
    return {"pair": [grid.d, grid.m], "k": k, "shard_v": shard_v,
            "nb": plan.nb, "tokens": live, "max_abs_err": err,
            "tolerance": "rtol 1e-5, atol 1e-5",
            "ms": cuda_ms(torch, lambda: emscatter.scatter_add_vtiles(
                wphi, lids, bv, nb=plan.nb, **geo), 20),
            "plain_ms": cuda_ms(torch, lambda:
                                emscatter.scatter_add_vtiles_plain(
                                    wphi, lids, bv, **geo), 5),
            "bound_ms": t_bytes, "bound_by": by}


def grid_estep_check(torch, grid, rows, k, v):
    """The E-step kernel against its plain version on this rank's block of
    the most populated scoring bucket of ``rows``, its [B, k, L] rows of
    exp(E[log beta]) gathered from the vocabulary shards as sharded
    scoring gathers them (a random lambda)."""
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        dirichlet_expectation_sharded,
    )
    from spark_text_clustering_tpu_torch.ops.sparse import (
        bucket_indices_by_length,
    )
    from spark_text_clustering_tpu_torch.parallel import (
        data_shard_rows, gather_model_rows_bkl, model_row_sum,
    )

    dev = grid.device
    buckets = bucket_indices_by_length(rows)
    width = max(buckets, key=lambda w: len(buckets[w]))
    batch, _, _ = data_shard_rows(grid, [rows[i] for i in buckets[width]],
                                  width, dev)
    shard_v = -(-v // grid.model_shards)
    rng = np.random.default_rng(300 + grid.m)
    lam = torch.from_numpy(
        rng.gamma(1.0, 20.0, (k, shard_v)).astype(np.float32)).to(dev)
    eb_shard = torch.exp(dirichlet_expectation_sharded(
        lam, model_row_sum(grid, lam)))
    eb = gather_model_rows_bkl(grid, eb_shard, batch.token_ids)
    cts = batch.token_weights.contiguous()
    alpha = torch.full((k,), 50.0 / k + 1.0, device=dev)
    g0 = torch.ones((cts.shape[0], k), device=dev)
    return {"name": "gamma_fixed_point_bkl", "config": "I-B",
            "rank": grid.rank,
            **estep_case(torch, eb, cts, alpha, g0, "I-B")}


def config_i_rank(grid, seed):
    """One rank of config I (2x2 grid, gloo, CUDA tensors).  First each
    kernel against its plain version at this rank's shard shapes (those
    launches are not counted), then the main path with the counts at 0:
    I-A (A's corpus: grid IDF -> EM fit, the fused sweep) and I-B (B's
    corpus: grid IDF -> EM fit, the two-stage sweep -> grid scoring of
    512 docs and the grid's EM log-likelihood of them).  Rank 0 returns
    the arrays the parent compares; every rank returns its numbers."""
    import torch
    import torch.distributed as dist

    from spark_text_clustering_tpu_torch import IDF, LDA, Params
    from spark_text_clustering_tpu_torch.models.sharded_eval import (
        make_sharded_em_log_likelihood,
    )
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.ops.sparse import next_pow2
    from spark_text_clustering_tpu_torch.parallel import data_shard_rows

    dev = grid.device
    # gloo's broadcast of a CUDA tensor (agree_checkpoint_exists uses it)
    flag = torch.full((1,), float(grid.rank), device=dev)
    dist.broadcast(flag, src=0)
    if float(flag.item()) != 0.0:
        raise AssertionError("config I: broadcast over gloo failed")
    corpora = {"A": (en_books_rows(seed), EN_V, EN_K),
               "B": (newsgroups_rows(seed), NG_V, NG_K)}
    tfidf = {label: IDF(device=dev).fit(
        {"rows": rows, "vocab": [f"t{i}" for i in range(v)]}).transform(
            {"rows": rows})["rows"] for label, (rows, v, _) in corpora.items()}
    checks = {
        "em_sweep_fused": grid_sweep_check(torch, grid, tfidf["A"], EN_K,
                                           EN_V),
        "scatter_add_vtiles": grid_scatter_check(torch, grid, tfidf["B"],
                                                 NG_K, NG_V),
        "gamma_fixed_point_bkl": grid_estep_check(
            torch, grid, tfidf["B"][:EVAL_DOCS], NG_K, NG_V),
    }

    out = {"rank": grid.rank, "pair": [grid.d, grid.m], "checks": checks}
    _build.reset_launches()
    before = dict(_build.LAUNCHES)
    for label, (rows, v, k) in corpora.items():
        ds = {"rows": rows, "vocab": [f"t{i}" for i in range(v)]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tf = IDF(min_doc_freq=2, idf_floor=1e-4, grid=grid).fit(ds)
        tf_rows = tf.transform(ds)
        torch.cuda.synchronize()
        t_idf = time.perf_counter() - t0
        grid.timed = True
        grid.stats.update(calls=0, seconds=0.0, bytes=0)
        params = Params(k=k, max_iterations=SWEEPS, seed=seed,
                        keep_doc_topic_counts=label == "B")
        t0 = time.perf_counter()
        fitted = LDA(params, grid=grid).fit(tf_rows)
        t_fit = time.perf_counter() - t0
        grid.timed = False
        model = fitted.model
        sweep_ms = 1e3 * float(np.mean(model.iteration_times))
        res = {
            "idf_s": t_idf, "fit_s": t_fit, "ms_per_sweep": sweep_ms,
            "collective_calls_per_sweep": grid.stats["calls"] / SWEEPS,
            "collective_ms_per_sweep": 1e3 * grid.stats["seconds"] / SWEEPS,
            "collective_mb_per_sweep": grid.stats["bytes"] / SWEEPS / 1e6,
            "collective_share": grid.stats["seconds"] / (
                SWEEPS * sweep_ms / 1e3),
            "avg_log_likelihood": fitted.log_likelihood / fitted.corpus_size,
            "lam_sum": float(model.lam.astype(np.float64).sum()),
            "idf_equal": bool(np.array_equal(
                tf.idf, IDF(min_doc_freq=2, idf_floor=1e-4, device=dev).fit(
                    ds).idf)),
        }
        if label == "B":
            docs = tf_rows["rows"][:EVAL_DOCS]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist_b = model.topic_distribution(docs, grid=grid)
            res["score_s"] = time.perf_counter() - t0
            width = max(8, next_pow2(max(len(i) for i, _ in docs)))
            block, lo, hi = data_shard_rows(grid, docs, width, dev)
            n_dk = torch.zeros((block.token_ids.shape[0], k), device=dev)
            n_dk[:hi - lo] = torch.from_numpy(
                fitted.doc_topic_counts[lo:hi]).to(dev)
            ll_fn = make_sharded_em_log_likelihood(
                grid, alpha=params.resolved_alpha(),
                eta=params.resolved_eta(), vocab_size=v)
            res["em_log_likelihood"] = float(ll_fn(
                model._lam_on_grid(grid), n_dk, block.token_ids,
                block.token_weights))
            if grid.rank == 0:
                res.update(dist=dist_b,
                           n_dk=fitted.doc_topic_counts[:EVAL_DOCS])
        if grid.rank == 0:
            res["lam"] = model.lam
        res["launches"] = {n: _build.LAUNCHES[n] - before[n]
                           for n in _build.LAUNCHES}
        before = dict(_build.LAUNCHES)
        out[label] = res
    return out


def nccl_rank(grid):
    """A 1x1 grid over NCCL: it initializes and reduces."""
    import torch
    import torch.distributed as dist

    x = torch.arange(4.0, device=grid.device)
    dist.all_reduce(x)
    return {"backend": dist.get_backend(), "sum": float(x.sum())}


I_REPEATS = {"A": 1, "B": 4}    # repeat 1x1 card fits beside the first


def lam_rel(a, b):
    """The largest difference of lambda ``a`` from ``b``, relative to
    max(|b|, 1)."""
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def lam_spread(lams):
    """The spread of repeat fits' lambdas: (the largest pairwise
    ``lam_rel`` of a later fit from an earlier one, every pair's distance
    as ``{"i-j": d}``)."""
    pairs = {f"{i}-{j}": lam_rel(lams[j], lams[i])
             for i in range(len(lams)) for j in range(i + 1, len(lams))}
    return max(pairs.values(), default=0.0), pairs


def grid_lam_bound(spread):
    """Config I's bound on the grid's lambda against the 1x1 fit's: 1e-3,
    or twice the 1x1 fits' spread (``lam_spread``) where that is
    larger."""
    return max(1e-3, 2.0 * spread)


def run_config_i(torch, seed, e):
    """EM and scoring on a 2x2 grid of 4 ranks on the one card, gloo with
    CUDA tensors: I-A and I-B (``config_i_rank``) against the 1x1 card
    fits from the same seed (avg logLik within 1e-4, lambda within 1e-3
    relative, or within twice the 1x1 fit's own spread where that is
    larger: the largest pairwise distance of ``I_REPEATS`` + 1 1x1 fits
    from the seed, five for B, whose two-stage sweep adds N_dk with float
    atomics, so 50 EM sweeps of it do not repeat; two for A, whose fused
    sweep repeats bit for bit), B's 512-doc grid scoring against 1x1 card scoring of the
    same model (5e-3) and the grid's EM log-likelihood against the 1x1
    one (1e-4); then I-CLI: ``train --data-shards 2 --model-shards 2
    --dist-backend gloo`` and ``score --model-shards 2`` on E's books
    against config E's 1x1 card CLI (distributions 5e-3, main topics where
    the top two differ by 1e-2), beside it a 1x1 NCCL grid."""
    from spark_text_clustering_tpu_torch import IDF, LDA, Params, load_model
    from spark_text_clustering_tpu_torch.models.sharded_eval import (
        make_sharded_em_log_likelihood,
    )
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.ops.sparse import batch_from_rows
    from spark_text_clustering_tpu_torch.parallel import make_grid, run_grid

    summary = {"phase": "config_I", "grid": list(GRID_I),
               "backend": "gloo", "ranks": GRID_I[0] * GRID_I[1]}
    _build.reset_launches()
    t0 = time.perf_counter()
    ranks = run_grid(config_i_rank, *GRID_I, (seed,), backend="gloo",
                     device="cuda", timeout=600)
    summary["grid_s"] = time.perf_counter() - t0
    grid_launches = dict(_build.LAUNCHES)
    rank0 = ranks[0]
    corpora = {"A": (en_books_rows(seed), EN_V, EN_K),
               "B": (newsgroups_rows(seed), NG_V, NG_K)}
    for label, (rows, v, k) in corpora.items():
        ds = {"rows": rows, "vocab": [f"t{i}" for i in range(v)]}
        tf_rows = IDF(min_doc_freq=2, idf_floor=1e-4).fit(ds).transform(ds)
        params = Params(k=k, max_iterations=SWEEPS, seed=seed,
                        keep_doc_topic_counts=label == "B")
        one = LDA(params).fit(tf_rows)
        avg1 = one.log_likelihood / one.corpus_size
        # the 1x1 card fit against itself, repeated from the same seed:
        # B's two-stage sweep adds N_dk with float atomics, so its 50
        # sweeps are not repeatable to the grid's limit (the fused sweep
        # is, bit for bit); its noise is the largest distance between any
        # two of the fits
        lams = [one.model.lam] + [LDA(params).fit(tf_rows).model.lam
                                  for _ in range(I_REPEATS[label])]
        repeat, pairs = lam_spread(lams)
        res = {key: val for key, val in rank0[label].items()
               if key not in ("lam", "dist", "n_dk")}
        res["ranks"] = [{key: r[label][key] for key in (
            "ms_per_sweep", "collective_share", "avg_log_likelihood",
            "lam_sum", "launches")} for r in ranks]
        ll_rel = abs(res["avg_log_likelihood"] - avg1) / abs(avg1)
        lam_diff = lam_rel(rank0[label]["lam"], one.model.lam)
        lam_bound = grid_lam_bound(repeat)
        res.update(one_device_avg_log_likelihood=avg1,
                   avg_log_likelihood_rel_diff=ll_rel,
                   lam_max_rel_diff=lam_diff,
                   one_device_fits=len(lams),
                   one_device_pairwise_lam_rel=pairs,
                   one_device_repeat_lam_max_rel_diff=repeat,
                   lam_bound=lam_bound,
                   lam_bound_reason=(
                       "1e-3" if lam_bound == 1e-3 else
                       f"twice the largest pairwise distance of "
                       f"{len(lams)} 1x1 card fits from the seed"))
        if not ll_rel <= 1e-4 or not lam_diff <= lam_bound:
            raise AssertionError(f"config I-{label}: grid vs 1x1 avg logLik "
                                 f"{ll_rel}, lambda {lam_diff} (bound "
                                 f"{lam_bound}; 1x1 against itself {repeat})")
        if len({r[label]["lam_sum"] for r in ranks}) != 1 or not all(
                r[label]["idf_equal"] for r in ranks):
            raise AssertionError(f"config I-{label}: ranks disagree")
        kern = "em_sweep_fused" if label == "A" else "scatter_add_vtiles"
        if any(r[label]["launches"][kern] != SWEEPS for r in ranks):
            raise AssertionError(f"config I-{label}: launches "
                                 f"{[r[label]['launches'] for r in ranks]}")
        if label == "B":
            docs = tf_rows["rows"][:EVAL_DOCS]
            grid_model = one.model
            grid_model.lam = rank0["B"]["lam"]
            want = grid_model.topic_distribution(docs, layout="padded")
            diff = float(np.abs(rank0["B"]["dist"] - want).max())
            grid1 = make_grid(1, 1, device="cuda")
            batch = batch_from_rows(docs, device=grid1.device)
            ll1 = float(make_sharded_em_log_likelihood(
                grid1, alpha=params.resolved_alpha(),
                eta=params.resolved_eta(), vocab_size=v)(
                    torch.from_numpy(rank0["B"]["lam"]).to(grid1.device),
                    torch.from_numpy(rank0["B"]["n_dk"]).to(grid1.device),
                    batch.token_ids, batch.token_weights))
            em_rel = abs(res["em_log_likelihood"] - ll1) / abs(ll1)
            res.update(score_max_dist_diff=diff,
                       one_device_em_log_likelihood=ll1,
                       em_log_likelihood_rel_diff=em_rel)
            if not diff <= 5e-3 or not em_rel <= 1e-4:
                raise AssertionError(f"config I-B: scoring {diff}, EM "
                                     f"logLik {em_rel}")
            if any(r["B"]["launches"]["gamma_fixed_point_bkl"] == 0
                   for r in ranks):
                raise AssertionError("config I-B: no E-step launch")
        summary[f"I_{label}"] = res

    # I-CLI on E's books, against config E's 1x1 card CLI, with the 1x1
    # NCCL grid beside it (its rank launches no kernel)
    root, books, stop = e["root"], e["books"], e["stop"]
    grid_flags = ["--data-shards", "2", "--model-shards", "2",
                  "--dist-backend", "gloo"]
    with beside(lambda: run_grid(nccl_rank, 1, 1, backend="nccl",
                                 device="cuda", timeout=300)) as nccl_box:
        _build.reset_launches()
        nums, path = cli_train("I-CLI", books, stop, "cuda",
                               os.path.join(root, "models_grid"),
                               len(e["vocab"]),
                               os.path.join(root, "train_grid.out"),
                               grid_flags)
        train_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        report, t_score = cli_score(
            "I-CLI", books, stop, "cuda", os.path.join(root, "out_grid"),
            os.path.join(root, "score_grid.out"),
            ["--model", path, "--model-shards", "2", "--dist-backend",
             "gloo"])
        score_launches = dict(_build.LAUNCHES)
    diff, agreement, clear = distributions_agree("I-CLI", report,
                                                 e["card_report"])
    ll_rel = abs(nums["avg_log_likelihood"] - e["avg_log_likelihood"]) / abs(
        e["avg_log_likelihood"])
    if not ll_rel <= 1e-4 or train_launches["em_sweep_fused"] != 4 * SWEEPS \
            or score_launches["gamma_fixed_point_bkl"] == 0:
        raise AssertionError(f"config I-CLI: avg logLik {ll_rel}, "
                             f"{train_launches}, {score_launches}")
    load_model(path, device="cpu")
    summary["I_CLI"] = {
        **nums, "score_s": t_score, "max_dist_diff": diff,
        "main_topic_agreement": agreement, "main_topic_clear_docs": clear,
        "avg_log_likelihood_rel_diff": ll_rel,
        "train_launches": train_launches, "score_launches": score_launches,
        "bounds": {"max_dist_diff": 5e-3,
                   "avg_log_likelihood_rel_diff": 1e-4}}

    (nccl,) = nccl_box["out"]
    if nccl != {"backend": "nccl", "sum": 6.0}:
        raise AssertionError(f"config I: NCCL 1x1 grid gave {nccl}")
    summary["nccl_1x1"] = nccl
    summary["checks"] = {name: [r["checks"][name] for r in ranks]
                         for name in ranks[0]["checks"]}
    summary["launches"] = {
        name: grid_launches[name] + train_launches[name]
        + score_launches[name] for name in grid_launches}
    summary["bounds"] = {"avg_log_likelihood_rel_diff": 1e-4,
                         "lam_max_rel_diff": "1e-3, or twice the largest "
                                             "pairwise distance of the 1x1 "
                                             "card fits from the seed",
                         "score_max_dist_diff": 5e-3,
                         "em_log_likelihood_rel_diff": 1e-4}
    return summary


GRID_J = (2, 2)                # config J: data x model shards, gloo
J_REPLAY_ITERS = 10            # J-C's grid iterations replayed at 1x1


def mask_floats(text: str) -> str:
    """``text`` with every float written as ``<f>``."""
    import re

    return re.sub(r"-?\d+\.\d+(?:[eE][-+]?\d+)?", "<f>", text)


def grid_tiles_check(torch, grid, rows, seed):
    """The tile kernel against its plain version on this rank's share of
    J-C's iteration 5: its data shard's tiles of ``plan_corpus_tiles
    (n_shards=D)`` as the grid fit picks them (``tile_pick``), eb of a
    random lambda gathered from the vocabulary shards
    (``gather_model_rows_kbl``), random gamma inits."""
    from spark_text_clustering_tpu_torch import OnlineLDA
    from spark_text_clustering_tpu_torch.ops import packed
    from spark_text_clustering_tpu_torch.parallel import (
        gather_model_rows_kbl, model_row_sum,
    )

    dev, k, n = grid.device, NG_K, len(rows)
    opt = OnlineLDA(online_params(seed, 0), grid=grid)
    opt.fit(rows, [f"h{i}" for i in range(NG_V)])     # no iteration
    plan = packed.plan_corpus_tiles(*flat_rows(rows),
                                    n_shards=grid.data_shards, k=k)
    per = plan.ids.shape[0] // grid.data_shards
    pick = grid.d * per + opt.tile_pick(5)[grid.d]
    d, tb = plan.d, len(pick)
    ids, cts, seg = (torch.from_numpy(a[pick]).to(dev)
                     for a in (plan.ids, plan.cts, plan.seg))
    shard_v = NG_V // grid.model_shards
    rng = np.random.default_rng(400 + grid.m)
    lam = torch.from_numpy(
        rng.gamma(1.0, 1.0, (k, shard_v)).astype(np.float32)).to(dev)
    lam_tok = gather_model_rows_kbl(grid, lam, ids.reshape(-1).long())
    eb = torch.exp(torch.digamma(lam_tok.clamp(min=1e-30)) - torch.digamma(
        model_row_sum(grid, lam))[:, None]).contiguous()
    g0 = torch.from_numpy(np.random.default_rng(500 + grid.rank).gamma(
        100.0, 0.01, (k, tb * d)).astype(np.float32)).to(dev)
    args = (eb, cts, seg, torch.full((k,), 1.0 / k, device=dev), g0)
    iters, case = tiles_case(torch, packed, args, d, f"J-C_rank_{grid.rank}",
                             plan.doc_ids[pick], n)
    t_bytes, by = tiles_bound(torch, args, d, iters,
                              int((plan.doc_ids[pick] < n).sum()))
    case.update(
        rank=grid.rank, pair=[grid.d, grid.m],
        live_tokens=int((seg < d).sum()),
        ms=cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles(*args, d),
                   20),
        plain_ms=cuda_ms(torch, lambda: packed.gamma_fixed_point_tiles_plain(
            *args, d), 3),
        bound_ms=t_bytes, bound_by=by)
    return case


def grid_nmf_check(torch, grid, rows, seed):
    """The NMF kernel against its plain version on this rank's block of
    config D's tiles (``plan_corpus_tiles(n_shards=D)``): W in tile-slot
    order from the fit's W0, H at the tokens gathered from the vocabulary
    shards of the fit's H0, H Hᵀ summed over "model"."""
    from spark_text_clustering_tpu_torch import NMF
    from spark_text_clustering_tpu_torch.models.nmf import docs_w_to_tiles
    from spark_text_clustering_tpu_torch.ops import nmf, packed
    from spark_text_clustering_tpu_torch.parallel import (
        gather_model_rows_kbl, psum_model,
    )

    dev, k, n = grid.device, NG_K, len(rows)
    plan = packed.plan_corpus_tiles(*flat_rows(rows),
                                    n_shards=grid.data_shards, k=k)
    per = plan.ids.shape[0] // grid.data_shards
    blk = slice(grid.d * per, (grid.d + 1) * per)
    w_doc, h = NMF(nmf_params(seed), device=dev)._init(
        n, k, NG_V, float(sum(w.sum() for _, w in rows)))
    shard_v = NG_V // grid.model_shards
    h = h[:, grid.m * shard_v:(grid.m + 1) * shard_v].contiguous()
    ids, cts, seg = (torch.from_numpy(np.ascontiguousarray(a[blk])).to(dev)
                     for a in (plan.ids, plan.cts, plan.seg))
    d = plan.d
    args = (gather_model_rows_kbl(grid, h, ids.reshape(-1).long()), cts, seg,
            docs_w_to_tiles(w_doc, plan.doc_ids[blk]),
            psum_model(grid, h @ h.T))
    got = nmf.nmf_mu_update_tiles(*args, d)
    want = nmf.nmf_mu_update_tiles_plain(*args, d)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.allclose(g, w, rtol=1e-4, atol=1e-8)
               for g, w in zip(got, want)):
        raise AssertionError(f"config J-D: nmf_mu_update_tiles differs from "
                             f"its plain version by {err} on rank "
                             f"{grid.rank}")
    live_tok = int((plan.seg[blk] < d).sum())
    live_slots = int((plan.doc_ids[blk] < n).sum())
    t_bytes, by = bound(*nmf.cost(*args, d, live_tokens=live_tok,
                                  live_slots=live_slots))
    return {"rank": grid.rank, "pair": [grid.d, grid.m], "k": k,
            "tiles": per, "tt": plan.tt, "d": d, "live_tokens": live_tok,
            "live_slots": live_slots, "max_abs_err": err,
            "tolerance": "rtol 1e-4, atol 1e-8",
            "ms": cuda_ms(torch, lambda: nmf.nmf_mu_update_tiles(*args, d),
                          20),
            "plain_ms": cuda_ms(torch, lambda: nmf.nmf_mu_update_tiles_plain(
                *args, d), 3),
            "bound_ms": t_bytes, "bound_by": by}


def grid_online_estep_check(torch, grid, rows, v, seed):
    """The padded E-step kernel against its plain version on this rank's
    rows of a J-CLI minibatch (E's TF-IDF rows, the online CLI's defaults:
    12 picks, 6 a data shard, of the corpus row length; a draw that
    reaches every data shard), its [B/D, k, L]
    rows of exp(E[log beta]) gathered from the vocabulary shards of a
    random lambda (``gather_model_rows_bkl``)."""
    from spark_text_clustering_tpu_torch import OnlineLDA
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        dirichlet_expectation_sharded,
    )
    from spark_text_clustering_tpu_torch.ops.sparse import batch_from_rows
    from spark_text_clustering_tpu_torch.parallel import (
        gather_model_rows_bkl, model_row_sum,
    )

    dev, k, n = grid.device, EN_K, len(rows)
    opt = OnlineLDA(online_defaults(EN_K, seed, 0), grid=grid)
    opt.fit(rows, [f"t{i}" for i in range(v)])        # no iteration
    bsz = -(-opt.last_batch_size // grid.data_shards) * grid.data_shards
    per = bsz // grid.data_shards
    # the first draw that gives every data shard a book (a draw of ~3.6
    # books leaves the last shard's rows all pads), else the first that
    # draws one
    sizes = [opt.sample_pick(i).size for i in range(2000)]
    it = next((i for i, m in enumerate(sizes)
               if m > (grid.data_shards - 1) * per),
              next(i for i, m in enumerate(sizes) if m))
    pick = opt.sample_pick(it)
    pick = np.concatenate([pick, np.arange(n, n + bsz - pick.size)])
    empty = (np.zeros(0, np.int32), np.zeros(0, np.float32))
    mine = [rows[i] if i < n else empty
            for i in pick[grid.d * per:(grid.d + 1) * per]]
    batch = batch_from_rows(mine, row_len=opt.last_row_len, device=dev)
    shard_v = -(-v // grid.model_shards)
    lam = torch.from_numpy(np.random.default_rng(600 + grid.m).gamma(
        100.0, 0.01, (k, shard_v)).astype(np.float32)).to(dev)
    eb_shard = torch.exp(dirichlet_expectation_sharded(
        lam, model_row_sum(grid, lam)))
    eb = gather_model_rows_bkl(grid, eb_shard, batch.token_ids)
    g0 = torch.from_numpy(np.random.default_rng(700 + grid.rank).gamma(
        100.0, 0.01, (per, k)).astype(np.float32)).to(dev)
    return {"name": "gamma_fixed_point_bkl", "config": "J-CLI",
            "rank": grid.rank, "iteration": it,
            **estep_case(torch, eb, batch.token_weights.contiguous(),
                         torch.full((k,), 1.0 / k, device=dev), g0,
                         "J-CLI")}


@contextlib.contextmanager
def shard_row_sums(torch, module, shards: int):
    """Inside the block, ``module._eb_at`` and ``module._eb_table`` (the
    online fit's exp(E[log beta]) at the tokens and over lambda's columns)
    on one device sum lambda's rows as a grid of ``shards`` vocabulary
    shards does: each shard's columns, then the shards in order.  A
    last-bit change in a row sum can move a tile at the tol boundary by
    one inner iteration, and that moves lambda by ~1e-4 an iteration; a
    stream's unconverged E-step tiles (100 inner iterations) carry it
    further (config M)."""
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        dirichlet_expectation_sharded,
    )

    eb_at, eb_table = module._eb_at, module._eb_table

    def row_sums(lam):
        w = lam.shape[1] // shards
        return sum(lam[:, i * w:(i + 1) * w].contiguous().sum(dim=1)
                   for i in range(shards))

    def grid_order(lam, flat, grid=None):
        return torch.exp(torch.digamma(lam[:, flat].clamp(min=1e-30))
                         - torch.digamma(row_sums(lam))[:, None])

    def table_grid_order(lam, grid=None):
        return torch.exp(dirichlet_expectation_sharded(lam, row_sums(lam)))

    module._eb_at, module._eb_table = grid_order, table_grid_order
    try:
        yield
    finally:
        module._eb_at, module._eb_table = eb_at, eb_table


def _timed_fit(torch, grid, fit, units: int) -> dict:
    """``fit()`` with the grid's collectives timed: (the fit's result, its
    seconds, ms a unit (an iteration or a sweep) from the fit's iteration
    times, and the collectives' ms, MB and share a unit)."""
    torch.cuda.synchronize()
    grid.timed = True
    grid.stats.update(calls=0, seconds=0.0, bytes=0)
    t0 = time.perf_counter()
    model = fit()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    grid.timed = False
    unit_ms = 1e3 * float(np.mean(model.iteration_times))
    return model, {
        "fit_s": secs, "ms_per_unit": unit_ms,
        "collective_calls_per_unit": grid.stats["calls"] / units,
        "collective_ms_per_unit": 1e3 * grid.stats["seconds"] / units,
        "collective_mb_per_unit": grid.stats["bytes"] / units / 1e6,
        "collective_share": grid.stats["seconds"] / (units * unit_ms / 1e3)}


def config_j_rank(grid, seed, e_rows, e_v):
    """One rank of config J (2x2 grid, gloo, CUDA tensors).  First the
    tile, NMF and E-step kernels against their plain versions at this
    rank's shard shapes (those launches are not counted), then the main
    path with the counts at 0: J-C (C's corpus, online VB tiles-resident
    on the grid, 60 iterations; then the first 10 again, for the 1x1
    replay), J-G (G's defaults: the host-streaming packed path on tiles)
    and J-D (D's NMF on tiles).  Rank 0 returns the arrays the parent
    compares; every rank returns its numbers."""
    import torch

    from spark_text_clustering_tpu_torch import NMF, OnlineLDA
    from spark_text_clustering_tpu_torch.ops import _build

    rows = newsgroups_rows(seed)
    vocab = [f"h{i}" for i in range(NG_V)]
    checks = {
        "gamma_fixed_point_tiles": grid_tiles_check(torch, grid, rows, seed),
        "nmf_mu_update_tiles": grid_nmf_check(torch, grid, rows, seed),
        "gamma_fixed_point_bkl": grid_online_estep_check(torch, grid, e_rows,
                                                         e_v, seed),
    }
    out = {"rank": grid.rank, "pair": [grid.d, grid.m], "checks": checks}
    _build.reset_launches()

    def launches_since(before):
        return {n_: _build.LAUNCHES[n_] - before[n_] for n_ in _build.LAUNCHES}

    before = dict(_build.LAUNCHES)
    opt = OnlineLDA(online_params(seed), grid=grid)
    model, res = _timed_fit(torch, grid, lambda: opt.fit(rows, vocab),
                            ONLINE_ITERS)
    res.update(layout=opt.last_layout, gamma_backend=opt.last_gamma_backend,
               batch_size=opt.last_batch_size, tiles=opt.last_tiles,
               log_perplexity=model.log_perplexity(rows[:EVAL_DOCS]),
               lam_sum=float(model.lam.astype(np.float64).sum()))
    replay = OnlineLDA(online_params(seed, J_REPLAY_ITERS), grid=grid)
    lam10 = replay.fit(rows, vocab).lam
    res["launches"] = launches_since(before)
    if grid.rank == 0:
        res.update(lam=model.lam, replay_lam=lam10, replay_picks=[
            replay.tile_pick(i) for i in range(J_REPLAY_ITERS)])
    out["C"] = res

    before = dict(_build.LAUNCHES)
    opt = OnlineLDA(online_defaults(NG_K, seed), grid=grid)
    model, res = _timed_fit(torch, grid, lambda: opt.fit(rows, vocab),
                            ONLINE_ITERS)
    res.update(layout=opt.last_layout, gamma_backend=opt.last_gamma_backend,
               bsz=opt.last_batch_size, tile_chunks=opt.last_tile_chunks,
               draws=[int(opt.sample_pick(i).size)
                      for i in range(ONLINE_ITERS)],
               lam_sum=float(model.lam.astype(np.float64).sum()),
               launches=launches_since(before))
    if grid.rank == 0:
        res["lam"] = model.lam
    out["G"] = res

    before = dict(_build.LAUNCHES)
    opt = NMF(nmf_params(seed), grid=grid)
    model, res = _timed_fit(torch, grid, lambda: opt.fit(rows, vocab),
                            NMF_ITERS)
    check = NMF(nmf_params(seed, NMF_CHECK_ITERS), grid=grid).fit(rows, vocab)
    res.update(layout=opt.last_layout, mu_backend=opt.last_mu_backend,
               tiles=opt.last_tiles, loss=model.loss,
               check_loss=check.loss, launches=launches_since(before))
    if grid.rank == 0:
        res.update(h=model.h, check_h=check.h)
    out["D"] = res
    return out


def _unit(res: dict, unit: str) -> dict:
    """A rank's J numbers with "unit" named: iteration or sweep."""
    return {key.replace("unit", unit): val for key, val in res.items()}


def run_config_j(torch, seed, e, log_perplexity_c):
    """Online VB and NMF on a 2x2 grid of 4 ranks on the one card, gloo
    with CUDA tensors (``config_j_rank``): J-C against a replay of its
    first 10 iterations at 1x1 on the card (the grid's tiles mapped to
    global indices, the same lambda and gamma draws: lambda within 1e-3
    relative) and against config C's log-perplexity (3%, the JAX
    package's whole-fit band: the grid walks another tile stream); J-G
    against the 1x1 card fit from the seed (lambda within 1e-3 relative,
    or twice the 1x1 fit's own spread over two more fits where that is
    larger: ``index_add_`` adds with float atomics); J-D against the 1x1
    card fits (after D's ten check sweeps H 1e-3 relative, floored at
    1e-6 of the largest, and the loss 1e-4; after the 40 the loss 1e-4);
    then J-CLI on E's books: ``train --algorithm online`` at 2x2
    and ``score`` of its model on the grid against config H's 1x1 card
    report (5e-3), and ``train --algorithm nmf`` at 1x1 and at 2x2, each
    model scored, the grid's report equal to the 1x1 report with floats
    masked.  J-CLI's four 2x2 commands run on one ``GridPool`` of four
    ranks (one start-up for the four, beside J's 1x1 fits and the 1x1 NMF
    pair); the timed grid runs alone."""
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.parallel import run_grid

    summary = {"phase": "config_J", "grid": list(GRID_J),
               "backend": "gloo", "ranks": GRID_J[0] * GRID_J[1]}
    _build.reset_launches()
    t0 = time.perf_counter()
    ranks = run_grid(config_j_rank, *GRID_J,
                     (seed, e["rows"], len(e["vocab"])), backend="gloo",
                     device="cuda", timeout=900)
    summary["grid_s"] = time.perf_counter() - t0
    grid_launches = dict(_build.LAUNCHES)

    # J-CLI on E's books: its four 2x2 commands on one pool of four ranks
    # (one start-up, which J's 1x1 fits and the 1x1 NMF pair overlap);
    # with V a multiple of the model shards the grid draws config H's
    # lambda
    root, books, stop = e["root"], e["books"], e["stop"]
    if len(e["vocab"]) % GRID_J[1]:
        raise AssertionError(f"config J-CLI: E's V={len(e['vocab'])} pads on "
                             f"{GRID_J[1]} model shards: another draw than H")
    flags = ["--data-shards", "2", "--model-shards", "2",
             "--dist-backend", "gloo"]
    online_train_launches = {name: 0 for name in grid_launches}
    cli_launches = {"online_score": dict(online_train_launches),
                    "nmf": dict(online_train_launches)}

    def nmf_run(name, extra, pool=None):
        """NMF's `train` and `score` of its model, on the pool's ranks
        (launches counted) or in this process (not counted)."""
        counted = cli_launches["nmf"] if pool else None
        nums, path = cli_train(
            "J-CLI", books, stop, "cuda",
            os.path.join(root, f"models_nmf_{name}"), len(e["vocab"]),
            os.path.join(root, f"train_nmf_{name}.out"),
            ["--algorithm", "nmf", *extra], counted, pool)
        report, secs = cli_score(
            "J-CLI", books, stop, "cuda", os.path.join(root, f"out_nmf_{name}"),
            os.path.join(root, f"score_nmf_{name}.out"),
            ["--model", path, *extra], (), counted, pool)
        return report, {f"nmf_train_{name}_s": nums["train_s"],
                        f"nmf_score_{name}_s": secs}

    t0 = time.perf_counter()
    with grid_pool(GRID_J[0] * GRID_J[1], os.path.join(root, "j_pool")) \
            as pool:
        j_onedevice(torch, seed, ranks, summary, log_perplexity_c)
        nmf_one = nmf_run("1x1", [])
        nums_o, path_o = cli_train(
            "J-CLI", books, stop, "cuda",
            os.path.join(root, "models_online_grid"), len(e["vocab"]),
            os.path.join(root, "train_online_grid.out"),
            ["--algorithm", "online", *flags], online_train_launches, pool)
        report_o, t_score_o = cli_score(
            "J-CLI", books, stop, "cuda",
            os.path.join(root, "out_online_grid"),
            os.path.join(root, "score_online_grid.out"),
            ["--model", path_o, *flags], (), cli_launches["online_score"],
            pool)
        nmf_grid = nmf_run("2x2", flags, pool)
    cli_s = time.perf_counter() - t0
    reports = {"1x1": nmf_one[0], "2x2": nmf_grid[0]}
    secs = {**nmf_one[1], **nmf_grid[1]}
    diff, agreement, clear = distributions_agree("J-CLI", report_o,
                                                 e["online_card_report"])
    nmf_equal = mask_floats(reports["2x2"]) == mask_floats(reports["1x1"])
    nmf_diff = float(np.abs(report_distributions(reports["2x2"], EN_K)
                            - report_distributions(reports["1x1"], EN_K)).max())
    if not nmf_equal or online_train_launches["gamma_fixed_point_bkl"] == 0:
        raise AssertionError(f"config J-CLI: NMF reports equal {nmf_equal} "
                             f"(distributions {nmf_diff}), online train "
                             f"{online_train_launches}")
    launches = {name: online_train_launches[name]
                + sum(c[name] for c in cli_launches.values())
                for name in grid_launches}
    summary["J_CLI"] = {
        "online_train_s": nums_o["train_s"],
        "online_preprocess_s": nums_o["preprocess_s"],
        "online_fit_s": nums_o["fit_s"], "online_score_s": t_score_o,
        "online_max_dist_diff": diff, "main_topic_agreement": agreement,
        "main_topic_clear_docs": clear, **secs,
        "nmf_report_equal_masked": nmf_equal, "nmf_max_dist_diff": nmf_diff,
        "online_train_launches": online_train_launches,
        "launches": launches, "cli_s": cli_s,
        "pool": "the four 2x2 commands on one pool of four ranks, which "
                "starts beside J's 1x1 fits and the 1x1 NMF pair",
        "bounds": {"online_max_dist_diff": 5e-3,
                   "nmf_report": "equal with floats masked"}}

    summary["checks"] = {name: [r["checks"][name] for r in ranks]
                         for name in ranks[0]["checks"]}
    summary["launches"] = {name: grid_launches[name] + launches[name]
                           for name in grid_launches}
    summary["bounds"] = {
        "J_C_replay_lam_max_rel_diff": 1e-3,
        "J_C_log_perplexity_rel_diff": 0.03,
        "J_G_lam_max_rel_diff": "1e-3, or twice the 1x1 fit's spread "
                                "against itself",
        "J_D_check_h_max_rel_diff": 1e-3, "J_D_check_loss_rel_diff": 1e-4,
        "J_D_loss_rel_diff": 1e-4}
    return summary


def j_onedevice(torch, seed, ranks, summary, log_perplexity_c):
    """J-C, J-G and J-D's 1x1 side: the replay, the 1x1 card fits and
    their comparisons with the grid ranks' results (``run_config_j``),
    into ``summary``."""
    from types import SimpleNamespace

    from spark_text_clustering_tpu_torch import NMF, OnlineLDA
    from spark_text_clustering_tpu_torch.device import resolve_device
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.ops import packed
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        init_lambda, seeded_generator,
    )

    dev = resolve_device("cuda")
    n_data = GRID_J[0]
    rank0 = ranks[0]
    rows = newsgroups_rows(seed)
    n, vocab = len(rows), [f"h{i}" for i in range(NG_V)]

    def lam_rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    def ranks_of(label, unit, *keys):
        return [{key: _unit(r[label], unit)[key] for key in (
            f"ms_per_{unit}", "collective_share", "launches", *keys)}
            for r in ranks]

    def public(label, unit):
        return {key: val for key, val in _unit(rank0[label], unit).items()
                if key not in ("lam", "h", "check_h", "replay_lam", "replay_picks")}

    # J-C: replay the grid's first 10 iterations at 1x1 on the card, from
    # the seeded lambda (V even: the grid draws the same table)
    p = online_params(seed, J_REPLAY_ITERS)
    plan = packed.plan_corpus_tiles(*flat_rows(rows), n_shards=n_data,
                                    k=NG_K, min_tile_docs=128)
    per = plan.ids.shape[0] // n_data
    ids, cts, seg, doc = (torch.from_numpy(a).to(dev) for a in (
        plan.ids, plan.cts, plan.seg, plan.doc_ids))
    lam = init_lambda(seeded_generator(dev, seed, online_lda._LAMBDA_KEY),
                      NG_K, NG_V, p.gamma_shape, device=dev)

    def replay_iteration(it, pick, lam):
        """Iteration ``it`` at 1x1 on the grid's tiles ``pick`` [data
        shards, tiles], as global tile indices."""
        glob = (pick + per * np.arange(n_data)[:, None]).reshape(-1)
        g = torch.from_numpy(glob).to(dev)
        return online_lda.tiles_iteration(
            lam, it, ids[g], cts[g], seg[g],
            draws._gamma_rows(run, it, doc[g].reshape(-1)).T.contiguous(),
            int((plan.doc_ids[glob] < n).sum()),
            alpha=torch.full((NG_K,), 1.0 / NG_K, device=dev),
            eta=p.resolved_eta(), tau0=p.tau0, kappa=p.kappa, d=plan.d,
            corpus_size=float(n), max_inner=p.estep_max_inner,
            tol=p.estep_tol)

    draws = OnlineLDA(p)
    run = SimpleNamespace(n=n, k=NG_K)
    with shard_row_sums(torch, online_lda, GRID_J[1]):
        for it, pick in enumerate(rank0["C"]["replay_picks"]):
            lam = replay_iteration(it, pick, lam)
    replay_rel = lam_rel(rank0["C"]["replay_lam"], lam.cpu().numpy())
    lp_rel = abs(rank0["C"]["log_perplexity"] - log_perplexity_c) / abs(
        log_perplexity_c)
    res_c = public("C", "iteration")
    res_c.update(replay_iterations=J_REPLAY_ITERS,
                 replay_lam_max_rel_diff=replay_rel,
                 one_device_log_perplexity=log_perplexity_c,
                 log_perplexity_rel_diff=lp_rel,
                 ranks=ranks_of("C", "iteration", "lam_sum"))
    if not replay_rel <= 1e-3 or not lp_rel <= 0.03 or (
            res_c["layout"], res_c["gamma_backend"]) != ("tiles_resident",
                                                          "pallas_tiles"):
        raise AssertionError(f"config J-C: replay lambda {replay_rel}, "
                             f"logPerp {lp_rel}, {res_c['layout']}")
    summary["J_C"] = res_c

    # J-G against the 1x1 card fit from the seed, and that fit's spread,
    # each summing lambda's rows in the grid's order
    with shard_row_sums(torch, online_lda, GRID_J[1]):
        one = OnlineLDA(online_defaults(NG_K, seed)).fit(rows, vocab).lam
        repeat = max(lam_rel(OnlineLDA(online_defaults(NG_K, seed)).fit(
            rows, vocab).lam, one) for _ in range(2))
    g_rel = lam_rel(rank0["G"]["lam"], one)
    g_bound = max(1e-3, 2.0 * repeat)
    res_g = public("G", "iteration")
    draws = res_g.pop("draws")
    one_bsz = OnlineLDA(online_defaults(NG_K, seed, 0))
    one_bsz.fit(rows, vocab)
    res_g.update(lam_max_rel_diff=g_rel,
                 one_device_repeat_lam_max_rel_diff=repeat, lam_bound=g_bound,
                 one_device_bsz=one_bsz.last_batch_size, max_draw=max(draws),
                 docs_per_s=sum(draws) / res_g["fit_s"],
                 ranks=ranks_of("G", "iteration", "lam_sum"))
    # the grid rounds bsz up to the data shards; the draws stay under the
    # 1x1 bsz, so both fits see the same docs
    if not g_rel <= g_bound or res_g["bsz"] != -(
            -one_bsz.last_batch_size // n_data) * n_data or (
            max(draws) > one_bsz.last_batch_size) or (
            res_g["layout"], res_g["gamma_backend"]) != ("packed",
                                                         "pallas_tiles"):
        raise AssertionError(f"config J-G: lambda {g_rel} (bound {g_bound}),"
                             f" bsz {res_g['bsz']}, {res_g['layout']}")
    summary["J_G"] = res_g

    # J-D against the 1x1 card fits from the seed: after D's ten check
    # sweeps H and the loss (D's limits), after the 40 the loss.  H's
    # smallest entries keep shrinking under the multiplicative update, so
    # a summation-order difference grows relative to them: on the CPU,
    # where every fit repeats bit for bit, the grid's H after 40 sweeps is
    # 2.9e-3 from 1x1 (1.7e-4 after 10), in entries ~1e-5 of the largest
    def h_rel(got, want):
        floor = 1e-6 * float(np.abs(want).max())
        return float(np.max(np.abs(got - want)
                            / np.maximum(np.abs(want), floor)))

    one_d = NMF(nmf_params(seed)).fit(rows, vocab)
    one_check = NMF(nmf_params(seed, NMF_CHECK_ITERS)).fit(rows, vocab)
    check_rel = h_rel(rank0["D"]["check_h"], one_check.h)
    check_loss_rel = abs(rank0["D"]["check_loss"] - one_check.loss) / abs(
        one_check.loss)
    loss_rel = abs(rank0["D"]["loss"] - one_d.loss) / abs(one_d.loss)
    res_d = public("D", "sweep")
    res_d.update(check_sweeps=NMF_CHECK_ITERS, check_h_max_rel_diff=check_rel,
                 check_loss_rel_diff=check_loss_rel,
                 h_max_rel_diff=h_rel(rank0["D"]["h"], one_d.h),
                 one_device_loss=one_d.loss, loss_rel_diff=loss_rel,
                 ranks=ranks_of("D", "sweep", "loss"))
    if not check_rel <= 1e-3 or not check_loss_rel <= 1e-4 or not (
            loss_rel <= 1e-4) or res_d["mu_backend"] != "cuda_tiles":
        raise AssertionError(f"config J-D: H {check_rel} and loss "
                             f"{check_loss_rel} after {NMF_CHECK_ITERS} "
                             f"sweeps, loss {loss_rel} after {NMF_ITERS}, "
                             f"{res_d['mu_backend']}")
    summary["J_D"] = res_d
    for label, kern in (("C", "gamma_fixed_point_tiles"),
                        ("G", "gamma_fixed_point_tiles"),
                        ("D", "nmf_mu_update_tiles")):
        if any(r[label]["launches"][kern] == 0 for r in ranks):
            raise AssertionError(f"config J-{label}: a rank launched no "
                                 f"{kern}")


# ---- config K: one-process streaming through the CLI -----------------------
K_TRIGGER_FILES = 8            # --max-files-per-trigger: 51 books, 7 triggers
K_WAVE = 24                    # the interrupted run's first wave: 3 triggers
K_STREAM = ["--max-files-per-trigger", str(K_TRIGGER_FILES),
            "--poll-interval", "0.05", "--idle-timeout", "0.5"]


def book_distributions(text: str, k: int) -> dict:
    """{book name: its distribution} read back from a scoring report."""
    names = [line.split(": ", 1)[1] for line in text.splitlines()
             if line.startswith("Book's name: ")]
    return dict(zip(names, report_distributions(text, k)))


def watch_dir(books, root, names):
    """``names`` of ``books`` copied into the watch dir ``root``, each
    file's mtime its index in the sorted book list (one second apart):
    every run polls them in the same order."""
    os.makedirs(root, exist_ok=True)
    order = sorted(os.listdir(books))
    for name in names:
        dst = os.path.join(root, name)
        shutil.copyfile(os.path.join(books, name), dst)
        t = 1.6e9 + order.index(name)
        os.utime(dst, (t, t))
    return root


@contextlib.contextmanager
def stream_triggers(torch):
    """Inside the block, every micro-batch a streaming scorer or trainer
    processes is recorded as (class name, device, its file names, host
    seconds to the end of its device work, seconds in the text front
    end)."""
    from spark_text_clustering_tpu_torch import streaming

    seen, front = [], []
    vectorize = streaming._vectorize_quarantined

    def timed_vectorize(*args):
        t0 = time.perf_counter()
        out = vectorize(*args)
        front.append(time.perf_counter() - t0)
        return out

    def spy(cls):
        process = cls.process

        def timed(self, mb):
            del front[:]
            t0 = time.perf_counter()
            out = process(self, mb)
            dev = getattr(self, "device", None) or self.model.device
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            seen.append((cls.__name__, str(dev), list(mb.names),
                         time.perf_counter() - t0, sum(front)))
            return out

        return process, timed

    patched = [(cls, *spy(cls)) for cls in (streaming.StreamingScorer,
                                            streaming.StreamingOnlineLDA)]
    streaming._vectorize_quarantined = timed_vectorize
    for cls, _, timed in patched:
        cls.process = timed
    try:
        yield seen
    finally:
        streaming._vectorize_quarantined = vectorize
        for cls, process, _ in patched:
            cls.process = process


def trigger_stats(triggers):
    """ms a trigger (mean, range), docs/s over the triggers' seconds and
    the text front end's share of them."""
    secs = np.array([t[3] for t in triggers])
    docs = sum(len(t[2]) for t in triggers)
    return {"triggers": len(triggers),
            "ms_per_trigger": 1e3 * float(secs.mean()),
            "ms_per_trigger_range": [1e3 * float(secs.min()),
                                     1e3 * float(secs.max())],
            "docs_per_s": docs / float(secs.sum()),
            "front_end_share": float(sum(t[4] for t in triggers)
                                     / secs.sum())}


def stream_cli(label, argv, out_path):
    """A stream verb through ``cli.main``: (stdout, wall seconds).  Fails
    unless it exits 0."""
    rc, out, secs = run_cli(argv, out_path)
    if rc != 0:
        raise AssertionError(f"config {label}: {argv[0]} exited {rc}")
    return out, secs


def epoch_reports(out_dir, k):
    """{book: distribution} over every epoch report of a ledgered
    stream-score, and the reports' names."""
    names = sorted(os.listdir(out_dir))
    dists = {}
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            dists.update(book_distributions(f.read(), k))
    return dists, names


def dists_agree(label, got, want, limit):
    """Largest difference of two {book: distribution} maps over the same
    books, and the main topics wherever ``want``'s top two differ by more
    than 1e-2; fails beyond ``limit`` or on a differing main topic."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"config {label}: books {len(got)} against "
                             f"{len(want)}")
    g = np.stack([got[n] for n in sorted(want)])
    w = np.stack([want[n] for n in sorted(want)])
    diff = float(np.abs(g - w).max())
    top2 = np.sort(w, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-2
    agree = g.argmax(1) == w.argmax(1)
    if not diff <= limit or not agree[clear].all():
        raise AssertionError(f"config {label}: distributions differ by "
                             f"{diff}, main topics {agree.mean()}")
    return diff


def lineage_walk(label, argv, out_path):
    """``cli lineage <argv> --json`` in this process: (the report, wall
    seconds).  Fails unless it exits 0."""
    rc, out, secs = run_cli(["lineage", *argv, "--json"], out_path)
    if rc != 0:
        raise AssertionError(f"config {label}: lineage exited {rc}: "
                             f"{out[-1000:]}")
    return json.loads(out), secs


def lineage_failed(label, rep, want):
    """Raise naming the checks of ``want`` ({check: held}) that failed."""
    failed = sorted(k for k, held in want.items() if not held)
    if failed:
        raise AssertionError(
            f"config {label}: {failed} failed: "
            f"{json.dumps(rep, sort_keys=True)[:3000]}")


def k_serve_lineage(root, model_dir, stop, book, k_walk):
    """K-serve-lineage: ``model_dir`` served in this process on the card by
    the ``serving`` library (N's buckets and batch, a run stream), one
    ``book`` POSTed under a minted, sampled ``X-STC-Trace``; the response
    saved, then the service drained.  The served distribution must equal
    in bytes the card's per-doc scoring of the model on the book (N's
    contract), and ``lineage`` of the response and of the bare trace id,
    with the stream, must walk back to ``k_walk``'s publish epoch and
    sources, the request's spans all attributed and ``serve.topic_
    inference``'s dispatch digest among the served ones.  Returns (the
    record, the per-document kernel's launches in the serve)."""
    from spark_text_clustering_tpu_torch import load_model, telemetry
    from spark_text_clustering_tpu_torch.cli import _load_stop_words
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.pipeline import (
        TextPreprocessor, make_vectorizer,
    )
    from spark_text_clustering_tpu_torch.serving import (
        ScoringService, make_http_server,
    )
    from spark_text_clustering_tpu_torch.telemetry import tracing

    with open(book) as f:
        text = f.read()
    stop_words = _load_stop_words(stop)
    tel = os.path.join(root, "serve_lineage.jsonl")
    ctx = tracing.mint(sampled=True)
    t0 = time.perf_counter()
    _build.reset_launches()
    telemetry.configure(tel, device="cuda")
    try:
        service = ScoringService(
            os.path.dirname(model_dir), "EN", model=model_dir,
            stop_words=stop_words, max_batch=N_MAX_BATCH,
            token_buckets=N_BUCKETS, watch_model=False, device="cuda")
        telemetry.manifest(kind="serve", model=model_dir, lang="EN",
                           vocab_width=service.scorer.model.vocab_size)
        httpd = make_http_server(service, "127.0.0.1", 0)
        host, port = httpd.server_address[:2]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            status, _, body = http_json(
                f"http://{host}:{port}/score",
                {"texts": [text], "names": [os.path.basename(book)]},
                headers={tracing.HEADER: ctx.format()})
        finally:
            drained = service.begin_drain()
            httpd.shutdown()
            httpd.server_close()
            thread.join()
        telemetry.event("serve_drained", **drained)
    finally:
        telemetry.shutdown()
    serve_s = time.perf_counter() - t0
    launches = _build.LAUNCHES["topic_inference_segments"]
    if status != 200:
        raise AssertionError(f"config K-serve-lineage: POST {status}: "
                             f"{body}")
    response = os.path.join(root, "response.json")
    with open(response, "w") as f:
        json.dump(body, f)

    # N's contract on this book, outside the counted serve
    model = load_model(model_dir, device="cuda")
    rows = make_vectorizer(model.vocab)(TextPreprocessor(
        stop_words=stop_words).transform({"texts": [text]})["tokens"])
    want = np.asarray(model.topic_distribution(rows, convergence="per_doc"))
    got = served(body["results"])
    by_response, walk_s = lineage_walk(
        "K-serve-lineage", [response, "--telemetry", tel],
        os.path.join(root, "lineage_response.out"))
    by_trace, trace_s = lineage_walk(
        "K-serve-lineage", [ctx.trace_id, "--telemetry", tel],
        os.path.join(root, "lineage_trace.out"))
    spans = by_response.get("spans") or {}
    digests = {(d["label"], d["cache"])
               for d in by_response.get("compile_digests", ())}
    publish_epoch = k_walk["model"]["publish_epoch"]
    lineage_failed("K-serve-lineage", by_response, {
        "served bytes equal the per-doc scoring":
            got.tobytes() == want.tobytes(),
        "kind response": by_response["kind"] == "response",
        "resolved": by_response["lineage"] == "resolved",
        "the header's trace id": by_response.get("trace_id")
            == ctx.trace_id == body["trace"]["trace_id"],
        "spans all attributed": spans.get("unattributed") == 0,
        "serve.request among the spans":
            "serve.request" in spans.get("names", ()),
        "serve.topic_inference's digest, cache off":
            ("serve.topic_inference", "off") in digests,
        "the publish epoch": by_response.get("model", {}).get(
            "publish_epoch") == publish_epoch,
        "the sources": by_response.get("sources") == k_walk["sources"],
        "the trace id walks to the model": by_trace["kind"] == "trace"
            and by_trace.get("model", {}).get("dir") == model_dir
            and by_trace.get("model", {}).get("publish_epoch")
            == publish_epoch,
        "the trace id walks to the sources":
            by_trace.get("sources") == k_walk["sources"],
        "kernel launched": launches >= 1,
    })
    return {"serve_s": serve_s, "walk_s": walk_s, "trace_walk_s": trace_s,
            "trace_id": ctx.trace_id, "spans": spans,
            "digests": sorted(f"{lbl}:{c}" for lbl, c in digests),
            "launches": launches, "served_bytes_equal_per_doc": True,
            "degraded": by_response["degraded"]}, launches


def run_config_k(torch, seed, e):
    """One-process streaming through the CLI on config E's 51 books, with
    the verbs' defaults (batch capacity 8, 2^18 hash features, k=5) and 8
    files a trigger: 7 triggers.

    K-score: ``stream-score`` of E's card model with a ledger (7 epochs,
    every book in one committed record; each E-step launch held against
    its plain version) against ``stream-score --device cpu`` (5e-3) and
    against E's ``score`` on the card (5e-3, main topics where the top two
    differ by more than 1e-2); the same command again commits nothing.
    K-train: ``stream-train`` on the card against ``--device cpu`` from
    the same seed (lambda 1e-3 relative: ``index_add_`` adds with atomics
    on the card); an interrupted run (24 books, the stream ends idle, 27
    more, ``--resume``) against the uninterrupted one (the same
    micro-batches, lambda 1e-3, docs_seen 51, step 7, every book committed
    once); ``stream compact``, then ``--resume`` loads the same lambda bit
    for bit; the published model carries ``ledger_ref`` and scores on the
    card."""
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.models.persistence import (
        latest_model_dir,
    )
    from spark_text_clustering_tpu_torch.ops import _build, estep
    from spark_text_clustering_tpu_torch.resilience import EpochLedger

    root = os.path.join(e["root"], "K")
    books, stop = e["books"], e["stop"]
    names = sorted(os.listdir(books))
    watch = watch_dir(books, os.path.join(root, "watch"), names)
    card_model = latest_model_dir(os.path.join(e["root"], "models"), "EN")
    n_triggers = -(-len(names) // K_TRIGGER_FILES)

    # K-score on the card, every E-step launch recorded
    def stream_score(device, tag):
        out, secs = stream_cli("K", [
            "stream-score", "--watch-dir", watch, "--stop-words", stop,
            "--model", card_model, "--checkpoint-dir",
            os.path.join(root, f"sck_{tag}"), "--output-dir",
            os.path.join(root, f"so_{tag}"), "--device", device, *K_STREAM],
            os.path.join(root, f"score_{tag}.out"))
        return out, secs

    _build.reset_launches()
    with stream_triggers(torch) as triggers, \
            recorded(estep, "gamma_fixed_point_bkl") as score_seen:
        _, score_s = stream_score("cuda", "cuda")
    score_launches = dict(_build.LAUNCHES)
    score_triggers = list(triggers)
    ledger = EpochLedger(os.path.join(root, "sck_cuda"))
    records = ledger.records()
    sources = [s for r in records for s in r["sources"]]
    if (len(records) != n_triggers or sorted(sources) != sorted(
            os.path.join(watch, n) for n in names)
            or score_launches["gamma_fixed_point_bkl"] != n_triggers
            or len(score_seen) != n_triggers):
        raise AssertionError(f"config K-score: {len(records)} epochs, "
                             f"{len(sources)} sources, {score_launches}")
    card, report_names = epoch_reports(os.path.join(root, "so_cuda"), EN_K)
    _, cpu_score_s = stream_score("cpu", "cpu")
    cpu, _ = epoch_reports(os.path.join(root, "so_cpu"), EN_K)
    vs_cpu = dists_agree("K-score card vs CPU", card, cpu, 5e-3)
    vs_score = dists_agree("K-score vs score", card, book_distributions(
        e["card_report"], EN_K), 5e-3)
    again, _ = stream_score("cuda", "cuda")
    if len(ledger.records()) != n_triggers or "[batch" in again or len(
            ledger.committed_sources()) != len(names):
        raise AssertionError("config K-score: the rerun scored or committed")

    # K-train: the uninterrupted run on the card, the same on the CPU
    def stream_train(device, tag, watch_dir_, *extra):
        models = os.path.join(root, f"m_{tag}")
        out, secs = stream_cli("K", [
            "stream-train", "--watch-dir", watch_dir_, "--stop-words", stop,
            "--checkpoint-dir", os.path.join(root, f"ck_{tag}"),
            "--checkpoint-interval", "2", "--models-dir", models,
            "--seed", str(seed), "--device", device, *K_STREAM, *extra],
            os.path.join(root, f"train_{tag}.out"))
        return out, secs, latest_model_dir(models, "EN")

    # the uninterrupted run writes its telemetry, under a spawner's trace
    # context as a supervised worker would be
    from spark_text_clustering_tpu_torch.telemetry import tracing

    tel_path = os.path.join(root, "telemetry", "train_whole.jsonl")
    trace = tracing.mint(sampled=True)
    os.environ[tracing.ENV_CONTEXT] = trace.format()
    _build.reset_launches()
    try:
        with stream_triggers(torch) as triggers, \
                recorded(online_lda, "gamma_fixed_point_bkl") as train_seen:
            _, train_s, whole_dir = stream_train(
                "cuda", "whole", watch, "--telemetry-file", tel_path)
            # the interrupted run's two incarnations on a trace of their
            # own, as a supervised worker's would be (K-lineage walks it)
            wave_trace = tracing.mint(sampled=True)
            os.environ[tracing.ENV_CONTEXT] = wave_trace.format()
            tracing.install(None)
            whole_batches = [t[2] for t in triggers]
            train_triggers = list(triggers)
            wave = watch_dir(books, os.path.join(root, "watch_wave"),
                             names[:K_WAVE])
            first_out, _, _ = stream_train("cuda", "wave", wave)
            watch_dir(books, wave, names[K_WAVE:])
            resumed_out, _, resumed_dir = stream_train("cuda", "wave", wave,
                                                       "--resume")
            os.environ.pop(tracing.ENV_CONTEXT)
            tracing.install(None)
            wave_batches = [t[2] for t in triggers[len(whole_batches):]]
    finally:
        os.environ.pop(tracing.ENV_CONTEXT, None)
        tracing.install(None)
    train_launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    _, tel_events, tel_snap = telemetry_stream(tel_path)
    whole_recs = EpochLedger(os.path.join(root, "ck_whole")).records()
    batches = [e for e in tel_events if e["event"] == "micro_batch"]
    commits = tel_snap["counters"].get("ledger.commits")
    if (len(batches) != n_triggers
            or {b.get("trace_id") for b in batches} != {trace.trace_id}
            or {r.get("trace", {}).get("trace_id") for r in whole_recs}
            != {trace.trace_id} or commits != len(whole_recs)):
        raise AssertionError(
            f"config K telemetry: {len(batches)} micro_batch events of "
            f"{n_triggers} triggers, trace ids "
            f"{ {b.get('trace_id') for b in batches} } against "
            f"{trace.trace_id}, ledger.commits {commits} of "
            f"{len(whole_recs)} records")
    k_telemetry = {"micro_batches": len(batches), "ledger_commits": commits,
                   "records_traced": len(whole_recs),
                   "seconds": time.perf_counter() - t0}
    rel = [os.path.basename(p) for b in whole_batches for p in b]
    if ([[os.path.basename(p) for p in b] for b in wave_batches]
            != [[os.path.basename(p) for p in b] for b in whole_batches]
            or rel != names
            or train_launches["gamma_fixed_point_bkl"] != 2 * n_triggers
            or len(train_seen) != 2 * n_triggers):
        raise AssertionError(f"config K-train: micro-batches "
                             f"{wave_batches} against {whole_batches}, "
                             f"{train_launches}")
    if f"stream ended: {K_WAVE} docs / 3 micro-batches" not in first_out or (
            "committed epoch" not in resumed_out):
        raise AssertionError("config K-train: the interrupted run")
    _, cpu_train_s, cpu_dir = stream_train("cpu", "cpu", watch)

    def lam_of(path):
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return z["lam"]

    def rel_diff(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    lam = lam_of(whole_dir)
    cpu_rel = rel_diff(lam, lam_of(cpu_dir))
    resume_rel = rel_diff(lam_of(resumed_dir), lam)
    wave_led = EpochLedger(os.path.join(root, "ck_wave"))
    train_recs = [r for r in wave_led.records() if r.get("shards")]
    wave_sources = sorted(os.path.basename(s) for r in train_recs
                          for s in r["sources"])
    last = train_recs[-1]
    with open(os.path.join(resumed_dir, "meta.json")) as f:
        ledger_ref = json.load(f).get("ledger_ref")
    if not cpu_rel <= 1e-3 or not resume_rel <= 1e-3 or (
            wave_sources != names or last["docs_seen"] != len(names)
            or last["step"] != n_triggers
            or ledger_ref != {"dir": os.path.join(root, "ck_wave"),
                              "epoch": wave_led.last_committed()}):
        raise AssertionError(f"config K-train: card vs CPU {cpu_rel}, "
                             f"resumed {resume_rel}, {last}, {ledger_ref}")

    # K-lineage: the published model walked back to the wave's committed
    # sources, its publish epoch and the wave's trace
    walk, walk_s = lineage_walk("K-lineage", [resumed_dir],
                                os.path.join(root, "lineage.out"))
    trained = [r for r in wave_led.records() if r["kind"] != "model-publish"]
    walked = (walk.get("workers") or [{}])[0]
    pub = walk.get("model", {})
    lineage_failed("K-lineage", walk, {
        "kind model": walk["kind"] == "model",
        "resolved": walk["lineage"] == "resolved",
        "nothing degraded": walk["degraded"] == [],
        "the committed sources": walk.get("sources") == sorted(
            s_ for r in trained for s_ in r["sources"]),
        "the publish epoch": pub.get("publish_epoch") == ledger_ref["epoch"]
            == pub.get("publish", {}).get("epoch")
            == wave_led.last_committed(),
        "every epoch": len(walked.get("epochs", ())) == len(trained),
        "every epoch on the wave's trace": {
            row.get("trace_id") for row in walked.get("epochs", ())}
            == {wave_trace.trace_id},
    })
    # K-serve-lineage: a served response walked back the same way; the
    # replica's per-document launches join K's
    serve_lineage, serve_launches = k_serve_lineage(
        root, resumed_dir, stop, os.path.join(watch, names[0]), walk)

    # compaction: the resumed stream loads the same lambda bit for bit
    # (no new file: it trains nothing and publishes what it loaded)
    compact_out, _ = stream_cli("K", ["stream", "compact", "--checkpoint-dir",
                                      os.path.join(root, "ck_wave")],
                                os.path.join(root, "compact.out"))
    # the same walk over the snapshot: the same sources, the one
    # compaction note
    compacted, _ = lineage_walk("K-lineage", [resumed_dir],
                                os.path.join(root, "lineage_compacted.out"))
    notes = compacted["degraded"]
    lineage_failed("K-lineage compacted", compacted, {
        "the same sources": compacted.get("sources") == walk["sources"],
        "resolved": compacted["lineage"] == "resolved",
        "one compaction note": len(notes) == 1 and "compacted" in notes[0],
        "the pinned publish": compacted.get("model", {}).get(
            "publish", {}).get("compacted") is True,
    })
    _, _, compacted_dir = stream_train("cuda", "wave", wave, "--resume")
    if not np.array_equal(lam_of(compacted_dir), lam_of(resumed_dir)) or (
            len(wave_led.records()) != 2):
        raise AssertionError("config K: the compacted ledger resumed "
                             "another lambda")
    _build.reset_launches()
    published, _ = cli_score("K", books, stop, "cuda",
                             os.path.join(root, "published_out"),
                             os.path.join(root, "published.out"),
                             ["--model", resumed_dir])
    published_launches = dict(_build.LAUNCHES)
    check_distribution(np.stack(list(book_distributions(
        published, EN_K).values())), len(names), EN_K, "K-published")

    # every E-step launch of the streams against its plain version; the
    # widest scoring and training launches timed
    cases = []
    for label, seen in (("score", score_seen), ("train", train_seen)):
        widest = max(range(len(seen)), key=lambda i: seen[i][0][0].shape[2])
        for i, (args, _) in enumerate(seen):
            cases.append({"run": label, "launch": i, **estep_case(
                torch, *args[:4], f"K_{label}_{i}", timed=i == widest)})
    del score_seen, train_seen
    launches = {name: score_launches[name] + train_launches[name]
                + published_launches[name] for name in score_launches}
    launches["topic_inference_segments"] += serve_launches
    return {
        "phase": "config_K", "books": len(names),
        "files_per_trigger": K_TRIGGER_FILES, "k": EN_K,
        "hash_features": 1 << 18, "batch_capacity": 8,
        "score": {**trigger_stats(score_triggers), "seconds": score_s,
                  "cpu_seconds": cpu_score_s,
                  "epochs_committed": len(records),
                  "reports": len(report_names),
                  "row_len": [c["shape"][2] for c in cases
                              if c["run"] == "score"],
                  "max_dist_diff_vs_cpu": vs_cpu,
                  "max_dist_diff_vs_score": vs_score},
        "train": {**trigger_stats(train_triggers), "seconds": train_s,
                  "cpu_seconds": cpu_train_s,
                  "row_len": [c["shape"][2] for c in cases
                              if c["run"] == "train"][:n_triggers],
                  "epochs_committed": len(EpochLedger(
                      os.path.join(root, "ck_whole")).records()),
                  "lam_max_rel_diff_vs_cpu": cpu_rel,
                  "lam_max_rel_diff_resumed": resume_rel,
                  "resumed_docs_seen": last["docs_seen"],
                  "resumed_step": last["step"],
                  "compact": compact_out.strip(),
                  "compacted_resume_bit_equal": True},
        "telemetry": k_telemetry,
        "lineage": {"seconds": walk_s, "sources": len(walk["sources"]),
                    "epochs": len(walked["epochs"]),
                    "publish_epoch": pub["publish_epoch"],
                    "trace_id": wave_trace.trace_id,
                    "compacted_degraded": notes, "serve": serve_lineage},
        "launches": launches, "score_launches": score_launches,
        "train_launches": train_launches,
        "published_score_launches": published_launches,
        "kernel": {"launches": len(cases),
                   "max_abs_err": max(c["max_abs_err"] for c in cases),
                   "widest": [c for c in cases if c["ms"] is not None]},
        "bounds": {"max_dist_diff": 5e-3, "lam_max_rel_diff": 1e-3},
    }


L_FLEET = ["--heartbeat-interval", "0.2", "--lease-timeout", "5.0",
           "--grace-seconds", "1.0", "--sweep-interval", "0.15",
           "--poll-interval", "0.05", "--idle-timeout", "0.8",
           "--max-files-per-trigger", "1"]
_FLEET_SUMMARY = re.compile(
    r"fleet converged: (\d+) committed epoch\(s\) across (\d+) worker\(s\) "
    r"— (\d+) spawn\(s\), (\d+) respawn\(s\), (\d+) resize\(s\), (\d+) "
    r"lease expiry\(ies\), (\d+) preemption\(s\) survived, (\d+) crash")


@contextlib.contextmanager
def lease_watch(fleet):
    """Inside the block, a thread reads the fleet's lease files every 10
    ms: {(worker, spawn id): [first lease ts, last ts of a live renewal]}."""
    seen, stop = {}, threading.Event()
    leases = os.path.join(fleet, "leases")

    def poll():
        while not stop.is_set():
            try:
                names = os.listdir(leases)
            except FileNotFoundError:
                names = []
            for name in names:
                try:
                    with open(os.path.join(leases, name)) as f:
                        lease = json.load(f)
                except (OSError, ValueError):
                    continue            # mid-rename
                key = (int(lease["worker"]), int(lease["spawn_id"]))
                ts = float(lease["ts"])
                first, last = seen.setdefault(key, [ts, ts])
                seen[key] = [min(first, ts),
                             last if lease.get("done") else max(last, ts)]
            stop.wait(0.01)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()


def fleet_tree(out_dir):
    """{path under the report root: bytes} of a fleet's reports."""
    tree = {}
    for d, _, files in os.walk(out_dir):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                tree[os.path.relpath(path, out_dir)] = f.read()
    return tree


def fleet_exactly_once(label, fleet, watch):
    """Every file of ``watch`` committed once across the worker ledgers
    of ``fleet``: fails on a file committed twice, lost or foreign."""
    from spark_text_clustering_tpu_torch.resilience import EpochLedger
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        fleet_committed_sources,
    )

    per = [s for n in sorted(os.listdir(fleet))
           if n.startswith("w") and os.path.isdir(os.path.join(fleet, n))
           for r in EpochLedger(os.path.join(fleet, n)).records()
           for s in r.get("sources", ())]
    want = {os.path.join(watch, n) for n in os.listdir(watch)}
    if len(per) != len(set(per)) or fleet_committed_sources(fleet) != want:
        raise AssertionError(f"config {label}: {len(per)} commits of "
                             f"{len(set(per))} files, {len(want)} watched")
    return len(per)


@contextlib.contextmanager
def beside(fn):
    """``fn()`` on a thread while the block runs (two fleets' start-ups
    overlap); yields a dict that holds its result under "out" once the
    block has ended, and raises again what ``fn`` raised."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except Exception as exc:  # noqa: BLE001 - raised again below
            box["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        yield box
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]


def run_fleet(label, argv, root):
    """``supervise`` with ``argv`` as a subprocess of the port's CLI (its
    workers on the card: no --device) in a session of its own, killed
    whole if it outlives 600 s.  Returns the fleet's wall seconds, its
    report counts, and per incarnation the seconds from its spawn record
    to its first lease beat, with the lease times seen."""
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        FleetLedger,
    )

    fleet = argv[argv.index("--fleet-dir") + 1]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("STC_FAULTS", "STC_FAULT_SEED")}
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    with lease_watch(fleet) as beats, \
            open(os.path.join(root, f"{label}.out"), "w+") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             "supervise", *argv], cwd=here, env=env, stdout=out,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        rc = None
        try:
            rc = proc.wait(timeout=600)
        finally:
            if rc != 0:
                # a worker left behind (a hung one) dies with its session
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        secs = time.perf_counter() - t0
        out.seek(0)
        text = out.read()
    if rc != 0:
        raise AssertionError(f"config {label}: supervise exited {rc}: "
                             f"{text[-2000:]}")
    m = _FLEET_SUMMARY.search(text)
    if m is None:
        raise AssertionError(f"config {label}: no fleet summary: "
                             f"{text[-2000:]}")
    keys = ("committed_epochs", "final_workers", "spawns", "respawns",
            "resizes", "lease_expiries", "preemptions", "crashes")
    counts = dict(zip(keys, map(int, m.groups())))
    records = FleetLedger(fleet).records()
    spawned = {}
    for rec in records:
        for w, sid in rec["spawn_ids"].items():
            spawned.setdefault((int(w), int(sid)), rec["ts"])
    return {
        "seconds": secs, "counts": counts,
        "records": [r["kind"] for r in records],
        "first_beat_s": {f"w{w}/s{sid}": beats[(w, sid)][0] - ts
                         for (w, sid), ts in sorted(spawned.items())
                         if (w, sid) in beats},
        "beats": beats, "spawned": spawned, "fleet_records": records,
    }


@contextlib.contextmanager
def collector(collect_dir, out_path):
    """``cli collect --dir collect_dir`` as a subprocess of the port's CLI
    for the block: yields its announce ({"host", "port", ...}); SIGTERM at
    the end, which must drain it with exit code 0 and its summary line."""
    from spark_text_clustering_tpu_torch.telemetry import transport

    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "STC_SHIP_TO"}
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with open(out_path, "w+") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             "collect", "--dir", collect_dir], cwd=here, env=env,
            stdout=out, stderr=subprocess.STDOUT, text=True)
        try:
            yield transport.read_collect_announce(collect_dir, wait_s=120.0)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = None
            out.seek(0)
            text = out.read()
    if rc != 0 or "collector drained:" not in text:
        raise AssertionError(f"collect exited {rc}: {text[-2000:]}")


def fleet_telemetry(label, sup_path, worker_dir, collect_dir, run, killed):
    """The fleet's telemetry, read without the JAX package: one local
    stream a worker incarnation (``worker-wNNN-sSS.jsonl``); the
    supervisor's spawn, respawn, crash and lease-expiry events equal to
    the fleet report's counts; every event that carries a trace id, in
    every stream, on the supervisor's trace (its fence records'); and the
    collector holding one stream a worker incarnation plus the
    supervisor's, each its local stream folded exactly once (no (source
    id, seq) twice; an incarnation the fleet killed, ``killed``, may lose
    the tail its shipper had not sent, or all of it where it was killed
    before its shipper's first batch)."""
    from spark_text_clustering_tpu_torch.telemetry import read_events

    want = {f"worker-w{w:03d}-s{sid}" for w, sid in run["spawned"]}
    sup = os.path.splitext(os.path.basename(sup_path))[0]
    local = {sup: read_events(sup_path)}
    for name in os.listdir(worker_dir):
        local[os.path.splitext(name)[0]] = read_events(
            os.path.join(worker_dir, name))
    if set(local) != want | {sup}:
        raise AssertionError(f"config {label}: worker streams {sorted(local)}"
                             f", incarnations {sorted(want)}")
    events = local[sup]
    counts = {key: sum(e["event"] == name for e in events)
              for key, name in (("spawns", "fleet_spawn"),
                                ("respawns", "fleet_respawn"),
                                ("crashes", "fleet_crash"),
                                ("lease_expiries", "fleet_lease_expired"))}
    if any(counts[key] != run["counts"][key] for key in counts):
        raise AssertionError(f"config {label}: supervisor events {counts}, "
                             f"report {run['counts']}")
    (trace,) = {r["trace_id"] for r in run["fleet_records"]
                if "trace_id" in r}
    folded, batches = {}, 0
    for name in os.listdir(collect_dir):
        if not name.endswith(".jsonl"):
            continue
        with open(os.path.join(collect_dir, name)) as f:
            recs = [json.loads(line) for line in f]
        seqs = [r["seq"] for r in recs if r["event"] == "collect_batch"]
        if len(seqs) != len(set(seqs)) or not seqs:
            raise AssertionError(f"config {label}: {name} folds seqs {seqs}")
        batches += len(seqs)
        stems = [s for s in local if name.endswith(f"-{s}.jsonl")]
        if len(stems) != 1 or stems[0] in folded:
            raise AssertionError(f"config {label}: collected {name}")
        recs = [r for r in recs if r["event"] != "collect_batch"]
        for key in ("source_id", "collect_recv_ts"):
            recs[0].pop(key, None)
        folded[stems[0]] = recs
    if not set(local) - set(killed) <= set(folded) <= set(local):
        raise AssertionError(f"config {label}: collected {sorted(folded)} "
                             f"of {sorted(local)}")
    for stem, recs in folded.items():
        mine = local[stem]
        if stem in killed:
            mine = mine[:len(recs)]
        traces = {e["trace_id"] for e in (*mine, *recs) if "trace_id" in e}
        if recs != mine or traces != {trace}:
            raise AssertionError(f"config {label}: {stem} folded "
                                 f"{len(recs)} of {len(local[stem])} "
                                 f"records, traces {traces} vs {trace}")
    return {"streams": len(folded), "batches": batches, "trace_id": trace,
            "supervisor_events": counts,
            "records": {stem: len(r) for stem, r in sorted(folded.items())},
            "local_records": {stem: len(r) for stem, r in sorted(local.items())}}


def time_to_recover(run, fleet, worker=0):
    """Seconds from the faulted incarnation's last live lease renewal (its
    last sign of life before the fault) to the first epoch its respawned
    incarnation committed."""
    from spark_text_clustering_tpu_torch.resilience import EpochLedger

    (respawn,) = [r for r in run["fleet_records"]
                  if r["kind"] == "respawn" and r["worker"] == worker]
    new_id = int(respawn["spawn_ids"][str(worker)])
    faulted = min(sid for w, sid in run["spawned"] if w == worker)
    first_commit = min(r["ts"] for r in EpochLedger(
        os.path.join(fleet, f"w{worker:03d}")).records()
        if r.get("spawn_id") == new_id)
    return first_commit - run["beats"][(worker, faulted)][1]


def run_config_l(torch, seed, e, smi):
    """The supervised stream fleet on the card, on config E's 51 books
    with the stream verbs' widths (batch capacity 8, 2^18 hash features,
    k=5) and one file a trigger, so that a report's bytes are a function
    of its book: ``python -m spark_text_clustering_tpu_torch.cli
    supervise`` as a subprocess, no --device, so every worker runs on the
    card.

    L-score (2 workers): every book committed once across w000/ and w001/,
    each distribution within 5e-3 of K's card ``stream-score`` and of E's
    ``score``.  L-kill and L-hang, in one fleet to save a fleet's start-up:
    worker 0 killed at its first commit, worker 1 hung at its third lease
    beat (lease expiry, SIGTERM, SIGKILL of a process that holds a CUDA
    context): the report tree byte equal to L-score's, exactly once, two
    respawns, one crash, one lease expiry.  Both fleets write their
    telemetry and ship it to a ``collect`` subprocess (``fleet_telemetry``).
    L-resize (2 -> 3 workers after 2 committed epochs, worker 0 hung at
    its fourth beat): the multiset of reports equal to L-score's, exactly
    once, a resize record.  L-train (2 ``stream-train`` workers, a kill at
    worker 0's first commit): exactly once; each worker's published model
    loads and scores on the card, and its lambda is within 1e-3 relative
    of one process training the same partition on the card.  The kernel:
    worker 0's own command, in this process, under a fleet dir holding one
    spawn record, with the counts at 0: every E-step launch held against
    its plain version and its reports byte equal to L-score's w000.  The
    four fleets run at once (``beside``), so their start-ups overlap; each
    fleet's seconds, first beats and time to recover are read with the
    others' processes on the host and the card."""
    from spark_text_clustering_tpu_torch import Params, cli, load_model
    from spark_text_clustering_tpu_torch.models.persistence import (
        latest_model_dir,
    )
    from spark_text_clustering_tpu_torch.ops import _build, estep
    from spark_text_clustering_tpu_torch.resilience import EpochLedger
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        FleetLedger,
    )
    from spark_text_clustering_tpu_torch.streaming import (
        FileStreamSource, MicroBatch, StreamingOnlineLDA, StreamingScorer,
    )

    root = os.path.join(e["root"], "L")
    os.makedirs(root)
    books, stop = e["books"], e["stop"]
    names = sorted(os.listdir(books))
    watch = watch_dir(books, os.path.join(root, "watch"), names)
    card_model = latest_model_dir(os.path.join(e["root"], "models"), "EN")

    def score_argv(tag, workers=2, *extra, fleet=None):
        return ["--role", "stream-score", "--watch-dir", watch,
                "--fleet-dir", fleet or os.path.join(root, f"fleet_{tag}"),
                "--workers", str(workers), *L_FLEET, "--stop-words", stop,
                "--model", card_model, "--output-dir",
                os.path.join(root, f"out_{tag}"), *extra]

    runs, telemetry_l = {}, {}

    def fleet(tag, argv):
        runs[tag] = run_fleet(f"L-{tag}", argv, root)
        return runs[tag]["counts"], fleet_tree(os.path.join(root,
                                                            f"out_{tag}"))

    def fleet_with_telemetry(tag, workers, *extra, killed=()):
        """``fleet`` with the supervisor's stream, one a worker
        incarnation, all shipped to a collector, then read back."""
        sup = os.path.join(root, f"sup_{tag}.jsonl")
        wdir = os.path.join(root, f"wtel_{tag}")
        cdir = os.path.join(root, f"collect_{tag}")
        with collector(cdir, os.path.join(root, f"collect_{tag}.out")) as ann:
            out = fleet(tag, score_argv(
                tag, workers, *extra, "--telemetry-file", sup,
                "--worker-telemetry-dir", wdir,
                "--ship-to", f"{ann['host']}:{ann['port']}"))
        telemetry_l[tag] = fleet_telemetry(f"L-{tag}", sup, wdir, cdir,
                                           runs[tag], set(killed))
        return out

    # L-score, uninterrupted, with the fleet's telemetry: every stream
    # collected whole.  Beside it: L-kill and L-hang in one fleet, worker 0
    # killed at its first commit, worker 1 hung at its third lease beat,
    # byte equal, with the fleet's telemetry (the killed and the hung
    # incarnation may lose what their shippers had not sent); L-resize (2
    # -> 3 workers with a hung worker); L-train (2 stream-train workers, a
    # kill at worker 0's first commit).  The four fleets' start-ups overlap
    models = os.path.join(root, "models_train")
    with beside(lambda: fleet_with_telemetry(
            "faults", 2, "--chaos-worker", "0:ledger.commit:kill@1",
            "--chaos-worker", "1:worker.heartbeat:hang@3",
            killed=("worker-w000-s0", "worker-w001-s1"))) as faults, \
            beside(lambda: fleet("resize", score_argv(
                "resize", 2, "--resize-at", "2:3", "--chaos-worker",
                "0:worker.heartbeat:hang@4"))) as resize, \
            beside(lambda: fleet("train", [
                "--role", "stream-train", "--watch-dir", watch,
                "--fleet-dir", os.path.join(root, "fleet_train"),
                "--workers", "2", *L_FLEET, "--stop-words", stop, "--seed",
                str(seed), "--models-dir", models, "--chaos-worker",
                "0:ledger.commit:kill@1"])) as train:
        counts, ref = fleet_with_telemetry("score", 2)
    fleet_exactly_once("L-score", os.path.join(root, "fleet_score"), watch)
    dists = {}
    for text in ref.values():
        dists.update(book_distributions(text.decode(), EN_K))
    k_card, _ = epoch_reports(os.path.join(e["root"], "K", "so_cuda"), EN_K)
    vs_k = dists_agree("L-score vs K", dists, k_card, 5e-3)
    vs_score = dists_agree("L-score vs score", dists, book_distributions(
        e["card_report"], EN_K), 5e-3)
    if len(ref) != len(names) or {p.split(os.sep)[0] for p in ref} != {
            "w000", "w001"} or counts["respawns"] or counts["spawns"] != 2:
        raise AssertionError(f"config L-score: {len(ref)} reports, {counts}")

    counts, tree = faults["out"]
    fleet_exactly_once("L-faults", os.path.join(root, "fleet_faults"), watch)
    if tree != ref or (counts["respawns"], counts["crashes"],
                       counts["lease_expiries"]) != (2, 1, 1):
        raise AssertionError(f"config L-faults: reports equal {tree == ref}"
                             f", {counts}")
    recover = {tag: time_to_recover(runs["faults"], os.path.join(
        root, "fleet_faults"), worker) for tag, worker in (("kill", 0),
                                                           ("hang", 1))}

    # L-resize
    counts, tree = resize["out"]
    fleet_exactly_once("L-resize", os.path.join(root, "fleet_resize"), watch)
    if sorted(tree.values()) != sorted(ref.values()) or (
            counts["resizes"] != 1 or "resize" not in runs["resize"]["records"]
            or counts["final_workers"] != 3):
        raise AssertionError(f"config L-resize: {counts}, "
                             f"{runs['resize']['records']}")

    # L-train
    counts, _ = train["out"]
    fleet_exactly_once("L-train", os.path.join(root, "fleet_train"), watch)
    if counts["respawns"] != 1:
        raise AssertionError(f"config L-train: {counts}")
    stop_words = cli._load_stop_words(stop)
    texts = []
    for name in names[:2]:
        with open(os.path.join(watch, name)) as f:
            texts.append(f.read())
    train_rel = []
    for w in range(2):
        published = latest_model_dir(os.path.join(models, f"w{w:03d}"), "EN")
        model = load_model(published, device="cuda")
        out = StreamingScorer(model, stop_words=stop_words,
                              keep_results=False).process(
            MicroBatch(0, names[:2], texts))
        check_distribution(np.stack([sd.distribution for sd in out]), 2,
                           EN_K, f"L-train w{w:03d} model")
        one = StreamingOnlineLDA(
            Params(k=EN_K, algorithm="online", seed=seed),
            num_features=1 << 18, stop_words=stop_words, device="cuda")
        one.run(FileStreamSource(watch, max_files_per_trigger=1,
                                 partition=(w, 2)),
                poll_interval=0.05, idle_timeout=0.5)
        want = one.model().lam
        want = np.asarray(want, np.float64)
        train_rel.append(float(np.max(np.abs(np.asarray(model.lam) - want)
                                      / np.abs(want))))
    if not max(train_rel) <= 1e-3:
        raise AssertionError(f"config L-train: lambda {train_rel}")

    # L-lineage: worker 0's model walked over the whole fleet's ledgers
    fleet_train = os.path.join(root, "fleet_train")
    walk, walk_s = lineage_walk("L-lineage", [
        latest_model_dir(os.path.join(models, "w000"), "EN"), "--fleet-dir",
        fleet_train], os.path.join(root, "lineage.out"))
    fleet_recs = FleetLedger(fleet_train).records()
    respawns = [r for r in fleet_recs if r["kind"] == "respawn"]
    respawn = respawns[-1] if respawns else {}
    # the supervisor's trace rides its spawn sets (both packages)
    sup_traces = {r["trace_id"] for r in fleet_recs if "trace_id" in r}
    ledgers = [EpochLedger(os.path.join(fleet_train, f"w{w:03d}")).records()
               for w in range(2)]
    w0_publish = [r for r in ledgers[0] if r["kind"] == "model-publish"]
    walked = walk.get("workers", [])
    publish = walk.get("model", {}).get("publish", {})
    books_once = sorted(os.path.join(watch, n) for n in names)
    lineage_failed("L-lineage", walk, {
        "2 workers": [w.get("worker") for w in walked] == [0, 1],
        "resolved": walk["lineage"] == "resolved",
        "nothing degraded": walk["degraded"] == [],
        "the sources union": walk.get("sources") == books_once,
        "every book once": sorted(
            s_ for w in walked for s_ in w["sources"]) == books_once,
        "each worker's committed sources": [w["sources"] for w in walked]
            == [sorted({s_ for r in recs for s_ in r.get("sources", ())})
                for recs in ledgers],
        "published in worker 0's ledger": walked[:1] != []
            and walked[0].get("publish") == publish and len(w0_publish) == 1
            and publish.get("epoch") == w0_publish[0]["epoch"]
            == walk["model"].get("publish_epoch"),
        "by the respawned incarnation": len(respawns) == 1
            and respawn.get("worker") == 0
            and (publish.get("worker"), publish.get("generation"),
                 publish.get("spawn_id")) == (
                0, respawn.get("generation"),
                respawn.get("spawn_ids", {}).get("0")),
        "every epoch on the supervisor's trace": len(sup_traces) == 1
            and {row.get("trace_id") for w in walked for row in w["epochs"]}
            == sup_traces,
    })
    l_lineage = {"seconds": walk_s, "sources": len(walk["sources"]),
                 "epochs": [len(w["epochs"]) for w in walked],
                 "publish": {k: publish.get(k) for k in (
                     "epoch", "worker", "generation", "spawn_id")},
                 "trace_id": next(iter(sup_traces))}

    # the kernel on L's path: worker 0's own command in this process
    own = os.path.join(root, "inproc")
    FleetLedger(os.path.join(own, "fleet")).append(
        kind="spawn", generation=0, worker_count=2, spawn_ids={0: 0, 1: 1})
    sv = cli.build_parser().parse_args(["supervise", *score_argv(
        "inproc", fleet=os.path.join(own, "fleet"))])
    argv = cli._worker_argv(sv, 0, 2, 0, 0)
    if argv[2:4] != ["spark_text_clustering_tpu_torch.cli", "stream-score"]:
        raise AssertionError(f"config L: worker argv {argv}")
    _build.reset_launches()
    with stream_triggers(torch) as triggers, \
            recorded(estep, "gamma_fixed_point_bkl") as seen:
        _, inproc_s = stream_cli("L", argv[3:],
                                 os.path.join(root, "inproc.out"))
    launches = dict(_build.LAUNCHES)
    mine = {p: b for p, b in ref.items() if p.startswith("w000")}
    inproc = fleet_tree(os.path.join(root, "out_inproc"))
    if inproc != mine or launches["gamma_fixed_point_bkl"] != len(mine) or (
            len(seen) != len(mine) or len(triggers) != len(mine)):
        raise AssertionError(f"config L: in-process worker 0 reports equal "
                             f"{inproc == mine}, {len(mine)} files, "
                             f"{launches}")
    widest = max(range(len(seen)), key=lambda i: seen[i][0][0].shape[2])
    cases = [{"launch": i, **estep_case(torch, *args[:4], f"L_{i}",
                                        timed=i == widest)}
             for i, (args, _) in enumerate(seen)]
    del seen
    fleets = {}
    for tag, run in runs.items():
        fleets[tag] = {
            "seconds": run["seconds"],
            "books_per_s": len(names) / run["seconds"],
            **run["counts"], "fleet_records": run["records"],
            "first_beat_s": run["first_beat_s"]}
        emit({"phase": f"config_L_{tag}", "card": smi, **fleets[tag],
              **({"time_to_recover_s": recover} if tag == "faults"
                 else {})})
    return {
        "phase": "config_L", "card": smi, "books": len(names),
        "files_per_trigger": 1, "k": EN_K, "hash_features": 1 << 18,
        "batch_capacity": 8, "fleets": fleets,
        "time_to_recover_s": recover, "fleet_telemetry": telemetry_l,
        "max_dist_diff_vs_k": vs_k, "max_dist_diff_vs_score": vs_score,
        "train_lam_max_rel_diff": train_rel, "lineage": l_lineage,
        "inproc_worker": {**trigger_stats(triggers), "seconds": inproc_s,
                          "reports_byte_equal": True},
        "launches": launches,
        "kernel": {"launches": len(cases),
                   "max_abs_err": max(c["max_abs_err"] for c in cases),
                   "widest": [c for c in cases if c["ms"] is not None],
                   "shapes": sorted({tuple(c["shape"]) for c in cases})},
        "bounds": {"max_dist_diff": 5e-3, "lam_max_rel_diff": 1e-3},
    }


def pid_alive(pid: int) -> bool:
    """Whether process ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _proc_table():
    """{pid: (parent pid, argv)} of this host's live processes."""
    out = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                argv = [a.decode(errors="replace")
                        for a in f.read().split(b"\0")]
        except OSError:
            continue
        if fields[0] != "Z":
            out[int(name)] = (int(fields[1]), argv)
    return out


@contextlib.contextmanager
def rank_watch(fleet):
    """Inside the block, a thread lists this host's processes every 20 ms:
    each worker command of ``fleet`` (its argv names the fleet dir) and
    each process it spawned (a grid worker's ranks), as {(worker, spawn
    id): {pid: [first seen, last seen, whether a spawned rank]}} in wall
    seconds."""
    seen, stop = {}, threading.Event()

    def poll():
        while not stop.is_set():
            now, table, workers = time.time(), _proc_table(), {}
            for pid, (_, argv) in table.items():
                if fleet in argv and "--fleet-spawn-id" in argv:
                    workers[pid] = (
                        int(argv[argv.index("--worker-index") + 1]),
                        int(argv[argv.index("--fleet-spawn-id") + 1]))
            for pid, (ppid, argv) in table.items():
                key = workers.get(pid) or workers.get(ppid)
                if key is not None:
                    span = seen.setdefault(key, {}).setdefault(
                        pid, [now, now, "--multiprocessing-fork" in argv])
                    span[1] = now
            stop.wait(0.02)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()


def orphans_after_respawn(fleet, procs, worker=0):
    """The processes of ``worker``'s first incarnation (seen by
    ``rank_watch``) against the first epoch its respawn committed: how
    many there were, how many were grid ranks, the ones still seen alive
    at or after that commit, and the seconds from the last one seen to the
    commit."""
    from spark_text_clustering_tpu_torch.resilience import EpochLedger
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        FleetLedger,
    )

    records = FleetLedger(fleet).records()
    first = int(records[0]["spawn_ids"][str(worker)])
    (respawn,) = [r for r in records
                  if r["kind"] == "respawn" and r["worker"] == worker]
    new_id = int(respawn["spawn_ids"][str(worker)])
    commit = min(r["ts"] for r in EpochLedger(os.path.join(
        fleet, f"w{worker:03d}")).records() if r.get("spawn_id") == new_id)
    old = procs.get((worker, first), {})
    return {"processes": len(old),
            "ranks": sum(1 for _, _, rank in old.values() if rank),
            "alive_after_respawn_commit": sorted(
                pid for pid, (_, last, _) in old.items() if last >= commit),
            "last_seen_to_respawn_commit_s": commit - max(
                (last for _, last, _ in old.values()), default=commit)}


# ---- config M: streaming on the (data, model) grid --------------------------
M_FLAGS = ["--data-shards", "2", "--model-shards", "2", "--dist-backend",
           "gloo"]


def m_rank(grid, body_name, args):
    """One rank of a config M command: the CLI's own rank function
    (``cli._grid_rank``) under spies.  On rank 0 each trigger (``process``)
    is timed to the end of its device work, with its text front end and
    its collectives (the grid's ``all_reduce``s, synchronized, and the
    trainer's broadcasts); every rank's E-step launches are recorded.
    After the command each recorded launch is held against its plain
    version, those launches left out of the counts.  Returns (the exit
    code, the rank's stats)."""
    import torch

    from spark_text_clustering_tpu_torch import cli, streaming
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.ops import _build

    trainer = streaming.StreamingOnlineLDA
    share, process = trainer._share, trainer.process
    vectorize = streaming._vectorize_quarantined
    shares = {"calls": 0, "seconds": 0.0}
    front, triggers = [], []

    def collective_s():
        return grid.stats["seconds"] + shares["seconds"]

    def timed_share(self, msg=None):
        t0 = time.perf_counter()
        try:
            return share(self, msg)
        finally:
            shares["calls"] += 1
            shares["seconds"] += time.perf_counter() - t0

    def timed_vectorize(*a):
        t0 = time.perf_counter()
        out = vectorize(*a)
        front.append(time.perf_counter() - t0)
        return out

    def timed_process(self, mb=None):
        del front[:]
        c0, t0 = collective_s(), time.perf_counter()
        out = process(self, mb)
        torch.cuda.synchronize()
        triggers.append(("StreamingOnlineLDA", "cuda", list(mb.names),
                         time.perf_counter() - t0, sum(front),
                         collective_s() - c0))
        return out

    trainer._share, trainer.process = timed_share, timed_process
    streaming._vectorize_quarantined = timed_vectorize
    grid.timed = True
    try:
        with recorded(online_lda, "gamma_fixed_point_bkl") as seen:
            rc = cli._grid_rank(grid, body_name, args)
    finally:
        trainer._share, trainer.process = share, process
        streaming._vectorize_quarantined = vectorize
        grid.timed = False
    launches = dict(_build.LAUNCHES)
    widest = max(range(len(seen)), key=lambda i: seen[i][0][0].shape[2],
                 default=None)
    cases = [{"rank": grid.rank, "launch": i, **estep_case(
        torch, *a[:4], f"M_{grid.rank}_{i}", timed=i == widest)}
        for i, (a, _) in enumerate(seen)]
    del seen
    _build.LAUNCHES.update(launches)
    return rc, {"rank": grid.rank, "triggers": triggers, "shares": shares,
                "all_reduce": dict(grid.stats), "launches": launches,
                "cases": cases}


@contextlib.contextmanager
def m_grid_spy():
    """Inside the block, a grid command run through ``cli.main`` in this
    process spawns its ranks under ``m_rank`` (which runs the CLI's own
    rank function); each command's seconds from spawn to result and its
    ranks' stats are appended to the yielded list."""
    from spark_text_clustering_tpu_torch import cli

    run_grid, runs = cli.run_grid, []

    def spied(fn, d, m, args, **kw):
        t0 = time.perf_counter()
        out = run_grid(m_rank, d, m, args, **kw)
        runs.append({"grid_s": time.perf_counter() - t0,
                     "ranks": [stats for _, stats in out]})
        return [rc for rc, _ in out]

    cli.run_grid = spied
    try:
        yield runs
    finally:
        cli.run_grid = run_grid


def m_partition_rank(grid, watch, stop, seed):
    """One rank of a 2x1 grid training each of a two-worker fleet's
    partitions of ``watch`` in turn, as one ``stream-train`` worker does
    (one file a trigger, every trigger committed to a checkpoint-less
    trainer): each partition's lambda [k, V]."""
    from spark_text_clustering_tpu_torch import Params, cli
    from spark_text_clustering_tpu_torch.streaming import (
        FileStreamSource, StreamingOnlineLDA,
    )

    out = []
    for w in range(2):
        t = StreamingOnlineLDA(
            Params(k=EN_K, algorithm="online", seed=seed,
                   data_shards=grid.data_shards),
            num_features=1 << 18, stop_words=cli._load_stop_words(stop),
            grid=grid)
        if grid.rank == 0:
            t.run(FileStreamSource(watch, max_files_per_trigger=1,
                                   partition=(w, 2)),
                  poll_interval=0.05, idle_timeout=0.5)
        else:
            t.run()
        out.append(t.model().lam)
    return out


def run_cli_err(argv, out_path):
    """``cli.main(argv)`` in this process: (exit code, stdout, stderr)."""
    from spark_text_clustering_tpu_torch import cli

    err = io.StringIO()
    with open(out_path, "w") as f, contextlib.redirect_stdout(f), \
            contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    with open(out_path) as f:
        return rc, f.read(), err.getvalue()


def check_m_telemetry(path, ranks, trace_id, triggers):
    """Each rank's ``-p<rank>`` stream of a grid ``stream-train`` run
    under a spawner's ``STC_TRACE``: the grid's process fields and mesh
    shape in its manifest, one ``micro_batch`` a trigger, each carrying
    the spawner's trace id, ``collective.*`` counters above 0 in its
    registry, and no stream at the path itself (the spawning process
    writes none)."""
    t0 = time.perf_counter()
    stem, ext = os.path.splitext(path)
    collectives = []
    for r in range(ranks):
        man, events, snap = telemetry_stream(f"{stem}-p{r}{ext}")
        calls = sum(v for n, v in snap["counters"].items()
                    if n.startswith("collective.") and n.endswith(".calls"))
        traces = [e.get("trace_id") for e in events
                  if e["event"] == "micro_batch"]
        if ((man["process_index"], man["process_count"]) != (r, ranks)
                or man["mesh_shape"] != {"data": 2, "model": 2}
                or not calls > 0 or traces != [trace_id] * triggers):
            raise AssertionError(
                f"config M telemetry: rank {r}: process "
                f"{man['process_index']}/{man['process_count']}, mesh "
                f"{man.get('mesh_shape')}, collective calls {calls}, "
                f"micro_batch trace ids {traces} against {triggers} x "
                f"{trace_id}")
        collectives.append(calls)
    if os.path.exists(path):
        raise AssertionError(f"config M telemetry: {path} was written")
    return {"ranks": ranks, "collective_calls": collectives,
            "micro_batches_traced": ranks * triggers,
            "seconds": time.perf_counter() - t0}


def run_config_m(torch, seed, e, smi):
    """Streaming on a 2x2 gloo grid of 4 ranks on the one card, on config
    E's 51 books with config K's widths (batch capacity 8, 2^18 hash
    features, k=5) and 8 files a trigger (7 triggers),
    ``--checkpoint-interval 2``; every grid command runs through
    ``cli.main`` with its ranks under ``m_rank``'s spies.

    M-train: ``stream-train --data-shards 2 --model-shards 2 --dist-backend
    gloo`` against K's 1x1 ``stream-train`` on the card run again with the
    grid's numerics: lambda's rows summed in the grid's order
    (``shard_row_sums``, J's rule) and E-step tiles of the grid's data
    blocks (4 rows; a tile's sums run in another order than an 8-row
    tile's, and most of a stream's E-step tiles run all 100 inner
    iterations unconverged, which carries a last-bit change to ~1e-3 of
    lambda in 7 steps), within
    1e-3 relative, or twice that run's spread over a repeat where that is
    larger (``index_add_`` adds with atomics); the differences from K's
    own run, of the grid and of that 1x1 run, are reported beside it.  Every book committed once, each state
    record one shard over [0, V_pad) with ``process_count`` 1.  M-resume: 24 books, the stream ends idle, 27
    more, ``--resume``: lambda within 1e-3 of M-train's, docs_seen 51 and
    step 7, every book committed once; the port's 1x1 library trainer
    loads the dir's lambda bit for bit, and ``stream-train --resume`` at
    1x1 on it exits 2 with the config-hash message.  M-fleet: ``supervise
    --role stream-train`` (a subprocess) with 2 workers, each a 2x1 grid
    (``--worker-arg=--data-shards=2 --worker-arg=--dist-backend=gloo``: 4
    ranks on the card), worker 0 killed at its first commit: every book
    committed once, no process of the killed worker alive once its respawn
    commits (their PIDs read from /proc), each partition's lambda within
    1e-3 of one 2x1 grid training it, time to recover; the fleet runs
    beside the untimed rest of M (``beside``): K's 1x1 runs with the
    grid's numerics, the 1x1 load and refusal and the reference grid;
    M-train and M-resume, whose ranks time the E-step and the triggers,
    run alone before it.  The kernel: every
    rank's E-step launches of M-train and M-resume against the plain
    version."""
    from spark_text_clustering_tpu_torch import Params
    from spark_text_clustering_tpu_torch.models import online_lda
    from spark_text_clustering_tpu_torch.models.persistence import (
        latest_model_dir, load_train_state,
    )
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.parallel import run_grid
    from spark_text_clustering_tpu_torch.resilience import EpochLedger
    from spark_text_clustering_tpu_torch.streaming import StreamingOnlineLDA

    root = os.path.join(e["root"], "M")
    os.makedirs(root)
    books, stop = e["books"], e["stop"]
    names = sorted(os.listdir(books))
    watch = os.path.join(e["root"], "K", "watch")       # K's, mtime-ordered
    n_triggers = -(-len(names) // K_TRIGGER_FILES)

    def stream_train(tag, watch_dir_, *extra, models=None):
        models = models or os.path.join(root, f"m_{tag}")
        out, secs = stream_cli("M", [
            "stream-train", "--watch-dir", watch_dir_, "--stop-words", stop,
            "--checkpoint-dir", os.path.join(root, f"ck_{tag}"),
            "--checkpoint-interval", "2", "--models-dir", models,
            "--seed", str(seed), "--device", "cuda", *K_STREAM, *extra],
            os.path.join(root, f"train_{tag}.out"))
        return out, secs, latest_model_dir(models, "EN")

    def lam_of(path):
        with np.load(os.path.join(path, "arrays.npz")) as z:
            return z["lam"]

    def rel_diff(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    def state_records(tag):
        recs = [r for r in EpochLedger(os.path.join(
            root, f"ck_{tag}")).records() if r.get("shards")]
        shards = {(r["process_count"], len(r["shards"]),
                   r["shards"][0]["p"], tuple(r["shards"][0]["cols"]))
                  for r in recs}
        srcs = [os.path.basename(s) for r in recs for s in r["sources"]]
        if shards != {(1, 1, 0, (0, 1 << 18))} or sorted(srcs) != names:
            raise AssertionError(f"config M-{tag}: records {shards}, "
                                 f"{len(srcs)} sources of {len(names)}")
        return recs

    # M-train and M-resume run alone: their ranks time the widest E-step
    # launch and the triggers.  K's 1x1 run with the grid's numerics
    # (lambda's rows summed in the grid's order, J's rule, and E-step tiles
    # of the grid's data blocks), which M-train is held to, runs beside
    # M-fleet after them (M-train's telemetry under a spawner's trace
    # context, which every rank adopts)
    from spark_text_clustering_tpu_torch.telemetry import tracing

    tel_path = os.path.join(root, "telemetry", "train.jsonl")
    trace = tracing.mint(sampled=True)
    os.environ[tracing.ENV_CONTEXT] = trace.format()
    _build.reset_launches()
    try:
        with m_grid_spy() as runs:
            train_out, train_s, train_dir = stream_train(
                "train", watch, *M_FLAGS, "--telemetry-file", tel_path)
    finally:
        os.environ.pop(tracing.ENV_CONTEXT, None)
        tracing.install(None)
    train_launches = dict(_build.LAUNCHES)
    m_telemetry = check_m_telemetry(tel_path, 4, trace.trace_id, n_triggers)
    train_run = runs[0]
    lam = lam_of(train_dir)
    train_recs = state_records("train")
    triggers = train_run["ranks"][0]["triggers"]

    # M-resume: 24 books, the stream ends idle, 27 more, --resume
    _build.reset_launches()
    with m_grid_spy() as wave_runs:
        wave = watch_dir(books, os.path.join(root, "watch_wave"),
                         names[:K_WAVE])
        first_out, _, _ = stream_train("wave", wave, *M_FLAGS)
        watch_dir(books, wave, names[K_WAVE:])
        resumed_out, _, resumed_dir = stream_train("wave", wave, *M_FLAGS,
                                                   "--resume")
    wave_launches = dict(_build.LAUNCHES)
    resume_rel = rel_diff(lam_of(resumed_dir), lam)
    last = state_records("wave")[-1]
    if (f"stream ended: {K_WAVE} docs / 3 micro-batches" not in first_out
            or "committed epoch" not in resumed_out
            or (last["docs_seen"], last["step"])
            != (len(names), n_triggers)
            or not resume_rel <= 1e-3):
        raise AssertionError(
            f"config M-resume: lambda {resume_rel}, "
            f"{last['docs_seen']} docs, step {last['step']}")

    # M-fleet (a subprocess: its workers' launches are not this
    # process's) runs beside the untimed rest of M: two 2x1 grid workers,
    # worker 0 killed at its first commit
    fleet = os.path.join(root, "fleet")
    models = os.path.join(root, "models_fleet")

    def m_fleet():
        with rank_watch(fleet) as procs:
            return run_fleet("M-fleet", [
                "--role", "stream-train", "--watch-dir", watch,
                "--fleet-dir", fleet, "--workers", "2", *L_FLEET,
                "--stop-words", stop, "--seed", str(seed), "--models-dir",
                models, "--chaos-worker", "0:ledger.commit:kill@1",
                "--worker-arg=--data-shards=2",
                "--worker-arg=--dist-backend=gloo"], root), procs

    with beside(m_fleet) as fleet_out:
        k_lam = lam_of(latest_model_dir(
            os.path.join(e["root"], "K", "m_whole"), "EN"))
        estep_kernel = online_lda.gamma_fixed_point_bkl
        online_lda.gamma_fixed_point_bkl = functools.partial(
            estep_kernel, tile_b=8 // 2)
        try:
            with shard_row_sums(torch, online_lda, 2):
                ordered = [lam_of(stream_train(f"k_order{i}", watch)[2])
                           for i in range(2)]
        finally:
            online_lda.gamma_fixed_point_bkl = estep_kernel
        spread = rel_diff(ordered[1], ordered[0])
        vs_order = rel_diff(lam, ordered[0])
        vs_k = rel_diff(lam, k_lam)
        k_numerics = rel_diff(ordered[0], k_lam)
        if (f"stream ended: {len(names)} docs / {n_triggers} micro-batches"
                not in train_out or len(triggers) != n_triggers
                or train_launches["gamma_fixed_point_bkl"] != 4 * n_triggers
                or not vs_order <= max(1e-3, 2 * spread)):
            raise AssertionError(
                f"config M-train: {len(triggers)} triggers, {train_launches}, "
                f"lambda against K with the grid's numerics {vs_order} (its "
                f"spread {spread}; against K {vs_k}, K against K with the "
                f"grid's numerics {k_numerics})")

        # the 1x1 library trainer loads the grid's dir bit for bit; the CLI at
        # 1x1 refuses to resume it
        ck_wave = os.path.join(root, "ck_wave")
        (shard,) = last["shards"]
        written = load_train_state(EpochLedger(ck_wave).resolve(
            shard["file"]))["lam"]
        one = StreamingOnlineLDA(Params(k=EN_K, seed=seed,
                                        checkpoint_dir=ck_wave),
                                 num_features=1 << 18, device="cuda")
        loaded_equal = bool(np.array_equal(one.lam.cpu().numpy(), written))
        rc, _, err = run_cli_err([
            "stream-train", "--watch-dir", wave, "--stop-words", stop,
            "--checkpoint-dir", ck_wave, "--models-dir",
            os.path.join(root, "m_refused"), "--seed", str(seed), "--resume",
            *K_STREAM], os.path.join(root, "refused.out"))
        if not loaded_equal or rc != 2 or (
                "checkpoint was written by config" not in err) or (
                os.path.exists(os.path.join(root, "m_refused"))):
            raise AssertionError(f"config M-resume: 1x1 load bit-equal "
                                 f"{loaded_equal}, 1x1 --resume exit {rc}: "
                                 f"{err[-500:]}")

        # M-fleet's reference, the 2x1 grid training each partition, once
        # M's own launches are counted (a grid's ranks add theirs to this
        # process's)
        t0 = time.perf_counter()
        want = run_grid(m_partition_rank, 2, 1, (watch, stop, seed),
                        backend="gloo", device="cuda", timeout=600)[0]
        partition_s = time.perf_counter() - t0
    run, procs = fleet_out["out"]
    fleet_exactly_once("M-fleet", fleet, watch)
    killed = orphans_after_respawn(fleet, procs, 0)
    recover = time_to_recover(run, fleet, 0)
    fleet_rel = [rel_diff(lam_of(latest_model_dir(
        os.path.join(models, f"w{w:03d}"), "EN")), want[w])
        for w in range(2)]
    if (run["counts"]["respawns"] != 1 or killed["ranks"] < 2
            or killed["alive_after_respawn_commit"]
            or not max(fleet_rel) <= 1e-3):
        raise AssertionError(f"config M-fleet: {run['counts']}, killed "
                             f"worker {killed}, lambda {fleet_rel}")

    cases = [c for r in (*train_run["ranks"], *(
        rank for w in wave_runs for rank in w["ranks"])) for c in r["cases"]]
    coll = np.array([t[5] for t in triggers])
    secs = np.array([t[3] for t in triggers])
    launches = {name: train_launches[name] + wave_launches[name]
                for name in train_launches}
    return {
        "phase": "config_M", "card": smi, "grid": [2, 2], "backend": "gloo",
        "ranks": 4, "books": len(names), "files_per_trigger": K_TRIGGER_FILES,
        "k": EN_K, "hash_features": 1 << 18, "batch_capacity": 8,
        "train": {**trigger_stats(triggers), "seconds": train_s,
                  "grid_s": train_run["grid_s"],
                  "collective_ms_per_trigger": 1e3 * float(coll.mean()),
                  "collective_share": float(coll.sum() / secs.sum()),
                  "broadcasts": train_run["ranks"][0]["shares"],
                  "all_reduce": train_run["ranks"][0]["all_reduce"],
                  "epochs_committed": len(train_recs),
                  "lam_max_rel_diff_vs_k_grid_numerics": vs_order,
                  "k_grid_numerics_repeat_lam_max_rel_diff": spread,
                  "lam_max_rel_diff_vs_k": vs_k,
                  "k_grid_numerics_vs_k_lam_max_rel_diff": k_numerics},
        "resume": {"lam_max_rel_diff": resume_rel,
                   "grid_s": [w["grid_s"] for w in wave_runs],
                   "resumed_docs_seen": last["docs_seen"],
                   "resumed_step": last["step"],
                   "one_device_load_bit_equal": loaded_equal,
                   "one_device_resume_exit": rc},
        "fleet": {"seconds": run["seconds"],
                  "books_per_s": len(names) / run["seconds"],
                  **run["counts"], "fleet_records": run["records"],
                  "first_beat_s": run["first_beat_s"],
                  "time_to_recover_s": recover, "killed_worker": killed,
                  "lam_max_rel_diff_vs_2x1": fleet_rel,
                  "partition_2x1_s": partition_s},
        "telemetry": m_telemetry,
        "launches": launches,
        "kernel": {"launches": len(cases),
                   "max_abs_err": max(c["max_abs_err"] for c in cases),
                   "widest": [c for c in cases if c["ms"] is not None],
                   "shapes": sorted({tuple(c["shape"]) for c in cases})},
        "bounds": {"lam_max_rel_diff_vs_k_grid_numerics":
                   "1e-3, or twice that 1x1 run's spread over a repeat",
                   "resume_lam_max_rel_diff": 1e-3,
                   "fleet_lam_max_rel_diff": 1e-3},
    }


# ---- config N: one serve replica -------------------------------------------
N_BUCKETS = (16384, 65536, 262144)   # --token-bucket: E's books batch to 8
N_MAX_BATCH = 8                      # --max-batch: the pinned doc axis
N_SEGMENTS = {"name": "topic_inference_segments", "route": "cuda",
              "source": "spark_text_clustering_tpu_torch/csrc/segments.cu",
              "replaces": "spark_text_clustering_tpu/ops/lda_math.py:434"}


def segments_batch(torch, eb_vk, rows, t, dev, b):
    """``rows`` packed as a serve dispatch packs them: docs contiguous from
    slot 0 at width ``t``, ``b`` doc slots (the empty ones past the rows),
    gamma0 all ones: (eb_tok, cts, offsets, gamma0) on ``dev``."""
    from spark_text_clustering_tpu_torch.ops.segments import pack_offsets

    lens = [len(i) for i, _ in rows]
    flat_i = np.zeros(t, np.int64)
    flat_c = np.zeros(t, np.float32)
    o = 0
    for ids, wts in rows:
        flat_i[o:o + len(ids)] = ids
        flat_c[o:o + len(ids)] = wts
        o += len(ids)
    offsets = pack_offsets(lens + [0] * (b - len(rows)))
    return (eb_vk[torch.from_numpy(flat_i).to(dev)],
            torch.from_numpy(flat_c).to(dev),
            torch.from_numpy(offsets).to(dev),
            torch.ones((b, eb_vk.shape[1]), dtype=torch.float32, device=dev))


def n_bucket(total: int) -> int:
    want = max(8, 1 << max(0, int(total - 1).bit_length()))
    return next(t for t in N_BUCKETS if t >= want)


def serve_batch(rows):
    """The rows of a serve dispatch at the widest bucket: the longest of
    ``rows``, at most ``N_MAX_BATCH``, that fit; (rows' indices longest
    first, the batch)."""
    order = sorted(range(len(rows)), key=lambda i: -len(rows[i][0]))
    batch, total = [], 0
    for i in order:
        if len(batch) < N_MAX_BATCH and total + len(rows[i][0]) <= N_BUCKETS[-1]:
            batch.append(rows[i])
            total += len(rows[i][0])
    return order, batch


def staged_share(lens, plan):
    """Share of the live tokens the kernel reads from shared memory under
    ``launch_plan``'s ``plan``: piece p of a doc (``piece_tokens`` tokens
    from the doc's start) is staged where p // cluster < stage_pieces."""
    p_tok, c, q = plan["piece_tokens"], plan["cluster"], plan["stage_pieces"]
    staged = sum(min(n, q * c * p_tok) for n in lens)
    return staged / max(1, sum(lens))


def check_segments(torch, eb_vk, alpha, rows, dev, label):
    """The per-document kernel at a serve dispatch's shapes: 8 of ``rows``
    (the largest 8 that fit) in the widest bucket against the plain version
    on the same card tensors (distributions within 1e-5, on books most of
    which converge: where every book runs all 100 iterations unconverged
    the two summation orders drift further apart, 2.3e-5 on A's rows under
    a lambda whose topics barely differ), a repeat bit for bit, and the
    first of them alone at its own bucket, alone at the widest, fourth in
    a batch of the others and in the whole-corpus launch of ``score
    --per-doc-convergence`` (all ``rows`` at the next power of two of
    their tokens): equal bytes through the kernel.  The serve dispatch
    again at forced cluster sizes 1, 2, 4, 8 and 16: equal bytes.  The
    plain version is run the same ways, and whether its bytes moved is
    recorded (index_add_'s float atomics and shape-dependent reductions on
    the card).  Times: events over back-to-back launches and CUDA-graph
    replay (device time alone: in config N the serve subprocesses start
    beside this check) at three shapes, each at the cluster size the
    wrapper picks (the serve dispatch, the book alone in its own bucket,
    the whole corpus), with the launch's shared memory and the share of
    tokens staged there; the bound from these inputs' live tokens and each
    doc's iterations."""
    from spark_text_clustering_tpu_torch.ops import segments
    from spark_text_clustering_tpu_torch.ops.sparse import next_pow2

    order, batch = serve_batch(rows)
    t, b, k = N_BUCKETS[-1], N_MAX_BATCH, eb_vk.shape[1]
    args = segments_batch(torch, eb_vk, batch, t, dev, b)

    def kernel(a, cluster=None):
        return segments.topic_inference_segments(a[0], a[1], a[2], alpha, a[3],
                                                 cluster=cluster)

    def plain(a):
        return segments.topic_inference_segments_plain(
            a[0], a[1], a[2], alpha, a[3])

    got = kernel(args)
    again = kernel(args)
    want, iters = segments.topic_inference_segments_plain(
        *args[:3], alpha, args[3], with_iters=True)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    repeat = bool(torch.equal(got, again))
    forced = {c: bool(torch.equal(kernel(args, c), got))
              for c in (1, 2, 4, 8, 16)}
    one = batch[0]
    others = batch[1:]
    lens_all = [len(i) for i, _ in rows]
    t_corpus = next_pow2(max(8, sum(lens_all)))
    corpus = segments_batch(torch, eb_vk, rows, t_corpus, dev, len(rows))
    ways = {
        "alone_own_bucket": segments_batch(torch, eb_vk, [one],
                                           n_bucket(len(one[0])), dev, b),
        "alone_widest": segments_batch(torch, eb_vk, [one], t, dev, b),
        "fourth_of_batch": segments_batch(
            torch, eb_vk, others[:3] + [one] + others[3:], t, dev, b),
        "whole_corpus": corpus,
    }
    pos = {"alone_own_bucket": 0, "alone_widest": 0, "fourth_of_batch": 3,
           "whole_corpus": order[0]}
    kern_rows = {"first_of_batch": got[0]}
    plain_rows = {"first_of_batch": want[0]}
    for way, a in ways.items():
        kern_rows[way] = kernel(a)[pos[way]]
        plain_rows[way] = plain(a)[pos[way]]
    torch.cuda.synchronize()

    def same(rowset):
        ref = rowset["first_of_batch"].cpu().numpy().tobytes()
        return all(r.cpu().numpy().tobytes() == ref for r in rowset.values())

    kernel_same = same(kern_rows)
    plain_same = same(plain_rows)
    plain_again = plain(args)
    plain_repeat = bool(torch.equal(plain_again, want))
    plain_spread = float((plain_again - want).abs().max())
    ms = cuda_ms(torch, lambda: kernel(args), 20)
    enqueue_ms = host_ms(torch, lambda: kernel(args), 20)
    plain_ms = cuda_ms(torch, lambda: plain(args), 3)

    lens = np.asarray([len(i) for i, _ in batch] + [0] * (b - len(batch)))
    it = iters.cpu().numpy()
    bound_ms, bound_by = segments_bound(args, alpha, lens, it)
    _, it_corpus = segments.topic_inference_segments_plain(
        *corpus[:3], alpha, corpus[3], with_iters=True)
    it_corpus = it_corpus.cpu().numpy()
    shapes = {}
    for name, a, shape_lens, shape_it in (
            ("serve_dispatch", args, list(lens), it),
            ("one_book_own_bucket", ways["alone_own_bucket"],
             [len(one[0])] + [0] * (b - 1),
             np.concatenate([it[:1], np.zeros(b - 1)])),
            ("whole_corpus", corpus, lens_all, it_corpus)):
        plan = segments.launch_plan(k, a[0].shape[0], a[3].shape[0], dev)
        shape_ms = ms if name == "serve_dispatch" else cuda_ms(
            torch, lambda a=a: kernel(a), 20)
        b_ms, b_by = segments_bound(a, alpha, shape_lens, shape_it)
        shapes[name] = {
            "t": int(a[0].shape[0]), "doc_slots": int(a[3].shape[0]),
            "live_tokens": int(sum(shape_lens)), "ms": shape_ms,
            "graph_ms": cuda_graph_ms(torch, lambda a=a: kernel(a), 20),
            "bound_ms": b_ms, "bound_by": b_by, **plan,
            "staged_token_share": staged_share(shape_lens, plan)}
    res = {**N_SEGMENTS, "label": label, "docs": len(batch), "t": t,
           "max_batch": b, "k": k, "live_tokens": int(lens.sum()),
           "doc_tokens": [int(x) for x in lens[:len(batch)]],
           "iterations": [int(x) for x in it[:len(batch)]],
           "max_abs_err": err, "repeat_bit_equal": repeat,
           "kernel_bytes_equal_alone_vs_batch": kernel_same,
           "kernel_bytes_equal_at_forced_clusters": forced,
           "plain_bytes_equal_alone_vs_batch": plain_same,
           "plain_repeat_bit_equal": plain_repeat,
           "plain_repeat_max_abs_diff": plain_spread,
           "ms": ms, "host_ms": enqueue_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "shapes": shapes, "ptxas": ptxas_report("segments")}
    if (not err <= 1e-5 or not repeat or not kernel_same
            or not all(forced.values())):
        raise AssertionError(f"segments kernel ({label}): {res}")
    return res


def segments_bound(args, alpha, lens, it):
    """The least time of one per-document launch on ``args`` (eb_tok, cts,
    offsets, gamma0): its cost (``segments.cost``) at each doc's tokens
    ``lens`` and iterations ``it``."""
    from spark_text_clustering_tpu_torch.ops import segments

    return bound(*segments.cost(args[0], args[1], args[2], alpha, args[3],
                                lens=lens, iters=it))


SEGMENTS_K = (100, 500)     # the Large instance's k=100, the Wide one's 500


def check_segments_k(torch, rows, dev, k, seed):
    """The per-document kernel at k topics on a serve dispatch's shapes:
    the 8 longest of ``rows`` that fit the widest bucket, eb of a random
    lambda [k, V] (A's kind of draw), against the plain version on the
    same card tensors (1e-5), a repeat bit for bit, the batch's bytes
    equal at forced clusters of 1, 2, 4, 8 and 16 CTAs a doc and its first
    doc's bytes equal alone at its own bucket; timed beside its bound and
    the plain version, with the launch's plan."""
    from spark_text_clustering_tpu_torch.ops import segments
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        dirichlet_expectation,
    )

    v = 1 + max(int(i.max()) for i, _ in rows if len(i))
    lam = np.random.default_rng(seed).gamma(0.5, 4.0, (k, v)).astype(
        np.float32)
    eb_vk = torch.exp(dirichlet_expectation(
        torch.from_numpy(lam).to(dev))).T.contiguous()
    alpha = torch.full((k,), 50.0 / k + 1.0, device=dev)
    _, batch = serve_batch(rows)
    t, b = N_BUCKETS[-1], N_MAX_BATCH
    args = segments_batch(torch, eb_vk, batch, t, dev, b)

    def kernel(a, cluster=None):
        return segments.topic_inference_segments(a[0], a[1], a[2], alpha, a[3],
                                                 cluster=cluster)

    got = kernel(args)
    again = kernel(args)
    want, iters = segments.topic_inference_segments_plain(
        *args[:3], alpha, args[3], with_iters=True)
    alone = kernel(segments_batch(torch, eb_vk, batch[:1],
                                  n_bucket(len(batch[0][0])), dev, b))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    repeat = bool(torch.equal(got, again))
    forced = {c: bool(torch.equal(kernel(args, c), got))
              for c in (1, 2, 4, 8, 16)}
    alone_same = alone[0].cpu().numpy().tobytes() == got[0].cpu().numpy(
    ).tobytes()
    lens = [len(i) for i, _ in batch] + [0] * (b - len(batch))
    it = iters.cpu().numpy()
    bound_ms, bound_by = segments_bound(args, alpha, lens, it)
    res = {**N_SEGMENTS, "k": k, "docs": len(batch), "t": t,
           "max_batch": b, "live_tokens": int(sum(lens)),
           "iterations": [int(x) for x in it[:len(batch)]],
           "max_abs_err": err, "tolerance": 1e-5, "repeat_bit_equal": repeat,
           "kernel_bytes_equal_at_forced_clusters": forced,
           "kernel_bytes_equal_alone_vs_batch": alone_same,
           "ms": cuda_ms(torch, lambda: kernel(args), 5),
           "plain_ms": cuda_ms(torch, lambda: segments.topic_inference_segments_plain(
               *args[:3], alpha, args[3]), 2),
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           **segments.launch_plan(k, t, b, dev)}
    if (not err <= 1e-5 or not repeat or not all(forced.values())
            or not alone_same):
        raise AssertionError(f"segments kernel at k={k}: {res}")
    return res


class ServeProc:
    """``cli serve`` as a subprocess of the port's CLI (a process group of
    its own, output in ``root/<label>.out``): the URL once warm, then
    ``stop()`` sends SIGTERM and returns the exit code and the output."""

    def __init__(self, label, argv, root):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.label = label
        self.path = os.path.join(root, f"{label}.out")
        self.out = open(self.path, "w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             "serve", *argv], cwd=here, env=env, stdout=self.out,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self.url = None

    def wait_url(self, timeout=180.0):
        deadline = time.monotonic() + timeout
        while self.url is None:
            with open(self.path) as f:
                for line in f:
                    if line.startswith("serving ") and " on http://" in line:
                        self.url = line.split(" on ")[1].split(" ")[0]
                        self.url_s = time.perf_counter() - self.t0
            if self.url is None:
                if self.proc.poll() is not None or time.monotonic() > deadline:
                    self.stop()
                    raise AssertionError(
                        f"config N {self.label}: no URL line: "
                        f"{open(self.path).read()[-2000:]}")
                time.sleep(0.05)
        return self.url

    def stop(self, timeout=120.0):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            rc = self.proc.wait()
        self.out.close()
        with open(self.path) as f:
            return rc, f.read()


def http_json(url, body=None, headers=None, timeout=120.0):
    """(status, headers, JSON body) of a GET, or of a POST of ``body``;
    an HTTP error status is returned, not raised."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            status, hdrs = resp.status, dict(resp.headers)
    except urllib.error.HTTPError as err:
        raw, status, hdrs = err.read(), err.code, dict(err.headers)
    ctype = hdrs.get("Content-Type", "")
    return status, hdrs, (json.loads(raw) if ctype.startswith(
        "application/json") else raw.decode())


def post_books(url, texts, names):
    """One POST of ``texts``: (seconds, the response's results)."""
    t0 = time.perf_counter()
    status, _, doc = http_json(f"{url}/score", {"texts": texts,
                                                "names": names})
    if status != 200:
        raise AssertionError(f"config N: POST /score {status}: {doc}")
    return time.perf_counter() - t0, doc["results"]


def served(results):
    return np.asarray([r["distribution"] for r in results],
                      np.float64).astype(np.float32)


def in_threads(fn, items, threads):
    """``fn(item)`` over ``items`` from ``threads`` threads; results in
    order; the first exception raised again."""
    out = [None] * len(items)
    errors = []
    lock = threading.Lock()
    todo = list(range(len(items)))

    def work():
        while True:
            with lock:
                if not todo or errors:
                    return
                i = todo.pop(0)
            try:
                out[i] = fn(items[i])
            except Exception as exc:  # noqa: BLE001 - raised again below
                with lock:
                    errors.append(exc)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    if errors:
        raise errors[0]
    return out


def parse_prometheus(text):
    """{sample: value} of a Prometheus text exposition; fails on a line
    that is neither a comment nor ``name[{labels}] value``."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        if not re.match(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?$", name):
            raise AssertionError(f"config N: prometheus line {line!r}")
        samples[name] = float(value)
    return samples


def serve_dispatch(path, launched):
    """A serve run stream's dispatch layer against the per-document
    kernel's ``launched`` launches over the run: ``serve.topic_inference``'s
    calls summed over its digests equal them, and so do the launches
    charged to those calls; the recompile sentinel's ``compile.retraces``
    after warmup (the registry's count less the warmup report's) is 0."""
    _, events, snap = telemetry_stream(path)
    digests = {e["digest"]: e["label"] for e in events
               if e["event"] == "dispatch_executable"}
    counters = snap["counters"]
    calls = sum(counters.get(f"dispatch.{d}.calls", 0)
                for d, lbl in digests.items()
                if lbl == "serve.topic_inference")
    charged = sum(counters.get(
        f"dispatch.{d}.launches.topic_inference_segments", 0)
        for d, lbl in digests.items() if lbl == "serve.topic_inference")
    (warm,) = [e for e in events if e["event"] == "serve_warmup"]
    (drained,) = [e for e in events if e["event"] == "serve_drained"]
    after = counters.get("compile.retraces", 0) - warm["retraces_at_warmup"]
    res = {"serve_topic_inference_calls": calls,
           "charged_launches": charged, "launches": launched,
           "retraces_at_warmup": warm["retraces_at_warmup"],
           "retraces_after_warmup": after,
           "signatures": {lbl: sum(1 for x in digests.values() if x == lbl)
                          for lbl in set(digests.values())}}
    if (calls != launched or charged != launched or after != 0
            or drained["retraces_after_warmup"] != 0):
        raise AssertionError(f"config N dispatch: {res}")
    return res


def run_config_n(torch, seed, e, smi):
    """One serve replica on config E's 51 books and E's card model (k=5).

    N-kernel: ``check_segments`` on the model's own rows of the books.
    N-serve: ``cli serve --port 0 --max-batch 8 --token-bucket 16384
    --token-bucket 65536 --token-bucket 262144 --telemetry-file`` as a
    subprocess on the card, beside a ``--max-queue 8`` card server (both
    started at once) and, once the timed traffic is done, the same on
    ``--device cpu``.  The 51 books from
    8 client threads one a request, then as 6 requests of 8-9 books: every
    served distribution equal in bytes to this process's
    ``topic_distribution(rows, convergence="per_doc")`` on the card, whose
    scoring report equals ``score --per-doc-convergence``'s byte for byte,
    and none degraded; the CPU server's within 1e-4, its requests of 8
    books paced (twice each request's time idle after it) so its queueing
    estimate stays below degraded mode's threshold: a CPU dispatch takes
    ~1 s, and a closed loop holds it at ρ ≈ 1, where the service truncates
    books to its smallest bucket.  N-swap: a newer model published
    mid-traffic: ``swaps`` 1, every response equal to its attributed
    model's bytes.  N-admission: 64 concurrent one-book requests against
    the ``--max-queue 8`` server: at least one 429, Retry-After in [1,
    60].  N-health: ``/healthz`` ok, ``/metrics?format=prometheus``
    parses.  N-drain: SIGTERM to each; exit 0, and the card server's
    drain report says no retrace after warmup.  N-inproc: the same
    ``serve`` command in this process (its launches counted, with the
    counts at 0 before ``score --per-doc-convergence`` and read after the
    drain), the 6 requests one at a time, each followed by as long idle:
    none degraded, the books' bytes equal the subprocess's; with
    ``--telemetry-file``, its stream's ``serve.topic_inference`` calls
    equal the kernel's launches over the serve and no retrace after warmup
    from the sentinel (``serve_dispatch``)."""
    from spark_text_clustering_tpu_torch import load_model
    from spark_text_clustering_tpu_torch.device import resolve_device
    from spark_text_clustering_tpu_torch.models.persistence import (
        latest_model_dir, save_model,
    )
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.pipeline import (
        TextPreprocessor, make_vectorizer,
    )
    from spark_text_clustering_tpu_torch.telemetry import dispatch
    from spark_text_clustering_tpu_torch.utils.readers import (
        read_stop_word_file, read_text_dir,
    )
    from spark_text_clustering_tpu_torch.utils.report import (
        format_scoring_report,
    )
    from spark_text_clustering_tpu_torch.utils.textproc import (
        parse_stop_words,
    )

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    root = os.path.join(e["root"], "N")
    models = os.path.join(root, "models")
    os.makedirs(models)
    src = latest_model_dir(os.path.join(e["root"], "models"), "EN")
    model_a = os.path.join(models, os.path.basename(src))
    shutil.copytree(src, model_a)
    stamp = int(model_a.rsplit("_", 1)[1])
    buckets = [x for t in N_BUCKETS for x in ("--token-bucket", str(t))]
    common = ["--models-dir", models, "--stop-words", e["stop"], "--port",
              "0", "--max-batch", str(N_MAX_BATCH), *buckets,
              "--max-seconds", "600"]
    tel = os.path.join(root, "serve_cuda.jsonl")
    procs = {
        "serve_cuda": ServeProc("serve_cuda", [
            *common, "--model-poll-interval", "0.2", "--telemetry-file",
            tel], root),
        "serve_queue8": ServeProc("serve_queue8", [
            *common, "--max-queue", "8", "--model-poll-interval", "600"],
            root),
    }
    try:
        # the books as serve and score vectorize them, and the card's
        # per-doc reference (the kernel launch of `score
        # --per-doc-convergence`'s path)
        docs = list(read_text_dir(e["books"]))
        texts = [d.text for d in docs]
        names = [os.path.basename(d.path) for d in docs]
        pre = TextPreprocessor(stop_words=parse_stop_words(
            read_stop_word_file(e["stop"])))
        model = load_model(model_a, device="cuda")
        rows = make_vectorizer(model.vocab)(
            pre.transform({"texts": texts})["tokens"])
        want = np.asarray(model.topic_distribution(rows,
                                                    convergence="per_doc"))
        kernel = check_segments(
            torch, model._exp_elog_beta(dev).T.contiguous(),
            torch.as_tensor(np.asarray(model.alpha, np.float32), device=dev),
            rows, dev, "N")
        emit({"phase": "config_N_kernel_vs_plain", **kernel})

        # the CPU server's answers, paced (each request of 8 books one
        # dispatch, then twice its time idle) so its load stays below the
        # degraded-mode threshold, beside the untimed phases below
        cpu_res = {}

        def cpu_traffic():
            try:
                cpu_url = procs["serve_cpu"].wait_url()
                out = []
                for lo in range(0, len(texts), N_MAX_BATCH):
                    t0 = time.perf_counter()
                    part = list(range(lo, min(lo + N_MAX_BATCH, len(texts))))
                    out += post_books(cpu_url, [texts[i] for i in part],
                                      [names[i] for i in part])[1]
                    time.sleep(2.0 * (time.perf_counter() - t0))
                cpu_res["results"] = out
            except Exception as exc:  # noqa: BLE001 - raised again below
                cpu_res["error"] = exc

        cpu_thread = threading.Thread(target=cpu_traffic)

        # N-serve
        url = procs["serve_cuda"].wait_url()
        first = {}

        def one(i):
            secs, (res,) = post_books(url, [texts[i]], [names[i]])
            first.setdefault("at", time.perf_counter())
            return secs, res

        t0 = time.perf_counter()
        singles = in_threads(one, list(range(len(texts))), 8)
        single_s = time.perf_counter() - t0
        spawn_to_first = first["at"] - procs["serve_cuda"].t0
        lat = np.asarray([s for s, _ in singles]) * 1e3
        groups = [list(range(i, min(i + 9 if i < 27 else i + 8, len(texts))))
                  for i in (0, 9, 18, 27, 35, 43)]
        t0 = time.perf_counter()
        grouped = in_threads(lambda g: post_books(
            url, [texts[i] for i in g], [names[i] for i in g])[1], groups, 6)
        grouped_s = time.perf_counter() - t0
        grouped = [r for g in grouped for r in g]
        # the CPU server starts once the timed traffic is done: its torch
        # threads would share the host's cores with the card server's
        # text front end
        procs["serve_cpu"] = ServeProc("serve_cpu", [
            *common, "--device", "cpu", "--model", model_a], root)
        cpu_thread.start()
        card_single = served([r for _, r in singles])
        card_grouped = served(grouped)
        degraded = sum(bool(r.get("degraded"))
                       for r in [r for _, r in singles] + grouped)
        if (degraded or card_single.tobytes() != want.tobytes()
                or card_grouped.tobytes() != want.tobytes()
                or [r["name"] for r in grouped] != names):
            raise AssertionError(
                "config N: served bytes differ from the card's per-doc "
                f"scoring by {np.abs(card_single - want).max()}, "
                f"{np.abs(card_grouped - want).max()} ({degraded} "
                "degraded answers)")

        # N-swap: a newer model published mid-traffic
        newer = load_model(model_a, device="cpu")
        newer.lam = (newer.lam * np.random.default_rng(seed + 7).uniform(
            0.5, 1.5, newer.lam.shape)).astype(np.float32)
        model_b = os.path.join(models, f"LdaModel_EN_{stamp + 1000}")
        stop_swap = threading.Event()
        seen = []

        def swap_client(c):
            j = c
            while not stop_swap.is_set():
                i = j % len(texts)
                _, (res,) = post_books(url, [texts[i]], [names[i]])
                seen.append((i, res))
                j += 4

        clients = [threading.Thread(target=swap_client, args=(c,))
                   for c in range(4)]
        for c in clients:
            c.start()
        time.sleep(0.5)
        save_model(newer, model_b)
        deadline = time.monotonic() + 60.0
        while http_json(f"{url}/healthz")[2]["swaps"] < 1:
            if time.monotonic() > deadline:
                stop_swap.set()
                raise AssertionError("config N: no hot swap in 60 s")
            time.sleep(0.05)
        time.sleep(1.0)
        stop_swap.set()
        for c in clients:
            c.join()
        want_b = np.asarray(load_model(model_b, device="cuda")
                            .topic_distribution(rows, convergence="per_doc"))
        by_model = {model_a: want, model_b: want_b}
        attributed = {}
        for i, res in seen:
            path = res["model"]["model"]
            attributed[path] = attributed.get(path, 0) + 1
            got = np.asarray(res["distribution"], np.float64).astype(
                np.float32)
            if got.tobytes() != by_model[path][i].tobytes():
                raise AssertionError(f"config N swap: book {i} under {path}")
        health = http_json(f"{url}/healthz")[2]
        if health["swaps"] != 1 or set(attributed) != {model_a, model_b}:
            raise AssertionError(f"config N swap: {health}, {attributed}")

        # N-admission: 64 concurrent docs against --max-queue 8
        q_url = procs["serve_queue8"].wait_url()
        gate = threading.Barrier(64)

        def burst(i):
            gate.wait(60.0)
            status, hdrs, doc = http_json(
                f"{q_url}/score", {"texts": [texts[i % len(texts)]]})
            return status, hdrs.get("Retry-After"), doc

        outcomes = in_threads(burst, list(range(64)), 64)
        refused = [(s, ra) for s, ra, _ in outcomes if s == 429]
        statuses = sorted({s for s, _, _ in outcomes})
        if not refused or set(statuses) - {200, 429} or not all(
                ra is not None and 1 <= int(ra) <= 60 for _, ra in refused):
            raise AssertionError(f"config N admission: {statuses}, "
                                 f"{refused[:4]}")

        # the CPU server against the card's
        cpu_thread.join()
        if "error" in cpu_res:
            raise cpu_res["error"]
        cpu = served(cpu_res["results"])
        cpu_degraded = sum(bool(r.get("degraded"))
                           for r in cpu_res["results"])
        cpu_diff = float(np.abs(cpu - card_single).max())
        if cpu_degraded or not cpu_diff <= 1e-4:
            raise AssertionError(f"config N: card and CPU serve differ by "
                                 f"{cpu_diff} ({cpu_degraded} degraded "
                                 "CPU answers)")

        # N-health
        status, _, health = http_json(f"{url}/healthz")
        _, hdrs, prom = http_json(f"{url}/metrics?format=prometheus")
        samples = parse_prometheus(prom)
        if status != 200 or health["status"] != "ok" or (
                samples.get("stc_serve_swaps_total") != 1):
            raise AssertionError(f"config N health: {health}, "
                                 f"{sorted(samples)[:8]}")
    finally:
        stopped = {name: p.stop() for name, p in procs.items()}

    # N-drain
    drains = {}
    for name, (rc, out) in stopped.items():
        line = [x for x in out.splitlines() if x.startswith("drain complete")]
        if rc != 0 or not line:
            raise AssertionError(f"config N {name}: exit {rc}: {out[-2000:]}")
        drains[name] = line[0]
    events = [json.loads(x) for x in open(tel)]
    (report,) = [x for x in events if x["event"] == "serve_drained"]
    (warm,) = [x for x in events if x["event"] == "serve_warmup"]
    if (events[0]["event"] != "manifest" or events[0].get("kind") != "serve"
            or report["retraces_after_warmup"] != 0 or report["swaps"] != 1):
        raise AssertionError(f"config N drain: {report}")

    # N-inproc: the same command in this process, its launches counted
    # with `score --per-doc-convergence`'s
    _build.reset_launches()
    rc, _, score_s = run_cli(
        ["score", "--books", e["books"], "--stop-words", e["stop"],
         "--model", model_a, "--output-dir", os.path.join(root, "score"),
         "--per-doc-convergence"], os.path.join(root, "score.out"))
    (rep_name,) = os.listdir(os.path.join(root, "score"))
    with open(os.path.join(root, "score", rep_name)) as f:
        score_report = f.read()
    report_equal = score_report == format_scoring_report(
        model, [d.path for d in docs], card_single, rows)
    inproc = {}

    def traffic():
        try:
            out_path = os.path.join(root, "serve_inproc.out")
            deadline = time.monotonic() + 120.0
            while "url" not in inproc and time.monotonic() < deadline:
                for line in open(out_path):
                    if line.startswith("serving ") and " on http://" in line:
                        inproc["url"] = line.split(" on ")[1].split(" ")[0]
                time.sleep(0.05)
            # one request at a time, each followed by as long idle: this
            # server shares the interpreter with the client and the rest
            # of this process, so its dispatches run slower than the
            # subprocess's, and concurrent requests can hold its load
            # estimate at the degraded-mode threshold (truncated books)
            results = []
            for g in groups:
                t0 = time.perf_counter()
                results += post_books(inproc["url"], [texts[i] for i in g],
                                      [names[i] for i in g])[1]
                time.sleep(time.perf_counter() - t0)
            inproc["degraded"] = sum(bool(r.get("degraded")) for r in results)
            inproc["dists"] = served(results)
        finally:
            if "url" in inproc:
                # the serve's SIGTERM drain; without a URL it ends at its
                # --max-seconds
                os.kill(os.getpid(), signal.SIGTERM)

    open(os.path.join(root, "serve_inproc.out"), "w").close()
    client = threading.Thread(target=traffic)
    client.start()
    score_launches = _build.LAUNCHES["topic_inference_segments"]
    inproc_tel = os.path.join(root, "serve_inproc.jsonl")
    # the serve's sentinel starts empty, as in a process of its own
    dispatch.reset()
    rc_serve, serve_out, _ = run_cli(
        ["serve", "--model", model_a, "--stop-words", e["stop"], "--port",
         "0", "--max-batch", str(N_MAX_BATCH), *buckets, "--max-seconds",
         "300", "--telemetry-file", inproc_tel],
        os.path.join(root, "serve_inproc.out"))
    client.join()
    launches = dict(_build.LAUNCHES)
    sentinel = serve_dispatch(inproc_tel, launches["topic_inference_segments"]
                              - score_launches)
    if (rc != 0 or rc_serve != 0 or not report_equal
            or inproc.get("dists") is None or inproc["degraded"]
            or inproc["dists"].tobytes() != want.tobytes()
            or launches["topic_inference_segments"] < 1 + len(N_BUCKETS)):
        diff = (float(np.abs(inproc["dists"] - want).max())
                if inproc.get("dists") is not None else None)
        raise AssertionError(
            f"config N in-process: score {rc}, serve {rc_serve}, report "
            f"equal {report_equal}, {inproc.get('degraded')} degraded "
            f"answers, served bytes {diff} from the per-doc scoring, "
            f"launches {launches}: {serve_out[-1000:]}")
    kernel["launches"] = launches["topic_inference_segments"]
    return {
        "phase": "config_N", "dispatch": sentinel, "docs": len(texts), "k": model.k,
        "vocab": model.vocab_size, "card": smi,
        "tokens": int(sum(len(i) for i, _ in rows)),
        "buckets": list(N_BUCKETS), "max_batch": N_MAX_BATCH,
        "spawn_to_url_s": procs["serve_cuda"].url_s,
        "spawn_to_first_response_s": spawn_to_first,
        "warmup_s": warm["warmup_seconds"],
        "request_p50_ms": float(np.percentile(lat, 50)),
        "request_p99_ms": float(np.percentile(lat, 99)),
        "docs_per_s": len(texts) / single_s,
        "grouped_docs_per_s": len(texts) / grouped_s,
        "served_bytes_equal_per_doc": True,
        "score_report_equal": report_equal, "score_s": score_s,
        "cpu_max_dist_diff": cpu_diff, "degraded_answers": degraded,
        "swap": {"responses": len(seen), "by_model": {
            os.path.basename(p): n for p, n in attributed.items()}},
        "admission": {"requests": 64, "refused": len(refused),
                      "retry_after": sorted({int(ra) for _, ra in refused})},
        "drain": drains, "drain_report": report,
        "prometheus_samples": len(samples),
        "kernel": kernel, "launches": launches,
        "seconds": time.perf_counter() - t_start,
        "bounds": {"cpu_max_dist_diff": 1e-4, "kernel_vs_plain": 1e-5},
    }, {"model_a": model_a, "model_b": model_b, "by_model": by_model,
        "texts": texts, "names": names}


# ---- the compile cache ---------------------------------------------------
CC_SHIM = """#!/bin/sh
# nvcc that answers --version only: any compile is logged and refused
echo "$*" >> "{log}"
if [ "$1" = "--version" ]; then exec "{real}" --version; fi
exit 1
"""


def cc_cli(argv, out_path, env, cwd):
    """The port's CLI as a subprocess: (exit code, output text)."""
    with open(out_path, "w") as out:
        rc = subprocess.run(
            [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
             *argv], cwd=cwd, env=env, stdout=out, stderr=subprocess.STDOUT,
            text=True, timeout=600).returncode
    with open(out_path) as f:
        return rc, f.read()


def cc_counters(path):
    """The ``compile.cache_*`` counters of a run stream's final registry,
    and the labels of its ``compile_cache`` events by op."""
    _, events, snap = telemetry_stream(path)
    counters = {k[len("compile.cache_"):]: int(v)
                for k, v in snap["counters"].items()
                if k.startswith("compile.cache_")}
    ops = {}
    for ev in events:
        if ev["event"] == "compile_cache":
            ops.setdefault(ev["op"], []).append(ev["label"])
    return counters, ops


def run_compile_cache(torch, e, n, smi):
    """The compile cache on the card, on an empty store, after N's models
    exist.  (a) ``cli compile-cache warm --cache-dir S --model <N's model>``
    as a subprocess: exit 0, all six libraries stored, none already
    cached.  (b) In this process, left disarmed after: ``compile-cache ls
    --json``: six committed entries under one fingerprint, the live one;
    ``verify`` exits 0.  (c) ``cli score``
    of E's books with ``--compile-cache S`` as a subprocess whose ``PATH``
    is led by an nvcc shim (``--version`` passed on to the real nvcc, any
    other call logged and refused): exit 0, its report equal in bytes to
    E's card ``score`` report, its stream's ``compile.cache_hits`` >= 1 and
    no miss, no compile in the shim's log, the build directory's listing
    unchanged.  (d) One byte of the payload of an entry (c) loaded flipped,
    the same ``score`` again: the same report, one miss and one
    invalidation, the entry under ``.quarantine/``, and published again
    from the build directory.  Returns the summary and the store for
    config O's fleet."""
    from spark_text_clustering_tpu_torch import compilecache
    from spark_text_clustering_tpu_torch.compilecache import (
        ExecutableStore,
    )
    from spark_text_clustering_tpu_torch.ops import _build

    t_start = time.perf_counter()
    root = os.path.join(e["root"], "CC")
    store = os.path.join(root, "store")
    os.makedirs(root)
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("STC_FAULTS", "STC_FAULT_SEED", "STC_COMPILE_CACHE")}
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    build_listing = sorted(os.listdir(_build.BUILD_DIR))

    # (a) warm
    t0 = time.perf_counter()
    rc, out = cc_cli(["compile-cache", "warm", "--cache-dir", store,
                      "--model", n["model_a"], "--stop-words", e["stop"]],
                     os.path.join(root, "warm.out"), env, here)
    warm_s = time.perf_counter() - t0
    n_lib = len(_build.SOURCES)
    m = re.search(r"— (\d+) stored, (\d+) already cached, (\d+) miss",
                  out)
    if rc != 0 or not m or (int(m.group(1)), int(m.group(2))) != (n_lib, 0):
        raise AssertionError(f"compile-cache warm: rc {rc}: {out[-2000:]}")

    # (b) ls and verify, in this process (each arms the store it reads:
    # disarmed again after, as this process was)
    try:
        rc, out, _ = run_cli(["compile-cache", "ls", "--json", "--cache-dir",
                              store], os.path.join(root, "ls.out"))
        listed = json.loads(out.strip().splitlines()[-1])["entries"]
        rc_verify, verify_out, _ = run_cli(
            ["compile-cache", "verify", "--cache-dir", store],
            os.path.join(root, "verify.out"))
    finally:
        compilecache.reset()
    live = ExecutableStore(store).fingerprint
    if (rc != 0 or len(listed) != n_lib
            or {x["status"] for x in listed} != {"committed"}
            or {x["fingerprint"] for x in listed} != {live}
            or any(x["stale"] for x in listed)
            or sorted(x["label"] for x in listed) != sorted(_build.SOURCES)):
        raise AssertionError(f"compile-cache ls: rc {rc}: {out[-2000:]}")
    if rc_verify != 0 or (f"verify: {n_lib}/{n_lib} entry(ies) loadable"
                          not in verify_out):
        raise AssertionError(f"compile-cache verify: rc {rc_verify}: "
                             f"{verify_out[-2000:]}")
    store_bytes = sum(x["payload_bytes"] for x in listed)

    # (c) a second process loads from the store and builds nothing
    shim_dir = os.path.join(root, "shim")
    os.makedirs(shim_dir)
    shim_log = os.path.join(root, "shim.log")
    with open(os.path.join(shim_dir, "nvcc"), "w") as f:
        f.write(CC_SHIM.format(log=shim_log, real=_build._nvcc()))
    os.chmod(os.path.join(shim_dir, "nvcc"), 0o755)
    shim_env = {**env, "PATH": f"{shim_dir}{os.pathsep}{env['PATH']}"}
    models = os.path.join(e["root"], "models")

    def score(tag):
        out_dir = os.path.join(root, f"TestOutput_{tag}")
        tel = os.path.join(root, f"score_{tag}.jsonl")
        t0 = time.perf_counter()
        rc, out = cc_cli(["score", "--books", e["books"], "--stop-words",
                          e["stop"], "--models-dir", models, "--output-dir",
                          out_dir, "--compile-cache", store,
                          "--telemetry-file", tel],
                         os.path.join(root, f"score_{tag}.out"), shim_env,
                         here)
        secs = time.perf_counter() - t0
        written = os.listdir(out_dir) if os.path.isdir(out_dir) else []
        if rc != 0 or len(written) != 1:
            raise AssertionError(f"compile-cache score {tag}: rc {rc}: "
                                 f"{out[-2000:]}")
        with open(os.path.join(out_dir, written[0])) as f:
            report = f.read()
        counters, ops = cc_counters(tel)
        return report, counters, ops, secs

    report, counters, ops, score_s = score("hit")
    with open(shim_log) as f:
        calls = [ln.strip() for ln in f if ln.strip()]
    compiles = [c for c in calls if c != "--version"]
    if (report != e["card_report"] or counters.get("hits", 0) < 1
            or counters.get("misses", 0) != 0 or compiles or not calls
            or sorted(os.listdir(_build.BUILD_DIR)) != build_listing):
        raise AssertionError(
            f"compile-cache second process: report equal "
            f"{report == e['card_report']}, counters {counters}, nvcc "
            f"calls {calls[:6]}, build dir changed "
            f"{sorted(os.listdir(_build.BUILD_DIR)) != build_listing}")

    # (d) a corrupt entry: a miss, quarantined, never a crash
    victim = sorted(ops["hit"])[0]
    entry = next(x for x in listed if x["label"] == victim)
    payload = os.path.join(entry["path"], f"{victim}.so")
    with open(payload, "r+b") as f:
        f.seek(os.path.getsize(payload) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    report_d, counters_d, ops_d, score_d_s = score("corrupt")
    quarantine = os.path.join(os.path.dirname(entry["path"]), ".quarantine")
    quarantined = sorted(os.listdir(quarantine)) if os.path.isdir(
        quarantine) else []
    with open(shim_log) as f:
        calls = [ln.strip() for ln in f if ln.strip()]
    if (report_d != e["card_report"] or counters_d.get("misses") != 1
            or counters_d.get("invalidations") != 1
            or counters_d.get("hits", 0) != counters["hits"] - 1
            or counters_d.get("stores") != 1
            or quarantined != [f"{entry['digest']}.1"]
            or any(c != "--version" for c in calls)
            or sorted(os.listdir(_build.BUILD_DIR)) != build_listing):
        raise AssertionError(
            f"compile-cache corrupt entry {victim}: report equal "
            f"{report_d == e['card_report']}, counters {counters_d}, "
            f"quarantined {quarantined}, nvcc calls {calls[:6]}")
    entries = ExecutableStore(store).entries()
    if len(entries) != n_lib or {x["status"] for x in entries} != {
            "committed"}:
        raise AssertionError(f"compile-cache after (d): {entries}")
    return {
        "phase": "compile_cache", "card": smi, "libraries": n_lib,
        "fingerprint": live, "store_bytes": store_bytes,
        "entries": {x["label"]: x["payload_bytes"] for x in listed},
        "warm_s": warm_s, "score_hit_s": score_s,
        "score_corrupt_s": score_d_s,
        "second_process": {"counters": counters, "hit_labels": ops["hit"],
                           "nvcc_calls": len(calls)},
        "corrupt_entry": {"label": victim, "counters": counters_d,
                          "quarantined": quarantined},
        "report_bytes_equal": True,
        "seconds": time.perf_counter() - t_start,
    }, store


# ---- config O: the serve fleet ------------------------------------------
O_WORKERS = 2                  # --workers: the canary and one more replica
O_MAX_WORKERS = 3              # --max-workers: room for O-alerts' scale-out
O_CLIENTS = 8                  # client threads, one X-STC-Stream each
O_PASSES = 2                   # passes over the 51 books, one a request
O_PROBES = ["--count", "5", "--rate", "5"]
# O-alerts: the monitors' rules.  replica_down waits 1 s of absence, not
# the built-in 3 s: a respawned replica beats before its torch import
# ends, which can be under 3 s from the kill; serve_p99 fires on the
# replicas' own card batches of passes 1-2 (any p99 above 0 s, at once).
O_DOWN_RULES = [{"name": "replica_down", "value": 1.0}]
O_P99_RULES = [{"name": "serve_p99", "value": 0.0, "for_seconds": 0.0,
                "signal": {"event": "serve_batch", "field": "seconds",
                           "agg": "p99", "window_seconds": 600.0}}]
O_SLACK_S = 2.0                # the alert log's transitions: kill to ready


@contextlib.contextmanager
def lease_log(fleet, workers, period=0.02):
    """Inside the block, a thread reads each replica's lease file every
    ``period`` seconds and records every change it sees as (wall time,
    spawn id or None when the file is absent, state, model stamp, pid):
    {worker: [observations]}."""
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        lease_path, read_lease,
    )

    seen = {w: [] for w in range(workers)}
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            for w in range(workers):
                lease = read_lease(lease_path(fleet, w))
                obs = (None, None, None, None) if lease is None else (
                    lease.get("spawn_id"), lease.get("state"),
                    lease.get("model_stamp"), lease.get("pid"))
                if not seen[w] or seen[w][-1][1:] != obs:
                    seen[w].append((time.time(), *obs))
            stop.wait(period)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()


@contextlib.contextmanager
def host_proc(argv, out_path, env, cwd):
    """``argv`` (a host verb of the port's CLI: ``monitor``, ``front``) as
    a subprocess in a session of its own, unbuffered, its output sent to
    ``out_path``; killed whole if it is still running when the block
    ends.  Yields the ``Popen``."""
    with open(out_path, "w") as out:
        proc = subprocess.Popen(argv, cwd=cwd, env={**env,
                                                    "PYTHONUNBUFFERED": "1"},
                                stdout=out, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            yield proc
        finally:
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def stop_host_proc(label, proc, out_path, line):
    """SIGTERM ``proc`` (``host_proc``) and wait: its output, which must
    hold ``line``, and exit code 0, or it fails."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    with open(out_path) as f:
        text = f.read()
    if rc != 0 or line not in text:
        raise AssertionError(f"config O-alerts: {label} exited {rc}: "
                             f"{text[-2000:]}")
    return text


def wait_for_line(label, proc, out_path, pattern, timeout=60.0):
    """The first match of ``pattern`` in ``proc``'s output file, waiting
    up to ``timeout`` seconds; fails if the process ends first."""
    deadline = time.monotonic() + timeout
    while True:
        with open(out_path) as f:
            m = re.search(pattern, f.read())
        if m:
            return m
        if proc.poll() is not None or time.monotonic() > deadline:
            with open(out_path) as f:
                raise AssertionError(f"config O-alerts: {label} printed no "
                                     f"{pattern!r}: {f.read()[-2000:]}")
        time.sleep(0.05)


@contextlib.contextmanager
def health_log(url, period=0.05):
    """Inside the block, a thread GETs ``url``/healthz every ``period``
    seconds and records (wall time, status, firing rules) each time the
    answer changes; an error is recorded as status "error"."""
    seen = []
    stop = threading.Event()

    def poll():
        while not stop.is_set():
            try:
                doc = http_json(f"{url}/healthz", timeout=5.0)[2]
                obs = (doc["status"], tuple(sorted(
                    f["rule"] for f in doc.get("alerts", {}).get(
                        "firing", ()))))
            except Exception as exc:  # noqa: BLE001 - recorded
                obs = ("error", (repr(exc),))
            if not seen or seen[-1][1:] != obs:
                seen.append((time.time(), *obs))
            stop.wait(period)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield seen
    finally:
        stop.set()
        thread.join()


def run_config_o(torch, seed, e, n, smi, cache):
    """The serve fleet on the card (``supervise --role serve``), on config
    E's 51 books and E's card model, right after N, whose model copy and
    in-process per-document reference bytes it reuses, with the compile
    cache the compile-cache phase warmed (``--compile-cache``): every
    replica incarnation loads its kernel from the store, with no miss.

    ``cli supervise --role serve --device cuda --workers 2 --max-workers 3
    --front-port 0 --actions-file A --serve-max-batch 8 --serve-linger-ms
    5`` with N's token buckets passed to each replica (``--worker-arg``),
    ``--heartbeat-interval 0.2 --lease-timeout 5 --grace-seconds 2
    --startup-grace 60``, the supervisor's and each replica incarnation's
    telemetry, as a subprocess.  8 client threads, each its own
    ``X-STC-Stream``, send one book a request through the front, two
    passes over the books; mid-way through pass 1 N's newer model is
    published and rolls through both replicas; mid-way through pass 2
    replica 1 gets SIGKILL and is respawned while the front retries on
    replica 0 (the second half of pass 2 waits for the kill, which waits
    for the roll).

    O-alerts, on the same fleet: from the front's announce (a CLI process
    takes 7-9 s to start on the card's host, and the kill must fall inside
    pass 2), ``cli monitor --fleet-dir --stream '<wtel>/worker-*.jsonl'
    --builtin replica_down`` (retuned to 1 s, ``O_DOWN_RULES``)
    ``--alerts-file L --interval 0.25`` and a standalone ``cli front
    --alerts-file L`` (port 0; it announces itself in the fleet's
    ``front.json``, so the probe goes through it) run beside the fleet,
    both up before the traffic starts; the kill takes replica_down
    for key 1 to firing and the respawn's first beat resolves it, both in
    the checksummed log between the kill and the respawn's ready (plus
    ``O_SLACK_S``), none before the kill, and that front's ``/healthz``
    says ``degraded`` naming the rule while it fires and ``ok`` after.
    After the recovery a second ``monitor --actions-file A --rules``
    (``serve_p99`` retuned to fire on the replicas' own card batches)
    asks for one ``scale_out``, which the supervisor applies exactly once
    (ack ``{"last_id": 0}``, one ``fleet_action``, ``fleet.actions_applied``
    1, a ``resize`` fence record to 3 with a ``fleet_resize`` event why
    ``alert_serve_p99``, no second action while the alert keeps firing):
    replica 2 spawns beside the serving two, which never leave ``ready``,
    while ``cli probe --count 5 --rate 5`` runs.  Pass 3, one pass over
    the books, then goes through the three replicas, and SIGTERM drains
    them.

    O fails unless every request succeeds; the kill falls inside pass 2;
    each stream's generations
    never go backward; every response's distribution equals in bytes the
    in-process card ``topic_distribution(rows, convergence="per_doc")`` of
    the model its ``X-STC-Generation`` names (and its result names),
    whichever replica answered; both replicas served passes 1-2 and
    replica 2 answered in pass 3; every replica incarnation's stream has a
    manifest on the card (``backend`` "gpu"), a ``serve_warmup`` and
    per-document kernel launches (a replica on the CPU launches none);
    one ``fleet_swap_roll_done`` with ``swapped`` 2 and no
    ``fleet_swap_stalled``; one respawn, the killed replica's lease gone
    before its respawn's first beat; the probe reports no failure and no
    pin violation; the monitors and the standalone front exit 0 on
    SIGTERM; the supervisor exits 0 with its ``serve fleet drained: 3``
    line and no replica process outlives it."""
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.resilience.supervisor import (
        FleetLedger,
    )
    from spark_text_clustering_tpu_torch.serving.front import model_stamp
    from spark_text_clustering_tpu_torch.telemetry.alerts import AlertLog

    t_start = time.perf_counter()
    root = os.path.join(e["root"], "O")
    models = os.path.join(root, "models")
    fleet = os.path.join(root, "fleet")
    wtel = os.path.join(root, "wtel")
    sup_tel = os.path.join(root, "sup.jsonl")
    actions = os.path.join(root, "actions.json")
    alerts = os.path.join(root, "alerts.jsonl")
    os.makedirs(models)
    model_a, model_b = n["model_a"], n["model_b"]
    shutil.copytree(model_a, os.path.join(models, os.path.basename(model_a)))
    stamp_a, stamp_b = model_stamp(model_a), model_stamp(model_b)
    want = {stamp_a: n["by_model"][model_a], stamp_b: n["by_model"][model_b]}
    texts, names = n["texts"], n["names"]
    buckets = [f"--worker-arg={x}" for t in N_BUCKETS
               for x in ("--token-bucket", str(t))]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("STC_FAULTS", "STC_FAULT_SEED")}
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cli = [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli"]
    argv = [*cli, "supervise", "--role", "serve", "--device", "cuda",
            "--workers", str(O_WORKERS), "--max-workers", str(O_MAX_WORKERS),
            "--front-port", "0", "--fleet-dir", fleet, "--actions-file",
            actions, "--models-dir", models, "--stop-words", e["stop"],
            "--serve-max-batch", str(N_MAX_BATCH), "--serve-linger-ms", "5",
            *buckets, "--heartbeat-interval", "0.2", "--lease-timeout", "5",
            "--grace-seconds", "2", "--startup-grace", "60",
            "--worker-telemetry-dir", wtel, "--telemetry-file", sup_tel,
            "--max-seconds", "300", "--compile-cache", cache]
    rules = {}
    for tag, spec in (("down", O_DOWN_RULES), ("p99", O_P99_RULES)):
        rules[tag] = os.path.join(root, f"rules_{tag}.json")
        with open(rules[tag], "w") as f:
            json.dump(spec, f)
    stream_glob = os.path.join(wtel, "worker-*.jsonl")
    mon_argv = [*cli, "monitor", "--fleet-dir", fleet, "--stream",
                stream_glob, "--builtin", "replica_down", "--rules",
                rules["down"], "--alerts-file", alerts, "--interval", "0.25",
                "--telemetry-file", os.path.join(root, "monitor.jsonl")]
    scale_argv = [*cli, "monitor", "--stream", stream_glob, "--rules",
                  rules["p99"], "--actions-file", actions, "--alerts-file",
                  os.path.join(root, "alerts_p99.jsonl"), "--interval",
                  "0.25", "--telemetry-file",
                  os.path.join(root, "monitor_p99.jsonl")]
    front_argv = [*cli, "front", "--fleet-dir", fleet, "--port", "0",
                  "--alerts-file", alerts]
    outs = {name: os.path.join(root, f"{name}.out")
            for name in ("supervise", "monitor", "monitor_p99", "front")}
    items = [(p, i) for p in range(O_PASSES) for i in range(len(texts))]
    pass3 = [(O_PASSES, i) for i in range(len(texts))]
    # the second half of pass 2 waits for the kill, which waits for the
    # roll and the monitor: the kill falls inside pass 2 on any host
    half = len(texts) // 2
    todo, held = items[:len(texts) + half], items[len(texts) + half:]
    kill_gate = threading.Event()
    done, failures, records = [], [], []
    lock = threading.Lock()
    marks = {}
    with lease_log(fleet, O_MAX_WORKERS) as leases, \
            open(outs["supervise"], "w+") as out:
        t0_wall = time.time()
        proc = subprocess.Popen(argv, cwd=here, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        hosts = contextlib.ExitStack()
        try:
            deadline = time.monotonic() + 60.0
            front = os.path.join(fleet, "front.json")
            while not os.path.exists(front):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("config O: no front announce")
                time.sleep(0.02)
            marks["announce"] = time.time()
            with open(front) as f:
                url = f"http://127.0.0.1:{json.load(f)['port']}"
            # O-alerts' first monitor and the standalone front start with
            # the fleet (a CLI process takes 7-9 s to come up on the card's
            # host): the kill below must fall mid-way through pass 2
            mon = hosts.enter_context(
                host_proc(mon_argv, outs["monitor"], env, here))
            sfront = hosts.enter_context(
                host_proc(front_argv, outs["front"], env, here))
            deadline = time.monotonic() + 120.0
            while http_json(f"{url}/healthz")[2]["ready"] < O_WORKERS:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("config O: replicas not ready")
                time.sleep(0.05)
            marks["ready"] = time.time()
            furl = wait_for_line("front", sfront, outs["front"],
                                 r"on (http://[\d.]+:\d+)").group(1)
            wait_for_line("monitor", mon, outs["monitor"],
                          r"monitoring \d+ rule")
            marks["monitor_up"] = time.time()

            def next_item():
                while True:
                    with lock:
                        if todo:
                            return todo.pop(0)
                        if not held:
                            return None
                    kill_gate.wait()
                    with lock:
                        todo.extend(held)
                        held.clear()

            def client(c):
                while True:
                    item = next_item()
                    if item is None:
                        return
                    p, i = item
                    t0 = time.perf_counter()
                    try:
                        status, hdrs, doc = http_json(
                            f"{url}/score", {"texts": [texts[i]],
                                             "names": [names[i]]},
                            headers={"X-STC-Stream": f"o-{c}"})
                        hdrs = {k.lower(): v for k, v in hdrs.items()}
                    except Exception as exc:  # noqa: BLE001 - counted
                        with lock:
                            failures.append(f"{item}: {exc!r}")
                        continue
                    secs = time.perf_counter() - t0
                    if status != 200 or "distribution" not in doc.get(
                            "results", [{}])[0]:
                        with lock:
                            failures.append(f"{item}: {status} {doc}")
                        continue
                    with lock:
                        records.append({
                            "stream": c, "pass": p, "book": i,
                            "seconds": secs, "done": time.time(),
                            "generation": int(hdrs["x-stc-generation"]),
                            "replica": int(hdrs["x-stc-replica"]),
                            "model": doc["results"][0]["model"]["model"],
                            "dist": served(doc["results"])[0]})
                        done.append(item)

            def start_clients():
                threads = [threading.Thread(target=client, args=(c,))
                           for c in range(O_CLIENTS)]
                for c in threads:
                    c.start()
                return threads

            clients = start_clients()
            t_traffic = time.perf_counter()
            # mid-way through pass 1: N's newer model, published as a
            # stream trainer does (a complete dir renamed into place)
            while len(done) < half and any(c.is_alive()
                                           for c in clients):
                time.sleep(0.005)
            staged = os.path.join(root, "staged_model")
            shutil.copytree(model_b, staged)
            os.rename(staged, os.path.join(models,
                                           os.path.basename(model_b)))
            marks["publish"] = time.time()
            # mid-way through pass 2, the roll done and the monitor
            # polling: SIGKILL replica 1

            def rolled():
                return all(next((o[3] for o in reversed(leases[w])
                                 if o[1] is not None), None) == stamp_b
                           for w in range(O_WORKERS))

            with health_log(furl) as healths:
                deadline = time.monotonic() + 120.0
                while (len(done) < len(texts) + half or not rolled()
                       or time.time() < marks["monitor_up"] + 1.0):
                    if failures or time.monotonic() > deadline:
                        raise AssertionError(
                            f"config O: {len(done)} answered, rolled "
                            f"{rolled()}, failures {failures[:4]}")
                    time.sleep(0.005)
                victim = [o for o in leases[1] if o[1] is not None][-1]
                os.kill(victim[4], signal.SIGKILL)
                marks["kill"] = time.time()
                with lock:
                    done_at_kill = len(done)
                    # the held half waited this long for the kill
                    gate_wait = max(0.0, marks["kill"] - max(
                        r["done"] for r in records))
                kill_gate.set()
                for c in clients:
                    c.join()
                traffic_s = time.perf_counter() - t_traffic
                deadline = time.monotonic() + 90.0
                while not any(o[1] not in (None, victim[1])
                              and o[2] == "ready" for o in leases[1]):
                    if proc.poll() is not None or (
                            time.monotonic() > deadline):
                        raise AssertionError(
                            "config O: no respawned replica")
                    time.sleep(0.05)
                marks["recovered"] = time.time()
                # the resolve lands at the respawn's first beat (plus
                # the rule's 0.5 s), before its ready; then a
                # /healthz answer after it
                deadline = time.monotonic() + 20.0
                while True:
                    logged = AlertLog(alerts).replay()[0]
                    if len(logged) >= 2 and healths[-1][0] >= (
                            logged[-1]["ts"]):
                        break
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"config O-alerts: alerts {logged}, "
                            f"/healthz {healths}")
                    time.sleep(0.05)
            mon_out = stop_host_proc("monitor", mon, outs["monitor"],
                                     "monitor done:")
            # the scale-out: a second monitor's serve_p99 action,
            # the probe beside it (through the standalone front)
            with host_proc(scale_argv, outs["monitor_p99"], env,
                           here) as scale_mon:
                marks["scale_monitor"] = time.time()
                with beside(lambda: subprocess.run(
                        [*cli, "probe", "--fleet-dir", fleet,
                         *O_PROBES], cwd=here, env=env,
                        capture_output=True, text=True,
                        timeout=120)) as probe_box:
                    deadline = time.monotonic() + 120.0
                    while http_json(f"{url}/healthz")[2]["ready"] < (
                            O_MAX_WORKERS):
                        if proc.poll() is not None or (
                                time.monotonic() > deadline):
                            raise AssertionError(
                                "config O-alerts: no third replica")
                        time.sleep(0.05)
                    marks["scaled"] = time.time()
                probe = probe_box["out"]
                # pass 3 through the three replicas, the alert firing
                todo.extend(pass3)
                t_pass3 = time.perf_counter()
                for c in start_clients():
                    c.join()
                pass3_s = time.perf_counter() - t_pass3
                scale_out = stop_host_proc(
                    "monitor_p99", scale_mon, outs["monitor_p99"],
                    "monitor done:")
            stop_host_proc("front", sfront, outs["front"],
                           "front drained:")
            marks["term"] = time.time()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            marks["exited"] = time.time()
        finally:
            hosts.close()
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        out.seek(0)
        sup_out = out.read()
    seconds = time.perf_counter() - t_start

    # the drain and the supervisor's stream
    if rc != 0 or f"serve fleet drained: {O_MAX_WORKERS} replica(s)" \
            not in sup_out:
        raise AssertionError(f"config O: supervise exited {rc}: "
                             f"{sup_out[-2000:]}")
    events = [json.loads(x) for x in open(sup_tel)]
    kinds = [x["event"] for x in events]
    spawns = [x for x in events if x["event"] == "fleet_spawn"]
    alive = sorted(x["pid"] for x in spawns if pid_alive(x["pid"]))
    (roll,) = [x for x in events if x["event"] == "fleet_swap_roll"]
    rolls = [x for x in events if x["event"] == "fleet_swap_roll_done"]
    respawns = [x for x in events if x["event"] == "fleet_respawn"]
    shutdown = [x for x in events if x["event"] == "fleet_shutdown"]
    if (len(rolls) != 1 or rolls[0]["swapped"] != O_WORKERS
            or rolls[0]["stamp"] != stamp_b
            or "fleet_swap_stalled" in kinds or len(respawns) != 1
            or respawns[0]["worker"] != 1
            or len(spawns) != O_MAX_WORKERS + 1
            or alive or [x["replicas"] for x in shutdown] != [O_MAX_WORKERS]):
        raise AssertionError(
            f"config O: rolls {rolls}, respawns {respawns}, "
            f"{len(spawns)} spawns, alive {alive}, events "
            f"{sorted(set(kinds))}")

    # the killed replica's lease retired before its respawn's first beat
    obs = leases[1]
    last_old = max(i for i, o in enumerate(obs) if o[1] == victim[1])
    first_new = min(i for i, o in enumerate(obs)
                    if o[1] not in (None, victim[1]))
    retired = any(o[1] is None for o in obs[last_old:first_new])
    if not retired:
        raise AssertionError(f"config O: replica 1's lease was never seen "
                             f"absent between incarnations: {obs}")
    respawn_beat = obs[first_new][0]
    respawn_ready = min(o[0] for o in obs[first_new:]
                        if o[1] == obs[first_new][1] and o[2] == "ready")

    # O-alerts: replica_down on the kill, resolved by the respawn's beat
    log, torn = AlertLog(alerts).replay()
    trans = [(r["rule"], r["key"], r["state"]) for r in log]
    firing_ts, resolved_ts = (log[0]["ts"], log[1]["ts"]) if len(
        log) == 2 else (None, None)
    if torn or trans != [("replica_down", "1", "firing"),
                         ("replica_down", "1", "resolved")] or not (
            marks["kill"] < firing_ts < resolved_ts
            <= respawn_ready + O_SLACK_S) or not (
            respawn_beat <= resolved_ts):
        raise AssertionError(
            f"config O-alerts: transitions {log} (torn {torn}); kill "
            f"{marks['kill']}, respawn beat {respawn_beat}, ready "
            f"{respawn_ready}")
    degraded = [h for h in healths if firing_ts <= h[0] < resolved_ts]
    after = [h for h in healths if h[0] >= resolved_ts]
    before = [h for h in healths if h[0] < marks["kill"]]
    if not any(h[1:] == ("degraded", ("replica_down",)) for h in degraded) \
            or not after or after[-1][1:] != ("ok", ()) or any(
            h[1:] != ("ok", ()) for h in before):
        raise AssertionError(f"config O-alerts: the standalone front's "
                             f"/healthz {healths} (firing {firing_ts}, "
                             f"resolved {resolved_ts})")
    if "fired: replica_down [1]" not in mon_out:
        raise AssertionError(f"config O-alerts: monitor {mon_out[-1000:]}")

    # O-alerts: exactly one scale_out applied, replica 2 beside the two
    acts = read_json(actions)["actions"]
    ack = read_json(actions + ".ack")
    applied = [x for x in events if x["event"] == "fleet_action"]
    resizes = [x for x in events if x["event"] == "fleet_resize"]
    fences = [(r["kind"], r["worker_count"]) for r in
              FleetLedger(fleet).records()]
    registry = [x for x in events if x["event"] == "registry"]
    counted = registry[-1]["snapshot"]["counters"].get(
        "fleet.actions_applied") if registry else None
    if ([(a["id"], a["kind"], a["alert"]) for a in acts]
            != [(0, "scale_out", "serve_p99")] or ack != {"last_id": 0}
            or [(x["id"], x["kind"], x["why"]) for x in applied]
            != [(0, "scale_out", "alert_serve_p99")]
            or [(x["workers_to"], x["why"]) for x in resizes]
            != [(O_MAX_WORKERS, "alert_serve_p99")]
            or fences.count(("resize", O_MAX_WORKERS)) != 1
            or counted != 1 or "fired: serve_p99" not in scale_out):
        raise AssertionError(
            f"config O-alerts: actions {acts}, ack {ack}, applied "
            f"{applied}, resizes {resizes}, fences {fences}, counter "
            f"{counted}, monitor {scale_out[-800:]}")
    t_action = applied[0]["ts"]
    for w in range(O_WORKERS):
        at = [o for o in leases[w] if o[0] <= t_action][-1]
        later = [o for o in leases[w] if t_action < o[0] < marks["term"]]
        if at[2] != "ready" or any(o[1] != at[1] or o[2] != "ready"
                                   for o in later):
            raise AssertionError(f"config O-alerts: replica {w} left ready "
                                 f"after the scale-out: {at}, {later}")
    third = [o for o in leases[2] if o[1] is not None]
    third_ready = min((o[0] for o in third if o[2] == "ready"), default=None)
    if third_ready is None:
        raise AssertionError(f"config O-alerts: replica 2 {leases[2]}")

    # the probe
    m = re.search(r"probe done: (\d+) probe\(s\).*?(\d+) failure\(s\).*?"
                  r"(\d+) pin violation\(s\)", probe.stdout)
    if probe.returncode != 0 or m is None or int(m.group(1)) != 5 or (
            int(m.group(2)) or int(m.group(3))):
        raise AssertionError(f"config O probe: exit {probe.returncode}: "
                             f"{probe.stdout[-500:]} {probe.stderr[-1000:]}")

    # the traffic: every request, monotone streams, bytes per generation;
    # the kill fell inside pass 2
    if not len(texts) < done_at_kill < len(items):
        raise AssertionError(f"config O: the kill came after {done_at_kill} "
                             f"of {len(items)} requests")
    if failures or sorted(done) != sorted(items + pass3):
        raise AssertionError(f"config O: {len(failures)} failed requests "
                             f"({failures[:4]}), {len(done)} answered")
    streams = {}
    for r in sorted(records, key=lambda r: r["done"]):
        streams.setdefault(r["stream"], []).append(r["generation"])
    backward = {s: g for s, g in streams.items() if g != sorted(g)}
    wrong = [(r["pass"], r["book"], r["replica"], r["generation"])
             for r in records
             if r["generation"] not in want
             or model_stamp(r["model"]) != r["generation"]
             or r["dist"].tobytes() != want[r["generation"]][
                 r["book"]].tobytes()]
    shares, shares3 = {}, {}
    for r in records:
        into = shares3 if r["pass"] == O_PASSES else shares
        into[r["replica"]] = into.get(r["replica"], 0) + 1
    if backward or wrong or sorted(shares) != list(range(O_WORKERS)) or (
            stamp_b not in {r["generation"] for r in records}) or (
            not shares3.get(O_MAX_WORKERS - 1)) or any(
            r["generation"] != stamp_b for r in records
            if r["pass"] == O_PASSES):
        raise AssertionError(f"config O: streams going backward {backward}, "
                             f"responses not their model's bytes {wrong[:6]}"
                             f", replicas {shares}, pass 3 {shares3}")

    # each replica incarnation on the card, through the kernel
    replicas = {}
    for name in sorted(os.listdir(wtel)):
        ev = [json.loads(x) for x in open(os.path.join(wtel, name))
              if x.strip()]
        kl = [x for x in ev if x["event"] == "kernel_launches"]
        launched = max((x["topic_inference_segments"] for x in kl),
                       default=0)
        cache_ops = [x["op"] for x in ev if x["event"] == "compile_cache"]
        if (not ev or ev[0]["event"] != "manifest"
                or ev[0].get("backend") != "gpu"
                or "serve_warmup" not in [x["event"] for x in ev]
                or launched <= 0 or "hit" not in cache_ops
                or "miss" in cache_ops):
            raise AssertionError(f"config O: replica stream {name}: "
                                 f"{ev[:1]}, launches {launched}, compile "
                                 f"cache {cache_ops}")
        replicas[name[:-len(".jsonl")]] = {
            "launches": launched, "cache_hits": cache_ops.count("hit"),
            "drained": any(x["event"] == "serve_drained" for x in ev)}
    if len(replicas) != O_MAX_WORKERS + 1:
        raise AssertionError(f"config O: replica streams {sorted(replicas)}")
    third_stream = [v for k, v in replicas.items()
                    if k.startswith(f"worker-w{O_MAX_WORKERS - 1:03d}-")]

    def first(w, pred):
        return min((o[0] for o in leases[w] if pred(o)), default=None)

    spawned = {(x["worker"], x["spawn_id"]): x["ts"] for x in spawns}
    ready_s = {}
    for (w, sid), ts in sorted(spawned.items()):
        at = first(w, lambda o, s=sid: o[1] == s and o[2] == "ready")
        ready_s[f"w{w}/s{sid}"] = None if at is None else at - ts
    lat = np.asarray([r["seconds"] for r in records
                      if r["pass"] < O_PASSES]) * 1e3
    launches = sum(r["launches"] for r in replicas.values())
    return {
        "phase": "config_O", "card": smi, "replicas": O_WORKERS,
        "clients": O_CLIENTS, "requests": len(records),
        "books": len(texts), "k": EN_K, "buckets": list(N_BUCKETS),
        "max_batch": N_MAX_BATCH,
        "spawn_to_announce_s": marks["announce"] - t0_wall,
        "spawn_to_ready_s": ready_s,
        "spawn_to_fleet_ready_s": marks["ready"] - t0_wall,
        "request_p50_ms": float(np.percentile(lat, 50)),
        "request_p99_ms": float(np.percentile(lat, 99)),
        "docs_per_s": len(items) / (traffic_s - gate_wait),
        "gate_wait_s": gate_wait,
        "publish_to_roll_done_s": rolls[0]["ts"] - marks["publish"],
        "roll_started_after_publish_s": roll["ts"] - marks["publish"],
        "swap_lag_s": rolls[0]["swap_lag_seconds"],
        "time_to_recover_s": marks["recovered"] - marks["kill"],
        "drain_s": marks["exited"] - marks["term"],
        "requests_by_replica": {str(k): v for k, v in sorted(
            shares.items())},
        "requests_by_generation": {
            str(g): sum(1 for r in records if r["generation"] == g)
            for g in sorted(want)},
        "replica_streams": replicas,
        "probe": probe.stdout.strip().splitlines()[-1],
        "failed_requests": 0, "streams_monotone": True,
        "served_bytes_equal_per_doc": True,
        "alerts": {
            "replica_down": {"firing_ts": firing_ts,
                             "resolved_ts": resolved_ts,
                             "kill_ts": marks["kill"],
                             "respawn_first_beat_ts": respawn_beat,
                             "respawn_ready_ts": respawn_ready},
            "kill_to_firing_s": firing_ts - marks["kill"],
            "kill_to_respawn_first_beat_s": respawn_beat - marks["kill"],
            "respawn_to_resolved_s": resolved_ts - respawn_beat,
            "front_healthz": [[h[0] - marks["kill"], h[1], list(h[2])]
                              for h in healths],
            "scale_out": {"action_ts": acts[0]["ts"],
                          "applied_ts": t_action,
                          "monitor_start_to_action_s":
                              acts[0]["ts"] - marks["scale_monitor"]},
            "action_to_replica_ready_s": third_ready - acts[0]["ts"],
            "pass3_requests_by_replica": {str(k): v for k, v in sorted(
                shares3.items())},
            "pass3_s": pass3_s,
            "third_replica_launches": sum(v["launches"]
                                          for v in third_stream),
            "rules": {"replica_down": O_DOWN_RULES,
                      "serve_p99": O_P99_RULES},
            "slack_s": O_SLACK_S},
        "launches": {name: (launches if name == "topic_inference_segments"
                            else 0) for name in _build.LAUNCHES},
        "seconds": seconds,
    }


def read_json(path):
    with open(path) as f:
        return json.load(f)


def profile_configs(torch, rows_a, rows_b, seed, out_dir):
    """torch.profiler over one fit and the scoring (A, B: padded scoring
    of every doc; D: topic_distribution of EVAL_DOCS docs) or evaluation
    (C, G: log-perplexity of EVAL_DOCS docs) of each config (count rows,
    no IDF), and over E's, F's and H's CLI ``train`` and ``score`` (the
    whole commands, text front end included; F's fit is the padded sweep,
    H's online VB): device time and calls by kernel name, and the
    device's busy share of the window's wall time.  The full tables go to
    ``<out_dir>/profile_{A,...,H}.txt`` when ``out_dir`` is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spark_text_clustering_tpu_torch import EMLDA, NMF, OnlineLDA, Params

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    def em_run(rows, k, v):
        vocab = [f"t{i}" for i in range(v)]
        opt = EMLDA(Params(k=k, max_iterations=SWEEPS, seed=seed))
        opt.fit(rows, vocab, max_iterations=1).topic_distribution(
            rows, layout="padded")                          # warm-up
        return (lambda: opt.fit(rows, vocab),
                lambda model: model.topic_distribution(rows, layout="padded"))

    def online_run(rows, params):
        vocab = [f"h{i}" for i in range(NG_V)]
        opt = OnlineLDA(params)
        opt.fit(rows, vocab).log_perplexity(rows[:EVAL_DOCS])  # warm-up
        return (lambda: opt.fit(rows, vocab),
                lambda model: model.log_perplexity(rows[:EVAL_DOCS]))

    def nmf_run(rows):
        vocab = [f"h{i}" for i in range(NG_V)]
        opt = NMF(nmf_params(seed))
        opt.fit(rows, vocab).topic_distribution(rows[:EVAL_DOCS])  # warm-up
        return (lambda: opt.fit(rows, vocab),
                lambda model: model.topic_distribution(rows[:EVAL_DOCS]))

    def cli_run(root, words=(8_000, 120_000), extra=()):
        stop = en_books_dir(seed, root, words=words)
        books, models = os.path.join(root, "books"), os.path.join(root, "m")

        def train():
            run_cli(["train", "--books", books, "--stop-words", stop,
                     "--models-dir", models, *extra],
                    os.path.join(root, "train.out"))

        def score(_):
            run_cli(["score", "--books", books, "--stop-words", stop,
                     "--models-dir", models, "--output-dir",
                     os.path.join(root, "o")], os.path.join(root, "s.out"))
        return train, score

    cli_root = tempfile.mkdtemp(prefix="chip_smoke_E_")
    for label, make in (("A", lambda: em_run(rows_a, EN_K, EN_V)),
                        ("B", lambda: em_run(rows_b, NG_K, NG_V)),
                        ("C", lambda: online_run(rows_b,
                                                 online_params(seed))),
                        ("D", lambda: nmf_run(rows_b)),
                        ("E", lambda: cli_run(os.path.join(cli_root, "E"))),
                        ("F", lambda: cli_run(os.path.join(cli_root, "F"),
                                              (F_WORDS, F_WORDS))),
                        ("G", lambda: online_run(
                            rows_b, online_defaults(NG_K, seed))),
                        ("H", lambda: cli_run(
                            os.path.join(cli_root, "H"),
                            extra=("--algorithm", "online")))):
        fit, score = make()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model = fit()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            score(model)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        events = prof.key_averages()
        # device-side events only (kernels, copies): an operator's row
        # repeats the time of the kernels it launched
        on_device = [e for e in events
                     if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
        busy_us = sum(dev_us(e) for e in on_device)
        top = sorted(on_device, key=lambda e: -dev_us(e))[:12]
        if out_dir:
            with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
                f.write(events.table(sort_by="self_cuda_time_total",
                                     row_limit=40))
        emit({
            "phase": f"profile_{label}", "fit_s": t1 - t0,
            "score_s": t2 - t1, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / (t2 - t0),
            "top_device_ms": [[e.key[:60], dev_us(e) / 1e3, e.count]
                              for e in top],
        })
    shutil.rmtree(cli_root, ignore_errors=True)


def start_doctor(build_dir):
    """``cli doctor --probe-timeout 120`` started as a subprocess of the
    port's CLI from this checkout (the entry a user calls), with the build
    directory's listing before it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("STC_FAULTS", "STC_FAULT_SEED")}
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    listing = sorted(os.listdir(build_dir))
    proc = subprocess.Popen(
        [sys.executable, "-m", "spark_text_clustering_tpu_torch.cli",
         "doctor", "--probe-timeout", "120"], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, listing, time.perf_counter()


def check_doctor(torch, started, build_dir, digest, n_sources):
    """The doctor's report on this card: exit 0, the accelerator OK and
    naming device 0, the CPU path and the text library OK, nvcc found
    and every library built for ``digest`` in ``build_dir``, whose
    listing the doctor left as it was."""
    proc, listing, t0 = started
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    lines = out.splitlines()
    kernels = next((ln for ln in lines if ln.startswith(
        "  kernels (nvcc, sm_90a): ")), "")
    want = {
        "exit 0": proc.returncode == 0,
        "accelerator OK": (
            f"  accelerator: OK — torch {torch.__version__}, cuda "
            f"{torch.version.cuda}, {torch.cuda.device_count()} device(s) "
            f"({torch.cuda.get_device_name(0)})") in lines,
        "cpu path OK": "  cpu path (--device cpu, gloo): OK" in lines,
        "native textproc OK": "  native textproc (C++ ctypes): OK" in lines,
        "nvcc found": bool(kernels) and "nvcc missing" not in kernels,
        "every library built": kernels.endswith(
            f", {n_sources}/{n_sources} libraries built for {digest} in "
            f"{build_dir}"),
        "the build directory unchanged":
            sorted(os.listdir(build_dir)) == listing,
    }
    failed = sorted(k for k, held in want.items() if not held)
    if failed:
        raise AssertionError(f"doctor: {failed} failed: {out[-3000:]}")
    return {"phase": "doctor", "seconds": secs, "report": lines}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one fit and scoring of each config")
    ap.add_argument("--out", default=None,
                    help="directory for the full JSON record, the profile "
                         "tables and the compiler's register reports")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and hold the kernels against their plain "
                         "versions, then stop (no result line)")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch

    import spark_text_clustering_tpu_torch  # noqa: F401  (the port, or fail)
    from spark_text_clustering_tpu_torch import EMLDA, Params
    from spark_text_clustering_tpu_torch.interop import em_state_from_numpy
    from spark_text_clustering_tpu_torch.ops import _build
    from spark_text_clustering_tpu_torch.ops.lda_math import (
        dirichlet_expectation,
    )
    from spark_text_clustering_tpu_torch.utils import native

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 1. build
    t0 = time.perf_counter()
    text = None if args.kernels_only else native.start()
    secs = _build.build_all()
    if not args.kernels_only:
        native.finish(text)
        secs["textproc"] = time.perf_counter() - t0 if text else 0.0
    build = {"phase": "build", "seconds": time.perf_counter() - t0,
             "per_source_s": secs}
    emit(build)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for name in _build.SOURCES:
            log = _build._lib_path(name).with_suffix(".log")
            if log.exists():
                shutil.copy(log, os.path.join(args.out, f"ptxas_{name}.log"))

    # the doctor from this checkout, beside the corpora's generation
    doctor = None if args.kernels_only else start_doctor(_build.BUILD_DIR)
    t0 = time.perf_counter()
    try:
        rows_a = en_books_rows(args.seed)
        rows_b = newsgroups_rows(args.seed)
    except BaseException:
        if doctor is not None:
            doctor[0].kill()
            doctor[0].wait()
        raise
    emit({"phase": "corpora", "seconds": time.perf_counter() - t0,
          "A_docs": len(rows_a), "A_tokens": sum(len(i) for i, _ in rows_a),
          "B_docs": len(rows_b), "B_tokens": sum(len(i) for i, _ in rows_b)})
    if doctor is not None:
        doctor = check_doctor(torch, doctor, _build.BUILD_DIR,
                              _build._digest(), len(_build.SOURCES))
        emit(doctor)
        record["doctor"] = doctor

    # 2. each kernel against its plain version, at main-path shapes
    rng = np.random.default_rng(args.seed + 1)
    checks = {
        "em_sweep_fused": check_sweep(torch, rows_a, dev, rng, args.seed),
        # the edge geometries and the tile check draw from their own
        # generators, so the later checks draw the inputs they drew
        # before those existed
        "scatter_add_vtiles": check_scatter(
            torch, rows_b, dev, rng, np.random.default_rng(args.seed + 4),
            args.profile),
        "gamma_fixed_point_tiles": check_tiles(
            torch, rows_b, dev, np.random.default_rng(args.seed + 2),
            args.seed),
        "nmf_mu_update_tiles": check_nmf(torch, rows_b, dev, args.seed),
    }
    esteps = [
        check_estep(torch, rows, k, v, dev, rng, label, pick)
        for label, rows, k, v in (("A", rows_a, EN_K, EN_V),
                                  ("B", rows_b, NG_K, NG_V))
        for pick in ("docs", "width")
    ]
    estep_edges = check_estep_edges(
        torch, dev, np.random.default_rng(args.seed + 3))
    # the per-document kernel on 8 of A's rows at the widest serve bucket,
    # eb of a random lambda whose topics differ enough for A's books to
    # converge (config N repeats it on E's card model)
    lam_seg = np.random.default_rng(args.seed + 5).gamma(
        0.5, 4.0, (EN_K, EN_V)).astype(np.float32)
    seg_check = check_segments(
        torch, torch.exp(dirichlet_expectation(
            torch.from_numpy(lam_seg).to(dev))).T.contiguous(),
        torch.full((EN_K,), 50.0 / EN_K + 1.0, device=dev), rows_a, dev, "A")
    # and at k = 100 and 500 (the Wide instance) on the same rows
    seg_k = [check_segments_k(torch, rows_a, dev, k, args.seed + 6)
             for k in SEGMENTS_K]
    for c in (*checks.values(), *esteps, seg_check, *seg_k):
        emit({"phase": "kernel_vs_plain", **c})
    emit({"phase": "kernel_vs_plain_edges", "name": "gamma_fixed_point_bkl",
          "geometries": estep_edges})
    if args.kernels_only:
        if args.out:
            record.update(build=build, kernels=list(checks.values()),
                          estep_buckets=esteps, estep_edges=estep_edges,
                          segments=seg_check, segments_k=seg_k)
            with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
                json.dump(record, f, indent=1)
        return 0

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        # 3. config A, resumed from one random start drawn on the CPU
        def start_a(tf_rows):
            return soft_start(torch, tf_rows, EN_K, EN_V, args.seed)

        vocab_a = [f"t{i}" for i in range(EN_V)]
        summary_a, tfidf_a, ckpt_a, model_a = run_config(
            torch, "A", rows_a, vocab_a, EN_K, args.seed,
            workdir, resume_state=start_a)
        ckpt_cpu = os.path.join(workdir, "A_ckpt_cpu")
        em_state_from_numpy(ckpt_cpu, *start_a(tfidf_a["rows"]), step=0)
        t0 = time.perf_counter()
        cpu_opt = EMLDA(Params(k=EN_K, max_iterations=SWEEPS,
                               checkpoint_dir=ckpt_cpu,
                               checkpoint_interval=10 * SWEEPS),
                        device="cpu")
        cpu_model = cpu_opt.fit(tfidf_a["rows"], vocab_a)
        cpu_avg = cpu_opt.last_log_likelihood / len(rows_a)
        rel = abs(cpu_avg - summary_a["avg_log_likelihood"]) / abs(cpu_avg)
        summary_a.update({
            "cpu_plain_avg_log_likelihood": cpu_avg,
            "cpu_plain_fit_s": time.perf_counter() - t0,
            "avg_log_likelihood_rel_diff": rel,
            "lam_max_rel_diff": float(np.max(
                np.abs(cpu_model.lam - model_a.lam)
                / np.maximum(np.abs(cpu_model.lam), 1.0))),
        })
        if summary_a["launches"]["em_sweep_fused"] != SWEEPS or (
            summary_a["launches"]["gamma_fixed_point_bkl"] == 0
        ):
            raise AssertionError(f"config A skipped a kernel: "
                                 f"{summary_a['launches']}")
        if not rel <= 1e-4:
            raise AssertionError(
                f"config A: CUDA and CPU avg logLik differ by {rel}")
        emit(summary_a)
        overhead = telemetry_overhead(torch, tfidf_a, ckpt_a, args.seed)
        emit(overhead)

        # 4. config B
        vocab_b = [f"h{i}" for i in range(NG_V)]
        summary_b, _, _, _ = run_config(
            torch, "B", rows_b, vocab_b, NG_K, args.seed, workdir)
        if summary_b["launches"]["scatter_add_vtiles"] == 0 or (
            summary_b["launches"]["gamma_fixed_point_bkl"] == 0
        ):
            raise AssertionError(f"config B skipped a kernel: "
                                 f"{summary_b['launches']}")
        if not np.isfinite(summary_b["avg_log_likelihood"]):
            raise AssertionError("config B: log-likelihood is not finite")
        emit(summary_b)

        # 5. config C
        summary_c = run_config_c(torch, rows_b, args.seed, workdir)
        emit(summary_c)

        # 6. config D
        summary_d = run_config_d(torch, rows_b, args.seed, workdir)
        emit(summary_d)

        # 7. config E, the CLI
        t0 = time.perf_counter()
        summary_e, books_e = run_config_e(torch, args.seed, workdir)
        summary_e["seconds"] = time.perf_counter() - t0
        emit(summary_e)

        # 8. config F, the padded EM layout and the MLlib artifacts
        t0 = time.perf_counter()
        summary_f = run_config_f(torch, args.seed, workdir, smi)
        summary_f["seconds"] = time.perf_counter() - t0
        emit(summary_f)

        # 9. config G, online VB with the defaults on C's rows
        t0 = time.perf_counter()
        summary_g = run_config_g(torch, rows_b, args.seed, workdir)
        summary_g["seconds"] = time.perf_counter() - t0
        emit(summary_g)

        # 10. config H, online VB through the CLI on E's books
        t0 = time.perf_counter()
        summary_h = run_config_h(torch, args.seed, books_e)
        summary_h["seconds"] = time.perf_counter() - t0
        emit(summary_h)

        # 11. config I, EM and scoring on a 2x2 grid of ranks on the card
        t0 = time.perf_counter()
        summary_i = run_config_i(torch, args.seed, books_e)
        summary_i["seconds"] = time.perf_counter() - t0
        emit({key: val for key, val in summary_i.items() if key != "checks"})
        emit({"phase": "config_I_kernel_vs_plain", **{
            name: {"max_abs_err": max(c["max_abs_err"] for c in cases),
                   "ms": [c["ms"] for c in cases],
                   "plain_ms": [c["plain_ms"] for c in cases]}
            for name, cases in summary_i["checks"].items()}})

        # 12. config J, online VB and NMF on a 2x2 grid of ranks on the card
        t0 = time.perf_counter()
        summary_j = run_config_j(torch, args.seed, books_e,
                                 summary_c["log_perplexity"])
        summary_j["seconds"] = time.perf_counter() - t0
        emit({key: val for key, val in summary_j.items() if key != "checks"})
        emit({"phase": "config_J_kernel_vs_plain", **{
            name: {"max_abs_err": max(c["max_abs_err"] for c in cases),
                   "ms": [c["ms"] for c in cases],
                   "plain_ms": [c["plain_ms"] for c in cases],
                   "bound_ms": [c["bound_ms"] for c in cases]}
            for name, cases in summary_j["checks"].items()}})

        # 13. config K, one-process streaming through the CLI on E's books
        t0 = time.perf_counter()
        summary_k = run_config_k(torch, args.seed, books_e)
        summary_k["seconds"] = time.perf_counter() - t0
        emit(summary_k)

        # 14. config L, the supervised stream fleet on E's books
        t0 = time.perf_counter()
        summary_l = run_config_l(torch, args.seed, books_e, smi)
        summary_l["seconds"] = time.perf_counter() - t0
        emit(summary_l)

        # 15. config M, streaming on a 2x2 grid of ranks on E's books
        t0 = time.perf_counter()
        summary_m = run_config_m(torch, args.seed, books_e, smi)
        summary_m["seconds"] = time.perf_counter() - t0
        emit(summary_m)

        # 16. config N, one serve replica on E's books and card model
        summary_n, n_refs = run_config_n(torch, args.seed, books_e, smi)
        emit(summary_n)

        # 17. the compile cache on N's model, warmed for O's fleet
        summary_cc, cc_store = run_compile_cache(torch, books_e, n_refs, smi)
        emit(summary_cc)
        emit({"phase": "compile_cache_seconds",
              "seconds": summary_cc["seconds"]})

        # 18. config O, the serve fleet on N's models and references, its
        # replicas loading their kernel from the warmed store
        summary_o = run_config_o(torch, args.seed, books_e, n_refs, smi,
                                 cc_store)
        emit(summary_o)
        emit({"phase": "config_O_spawn_to_ready", "card": smi,
              "compile_cache": True,
              "spawn_to_ready_s": summary_o["spawn_to_ready_s"],
              "spawn_to_fleet_ready_s": summary_o["spawn_to_fleet_ready_s"]})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    if args.profile:
        profile_configs(torch, rows_a, rows_b, args.seed, args.out)

    # 19. the seconds the telemetry phases added to the run
    added = {"A_overhead": overhead["seconds"],
             "E": summary_e["telemetry"]["seconds"],
             "K": summary_k["telemetry"]["seconds"],
             "M": summary_m["telemetry"]["seconds"]}
    telemetry_line = {"phase": "telemetry", "added_s": sum(added.values()),
                      "per_config_s": added,
                      "overhead_share": overhead["estimated_overhead_share"]}
    emit(telemetry_line)

    # 20. the kernels line; the sweep's error is the largest of config A's
    # and config E's checks and config I's ranks'; the gamma row is config
    # B's most populated bucket, and its error the largest of the four
    # buckets, the edge geometries, config H's, K's and L's launches
    # checked and config I's, J's and M's ranks' (its config_M entry: M's
    # launches, error and widest rank launch); the scatter's includes config
    # I's ranks'; the tile row's error includes config G's launches and
    # J's ranks', the NMF row's J's ranks'
    grid_err = {name: max(c["max_abs_err"] for c in cases)
                for name, cases in summary_i["checks"].items()}
    j_err = {name: max(c["max_abs_err"] for c in cases)
             for name, cases in summary_j["checks"].items()}
    sweep = checks["em_sweep_fused"]
    sweep["config_E"] = summary_e["sweep_check"]
    sweep["config_I"] = summary_i["checks"]["em_sweep_fused"]
    sweep["max_abs_err"] = max(sweep["max_abs_err"],
                               sweep["config_E"]["max_abs_err"],
                               grid_err["em_sweep_fused"])
    scatter = checks["scatter_add_vtiles"]
    scatter["config_I"] = summary_i["checks"]["scatter_add_vtiles"]
    scatter["max_abs_err"] = max(scatter["max_abs_err"],
                                 grid_err["scatter_add_vtiles"])
    tiles = checks["gamma_fixed_point_tiles"]
    tiles["config_G"] = summary_g["kernel"]
    tiles["config_J"] = summary_j["checks"]["gamma_fixed_point_tiles"]
    tiles["max_abs_err"] = max(tiles["max_abs_err"],
                               tiles["config_G"]["max_abs_err"],
                               j_err["gamma_fixed_point_tiles"])
    nmf_row = checks["nmf_mu_update_tiles"]
    nmf_row["config_J"] = summary_j["checks"]["nmf_mu_update_tiles"]
    nmf_row["max_abs_err"] = max(nmf_row["max_abs_err"],
                                 j_err["nmf_mu_update_tiles"])
    kernels = [
        sweep,
        checks["scatter_add_vtiles"],
        tiles,
        nmf_row,
        {**esteps[2], "route": "cuda",
         "source": "spark_text_clustering_tpu_torch/csrc/estep.cu",
         "replaces": "spark_text_clustering_tpu/ops/pallas_estep.py:161",
         "max_abs_err": max([e["max_abs_err"] for e in (*esteps, *estep_edges)]
                            + [summary_h["kernel"]["max_abs_err"],
                               summary_h["k100"]["train_kernel"]["max_abs_err"],
                               summary_h["k100"]["score_kernel"]["max_abs_err"],
                               summary_k["kernel"]["max_abs_err"],
                               summary_l["kernel"]["max_abs_err"],
                               summary_m["kernel"]["max_abs_err"],
                               grid_err["gamma_fixed_point_bkl"],
                               j_err["gamma_fixed_point_bkl"]]),
         "buckets": esteps, "geometries": estep_edges,
         "config_H": summary_h["kernel"], "config_K": summary_k["kernel"],
         "config_H_k100": {run: summary_h["k100"][f"{run}_kernel"]
                           for run in ("train", "score")},
         "config_L": summary_l["kernel"], "config_M": summary_m["kernel"],
         "config_I": summary_i["checks"]["gamma_fixed_point_bkl"],
         "config_J": summary_j["checks"]["gamma_fixed_point_bkl"]},
        # the per-document kernel: config N's check on E's card model at a
        # serve dispatch's shapes, and phase 2's on A's rows; its launches
        # also config O's replicas'
        {**summary_n["kernel"], "config_A": seg_check, "at_k": seg_k,
         "config_O": {"launches": summary_o["launches"][
             "topic_inference_segments"]},
         "max_abs_err": max([seg_check["max_abs_err"],
                             summary_n["kernel"]["max_abs_err"]]
                            + [c["max_abs_err"] for c in seg_k])},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = []
    for kern in kernels:
        name = kern["name"]
        kern["launches"] = sum(
            sm["launches"][name]
            for sm in (summary_a, summary_b, summary_c, summary_d, summary_e,
                       summary_f, summary_g, summary_h, summary_i,
                       summary_j, summary_k, summary_l, summary_m,
                       summary_n, summary_o))
        if kern["launches"] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
        line.append({k_: kern[k_] for k_ in keys})
        if "config_M" in kern:
            m_kern = kern["config_M"]
            line[-1]["config_M"] = {
                "launches": summary_m["launches"][name],
                "max_abs_err": m_kern["max_abs_err"],
                **{k_: max(c[k_] for c in m_kern["widest"])
                   for k_ in ("ms", "plain_ms", "bound_ms")}}
    record.update(build=build, kernels=kernels, config_A=summary_a,
                  telemetry_overhead=overhead, telemetry=telemetry_line,
                  config_B=summary_b, config_C=summary_c, config_D=summary_d,
                  config_E=summary_e, config_F=summary_f, config_G=summary_g,
                  config_H=summary_h, config_I=summary_i, config_J=summary_j,
                  config_K=summary_k, config_L=summary_l,
                  config_M=summary_m, config_N=summary_n,
                  compile_cache=summary_cc, config_O=summary_o)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(record, f, indent=1)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
