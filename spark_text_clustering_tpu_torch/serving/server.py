"""The scoring service core: model host, warmup, hot-swap, HTTP front (the
JAX package's ``serving/server.py``, ported).

Three moving parts (docs/SERVING.md has the protocol diagram):

  * ``ServeScorer`` — an IMMUTABLE snapshot of one verified model plus
    everything scoring needs (preprocessor, vectorizer, the device-resident
    ``exp(E[log beta])`` table [V, k], alpha and the pinned gamma0), on one
    torch device.  Built and WARMED off the serving path; the service
    swings one reference between snapshots, so "which model answered" is
    decided per batch by whichever snapshot the dispatch captured — never
    a torn mix.  A swapped-out snapshot's tensors are freed when the last
    dispatch holding it returns.
  * ``ScoringService`` — accept -> vectorize -> coalesce -> dispatch ->
    respond, plus the model watcher (polls the shared
    ``resolve_latest_model`` selection path; a ``stream-train`` fleet's
    model-publish lands as a newer committed artifact dir) and the drain
    lifecycle (finish queued, refuse new, exit clean).
  * ``make_http_server`` — stdlib ``ThreadingHTTPServer`` speaking JSON
    on localhost: POST ``/score``, GET ``/healthz``, GET ``/metrics``.

Determinism contract: LDA models score through the packed layout with
PER-DOCUMENT convergence (``topic_inference_segments(freeze=True)``; on
the card one launch of the per-document kernel, ``ops/segments.py``), so a
response is a pure function of the document — independent of what
traffic it coalesced with and byte-identical to
``score --per-doc-convergence`` over the same books on the same device.
Non-LDA models (NMF) score through the model's own
``topic_distribution``; their fixed iteration depth is batch-invariant by
construction but the byte-level pin is only asserted for LDA.

Threads: HTTP handler threads vectorize; the coalescer's worker thread
dispatches; the watcher thread builds and warms the next snapshot.  Each
names the snapshot's device explicitly.  There is nothing to compile: a
dispatch is one gather and one kernel launch, so warmup runs one
dispatch a token bucket (the kernel's load, the thread's CUDA context,
the allocator's first blocks).  The gather and the kernel's call go
through the dispatch layer under the JAX package's labels
(``serve.gather``, ``serve.topic_inference``), so its recompile sentinel
counts ``compile.retraces`` at each signature past a label's first, where
the JAX package traces, process-wide (a swapped-in model of the same k
meets the signatures already run).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..device import resolve_device
from ..models.base import gather_token_rows
from ..models.persistence import latest_model_dir, resolve_latest_model
from ..ops.lda_math import topic_inference_segments
from ..ops.segments import pack_offsets
from ..ops.sparse import next_pow2
from ..resilience import CorruptArtifactError, Quarantine, faultinject
from ..resilience.retry import sleep as _sleep
from ..telemetry import tracing
from ..telemetry.queueing import QueueingEstimator
from .coalescer import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    PendingDoc,
    RequestCoalescer,
    ServiceDraining,
    ServiceOverloaded,
)
from .front import (
    DEGRADED_HEADER,
    GENERATION_HEADER,
    PRIORITY_HEADER,
    REPLICA_HEADER,
    model_stamp,
)

__all__ = [
    "DEFAULT_TOKEN_BUCKETS",
    "ServeScorer",
    "ScoringService",
    "DegradeController",
    "make_http_server",
]

# default warmup grid: pow2 token buckets a book-sized request lands in
DEFAULT_TOKEN_BUCKETS = (256, 1024, 4096)

# a dispatch's two calls, under the JAX package's labels
_infer = telemetry.instrument_dispatch("serve.topic_inference",
                                       topic_inference_segments)
_gather = telemetry.instrument_dispatch("serve.gather", gather_token_rows)


def _read_meta(path: str) -> dict:
    try:
        with open(os.path.join(path, "meta.json"), encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _on_device(dev: torch.device):
    """The calling thread's current CUDA device set to ``dev`` (nothing
    for the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ServeScorer:
    """One verified model, frozen into a servable snapshot on ``device``."""

    def __init__(
        self,
        model,
        path: str,
        *,
        generation: int,
        stop_words: frozenset = frozenset(),
        lemmatize: bool = True,
        max_batch: int = 64,
        token_buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
        device="cuda",
        emulate_doc_seconds: Optional[float] = None,
    ) -> None:
        from ..models.base import LDAModel
        from ..pipeline import TextPreprocessor, make_vectorizer

        self.model = model
        self.path = path
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.token_buckets = tuple(sorted(int(t) for t in token_buckets))
        # publish-order stamp of the served artifact (the fleet front's
        # generation-pinning key; None for unstamped explicit dirs)
        self.stamp = model_stamp(path)
        # the fleet drill's emulated dispatch: a pinned per-document
        # sleep in place of the kernel, so a CPU host can run N replicas
        # and the drill measures the fleet path (routing, transport,
        # coalescing) around a device-shaped service time
        self.emulate_doc_seconds = emulate_doc_seconds
        self.pre = TextPreprocessor(
            stop_words=stop_words, lemmatize=lemmatize
        )
        self.rows_for = make_vectorizer(model.vocab)
        meta = _read_meta(path)
        ledger_ref = meta.get("ledger_ref")
        # every response carries this verbatim: which artifact answered,
        # and — for stream-published models — which committed epoch
        # published it (the ledger back-reference in meta.json)
        self.attribution = {
            "model": path,
            "epoch": (ledger_ref or {}).get("epoch"),
            "ledger_ref": ledger_ref,
            "step": meta.get("step"),
            "generation": int(generation),
        }
        publish_trace = self._publish_trace(ledger_ref)
        if publish_trace:
            # the training side of the causal chain: the model-publish
            # ledger record's span — responses (and trace_request
            # events) link the serving trace back to the trace that
            # ingested and trained the bytes being served
            self.attribution["publish_trace"] = publish_trace
        self._lda = (isinstance(model, LDAModel)
                     and emulate_doc_seconds is None)
        if self._lda:
            dev = self.device
            with _on_device(dev):
                # the same table, alpha and starting gamma as
                # ``topic_distribution(rows, convergence="per_doc")``
                self._eb_tok_table = model._exp_elog_beta(dev).T.contiguous()
                self._alpha = torch.as_tensor(
                    np.asarray(model.alpha, np.float32), device=dev)
                self._gamma0 = torch.ones(
                    (self.max_batch, model.k), dtype=torch.float32,
                    device=dev)

    @staticmethod
    def _publish_trace(ledger_ref) -> Optional[dict]:
        """Trace fields of the model-publish ledger record, when the
        checkpoint dir is still reachable.  Best-effort: a relocated or
        legacy (pre-trace) ledger reads as no training trace."""
        if not ledger_ref or ledger_ref.get("epoch") is None \
                or not ledger_ref.get("dir"):
            return None
        from ..resilience.ledger import EpochLedger

        try:
            rec = EpochLedger(str(ledger_ref["dir"])).record_for(
                int(ledger_ref["epoch"])
            )
        except (OSError, ValueError, CorruptArtifactError):
            return None
        trace = (rec or {}).get("trace")
        return dict(trace) if isinstance(trace, dict) else None

    @property
    def k(self) -> int:
        return int(self.model.k)

    def _bucket(self, total_tokens: int) -> int:
        want = next_pow2(max(8, total_tokens))
        for t in self.token_buckets:
            if t >= want:
                return t
        return want          # oversize: exact pow2, counted as a retrace

    def score_rows(
        self, rows: List[tuple], *, degraded: bool = False
    ) -> np.ndarray:
        """Distributions [n, k] for up to ``max_batch`` vectorized rows.

        LDA path: the ``_topic_distribution_packed`` packing recipe
        (docs contiguous, pads trailing with seg 0 / weight 0) at a
        PINNED doc axis (``max_batch``) and a bucketed token axis, run
        with per-document frozen convergence — so the bytes match the
        batch CLI's ``--per-doc-convergence`` output no matter how
        traffic coalesced.  On the card: the gather of the docs' rows of
        the [V, k] table and one launch of the per-document kernel.

        ``degraded=True`` is the overload tier (docs/SERVING.md
        "Overload & degradation"): documents are truncated to fit the
        SMALLEST warmed token bucket — cheaper answers on a shape warmup
        already ran.  The emulated path halves its pinned service time
        instead."""
        n = len(rows)
        if n > self.max_batch:
            raise ValueError(f"{n} rows > max_batch {self.max_batch}")
        if n == 0:
            return np.zeros((0, self.k), np.float32)
        if self.emulate_doc_seconds is not None:
            # a device-shaped service time and a fixed answer: block for
            # the pinned seconds a document, answer the uniform
            # distribution with topic 0 ahead (the JAX package's bytes)
            per_doc = self.emulate_doc_seconds
            if degraded:
                per_doc *= 0.5
            _sleep(per_doc * n)
            out = np.full((n, self.k), 1.0 / self.k, np.float32)
            out[:, 0] += 1e-3
            return out
        if not self._lda:
            return np.asarray(
                self.model.topic_distribution(rows, device=self.device),
                np.float32,
            )
        if degraded:
            budget = self.token_buckets[0]
            total = sum(len(i) for i, _ in rows)
            if total > budget:
                # head-truncate each document to its share of the
                # smallest bucket: total tokens <= budget, so _bucket
                # resolves to an already-warmed shape
                allow = max(1, budget // n)
                rows = [(ids[:allow], wts[:allow]) for ids, wts in rows]
        lens = [len(i) for i, _ in rows]
        t_pad = self._bucket(sum(lens))
        flat_i = np.zeros(t_pad, np.int64)
        flat_c = np.zeros(t_pad, np.float32)
        seg = np.zeros(t_pad, np.int64)
        o = 0
        for d, (ids, wts) in enumerate(rows):
            flat_i[o:o + len(ids)] = ids
            flat_c[o:o + len(ids)] = wts
            seg[o:o + len(ids)] = d
            o += len(ids)
        offsets = pack_offsets(lens + [0] * (self.max_batch - n))
        dev = self.device
        with _on_device(dev):
            out = _infer(
                _gather(self._eb_tok_table, torch.from_numpy(flat_i).to(dev)),
                torch.from_numpy(flat_c).to(dev),
                torch.from_numpy(seg).to(dev),
                self._alpha,
                self._gamma0,
                freeze=True,
                offsets=torch.from_numpy(offsets).to(dev),
            )
            return out[:n].cpu().numpy()

    def warmup(self) -> dict:
        """One dispatch per configured token bucket BEFORE traffic
        arrives: the kernel loads (built if missing), the warming thread
        makes its CUDA context and the allocator takes its blocks.  Past
        this point an in-bucket dispatch is at a shape this process has
        seen (``compile.retraces`` does not move).  The report keeps the
        JAX package's keys: ``signatures`` is the recompile sentinel's
        distinct signatures per label, and there is no executable cache
        (``compile_cache`` "off")."""
        from ..telemetry import compilation

        reg = telemetry.get_registry()
        t0 = time.perf_counter()
        v = max(1, self.model.vocab_size)
        if self.emulate_doc_seconds is None:
            for t in self.token_buckets:
                live = max(1, t // 2 + 1)  # lands exactly in bucket t
                ids = (np.arange(live, dtype=np.int64) % v).astype(np.int32)
                self.score_rows([(ids, np.ones(live, np.float32))])
        retraces = reg.counter("compile.retraces").value
        report = {
            "buckets": list(self.token_buckets),
            "warmup_seconds": round(time.perf_counter() - t0, 6),
            "signatures": compilation.signatures(),
            "retraces_at_warmup": int(retraces),
            "compile_cache": "off",
        }
        if self.emulate_doc_seconds is not None:
            report["emulated_doc_seconds"] = self.emulate_doc_seconds
        return report


class DegradeController:
    """Hysteresis gate for degraded-mode answers.

    ``update(pressure)`` is called once per dispatched batch with the
    current pressure signal (max of queue fullness and the live ρ
    estimate, both dimensionless around 1.0 = saturated).  The mode
    flips to degraded only after pressure has held at or above
    ``enter_pressure`` for ``enter_seconds`` of consecutive updates, and
    restores only after it has held at or below ``exit_pressure`` for
    ``exit_seconds`` — the gap between the thresholds plus the dwell
    times is the hysteresis that keeps a noisy boundary load from
    flapping quality.  ``clock`` is injectable so tests drive the dwell
    on a fake clock.

    Single-writer by construction: only the coalescer's batch worker
    calls ``update``; readers (health, response attribution) see a
    monotonic bool.
    """

    def __init__(
        self,
        *,
        enter_pressure: float = 0.9,
        exit_pressure: float = 0.6,
        enter_seconds: float = 1.0,
        exit_seconds: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if exit_pressure >= enter_pressure:
            raise ValueError(
                f"exit_pressure {exit_pressure} must be below "
                f"enter_pressure {enter_pressure} (the hysteresis band)"
            )
        self.enter_pressure = float(enter_pressure)
        self.exit_pressure = float(exit_pressure)
        self.enter_seconds = float(enter_seconds)
        self.exit_seconds = float(exit_seconds)
        self._clock = clock
        self._degraded = False
        self._since: Optional[float] = None   # condition onset, or None

    @property
    def degraded(self) -> bool:
        return self._degraded

    def update(self, pressure: float) -> bool:
        now = self._clock()
        if not self._degraded:
            if pressure >= self.enter_pressure:
                if self._since is None:
                    self._since = now
                elif now - self._since >= self.enter_seconds:
                    self._degraded = True
                    self._since = None
                    telemetry.count("degrade.entered")
                    telemetry.event(
                        "degrade_mode", state="degraded",
                        pressure=round(pressure, 4),
                    )
            else:
                self._since = None
        else:
            if pressure <= self.exit_pressure:
                if self._since is None:
                    self._since = now
                elif now - self._since >= self.exit_seconds:
                    self._degraded = False
                    self._since = None
                    telemetry.count("degrade.exited")
                    telemetry.event(
                        "degrade_mode", state="restored",
                        pressure=round(pressure, 4),
                    )
            else:
                self._since = None
        return self._degraded


class ScoringService:
    """Accept -> coalesce -> dispatch -> respond, with hot-swap + drain."""

    def __init__(
        self,
        models_dir: str,
        lang: str,
        *,
        model: Optional[str] = None,
        verify_deep: bool = True,
        stop_words: frozenset = frozenset(),
        lemmatize: bool = True,
        max_batch: int = 64,
        linger_s: float = 0.005,
        token_buckets: Sequence[int] = DEFAULT_TOKEN_BUCKETS,
        model_poll_interval: float = 2.0,
        quarantine_dir: Optional[str] = None,
        request_timeout: float = 60.0,
        watch_model: bool = True,
        max_queue: Optional[int] = None,
        batch_weight: float = 0.25,
        degrade: Optional[DegradeController] = None,
        device="cuda",
        replica_index: Optional[int] = None,
        emulate_doc_seconds: Optional[float] = None,
        alerts_file: Optional[str] = None,
    ) -> None:
        self.models_dir = models_dir
        self.lang = lang
        self.explicit_model = model
        self.verify_deep = verify_deep
        self.device = resolve_device(device)
        # a monitor's alerts.jsonl: firing alerts degrade /healthz
        self.alerts_file = alerts_file
        # fleet identity: responses carry X-STC-Replica, and the
        # Prometheus exposition labels every series with the index, so a
        # scraper sees N replicas as one labelled family
        self.replica_index = replica_index
        self._scorer_kw = dict(
            stop_words=stop_words,
            lemmatize=lemmatize,
            max_batch=max_batch,
            token_buckets=token_buckets,
            device=self.device,
            emulate_doc_seconds=emulate_doc_seconds,
        )
        self.model_poll_interval = float(model_poll_interval)
        self.request_timeout = float(request_timeout)
        self.quarantine = Quarantine(quarantine_dir)
        self.started_at = time.time()
        self.draining = False
        self._swap_lock = threading.Lock()
        self._stop_watcher = threading.Event()

        path, mdl = resolve_latest_model(
            models_dir, lang, explicit=model, verify_deep=verify_deep,
            device=self.device,
        )
        self._scorer = ServeScorer(
            mdl, path, generation=0, **self._scorer_kw
        )
        self.warmup_report = self._scorer.warmup()
        telemetry.event(
            "serve_warmup", model=path, **{
                k: v for k, v in self.warmup_report.items()
                if k != "signatures"
            },
        )
        # admission control (docs/SERVING.md "Overload & degradation"):
        # None picks the default backlog bound (8 full batches); 0 keeps
        # the intake unbounded for embedded/offline use
        if max_queue is None:
            max_queue = 8 * max_batch
        self.max_queue = max_queue if max_queue > 0 else None
        self._degrade = degrade if degrade is not None \
            else DegradeController()
        # in-process queueing triple (c=1: this replica) — arrivals
        # noted per accepted request, service attributed per dispatch;
        # the Erlang-C predicted wait prices every 429's Retry-After
        self._queue_est = QueueingEstimator(
            window_seconds=10.0, replica_count=1
        )
        self._est_lock = threading.Lock()
        self.coalescer = RequestCoalescer(
            self._dispatch, max_batch=max_batch, linger_s=linger_s,
            max_queue=self.max_queue, batch_weight=batch_weight,
        )
        self._watcher = None
        if model is None and watch_model:
            # an explicitly pinned --model never swaps; discovery mode
            # polls the selection path for a newer published artifact.
            # Fleet replicas run with watch_model=False: the supervisor
            # sequences swaps replica by replica through control files,
            # so the fleet never re-warms everywhere at once.
            self._watcher = threading.Thread(
                target=self._watch, name="stc-serve-watcher", daemon=True
            )
            self._watcher.start()

    # -- attribution / health -------------------------------------------
    @property
    def scorer(self) -> ServeScorer:
        return self._scorer

    def health(self) -> dict:
        reg = telemetry.get_registry()
        firing = []
        if self.alerts_file:
            # a torn or missing log reads as no alerts (firing_alerts is
            # cached by mtime): a health check never fails on its own
            # telemetry
            from ..telemetry.alerts import firing_alerts

            firing = firing_alerts(self.alerts_file)
        out = {
            "status": "draining" if self.draining else (
                "degraded" if firing else "ok"),
            "model": self._scorer.attribution,
            "uptime_s": round(time.time() - self.started_at, 3),
            "queue_depth": self.coalescer.queue_depth(),
            "max_queue": self.max_queue,
            "degraded_mode": self._degrade.degraded,
            "requests": reg.counter("serve.requests").value,
            "batches": reg.counter("serve.batches").value,
            "swaps": reg.counter("serve.swaps").value,
            "warmup": {
                k: v for k, v in self.warmup_report.items()
                if k != "signatures"
            },
        }
        if self.alerts_file:
            out["alerts"] = {"source": self.alerts_file, "firing": firing}
        return out

    # -- request path ----------------------------------------------------
    def retry_after_seconds(self) -> float:
        """Price of coming back: the live Erlang-C predicted wait (p99,
        falling back to mean), ceil'd into [1, 60] whole seconds — a
        refused client is told WHEN the backlog should have drained,
        not just to go away.  A saturated replica has no steady state;
        the estimator caps the prediction at its window, which lands
        here as the window in seconds."""
        with self._est_lock:
            est = self._queue_est.estimate(time.time()) or {}
        wait = est.get("predicted_wait_p99_seconds") \
            or est.get("predicted_wait_seconds") or 0.0
        if not math.isfinite(wait):
            wait = self._queue_est.window_seconds
        return float(min(max(1.0, math.ceil(wait)), 60.0))

    def submit_texts(
        self,
        texts: Sequence[str],
        names: Optional[Sequence[str]] = None,
        trace: Optional[tracing.TraceContext] = None,
        priority: str = DEFAULT_PRIORITY,
    ) -> List[dict]:
        """Score ``texts``; returns one result dict per document, in
        order.  Raises ``ServiceDraining`` after the preemption notice
        and ``ServiceOverloaded`` (with ``retry_after`` priced) when the
        bounded intake refuses the request or evicts every document in
        it.  Called from HTTP handler threads (and directly by tests);
        blocks until every document's batch completed.

        ``trace``: the request's causal context (the HTTP front parses
        ``X-STC-Trace`` into one; None mints a head-sampled root).  A
        sampled request emits the per-request span chain
        ``serve.request`` -> ``serve.vectorize`` / ``serve.batch_wait``
        -> ``serve.dispatch`` onto the run stream; an unsampled one
        only propagates the id — no span cost on the hot path.
        """
        faultinject.check("serve.accept")
        if self.draining:
            telemetry.count("serve.rejected", len(texts))
            raise ServiceDraining(
                "scoring service is draining (preemption notice "
                "received) — retry against another replica"
            )
        if priority not in PRIORITIES:
            priority = DEFAULT_PRIORITY
        # every arrival feeds λ — refused requests still arrived, and
        # their pressure is exactly what prices the next Retry-After
        with self._est_lock:
            self._queue_est.note_arrivals(len(texts), time.time())
        try:
            # whole-request admission: reserve every slot up front so a
            # multi-doc request is admitted or refused as ONE unit
            self.coalescer.reserve(len(texts), priority)
        except ServiceOverloaded as exc:
            telemetry.count("serve.rejected", len(texts))
            exc.retry_after = self.retry_after_seconds()
            raise
        ctx = trace if trace is not None else tracing.mint()
        if ctx.sampled:
            telemetry.count("trace.sampled")
        else:
            telemetry.count("trace.dropped")
        traced = ctx.sampled and telemetry.enabled()
        names = list(names or [f"doc{i}" for i in range(len(texts))])
        t0 = time.perf_counter()
        t0_wall = time.time()
        scorer = self._scorer       # vectorize against ONE vocabulary
        pending: List[Optional[PendingDoc]] = []
        results: List[Optional[dict]] = [None] * len(texts)
        for i, (name, text) in enumerate(zip(names, texts)):
            try:
                (row,) = scorer.rows_for(
                    scorer.pre.transform({"texts": [text]})["tokens"]
                )
            except Exception as exc:
                # one malformed document gets an error response; its
                # batchmates (and the daemon) are untouched — and its
                # reserved intake slot goes back
                self.coalescer.release(1)
                telemetry.count("serve.quarantined")
                telemetry.event(
                    "serve_quarantined", docs=1, stage="vectorize",
                    error=repr(exc),
                )
                self.quarantine.put(name, text, exc, stage="vectorize")
                results[i] = {"name": name, "error": repr(exc)}
                pending.append(None)
                continue
            telemetry.count("serve.requests")
            pending.append(
                self.coalescer.submit(
                    PendingDoc(name=name, row=row, priority=priority)
                )
            )
        vec_end = time.perf_counter()
        evicted = 0
        live = 0
        for i, doc in enumerate(pending):
            if doc is None:
                continue
            live += 1
            if not doc.done.wait(self.request_timeout):
                results[i] = {
                    "name": doc.name,
                    "error": f"timeout after {self.request_timeout}s",
                }
                continue
            if doc.error is not None:
                results[i] = {"name": doc.name, "error": doc.error}
                if doc.error_kind == "ServiceOverloaded":
                    # evicted mid-queue by interactive load
                    results[i]["rejected"] = True
                    evicted += 1
            else:
                dist = doc.distribution
                results[i] = {
                    "name": doc.name,
                    "topic": int(np.argmax(dist)),
                    "distribution": [float(x) for x in dist],
                    "model": doc.served_by,
                }
                if doc.degraded:
                    results[i]["degraded"] = True
            dt = time.perf_counter() - t0
            telemetry.observe("serve.request_seconds", dt)
            telemetry.observe(
                f"serve.class.{priority}.request_seconds", dt
            )
        if live and evicted == live:
            # the whole request was shed from the queue: surface it as
            # one typed refusal (HTTP 429), not a 200 full of errors
            telemetry.count("serve.rejected", evicted)
            raise ServiceOverloaded(
                f"all {evicted} document(s) evicted under interactive "
                f"pressure (batch sheds first)",
                priority=priority, evicted=True,
                retry_after=self.retry_after_seconds(),
            )
        if traced:
            self._emit_request_spans(
                ctx, scorer, pending,
                t0=t0, t0_wall=t0_wall, vec_end=vec_end,
                end=time.perf_counter(), docs=len(texts),
            )
        return [r for r in results if r is not None]

    def _emit_request_spans(
        self, ctx, scorer, pending, *, t0, t0_wall, vec_end, end, docs,
    ) -> None:
        """One request's causal spans + the ``trace_request`` anchor
        event, all on the run stream.  Span starts are wall-clock
        (``t0_wall`` plus the perf-counter delta) so a causal exporter
        can place them on the corrected cross-process timeline.  The
        request's own span id is the context's — the root a lineage
        walker checks for unattributed children."""

        def wall(p: float) -> float:
            return t0_wall + (p - t0)

        attr = scorer.attribution
        publish = attr.get("publish_trace") or {}
        telemetry.event(
            "trace_request",
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            sampled=True,
            docs=docs,
            model=attr["model"],
            epoch=attr.get("epoch"),
            **(
                {
                    "publish_trace_id": publish.get("trace_id"),
                    "publish_span_id": publish.get("span_id"),
                }
                if publish.get("span_id") else {}
            ),
        )
        tracing.emit_span(
            "serve.request",
            trace_id=ctx.trace_id,
            span_id=ctx.span_id,
            parent_span_id=ctx.parent_span_id,
            start=t0_wall,
            seconds=end - t0,
            docs=docs,
        )
        tracing.emit_span(
            "serve.vectorize",
            trace_id=ctx.trace_id,
            span_id=tracing.new_span_id(),
            parent_span_id=ctx.span_id,
            start=t0_wall,
            seconds=vec_end - t0,
        )
        live = [
            d for d in pending
            if d is not None and d.popped_at is not None
        ]
        if not live:
            return
        enq = min(d.enqueued_at for d in live)
        popped = max(d.popped_at for d in live)
        wait_id = tracing.new_span_id()
        tracing.emit_span(
            "serve.batch_wait",
            trace_id=ctx.trace_id,
            span_id=wait_id,
            parent_span_id=ctx.span_id,
            start=wall(enq),
            seconds=max(0.0, popped - enq),
        )
        dispatch_s = max(
            (d.dispatch_seconds for d in live
             if d.dispatch_seconds is not None),
            default=None,
        )
        if dispatch_s is not None:
            tracing.emit_span(
                "serve.dispatch",
                trace_id=ctx.trace_id,
                span_id=tracing.new_span_id(),
                parent_span_id=wait_id,
                start=wall(popped),
                seconds=dispatch_s,
                model=attr["model"],
            )

    def _dispatch(self, batch: List[PendingDoc]) -> None:
        # ONE snapshot per batch: the whole dispatch — and therefore
        # every response in it — is attributable to exactly this model,
        # however the watcher swings ``self._scorer`` mid-flight
        scorer = self._scorer
        # pressure = max(queue fullness, live ρ); ρ counts REFUSED
        # arrivals too, so a replica busy saying no stays degraded —
        # exactly the regime where cheaper answers buy back capacity
        pressure = 0.0
        if self.max_queue:
            pressure = self.coalescer.queue_depth() / self.max_queue
        with self._est_lock:
            est = self._queue_est.estimate(time.time()) or {}
        rho = est.get("rho")
        if rho is not None and math.isfinite(rho):
            pressure = max(pressure, float(rho))
        degraded = self._degrade.update(pressure)
        t0 = time.perf_counter()
        dist = scorer.score_rows(
            [d.row for d in batch], degraded=degraded
        )
        dt = time.perf_counter() - t0
        with self._est_lock:
            self._queue_est.observe_event(time.time(), {
                "event": "serve_batch",
                "docs": len(batch),
                "seconds": dt,
            })
        if degraded:
            telemetry.count("degrade.responses", len(batch))
        for d, row in zip(batch, dist):
            d.distribution = np.asarray(row)
            d.served_by = scorer.attribution
            d.degraded = degraded
            d.done.set()

    # -- hot swap --------------------------------------------------------
    def poll_model_once(self) -> bool:
        """One watcher step: if the selection path now resolves to a
        NEWER artifact, verify + load + warm it off the serving path and
        install it atomically.  Returns True when a swap landed.  Any
        failure — corrupt candidate, warmup error, an armed
        ``serve.swap`` fault — leaves the previous verified model
        serving (``serve.swap_failures``)."""
        # cheap pre-check: don't re-load (or deep-verify) a [k, V] model
        # every poll tick when the selection still resolves to the
        # artifact already serving
        probe = self.explicit_model or latest_model_dir(
            self.models_dir, self.lang
        )
        if probe is None or probe == self._scorer.path:
            return False
        try:
            path, mdl = resolve_latest_model(
                self.models_dir, self.lang,
                explicit=self.explicit_model,
                verify_deep=self.verify_deep,
                device=self.device,
            )
        except CorruptArtifactError:
            return False      # nothing newer and loadable; keep serving
        if path == self._scorer.path:
            return False
        old = self._scorer.attribution
        try:
            nxt = ServeScorer(
                mdl, path,
                generation=old["generation"] + 1,
                **self._scorer_kw,
            )
            nxt.warmup()      # load and launch BEFORE traffic sees it
            with self._swap_lock:
                faultinject.check("serve.swap")
                self._scorer = nxt
        except Exception as exc:
            telemetry.count("serve.swap_failures")
            telemetry.event(
                "serve_swap_failed", candidate=path, error=repr(exc),
                serving=old["model"],
            )
            return False
        telemetry.count("serve.swaps")
        telemetry.event(
            "serve_swap",
            from_model=old["model"], to_model=path,
            epoch=nxt.attribution["epoch"],
            generation=nxt.attribution["generation"],
        )
        return True

    def _watch(self) -> None:
        while not self._stop_watcher.is_set():
            _sleep(self.model_poll_interval)
            if self._stop_watcher.is_set():
                return
            self.poll_model_once()

    # -- drain -----------------------------------------------------------
    def begin_drain(self, timeout: float = 60.0) -> dict:
        """The preemption notice: refuse new documents, finish queued
        ones, stop the watcher.  Returns the drain report the CLI emits
        as the ``serve_drained`` event."""
        self.draining = True
        self._stop_watcher.set()
        self.coalescer.drain(timeout)
        reg = telemetry.get_registry()
        retraces = reg.counter("compile.retraces").value
        return {
            "requests": reg.counter("serve.requests").value,
            "batches": reg.counter("serve.batches").value,
            "swaps": reg.counter("serve.swaps").value,
            "quarantined": reg.counter("serve.quarantined").value,
            "rejected": reg.counter("serve.rejected").value,
            "evicted": reg.counter("admission.evicted").value,
            "degraded_responses": reg.counter(
                "degrade.responses"
            ).value,
            "retraces_total": int(retraces),
            "retraces_after_warmup": int(
                retraces - self.warmup_report["retraces_at_warmup"]
            ),
        }


# ---------------------------------------------------------------------------
# HTTP front (stdlib only)
# ---------------------------------------------------------------------------
class _ServeHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    # the default handler logs every request to stderr; the service's
    # telemetry stream is the intended log
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _send(
        self, code: int, doc: dict, trace=None, headers=None, stamp=None,
    ) -> None:
        service: ScoringService = self.server.service
        body = json.dumps(doc).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            # typed-refusal extras: Retry-After on a 429, X-STC-Degraded
            # on a quality-shed answer
            self.send_header(k, v)
        if trace is not None:
            # the served byte's end of the causal chain: clients resume
            # the walk from this header
            self.send_header(tracing.HEADER, trace.format())
        # which publish generation answered (the fleet front's
        # generation-pinning key): the newest model that scored the
        # request's documents, else the one serving now
        if stamp is None:
            stamp = service.scorer.stamp
        if stamp is not None:
            self.send_header(GENERATION_HEADER, str(stamp))
        # and which replica (the front forwards it as it is)
        if service.replica_index is not None:
            self.send_header(REPLICA_HEADER, str(service.replica_index))
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code: int, text: str, ctype: str) -> None:
        body = text.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        from ..telemetry import prometheus

        service: ScoringService = self.server.service
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._send(200, service.health())
        elif path == "/metrics":
            # content negotiation: standard scrapers (Prometheus sends
            # text/plain;version=... / openmetrics Accept values) get
            # the text exposition format; JSON consumers (no Accept
            # preference, or application/json) get the registry dump
            accept = self.headers.get("Accept", "")
            params = urllib.parse.parse_qs(query)
            want_buckets = params.get("buckets", ["0"])[-1] in (
                "1", "true", "yes"
            )
            snap = telemetry.get_registry().snapshot(
                include_buckets=want_buckets
            )
            if "prometheus" in params.get("format", []) or (
                not params.get("format")
                and prometheus.wants_prometheus(accept)
            ):
                labels = (
                    {"replica": str(service.replica_index)}
                    if service.replica_index is not None else None
                )
                self._send_text(
                    200,
                    prometheus.render(snap, labels=labels,
                                      buckets=want_buckets),
                    prometheus.CONTENT_TYPE,
                )
            else:
                self._send(200, snap)
        else:
            self._send(404, {"error": f"no route {self.path}"})

    def do_POST(self):  # noqa: N802
        service: ScoringService = self.server.service
        if self.path != "/score":
            self._send(404, {"error": f"no route {self.path}"})
            return
        # inbound causal context: a W3C-traceparent-style X-STC-Trace
        # header continues the caller's trace (the server works under a
        # CHILD span of it); no header mints a head-sampled root
        inbound = tracing.parse(self.headers.get(tracing.HEADER))
        ctx = inbound.child() if inbound is not None else tracing.mint()
        # priority class: unknown values fold to the default so the
        # header never grows unbounded per-class state
        priority = (
            self.headers.get(PRIORITY_HEADER) or DEFAULT_PRIORITY
        ).strip().lower()
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
            texts = payload.get("texts")
            if texts is None and "text" in payload:
                texts = [payload["text"]]
            if not isinstance(texts, list) or not texts:
                raise ValueError(
                    "body must carry 'text' or a non-empty 'texts' list"
                )
            names = payload.get("names")
        except (ValueError, json.JSONDecodeError) as exc:
            self._send(400, {"error": f"bad request: {exc}"}, trace=ctx)
            return
        try:
            results = service.submit_texts(
                texts, names, trace=ctx, priority=priority
            )
        except ServiceDraining as exc:
            self._send(
                503, {"error": str(exc), "status": "draining"},
                trace=ctx,
            )
            return
        except ServiceOverloaded as exc:
            # the typed refusal: 429 + a Retry-After priced from the
            # live Erlang-C predicted wait — refusal with a schedule
            ra = exc.retry_after
            if ra is None:
                ra = service.retry_after_seconds()
            self._send(
                429,
                {
                    "error": str(exc),
                    "status": "overloaded",
                    "priority": exc.priority,
                    "retry_after": ra,
                },
                trace=ctx,
                headers={"Retry-After": str(int(math.ceil(ra)))},
            )
            return
        stamps = [model_stamp(r["model"]["model"]) for r in results
                  if "model" in r]
        stamps = [st for st in stamps if st is not None]
        extra = None
        if any(r.get("degraded") for r in results):
            # quality-shed attribution: clients can tell a cheap answer
            # from a full one
            extra = {DEGRADED_HEADER: "1"}
        self._send(
            200,
            {
                "results": results,
                "model": service.scorer.attribution,
                "trace": ctx.to_fields(),
            },
            trace=ctx,
            headers=extra,
            stamp=max(stamps) if stamps else None,
        )


def make_http_server(
    service: ScoringService, host: str = "127.0.0.1", port: int = 8765
) -> ThreadingHTTPServer:
    """Bind the JSON front; ``port=0`` picks a free port.  The caller
    owns ``serve_forever`` (usually on a thread) and ``shutdown`` plus
    ``server_close`` after the drain."""
    # deep listen backlog: a burst must reach the admission gate and be
    # refused with a priced 429, not die as a connection reset in the
    # kernel's SYN queue
    _ServeServer = type(
        "_ServeServer", (ThreadingHTTPServer,),
        {"request_queue_size": 128},
    )
    httpd = _ServeServer((host, port), _ServeHandler)
    httpd.service = service
    httpd.daemon_threads = True
    return httpd
