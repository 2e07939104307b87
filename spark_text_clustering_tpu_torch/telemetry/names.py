"""Canonical metric-name declarations (the STC004 registry).

Every metric a hot path writes through the ``telemetry.count`` /
``telemetry.gauge`` / ``telemetry.observe`` facade must be declared here
exactly once — ``stc lint`` rule STC004 enforces both directions:

  * a call site whose (literal) name is not declared here fails lint —
    an undeclared name is usually a typo that would fork a metric family
    and silently split its counts;
  * a declaration no longer referenced anywhere fails lint — stale
    entries document observability the code no longer has.

Names are dotted ``snake.case``: lowercase ``[a-z0-9_]`` segments joined
by dots, most-general family first (``resilience.retries``,
``stream.queue_depth``).  Dashboards and the ``metrics`` CLI key on
these strings, so renames are breaking changes to every committed
baseline (``scripts/records/ci_metrics_baseline.json``) — declare new
names instead of repurposing old ones.

``PREFIXES`` declares the few DYNAMIC families the telemetry facade and
the collectives layer mint per call site (``span.<path>.seconds``,
``collective.<op>.calls``).  A non-literal metric name at a call site is
only lint-clean when its leading literal text matches one of these
prefixes; everything else must be a declared literal.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

__all__ = ["METRICS", "PREFIXES", "NAME_RE", "is_valid_name"]

# dotted snake.case: [a-z0-9_]+ segments joined by '.'
NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)*$")

# name -> one-line description (kept here, not in dashboards, so the
# meaning travels with the declaration)
METRICS: Dict[str, str] = {
    # -- resilience (docs/RESILIENCE.md) --------------------------------
    "resilience.retries": "transient failures absorbed by retry_call",
    "resilience.giveups": "retry policies exhausted (RetryGiveUp raised)",
    "resilience.deadline_giveups":
        "retry loops stopped by a wall-clock deadline budget (the "
        "lease-bounded subset of resilience.giveups)",
    "resilience.quarantined": "documents routed to a dead-letter dir",
    "resilience.artifacts_skipped":
        "uncommitted/corrupt model dirs skipped by latest_model_dir",
    "resilience.checkpoints_rejected":
        "checkpoints rejected by the multi-host existence agreement",
    # -- epoch commit ledger (docs/RESILIENCE.md "Epoch commit ledger") -
    "ledger.commits": "epoch records appended to the commit ledger",
    "ledger.rollbacks":
        "uncommitted epochs rolled back at recovery (orphan payloads "
        "quarantined) plus torn ledger appends truncated",
    "ledger.replays_suppressed":
        "committed source files suppressed from re-emission at resume "
        "(the exactly-once half the at-least-once window used to replay)",
    "ledger.compactions":
        "committed epoch histories folded into a snapshot record "
        "(stc stream compact)",
    "ledger.fence_refusals":
        "ledger writes refused under a superseded fleet fence token "
        "(FencedEpochError raised at a zombie worker)",
    # -- fleet supervision (docs/RESILIENCE.md "Fleet supervision") -----
    "fleet.workers": "live supervised workers after the last sweep",
    "fleet.spawns": "worker subprocesses spawned (initial + respawns)",
    "fleet.respawns": "workers respawned after a death or preemption",
    "fleet.resizes": "ledger-gated topology changes (scale out/in/plan)",
    "fleet.preemptions":
        "drain SIGTERMs observed: escalations, resize drains, and "
        "externally-preempted workers that drained cleanly",
    "fleet.lease_expiries":
        "heartbeat leases that went stale past the timeout (stuck or "
        "dead worker detected)",
    "fleet.crashes": "workers that died without a terminal done-lease",
    "fleet.heartbeats": "lease renewals written by workers",
    "fleet.actions_applied":
        "monitor actions-file requests applied by the supervisor "
        "(alert-driven resize/drain — the telemetry -> topology loop)",
    # -- serve fleet (docs/SERVING.md "Serve fleet") ---------------------
    "fleet.swap_rolls":
        "rolling model swaps started by the serve supervisor (one "
        "committed publish rolled replica-by-replica)",
    "fleet.swap_stalls":
        "replica swaps that timed out mid-roll (the replica keeps "
        "serving its verified old model; the roll moves on)",
    "front.requests":
        "documents routed to a replica by the serve-fleet front "
        "(successful forwards; retries and refusals count separately)",
    "front.retries":
        "forwards retried on another replica after a connection-level "
        "failure or a draining (503) answer — scoring is idempotent "
        "per document, so a killed replica costs a retry, not a "
        "failed client request",
    "front.no_replica":
        "front requests refused because no ready replica existed "
        "within the wait budget (the fleet was empty or all-draining)",
    "front.repins":
        "client streams re-pinned to a newer model generation after "
        "their pinned generation left the fleet (rolling swap "
        "completed under them)",
    "front.request_seconds":
        "per-request front latency on EVERY exit path: accept -> "
        "replica response relayed, retry budget exhausted, or refused "
        "with no ready replica (includes routing, transport, and any "
        "retries — the latency-SLO denominator)",
    "front.shed_total":
        "requests shed at the front edge (pending set full or an "
        "armed front.shed fault): typed 429 quoting the last "
        "replica-priced Retry-After, never queued onto the fleet",
    "front.rejected_total":
        "replica 429s propagated to the client with Retry-After "
        "intact — a typed refusal is an ANSWER, so no retry is spent "
        "storming the rest of the saturated fleet",
    "front.retry_budget_exhausted":
        "requests failed after spending their whole per-request retry "
        "budget on connection-level failures (its own typed outcome: "
        "distinguishes a flapping fleet from an empty one)",
    # -- SLO engine & queueing observatory (docs/OBSERVABILITY.md
    #    "SLOs & error budgets") -----------------------------------------
    "probe.requests":
        "sentinel canary requests sent through the front by stc probe "
        "(the outside-in availability/latency sample)",
    "probe.failures":
        "canary requests that failed: non-200 status, connection "
        "error, or timeout (each one spends probe-SLO budget)",
    "probe.pin_violations":
        "canary requests whose X-STC-Generation went BACKWARD on the "
        "probe's pinned stream (a generation-pinning breach observed "
        "from outside)",
    "probe.request_seconds":
        "per-canary-request latency: connect -> response read "
        "(outside-in, fresh connection each probe)",
    "probe.rejected":
        "probe requests answered with a typed 429 (shed or admission "
        "refusal) — counted apart from probe.failures because a typed "
        "refusal under overload is the system WORKING",
    "queueing.updates":
        "queueing estimates computed (each one re-publishes the "
        "lambda/service/rho/wait gauges from the current window)",
    "queueing.lambda":
        "request arrival rate at the front, events/second over the "
        "estimator window (ROADMAP item 3's lambda)",
    "queueing.replicas":
        "replica count c the M/M/c prediction used (distinct serve "
        "streams in the window, or the configured override)",
    "queueing.service_seconds":
        "per-document service time S from serve_batch dispatch "
        "records (batch seconds over batch docs — the "
        "request-minus-queue attribution)",
    "queueing.rho":
        "fleet utilization lambda*S/c — the overload-control signal "
        "(rho -> 1 means waits diverge before p99 ever fires)",
    "queueing.predicted_wait_seconds":
        "Erlang-C predicted mean M/M/c queueing wait at the current "
        "(lambda, S, c); capped at the estimator window when "
        "saturated",
    "queueing.predicted_wait_p99_seconds":
        "Erlang-C predicted p99 queueing wait (exponential tail of "
        "the M/M/c waiting-time distribution)",
    "queueing.measured_wait_seconds":
        "measured mean coalescer wait from serve_batch wait fields "
        "(doc-weighted enqueue -> dispatch)",
    "queueing.wait_divergence":
        "measured over predicted mean wait (floored) — sustained "
        "divergence means the M/M/c model no longer describes the "
        "fleet (queue_wait_divergence alert)",
    # -- quarantine requeue (stc stream requeue) ------------------------
    "requeue.replayed":
        "quarantined documents replayed back into a watch directory",
    "requeue.archived":
        "error sidecars archived to quarantine .archive/ during requeue",
    # -- telemetry self-observation -------------------------------------
    "telemetry_write_errors": "run-stream appends that failed after retry",
    # -- telemetry transport plane (telemetry.transport;
    #    docs/OBSERVABILITY.md "Telemetry transport") --------------------
    "telemetry.shipped":
        "run-stream records acknowledged by the collector (fresh "
        "sends; replays count separately)",
    "telemetry.spooled":
        "records written to the durable local spool because the "
        "collector was unreachable (replayed on reconnect)",
    "telemetry.dropped":
        "records lost by the shipper and COUNTED: bounded-buffer "
        "overflow, unserializable records, or a spool that also "
        "failed — never silent",
    "telemetry.ship_errors":
        "batch pushes that exhausted their retry policy (each one "
        "diverts its batch to the spool)",
    "telemetry.ship_replayed":
        "spooled records delivered to the collector on reconnect "
        "(the replay half of the exactly-once contract)",
    "collect.batches":
        "wire batches folded into per-source streams by the "
        "collector (each one committed by its collect_batch marker)",
    "collect.ingested":
        "events folded exactly once into collector-side streams",
    "collect.duplicates":
        "batches suppressed by (source_id, seq) dedup — the "
        "at-least-once re-sends the exactly-once fold absorbed",
    "collect.duplicate_events":
        "events inside dedup-suppressed batches (the volume the "
        "suppression saved)",
    "collect.ingest_errors":
        "POST /ingest requests rejected (malformed body or an "
        "injected collect.ingest fault) — the shipper retries/spools",
    "collect.recovered_streams":
        "per-source streams whose un-markered tail was truncated at "
        "collector restart (the crash window between append and ack)",
    "collect.truncated_events":
        "uncommitted event lines removed by recovery truncation "
        "(re-shipped by their source, so folded exactly once)",
    "collect.sources":
        "distinct source_ids the collector has folded streams for",
    # -- streaming ------------------------------------------------------
    "stream.queue_depth": "new-but-unconsumed files seen by the last poll",
    "stream.trigger_cap":
        "current AIMD max_files_per_trigger cap (backpressure controller)",
    "stream.score.micro_batch_seconds": "stream-score trigger wall time",
    "stream.train.micro_batch_seconds": "stream-train trigger wall time",
    # -- scoring service (docs/SERVING.md) ------------------------------
    "serve.requests": "documents accepted by the scoring service",
    "serve.rejected":
        "documents refused by a draining service (SIGTERM received: "
        "queued work finishes, new work is turned away)",
    "serve.batches": "coalesced dispatches served (continuous batching)",
    "serve.swaps": "atomic model hot-swaps installed (new ledger epoch)",
    "serve.swap_failures":
        "hot-swap attempts aborted (verify/load/install failure) — the "
        "service keeps serving the previous verified model",
    "serve.quarantined":
        "serve documents that failed vectorize/score and got an error "
        "response instead of killing their batch",
    "serve.queue_depth": "documents waiting in the coalescer queue",
    "serve.request_seconds":
        "per-document service latency: accept -> response ready",
    "serve.queue_seconds":
        "per-document coalescer wait: enqueue -> batch dispatch",
    "serve.batch_fill":
        "live-document fill ratio of each dispatched serve batch",
    # -- training loops -------------------------------------------------
    "train_iteration_seconds": "per-iteration wall time (IterationTimer)",
    # -- device-resident model handoff (PERF.md item 2) -----------------
    "handoff.deferred_bytes":
        "model bytes left device-resident at the fit -> model handoff "
        "(the [k, V] download a single-process fit defers)",
    "handoff.downloads":
        "deferred device-resident models materialized to host on their "
        "first host-side consumer (ensure_host)",
    # -- persistent executable cache (docs/OBSERVABILITY.md
    #    "Executable cache"; spark_text_clustering_tpu/compilecache) ----
    "compile.cache_hits":
        "instrumented first calls served by deserializing a committed "
        "executable-cache entry instead of trace+compile",
    "compile.cache_misses":
        "executable-cache consultations that fell through to live "
        "compile (absent entry, stale fingerprint, unsupported backend, "
        "I/O failure, or a just-invalidated entry)",
    "compile.cache_stores":
        "freshly compiled executables serialized and committed to the "
        "cache (publish-race losers do not count)",
    "compile.cache_invalidations":
        "corrupt/torn/mismatched cache entries quarantined on contact "
        "(each one also counts a miss — degradation, never a crash)",
    "compile.time_to_first_dispatch_seconds":
        "wall seconds from telemetry import to the end of this "
        "process's first instrumented dispatch (the cold-start metric "
        "the executable cache exists to shrink)",
    # -- causal tracing (telemetry.tracing; docs/OBSERVABILITY.md
    #    "Causal tracing & lineage") ------------------------------------
    "trace.sampled":
        "serve requests admitted by head sampling (their trace context "
        "emits spans and rides the response header)",
    "trace.dropped":
        "serve requests minted UNSAMPLED by head sampling (the context "
        "still propagates; no spans are emitted)",
    "trace.spans":
        "completed causal spans emitted to run streams (trace_span "
        "events the --causal exporter joins into flow chains)",
    # -- model lineage (stc lineage; spark_text_clustering_tpu/lineage) -
    "lineage.walks": "lineage walks completed by the stc lineage verb",
    "lineage.degraded":
        "lineage reads that degraded typed (torn/corrupt ledger tail, "
        "unreadable meta, legacy pre-trace records) instead of crashing",
    # -- measured-scale observatory (telemetry.scale_probe /
    #    `stc metrics scale-check`; docs/OBSERVABILITY.md
    #    "Measured-scale observatory") ----------------------------------
    "scale.probe_runs":
        "measured-scale probe runs completed (the sharded entry "
        "families executed on a forced model-sharded dryrun mesh)",
    "scale.divergences":
        "measured-vs-static reconciliation breaches found by the last "
        "`stc metrics scale-check` (peak/collective bytes over "
        "tolerance, V=10M extrapolation over the HBM budget, retraces "
        "after the first step, committed-measured-record drift)",
    "scale.sharding_mismatches":
        "probed entries whose executable consumed/produced NO "
        "model-axis-sharded wide operand despite declared sharded_dims "
        "(the runtime twin of a static STC213 finding)",
    # -- static analysis (docs/STATIC_ANALYSIS.md) ----------------------
    "lint.findings": "unwaived stc lint findings in the last run",
    "lint.waived": "stc lint findings suppressed by pragma or baseline",
    "lint.scale_entries":
        "entry points traced at their declared V=10M/k=500 scale "
        "shapes by the last `stc lint --scale` run (the layer-3 audit)",
    "lint.scale_findings":
        "unwaived STC210-215 scale-audit findings in the last run",
    "lint.scale_waived":
        "scale-audit findings suppressed by pragma or baseline (the "
        "reasoned single-chip-tier HBM exceptions)",
    "lint.protocol_sites":
        "registered protocol-surface sites (writers, readers, path "
        "attrs, schema pairs, snapshots) checked by the last "
        "`stc lint --protocol` run (the layer-4 audit)",
    "lint.protocol_findings":
        "unwaived STC300-305 protocol-audit findings in the last run",
    "lint.protocol_waived":
        "protocol-audit findings suppressed by pragma or baseline",
}

# prefix -> owner/description of the dynamic family
PREFIXES: Dict[str, str] = {
    "span.": "telemetry facade: per-span latency/error families",
    "front.replica.":
        "serving.front: per-replica routed-request counters and "
        "latency histograms (front.replica.<i>.requests/.retries/"
        ".request_seconds — the index surfaces as the Prometheus "
        "'replica' label on the exposition path)",
    "serve.replica.":
        "serve fleet replica self-identity gauges written by the "
        "replica lease loop (serve.replica.index/.stamp/.draining)",
    "device_sync.": "telemetry facade: attributed block_until_ready waits",
    "train.": "telemetry facade: per-optimizer iteration histograms",
    "collective.": "parallel.collectives: per-op trace-time calls/bytes",
    "probe.accelerator.": "utils.env: probe attempts by outcome class",
    "dispatch.":
        "telemetry.dispatch: per-compiled-executable calls / runtime "
        "collective bytes / cost_analysis device-time estimates / "
        "measured wall+sync seconds (the roofline join)",
    "compile.":
        "telemetry.compilation: recompile sentinel — distinct compiled "
        "signatures per dispatch label, first-call compile seconds, "
        "retrace counter (gated vs scripts/records/compile_baseline.json) "
        "— plus the executable cache's per-entry "
        "compile.<digest>.cache_load_seconds gauges (compilecache)",
    "mem.":
        "telemetry.memory: per-digest memory_analysis attribution "
        "(arg/out/temp/peak bytes) + live device memory_stats and "
        "host-RSS gauges sampled at epoch/trigger boundaries, incl. "
        "the per-device max/min/imbalance breakdown "
        "(mem.device.*_max/_min, mem.device.imbalance) that exposes "
        "per-device imbalance the summed gauges hide under sharding",
    # CLI-derived families (written by `metrics merge`, never by a hot
    # path): cross-process aggregates and skew-report findings
    "merge.": "metrics merge: per-metric min/median/max across processes",
    "skew.": "metrics merge: cross-host skew findings (straggler/retries/"
             "queue-depth divergence)",
    # live alerting engine (`stc monitor`, telemetry.alerts /
    # docs/OBSERVABILITY.md "Live monitoring & alerting")
    "alert.":
        "telemetry.alerts: alert state-machine transitions "
        "(alert.pending/firing/resolved counters, alert.active gauge)",
    "drift.":
        "telemetry.alerts: topic-drift probe over committed-epoch "
        "lambdas (drift.kl / drift.hellinger gauges, drift.probes)",
    "monitor.":
        "telemetry.alerts: monitor engine self-observation (polls, "
        "events consumed, actions emitted, poll errors, live streams)",
    "front.request_outcomes.":
        "serving.front: typed per-outcome request counters on every "
        "exit path of FrontRouter.route (front.request_outcomes.ok/"
        ".error_status/.retry_exhausted/.no_replica — the "
        "availability-SLO numerator and denominator)",
    "slo.":
        "telemetry.slo: per-objective error-budget gauges "
        "(slo.<objective>.budget_remaining/.good_fraction/"
        ".burn_<window>/.burning) plus the engine's slo.evaluations "
        "counter and slo.objectives_burning roll-up",
    "queueing.replica.":
        "telemetry.queueing: measured per-replica busy fraction "
        "(queueing.replica.<i>.rho — spread across replicas exposes "
        "routing skew the fleet-wide rho hides)",
    "admission.":
        "serving.coalescer bounded intake: per-priority accepted/"
        "rejected counters plus admission.evicted (batch docs shed to "
        "make room for interactive arrivals) — the typed-429 ledger",
    "degrade.":
        "serving.server degraded mode: degrade.entered/.exited "
        "hysteresis transitions and degrade.responses (documents "
        "answered on the cheaper tier, attributed via X-STC-Degraded)",
    "serve.class.":
        "serving.server per-priority-class latency histograms "
        "(serve.class.<interactive|batch>.request_seconds — the "
        "per-class SLO evidence that batch sheds first)",
    "autoscale.":
        "telemetry.queueing PredictiveAutoscaler: autoscale.scale_out/"
        ".scale_in decisions emitted from the lambda*S vs c*capacity "
        "signal (ahead of the p99 burn-rate page), plus the "
        "autoscale.target gauge",
}


def is_valid_name(name: str) -> bool:
    return bool(NAME_RE.match(name))


def declared(name: str) -> bool:
    """Is ``name`` covered by a literal declaration or a dynamic-family
    prefix?  (The runtime mirror of the STC004 static check — handy for
    tests and REPL triage.)"""
    if name in METRICS:
        return True
    return any(name.startswith(p) for p in PREFIXES)


def families() -> Tuple[str, ...]:
    """All declared names + prefixes, for report rendering."""
    return tuple(sorted(METRICS)) + tuple(sorted(PREFIXES))
