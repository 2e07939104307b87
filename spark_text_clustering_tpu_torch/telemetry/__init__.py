"""End-to-end telemetry of the port: metric registry, spans, run
manifests, JSONL — the JAX package's telemetry core, under its names.

Every hot path — pipeline phases, the EM/Online/NMF training loops,
streaming micro-batches, grid collectives, the epoch ledger — reports
through this one facade, and the JAX package's ``metrics`` tooling
(summarize / diff / merge) reads the emitted streams as it reads its
own: the same event types and metric names.

Usage (instrumented code)::

    from .. import telemetry

    with telemetry.span("train.em"):
        ...
    telemetry.count("collective.psum_data.calls")
    telemetry.observe("stream.score.micro_batch_seconds", dt)
    telemetry.event("micro_batch", batch_id=3, docs=8, seconds=dt)

Usage (a command that owns a run)::

    telemetry.configure("run/telemetry.jsonl", device=device)
    telemetry.manifest(params=params, mesh=grid, vocab_width=v)
    ... train ...
    telemetry.shutdown()        # final registry snapshot + close

Each rank of a grid is one process and routes its path through
``per_process_path`` (``events-p<rank>.jsonl``); ``metrics merge`` folds
the ranks' streams back into one logical run.  Hot-loop callables wrap
with ``instrument_dispatch(label, fn)`` for per-call attribution
(``dispatch.<digest>.*``, the hand-written kernels' launches and costs,
``compile.*``, ``mem.<digest>.*``; ``telemetry.dispatch``).

**Disabled is the default and costs (almost) nothing**: every helper
collapses to one module-global bool check; ``span()`` returns a shared
no-op singleton (no allocation), and ``device_sync`` is the bare
synchronize the call site made before.  The registry object itself is
always live so error counters (e.g. ``telemetry_write_errors``) work even
when no run sink is configured.

Import is light: torch is only touched when a sample, a sync or a span
needs it.
"""

from __future__ import annotations

import threading
import time
from typing import Iterable, Optional

from . import transport
from .dispatch import instrument as instrument_dispatch
from .dispatch import note_sync as _note_sync
from .events import (
    SCHEMA_VERSION,
    JsonlSink,
    TelemetryWriter,
    backend_fields,
    manifest_fields,
    per_process_path,
    process_info,
    read_events,
)
from .registry import (
    DEFAULT_SECONDS_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
)
from .spans import NOOP_SPAN, Span, current_path

__all__ = [
    "SCHEMA_VERSION",
    "MetricRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_SECONDS_BUCKETS",
    "TelemetryWriter",
    "JsonlSink",
    "read_events",
    "manifest_fields",
    "per_process_path",
    "process_info",
    "backend_fields",
    "instrument_dispatch",
    "Span",
    "current_path",
    "get_registry",
    "get_writer",
    "get_device",
    "enabled",
    "configure",
    "manifest",
    "shutdown",
    "span",
    "event",
    "count",
    "gauge",
    "observe",
    "device_sync",
    "in_device_sync",
    "sample_memory",
    "emit_fit",
]

# process anchor of the JAX package's time-to-first-dispatch metric: this
# package is imported at process start by every command
PROCESS_T0 = time.perf_counter()

_registry = MetricRegistry()
# device_sync's per-thread flag (in_device_sync)
_sync_state = threading.local()
_writer: Optional[TelemetryWriter] = None
_enabled = False
# the run's torch device (``configure(device=)``): the one memory samples
# read and the manifest's backend names
_device = None


def get_registry() -> MetricRegistry:
    return _registry


def get_writer() -> Optional[TelemetryWriter]:
    return _writer


def get_device():
    return _device


def enabled() -> bool:
    return _enabled


def configure(
    path: Optional[str] = None,
    *,
    run_id: Optional[str] = None,
    fresh_registry: bool = True,
    ship_to: Optional[str] = None,
    device=None,
) -> Optional[TelemetryWriter]:
    """Enable telemetry for this process.

    ``path`` is the run's JSONL stream (None = registry-only: spans and
    metrics aggregate in memory, nothing is written).  Reconfiguring
    closes any previous writer.  Returns the writer (or None).
    ``run_id`` names the run in every record (default: minted);
    ``fresh_registry=False`` keeps the metrics gathered so far.
    ``device`` is the run's torch device: memory samples read it, and
    the manifest names its backend.

    ``ship_to`` (or the ``STC_SHIP_TO`` env var, which is how supervised
    workers inherit the collector address) additionally pushes every
    record of the run stream to a collector daemon at ``host:port`` —
    see ``telemetry.transport``.
    """
    import os as _os

    global _writer, _enabled, _device
    if _writer is not None:
        _writer.close()
        _writer = None
    transport.close_shipping()
    if fresh_registry:
        _registry.reset()
    _writer = (
        TelemetryWriter(path, registry=_registry, run_id=run_id)
        if path
        else None
    )
    target = ship_to or _os.environ.get(transport.ENV_SHIP_TO, "")
    if path and target:
        transport.configure_shipping(
            target, stream_path=path, registry=_registry
        )
    _device = device
    _enabled = True
    return _writer


def manifest(**fields) -> None:
    """Write the run manifest (see ``events.manifest_fields`` for the
    ``params=``/``mesh=``/``vocab_width=`` conveniences; the backend is
    the configured device's)."""
    if _writer is not None:
        fields.setdefault("device", _device)
        _writer.write_manifest(**manifest_fields(**fields))


def shutdown() -> None:
    """Disable telemetry; flush the final registry snapshot and close
    the run stream.  The writer closes FIRST so the final registry
    snapshot flows through the sink into the shipper, then the shipper
    drains (or spools) it."""
    global _writer, _enabled, _device
    if _writer is not None:
        _writer.close()
        _writer = None
    transport.close_shipping()
    _enabled = False
    _device = None


def span(name: str, emit: bool = True, **fields):
    """Context manager; the no-op singleton when telemetry is off."""
    if not _enabled:
        return NOOP_SPAN
    return Span(name, emit=emit, **fields)


def _observe_span(path, seconds, emit, fields, error=False):
    # Span.__exit__ hook (kept here so spans.py stays state-free)
    if not _enabled:
        return
    _registry.histogram(f"span.{path}.seconds").observe(seconds)
    if error:
        _registry.counter(f"span.{path}.errors").inc()
    if emit and _writer is not None:
        _writer.emit(
            "span", name=path, seconds=round(seconds, 6),
            **({"error": True} if error else {}), **fields,
        )


def event(name: str, /, **fields) -> None:
    # ``name`` is positional-only so events may carry a "name" field
    if _enabled and _writer is not None:
        _writer.emit(name, **fields)


def count(name: str, n: int = 1) -> None:
    if _enabled:
        _registry.counter(name).inc(n)


def gauge(name: str, v: float) -> None:
    if _enabled:
        _registry.gauge(name).set(v)


def observe(
    name: str, v: float, buckets: Optional[Iterable[float]] = None
) -> None:
    if _enabled:
        _registry.histogram(name, buckets).observe(v)


def device_sync(x, label: str = "train"):
    """The wait for ``x``'s device, ATTRIBUTED instead of smeared:
    ``torch.cuda.synchronize`` for a CUDA tensor, nothing for a CPU one.

    Routing the hot loops' existing syncs through here gives the wait its
    own histogram (``device_sync.<label>.seconds``) and call counter, so
    a profile can say "the card was busy, the host was waiting".  It adds
    no sync of its own: disabled mode is the bare synchronize.  While it
    runs, ``in_device_sync()`` is true on this thread: the trace audit
    (lint layer 2, STC203) exempts the host reads made here, as STC005
    does.
    """
    _sync_state.active = True
    try:
        if not _enabled:
            if x.device.type == "cuda":
                import torch

                torch.cuda.synchronize(x.device)
            return x
        t0 = time.perf_counter()
        if x.device.type == "cuda":
            import torch

            torch.cuda.synchronize(x.device)
        dt = time.perf_counter() - t0
        _registry.histogram(f"device_sync.{label}.seconds").observe(dt)
        _registry.counter(f"device_sync.{label}.calls").inc()
        # the wait belongs to the call dispatched just before it: it
        # completes that digest's measured roofline seconds
        # (dispatch.note_sync)
        _note_sync(dt)
        return x
    finally:
        _sync_state.active = False


def in_device_sync() -> bool:
    """True while ``device_sync`` runs on this thread."""
    return getattr(_sync_state, "active", False)


def sample_memory(label: str = ""):
    """Live device-memory + host-RSS gauges (``mem.device.*`` /
    ``mem.host.rss_bytes``) and one ``memory_sample`` event — call at
    epoch/trigger boundaries.  No-op when telemetry is off; a CPU run
    degrades to an explicit ``device: "unavailable"`` marker
    (telemetry.memory)."""
    if not _enabled:
        return None
    from .memory import sample

    return sample(label)


def emit_fit(
    optimizer: str,
    times,
    kind: str = "per_iteration",
    start_iteration: int = 0,
    **summary,
) -> None:
    """Per-iteration + fit-summary telemetry from a training loop.

    One call at the end of each estimator's ``fit`` emits a
    ``train_iteration`` event per recorded wall time (``kind`` says
    whether they are true samples or chunk means — the
    ``IterationTimer.kind`` distinction) and one ``train_fit`` event
    carrying convergence/layout/roofline fields the caller passes
    (log_likelihood, loss, layout, cells, dispatches, ...).
    """
    if not _enabled:
        return
    # fit end is an epoch boundary: one live memory sample so every
    # training run's registry snapshot carries device/host pressure
    sample_memory(optimizer)
    for i, s in enumerate(times):
        _registry.histogram(
            f"train.{optimizer}.iteration_seconds"
        ).observe(float(s))
        if _writer is not None:
            _writer.emit(
                "train_iteration",
                optimizer=optimizer,
                iteration=start_iteration + i,
                seconds=round(float(s), 6),
                kind=kind,
            )
    clean = {k: v for k, v in summary.items() if v is not None}
    if _writer is not None:
        _writer.emit(
            "train_fit",
            optimizer=optimizer,
            iterations=len(list(times)),
            kind=kind,
            **clean,
        )
