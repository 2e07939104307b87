"""The scoring service: a persistent, hot-swapping, continuously-batched
``serve`` daemon, one replica (docs/SERVING.md; the JAX package's
``serving`` package, ported).

The reference's scoring path is a cold batch job — every run pays process
startup and model load before the first document scores
(LDALoader.scala).  This package keeps one process resident:

  * **load-once, hot-swap** — the newest verified model loads once through
    the shared ``resolve_latest_model`` selection path; when a
    ``stream-train`` fleet publishes a newer model, the watcher verifies,
    loads and warms it OFF the serving path and installs it atomically:
    in-flight batches finish on the old model, new batches see the new
    one, and every response names the model (path + publishing epoch)
    that produced it.
  * **warmup ahead of traffic** — one dispatch per power-of-two token
    bucket before the port opens (the kernel loaded, the CUDA context
    made), so in-bucket traffic meets only shapes already run.
  * **continuous batching** — concurrent documents coalesce into one
    dispatch under a max-linger deadline
    (``serving.coalescer.RequestCoalescer``), with per-document
    ``serve.request_seconds`` / ``serve.queue_seconds`` /
    ``serve.batch_fill`` telemetry in the shared registry.
  * **graceful degradation** — bounded admission with a priced 429,
    degraded answers under pressure, SIGTERM drains (queued documents
    finish, new ones are refused), per-document failures get error
    responses instead of killing their batch, and the ``serve.accept`` /
    ``serve.admit`` / ``serve.batch`` / ``serve.swap`` fault sites are
    registered in the chaos harness.

Transport is stdlib-only: ``http.server.ThreadingHTTPServer`` on
localhost, JSON in/out, ``/score`` + ``/healthz`` + ``/metrics``.
"""

from .coalescer import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    PendingDoc,
    RequestCoalescer,
    ServiceDraining,
    ServiceOverloaded,
)

__all__ = [
    "DEFAULT_PRIORITY",
    "PRIORITIES",
    "PendingDoc",
    "RequestCoalescer",
    "ServiceDraining",
    "ServiceOverloaded",
    "ScoringService",
    "ServeScorer",
    "DegradeController",
    "make_http_server",
]

# ``server`` reaches torch and the models; importing it lazily (PEP 562)
# keeps the coalescer and the front's constants light to import, while
# ``from .serving import ScoringService`` works as it does in the JAX
# package
_SERVER_EXPORTS = (
    "ScoringService", "ServeScorer", "DegradeController",
    "make_http_server",
)


def __getattr__(name):
    if name in _SERVER_EXPORTS:
        from . import server

        return getattr(server, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
