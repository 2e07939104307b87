"""Causal trace context: one trace id from ingested file to served byte.

A W3C-traceparent-style context (``trace_id`` / ``span_id`` /
``parent_span_id`` / sampled flag) propagated across every process
boundary the stack already has:

    supervisor spawn  -> STC_TRACE in the worker env (``env_for_child``)
    worker startup    -> ``adopt_env()`` installs a child context
    heartbeat lease   -> ``fields()`` stamped into every lease write
    epoch ledger      -> begin/stage/commit records carry a child span
    model publish     -> the ``model-publish`` record's span is the
                         model's birth certificate (``stc lineage``)
    serve             -> inbound ``X-STC-Trace`` header (or a minted
                         head-sampled context) stamped through
                         coalescer batch -> dispatch -> response header

Wire format is the traceparent layout::

    00-<32 hex trace id>-<16 hex span id>-<01|00>

so any W3C-aware client can originate a trace.  ``metrics trace
--causal`` joins the emitted ``trace_span`` / trace-stamped events into
Perfetto flow events across process tracks, and ``stc lineage`` walks
the ledger side of the same ids.

Cost discipline: the module is jax-free, ``current()`` is one global
read, and nothing allocates unless a context is installed or minted.
Head sampling (``STC_TRACE_SAMPLE``, default 1.0) decides at mint time
whether a request's spans are emitted at all — an unsampled context
still propagates (the id is cheap; the spans are not).
"""

from __future__ import annotations

import os
import random
import re
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "ENV_CONTEXT",
    "ENV_SAMPLE",
    "HEADER",
    "TraceContext",
    "parse",
    "mint",
    "sample_rate",
    "new_trace_id",
    "new_span_id",
    "install",
    "current",
    "fields",
    "adopt_env",
    "env_for_child",
    "emit_adopt",
    "emit_span",
]

ENV_CONTEXT = "STC_TRACE"
ENV_SAMPLE = "STC_TRACE_SAMPLE"
HEADER = "X-STC-Trace"
VERSION = "00"

SPANS_COUNTER = "trace.spans"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# process-wide current context (workers install exactly one at startup;
# serve threads pass per-request contexts explicitly instead)
_current: Optional["TraceContext"] = None

# id entropy: a module RNG seeded from urandom — cheap per id, and tests
# may reseed for determinism without monkeypatching os.urandom
_rng = random.Random(int.from_bytes(os.urandom(8), "big"))


def new_trace_id() -> str:
    return f"{_rng.getrandbits(128):032x}"


def new_span_id() -> str:
    return f"{_rng.getrandbits(64):016x}"


@dataclass(frozen=True)
class TraceContext:
    """One node of a causal chain.  Immutable: hops derive children."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    sampled: bool = True

    def format(self) -> str:
        """The traceparent wire string (parent id travels out-of-band —
        the receiver's child() records it in its own records)."""
        return (
            f"{VERSION}-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    def child(self) -> "TraceContext":
        """A new span under this one: same trace, fresh span id."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            parent_span_id=self.span_id,
            sampled=self.sampled,
        )

    def to_fields(self) -> Dict:
        """Flat record fields (ledger records, lease files, events)."""
        out: Dict = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "sampled": self.sampled,
        }
        if self.parent_span_id:
            out["parent_span_id"] = self.parent_span_id
        return out


def parse(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a traceparent-style string; malformed input reads as no
    context (a bad header must never fail a request)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    _, trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    try:
        sampled = bool(int(flags, 16) & 0x01)
    except ValueError:
        sampled = True
    return TraceContext(
        trace_id=trace_id, span_id=span_id, sampled=sampled,
    )


def sample_rate() -> float:
    """Head-sampling probability for minted roots (``STC_TRACE_SAMPLE``,
    clamped to [0, 1]; default: sample everything)."""
    raw = os.environ.get(ENV_SAMPLE)
    if not raw:
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def mint(sampled: Optional[bool] = None) -> TraceContext:
    """A fresh root context.  ``sampled=None`` applies head sampling."""
    if sampled is None:
        rate = sample_rate()
        sampled = rate >= 1.0 or _rng.random() < rate
    return TraceContext(
        trace_id=new_trace_id(), span_id=new_span_id(), sampled=sampled,
    )


def install(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Set (or with None clear) this process's context."""
    global _current
    _current = ctx
    return ctx


def current() -> Optional[TraceContext]:
    return _current


def fields() -> Dict:
    """The installed context as flat record fields ({} when none) — the
    one-liner lease/ledger/event writers stamp with."""
    ctx = _current
    return ctx.to_fields() if ctx is not None else {}


def adopt_env() -> Optional[TraceContext]:
    """Worker startup: adopt a parent-propagated ``STC_TRACE`` as this
    process's context — a CHILD span of the spawner's, so the causal
    edge supervisor->worker is recorded on both sides.  No env, no
    context (standalone runs stay untraced unless they mint)."""
    ctx = parse(os.environ.get(ENV_CONTEXT))
    if ctx is None:
        return None
    return install(ctx.child())


def env_for_child(ctx: Optional[TraceContext]) -> Dict[str, str]:
    """Env fragment a spawner merges into a child process's environment
    (the supervisor's half of the adopt_env handshake)."""
    if ctx is None:
        return {}
    return {ENV_CONTEXT: ctx.format()}


def emit_adopt() -> None:
    """Announce the installed context on this process's run stream (the
    causal exporter's anchor for the worker end of the spawn edge)."""
    from . import enabled, event

    ctx = _current
    if ctx is None or not enabled():
        return
    event("trace_adopt", **ctx.to_fields())


def emit_span(
    name: str,
    *,
    trace_id: str,
    span_id: str,
    parent_span_id: Optional[str] = None,
    start: float,
    seconds: float,
    **extra,
) -> None:
    """One completed causal span onto the run stream.

    ``start`` is wall-clock (``time.time``) so ``metrics trace --causal``
    can place it on the cross-process corrected timeline; ``seconds`` is
    the measured duration.  Counted in ``trace.spans``.
    """
    from . import enabled

    if not enabled():
        return
    from . import count, event

    count(SPANS_COUNTER)
    event(
        "trace_span",
        name=name,
        trace_id=trace_id,
        span_id=span_id,
        **({"parent_span_id": parent_span_id} if parent_span_id else {}),
        start=round(float(start), 6),
        seconds=round(float(seconds), 6),
        **extra,
    )
