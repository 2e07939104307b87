"""Hierarchical spans: wall-time attribution that nests under the torch
profiler.

``span("train.em")`` is a context manager that (1) pushes onto a
thread-local stack so nested spans record hierarchical paths
(``train.em/chunk``), (2) opens a ``torch.profiler.record_function`` with
the same path — so host spans line up with the device timeline inside an
active ``utils.profiling.trace`` capture — and (3) on exit, observes
``span.<path>.seconds`` on the registry and optionally emits a ``span``
event to the run's JSONL stream.  A span exists only while telemetry is
enabled, so the profiler range costs nothing otherwise.

Disabled mode returns a shared no-op singleton: no allocation, no
timestamps, one bool check at the call site (``telemetry.span``).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["Span", "NOOP_SPAN", "current_path"]

_tls = threading.local()


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_path() -> str:
    """Slash-joined path of currently-open spans on this thread."""
    return "/".join(_stack())


class _NoopSpan:
    """Reusable, reentrant do-nothing context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    __slots__ = ("name", "path", "emit", "fields", "_t0", "_annot",
                 "seconds")

    def __init__(self, name: str, emit: bool = True, **fields) -> None:
        self.name = name
        self.emit = emit
        self.fields = fields
        self.path = ""
        self.seconds: Optional[float] = None
        self._t0 = 0.0
        self._annot = None

    def __enter__(self) -> "Span":
        st = _stack()
        st.append(self.name)
        self.path = "/".join(st)
        # profiler alignment: a named range on the trace's host timeline
        try:
            import torch

            self._annot = torch.profiler.record_function(self.path)
            self._annot.__enter__()
        except (ImportError, RuntimeError):
            self._annot = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = time.perf_counter() - self._t0
        self.seconds = dt
        if self._annot is not None:
            try:
                self._annot.__exit__(exc_type, exc, tb)
            except RuntimeError:
                pass
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        from . import _observe_span  # late: avoids import cycle

        _observe_span(self.path, dt, self.emit, self.fields,
                      error=exc_type is not None)
        return False
