"""Structured metrics and a device trace for the CLI.

  * ``MetricsLogger`` — append-only JSONL sink with the JAX package's
    record schema (``ts``, ``event`` and the fields); ``path=None`` drops
    every record, so call sites need not check whether metrics were asked
    for.
  * ``trace(log_dir)`` — a ``torch.profiler`` trace of the region, CPU and
    (where a card is present) CUDA activity, exported as a Chrome trace
    into ``log_dir``; the counterpart of the JAX package's
    ``jax.profiler`` trace.  ``None`` does nothing.
"""

from __future__ import annotations

import json
import os
import time
import warnings
from contextlib import contextmanager
from typing import Dict, Optional

__all__ = ["MetricsLogger", "trace"]


@contextmanager
def trace(log_dir: Optional[str]):
    """Profile the region into ``<log_dir>/trace_<millis>.json``."""
    if not log_dir:
        yield
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{int(time.time() * 1000)}.json")
    )


class MetricsLogger:
    """Append-only JSONL metrics sink.  Every record carries a wall-clock
    timestamp and an event name:

        {"ts": 1700000000.123, "event": "train_iteration",
         "iteration": 3, "seconds": 0.21, "kind": "per_iteration"}

    The file is truncated when the logger opens it: one run, one file.  A
    sink that fails warns once and drops its records; the run goes on."""

    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self._warned = False
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                open(path, "w", encoding="utf-8").close()
            except OSError as exc:
                self._surface(exc)

    def _surface(self, exc: OSError) -> None:
        if not self._warned:
            self._warned = True
            warnings.warn(f"metrics sink {self.path!r} is failing ({exc!r}); "
                          "records are being dropped", RuntimeWarning,
                          stacklevel=3)

    def log(self, event: str, **fields) -> None:
        if not self.path:
            return
        rec: Dict = {"ts": time.time(), "event": event}
        rec.update(fields)
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError as exc:
            self._surface(exc)

    def log_phases(self, phases: Dict[str, float]) -> None:
        for name, seconds in phases.items():
            self.log("phase", name=name, seconds=round(seconds, 6))

    def log_iteration_times(self, times, kind: str = "per_iteration") -> None:
        for i, s in enumerate(times):
            self.log(
                "train_iteration", iteration=i, seconds=round(s, 6),
                kind=kind,
            )
