"""Phase and per-iteration wall times (MLlib's ``iterationTimes``).

Both timers also report into the process telemetry registry when it is
enabled (a ``phase.<name>`` span, the ``train_iteration_seconds``
histogram); disabled, that is one bool check."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

from .. import telemetry

__all__ = ["IterationTimer", "PhaseTimer"]


class PhaseTimer:
    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with telemetry.span(f"phase.{name}"):
                yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        return "\n".join(f"{k}: {v:.3f}s" for k, v in self.phases.items())


class IterationTimer:
    """Per-iteration wall seconds.  ``kind`` is "interval_mean" once a
    chunk of iterations was timed as one span and split evenly."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0 = None
        self._split = False

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is not None:
            dt = time.perf_counter() - self._t0
            self.times.append(dt)
            telemetry.observe("train_iteration_seconds", dt)
            self._t0 = None

    @property
    def kind(self) -> str:
        return "interval_mean" if self._split else "per_iteration"

    def split_last(self, m: int) -> None:
        """Replace the last span with ``m`` equal slices."""
        if m > 1 and self.times:
            chunk = self.times.pop()
            self.times.extend([chunk / m] * m)
            self._split = True
