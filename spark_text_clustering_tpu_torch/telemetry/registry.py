"""Process-wide metric registry: counters, gauges, fixed-bucket histograms.

The reference's observability is ``System.nanoTime`` prints; this registry
is the structured replacement every instrumented hot path writes into
(training loops, streaming micro-batches, collectives, the TPU probe).
Design constraints, in order:

  * **Bounded memory.**  Histograms use FIXED log-spaced buckets — an
    endless stream-train run observing millions of latencies holds the
    same few hundred ints forever.  Percentiles are bucket-upper-bound
    estimates (conservative: reported >= true value), exact min/max/sum
    ride along.
  * **Near-zero cost when telemetry is off.**  The registry itself is
    always live (error counters must work even with telemetry disabled),
    but hot-path call sites go through the gated helpers in
    ``telemetry/__init__`` which collapse to one bool check.
  * **jax-free.**  The probe/bench parents import this before (or
    without) any jax bring-up.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "DEFAULT_SECONDS_BUCKETS",
]

# 10 us .. ~5400 s in x2 steps: wide enough for a micro-batch latency and
# a full 1M-doc fit in the same bucket family, 30 ints per histogram.
DEFAULT_SECONDS_BUCKETS: Tuple[float, ...] = tuple(
    1e-5 * (2.0 ** i) for i in range(30)
)


class Counter:
    """Monotonic add-only counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``buckets`` are ascending upper bounds; one implicit overflow bucket
    catches everything above the last bound.  ``percentile(q)`` returns
    the upper bound of the bucket holding the q-th observation, clamped
    to the exact observed max — an upper-bound estimate whose error is
    bounded by the bucket ratio (2x for the default log-2 spacing),
    which is the trade for never growing.
    """

    __slots__ = ("name", "buckets", "counts", "count", "sum", "min", "max")

    def __init__(
        self, name: str, buckets: Optional[Iterable[float]] = None
    ) -> None:
        self.name = name
        self.buckets: Tuple[float, ...] = tuple(
            sorted(buckets) if buckets is not None
            else DEFAULT_SECONDS_BUCKETS
        )
        self.counts: List[int] = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0 observations -> nan."""
        if self.count == 0:
            return math.nan
        rank = max(1, math.ceil(self.count * q / 100.0))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                upper = (
                    self.buckets[i] if i < len(self.buckets) else self.max
                )
                return min(upper, self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def snapshot(self, include_buckets: bool = False) -> Dict:
        out = {
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": None if self.count == 0 else self.min,
            "max": None if self.count == 0 else self.max,
            "mean": None if self.count == 0 else self.mean,
            "p50": None if self.count == 0 else self.percentile(50),
            "p95": None if self.count == 0 else self.percentile(95),
            "p99": None if self.count == 0 else self.percentile(99),
        }
        if include_buckets:
            # per-bucket (non-cumulative) counts aligned with bounds;
            # counts has one extra overflow slot past the last bound
            out["buckets"] = list(self.buckets)
            out["bucket_counts"] = list(self.counts)
        return out


class MetricRegistry:
    """Named metric store.  ``counter``/``gauge``/``histogram`` create on
    first use and return the same object after (type mismatch raises —
    one name, one kind).  Thread-safe creation; single-field updates ride
    on the GIL like every other Python counter."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name, *args)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(
        self, name: str, buckets: Optional[Iterable[float]] = None
    ) -> Histogram:
        if buckets is None:
            return self._get(name, Histogram)
        return self._get(name, Histogram, buckets)

    def snapshot(self, include_buckets: bool = False) -> Dict:
        """JSON-ready view of every metric, grouped by kind."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.snapshot()
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.snapshot()
            else:
                out["histograms"][name] = m.snapshot(include_buckets)
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
