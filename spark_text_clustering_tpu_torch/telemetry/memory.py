"""Live memory sampling (the ``mem.device.*`` / ``mem.host.*`` family).

``sample`` reads the run device's allocator statistics
(``mem.device.bytes_in_use`` / ``.peak_bytes_in_use`` / ``.bytes_limit``)
plus the host RSS (``mem.host.rss_bytes``), and emits one
``memory_sample`` event.  On a CUDA device ``bytes_in_use`` and
``peak_bytes_in_use`` are the bytes of live tensors
(``torch.cuda.memory_stats``: ``allocated_bytes.all.current`` and
``.peak``), not the caching allocator's reserve, and ``bytes_limit`` is
the card's total memory (``torch.cuda.mem_get_info``).  The sample also
publishes the per-device breakdown triple of the JAX package —
``mem.device.bytes_in_use_max`` / ``..._min`` (likewise for
``peak_bytes_in_use``) and ``mem.device.imbalance`` ((max-min)/max of the
peaks) — over the devices this process drives: one a rank, so a grid's
imbalance reads across the ranks' streams once ``metrics merge`` folds
them.  A CPU run reports no device memory: the sample then carries
``device: "unavailable"`` and counts ``mem.device_stats_unavailable``, as
the JAX package does on its CPU backend, so dashboards can tell "no
pressure" from "no data".  Call at epoch/trigger boundaries (the
``telemetry.sample_memory`` facade gates on enabled).

Per-executable attribution (``mem.<digest>.*``) comes with the dispatch
layer, ROADMAP item 9b.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

__all__ = [
    "sample",
    "host_rss_bytes",
    "device_stats",
    "per_device_stats",
    "device_breakdown",
]

# gauge suffixes, summed over the devices this process drives
_DEVICE_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def host_rss_bytes() -> Optional[int]:
    """Current resident set size of this process; None when unreadable.

    Linux reads /proc/self/status (current RSS); elsewhere falls back to
    ``getrusage`` ru_maxrss, which is the PEAK — close enough for the
    "did the host blow up" gauge this feeds."""
    try:
        with open("/proc/self/status", "r", encoding="ascii") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB, macOS bytes; both are order-of-magnitude
        # right for a fallback gauge — prefer the smaller interpretation
        return int(rss) * (1024 if sys.platform != "darwin" else 1)
    except (ImportError, OSError, ValueError):
        return None


def _cuda_row(torch, index: int) -> Dict:
    row: Dict = {"device": index,
                 "kind": str(torch.cuda.get_device_name(index))}
    try:
        stats = torch.cuda.memory_stats(index)
        _, total = torch.cuda.mem_get_info(index)
    except RuntimeError as exc:
        row["unavailable"] = type(exc).__name__
        return row
    row["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    row["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    row["bytes_limit"] = int(total)
    return row


def per_device_stats(device=None) -> Optional[List[Dict]]:
    """One row per device this process drives — ``device`` (default: the
    device ``telemetry.configure`` was given): ``{"device": i, "kind":
    ..., "bytes_in_use": ..., ...}`` for a CUDA device, ``{"device": 0,
    "kind": "cpu", "unavailable": "no_memory_stats"}`` for the CPU.  None
    when no device is known — an UNREPORTING device is data, not an
    error."""
    if device is None:
        from . import get_device

        device = get_device()
    if device is None:
        return None
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return [{"device": 0, "kind": dev.type,
                 "unavailable": "no_memory_stats"}]
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return [_cuda_row(torch, index)]


def device_breakdown(
    rows: Optional[List[Dict]],
) -> Optional[Dict[str, float]]:
    """Max/min/imbalance triple over the reporting devices of a
    ``per_device_stats`` view.  ``imbalance`` is (max-min)/max of the
    per-device PEAKS (0 = perfectly balanced, -> 1 = one device carries
    everything).  None when no device reports."""
    reporting = [
        r for r in (rows or []) if r and "unavailable" not in r
    ]
    if not reporting:
        return None
    out: Dict[str, float] = {"reporting_devices": len(reporting)}
    for name in _DEVICE_FIELDS:
        vals = [r[name] for r in reporting if name in r]
        if not vals:
            continue
        out[f"{name}_max"] = max(vals)
        out[f"{name}_min"] = min(vals)
    peak_max = out.get("peak_bytes_in_use_max")
    peak_min = out.get("peak_bytes_in_use_min")
    if peak_max:
        out["imbalance"] = (peak_max - peak_min) / peak_max
    return out


def device_stats(
    rows: Optional[List[Dict]] = None,
) -> Optional[Dict[str, int]]:
    """Summed statistics over the reporting rows (default: this
    process's devices); None when no device reports (the CPU)."""
    if rows is None:
        rows = per_device_stats()
    if rows is None:
        return None
    totals: Dict[str, int] = {}
    reported = 0
    for row in rows:
        if "unavailable" in row:
            continue
        reported += 1
        for name in _DEVICE_FIELDS:
            if name in row:
                totals[name] = totals.get(name, 0) + row[name]
    return totals if reported else None


def sample(label: str = "") -> Dict:
    """One live memory sample: device + host gauges and a
    ``memory_sample`` event.  Callers gate on ``telemetry.enabled()``
    (use the ``telemetry.sample_memory`` facade)."""
    from . import get_registry, get_writer

    reg = get_registry()
    reg.counter("mem.samples").inc()
    result: Dict = {"label": label}
    rss = host_rss_bytes()
    if rss is not None:
        reg.gauge("mem.host.rss_bytes").set(rss)
        result["host_rss_bytes"] = rss
    rows = per_device_stats()
    dev = device_stats(rows)
    if dev is None:
        reg.counter("mem.device_stats_unavailable").inc()
        result["device"] = "unavailable"
    else:
        for name, v in dev.items():
            reg.gauge(f"mem.device.{name}").set(v)
            result[f"device_{name}"] = v
        # per-device breakdown alongside the sums
        br = device_breakdown(rows)
        if br is not None:
            for name, v in br.items():
                if name == "reporting_devices":
                    continue
                reg.gauge(f"mem.device.{name}").set(v)
                result[f"device_{name}"] = v
    if rows is not None:
        result["devices"] = len(rows)
        result["devices_reporting"] = sum(
            1 for r in rows if "unavailable" not in r
        )
    w = get_writer()
    if w is not None:
        w.emit("memory_sample", **result)
    return result
