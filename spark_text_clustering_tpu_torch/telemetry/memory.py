"""Memory attribution (the ``mem.*`` family): per call and live.

Two views, both best-effort by contract (a device that cannot report
degrades to explicit ``unavailable`` markers, never a crash):

  * **Per-call attribution** — ``attribute_call`` is the port's
    counterpart of the JAX package's ``attribute_compiled``: at the first
    call of each dispatch digest (``telemetry.dispatch``) it publishes
    ``mem.<digest>.arg_bytes`` / ``.out_bytes`` (the call's tensor
    operands and results), ``.temp_bytes`` (the largest scratch a kernel
    wrapper allocated for one launch inside the call, 0 where none ran),
    ``.code_bytes`` (the size of the loaded libraries of the kernels the
    call launched; left out where it launched none, and ``mem_source``
    says so) and ``.peak_bytes`` (arg + out + temp, the JAX package's
    upper bound for one execution).
  * **Live sampling** — ``sample`` reads the run device's allocator statistics
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

"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

__all__ = [
    "attribute_call",
    "sample",
    "host_rss_bytes",
    "device_stats",
    "per_device_stats",
    "device_breakdown",
]

# gauge suffixes, summed over the devices this process drives
_DEVICE_FIELDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")


def _tensor_bytes(obj) -> int:
    from .dispatch import leaves

    return sum(x.numel() * x.element_size() for x in leaves(obj)
               if hasattr(x, "element_size") and hasattr(x, "numel"))


def attribute_call(rec, args, kwargs, out, scratch: int,
                   kernels: List[str]) -> None:
    """``mem.<digest>.*`` gauges from one call's tensors, the scratch its
    kernel wrappers allocated and the libraries of ``kernels``, the
    kernels it launched; stamps ``rec.mem_bytes`` / ``rec.mem_source``."""
    from . import get_registry

    mem: Dict[str, int] = {
        "arg_bytes": _tensor_bytes([list(args), dict(kwargs)]),
        "out_bytes": _tensor_bytes(out),
        "temp_bytes": int(scratch),
    }
    rec.mem_source = "tensors"
    if kernels:
        from ..ops import _build

        sizes = [_build.library_bytes(k) for k in kernels]
        if all(s is not None for s in sizes):
            mem["code_bytes"] = int(sum(sizes))
            rec.mem_source = "tensors+libraries"
    else:
        rec.mem_source = "tensors:no_kernel_library"
    mem["peak_bytes"] = (mem["arg_bytes"] + mem["out_bytes"]
                         + mem["temp_bytes"])
    reg = get_registry()
    for name, v in mem.items():
        reg.gauge(f"mem.{rec.digest}.{name}").set(v)
    rec.mem_bytes = mem


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
