"""Roofline join: measured per-executable time vs cost-model peaks.

The dispatch layer records, per compiled executable: call counts,
in-call wall seconds, attributed ``device_sync`` wait seconds, and the
XLA ``cost_analysis()`` flops/bytes estimates.  This module joins them
against a per-backend peaks table to report **achieved FLOP/s and
bytes/s as a fraction of roofline**, per digest, sorted worst-first —
the number ROADMAP open item 2 demands before the NMF/online-VB fusion
work ("dispatch.* roofline numbers in bench").

Measured seconds = ``wall_seconds_total + sync_seconds_total``: the
host-side dispatch time plus the attributed ``block_until_ready`` wait
that immediately follows it in every hot loop.  For the scan-chunked
runners (one dispatch per interval, synced right after) that is the
end-to-end device interval; for pipelined per-batch loops it is a
LOWER bound on device time, so the roofline fraction reads
conservatively high — documented in docs/OBSERVABILITY.md.  The
COMPILING first call is excluded from the join (see ``roofline_row``):
its wall is trace+compile, not execution.

``roofline_frac`` is the fraction of the ATTAINABLE rate under the
classic roofline model: attainable FLOP/s = min(peak_flops,
arithmetic_intensity * peak_bytes/s).  A kernel at 3% of peak FLOP/s
but 90% of its bandwidth-bound attainable rate is memory-bound and
near-roofline — the sort key distinguishes "badly scheduled" from
"bandwidth-limited".

CPU peaks are order-of-magnitude sandbox defaults (override with
``metrics roofline --peaks peaks.json``); TPU peaks are per-chip
datasheet numbers, fp32 work reported against the bf16 MXU peak so
every fraction is a conservative lower bound (same convention as
bench.py's model-side MFU accounting).  The ``nvidia-h100`` row is the
H100 SXM's f32 peak (the port's count paths run f32 with TF32 off) and
its HBM3 rate and capacity; a run on a CUDA card takes it.

A copy of the JAX package's module: the same rows on the same stream.
Import is light (the CLI path never brings torch up).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = [
    "BACKEND_PEAKS",
    "resolve_peaks",
    "roofline_row",
    "rows_from_run",
    "rows_live",
]

# key -> {flops_per_s, bytes_per_s, hbm_bytes, note}; per chip (not per
# host).  hbm_bytes is the datasheet capacity the static scale audit
# (analysis.scale_audit, rule STC212) budgets per-chip peak-live
# estimates against.
BACKEND_PEAKS: Dict[str, Dict] = {
    "tpu-v5e": {
        "flops_per_s": 197e12, "bytes_per_s": 819e9,
        "hbm_bytes": 16 * 2**30,
        "note": "bf16 MXU peak / HBM2 per chip",
    },
    "tpu-v4": {
        "flops_per_s": 275e12, "bytes_per_s": 1228e9,
        "hbm_bytes": 32 * 2**30,
        "note": "bf16 MXU peak / HBM2 per chip",
    },
    "nvidia-h100": {
        "flops_per_s": 67e12, "bytes_per_s": 3.35e12,
        "hbm_bytes": 80 * 2**30,
        "note": "f32 peak (TF32 off) / HBM3 per H100 SXM card",
    },
    "cpu": {
        "flops_per_s": 5e10, "bytes_per_s": 2e10,
        "hbm_bytes": 64 * 2**30,
        "note": "order-of-magnitude sandbox default — override "
                "with --peaks for a calibrated host",
    },
}
_DEFAULT_TPU = "tpu-v5e"
_DEFAULT_GPU = "nvidia-h100"


def resolve_peaks(
    backend: str,
    device_kind: str = "",
    override: Optional[Dict] = None,
) -> Tuple[str, Dict]:
    """(peaks key, peaks dict) for a run's backend + device kind.

    ``override`` (a ``--peaks`` JSON object) wins outright when it
    carries flops_per_s/bytes_per_s; TPU generations match on the
    device kind string ('TPU v5e' -> tpu-v5e); a CUDA card (backend
    ``gpu``, or a backend or kind naming an H100) takes the
    ``nvidia-h100`` row;
    anything unmatched falls back to the cpu defaults so the verb always
    reports."""
    if override and "flops_per_s" in override and "bytes_per_s" in override:
        peaks = {
            "flops_per_s": float(override["flops_per_s"]),
            "bytes_per_s": float(override["bytes_per_s"]),
            "note": str(override.get("note", "user-supplied peaks")),
        }
        if isinstance(override.get("hbm_bytes"), (int, float)):
            peaks["hbm_bytes"] = int(override["hbm_bytes"])
        return "override", peaks
    backend = (backend or "").lower()
    kind = (device_kind or "").lower().replace(" ", "")
    if backend == "tpu" or kind.startswith("tpu"):
        for key in BACKEND_PEAKS:
            if not key.startswith("tpu-"):
                continue
            if key.split("-", 1)[1] in kind:
                return key, BACKEND_PEAKS[key]
        return _DEFAULT_TPU, BACKEND_PEAKS[_DEFAULT_TPU]
    if backend == "gpu" or "h100" in backend or "h100" in kind:
        return _DEFAULT_GPU, BACKEND_PEAKS[_DEFAULT_GPU]
    return "cpu", BACKEND_PEAKS["cpu"]


def roofline_row(
    *,
    digest: str,
    label: str,
    calls: float,
    seconds: float,
    est_flops: Optional[float],
    est_bytes: Optional[float],
    peaks: Dict,
    mem_peak_bytes: Optional[float] = None,
    cost_source: str = "",
    compile_seconds: Optional[float] = None,
) -> Dict:
    """One joined row; ``available`` is False when either side of the
    join is missing (no cost model, or zero measured seconds).

    When ``compile_seconds`` is known, the COMPILING first call is
    excluded from the join (one fewer call, its wall subtracted): that
    call's time is trace+XLA-compile, and folding it in would report a
    hot loop as orders of magnitude below roofline just for having
    compiled once.  A digest that only ever ran its compiling call
    reports unavailable — there is no warm measurement to judge."""
    row: Dict = {
        "digest": digest,
        "label": label,
        "calls": int(calls),
        "seconds": round(float(seconds), 6),
        "est_flops": est_flops,
        "est_bytes": est_bytes,
        "mem_peak_bytes": mem_peak_bytes,
        "cost_source": cost_source,
        "available": False,
    }
    # HBM headroom: the memory roofline next to the compute one — the
    # hbm_bytes column the static scale audit budgets against (STC212),
    # read off the SAME peaks table so both rooflines share one source
    hbm = peaks.get("hbm_bytes")
    if hbm and mem_peak_bytes is not None and mem_peak_bytes >= 0:
        row["hbm_bytes"] = int(hbm)
        row["hbm_frac"] = mem_peak_bytes / hbm
        row["hbm_headroom_bytes"] = int(hbm - mem_peak_bytes)
    if compile_seconds is not None and calls >= 1:
        calls = calls - 1
        seconds = seconds - float(compile_seconds)
        row["warm_calls"] = int(calls)
    if not calls or seconds <= 0 or not est_flops or est_flops <= 0:
        row["why_unavailable"] = (
            "only the compiling call ran"
            if row.get("warm_calls") == 0
            else "no measured seconds" if seconds <= 0 or not calls
            else f"no cost model ({cost_source or 'pending'})"
        )
        return row
    achieved_flops = est_flops * calls / seconds
    row["achieved_flops_per_s"] = achieved_flops
    row["frac_peak_flops"] = achieved_flops / peaks["flops_per_s"]
    attainable = peaks["flops_per_s"]
    if est_bytes and est_bytes > 0:
        achieved_bytes = est_bytes * calls / seconds
        row["achieved_bytes_per_s"] = achieved_bytes
        row["frac_peak_bytes"] = achieved_bytes / peaks["bytes_per_s"]
        intensity = est_flops / est_bytes      # FLOPs per byte
        bw_bound = intensity * peaks["bytes_per_s"]
        attainable = min(peaks["flops_per_s"], bw_bound)
        row["bound"] = (
            "memory" if bw_bound < peaks["flops_per_s"] else "compute"
        )
    row["attainable_flops_per_s"] = attainable
    row["roofline_frac"] = achieved_flops / attainable
    if row["roofline_frac"] > 1.0:
        # a fraction over 1 means the measured window missed device
        # time: the caller consumed the result without an attributed
        # device_sync (async dispatch -> wall is enqueue only), or the
        # peaks table understates this host.  Flagged, not clamped.
        row["overunity"] = True
    row["available"] = True
    return row


def _sort_worst_first(rows: List[Dict]) -> List[Dict]:
    """Available rows ascending by roofline fraction (worst first);
    unjoinable rows trail, largest time sink first."""
    avail = [r for r in rows if r["available"]]
    rest = [r for r in rows if not r["available"]]
    avail.sort(key=lambda r: (r["roofline_frac"], r["label"]))
    rest.sort(key=lambda r: (-r["seconds"], r["label"]))
    return avail + rest


def rows_from_run(
    manifest: Dict,
    metrics: Dict[str, float],
    events: List[Dict],
    peaks: Dict,
) -> List[Dict]:
    """Joined rows for one telemetry run stream: ``dispatch_executable``
    events carry the cost model per digest; the registry snapshot
    carries calls + wall/sync seconds + the ``mem.<digest>.peak_bytes``
    attribution."""
    by_digest: Dict[str, Dict] = {}
    for e in events:
        if e.get("event") == "dispatch_executable" and e.get("digest"):
            by_digest[str(e["digest"])] = e    # last announcement wins
    rows = []
    for d, e in by_digest.items():
        calls = metrics.get(f"counter.dispatch.{d}.calls", 0.0)
        seconds = metrics.get(
            f"gauge.dispatch.{d}.wall_seconds_total", 0.0
        ) + metrics.get(f"gauge.dispatch.{d}.sync_seconds_total", 0.0)
        rows.append(roofline_row(
            digest=d,
            label=str(e.get("label", "?")),
            calls=calls,
            seconds=seconds,
            est_flops=e.get("est_flops"),
            est_bytes=e.get("est_bytes"),
            peaks=peaks,
            mem_peak_bytes=(
                metrics.get(f"gauge.mem.{d}.peak_bytes")
                if f"gauge.mem.{d}.peak_bytes" in metrics
                else e.get("mem_peak_bytes")
            ),
            cost_source=str(e.get("cost_source", "")),
            compile_seconds=e.get("compile_seconds"),
        ))
    return _sort_worst_first(rows)


def live_peaks(device=None) -> Tuple[str, Dict]:
    """Peaks for a run on ``device`` (default: the device
    ``telemetry.configure`` was given): the row of the card's name when
    it is a CUDA device, the cpu defaults otherwise."""
    if device is None:
        from . import get_device

        device = get_device()
    if device is not None and str(device).startswith("cuda"):
        import torch

        return resolve_peaks("gpu", torch.cuda.get_device_name(device))
    return resolve_peaks("cpu")


def rows_live(
    peaks: Optional[Dict] = None, prefix: Optional[str] = None
) -> List[Dict]:
    """Joined rows straight from the live dispatch records (no stream
    round trip).  ``prefix`` filters by dispatch label family
    (``"em."``)."""
    from . import dispatch

    if peaks is None:
        _, peaks = live_peaks()
    rows = []
    for rec in dispatch.records().values():
        if prefix and not rec.label.startswith(prefix):
            continue
        rows.append(roofline_row(
            digest=rec.digest,
            label=rec.label,
            calls=rec.calls,
            seconds=rec.wall_seconds + rec.sync_seconds,
            est_flops=rec.est_flops,
            est_bytes=rec.est_bytes,
            peaks=peaks,
            mem_peak_bytes=(rec.mem_bytes or {}).get("peak_bytes"),
            cost_source=rec.cost_source,
            compile_seconds=rec.compile_seconds,
        ))
    return _sort_worst_first(rows)
