"""Measured-scale observatory: RUN the vocab-sharded path on a forced
(data, model) grid of ranks, measure it, and reconcile the measurement
against the static scale audit (the JAX package's
``telemetry/scale_probe.py``, for torch).

The layer-3 scale audit (``analysis.scale_audit``, ``lint --scale``)
proves k=500/V=10M fits STATICALLY: one eager call of each entry on fake
tensors, a running sum of live bytes, a committed record.  A static
estimate that is never reconciled against a real run is a prediction
that can rot silently; this module is its empirical twin.  It runs the
vocab-sharded entry families (the EM bucket step, the online step, the
sharded scoring and evaluation, the sharded top terms) for real on a
grid of ranks that forces model-axis sharding
(``parallel.mesh.dryrun_grid``: 2x2 by default, at a scaled-down
geometry) and captures per entry, on every rank:

  * the per-rank peak: on the card the call's argument bytes plus the
    highest growth of the caching allocator's ``max_memory_allocated``
    over a WARM call (after ``reset_peak_memory_stats``; a first call
    also holds one-time allocations, a cuBLAS workspace, the kernel
    library's load); on the CPU, which keeps no such statistics, the
    dispatch record's attribution (arguments + outputs + the largest
    kernel scratch, ``telemetry.memory.attribute_call``), and
    ``mem_source`` says which: the measured twin of STC212;
  * each wide (vocabulary-width) operand's shard shape, read from its
    widths: a rank holds only its shard, so a leaf whose dim has the
    shard width (V/m, V/m+1) is sharded, and one with the full width (V,
    V+1) on a grid of m > 1 ran replicated: the runtime twin of STC213;
  * the collective bytes of one step from the dispatch record
    (``collective_bytes_per_call``, every collective ``parallel.
    collectives`` accounts inside the call): the twin of STC214;
  * the rank's device memory row (``telemetry.memory.per_device_stats``;
    the CPU reports ``unavailable``, never a crash);
  * zero-retrace evidence: the warm calls after the first must add no
    dispatch signature.

The parent merges the ranks into one evidence document (the largest
peak, collective bytes and retrace count over the ranks; an entry is
``model_sharded`` only where every rank's wide leaves were sharded).
Each probed entry is also called once at the SAME geometry through the
scale audit's own byte accounting (its fake mode and stand-ins), on the
audit grid of the probe's model shards, in the parent and on the CPU:
the "predicted" twin.  As in the JAX package the twin takes the whole
batch on one model row, so it reads high.  ``metrics scale-check``
multiplies the committed V=10M prediction (``analysis/
scale_baseline.json``) by the measured/predicted ratio for an
empirically anchored per-card estimate against the card's HBM budget;
``reconcile`` and ``measured_section`` are the JAX package's, as they
are.

Each rank rides the normal telemetry rails (its own registry-only
telemetry, or its ``<stem>-p<rank><ext>`` stream): instrumented dispatch
(``dispatch.<digest>.*``, kernel launches included), a
``memory_sample``, one ``scale_probe_entry`` event per entry and the
``scale.probe_runs`` counter.

Nothing here imports torch at import (the CLI's help path stays light);
the ranks load the kernels the parent built.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PROBE_VERSION",
    "PROBE_DIMS",
    "WARM_STEPS",
    "PEAK_TOLERANCE",
    "COLLECTIVE_TOLERANCE",
    "ProbeSpec",
    "PROBE_SPECS",
    "probe_spec_names",
    "run_probe",
    "reconcile",
    "measured_section",
]

PROBE_VERSION = 1

# the probe geometry (the JAX package's): small enough to run in seconds,
# wide enough that the vocab axis DOMINATES the byte accounting (V=64Ki
# f32 lambda = 2 MiB whole, 1 MiB a shard on the 2x2 grid) so predicted
# vs measured reconciles on the same buffers the V=10M budget is about.
# V and B must divide the grid's axes.
PROBE_DIMS: Dict[str, int] = {
    "k": 8,
    "v": 65536,
    "b": 16,
    "l": 16,
    "n": 10,        # top-words per topic per shard
}
WARM_STEPS = 2

# committed reconciliation tolerances (the scale-check gate defaults,
# the JAX package's).  The static estimate holds every tensor live until
# its last holder is freed and counts the batch's captured tensors, so it
# reads HIGH; the hazard the gate exists for is the other direction, a
# real run exceeding its static budget (or a replicated one blowing past
# it by ~model_shards x), so the tolerance bounds measured ABOVE
# predicted.
PEAK_TOLERANCE = 0.25
COLLECTIVE_TOLERANCE = 0.25

# the corpus size the online step is given (JAX's np.float32(1000.0))
_CORPUS = 1000.0


@dataclass(frozen=True)
class ProbeSpec:
    """One probed entry family.

    ``build(grid, dims, make)`` returns ``(fn, args)``: the callable the
    production path dispatches for the family, and this rank's shards of
    the probe's seeded arrays, each made by ``make(array, dtype)`` (a
    tensor on the rank's device in a live run, a fake one under the
    scale audit's fake mode for the predicted twin).  ``name`` joins the
    entry against the committed scale record; ``label`` is the dispatch
    label used when the built fn is not already instrumented."""

    name: str
    build: Callable
    label: str
    expects_sharding: bool = True
    note: str = ""


# ---------------------------------------------------------------------------
# builders: the vocab-sharded entry families, dispatched for real
# ---------------------------------------------------------------------------
def _probe_arrays(dims: Dict[str, int]):
    """The JAX package's seeded probe arrays (the same draws)."""
    rng = np.random.default_rng(7)
    k, v, b, l = dims["k"], dims["v"], dims["b"], dims["l"]
    wide = np.abs(rng.normal(size=(k, v))).astype(np.float32) + 0.1
    n_dk = np.abs(rng.normal(size=(b, k))).astype(np.float32) + 0.1
    ids = rng.integers(0, v, size=(b, l)).astype(np.int32)
    wts = np.ones((b, l), np.float32)
    return wide, n_dk, ids, wts


def _cols(grid, dims: Dict[str, int]) -> slice:
    """This rank's vocabulary columns [m V/M, (m+1) V/M)."""
    w = dims["v"] // grid.model_shards
    return slice(grid.m * w, (grid.m + 1) * w)


def _rows(grid, dims: Dict[str, int]) -> slice:
    """This rank's documents [d B/D, (d+1) B/D)."""
    per = dims["b"] // grid.data_shards
    return slice(grid.d * per, (grid.d + 1) * per)


def _build_em_bucket_step(grid, dims, make):
    import torch

    from ..config import Params
    from ..models.em_lda import EMLDA, make_em_chunk_runner

    # the verbose padded fit's dispatch (em.bucket_step): one sweep of the
    # padded layout's buckets, the batch held by the layout
    n_wk, n_dk, ids, wts = _probe_arrays(dims)
    est = EMLDA(Params(k=dims["k"], algorithm="em"), device=grid.device)
    est.grid = grid
    v = dims["v"]
    layout = est._padded_grid(list(zip(ids, wts)), v, v, dims["k"], 1.1,
                              1.1)
    return make_em_chunk_runner(layout.sweep), (
        make(n_wk[:, _cols(grid, dims)], torch.float32),
        make(n_dk[_rows(grid, dims)], torch.float32), 1)


def _build_online_train_step(grid, dims, make):
    import functools

    import torch

    from ..streaming import _online_step

    # the streaming step (stream.online_step): its step, docs and corpus
    # ride as CPU tensors, as the trainer passes them
    lam, gamma0, ids, wts = _probe_arrays(dims)
    rows = _rows(grid, dims)
    fn = functools.partial(
        _online_step, alpha=make(np.full((dims["k"],), 0.1, np.float32),
                                 torch.float32),
        eta=0.01, tau0=1024.0, kappa=0.51, grid=grid)
    return fn, (
        make(lam[:, _cols(grid, dims)], torch.float32),
        torch.tensor([0, dims["b"]], dtype=torch.int64),
        make(ids[rows], torch.int32), make(wts[rows], torch.float32),
        make(gamma0[rows], torch.float32),
        torch.tensor(_CORPUS, dtype=torch.float32))


def _build_sharded_topic_inference(grid, dims, make):
    import torch

    from ..models.sharded_eval import make_sharded_topic_inference

    lam, gamma0, ids, wts = _probe_arrays(dims)
    rows = _rows(grid, dims)
    fn = make_sharded_topic_inference(
        grid, alpha=np.full((dims["k"],), 0.1, np.float32),
        vocab_size=dims["v"], max_inner=5)
    return fn, (make(lam[:, _cols(grid, dims)], torch.float32),
                make(ids[rows], torch.int32), make(wts[rows], torch.float32),
                make(gamma0[rows], torch.float32))


def _build_sharded_em_log_likelihood(grid, dims, make):
    import torch

    from ..models.sharded_eval import make_sharded_em_log_likelihood

    n_wk, n_dk, ids, wts = _probe_arrays(dims)
    rows = _rows(grid, dims)
    fn = make_sharded_em_log_likelihood(grid, alpha=1.1, eta=1.1,
                                        vocab_size=dims["v"])
    return fn, (make(n_wk[:, _cols(grid, dims)], torch.float32),
                make(n_dk[rows], torch.float32),
                make(ids[rows], torch.int32), make(wts[rows], torch.float32))


def _build_sharded_top_terms(grid, dims, make):
    import torch

    from ..models.sharded_eval import make_sharded_top_terms

    lam, _, _, _ = _probe_arrays(dims)
    fn = make_sharded_top_terms(grid, vocab_size=dims["v"], n=dims["n"])
    return fn, (make(lam[:, _cols(grid, dims)], torch.float32),)


PROBE_SPECS: Tuple[ProbeSpec, ...] = (
    ProbeSpec(
        "em_lda.bucket_step", _build_em_bucket_step,
        label="scale_probe.em_bucket_step",
    ),
    ProbeSpec(
        "online_lda.train_step", _build_online_train_step,
        label="scale_probe.online_train_step",
        note="the online sufficient-stats step (E+M fused)",
    ),
    ProbeSpec(
        "sharded_eval.topic_inference", _build_sharded_topic_inference,
        label="sharded_eval.topic_inference",
    ),
    ProbeSpec(
        "sharded_eval.em_log_likelihood",
        _build_sharded_em_log_likelihood,
        label="sharded_eval.em_log_likelihood",
    ),
    ProbeSpec(
        "sharded_eval.top_terms", _build_sharded_top_terms,
        label="scale_probe.top_terms",
        note=(
            "sharded top-words extraction; no static scale record row "
            "yet, so scale-check reconciles shardings only"
        ),
    ),
)


def probe_spec_names() -> List[str]:
    return [s.name for s in PROBE_SPECS]


# ---------------------------------------------------------------------------
# measurement, on each rank
# ---------------------------------------------------------------------------
def _live_maker(device):
    """``make`` of a live run: the array as a tensor on ``device``."""
    import torch

    def make(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)

    return make


def _fake_maker():
    """``make`` of the predicted twin: a fake tensor of the array's shape
    (the builder runs under the scale audit's fake mode)."""
    import torch

    from ..analysis.scale_audit import fake_mode

    def make(a, dtype):
        with fake_mode():
            return torch.empty(np.shape(a), dtype=dtype)

    return make


def _step_collective_bytes(calls) -> int:
    """A step's collective bytes from ``(name, bytes)`` pairs: every
    collective ``parallel.collectives`` accounts, the set the dispatch
    layer charges to the call in flight (``collective_bytes_per_call``),
    so the measured side and the predicted twin sum the same calls."""
    return int(sum(n for _, n in calls))


def _collective_counter_total(snapshot: Dict) -> int:
    return int(sum(
        v for k, v in snapshot.get("counters", {}).items()
        if k.startswith("collective.") and k.endswith(".traced_bytes")
    ))


def _leaf_sharding_rows(leaves, dims: Dict[str, int], model_shards: int,
                        side: str) -> List[Dict]:
    """One row per wide (vocabulary-width) leaf of this rank: its global
    shape, the grid axis it is cut over (``spec``), its shard shape, and
    whether the wide dim is cut.  A rank holds only its shard, so widths
    tell: the shard's width (V/m, V/m+1) is a cut dim, the full width
    (V, V+1) on a grid of m > 1 a replicated one (with m = 1 nothing is
    cut)."""
    full = {dims["v"], dims["v"] + 1}
    cut = ({dims["v"] // model_shards, dims["v"] // model_shards + 1}
           if model_shards > 1 else set())
    rows: List[Dict] = []
    for i, leaf in enumerate(leaves):
        shape = [int(d) for d in getattr(leaf, "shape", ())]
        split = [j for j, d in enumerate(shape) if d in cut]
        whole = [j for j, d in enumerate(shape) if d in full]
        if not split and not whole:
            continue
        glob = [d * model_shards if j in split else d
                for j, d in enumerate(shape)]
        rows.append({
            "side": side, "index": i, "shape": glob,
            "shard_shape": shape,
            "sharded": bool(split) and not whole,
            "spec": "replicated" if whole and model_shards > 1
            else "model",
        })
    return rows


def _device_bytes(leaves, device) -> int:
    """Bytes of the tensor leaves that live on ``device``."""
    return sum(int(x.numel()) * x.element_size() for x in leaves
               if hasattr(x, "element_size") and x.device == device)


def _probe_entry(spec: ProbeSpec, grid, dims: Dict[str, int],
                 warm_steps: int, predicted: Dict) -> Dict:
    """One entry on this rank: a first call and ``warm_steps`` warm ones
    on its shards, then its measured evidence (``predicted`` is the
    entry's twin, for the ``scale_probe_entry`` event)."""
    import torch

    from . import device_sync, event, get_registry
    from . import dispatch as dispatch_attr

    fn, args = spec.build(grid, dims, _live_maker(grid.device))
    label = getattr(getattr(fn, "func", fn), "dispatch_label", None)
    if label is None:
        # attributed under the probe's own label: a probe run is not a
        # production call site, so it stays out of the lint registry's
        # dispatch labels (which telemetry.instrument_dispatch feeds)
        label = spec.label
        fn = dispatch_attr.instrument(label, fn)
    cuda = grid.device.type == "cuda"

    before = set(dispatch_attr.records())
    coll0 = _collective_counter_total(get_registry().snapshot())
    seconds: List[float] = []
    growth = 0
    out = None
    calls = 1 + max(0, warm_steps)
    for i in range(calls):
        if cuda and i == calls - 1:
            # the last call's growth over what is held before it
            out = None
            base = torch.cuda.memory_allocated(grid.device)
            torch.cuda.reset_peak_memory_stats(grid.device)
        t0 = time.perf_counter()
        out = fn(*args)
        device_sync(args[0], "scale_probe")
        seconds.append(time.perf_counter() - t0)
        if cuda and i == calls - 1:
            growth = torch.cuda.max_memory_allocated(grid.device) - base
        if i == 0:
            coll_delta = (_collective_counter_total(
                get_registry().snapshot()) - coll0)
            after_first = set(dispatch_attr.records())
    retraces = len(set(dispatch_attr.records())) - len(after_first)
    new_digests = sorted(after_first - before)

    recs = dispatch_attr.records()
    rec = next((recs[d] for d in new_digests if recs[d].label == label),
               recs[new_digests[0]] if new_digests else None)

    in_leaves = dispatch_attr.leaves(list(args))
    if cuda:
        arg_bytes = _device_bytes(in_leaves, grid.device)
        mem = {"arg_bytes": arg_bytes, "growth_bytes": int(growth),
               "peak_bytes": arg_bytes + int(growth)}
        source = "cuda_allocator:warm_call"
    else:
        mem = dict(rec.mem_bytes) if rec is not None and rec.mem_bytes \
            else None
        source = rec.mem_source if rec is not None else "no_record"
    measured: Dict = {
        "per_chip_peak_bytes": (mem or {}).get("peak_bytes"),
        "mem_source": source,
        "collective_bytes_per_step": (
            rec.collective_bytes_per_call
            if rec is not None and rec.collective_bytes_per_call is not None
            else coll_delta),
        "first_call_seconds": round(seconds[0], 6),
        "warm_step_seconds": [round(s, 6) for s in seconds[1:]],
    }
    if mem:
        measured["mem_bytes"] = mem

    shardings = _leaf_sharding_rows(in_leaves, dims, grid.model_shards, "in")
    shardings += _leaf_sharding_rows(dispatch_attr.leaves(out), dims,
                                     grid.model_shards, "out")
    model_sharded = (all(r["sharded"] for r in shardings) if shardings
                     else None)
    entry = {
        "label": label,
        "digests": new_digests,
        "expects_sharding": spec.expects_sharding,
        "measured": measured,
        "model_sharded": model_sharded,
        "shardings": shardings,
        "retraces_after_first": int(retraces),
        "launches": dict(rec.kernels) if rec is not None else {},
    }
    event(
        "scale_probe_entry",
        name=spec.name,
        label=label,
        measured_peak_bytes=measured["per_chip_peak_bytes"],
        predicted_peak_bytes=predicted["per_chip_peak_bytes"],
        measured_collective_bytes=measured["collective_bytes_per_step"],
        predicted_collective_bytes=predicted["collective_bytes_per_step"],
        model_sharded=model_sharded,
        retraces_after_first=int(retraces),
    )
    return entry


def _probe_rank(grid, predicted: Dict[str, Dict], dims: Dict[str, int],
                warm_steps: int, telemetry_file: Optional[str]) -> Dict:
    """One rank of the probe grid: its own telemetry (registry-only, or
    its ``<stem>-p<rank><ext>`` stream), each entry of ``predicted`` (name
    -> its twin) measured on its shards, its device memory row and its
    roofline rows."""
    import torch

    from .. import telemetry
    from .memory import per_device_stats
    from .roofline import rows_live

    path = None
    if telemetry_file:
        stem, ext = os.path.splitext(telemetry_file)
        path = f"{stem}-p{grid.rank}{ext or '.jsonl'}"
    telemetry.configure(path, device=grid.device)
    try:
        telemetry.manifest(kind="scale_probe", mesh=grid)
        entries = {s.name: _probe_entry(s, grid, dims, warm_steps,
                                        predicted[s.name])
                   for s in PROBE_SPECS if s.name in predicted}
        rows = per_device_stats(grid.device)
        # the rank's stream carries its device memory beside the probe's
        # dispatch attribution
        telemetry.sample_memory("scale_probe")
        digests = {d for e in entries.values() for d in e["digests"]}
        roofline = [r for r in rows_live() if r["digest"] in digests]
        telemetry.count("scale.probe_runs")
        kind = (torch.cuda.get_device_name(grid.device)
                if grid.device.type == "cuda" else grid.device.type)
        return {"entries": entries, "device_memory": rows,
                "roofline": roofline, "device_kind": kind}
    finally:
        telemetry.shutdown()


# ---------------------------------------------------------------------------
# the predicted twin, in the parent
# ---------------------------------------------------------------------------
def _predict(spec: ProbeSpec, dims: Dict[str, int],
             model_shards: int) -> Dict:
    """The entry called once at the probe geometry through the scale
    audit's byte accounting (``scale_audit._trace``: its fake mode, each
    storage's bytes once, its stand-ins for host reads) on the audit grid
    of ``model_shards``: the static law evaluated at the measured point.
    A copy of a result to the host (the top terms' ``.numpy()``) reads
    zeros: a fake tensor has no value, and the copy adds no device
    bytes."""
    from ..analysis.scale_audit import _trace, audit_grid

    grid = audit_grid(model_shards)
    make = _fake_maker()
    entry = SimpleNamespace(build=lambda d: spec.build(grid, d, make))
    trace, _ = _trace(f"scale_probe:{spec.name}", entry,
                      dict(dims, corpus=_CORPUS), host_copies=True)
    if not trace.done:
        raise RuntimeError(
            f"{spec.name}: the predicted twin did not run to its end: "
            + "; ".join(f.message for f in trace.stops))
    return {
        "per_chip_peak_bytes": int(trace.peak),
        "collective_bytes_per_step": _step_collective_bytes(
            trace.collectives),
    }


def _merge_entry(spec: ProbeSpec, ranks: List[Dict],
                 predicted: Dict) -> Dict:
    """The ranks' evidence of one entry as one: the largest peak,
    collective bytes, first-call seconds and retrace count; sharded only
    where every rank's wide leaves were; each sharding row with its
    rank."""
    meas = [r["measured"] for r in ranks]
    peaks = [m["per_chip_peak_bytes"] for m in meas]
    top = max(range(len(ranks)), key=lambda i: peaks[i] or 0)
    colls = [m["collective_bytes_per_step"] for m in meas]
    measured: Dict = {
        "per_chip_peak_bytes": (None if any(p is None for p in peaks)
                                else max(peaks)),
        "mem_source": meas[top]["mem_source"],
        "collective_bytes_per_step": (None if any(c is None for c in colls)
                                      else max(colls)),
        "first_call_seconds": max(m["first_call_seconds"] for m in meas),
        "warm_step_seconds": [max(s) for s in zip(
            *(m["warm_step_seconds"] for m in meas))],
    }
    if "mem_bytes" in meas[top]:
        measured["mem_bytes"] = meas[top]["mem_bytes"]
    sharded = [r["model_sharded"] for r in ranks]
    launches: Dict[str, int] = {}
    for r in ranks:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    entry: Dict = {
        "label": ranks[0]["label"],
        "digests": sorted({d for r in ranks for d in r["digests"]}),
        "expects_sharding": spec.expects_sharding,
        "measured": measured,
        "predicted": predicted,
        "model_sharded": (False if False in sharded
                          else None if all(s is None for s in sharded)
                          else True),
        "shardings": [dict(row, rank=i) for i, r in enumerate(ranks)
                      for row in r["shardings"]],
        "retraces_after_first": max(r["retraces_after_first"]
                                    for r in ranks),
        "launches": launches,
    }
    if spec.note:
        entry["note"] = spec.note
    return entry


def run_probe(
    entries: Optional[Sequence[str]] = None,
    *,
    model_shards: Optional[int] = None,
    dims: Optional[Dict[str, int]] = None,
    warm_steps: int = WARM_STEPS,
    device="cuda",
    ranks: Optional[int] = None,
    telemetry_file: Optional[str] = None,
) -> Dict:
    """Run the probe on a spawned grid of ``ranks`` ranks (default
    ``parallel.mesh.DRYRUN_RANKS``: the dryrun grid is 2x2) over gloo on
    ``device`` and return the evidence document (the JAX package's keys;
    ``device_count`` is the ranks).  Raises ``ValueError`` when v or b does not divide the grid
    or an entry is unknown, and ``RuntimeError`` without a card where
    "cuda" is asked for.  The CUDA kernels are built here first (nothing
    is built where the libraries are there); the ranks load them.
    ``telemetry_file`` gives each rank a run stream ``<stem>-p<rank>
    <ext>``; without it each rank's telemetry is registry-only."""
    from ..device import resolve_device
    from ..ops import _build
    from ..parallel.mesh import DRYRUN_RANKS, dryrun_grid, run_grid

    dims = dict(PROBE_DIMS, **(dims or {}))
    n_data, n_model = dryrun_grid(
        model_shards, DRYRUN_RANKS if ranks is None else ranks)
    if dims["v"] % n_model or dims["b"] % n_data:
        raise ValueError(
            f"probe geometry v={dims['v']}/b={dims['b']} does not "
            f"divide the {n_data}x{n_model} dryrun grid"
        )
    if entries is not None:
        unknown = set(entries) - {s.name for s in PROBE_SPECS}
        if unknown:
            raise ValueError(
                f"unknown probe entries {sorted(unknown)}; known: "
                f"{probe_spec_names()}"
            )
    selected = [s for s in PROBE_SPECS
                if entries is None or s.name in set(entries)]
    dev = resolve_device(device)

    # the twins first, on the CPU: no CUDA context in this process
    predicted = {s.name: _predict(s, dims, n_model) for s in selected}
    if dev.type == "cuda":
        _build.build_all()
    results = run_grid(
        _probe_rank, n_data, n_model,
        (predicted, dims, int(warm_steps), telemetry_file),
        backend="gloo", device=dev.type)

    evidence: Dict = {
        "version": PROBE_VERSION,
        "backend": dev.type,
        "device_kind": results[0]["device_kind"],
        "device_count": n_data * n_model,
        "mesh": {"data_shards": n_data, "model_shards": n_model},
        "forced_model_sharding": n_model > 1,
        "geometry": dict(dims),
        "warm_steps": int(warm_steps),
        "entries": {
            s.name: _merge_entry(s, [r["entries"][s.name] for r in results],
                                 predicted[s.name])
            for s in selected},
    }
    rows = [dict(row, rank=i) for i, r in enumerate(results)
            for row in r["device_memory"]]
    evidence["device_memory"] = {
        "devices": len(rows),
        "reporting": sum(1 for r in rows if "unavailable" not in r),
        "per_device": rows,
    }
    evidence["roofline"] = [dict(row, rank=i) for i, r in enumerate(results)
                            for row in r["roofline"]]
    return evidence


# ---------------------------------------------------------------------------
# reconciliation (the scale-check math, the JAX package's as it is; CLI
# rendering lives in metrics_cli._cmd_scale_check)
# ---------------------------------------------------------------------------
def _rel_error(measured: float, predicted: float) -> Optional[float]:
    if predicted is None or predicted <= 0 or measured is None:
        return None
    return (float(measured) - float(predicted)) / float(predicted)


def reconcile(
    evidence: Dict,
    record: Optional[Dict],
    *,
    peak_tolerance: float = PEAK_TOLERANCE,
    collective_tolerance: float = COLLECTIVE_TOLERANCE,
) -> Dict:
    """Join probe evidence against the committed static scale record.

    Per entry: signed relative error of measured vs predicted per-chip
    peak bytes and collective bytes at the PROBE geometry (divergence
    when measured exceeds predicted beyond tolerance — the static
    estimate is conservative by construction, so the gate bounds the
    dangerous direction), a measured-sharding match column, a
    zero-retrace check, and the extrapolation row: the committed V=10M
    static prediction scaled by the measured/predicted ratio, against
    the committed HBM budget.  Entries without a static record row
    reconcile shardings/retraces only (noted, not gated)."""
    rec_entries = (record or {}).get("entries", {})
    out: Dict = {
        "peak_tolerance": peak_tolerance,
        "collective_tolerance": collective_tolerance,
        "probe": {
            "backend": evidence.get("backend"),
            "mesh": evidence.get("mesh"),
            "geometry": evidence.get("geometry"),
            "device_count": evidence.get("device_count"),
        },
        "entries": {},
        "divergences": 0,
        "sharding_mismatches": 0,
    }
    if not evidence.get("forced_model_sharding"):
        out["divergences"] += 1
        out["probe_divergence"] = (
            "probe mesh did not force model-axis sharding "
            f"({evidence.get('mesh')}) — nothing measured here can "
            "stand in for the sharded path"
        )
    for name, ev in sorted(evidence.get("entries", {}).items()):
        row: Dict = {"label": ev.get("label")}
        divs: List[str] = []
        notes: List[str] = []
        meas, pred = ev.get("measured", {}), ev.get("predicted", {})

        mp = meas.get("per_chip_peak_bytes")
        pp = pred.get("per_chip_peak_bytes")
        row["predicted_peak_bytes"] = pp
        row["measured_peak_bytes"] = mp
        if mp is None:
            notes.append(
                "measured peak unavailable "
                f"({meas.get('mem_source', '?')})"
            )
        else:
            err = _rel_error(mp, pp)
            row["peak_rel_error"] = (
                round(err, 4) if err is not None else None
            )
            if err is not None and err > peak_tolerance:
                divs.append(
                    f"measured per-chip peak {mp} exceeds the static "
                    f"estimate {pp} by {err:+.1%} "
                    f"(tolerance +{peak_tolerance:.0%})"
                )

        mc = meas.get("collective_bytes_per_step")
        pc = pred.get("collective_bytes_per_step")
        row["predicted_collective_bytes"] = pc
        row["measured_collective_bytes"] = mc
        if mc is not None:
            err = _rel_error(mc, pc)
            row["collective_rel_error"] = (
                round(err, 4) if err is not None else None
            )
            if err is not None and err > collective_tolerance:
                divs.append(
                    f"measured collective bytes {mc} exceed the "
                    f"static estimate {pc} by {err:+.1%} "
                    f"(tolerance +{collective_tolerance:.0%})"
                )
        elif pc:
            notes.append("measured collective bytes unavailable")

        retr = int(ev.get("retraces_after_first", 0))
        row["retraces_after_first"] = retr
        if retr:
            divs.append(
                f"{retr} retrace(s) after the first step — the probe "
                "geometry must run zero-recompile warm"
            )

        static = rec_entries.get(name)
        declared_sharded = (
            int(static.get("model_shards", 1)) > 1
            if static is not None
            else bool(ev.get("expects_sharding"))
        )
        ms = ev.get("model_sharded")
        row["sharding"] = {
            "declared": declared_sharded,
            "measured_model_sharded": ms,
            "match": (ms == declared_sharded) if ms is not None
            else None,
        }
        if declared_sharded and ms is False:
            out["sharding_mismatches"] += 1
            divs.append(
                "no wide operand was model-axis sharded at runtime — "
                "the entry ran REPLICATED (empirical STC213)"
            )
        elif ms is None:
            notes.append("sharding unobservable (no wide leaves read)")

        if static is None:
            row["record"] = False
            notes.append(
                "no static scale record row — extrapolation skipped"
            )
        else:
            row["record"] = True
            if mp is not None and pp:
                ratio = float(mp) / float(pp)
                implied = int(
                    float(static["per_chip_peak_bytes"]) * ratio
                )
                budget = int(static.get("hbm_budget_bytes", 0))
                extra = {
                    "peak_ratio": round(ratio, 4),
                    "implied_per_chip_bytes": implied,
                    "static_per_chip_bytes": int(
                        static["per_chip_peak_bytes"]
                    ),
                    "hbm_budget_bytes": budget,
                    "within_budget": (
                        implied <= budget if budget else None
                    ),
                }
                if mc is not None and pc:
                    extra["collective_ratio"] = round(
                        float(mc) / float(pc), 4
                    )
                    extra["implied_collective_bytes"] = int(
                        float(static["collective_bytes_per_step"])
                        * extra["collective_ratio"]
                    )
                row["extrapolation"] = extra
                if budget and implied > budget:
                    divs.append(
                        f"measured-anchored extrapolation "
                        f"{implied / 2**30:.2f} GiB/chip at the "
                        f"declared scale exceeds the "
                        f"{budget / 2**30:.2f} GiB HBM budget"
                    )

        row["divergences"] = divs
        if notes:
            row["notes"] = notes
        out["divergences"] += len(divs)
        out["entries"][name] = row
    return out


def measured_section(evidence: Dict, recon: Dict) -> Dict:
    """The ``measured`` twin section committed into
    ``scale_baseline.json`` (``metrics scale-check --write-record``) —
    the empirically-anchored summary the drift rules in
    ``analysis.scale_audit.compare_measured_with_record`` gate future
    probe runs against."""
    entries: Dict[str, Dict] = {}
    for name, row in recon.get("entries", {}).items():
        e: Dict = {
            "model_sharded": row.get("sharding", {}).get(
                "measured_model_sharded"
            ),
            "retraces_after_first": row.get("retraces_after_first"),
        }
        if row.get("peak_rel_error") is not None:
            e["peak_rel_error"] = row["peak_rel_error"]
        extra = row.get("extrapolation")
        if extra:
            e["peak_ratio"] = extra["peak_ratio"]
            e["implied_per_chip_bytes"] = extra[
                "implied_per_chip_bytes"
            ]
            e["within_budget"] = extra["within_budget"]
            if "collective_ratio" in extra:
                e["collective_ratio"] = extra["collective_ratio"]
        entries[name] = e
    return {
        "version": PROBE_VERSION,
        "backend": evidence.get("backend"),
        "device_kind": evidence.get("device_kind"),
        "mesh": evidence.get("mesh"),
        "geometry": evidence.get("geometry"),
        "entries": entries,
    }
