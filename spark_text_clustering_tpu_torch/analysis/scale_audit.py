"""Layer 3: the scale audit of the registered entry points (the JAX
package's scale audit, read for torch; the module keeps its name so that
waivers, reports and the record read as JAX's do).

Layer 2 calls each entry at TOY shapes: right for dtype and host-read
discipline, blind to every defect that only exists at the CC-News
geometry (k=500 topics, V=10M terms): a signature that varies along an
unbucketed dim, an entry that stops fitting the card's memory, a
vocab-sharded path that quietly keeps a full-V operand, a collective that
moves the whole model every step.

Every entry point's registration declares its *scale shapes*
(``entrypoints.ScaleSpec``: the production geometry, the pow2 bucket
grids included), and this audit calls the entry once at each scale point
it needs, eagerly, on **fake tensors**: the builder and the call run
under one ``torch._subclasses.FakeTensorMode``, so a [500, 10M] float32
lambda is shape and dtype only, and no buffer is allocated.  A recording
``TorchDispatchMode`` above the fake mode sees every aten op:

  * it counts live bytes once per storage (``untyped_storage()._cdata``,
    which views share), adding a storage when a tensor first shows it and
    subtracting it when the last tensor holding it is freed
    (``weakref.finalize``); the running sum's peak over the call is the
    entry's ``per_chip_peak_bytes``, the eager counterpart of JAX's
    liveness scan;
  * it answers the host reads a fake tensor cannot answer
    (``aten._local_scalar_dense``: ``bool()``, ``int()``, ``float()``,
    ``.item()``) from ``STAND_INS``, keyed by the read and its call site as
    layer 2's STC203 snippets are: a ``bool`` read answers ``False`` (not
    converged, so each fixed point runs to the ``max_inner`` its builder
    sets), a numeric read the value declared for its site.

Multichip entries run on the **audit grid**, ``audit_grid()``: rank 0 of
a 1 x ``SCALE_MODEL_SHARDS`` grid with no process groups, so the code
slices the vocabulary as one card of a 16-card row would and every
collective returns at its ``group is None``.  The trace therefore sees
per-card shapes, and per-card bytes need no division.

Rules (STC21x; the waiver ``path`` is ``scale:<entry name>``):

  STC210  the builder or the call raised; no ``ScaleSpec``; a host read
          at scale with no declared stand-in; ``Tensor.numpy`` /
          ``tolist`` of a fake tensor; a real (non-fake) tensor over
          1 MiB in the call (the entry materialised a buffer at scale);
          a CUDA context made; the entry set drifting from the committed
          record
  STC211  the signature (the shapes of the tensor leaves, scalars by type
          only, as JAX's avals are) varies along a dim the spec does not
          declare bucketed, a "bucketed" grid that is not pow2, or the
          signature drifting from the committed record
  STC212  the per-card peak over the ``nvidia-h100`` budget
          (``hbm_bytes`` x ``HBM_UTILIZATION``), or drifting beyond
          ``PEAK_DRIFT_TOLERANCE`` from the committed record
  STC213  a vocab-sharded entry on the audit grid whose trace took an op
          input or output of the full sharded width (V or V+1) rather
          than the shard's: it would run replicated; a ``gather_model_
          rows*`` call whose result has the full width is the model-axis
          gather
  STC214  the bytes of the collectives the call made (``count_
          collectives``) over ``COLLECTIVE_BUDGET_BYTES`` or the spec's
          own budget
  STC215  the dtypes of the leaves in and out differ between the
          grid-min and grid-max traces

The kernel wrappers take their plain versions on CPU tensors (fake ones
too), so a kernel entry's peak is its plain version's, an upper bound of
the card's; its record also carries ``kernel_io_bytes``, the kernel
module's ``cost()`` bytes at the scale point.  The audit imports no jax,
builds no kernel library and makes no CUDA context.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import weakref
from typing import Dict, List, Mapping, Optional, Tuple

from .findings import Finding
from .jaxpr_audit import _call_site, _leaves

__all__ = [
    "COLLECTIVE_BUDGET_BYTES",
    "DEFAULT_BACKEND",
    "DEFAULT_SCALE_BASELINE_PATH",
    "HBM_UTILIZATION",
    "MEASURED_DRIFT_TOLERANCE",
    "PEAK_DRIFT_TOLERANCE",
    "REAL_BUDGET_BYTES",
    "RECORD_DRIFT",
    "STAND_INS",
    "audit_entry_scale",
    "audit_grid",
    "compare_measured_with_record",
    "compare_with_record",
    "fake_mode",
    "load_scale_record",
    "run_scale_audit",
    "save_scale_record",
]

# the port's own roofline row: one H100 SXM, 80 GiB of HBM3
DEFAULT_BACKEND = "nvidia-h100"
# fraction of the datasheet memory a step may claim: the rest is the
# caching allocator's fragmentation, the CUDA context and the libraries
HBM_UTILIZATION = 0.9
# per-card per-step collective budget, the JAX package's policy number
# (override per entry via ScaleSpec.collective_budget_bytes)
COLLECTIVE_BUDGET_BYTES = 2 << 30
# committed-record tolerance for byte estimates (signatures are exact)
PEAK_DRIFT_TOLERANCE = 0.10
# committed measured-twin drift tolerance, the JAX package's: an absolute
# band on the measured/predicted ratios of the record's "measured"
# section (written by ``telemetry.scale_probe`` through ``metrics
# scale-check --write-record``)
MEASURED_DRIFT_TOLERANCE = 0.25
# a real tensor above this in an audited call is a buffer materialised
# at scale (layer 2's captured-constant budget)
REAL_BUDGET_BYTES = 1 << 20

DEFAULT_SCALE_BASELINE_PATH = os.path.join(
    "spark_text_clustering_tpu_torch", "analysis", "scale_baseline.json"
)

# the count_collectives names that move bytes between cards (the others
# are the gather/scatter wrappers around them and the host -> device
# staging of a batch)
_REDUCING = ("psum_data", "psum_model", "fetch_global")

_PKG = "spark_text_clustering_tpu_torch"
_READ = "aten._local_scalar_dense"

# Every numeric host read an entry makes at scale, keyed by the read and
# its call site (layer 2's STC203 snippet, whose waiver names the same
# site).  The values answer the site's reads in the order one call makes
# them (cycling); a string names a scale dim, whose value at the traced
# point answers.  A bool read needs no entry: it answers False.
STAND_INS: Dict[str, Tuple] = {
    # the streaming step's int(step), int(docs), float(corpus): the
    # step is JAX's np.int32(3), the docs a batch, the corpus its dim
    f"{_READ} @ {_PKG}/streaming.py:<lambda>": (3, "b", "corpus"),
    # the M-step's int(step), int(docs): JAX's np.int32(3) and the batch
    f"{_READ} @ {_PKG}/models/online_lda.py:<lambda>": (3, "b"),
    # the chunked paths' int(step): JAX's np.int32(3)
    f"{_READ} @ {_PKG}/models/online_lda.py:run_chunk": (3,),
    # the transform's int(n_iter): JAX's np.int32(5)
    f"{_READ} @ {_PKG}/models/nmf.py:_solve_w": (5,),
    # the flat segment fixed point's float(worst) against tol: a value
    # above any tol, so the loop runs to the max_inner its builder sets
    f"{_READ} @ {_PKG}/ops/lda_math.py:gamma_fixed_point_segments": (1.0,),
}


class _ScaleStop(Exception):
    """A read the audit cannot answer: the trace stops, with its STC210
    finding already made."""


# the audit's fake mode while a build or call runs under it, else None
_active_mode = None


def fake_mode():
    """The audit's ``FakeTensorMode``, for a scale builder that makes its
    leaves: ``torch.empty(shape, dtype=...)`` under it allocates nothing.
    Raises outside the audit, where the same call would allocate the
    scale point's buffers for real."""
    if _active_mode is None:
        raise RuntimeError(
            "scale builders run only under the scale audit "
            "(analysis.scale_audit): outside it their leaves would be "
            "real buffers of the scale shapes")
    return _active_mode


def audit_grid(model_shards: Optional[int] = None):
    """Rank 0 of a 1 x ``model_shards`` grid on the CPU with no process
    groups: the code slices the vocabulary as one card of a row does, and
    every collective returns at ``group is None``."""
    import torch

    from ..parallel.mesh import ProcessGrid
    from .entrypoints import SCALE_MODEL_SHARDS

    return ProcessGrid(1, model_shards or SCALE_MODEL_SHARDS, rank=0,
                       device=torch.device("cpu"))


def _nbytes(t) -> int:
    return int(t.numel()) * t.element_size()


class _Trace:
    """What one call at one scale point showed."""

    def __init__(self):
        self.live: Dict[int, List[int]] = {}   # storage -> [bytes, holders]
        self.held: set = set()                 # ids of tensors counted
        self.cur = 0
        self.peak = 0
        self.calling = False
        self.reads: Dict[str, int] = {}
        self.stops: List[Finding] = []
        self.real: Dict[str, Finding] = {}
        self.wide: Dict[str, str] = {}         # site -> op signature
        self.collectives: List[Tuple[str, int]] = []
        self.sig: Tuple[str, ...] = ()
        self.dtypes: Tuple[str, ...] = ()
        self.done = False

    def track(self, t) -> None:
        tid = id(t)
        if tid in self.held:
            return
        try:
            st = t.untyped_storage()
            key, nbytes = st._cdata, st.nbytes()
        except (RuntimeError, NotImplementedError):
            return
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [nbytes, 0]
            self.cur += nbytes
            if self.calling and self.cur > self.peak:
                self.peak = self.cur
        entry[1] += 1
        self.held.add(tid)
        weakref.finalize(t, self._release, key, tid)

    def _release(self, key: int, tid: int) -> None:
        self.held.discard(tid)
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] <= 0:
            self.cur -= entry[0]
            del self.live[key]


def _modes(path: str, trace: _Trace, dims: Mapping[str, int],
           full_widths: frozenset, host_copies: bool = False):
    """The (function mode, dispatch mode) pair that records one scale
    call.  ``host_copies``: answer ``Tensor.numpy`` / ``tolist`` of a fake
    tensor with zeros of its shape instead of stopping the trace."""
    import numpy as np
    import torch
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    local_scalar = torch.ops.aten._local_scalar_dense.default
    # the numpy dtype of a fake tensor's host copy (``host_copies``)
    numpy_dtypes = {torch.float32: np.float32, torch.float64: np.float64,
                    torch.int32: np.int32, torch.int64: np.int64,
                    torch.bool: np.bool_}

    def stop(what: str, message: str) -> None:
        trace.stops.append(Finding(
            rule="STC210", path=path, line=0, message=message,
            snippet=what))
        raise _ScaleStop(what)

    def host_read(t):
        if t.dtype == torch.bool:
            return False                      # "not converged"
        key = f"{_READ} @ {_call_site()}"
        values = STAND_INS.get(key)
        if values is None:
            stop(key, f"host read at scale with no declared stand-in "
                      f"({key}): a fake tensor has no value to read; "
                      f"declare the read's value in scale_audit.STAND_INS "
                      f"beside its STC203 waiver")
        n = trace.reads.get(key, 0)
        trace.reads[key] = n + 1
        v = values[n % len(values)]
        v = dims[v] if isinstance(v, str) else v
        return float(v) if t.is_floating_point() else int(v)

    def real_check(t, what) -> None:
        if (not trace.calling or isinstance(t, FakeTensor)
                or _nbytes(t) <= REAL_BUDGET_BYTES):
            return
        site = _call_site()
        if site not in trace.real:
            trace.real[site] = Finding(
                rule="STC210", path=path, line=0,
                message=(
                    f"a real {t.dtype} tensor of {_nbytes(t)} bytes "
                    f"{what} at {site}: the entry materialised a buffer "
                    f"at scale (every tensor of the audit is fake)"),
                snippet=f"real {t.dtype}{list(t.shape)} @ {site}")

    class Functions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in ("numpy", "tolist") and args and isinstance(
                    args[0], FakeTensor):
                if host_copies:
                    zeros = np.zeros(tuple(args[0].shape),
                                     numpy_dtypes[args[0].dtype])
                    return zeros if name == "numpy" else zeros.tolist()
                what = f"Tensor.{name} @ {_call_site()}"
                stop(what, f"host read {what} of a fake tensor: at scale "
                           f"the entry copies a device buffer to the host")
            return func(*args, **(kwargs or {}))

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is local_scalar and isinstance(args[0], FakeTensor):
                return host_read(args[0])
            ins = [x for x in _leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            for t in ins:
                real_check(t, f"read by {func}")
                trace.track(t)
            out = _upper_bound(func, args, kwargs)
            outs = [x for x in _leaves(out) if isinstance(x, torch.Tensor)]
            for t in outs:
                real_check(t, f"made by {func}")
                trace.track(t)
            if full_widths and trace.calling:
                for t in ins + outs:
                    if full_widths.intersection(t.shape):
                        site = _call_site()
                        trace.wide.setdefault(
                            site, f"{func} {t.dtype}{list(t.shape)}")
                        break
            return out

    return Functions(), Ops()


def _upper_bound(func, args, kwargs):
    """``func(*args, **kwargs)``, where a size that depends on a fake
    tensor's values takes its upper bound: ``nonzero`` selects every
    element, a boolean mask index every position.  The fits' masks are
    live-slot masks, so the peak stays an upper bound of the card's."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    aten = torch.ops.aten
    if func is aten.nonzero.default and isinstance(args[0], FakeTensor):
        x = args[0]
        return torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                           device=x.device)
    if func is aten.index.Tensor:
        idx = list(args[1])
        if any(isinstance(i, FakeTensor) and i.dtype == torch.bool
               for i in idx):
            flat = []
            for i in idx:
                if isinstance(i, FakeTensor) and i.dtype == torch.bool:
                    flat.extend(torch.empty((i.numel(),), dtype=torch.int64,
                                            device=i.device)
                                for _ in range(i.dim()))
                else:
                    flat.append(i)
            return func(args[0], flat, *args[2:], **kwargs)
    return func(*args, **kwargs)


def _leaf_sigs(tree) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(shape signature, dtype names) of a tree's tensor and scalar
    leaves: a tensor by its shape, a Python scalar as JAX's aval of one
    (shape ``[]``, the scalar's type); other leaves (callables, grids)
    are not part of a signature."""
    import torch

    shapes, dtypes = [], []
    for x in _leaves(tree):
        if isinstance(x, torch.Tensor):
            shapes.append(f"[{','.join(str(int(d)) for d in x.shape)}]")
            dtypes.append(str(x.dtype).replace("torch.", ""))
        elif isinstance(x, (bool, int, float)):
            shapes.append("[]")
            dtypes.append(type(x).__name__)
    return tuple(shapes), tuple(dtypes)


@contextlib.contextmanager
def _telemetry_off():
    from .. import telemetry

    was = telemetry._enabled
    telemetry._enabled = False
    try:
        yield
    finally:
        telemetry._enabled = was


def _trace(path: str, spec, dims: Mapping[str, int],
           full_widths: frozenset = frozenset(), host_copies: bool = False):
    """Build and call the entry once at ``dims`` under the audit's fake
    mode and recording modes; returns (trace, built args).  The default
    dtype is float64 for the call (layer 2's hard mode), restored after
    it, also when it raises.  A read the audit cannot answer ends the
    trace with ``trace.done`` False and its finding in ``trace.stops``.
    ``host_copies`` answers a copy of a fake tensor to the host with
    zeros (the measured-scale probe's twin, whose entries may end by
    copying a result to the host: the copy adds no device bytes)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from ..parallel.collectives import count_collectives

    global _active_mode
    trace = _Trace()
    fmode, dmode = _modes(path, trace, dims, full_widths, host_copies)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    default = torch.get_default_dtype()
    outer, _active_mode = _active_mode, mode
    args = None
    # the builder's garbage is collected before the call, so the call's
    # peak starts from what it holds; the objects older than the build
    # are frozen out of that collection (a full one costs ~0.2 s)
    gc.freeze()
    try:
        with _telemetry_off(), mode, fmode, dmode:
            fn, args = spec.build(dict(dims))
            leaves = [x for x in _leaves(args) if isinstance(x, torch.Tensor)]
            for t in leaves:
                trace.track(t)
            gc.collect()
            trace.peak = trace.cur
            trace.calling = True
            torch.set_default_dtype(torch.float64)
            with count_collectives() as calls:
                out = fn(*args)
            trace.calling = False
        for t in leaves:
            if not isinstance(t, FakeTensor) and _nbytes(t) > REAL_BUDGET_BYTES:
                trace.real.setdefault("<args>", Finding(
                    rule="STC210", path=path, line=0,
                    message=(f"the builder passed a real {t.dtype} tensor "
                             f"of {_nbytes(t)} bytes: a scale leaf must be "
                             f"fake (made under fake_mode())"),
                    snippet=f"real {t.dtype}{list(t.shape)} @ <args>"))
        trace.collectives = list(calls)
        trace.sig, in_dt = _leaf_sigs(args)
        trace.dtypes = in_dt + ("->",) + _leaf_sigs(out)[1]
        trace.done = True
        del out
    except _ScaleStop:
        trace.done = False
    finally:
        gc.unfreeze()
        trace.calling = False
        _active_mode = outer
        torch.set_default_dtype(default)
    return trace, args


def _hbm_budget_bytes(backend: str) -> int:
    from ..telemetry.roofline import BACKEND_PEAKS

    peaks = BACKEND_PEAKS.get(backend) or BACKEND_PEAKS[DEFAULT_BACKEND]
    return int(peaks["hbm_bytes"] * HBM_UTILIZATION)


def audit_entry_scale(
    name: str,
    spec,
    *,
    multichip: bool = False,
    backend: str = DEFAULT_BACKEND,
) -> Tuple[List[Finding], Optional[Dict]]:
    """Run STC210-215 for one entry's ``ScaleSpec``; returns (findings,
    record): the record is the entry's row in the scale report and the
    committed record, None when the grid-max trace did not reach its end
    (its STC210 finding rides in the list)."""
    import torch

    findings: List[Finding] = []
    path = f"scale:{name}"
    pmax = {n: d.points[-1] for n, d in spec.dims.items()}
    pmin = {n: d.points[0] for n, d in spec.dims.items()}
    shard_sizes = frozenset(
        int(pmax[n]) for n in spec.sharded_dims if n in pmax)
    shards = spec.model_shards if spec.sharded_dims else 1
    full_widths = (frozenset(shard_sizes | {s + 1 for s in shard_sizes})
                   if spec.sharded_dims and multichip else frozenset())
    cuda_before = torch.cuda.is_initialized()
    once: Dict[str, Finding] = {}     # STC210s of the traces, one a snippet

    def traced(dims, what: str, widths: frozenset = frozenset()):
        try:
            trace, args = _trace(path, spec, dims, widths)
        except Exception as exc:
            findings.append(Finding(
                rule="STC210", path=path, line=0,
                message=(f"entry failed to build/trace at {what} scale "
                         f"point {dict(dims)}: {type(exc).__name__}: {exc}"),
                snippet=f"scale point {dict(dims)}"))
            return None, None
        for f in trace.stops + list(trace.real.values()):
            once.setdefault(f.snippet, f)
        return (trace, args) if trace.done else (None, None)

    def cuda_check() -> None:
        if torch.cuda.is_initialized() and not cuda_before:
            findings.append(Finding(
                rule="STC210", path=path, line=0,
                message="the entry made a CUDA context: the scale audit "
                        "runs on fake CPU tensors only",
                snippet="torch.cuda initialized"))

    top, args = traced(pmax, "the grid-max", full_widths)
    if top is None:
        findings.extend(once.values())
        cuda_check()
        return findings, None

    # ---- STC211: unbucketed dynamic dims / non-pow2 buckets -----------
    for dim_name, dim in spec.dims.items():
        if dim.bucketed and any(p < 1 or (p & (p - 1)) for p in dim.points):
            findings.append(Finding(
                rule="STC211", path=path, line=0,
                message=(
                    f"dim {dim_name!r} is declared bucketed but its grid "
                    f"{dim.points} is not pow2-aligned: the warm-up and "
                    f"the compile cache key on pow2 buckets"),
                snippet=f"dim {dim_name} grid {dim.points}"))
        if len(dim.points) < 2:
            continue
        adjacent = dict(pmax)
        adjacent[dim_name] = dim.points[-2]
        adj, _ = traced(adjacent, "an adjacent")
        if adj is not None and adj.sig != top.sig and not dim.bucketed:
            findings.append(Finding(
                rule="STC211", path=path, line=0,
                message=(
                    f"input signature varies with UNBUCKETED dim "
                    f"{dim_name!r} ({dim.points[-2]} -> {dim.points[-1]} "
                    f"changes the shapes): every distinct value at run "
                    f"time is one more signature; bucket the dim (pow2 "
                    f"grid) or pad it static"),
                snippet=f"unbucketed dynamic dim {dim_name}"))

    # ---- STC215: dtype drift across scale params ----------------------
    if pmin != pmax:
        low, _ = traced(pmin, "the grid-min")
        if low is not None and len(low.dtypes) != len(top.dtypes):
            findings.append(Finding(
                rule="STC215", path=path, line=0,
                message=(
                    f"traced arity changed between scale points "
                    f"({len(low.dtypes)} vs {len(top.dtypes)} leaves): "
                    f"the program's structure depends on scale params"),
                snippet="arity drift"))
        elif low is not None:
            for i, (a, b) in enumerate(zip(low.dtypes, top.dtypes)):
                if a != b:
                    findings.append(Finding(
                        rule="STC215", path=path, line=0,
                        message=(
                            f"dtype promotion manifests only at scale "
                            f"params: leaf {i} is {a} at {pmin} but {b} "
                            f"at {pmax}; anchor the dtype explicitly"),
                        snippet=f"leaf {i} {a}->{b}"))

    findings.extend(once.values())

    # ---- STC212: the card's memory budget -----------------------------
    budget = _hbm_budget_bytes(backend)
    peak = top.peak
    if peak > budget:
        findings.append(Finding(
            rule="STC212", path=path, line=0,
            message=(
                f"per-card peak-live estimate {peak / 2**30:.2f} GiB at "
                f"{pmax} exceeds the {backend} budget "
                f"{budget / 2**30:.2f} GiB ({shards} model shard(s)): "
                f"shard the wide operands or shrink the declared tier"),
            snippet=f"hbm estimate over {backend} budget"))

    # ---- STC213: a sharded entry that runs replicated -----------------
    for site, op in sorted(top.wide.items()):
        gather = site.rsplit(":", 1)[-1].startswith("gather_model_rows")
        findings.append(Finding(
            rule="STC213", path=path, line=0,
            message=(
                f"model-axis gather of the sharded width ({op} at {site}): "
                f"the whole vocabulary materialises on every card each "
                f"step" if gather else
                f"entry declares {tuple(spec.sharded_dims)} sharded over "
                f"{shards} cards, but {op} at {site} takes the full "
                f"sharded width, not the shard's: it would run "
                f"replicated"),
            snippet=f"{'gather' if gather else 'full width'} @ {site}"))

    # ---- STC214: collective bytes per step ----------------------------
    # a chunk entry runs spec.steps steps a call; the budget is a step's
    coll = sum(n for what, n in top.collectives
               if what in _REDUCING) // max(1, spec.steps)
    coll_budget = (spec.collective_budget_bytes
                   if spec.collective_budget_bytes is not None
                   else COLLECTIVE_BUDGET_BYTES)
    if coll > coll_budget:
        findings.append(Finding(
            rule="STC214", path=path, line=0,
            message=(
                f"collective traffic {coll / 2**30:.2f} GiB/card/step at "
                f"{pmax} exceeds the {coll_budget / 2**30:.2f} GiB "
                f"budget: reduce-scatter instead of psum+keep, or raise "
                f"the entry's declared budget with a reason"),
            snippet="collective bytes over budget"))

    cuda_check()

    record = {
        "dims": {n: list(d.points) for n, d in spec.dims.items()},
        "model_shards": shards,
        "signature": list(top.sig),
        "per_chip_peak_bytes": int(peak),
        "hbm_budget_bytes": int(budget),
        "hbm_frac": round(peak / budget, 4) if budget else None,
        "collective_bytes_per_step": int(coll),
        "backend": backend,
    }
    if spec.kernel_io is not None:
        record["kernel_io_bytes"] = int(spec.kernel_io(*args))
    if spec.note:
        record["note"] = spec.note
    return findings, record


# ---------------------------------------------------------------------------
# committed scale record (the JAX package's, unchanged)
# ---------------------------------------------------------------------------
# the snippets of compare_with_record's findings: drift that rewriting the
# record (lint --scale --rebaseline) resolves, so never a waiver
RECORD_DRIFT = (
    "missing scale_baseline.json",
    "entry vanished from scale audit",
    "entry missing from scale_baseline.json",
    "signature drift vs scale_baseline.json",
    "hbm drift vs scale_baseline.json",
)


def load_scale_record(path: str) -> Optional[Dict]:
    import json

    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_scale_record(report: Dict, path: str) -> None:
    """Write the committed scale record.  The record schema carries TWO
    sections: the static audit's ``entries`` (regenerated by
    ``stc lint --scale --rebaseline``) and the measured-scale
    observatory's ``measured`` twin (written by ``metrics scale-check
    --write-record``, from a probe run on the card).  Each writer owns
    only its own section — a static rebaseline
    must not silently drop the committed measured evidence, and vice
    versa."""
    import json

    if "measured" not in report:
        prev = load_scale_record(path)
        if prev and "measured" in prev:
            report = dict(report, measured=prev["measured"])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")


def compare_measured_with_record(
    fresh: Dict, record: Optional[Dict],
    tolerance: float = MEASURED_DRIFT_TOLERANCE,
) -> List[Dict]:
    """Drift rules for the measured twin: a fresh probe's
    measured/predicted ratios vs the record's committed ``measured``
    section.  Returns plain finding dicts (``entry``/``field``/``old``/
    ``new``/``why``) — the scale-check verb folds them into its
    divergence count.  No committed measured section (or a different
    probe geometry/mesh) yields no findings: drift needs a comparable
    anchor, and the first ``--write-record`` creates one."""
    old = (record or {}).get("measured")
    if not old or not isinstance(old, dict):
        return []
    if (
        old.get("geometry") != fresh.get("geometry")
        or old.get("mesh") != fresh.get("mesh")
    ):
        return [{
            "entry": "<record>", "field": "geometry",
            "old": {"geometry": old.get("geometry"),
                    "mesh": old.get("mesh")},
            "new": {"geometry": fresh.get("geometry"),
                    "mesh": fresh.get("mesh")},
            "why": (
                "committed measured section was captured at a "
                "different probe geometry/mesh — re-commit with "
                "--write-record (ratios are not comparable)"
            ),
        }]
    out: List[Dict] = []
    oe, ne = old.get("entries", {}), fresh.get("entries", {})
    for name in sorted(set(oe) & set(ne)):
        for fieldname in ("peak_ratio", "collective_ratio"):
            ov, nv = oe[name].get(fieldname), ne[name].get(fieldname)
            if ov is None or nv is None:
                continue
            if abs(float(nv) - float(ov)) > tolerance:
                out.append({
                    "entry": name, "field": fieldname,
                    "old": ov, "new": nv,
                    "why": (
                        f"measured/predicted {fieldname} drifted "
                        f"{ov} -> {nv} (> ±{tolerance} band) vs the "
                        f"committed measured record — re-run the "
                        f"probe and, if real, re-commit with "
                        f"--write-record"
                    ),
                })
        ov = oe[name].get("model_sharded")
        nv = ne[name].get("model_sharded")
        if ov is True and nv is False:
            out.append({
                "entry": name, "field": "model_sharded",
                "old": ov, "new": nv,
                "why": (
                    "entry was measured model-sharded in the "
                    "committed record but ran replicated now"
                ),
            })
    return out


def compare_with_record(
    report: Dict, record: Optional[Dict], baseline_path: str
) -> List[Finding]:
    """Drift gate against the committed scale record: entry-set changes
    and signature changes are exact (the recompile surface is policy),
    byte estimates get PEAK_DRIFT_TOLERANCE (liveness estimates may
    shift slightly across pinned-jax upgrades)."""
    regen = f"regenerate with `stc lint --scale --rebaseline` ({baseline_path})"
    if record is None:
        return [Finding(
            rule="STC210", path="scale:baseline", line=0,
            message=(
                f"no committed scale record at {baseline_path} — the "
                f"V=10M/k=500 claim has no evidence artifact; {regen}"
            ),
            snippet="missing scale_baseline.json",
        )]
    out: List[Finding] = []
    old = record.get("entries", {})
    new = report.get("entries", {})
    for name in sorted(set(old) - set(new)):
        out.append(Finding(
            rule="STC210", path=f"scale:{name}", line=0,
            message=(
                f"entry is in the committed scale record but no longer "
                f"audits at scale — {regen}"
            ),
            snippet="entry vanished from scale audit",
        ))
    for name in sorted(set(new) - set(old)):
        out.append(Finding(
            rule="STC210", path=f"scale:{name}", line=0,
            message=(
                f"entry audits at scale but is missing from the "
                f"committed scale record — {regen}"
            ),
            snippet="entry missing from scale_baseline.json",
        ))
    for name in sorted(set(new) & set(old)):
        o, n = old[name], new[name]
        if list(o.get("signature", [])) != list(n.get("signature", [])):
            out.append(Finding(
                rule="STC211", path=f"scale:{name}", line=0,
                message=(
                    f"scale input signature drifted from the committed "
                    f"record — the recompile surface changed; {regen}"
                ),
                snippet="signature drift vs scale_baseline.json",
            ))
        ob = float(o.get("per_chip_peak_bytes", 0))
        nb = float(n.get("per_chip_peak_bytes", 0))
        if ob and not math.isclose(
            nb, ob, rel_tol=PEAK_DRIFT_TOLERANCE
        ):
            out.append(Finding(
                rule="STC212", path=f"scale:{name}", line=0,
                message=(
                    f"per-chip peak estimate drifted "
                    f"{ob / 2**20:.1f} -> {nb / 2**20:.1f} MiB "
                    f"(> {PEAK_DRIFT_TOLERANCE:.0%} tolerance) vs the "
                    f"committed record — {regen}"
                ),
                snippet="hbm drift vs scale_baseline.json",
            ))
    return out


def run_scale_audit(
    entries=None,
    *,
    backend: str = DEFAULT_BACKEND,
) -> Tuple[List[Finding], Dict]:
    """Audit every registered entry point (or an explicit subset) at its
    declared scale shapes.  Returns (findings, report); a registration
    without a ``ScaleSpec`` is an STC210 finding: the scale tier covers
    the whole registry or says why not."""
    from .entrypoints import ENTRYPOINTS

    if entries is None:
        entries = ENTRYPOINTS
    findings: List[Finding] = []
    report: Dict = {
        "version": 1,
        "backend": backend,
        "hbm_utilization": HBM_UTILIZATION,
        "entries": {},
    }
    for ep in entries:
        spec = getattr(ep, "scale", None)
        if spec is None:
            findings.append(Finding(
                rule="STC210", path=f"scale:{ep.name}", line=0,
                message=(
                    "entry point declares no scale shapes "
                    "(EntryPoint.scale): the V=10M/k=500 audit cannot see "
                    "it; declare a ScaleSpec in the same change as the "
                    "registration"),
                snippet="no ScaleSpec declared"))
            continue
        f, record = audit_entry_scale(
            ep.name, spec, multichip=ep.multichip, backend=backend)
        findings.extend(f)
        if record is not None:
            report["entries"][ep.name] = record
    return findings, report
