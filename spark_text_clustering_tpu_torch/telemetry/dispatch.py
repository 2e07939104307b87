"""Per-call attribution of the port's dispatches (the ``dispatch.*``
family), under the JAX package's names and events.

Every hot-loop call site wraps its callable with ``instrument(label,
fn)``, which keys each distinct (label, signature) pair to a stable
digest, the signature being each tensor operand's shape, dtype and
device (a Python scalar by its value, as the JAX package keys a static
argument), and records per digest:

  * ``dispatch.<digest>.calls``                 (counter) calls
  * ``dispatch.<digest>.collective_bytes``      (counter) bytes of the
    grid collectives the calls issued (``parallel.collectives._acct``
    counts each real call per rank and hands its bytes here)
  * ``dispatch.<digest>.est_bytes`` / ``.est_flops`` / ``.est_seconds``
    (gauges) the first call's estimates: the sum of the hand-written
    kernels' ``cost()`` over the launches made inside it, and the sum of
    each launch's least time on the card's peaks (``telemetry.
    roofline``); a call that launched no kernel has none
  * ``dispatch.<digest>.device_seconds_total`` / ``.device_bytes_total``
    (gauges) the estimates times the calls
  * ``dispatch.<digest>.wall_seconds_total`` / ``.sync_seconds_total``
    (gauges) the calls' wall time, and the ``device_sync`` waits that
    followed them: the measured side of the ``metrics roofline`` join
  * ``dispatch.<digest>.launches.<kernel>`` (counter) the kernels'
    launches inside the calls, by wrapper name: the same counts as
    ``ops._build.LAUNCHES``, split by call

plus one ``dispatch_executable`` event per digest per run stream, the
JAX package's fields, mapping the digest back to its label and
signature.  The first call of each digest also feeds
``telemetry.compilation`` (the ``compile.*`` recompile sentinel) and
``telemetry.memory`` (``mem.<digest>.*``).

Nothing is traced or compiled, so the port differs from the JAX package
where that shows:

  * the estimates count the hand-written kernels only (a call's plain
    PyTorch ops add nothing), so ``metrics roofline`` reads a call low,
    never high, for what it leaves out; ``cost_source`` says
    ``"kernels"``, or ``"none"`` where a call launched no kernel (every
    call on the CPU, where the wrappers run their plain versions);
  * ``compile_seconds`` is the first call's wall time where that call
    built or loaded a kernel library (``ops._build.load_library``), the
    port's one compile; where it loaded nothing it compiled nothing and
    stays None, so the roofline join keeps the call;
  * the compile cache (``compilecache``) stores kernel libraries, not
    executables: a first call that loaded a library from the store has
    ``cache_status`` ``"hit"`` (and ``cache_load_seconds``), one that
    built or took a library and published it ``"miss"``; with the cache
    unarmed, or where the call loaded nothing, it stays ``"off"``.

Disabled telemetry reduces the wrapper to one bool check plus the call;
attribution never raises into the loop it observes.  Import is light:
nothing here touches torch.
"""

from __future__ import annotations

import functools
import hashlib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "ExecutableRecord",
    "instrument",
    "records",
    "reset",
    "note_collective",
    "note_sync",
    "note_launch",
    "note_library_load",
    "note_cache_config",
    "cache_armed",
    "recording",
    "cost_tracing",
]

# the telemetry package (this module's parent): its ``_enabled`` flag is
# the wrapper's one check
_pkg = sys.modules[__package__]
_tls = threading.local()
_lock = threading.Lock()
# kernel libraries loaded (or built and loaded) in this process so far,
# and those of them the compile cache served ("hit") or had to take from
# the build directory and publish ("miss"), with the hits' load seconds
_library_loads = 0
_cache_loads = {"hit": 0, "miss": 0}
_cache_hit_seconds = 0.0


@dataclass
class ExecutableRecord:
    """What we know about one (label, signature) pair."""

    digest: str
    label: str
    signature: str
    calls: int = 0
    # collective bytes of the first call (None until it ran)
    collective_bytes_per_call: Optional[int] = None
    est_flops: Optional[float] = None
    est_bytes: Optional[float] = None
    est_seconds: Optional[float] = None
    cost_source: str = "pending"
    # the first call's wall time where it built or loaded a library
    compile_seconds: Optional[float] = None
    # nth distinct signature for this label (1 = no retrace yet)
    compile_ordinal: Optional[int] = None
    wall_seconds: float = 0.0
    sync_seconds: float = 0.0
    # {arg,out,temp,peak[,code]}_bytes of the first call (telemetry.memory)
    mem_bytes: Optional[Dict[str, int]] = None
    mem_source: str = "pending"
    cache_status: str = "off"
    cache_load_seconds: Optional[float] = None
    # kernel launches per wrapper name, over every call
    kernels: Dict[str, int] = field(default_factory=dict)
    announced_to: Optional[int] = None
    _seen: bool = field(default=False, repr=False)


class _Frame:
    """One instrumented call in flight: what its launches and collectives
    added."""

    __slots__ = ("launches", "bytes", "flops", "seconds", "scratch",
                 "collective_bytes", "cost_error")

    def __init__(self) -> None:
        self.launches: Dict[str, int] = {}
        self.bytes = 0.0
        self.flops = 0.0
        self.seconds = 0.0
        self.scratch = 0
        self.collective_bytes = 0
        self.cost_error: Optional[str] = None


_records: Dict[str, ExecutableRecord] = {}
# the card's peaks, looked up at the first launch that needs them
_peaks: Optional[Dict] = None


def records() -> Dict[str, ExecutableRecord]:
    """Live digest -> record table (tests / REPL triage)."""
    return dict(_records)


def reset() -> None:
    from . import compilation

    with _lock:
        _records.clear()
    _tls.last_record = None
    compilation.reset()


def _stack() -> List[_Frame]:
    st = getattr(_tls, "frames", None)
    if st is None:
        st = _tls.frames = []
    return st


def recording() -> bool:
    """True while an instrumented call runs on this thread with telemetry
    enabled: a kernel wrapper's launch is then charged to it."""
    return bool(getattr(_tls, "frames", None))


def cost_tracing() -> bool:
    """Always False: nothing is ever retraced for a cost analysis (the
    JAX package's collectives skip their counters while it is True)."""
    return False


def note_collective(nbytes: int) -> None:
    """Charge a grid collective's bytes to the instrumented call running
    on this thread (no-op outside one)."""
    st = getattr(_tls, "frames", None)
    if st:
        st[-1].collective_bytes += int(nbytes)  # stc-lint: disable=STC005 -- nbytes is the host-side byte count the collectives compute from their operands' numel and element size; int() of a Python int waits for nothing


def note_library_load(cache: str = "off",
                      load_seconds: Optional[float] = None) -> None:
    """``ops._build`` loaded (or built and loaded) a kernel library;
    ``cache`` says how the compile cache took part ("hit", "miss" or
    "off")."""
    global _library_loads, _cache_hit_seconds
    _library_loads += 1
    if cache in _cache_loads:
        _cache_loads[cache] += 1
        if load_seconds is not None:
            _cache_hit_seconds += load_seconds


# -- the compile cache's armed state (compilecache) --------------------------
# ``compilecache.configure()``/``reset()`` push it here, so a library load
# reads one global instead of asking the store
_cache_pending = True
_cache_on = False


def note_cache_config(active: Optional[bool]) -> None:
    """compilecache pushes its armed state (None = re-read the env
    lazily on the next library load)."""
    global _cache_pending, _cache_on
    if active is None:
        _cache_pending = True
        _cache_on = False
    else:
        _cache_pending = False
        _cache_on = bool(active)


def cache_armed() -> bool:
    """Whether library loads go through the compile cache."""
    global _cache_pending, _cache_on
    if _cache_pending:
        from .. import compilecache

        _cache_on = compilecache.active()
        _cache_pending = False
    return _cache_on


def _launch_seconds(nbytes: float, flops: float) -> float:
    """A launch's least time on the card's peaks (the larger of its
    bytes over the memory rate and its flops over the f32 rate)."""
    global _peaks
    if _peaks is None:
        from .roofline import live_peaks

        _peaks = live_peaks("cuda")[1]
    return max(nbytes / _peaks["bytes_per_s"], flops / _peaks["flops_per_s"])


def note_launch(name: str, cost: Optional[Callable] = None,
                scratch: int = 0) -> None:
    """One kernel launch inside the instrumented call on this thread:
    its count, its cost (``cost()`` -> (bytes, flops), asked only here)
    and the scratch its wrapper allocated."""
    st = getattr(_tls, "frames", None)
    if not st:
        return
    frame = st[-1]
    frame.launches[name] = frame.launches.get(name, 0) + 1
    frame.scratch = max(frame.scratch, int(scratch))
    if cost is None:
        return
    try:
        nbytes, flops = cost()
        seconds = _launch_seconds(nbytes, flops)
    except Exception as exc:
        # attribution never raises into the loop it observes: the call
        # reports no estimate, and why (its cost_source)
        frame.cost_error = type(exc).__name__
        return
    frame.bytes += nbytes
    frame.flops += flops
    frame.seconds += seconds


def note_sync(seconds: float) -> None:
    """Attribute a ``telemetry.device_sync`` wait to the digest this
    thread dispatched LAST (one-shot: each hot loop pairs a dispatch with
    one sync, and clearing the slot keeps a later unrelated sync off a
    stale digest)."""
    rec = getattr(_tls, "last_record", None)
    if rec is None:
        return
    _tls.last_record = None
    rec.sync_seconds += float(seconds)
    _pkg.get_registry().gauge(
        f"dispatch.{rec.digest}.sync_seconds_total"
    ).set(rec.sync_seconds)


# -- signature / digest ------------------------------------------------------
def leaves(obj) -> list:
    """The operands of a call, flattened through tuples, lists, dicts
    (values by sorted key) and dataclasses (fields in order, such as a
    ``DocTermBatch``), as the JAX package's tree leaves."""
    if isinstance(obj, (tuple, list)):
        return [x for item in obj for x in leaves(item)]
    if isinstance(obj, dict):
        return [x for key in sorted(obj) for x in leaves(obj[key])]
    fields = getattr(type(obj), "__dataclass_fields__", None)
    if fields is not None:
        return [x for name in fields for x in leaves(getattr(obj, name))]
    return [obj]


def _leaf_sig(leaf: Any) -> str:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is not None and dtype is not None:
        device = getattr(leaf, "device", None)
        where = f"@{device}" if device is not None else ""
        return f"{str(dtype).replace('torch.', '')}{tuple(shape)}{where}"
    if isinstance(leaf, (int, float, bool, str)) or leaf is None:
        return repr(leaf)
    return type(leaf).__name__


def _signature(args, kwargs) -> str:
    """Shape/dtype/device signature of a call's operands: the digest key."""
    return "|".join(_leaf_sig(x) for x in leaves(list(args))
                    + leaves(dict(kwargs)))


def _digest(label: str, signature: str) -> str:
    return hashlib.sha1(f"{label}|{signature}".encode()).hexdigest()[:10]


# -- accounting --------------------------------------------------------------
def _first_call(rec: ExecutableRecord, frame: _Frame, args, kwargs, out,
                dt: float, loads: tuple) -> None:
    from .compilation import note_first_call
    from .memory import attribute_call

    rec._seen = True
    n0, h0, m0, s0 = loads
    n1, h1, m1, s1 = _load_marks()
    loaded = n1 != n0
    rec.compile_seconds = dt if loaded else None
    if m1 != m0:
        rec.cache_status = "miss"
    elif h1 != h0:
        rec.cache_status = "hit"
        rec.cache_load_seconds = round(s1 - s0, 6)
    rec.collective_bytes_per_call = frame.collective_bytes
    if frame.cost_error is not None:
        rec.cost_source = f"error:{frame.cost_error}"
    elif frame.launches:
        rec.est_bytes = float(frame.bytes)
        rec.est_flops = float(frame.flops)
        rec.est_seconds = float(frame.seconds)
        rec.cost_source = "kernels"
    else:
        rec.cost_source = "none"
    try:
        attribute_call(rec, args, kwargs, out, frame.scratch,
                       sorted(frame.launches))
    except Exception as exc:  # attribution never raises into the loop
        rec.mem_source = f"unavailable:{type(exc).__name__}"
    note_first_call(rec)


def _account(rec: ExecutableRecord, frame: _Frame) -> None:
    reg = _pkg.get_registry()
    d = rec.digest
    rec.calls += 1
    calls = reg.counter(f"dispatch.{d}.calls")
    calls.inc()
    if frame.collective_bytes:
        reg.counter(f"dispatch.{d}.collective_bytes").inc(
            frame.collective_bytes)
    for name, n in frame.launches.items():
        rec.kernels[name] = rec.kernels.get(name, 0) + n
        reg.counter(f"dispatch.{d}.launches.{name}").inc(n)
    if rec.est_seconds is not None:
        reg.gauge(f"dispatch.{d}.est_seconds").set(rec.est_seconds)
        reg.gauge(f"dispatch.{d}.device_seconds_total").set(
            calls.value * rec.est_seconds)
    if rec.est_bytes is not None:
        reg.gauge(f"dispatch.{d}.est_bytes").set(rec.est_bytes)
        reg.gauge(f"dispatch.{d}.device_bytes_total").set(
            calls.value * rec.est_bytes)
    if rec.est_flops is not None:
        reg.gauge(f"dispatch.{d}.est_flops").set(rec.est_flops)
    reg.gauge(f"dispatch.{d}.wall_seconds_total").set(rec.wall_seconds)
    w = _pkg.get_writer()
    if w is not None and rec.announced_to != id(w):
        # once per run stream: the digest -> label mapping consumers
        # (merge / trace / roofline) join dispatch.* and mem.* against
        rec.announced_to = id(w)
        w.emit(
            "dispatch_executable",
            digest=d,
            label=rec.label,
            signature=rec.signature[:400],
            collective_bytes_per_call=rec.collective_bytes_per_call,
            est_flops=rec.est_flops,
            est_bytes=rec.est_bytes,
            est_seconds=rec.est_seconds,
            cost_source=rec.cost_source,
            compile_seconds=rec.compile_seconds,
            compile_ordinal=rec.compile_ordinal,
            mem_peak_bytes=(rec.mem_bytes or {}).get("peak_bytes"),
            mem_source=rec.mem_source,
            in_shardings=None,
            out_shardings=None,
            cache=rec.cache_status,
            cache_load_seconds=rec.cache_load_seconds,
            kernels=dict(frame.launches),
        )


def _load_marks() -> tuple:
    """Library loads so far: (all, cache hits, cache misses, hit seconds)."""
    return (_library_loads, _cache_loads["hit"], _cache_loads["miss"],
            _cache_hit_seconds)


def _call_recorded(label: str, fn, args, kwargs):
    signature = _signature(args, kwargs)
    digest = _digest(label, signature)
    rec = _records.get(digest)
    if rec is None:
        with _lock:
            rec = _records.get(digest)
            if rec is None:
                rec = _records[digest] = ExecutableRecord(digest, label,
                                                          signature)
    first = not rec._seen
    frame = _Frame()
    stack = _stack()
    stack.append(frame)
    loads = _load_marks()
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t0
        stack.pop()
    rec.wall_seconds += dt
    if first:
        _first_call(rec, frame, args, kwargs, out, dt, loads)
    _tls.last_record = rec
    _account(rec, frame)
    return out


# -- public wrapper ----------------------------------------------------------
def instrument(label: str, fn: Callable) -> Callable:
    """Wrap a call site's callable with dispatch attribution.

    Disabled telemetry costs one bool check; attribution never raises
    into the loop it observes.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not _pkg._enabled:
            return fn(*args, **kwargs)
        return _call_recorded(label, fn, args, kwargs)

    wrapped.__wrapped__ = fn
    wrapped.dispatch_label = label
    return wrapped
