"""Layer 2: the trace audit of the registered entry points (the JAX
package's jaxpr audit, read for torch; the module keeps its name so that
waivers and reports read as JAX's do).

Each entry point in ``analysis.entrypoints.ENTRYPOINTS`` is built at its
tiny representative shapes on the CPU, and the "trace" is one eager call
of ``fn(*args)`` under two modes: a ``TorchDispatchMode`` that sees every
aten op with its input and output tensors, and a ``TorchFunctionMode``
for the tensor methods that reach no aten op (``Tensor.numpy``,
``Tensor.tolist``, ``Tensor.cpu``).  With ``enable_x64=True`` (the
production mode) the call runs under ``torch.set_default_dtype(
torch.float64)``, JAX's x64 flag read for torch: code that spells its
dtypes traces the same either way, code that leans on the float32
default leaks float64, and ``torch.from_numpy`` of a float64 array leaks
in both modes (on the card a silent 2x memory and bandwidth cost).

Rules (STC2xx; same waiver machinery as layer 1, baseline ``path`` is
``jaxpr:<entry name>``):

  STC200  the builder or the call raised, or the audit made a CUDA
          context (it runs on the CPU only, as JAX's pins its platform)
  STC201  a float64/complex128 tensor among a recorded op's inputs or
          outputs (once per op name)
  STC202  an output leaf that is a Python scalar or a numpy value rather
          than a tensor: its dtype is the consumer's choice (torch's
          wrapped-number promotion), the counterpart of a weak type
  STC203  a host read inside the entry: ``aten._local_scalar_dense``
          (``.item()``, ``bool()``, ``float()``, ``int()`` of a tensor),
          ``Tensor.numpy`` / ``tolist`` / ``cpu`` — once per (read, call
          site); reads inside ``telemetry.device_sync`` are exempt
  STC204  a tensor over 1 MiB read by an op that is neither an argument
          leaf nor a recorded op's output: a captured constant
  STC205  a ``multichip`` entry that issued no collective through
          ``parallel.collectives`` (counted whether telemetry is on or off)

The audit moves nothing to a device and builds no kernel library: the
kernel wrappers take their plain versions on CPU tensors, so the audit
covers each wrapper and its plain version, and ``chip_smoke.py`` covers
the kernels.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Iterable, List, Sequence, Tuple

from .findings import Finding

__all__ = ["audit_entry", "run_jaxpr_audit", "CONST_BUDGET_BYTES"]

CONST_BUDGET_BYTES = 1 << 20  # 1 MiB

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__))
# the tensor methods that read a tensor into host memory without an aten op
_HOST_METHODS = ("numpy", "tolist", "cpu")


def _leaves(tree) -> Iterable:
    """Every leaf of nested tuples, lists, dicts and dataclasses."""
    if isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _leaves(item)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    else:
        yield tree


def _tensors(tree) -> List:
    import torch

    return [x for x in _leaves(tree) if isinstance(x, torch.Tensor)]


def _storage(t) -> int:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def _call_site() -> str:
    """The innermost frame of the package outside this audit:
    ``<package>/<module>.py:<function>``."""
    frame = sys._getframe(2)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if path.startswith(_PACKAGE_DIR) and not path.startswith(
                _ANALYSIS_DIR):
            rel = os.path.relpath(path, os.path.dirname(_PACKAGE_DIR))
            return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


def _modes(path: str, findings: List[Finding], arg_ptrs: set):
    """The (function mode, dispatch mode) pair that records one call."""
    import torch
    from torch.overrides import TorchFunctionMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..telemetry import in_device_sync

    wide = (torch.float64, torch.complex128)
    local_scalar = torch.ops.aten._local_scalar_dense.default
    state = {"ops": 0, "seen_ops": set(), "reads": set(), "consts": set(),
             "known": set(arg_ptrs)}

    def host_read(what: str) -> None:
        if in_device_sync():
            return
        site = _call_site()
        if (what, site) in state["reads"]:
            return
        state["reads"].add((what, site))
        findings.append(Finding(
            rule="STC203", path=path, line=0,
            message=(
                f"host read {what} inside the entry at {site} — on the "
                f"card a wait for the device on every call"
            ),
            snippet=f"{what} @ {site}",
        ))

    class Functions(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in _HOST_METHODS and args and isinstance(
                    args[0], torch.Tensor):
                host_read(f"Tensor.{name}")
            return func(*args, **(kwargs or {}))

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            ins = _tensors((args, kwargs))
            if func is local_scalar:
                host_read("aten._local_scalar_dense")
            for t in ins:
                ptr = _storage(t)
                nbytes = t.numel() * t.element_size()
                if (nbytes > CONST_BUDGET_BYTES and ptr
                        and ptr not in state["known"]
                        and ptr not in state["consts"]):
                    state["consts"].add(ptr)
                    findings.append(Finding(
                        rule="STC204", path=path, line=0,
                        message=(
                            f"captured tensor of {nbytes} bytes read by "
                            f"{func} at {_call_site()} — pass it as an "
                            f"argument instead of capturing it"
                        ),
                        snippet=f"const {t.dtype} {nbytes}B",
                    ))
            out = func(*args, **kwargs)
            outs = _tensors(out)
            state["ops"] += 1
            for t in outs:
                state["known"].add(_storage(t))
            name = str(func)
            if name not in state["seen_ops"]:
                for t in outs + ins:
                    if t.dtype in wide:
                        state["seen_ops"].add(name)
                        findings.append(Finding(
                            rule="STC201", path=path, line=0,
                            message=(
                                f"{t.dtype} tensor at op {name!r} "
                                f"({_call_site()}) — an implicit dtype is "
                                f"leaning on the float32 default, or a "
                                f"float64 array came in; spell the dtype"
                            ),
                            snippet=f"{name} -> {t.dtype}{list(t.shape)}",
                        ))
                        break
            return out

    return Functions(), Ops(), state


def audit_entry(
    name: str,
    fn,
    args: Sequence,
    *,
    multichip: bool = False,
    enable_x64: bool = True,
) -> Tuple[List[Finding], int]:
    """Call ``fn(*args)`` once under the recording modes and run the
    STC2xx checks.  Returns (findings, recorded aten op count).

    ``enable_x64=True`` is the production mode (float64 default dtype
    for the call, restored after it, also when it raises)."""
    import numpy as np
    import torch

    from ..parallel.collectives import count_collectives

    findings: List[Finding] = []
    path = f"jaxpr:{name}"
    cuda_before = torch.cuda.is_initialized()
    arg_ptrs = {_storage(t) for t in _tensors(args)}
    fmode, dmode, state = _modes(path, findings, arg_ptrs)
    default = torch.get_default_dtype()
    try:
        if enable_x64:
            torch.set_default_dtype(torch.float64)
        with count_collectives() as collectives, fmode, dmode:
            out = fn(*args)
    finally:
        torch.set_default_dtype(default)

    # ---- STC200: the audit must never touch the card ------------------
    if torch.cuda.is_initialized() and not cuda_before:
        findings.append(Finding(
            rule="STC200", path=path, line=0,
            message="the entry made a CUDA context: the audit runs on the "
                    "CPU only",
            snippet="torch.cuda initialized",
        ))

    # ---- STC202: host-typed outputs -----------------------------------
    for i, leaf in enumerate(_leaves(out)):
        if isinstance(leaf, (bool, int, float, np.generic, np.ndarray)):
            findings.append(Finding(
                rule="STC202", path=path, line=0,
                message=(
                    f"output {i} is a {type(leaf).__name__}, not a tensor "
                    f"— its dtype is left to the consumer's promotion; "
                    f"return a tensor of an explicit dtype"
                ),
                snippet=f"out[{i}] {type(leaf).__name__}",
            ))

    # ---- STC205: multichip entries must issue a collective ------------
    if multichip and not collectives:
        findings.append(Finding(
            rule="STC205", path=path, line=0,
            message=(
                "entry point is registered multichip=True but issued no "
                "collective through parallel.collectives — on a grid it "
                "would silently run unreduced"
            ),
            snippet="no collective",
        ))
    return findings, state["ops"]


def run_jaxpr_audit(entries=None) -> Tuple[List[Finding], List[str]]:
    """Audit every registered entry point (or an explicit subset).

    Returns (findings, audited entry names).  A builder or call crash is
    itself a finding (rule STC200) rather than an exception: a broken
    registration must fail lint, not the linter."""
    import torch

    from .entrypoints import ENTRYPOINTS

    if entries is None:
        entries = ENTRYPOINTS
    findings: List[Finding] = []
    audited: List[str] = []
    for ep in entries:
        cuda_before = torch.cuda.is_initialized()
        try:
            fn, args = ep.build()
            if torch.cuda.is_initialized() and not cuda_before:
                raise RuntimeError("the builder made a CUDA context")
            f, _ = audit_entry(ep.name, fn, args, multichip=ep.multichip)
        except Exception as exc:
            # a broken registration must FAIL LINT (as a finding), not
            # kill the linter mid-report; the error rides in the message
            findings.append(Finding(
                rule="STC200", path=f"jaxpr:{ep.name}", line=0,
                message=(
                    f"entry point failed to build/trace: "
                    f"{type(exc).__name__}: {exc}"
                ),
            ))
            continue
        findings.extend(f)
        audited.append(ep.name)
    return findings, audited
