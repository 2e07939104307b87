"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/torch_kernels/`` at the
repository root, named by a hash of every source under ``csrc/`` and of
the compiler flags: an edited source rebuilds, an unchanged one loads.
``build_all`` starts one ``nvcc`` per source, all at once.  Builds hold
an exclusive lock on ``BUILD_DIR/.build.lock`` (``build_lock``), so ranks
of a grid that load the kernels at once build each library once, and
the others wait for it.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``.  Wrappers allocate outputs
and scratch with ``torch.empty``; a temporary freed after a launch is
safe, because PyTorch's caching allocator reuses memory in stream order.

Nothing here runs at import time; the CPU tests import every module
without a compiler.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from ..telemetry import dispatch as _dispatch

__all__ = ["SOURCES", "BUILD_DIR", "KernelError", "build_all", "build_lock",
           "count_launch", "host_counts", "library_bytes", "load_library",
           "nbytes"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("estep", "emscatter", "emsweep", "packed", "nmf", "segments")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C interface of each library: {function: argtypes}; every function
# returns an int (a CUDA error code, or the queried value).
SIGNATURES = {
    "estep": {
        "stc_gamma_fixed_point_bkl": [_P] * 4 + [_I] * 6 + [_F, _P, _P],
        "stc_estep_max_k": [],
        "stc_estep_max_tile_b": [],
    },
    "emscatter": {
        "stc_scatter_add_vtiles": [_P] * 3 + [_I] * 7 + [_P] * 4,
    },
    "emsweep": {
        "stc_em_sweep_fused": [_P] * 10 + [_I] * 9 + [_F] + [_P] * 6,
    },
    "packed": {
        "stc_gamma_fixed_point_tiles": [_P] * 5 + [_I] * 6 + [_F] + [_P] * 3,
        "stc_tiles_smem_bytes": [_I] * 4,
        "stc_tiles_scratch_floats": [_I] * 4,
    },
    "nmf": {
        "stc_nmf_mu_update_tiles": [_P] * 5 + [_I] * 5 + [_F] + [_P] * 4,
        "stc_nmf_smem_bytes": [_I] * 4,
        "stc_nmf_scratch_floats": [_I] * 4,
        "stc_nmf_blocks_per_sm": [_I] * 4,
    },
    "segments": {
        "stc_topic_inference_segments": [_P] * 5 + [_I] * 6 + [_F] + [_P] * 3,
        "stc_segments_max_k": [],
        "stc_segments_max_cluster": [],
        "stc_segments_piece_tokens": [_I],
        "stc_segments_smem_limit": [],
        "stc_segments_smem_budget": [],
        "stc_segments_smem_bytes": [_I] * 4,
        "stc_segments_stage_pieces": [_I] * 4,
        "stc_segments_scratch_floats": [_I] * 5,
        "stc_segments_active_clusters": [_I] * 4,
    },
}


class KernelError(RuntimeError):
    """A CUDA kernel of the port failed to build or to launch: a fault of
    the card or the toolchain, never of the data (a streaming scorer lets
    it through instead of quarantining the documents)."""


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}_{_digest()}.so"


@contextlib.contextmanager
def build_lock():
    """Hold the build directory's lock (across processes) in the block."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp .so, log)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all() -> Dict[str, float]:
    """Build every source not yet built, all ``nvcc`` runs in parallel.
    Returns {name: seconds from the start until its build finished} (0.0
    for a library already built) and keeps the compiler's register and
    shared-memory report in ``<lib>.log``."""
    t0 = time.perf_counter()
    secs = {n: 0.0 for n in SOURCES}
    with build_lock():
        started = {
            n: _start(n) for n in SOURCES if not _lib_path(n).exists()
        }
        for n, (proc, tmp) in started.items():
            log = _finish(n, proc, tmp)
            _lib_path(n).with_suffix(".log").write_text(log)
            secs[n] = time.perf_counter() - t0
    return secs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing.  A
    load (and a build before it) is the port's compile: the dispatch
    layer charges the call it falls in with it."""
    lib = _LIBS.get(name)
    if lib is None:
        _dispatch.note_library_load()
        if not _lib_path(name).exists():
            with build_lock():
                if not _lib_path(name).exists():
                    proc, tmp = _start(name)
                    _finish(name, proc, tmp)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")


# Kernel launches per wrapper: each wrapper adds one where it launches
# its kernel and nowhere else, so a run can show it went through them.
LAUNCHES: Dict[str, int] = {
    "gamma_fixed_point_bkl": 0,
    "scatter_add_vtiles": 0,
    "em_sweep_fused": 0,
    "gamma_fixed_point_tiles": 0,
    "nmf_mu_update_tiles": 0,
    "topic_inference_segments": 0,
}


# The source (and so the library) of each kernel
KERNEL_SOURCES = {
    "gamma_fixed_point_bkl": "estep",
    "scatter_add_vtiles": "emscatter",
    "em_sweep_fused": "emsweep",
    "gamma_fixed_point_tiles": "packed",
    "nmf_mu_update_tiles": "nmf",
    "topic_inference_segments": "segments",
}


def count_launch(name: str,
                 cost: Optional[Callable[[], Tuple[float, float]]] = None,
                 scratch: int = 0) -> None:
    """One launch of kernel ``name``.  ``cost`` gives the launch's (bytes,
    flops), its module's ``cost()`` on its inputs, and ``scratch`` the
    bytes of the scratch its wrapper allocated: the dispatch layer
    charges them to the instrumented call the launch falls in, and asks
    for ``cost`` only then (telemetry enabled)."""
    LAUNCHES[name] += 1
    if _dispatch.recording():
        _dispatch.note_launch(name, cost, scratch)


def library_bytes(kernel: str) -> Optional[int]:
    """Size of the loaded library that holds ``kernel``; None where it is
    not loaded in this process."""
    source = KERNEL_SOURCES[kernel]
    if source not in _LIBS:
        return None
    try:
        return os.path.getsize(_lib_path(source))
    except OSError:
        return None


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def host_counts(x, n: int, default: int):
    """``x`` (a tensor, array or sequence: a cost's live counts or
    iterations) as n float64 counts on the host, or ``default`` for each
    where ``x`` is None."""
    import numpy as np

    if x is None:
        return np.full(n, float(default))
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64).reshape(-1)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check_tensors(name: str, *tensors) -> None:
    """The checks every wrapper makes before a launch: each tensor on the
    card, contiguous, and float32 or int32 as the kernel reads it."""
    import torch

    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name}: dtype {t.dtype} is not f32/i32")
