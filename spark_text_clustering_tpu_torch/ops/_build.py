"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/torch_kernels/`` at the
repository root, named by a hash of every source under ``csrc/``, the
compiler flags and the nvcc release (``_digest``): an edited source or
another toolchain rebuilds, an unchanged one loads.  ``build_all``
starts one ``nvcc`` per source, all at once.  Builds hold an exclusive
lock on ``BUILD_DIR/.build.lock`` (``build_lock``), so ranks of a grid
that load the kernels at once build each library once, and the others
wait for it.

With the compile cache armed (``compilecache``: ``STC_COMPILE_CACHE`` or
the CLI's ``--compile-cache``), ``load_library`` looks in its store
first: a hit loads the committed library and runs nothing of nvcc; a
miss takes the build directory's library (built if missing) and
publishes it to the store.  Unarmed, a load is what it always was.

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
import platform
import re
import shutil
import struct
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..telemetry import dispatch as _dispatch

__all__ = ["SOURCES", "BUILD_DIR", "KernelError", "build_all", "build_lock",
           "count_launch", "entry_digest", "host_counts", "library_bytes",
           "load_library", "nbytes", "nvcc_release", "publish_all",
           "toolchain_fingerprint"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("estep", "emscatter", "emsweep", "packed", "nmf", "segments")
TARGET = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={TARGET}", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# the file each loaded library was loaded from (the build directory's,
# or a compile-cache entry's payload)
_LIB_PATHS: Dict[str, Path] = {}
# `nvcc --version`'s release line, per nvcc path, asked once a process
_RELEASES: Dict[str, str] = {}

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


def nvcc_release() -> str:
    """The release line of ``nvcc --version`` ("Cuda compilation tools,
    release 12.4, V12.4.131"), asked once a process for each nvcc;
    raises ``KernelError`` without nvcc."""
    nvcc = _nvcc()
    release = _RELEASES.get(nvcc)
    if release is None:
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise KernelError(f"{nvcc} --version failed: {exc}") from exc
        release = next((ln.strip() for ln in out.splitlines()
                        if "release" in ln), "version unknown")
        _RELEASES[nvcc] = release
    return release


def _digest() -> str:
    """The hash that names the libraries: every source under ``csrc/``,
    the flags, and the nvcc release (without nvcc, none)."""
    try:
        release = nvcc_release()
    except KernelError:
        release = "nvcc missing"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(release.encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def toolchain_fingerprint() -> str:
    """The compile cache's key prefix: the nvcc release, the target, the
    flags and the host's machine, as ``nvcc12.4-sm_90a-x86_64-<hex12>``.
    Raises ``KernelError`` without nvcc."""
    release = nvcc_release()
    raw = "|".join((release, TARGET, " ".join(NVCC_FLAGS),
                    platform.machine()))
    m = re.search(r"release (\d+(?:\.\d+)*)", release)
    return (f"nvcc{m.group(1) if m else 'unknown'}-{TARGET}-"
            f"{platform.machine()}-"
            f"{hashlib.sha256(raw.encode()).hexdigest()[:12]}")


def entry_digest(name: str, signature: str) -> str:
    """A library's key in the compile cache: its name and the sources'
    digest, as the dispatch layer keys a label and its signature."""
    return hashlib.sha1(f"{name}|{signature}".encode()).hexdigest()[:10]


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


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Build every source of ``names`` not yet built, all ``nvcc`` runs in
    parallel.  Returns {name: seconds from the start until its build
    finished} (0.0 for a library already built) and keeps the compiler's
    register and shared-memory report in ``<lib>.log``."""
    t0 = time.perf_counter()
    secs = {n: 0.0 for n in names}
    if all(_lib_path(n).exists() for n in names):
        return secs
    with build_lock():
        started = {
            n: _start(n) for n in names if not _lib_path(n).exists()
        }
        for n, (proc, tmp) in started.items():
            log = _finish(n, proc, tmp)
            _lib_path(n).with_suffix(".log").write_text(log)
            secs[n] = time.perf_counter() - t0
    return secs


def _built(name: str) -> Tuple[Path, Optional[float]]:
    """The build directory's library for ``name``, built if missing;
    with the seconds its build took (None where it was already built)."""
    path = _lib_path(name)
    if path.exists():
        return path, None
    t0 = time.perf_counter()
    with build_lock():
        if not path.exists():
            proc, tmp = _start(name)
            _finish(name, proc, tmp)
            return path, time.perf_counter() - t0
    return path, None


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check_elf(path: str) -> None:
    """Raise ``OSError`` unless ``path`` holds a whole ELF64 file: every
    segment and the section table inside its size.  ``dlopen`` of a file
    cut short can fault on a page past its end instead of failing."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(64)
        if len(head) < 64 or head[:5] != b"\x7fELF\x02":
            raise OSError(f"{path}: not an ELF64 file")
        phoff, shoff = struct.unpack_from("<QQ", head, 32)
        phentsize, phnum, shentsize, shnum = struct.unpack_from(
            "<HHHH", head, 54)
        end = max(phoff + phentsize * phnum, shoff + shentsize * shnum)
        if end <= size:
            f.seek(phoff)
            table = f.read(phentsize * phnum)
            for i in range(phnum):
                offset, = struct.unpack_from("<Q", table, i * phentsize + 8)
                filesz, = struct.unpack_from("<Q", table, i * phentsize + 32)
                end = max(end, offset + filesz)
    if end > size:
        raise OSError(f"{path}: {size} bytes, its ELF headers need {end}")


def _load_cached(name: str) -> ctypes.CDLL:
    """Load ``name`` through the armed compile cache: a committed entry
    loads as it is; a miss (absent, stale, corrupt: the store quarantines
    what it cannot load) takes the build directory's library and
    publishes it."""
    from .. import compilecache

    store = compilecache.get_store()
    signature = _digest()
    digest = entry_digest(name, signature)

    def load(path: str) -> ctypes.CDLL:
        _check_elf(path)
        return _bind(name, ctypes.CDLL(path))

    hit = store.lookup(name, signature, digest, load=load)
    if hit is not None:
        _dispatch.note_library_load("hit", hit.load_seconds)
        _LIB_PATHS[name] = Path(hit.path)
        return hit.library
    path, secs = _built(name)
    store.store(name, signature, digest, str(path), compile_seconds=secs)
    _dispatch.note_library_load("miss")
    _LIB_PATHS[name] = path
    return _bind(name, ctypes.CDLL(str(path)))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing (or,
    with the compile cache armed, loaded from its store).  A load (and a
    build before it) is the port's compile: the dispatch layer charges
    the call it falls in with it."""
    lib = _LIBS.get(name)
    if lib is None:
        if _dispatch.cache_armed():
            lib = _load_cached(name)
        else:
            _dispatch.note_library_load()
            path, _ = _built(name)
            lib = _bind(name, ctypes.CDLL(str(path)))
            _LIB_PATHS[name] = path
        _LIBS[name] = lib
    return lib


def publish_all() -> None:
    """Every library through the armed compile cache (``compile-cache
    warm``): the ones neither the store nor the build directory holds
    are built first, all at once; then each loads, from the store or, on
    a miss, from the build directory, publishing it."""
    from .. import compilecache

    store = compilecache.get_store()
    signature = _digest()
    build_all([n for n in SOURCES
               if n not in _LIBS
               and not store.contains(entry_digest(n, signature))
               and not _lib_path(n).exists()])
    for n in SOURCES:
        load_library(n)


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
        return os.path.getsize(_LIB_PATHS[source])
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
