"""ctypes bindings for the port's native text library (``native/
textproc.cpp``, the port's own copy of the JAX package's C++ front end).

The library is built with ``g++`` on first use, never at import, into
``build/torch_kernels/`` at the repository root, named by a hash of its
three sources and the compiler flags (as ``ops/_build.py`` names the CUDA
libraries): an edited source rebuilds, an unchanged one loads.  Each build
writes a temporary file of its own and ``os.replace``-s it into place, so
processes that build at the same time never load a half-written library.

``preprocess_document_native`` emits the same tokens as
``textproc.preprocess_document``.  ctypes releases the GIL for the whole
call, so ``preprocess_documents`` spreads documents over a thread pool and
scales across host cores.

``load()`` raises where the build fails (no ``g++``), naming the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = [
    "build",
    "finish",
    "lemma_native",
    "lib_path",
    "load",
    "native_available",
    "preprocess_document_native",
    "preprocess_documents",
    "start",
    "stem_native",
]

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("textproc.cpp", "unicode_tables.h", "nnp_suffix_table.h")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _digest() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where the library for the current sources lives."""
    from ..ops import _build

    return _build.BUILD_DIR / f"textproc_{_digest()}.so"


def start():
    """Start ``g++`` for the library; returns (process, tmp path), or None
    when the library for these sources is already built."""
    path = lib_path()
    if path.exists():
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC_DIR / "textproc.cpp")]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not start: {exc}") from exc
    return proc, tmp


def finish(started, timeout: float = 600.0) -> None:
    """Wait for a build from ``start`` and move it into place."""
    if started is None:
        return
    proc, tmp = started
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        os.unlink(tmp)
        raise RuntimeError(f"g++ took over {timeout:.0f} s for textproc.cpp")
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for textproc.cpp:\n{out}")
    os.replace(tmp, lib_path())


def build() -> float:
    """Build the library unless it is built; returns the seconds it took
    (0.0 when it was already there).  Raises ``RuntimeError`` on failure."""
    from ..ops import _build

    t0 = time.perf_counter()
    if lib_path().exists():
        return 0.0
    with _build.build_lock():
        started = start()
        finish(started)
    return time.perf_counter() - t0 if started else 0.0


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            build()
            lib = ctypes.CDLL(str(lib_path()))
        except (RuntimeError, OSError) as exc:
            _error = str(exc)
            return None
        lib.stc_preprocess.restype = ctypes.c_void_p
        lib.stc_preprocess.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.stc_stem.restype = ctypes.c_void_p
        lib.stc_stem.argtypes = [ctypes.c_char_p]
        lib.stc_lemma.restype = ctypes.c_void_p
        lib.stc_lemma.argtypes = [ctypes.c_char_p]
        lib.stc_free.argtypes = [ctypes.c_void_p]
        lib.stc_abi_version.restype = ctypes.c_int
        if lib.stc_abi_version() != ABI_VERSION:
            _error = f"library ABI {lib.stc_abi_version()} != {ABI_VERSION}"
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library builds (if missing) and loads here."""
    return _load() is not None


def load() -> ctypes.CDLL:
    """The loaded library; raises ``RuntimeError`` naming why it is not
    there (the build's error, or a wrong ABI)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native text library unavailable: {_error}")
    return lib


def _take_string(lib: ctypes.CDLL, ptr: int) -> str:
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.stc_free(ptr)


def preprocess_document_native(
    text: str,
    stop_words: frozenset = frozenset(),
    lemmatize: bool = True,
    min_lemma_len_exclusive: int = 3,
    dedup_within_sentence: bool = True,
    fold_case: bool = True,
) -> List[str]:
    """Native twin of ``textproc.preprocess_document`` (same signature,
    same tokens)."""
    lib = load()
    raw = text.encode("utf-8")
    sw = "\n".join(sorted(stop_words)).encode("utf-8")
    out_len = ctypes.c_long()
    ptr = lib.stc_preprocess(
        raw,
        len(raw),  # explicit length: embedded NUL bytes must not truncate
        sw,
        1 if lemmatize else 0,
        min_lemma_len_exclusive,
        1 if dedup_within_sentence else 0,
        1 if fold_case else 0,
        ctypes.byref(out_len),
    )
    try:
        joined = ctypes.string_at(ptr, out_len.value).decode("utf-8")
    finally:
        lib.stc_free(ptr)
    return joined.split("\n") if joined else []


def preprocess_documents(
    texts: Sequence[str],
    stop_words: frozenset = frozenset(),
    lemmatize: bool = True,
    min_lemma_len_exclusive: int = 3,
    dedup_within_sentence: bool = True,
    fold_case: bool = True,
    max_workers: Optional[int] = None,
) -> List[List[str]]:
    """Preprocess a corpus in parallel across host cores (ctypes releases
    the GIL, so threads give true parallelism); ``max_workers`` threads,
    by default one a core up to 32."""
    load()
    if max_workers is None:
        max_workers = min(32, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(
            pool.map(
                lambda t: preprocess_document_native(
                    t,
                    stop_words=stop_words,
                    lemmatize=lemmatize,
                    min_lemma_len_exclusive=min_lemma_len_exclusive,
                    dedup_within_sentence=dedup_within_sentence,
                    fold_case=fold_case,
                ),
                texts,
            )
        )


def stem_native(token: str) -> str:
    lib = load()
    return _take_string(lib, lib.stc_stem(token.encode("utf-8")))


def lemma_native(word: str) -> str:
    lib = load()
    return _take_string(lib, lib.stc_lemma(word.encode("utf-8")))
