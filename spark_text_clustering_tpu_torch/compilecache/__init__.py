"""Persistent compile cache: the port's kernel libraries, stored once and
loaded by every later process.

The port's one compile is ``ops._build``'s: ``nvcc`` turns each
``csrc/<name>.cu`` into a shared library.  Every respawned supervisor
worker, every new ``serve`` replica and every cold ``score`` / ``train``
in a fresh checkout would pay those builds again.  This package is a
content-addressed on-disk store of the built libraries, keyed by (the
toolchain's fingerprint, the library's name, the digest of the sources
and flags it was built from), so a second process loads a committed
``.so`` instead of running ``nvcc``.

Activation is the JAX package's: the ``STC_COMPILE_CACHE`` environment
variable names the store root and is read lazily once, so supervised
workers, serve replicas and the ranks of a grid inherit the cache with
no plumbing; ``configure()`` arms or disarms it explicitly (the CLI's
``--compile-cache`` flag, tests).  With nothing armed, a library load
makes one module-global check and goes on as before.

The consumers:

* ``ops._build.load_library`` consults the store before it builds, and
  publishes what it built (or found in its build directory);
* ``ServeScorer.warmup()`` reports its hit/miss/store deltas;
* the CLI's ``compile-cache`` verb gives ``warm`` / ``ls`` / ``gc`` /
  ``verify``.

Imports neither torch nor jax.
"""

from __future__ import annotations

import os
from typing import Optional

from .store import CachedLibrary, ExecutableStore

__all__ = [
    "ENV_DIR",
    "CachedLibrary",
    "ExecutableStore",
    "configure",
    "reset",
    "active",
    "get_store",
]

ENV_DIR = "STC_COMPILE_CACHE"

_store: Optional[ExecutableStore] = None
_env_loaded = False


def _push_armed_state(active: Optional[bool]) -> None:
    # the library loader reads the armed state as one global: it is
    # pushed there, never queried per load
    from ..telemetry.dispatch import note_cache_config

    note_cache_config(active)


def configure(root: Optional[str]) -> Optional[ExecutableStore]:
    """Arm the cache at ``root`` (or with ``None`` disarm) for this
    process; explicit configuration wins over the environment."""
    global _store, _env_loaded
    _env_loaded = True
    _store = ExecutableStore(root) if root else None
    _push_armed_state(_store is not None)
    return _store


def reset() -> None:
    """Disarm; the next ``active()``/``get_store()`` re-reads the env."""
    global _store, _env_loaded
    _store = None
    _env_loaded = False
    _push_armed_state(None)


def _current() -> Optional[ExecutableStore]:
    global _store, _env_loaded
    if not _env_loaded:
        _env_loaded = True
        root = os.environ.get(ENV_DIR)
        if root:
            _store = ExecutableStore(root)
        _push_armed_state(_store is not None)
    return _store


def active() -> bool:
    return _current() is not None


def get_store() -> Optional[ExecutableStore]:
    return _current()
