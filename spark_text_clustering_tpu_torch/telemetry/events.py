"""Versioned JSONL event stream + run manifest.

One run -> one ``.jsonl`` file whose FIRST record is a **manifest**
(schema version, run id, config hash, backend, mesh shape, vocab width,
git rev) and whose remaining records are flat events::

    {"event": "manifest", "schema": 1, "run_id": "...", ...}
    {"ts": 1700000000.1, "event": "train_iteration", "optimizer": "em",
     "iteration": 3, "seconds": 0.21}

The manifest-first invariant is load-bearing for the ``metrics`` CLI
(summarize/diff/check key off it), so the writer BUFFERS events emitted
before ``write_manifest`` and flushes them after it — call sites don't
have to sequence their setup around when the vocab width becomes known.

I/O failure policy (the old ``MetricsLogger`` silently lost records):
every failed write increments the ``telemetry_write_errors`` counter on
the process registry and the FIRST failure warns once — training is
never aborted for a telemetry disk error, but the loss is visible.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
import warnings
from typing import Dict, List, Optional

from . import transport
from .registry import MetricRegistry

__all__ = [
    "SCHEMA_VERSION",
    "JsonlSink",
    "TelemetryWriter",
    "read_events",
    "manifest_fields",
    "git_rev",
    "process_info",
    "per_process_path",
    "backend_fields",
]

SCHEMA_VERSION = 1

WRITE_ERRORS_COUNTER = "telemetry_write_errors"


class JsonlSink:
    """Append-only JSONL file with surfaced (never raised) I/O errors.

    Shared by ``TelemetryWriter`` and the legacy ``MetricsLogger`` shim so
    the error-surfacing policy lives in exactly one place.
    """

    def __init__(
        self,
        path: Optional[str],
        *,
        registry: Optional[MetricRegistry] = None,
        truncate: bool = True,
    ) -> None:
        self.path = path
        self._registry = registry
        self._warned = False
        if path:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                if truncate:
                    # one run, one file
                    with open(path, "w", encoding="utf-8"):
                        pass
            except OSError as exc:
                self._surface(exc)

    def _surface(self, exc: OSError) -> None:
        if self._registry is None:
            # late import: default registry lives in the package facade
            from . import get_registry

            self._registry = get_registry()
        self._registry.counter(WRITE_ERRORS_COUNTER).inc()
        if not self._warned:
            self._warned = True
            warnings.warn(
                f"telemetry sink {self.path!r} is failing "
                f"({exc!r}); records are being dropped (counted in "
                f"{WRITE_ERRORS_COUNTER}) — this warning prints once",
                RuntimeWarning,
                stacklevel=3,
            )

    def write(self, rec: Dict) -> bool:
        """Append one record; False (and a surfaced error) on failure.

        Transient I/O errors get one quick retry (resilience
        TELEMETRY_POLICY — telemetry must never stall the training loop
        it observes); exhausted retries surface as before."""
        if not self.path:
            return False
        # lazy import: resilience.retry counts into THIS package's
        # registry, so the import edge must stay one-way at module level
        from ..resilience import TELEMETRY_POLICY, RetryGiveUp, faultinject
        from ..resilience import retry_call

        def _append() -> None:
            faultinject.check("telemetry.write")
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")

        try:
            retry_call(_append, site="telemetry.write",
                       policy=TELEMETRY_POLICY)
            ok = True
        except RetryGiveUp as exc:
            last = exc.last
            self._surface(
                last if isinstance(last, OSError) else OSError(last)
            )
            ok = False
        except (TypeError, ValueError) as exc:
            # unserializable field — drop the record, keep the run
            # alive, count the loss
            self._surface(OSError(exc))
            return False
        # transport hook: a configured shipper also gets the record —
        # deliberately even when the LOCAL append failed, so a full
        # local disk does not blind the collector too
        transport.offer(rec)
        return ok


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort short git revision of the running tree."""
    try:
        r = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
        )
        return r.stdout.strip() or None if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, ValueError):
        # no git binary / not a checkout / timeout — the manifest simply
        # records no revision
        return None


def process_info() -> Dict:
    """``{"process_index": i, "process_count": n}``: this process's rank
    and the world size of ``torch.distributed`` once it is initialized,
    else rank 0 of 1.  Each rank of a grid is one process and writes a
    stream of its own; a single process is rank 0 of 1, as the JAX
    package's one process is.  Reading it never initializes anything."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return {
                "process_index": int(dist.get_rank()),
                "process_count": int(dist.get_world_size()),
            }
    except (RuntimeError, ValueError, AttributeError):
        pass
    return {"process_index": 0, "process_count": 1}


def per_process_path(path: str) -> str:
    """The run-stream name of this process: ``<stem>-p<rank><ext>`` on a
    grid of more than one rank (a rank opening another's file would
    truncate its records), the caller's path verbatim for one process."""
    info = process_info()
    if info["process_count"] <= 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}-p{info['process_index']}{ext or '.jsonl'}"


def manifest_fields(
    params=None,
    mesh=None,
    vocab_width: Optional[int] = None,
    device=None,
    **extra,
) -> Dict:
    """Standard manifest payload from live objects.

    ``params``: a ``config.Params`` (hashed canonically via its JSON
    form, as the JAX package hashes its own).  ``mesh``: a
    ``parallel.ProcessGrid`` (``{"data": D, "model": M}``), or a dict of
    axis sizes.  ``device``: the run's torch device, which names the
    ``backend`` as JAX names its backends (``"gpu"`` for CUDA, ``"cpu"``)
    and sets ``device_count``; it is not itself a manifest field.
    """
    import platform

    out: Dict = {
        "host": platform.node(),
        "git_rev": git_rev(),
    }
    # process dimension: which rank of a grid wrote this stream
    # (`metrics merge` folds N such streams into one logical run)
    out.update(process_info())
    if params is not None:
        cfg = json.loads(params.to_json())
        out["config"] = cfg
        out["config_hash"] = hashlib.sha1(
            json.dumps(cfg, sort_keys=True).encode()
        ).hexdigest()[:12]
        out["algorithm"] = cfg.get("algorithm")
    if mesh is not None:
        shape = mesh if isinstance(mesh, dict) else {
            "data": getattr(mesh, "data_shards", None),
            "model": getattr(mesh, "model_shards", None),
        }
        try:
            out["mesh_shape"] = {str(k): int(v) for k, v in shape.items()}
        except (TypeError, ValueError, AttributeError):
            # grid-like object without its shard counts: skip the field
            pass
    if vocab_width is not None:
        out["vocab_width"] = int(vocab_width)
    if device is not None:
        out.update(backend_fields(device))
    out.update(extra)
    return out


def backend_fields(device) -> Dict:
    """``backend`` and ``device_count`` of a run on ``device``, in JAX's
    words: ``"gpu"`` and the visible cards for CUDA, ``"cpu"`` and 1
    otherwise; a CUDA run also names its card (``device_kind``, which
    ``metrics roofline`` picks its peaks by)."""
    import torch

    if torch.device(device).type == "cuda":
        return {"backend": "gpu", "device_count": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(device)}
    return {"backend": "cpu", "device_count": 1}


class TelemetryWriter:
    """Run-scoped event writer: manifest first, then the event stream.

    ``emit`` before ``write_manifest`` buffers; ``close`` with no
    manifest writes a minimal auto-manifest so the invariant holds for
    consumers either way.
    """

    def __init__(
        self,
        path: str,
        *,
        registry: Optional[MetricRegistry] = None,
        run_id: Optional[str] = None,
    ) -> None:
        self.run_id = run_id or (
            time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            + f"-{os.getpid()}"
        )
        self._sink = JsonlSink(path, registry=registry)
        self._registry = registry
        self._pending: List[Dict] = []
        self._manifest_written = False
        self.path = path

    def write_manifest(self, **fields) -> None:
        rec = {
            "event": "manifest",
            "schema": SCHEMA_VERSION,
            "run_id": self.run_id,
            "ts": time.time(),
        }
        rec.update(fields)
        self._sink.write(rec)
        self._manifest_written = True
        pending, self._pending = self._pending, []
        for p in pending:
            self._sink.write(p)

    def emit(self, event: str, /, **fields) -> None:
        rec = {"ts": time.time(), "event": event}
        rec.update(fields)
        if not self._manifest_written:
            self._pending.append(rec)
            return
        self._sink.write(rec)

    def close(self) -> None:
        """Flush; emit a final registry snapshot when a registry is
        attached (the ``registry`` event the CLI's diff/check read
        counters from)."""
        if not self._manifest_written:
            self.write_manifest(auto=True)
        if self._registry is not None:
            # the snapshot carries the process dimension so a merged
            # view can attribute every counter to its writer even when
            # streams are renamed/concatenated downstream
            self._sink.write({
                "ts": time.time(),
                "event": "registry",
                "snapshot": self._registry.snapshot(),
                **process_info(),
            })


def read_events(path: str) -> List[Dict]:
    """Parse a telemetry JSONL file; tolerates trailing partial lines
    (a live run being summarized mid-write)."""
    out: List[Dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out
