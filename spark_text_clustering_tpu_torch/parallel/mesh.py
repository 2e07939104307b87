"""The (data, model) process grid: the port's form of the JAX package's
device mesh.

The JAX package shards every estimator over a ``("data", "model")``
mesh: documents over "data", the term-topic table [k, V] over the
vocabulary on "model".  One JAX process drives all its local devices.
The port runs one process per rank instead, each on one device:

  * rank ``r = d * model_shards + m`` has grid coordinates ``(d, m)``;
  * its "data" group is the column of ranks sharing ``m`` (a reduction
    over documents), its "model" group the row of ranks sharing ``d`` (a
    reduction over vocabulary shards).

A 1x1 grid needs no process group: every single-device path stays as it
is.  Larger grids need ``torch.distributed`` started first, either by
``initialize_distributed`` (one command per rank, JAX's
``--coordinator`` bring-up) or by ``run_grid``, which spawns the ranks of
a grid on this host.  ``backend`` is explicit: ``"nccl"`` by default for
CUDA devices, ``"gloo"`` for the CPU.  NCCL refuses two ranks on one
card, so a grid with more ranks than visible cards needs
``backend="gloo"``; gloo reduces CUDA tensors too, through the host.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import multiprocessing
import os
import pickle
import shutil
import signal
import sys
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from .. import telemetry
from ..device import resolve_device
from ..resilience import retry

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "ProcessGrid",
    "agree_checkpoint_exists",
    "check_backend",
    "default_backend",
    "initialize_distributed",
    "is_coordinator",
    "make_grid",
    "run_grid",
]

DATA_AXIS = "data"
MODEL_AXIS = "model"

# How long a rank waits in a collective before torch.distributed gives up
_TIMEOUT_S = 1800.0
# How long run_grid lets the other ranks run on once one has failed
_GRACE_S = 10.0
# prctl(2): deliver a signal to this process when its parent ends
_PR_SET_PDEATHSIG = 1


class ProcessGrid:
    """This process's place in a ``data_shards x model_shards`` grid: its
    rank, coordinates ``(d, m)``, device, and the two process groups its
    collectives reduce over (None where that axis has one rank).

    ``timed`` makes every collective synchronize the device around its
    ``all_reduce`` and add its host seconds, calls and bytes to
    ``stats``: what share of a sweep the collectives take."""

    def __init__(self, data_shards: int, model_shards: int, rank: int,
                 device: torch.device, data_group=None,
                 model_group=None) -> None:
        self.data_shards = data_shards
        self.model_shards = model_shards
        self.rank = rank
        self.device = device
        self.data_group = data_group
        self.model_group = model_group
        self.timed = False
        self.stats = {"calls": 0, "seconds": 0.0, "bytes": 0}

    @property
    def size(self) -> int:
        return self.data_shards * self.model_shards

    @property
    def d(self) -> int:
        return self.rank // self.model_shards

    @property
    def m(self) -> int:
        return self.rank % self.model_shards

    def __repr__(self) -> str:
        return (f"ProcessGrid({self.data_shards}x{self.model_shards}, "
                f"rank={self.rank}, device={self.device})")


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(backend: str, device, ranks: int) -> str:
    """``backend`` when it can run ``ranks`` ranks on ``device`` on one
    host, else ``ValueError`` saying what to pass instead."""
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (use 'nccl'|'gloo')")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend='nccl' reduces CUDA tensors only; "
                             "use backend='gloo' on the CPU")
        cards = torch.cuda.device_count()
        if ranks > cards:
            raise ValueError(
                f"backend='nccl' takes one rank a card, and {ranks} ranks "
                f"share {cards} visible card(s); use backend='gloo'")
    return backend


def _rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:(rank mod cards)`` for CUDA."""
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device("cuda")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return resolve_device(dev)


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
) -> None:
    """Join a grid of ``num_processes`` ranks as rank ``process_id``.

    ``coordinator_address`` is ``host:port`` of rank 0
    (``tcp://host:port``) or a ``tcp://`` / ``file://`` URL.  No-op
    without a coordinator; partial arguments are an error, not a silent
    no-op: N processes started with only ``num_processes``/``process_id``
    would each train a model of their own."""
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "num_processes/process_id require coordinator_address "
                "(pass --coordinator host:port on every process)")
        return
    if num_processes is None or process_id is None:
        raise ValueError(
            "coordinator_address requires num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    backend = check_backend(backend or default_backend(device), device,
                             num_processes)
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=_TIMEOUT_S))


def make_grid(
    data_shards: Optional[int] = None,
    model_shards: int = 1,
    backend: Optional[str] = None,
    device="cuda",
) -> ProcessGrid:
    """This process's ``ProcessGrid`` (JAX's ``make_mesh``).

    ``data_shards=None`` takes every rank of the started world (one
    without ``torch.distributed``).  The grid takes the whole world:
    exactly ``data_shards * model_shards`` ranks, each calling this in
    the same order, as ``new_group`` requires."""
    world = dist.get_world_size() if _distributed() else 1
    if model_shards < 1 or (data_shards is not None and data_shards < 1):
        raise ValueError(f"grid {data_shards}x{model_shards}: shards >= 1")
    if data_shards is None:
        if world % model_shards:
            raise ValueError(f"{world} ranks not divisible by "
                             f"model_shards={model_shards}")
        data_shards = world // model_shards
    size = data_shards * model_shards
    if size != world:
        raise ValueError(
            f"grid {data_shards}x{model_shards} needs {size} ranks, and "
            f"{world} are started (initialize_distributed, or run_grid)")
    rank = dist.get_rank() if _distributed() else 0
    if backend is None:
        backend = dist.get_backend() if _distributed() else (
            default_backend(device))
    dev = _rank_device(device, rank)
    if size == 1:
        return ProcessGrid(1, 1, rank, dev)
    check_backend(backend, dev, size)
    data_group = model_group = None
    # every rank creates every group, columns first, in one order
    for m in range(model_shards):
        ranks = [d * model_shards + m for d in range(data_shards)]
        group = dist.new_group(ranks, backend=backend) if (
            data_shards > 1) else None
        if rank in ranks:
            data_group = group
    for d in range(data_shards):
        ranks = [d * model_shards + m for m in range(model_shards)]
        group = dist.new_group(ranks, backend=backend) if (
            model_shards > 1) else None
        if rank in ranks:
            model_group = group
    return ProcessGrid(data_shards, model_shards, rank, dev, data_group,
                       model_group)


def is_coordinator() -> bool:
    """True on the rank that owns driver-side effects (model save, report
    writes): rank 0, and every process outside a grid."""
    return not _distributed() or dist.get_rank() == 0


def agree_checkpoint_exists(path: Optional[str]) -> bool:
    """Whether a fit should resume from ``path``, agreed across ranks.

    "Exists" means a valid resume point (a checksum sidecar that disagrees
    with the file reads as absent).  Checkpoints are written by the
    coordinator only, so a grid resumes from ONE shared filesystem; ranks
    that disagree would take different branches and issue mismatched
    collectives, so the coordinator's view is broadcast and a dissenting
    rank raises."""
    if not path:
        return False
    from ..models.persistence import train_state_valid

    if _distributed() and dist.get_world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        coordinator = dist.get_rank() == 0
        flag = torch.tensor([int(coordinator and train_state_valid(path))],
                            dtype=torch.int32, device=dev)
        dist.broadcast(flag, src=0)
        coord = bool(int(flag.item()))
        # the other ranks look after the broadcast: a checkpoint the
        # coordinator wrote before it got here is then in place for them
        exists = coord if coordinator else train_state_valid(path)
        _note_rejected(path, exists)
        if coord != exists:
            raise RuntimeError(
                f"checkpoint {path}: exists={exists} on rank "
                f"{dist.get_rank()} but {coord} on the coordinator; "
                "checkpoint_dir must be a filesystem every rank sees")
        return coord
    exists = train_state_valid(path)
    _note_rejected(path, exists)
    return exists


def _note_rejected(path: str, valid: bool) -> None:
    """Count a checkpoint file this rank found but could not resume
    from."""
    if not valid and os.path.exists(path):
        telemetry.count("resilience.checkpoints_rejected")
        telemetry.event("checkpoint_rejected", path=path)


def agree_ledger_epoch(ledger_dir: Optional[str]) -> int:
    """Last committed epoch of a stream checkpoint dir's commit ledger,
    agreed across ranks (-1 without a ledger dir).  The coordinator owns
    the ledger append, so its view is broadcast, and a rank that reads
    another epoch from its own filesystem raises instead of resuming from
    another transaction point (``agree_checkpoint_exists``, one level up
    the protocol).  Outside a started grid it is the local
    ``last_committed()``."""
    if not ledger_dir:
        return -1
    from ..resilience.ledger import EpochLedger

    local = EpochLedger(ledger_dir).last_committed()
    if _distributed() and dist.get_world_size() > 1:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        epoch = torch.tensor([local], dtype=torch.int64, device=dev)
        dist.broadcast(epoch, src=0)
        coord = int(epoch.item())
        if coord != local:
            raise RuntimeError(
                f"epoch ledger {ledger_dir}: rank {dist.get_rank()} reads "
                f"last committed epoch {local} but the coordinator reads "
                f"{coord}; checkpoint_dir must be one filesystem every "
                "rank sees")
        return coord
    return local


# ---- spawning a grid on this host -----------------------------------------
def _die_with_parent(parent: int) -> None:
    """End this process when ``parent`` (the process that spawned it)
    ends, however it ends: the kernel's parent-death signal (Linux
    ``prctl(PR_SET_PDEATHSIG, SIGKILL)``), else a thread that watches
    ``os.getppid()``.  A rank whose parent was SIGKILLed would otherwise
    block in a collective for good, holding its CUDA context."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        armed = libc.prctl(_PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) == 0
    except (OSError, AttributeError):
        armed = False
    if not armed:
        def watch() -> None:
            while os.getppid() == parent:
                retry.sleep(0.5)
            os._exit(1)

        threading.Thread(target=watch, daemon=True).start()
    if os.getppid() != parent:
        os._exit(1)          # the parent ended before the signal was armed


def _rank_main(fn, args, data_shards, model_shards, rank, init, backend,
               device, tmp, parent) -> None:
    """One spawned rank: bound to its parent's life, its output into files
    under ``tmp``, the world joined through the ``file://`` rendezvous,
    ``fn(grid, *args)`` run, its result and kernel launches pickled for
    the parent."""
    from ..ops import _build

    _die_with_parent(parent)
    world = data_shards * model_shards
    sys.stdout = open(os.path.join(tmp, f"out_{rank}"), "w", buffering=1)
    sys.stderr = open(os.path.join(tmp, f"err_{rank}"), "w", buffering=1)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    initialize_distributed(init, world, rank, backend=backend,
                           device=device)
    try:
        grid = make_grid(data_shards, model_shards, backend, device)
        result = fn(grid, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result_{rank}"), "wb") as f:
        pickle.dump((result, dict(_build.LAUNCHES)), f)


@contextlib.contextmanager
def _forwarded(signals: Sequence[int], proc):
    """Inside the block, each of ``signals`` this process receives is
    passed on to ``proc`` instead (where this is the main thread, the
    only one that may set handlers)."""
    if threading.current_thread() is not threading.main_thread():
        signals = ()

    def forward(signum, frame) -> None:
        with contextlib.suppress(ProcessLookupError, TypeError):
            os.kill(proc.pid, signum)

    previous = {sig: signal.signal(sig, forward) for sig in signals}
    try:
        yield
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def run_grid(
    fn: Callable,
    data_shards: int,
    model_shards: int,
    args: Sequence = (),
    *,
    backend: Optional[str] = None,
    device="cuda",
    timeout: Optional[float] = 3600.0,
    grace: float = _GRACE_S,
    forward_signals: Sequence[int] = (),
) -> List:
    """Run ``fn(grid, *args)`` on every rank of a ``data_shards x
    model_shards`` grid of processes spawned on this host; returns the
    ranks' results in rank order.

    Ranks start with the ``spawn`` method (CUDA does not survive a fork)
    and meet at a ``file://`` rendezvous in a temporary directory; rank
    ``r`` runs on ``cuda:(r mod cards)``, or on the CPU with this host's
    cores split between the ranks.  Build the CUDA kernels before calling
    (``_build.build_all``): the ranks load them.  Rank 0's standard
    output, and every rank's standard error, are printed here once the
    ranks end.  The kernel launches each rank made are added to this
    process's counts (``_build.LAUNCHES``).

    A rank that fails leaves the others blocked in a collective: once one
    fails, the rest get ``grace`` seconds (ten by default), then are
    killed, as is every rank still running after ``timeout`` seconds
    (None: no limit, for a stream).  Any failure raises ``RuntimeError``
    naming the ranks and their exit codes.  Every rank ends when this
    process ends, even by SIGKILL, so none is left blocked behind it.
    ``forward_signals`` (say ``(signal.SIGTERM,)``) are passed on to rank
    0 while the ranks run, instead of ending this process: a stream's
    preemption notice reaches the rank that polls its source."""
    from ..ops import _build

    world = data_shards * model_shards
    backend = check_backend(backend or default_backend(device), device,
                             world)
    tmp = tempfile.mkdtemp(prefix="stc_grid_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(
            fn, tuple(args), data_shards, model_shards, r, init, backend,
            str(device), tmp, os.getpid()))
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        failed_at = None
        with _forwarded(forward_signals, procs[0]):
            while any(p.is_alive() for p in procs):
                now = time.monotonic()
                if failed_at is None and any(
                        p.exitcode not in (None, 0) for p in procs):
                    failed_at = now
                if (deadline is not None and now > deadline) or (
                        failed_at is not None and now > failed_at + grace):
                    break
                procs[0].join(0.05)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        for r in range(world):
            for name, stream in (("out", sys.stdout), ("err", sys.stderr)):
                path = os.path.join(tmp, f"{name}_{r}")
                if (name == "err" or r == 0) and os.path.exists(path):
                    with open(path) as f:
                        text = f.read()
                    if text:
                        stream.write(text)
                        stream.flush()
        bad = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode}
        if bad:
            raise RuntimeError(
                f"grid {data_shards}x{model_shards}: ranks {sorted(bad)} "
                f"ended with exit codes {bad} (negative: killed after "
                "another rank failed or the timeout)")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}"), "rb") as f:
                result, launches = pickle.load(f)
            results.append(result)
            for name, count in launches.items():
                _build.LAUNCHES[name] += count
        return results
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.kill()
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
