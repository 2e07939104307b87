"""Deterministic, seed-driven fault injection, copied from the JAX package
so that one spec makes the same decisions in both packages.

Code calls ``check(site)`` at its injection points (and ``corrupt(site,
path)`` right after writing a file); with no spec armed both are a dict
lookup on an empty plan.  A plan is armed by ``configure`` or from the
environment::

    STC_FAULTS="ckpt.write:kill@2;stream.poll:ioerror@0.3"
    STC_FAULT_SEED=7

Spec grammar (semicolon-separated rules)::

    <site>:<kind>[@<arg>]

    ioerror[@p]   raise InjectedIOError on each hit with probability p
                  (default 1.0), drawn from a per-(seed, site, kind) RNG
    fail[@n]      raise InjectedIOError on the n-th hit only (default 1st)
    kill[@n]      os._exit(137) on the n-th hit: a real crash
    partial[@n]   on the n-th hit, ``corrupt()`` truncates the named file
                  to half its size (a torn write that survived)
    hang[@n]      on the n-th hit, block for an hour (through the
                  injectable ``retry.sleep``)
    slow[@s]      sleep ``s`` seconds (default 1.0) on every hit
"""

from __future__ import annotations

import os
import random
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = [
    "ENV_SEED",
    "ENV_SPEC",
    "FaultPlan",
    "FaultRule",
    "InjectedIOError",
    "SITES",
    "active",
    "check",
    "configure",
    "corrupt",
    "reset",
]

ENV_SPEC = "STC_FAULTS"
ENV_SEED = "STC_FAULT_SEED"

KINDS = ("ioerror", "fail", "kill", "partial", "hang", "slow")

# Every injection point the port's code owns (the JAX package's names;
# tests/test_torch_ledger.py holds this set to the port's check/corrupt
# calls, both ways).
SITES = frozenset({
    "artifact.file",      # between files of a model artifact write
    "artifact.commit",    # before the COMMIT marker seals the dir
    "ckpt.write",         # train-state checkpoint write
    "stream.poll",        # streaming source directory poll
    "report.write",       # scoring report write
    "ledger.stage",       # before an epoch intent record is staged
    "ledger.commit",      # before the epoch ledger append (commit point)
    "supervisor.spawn",   # before the supervisor spawns a worker process
    "worker.heartbeat",   # before a worker's lease heartbeat write
    "worker.kill",        # before the supervisor's SIGKILL escalation
    "telemetry.write",    # telemetry run-stream append
    "telemetry.ship",     # before a shipper batch POSTs to the collector
    "collect.ingest",     # top of the collector's /ingest fold
    "serve.accept",       # before the scoring service accepts a request
    "serve.admit",        # inside the coalescer's bounded admission
                          # check (forces a typed 429, never a crash)
    "serve.batch",        # before a coalesced serve batch dispatches
    "serve.swap",         # before a verified model hot-swap installs
    "front.shed",         # the front's pending-set admission (forces a
                          # typed 429 shed at the edge)
    "monitor.poll",       # top of each alert-engine evaluation cycle
    "monitor.action",     # before the monitor's actions-file write
})


class InjectedIOError(OSError):
    """An injected transient I/O failure (an OSError, so retry filters
    treat it as the real thing)."""


@dataclass
class FaultRule:
    site: str
    kind: str                       # one of KINDS
    arg: float = 1.0                # probability (ioerror) or hit index
    hits: int = 0                   # hits observed so far
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def should_fire(self) -> bool:
        self.hits += 1
        if self.kind == "ioerror":
            return self._rng.random() < self.arg
        if self.kind == "slow":
            return True                 # every hit is late
        return self.hits == int(self.arg)


class FaultPlan:
    """Parsed, armed fault rules keyed by site."""

    def __init__(self, spec: str, seed: int = 0) -> None:
        self.spec = spec
        self.seed = seed
        self.rules: Dict[str, List[FaultRule]] = {}
        for part in filter(None, (p.strip() for p in spec.split(";"))):
            fields = part.split(":")
            if len(fields) != 2:
                raise ValueError(
                    f"bad fault rule {part!r} (want <site>:<kind>[@arg])"
                )
            site, action = fields
            kind, _, arg_s = action.partition("@")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {KINDS})"
                )
            arg = float(arg_s) if arg_s else 1.0
            rule = FaultRule(site=site, kind=kind, arg=arg)
            # per-(seed, site, kind) stream: exact replay, sites
            # decorrelated
            rule._rng = random.Random(
                (seed << 32) ^ zlib.crc32(f"{site}:{kind}".encode())
            )
            self.rules.setdefault(site, []).append(rule)


_plan: Optional[FaultPlan] = None
_env_loaded = False


def configure(spec: Optional[str], seed: int = 0) -> Optional[FaultPlan]:
    """Arm (or with ``None`` disarm) a fault plan for this process."""
    global _plan, _env_loaded
    _env_loaded = True              # explicit config wins over the env
    _plan = FaultPlan(spec, seed) if spec else None
    return _plan


def reset() -> None:
    """Disarm; the next ``check`` re-reads the environment."""
    global _plan, _env_loaded
    _plan = None
    _env_loaded = False


def _current() -> Optional[FaultPlan]:
    global _plan, _env_loaded
    if not _env_loaded:
        _env_loaded = True
        spec = os.environ.get(ENV_SPEC)
        if spec:
            _plan = FaultPlan(spec, int(os.environ.get(ENV_SEED, "0")))
    return _plan


def active() -> bool:
    return _current() is not None


def check(site: str) -> None:
    """Injection point: raise, sleep or kill here when an armed rule
    fires."""
    plan = _current()
    if plan is None:
        return
    for rule in plan.rules.get(site, ()):
        if rule.kind == "partial" or not rule.should_fire():
            continue
        if rule.kind == "kill":
            os._exit(137)           # no finally blocks, no atexit
        if rule.kind in ("hang", "slow"):
            from .retry import sleep

            sleep(3600.0 if rule.kind == "hang" else rule.arg)
            continue
        raise InjectedIOError(
            f"injected fault at {site} (hit {rule.hits}, "
            f"kind {rule.kind})"
        )


def corrupt(site: str, path: str) -> None:
    """Partial-write point: truncate ``path`` to half when armed."""
    plan = _current()
    if plan is None:
        return
    for rule in plan.rules.get(site, ()):
        if rule.kind == "partial" and rule.should_fire():
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(1, size // 2))
