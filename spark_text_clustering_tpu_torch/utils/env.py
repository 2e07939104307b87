"""Hang-proof probes of the runtime environment (host side; neither torch
nor jax is imported here).

A card that is wedged, or a CUDA runtime that blocks while it comes up,
can hang the process that first asks for a CUDA context.  ``probe_accelerator``
therefore asks in a throwaway interpreter, under a timeout, so the caller
can only see a ``hang``, never hang itself: the port's counterpart of the
JAX package's ``utils/env.py`` probe, with its return dict, its history
rows, its retry schedule and its telemetry.  ``doctor`` rests on it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Mapping, Optional

__all__ = [
    "probe_accelerator",
    "scrubbed_cpu_env",
]

# The probe: a fresh interpreter imports torch and prints one line.  "b"
# is the platform torch would run on ("cuda" with a device, else "cpu"),
# "n" the devices it sees (the JAX package's three keys); the rest
# (``_DETAIL``) names device 0 and the gloo backend.
_PROBE_CODE = (
    "import json, torch; n = torch.cuda.device_count(); "
    "p = torch.cuda.get_device_properties(0) if n else None; "
    "d = torch.distributed; "
    "print('PROBE', json.dumps({'v': torch.__version__, "
    "'b': 'cuda' if n else 'cpu', 'n': n, 'cuda': torch.version.cuda, "
    "'name': p.name if p else None, "
    "'capability': [p.major, p.minor] if p else None, "
    "'gloo': d.is_available() and d.is_gloo_available()}))"
)
_DETAIL = ("cuda", "name", "capability", "gloo")


def scrubbed_cpu_env(base: Optional[Mapping[str, str]] = None) -> dict:
    """A copy of ``base`` (default ``os.environ``) in which torch sees no
    CUDA device: the environment of the port's CPU path (``--device cpu``,
    gloo), for subprocesses that must start whatever state the card is
    in."""
    env = dict(os.environ if base is None else base)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def probe_accelerator(
    attempts: int = 3,
    probe_timeout: int = 90,
    require_accelerator: bool = True,
    env: Optional[Mapping[str, str]] = None,
    verbose: bool = False,
) -> dict:
    """Can a FRESH interpreter import torch and see a CUDA device under
    ``env`` (default: the current environment)?

    Probed in a throwaway subprocess, so a wedged card can only time out,
    never hang the caller; this process makes no CUDA context.  Retries
    on the schedule of ``resilience.retry.backoff_delays`` (0, 10, 30, 30,
    ... seconds), waiting through its injectable ``sleep``.  With
    ``require_accelerator``, zero devices counts as failure
    (``cpu_fallback``).

    Returns the JAX package's ``{"ok", "backend", "version", "devices",
    "error", "history"}`` (``backend`` "cuda" or "cpu", ``version``
    torch's), plus, from a probe that answered, ``cuda`` (torch's CUDA
    version), ``name`` and ``capability`` of device 0 and ``gloo``
    (whether torch.distributed has its gloo backend).  ``history`` has one
    row an attempt: ``{"utc", "attempt", "elapsed_s", "outcome",
    "error_class", "error", "timeout_s"}``.  Each attempt is also a
    ``probe.accelerator`` span, a ``probe_attempt`` event and a
    ``probe.accelerator.<outcome>`` counter, the outcome one of ``ok``,
    ``hang``, ``init_error`` and ``cpu_fallback``.
    """
    from .. import telemetry
    from ..resilience.retry import RetryPolicy, backoff_delays
    from ..resilience.retry import sleep as _retry_sleep

    probe_policy = RetryPolicy(
        attempts=attempts, base_delay=10.0, multiplier=3.0,
        max_delay=30.0, jitter=0.0,
    )
    delays = list(backoff_delays(probe_policy, site="probe.accelerator"))
    last_err = ""
    history: list = []

    def _note(err_class: str, err: str, t0: float, attempt: int) -> None:
        elapsed = round(time.monotonic() - t0, 1)
        history.append({
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "attempt": attempt,
            "elapsed_s": elapsed,
            "outcome": err_class,
            "error_class": err_class,   # the JAX package's older name
            "error": err,
            "timeout_s": probe_timeout,
        })
        telemetry.count(f"probe.accelerator.{err_class}")
        telemetry.event(
            "probe_attempt", attempt=attempt, outcome=err_class,
            elapsed_s=elapsed, timeout_s=probe_timeout, error=err,
        )

    for i in range(attempts):
        _retry_sleep(delays[i])
        t0 = time.monotonic()
        with telemetry.span("probe.accelerator", emit=False):
            try:
                r = subprocess.run(
                    [sys.executable, "-c", _PROBE_CODE],
                    capture_output=True,
                    text=True,
                    timeout=probe_timeout,
                    env=None if env is None else dict(env),
                )
            except subprocess.TimeoutExpired:
                r = None
        if r is None:
            last_err = f"probe hung >{probe_timeout}s"
            _note("hang", last_err, t0, i)
        else:
            line = next(
                (ln for ln in r.stdout.splitlines()
                 if ln.startswith("PROBE ")),
                None,
            )
            if r.returncode == 0 and line:
                info = json.loads(line[len("PROBE "):])
                if require_accelerator and info["b"] == "cpu":
                    last_err = "torch sees no CUDA device"
                    _note("cpu_fallback", last_err, t0, i)
                else:
                    _note("ok", "", t0, i)
                    return {
                        "ok": True,
                        "backend": info["b"],
                        "version": info["v"],
                        "devices": info["n"],
                        "error": "",
                        "history": history,
                        **{k: info[k] for k in _DETAIL if k in info},
                    }
            else:
                tail = (
                    r.stderr.strip().splitlines()[-1]
                    if r.stderr.strip() else ""
                )
                last_err = f"rc={r.returncode} {tail}".strip()
                _note("init_error", last_err, t0, i)
        if verbose:
            sys.stderr.write(
                f"# accelerator probe attempt {i + 1}/{attempts}: "
                f"{last_err}\n"
            )
    return {"ok": False, "backend": None, "version": None,
            "devices": 0, "error": last_err, "history": history}
