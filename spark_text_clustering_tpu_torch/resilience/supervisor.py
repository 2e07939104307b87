"""Worker lifecycle of a stream: the SIGTERM drain notice.

The JAX package's ``resilience/supervisor.py`` also holds the supervised
worker fleet (leases, fence tokens, the file partition, the resize loop);
that part is ROADMAP queue 1 item 7b and grows into this file there.
"""

from __future__ import annotations

import signal

__all__ = ["PreemptionNotice"]


class PreemptionNotice:
    """SIGTERM drain flag (a preemption notice): the handler only sets a
    flag, and the streaming loop finishes its in-flight trigger, commits
    or rolls back through the ledger, and stops.  ``install()`` replaces
    the process's SIGTERM handler; ``uninstall()`` puts back the one it
    replaced."""

    def __init__(self) -> None:
        self.requested = False
        self._previous = None

    def install(self) -> "PreemptionNotice":
        self._previous = signal.signal(signal.SIGTERM, self._handle)
        return self

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None

    def _handle(self, signum, frame) -> None:
        self.requested = True

    def __call__(self) -> bool:
        return self.requested

    def __bool__(self) -> bool:
        return self.requested
