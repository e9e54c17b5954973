"""Preemption handling: SIGTERM → checkpoint-at-next-step-boundary (a copy
of the reference's ``repro.runtime.preempt``).

Cloud fleets deliver SIGTERM with a grace window before eviction.
The guard flips an event; the train loop checks it once per step and performs
a final checkpoint + clean exit, so a preempted worker loses at most one step.
"""

from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._event = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.getsignal(s)
            try:
                signal.signal(s, self._handler)
            except ValueError:  # non-main thread (tests): poll-only mode
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self._prev.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass
        return False

    def _handler(self, signum, frame):
        self._event.set()

    def request(self):
        """Programmatic preemption request (used by tests)."""
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)
