"""The single injectable time source for the port's serving stack (a copy
of the reference's ``repro.runtime.clock``).

Every timestamp the engine takes flows through a :class:`Clock` instance
(or this module's :func:`now` / :func:`wall_now` helpers), never through a
raw ``time`` call, so ``repro_torch.serving.faults.VirtualClock`` can swap
deterministic time under a whole engine (deadlines, lifecycle timestamps)
without a single sleep.

Two concrete clocks:

* :class:`MonotonicClock` (module singleton :data:`MONOTONIC`) wraps
  ``time.perf_counter``; the default for latency (TTFT, queue wait). Its
  origin is arbitrary: only differences mean anything.
* :class:`WallClock` (module singleton :data:`WALL`) wraps ``time.time``;
  for timestamps that must compare across hosts (artifact manifests).

A clock is any zero-argument callable returning seconds as ``float``.
"""

from __future__ import annotations

import time

__all__ = ["Clock", "MonotonicClock", "WallClock", "MONOTONIC", "WALL",
           "now", "wall_now"]


class Clock:
    """Zero-arg callable returning seconds (float). Subclass or duck-type."""

    def __call__(self) -> float:  # pragma: no cover - abstract
        raise NotImplementedError


class MonotonicClock(Clock):
    """``time.perf_counter``: monotone, arbitrary origin, high resolution."""

    def __call__(self) -> float:
        return time.perf_counter()


class WallClock(Clock):
    """``time.time``: epoch seconds, comparable across hosts."""

    def __call__(self) -> float:
        return time.time()


MONOTONIC = MonotonicClock()
WALL = WallClock()


def now() -> float:
    """Monotonic seconds (the default latency clock)."""
    return MONOTONIC()


def wall_now() -> float:
    """Wall-clock epoch seconds (for cross-host timestamps)."""
    return WALL()
