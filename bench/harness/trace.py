"""The traced run's readings: the program's own trace of the whole window,
and a device trace of a bounded part of it.

At the window's open the tracer gives the engine a ``TraceRecorder`` (the
program's lifecycle and phase spans: prefill dispatches with their bucket,
each request's prefill chunks, decode dispatches), so that the work of every
dispatch can be counted. ``profile_s`` seconds in the middle of the window
run under ``torch.profiler`` (CPU and CUDA activity), started and stopped
at engine-step boundaries after a device synchronize, so that the kernels of
exactly those steps fall inside. The device trace is kept in memory as
(name, start, end) of every device operation, never written out.

A ``record_function`` mark stamped on the benchmark's clock ties the
profiler's time base to the loop's, so an idle gap of the device can be
named by the engine phase the host was in.

Profiling slows what it profiles, and stopping the profiler takes the host
a while: the metrics that read the whole window leave out the profiled
stretch, from just before the profiler starts to just after its events are
read (``excluded``, with the program's counters at both ends). The
profiler is started and stopped once before the loop, so that loading its
library does not fall inside the window.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from repro_torch.serving.observability import TraceRecorder

#: events the program's recorder may hold over a window
RECORDER_CAPACITY = 1 << 21


def _ns(ev, what: str) -> int:
    """An event's start or duration in ns, across PyTorch versions."""
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")()
                                                * 1000)


@dataclasses.dataclass
class DeviceTrace:
    """Device operations of the profiled interval, on the loop's clock."""

    t0: float                  # interval start and end (loop clock)
    t1: float
    ops: List[Tuple[str, float, float]]   # (name, start, end)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, clipped to the window."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the window (no device operation running)."""
        out, t = [], self.t0
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = b
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the operations whose name holds ``fragment``."""
        return sum(b - a for n, a, b in self.ops if fragment in n)

    def kernel_count(self, fragment: str) -> int:
        return sum(fragment in n for n, _, _ in self.ops)


class Tracer:
    """The hooks of a traced run's loop (see ``loops/closed.py``)."""

    def __init__(self, engine, seconds: float, profile_s: float, counters,
                 clock=time.perf_counter):
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.seconds = seconds
        self.profile_s = min(profile_s, seconds)
        self.counters = counters
        self.clock = clock
        self.recorder = TraceRecorder(RECORDER_CAPACITY)
        self.prof: Optional[profile] = None
        self.p_start = self.p0 = self.p1 = None
        self.device: Optional[DeviceTrace] = None
        #: (start, end, counters at start, counters at end) of the stretch
        #: the profiler took
        self.excluded: Optional[tuple] = None
        self._x0 = None
        self._mark_t = 0.0
        prof = profile(activities=self._activities())
        prof.start()
        torch.zeros(1, device=engine.device).add_(1)
        self._sync()
        prof.stop()

    def _activities(self):
        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])

    def _mark(self) -> None:
        """A profiler event stamped on the loop's clock."""
        self._mark_t = self.clock()
        with record_function("bench_mark"):
            pass

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _start(self) -> None:
        self._sync()
        self._x0 = (self.clock(), self.counters())
        self.prof = profile(activities=self._activities())
        self.prof.start()
        torch.zeros(1, device=self.engine.device).add_(1)
        self._sync()   # the device's tracing is live before the first step
        self._mark()
        self.p0 = self.clock()

    def _stop(self) -> None:
        self._sync()
        self.p1 = self.clock()
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        mark = [e for e in events if e.name() == "bench_mark"]
        if not mark:
            raise RuntimeError("the profiler recorded no mark: its time base "
                               "cannot be tied to the loop's")
        off = _ns(mark[0], "start") / 1e9 - self._mark_t
        ops = []
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            a = _ns(e, "start") / 1e9 - off
            ops.append((e.name(), a, a + _ns(e, "duration") / 1e9))
        self.device = DeviceTrace(self.p0, self.p1, ops)
        self.prof = None
        self.excluded = (self._x0[0], self.clock(), self._x0[1],
                         self.counters())

    def __call__(self, event: str, t: float) -> None:
        if event == "open":
            self.engine.obs.trace = self.recorder
            self.p_start = t + (self.seconds - self.profile_s) / 2
        elif event == "step":
            if self.p0 is None and t >= self.p_start:
                self._start()
            elif self.prof is not None and t >= self.p0 + self.profile_s:
                self._stop()
        elif event == "close":
            if self.prof is not None:
                self._stop()
            self.engine.obs.trace = None
