"""Zero-perturbation serving observability: metrics registry + lifecycle
trace recorder (a copy of the reference's ``repro.serving.observability``,
its v1.3 contract: names, kinds, units, phases and trace events alike).

Two instruments, one clock:

* :class:`MetricsRegistry` — monotone counters, gauges, and fixed-bucket
  histograms under the **frozen** ``SERVING_METRICS`` name/unit schema
  (frozen the way ``api.FINISH_REASONS`` is: dashboards and the heartbeat
  digest depend on these names). Counters and gauges may be *polled*
  (registered with a zero-arg callable reading the engine's own
  bookkeeping ints), which is what makes ``engine.health()`` literally a
  read of the same counters the registry exports — one source of truth,
  two read surfaces. Snapshots export as a JSON dict (one line each in a
  JSONL stream) and as Prometheus text exposition.
* :class:`TraceRecorder` — a bounded ring buffer of span/instant events
  (oldest dropped first, drops counted) covering per-request lifecycle
  (submitted → queued → admitted → prefill chunks → first token → decode
  → retired, with finish_reason and slot/page annotations) and per-step
  engine phases (sweep, admit, prefill dispatch/sync, sample-collect,
  decode dispatch/sync, collect, page maintenance). Exports Chrome/
  Perfetto ``trace.json`` (load in ``ui.perfetto.dev`` or
  ``chrome://tracing``).

:class:`Observability` bundles both behind the engine's single injectable
clock (``repro_torch.runtime.clock``; ``faults.VirtualClock`` substitutes it
wholesale, making every timestamp — and therefore every span duration and
histogram observation — deterministic in tests).

The zero-perturbation contract: nothing in this module touches the device
or the engine's graph caches — all instrumentation is host-side
bookkeeping around (never inside) the captured dispatches, so tokens are
bit-identical with tracing on, off, or unconfigured, and no new
compile-cache axis exists. ``chip_smoke.py`` prints the traced and
untraced tok/s on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.runtime import clock as rtclock

__all__ = ["MetricSpec", "SERVING_METRICS", "PHASES",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "TraceRecorder", "Observability"]


# ---------------------------------------------------------------------------
# the frozen metric schema (v1.3)
# ---------------------------------------------------------------------------

#: engine-step phase names (trace span names on the engine track, and the
#: ``serving_phase_<name>_seconds_total`` counter suffixes). ``page_maint``
#: nests inside whichever phase triggered the page bookkeeping (admit,
#: prefill, or decode), so its seconds are also counted by its parent.
PHASES = ("sweep", "admit", "prefill_dispatch", "prefill_sync",
          "sample_collect", "decode_dispatch", "decode_sync", "collect",
          "page_maint")

#: default latency histogram bucket upper bounds, seconds
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One frozen registry entry: name, kind, unit, meaning."""

    name: str
    kind: str                    # "counter" | "gauge" | "histogram"
    unit: str                    # "1", "seconds", "tokens", "pages", ...
    help: str
    buckets: Optional[Tuple[float, ...]] = None  # histograms only
    paged_only: bool = False     # registered only under kv_layout="paged"


def _phase_specs() -> Tuple[MetricSpec, ...]:
    return tuple(
        MetricSpec(f"serving_phase_{p}_seconds_total", "counter", "seconds",
                   f"cumulative host seconds spent in the '{p}' step phase")
        for p in PHASES)


#: The frozen serving metric schema (v1.3 contract). Names and units are
#: stable the way FINISH_REASONS is: additions are allowed in later
#: contract versions, renames/removals are not.
SERVING_METRICS: Tuple[MetricSpec, ...] = (
    # ---- request lifecycle counters
    MetricSpec("serving_requests_submitted_total", "counter", "1",
               "submit() calls accepted into the engine (incl. sheds)"),
    MetricSpec("serving_requests_completed_total", "counter", "1",
               "requests finished with reason stop/length"),
    MetricSpec("serving_requests_cancelled_total", "counter", "1",
               "requests finished with reason cancelled"),
    MetricSpec("serving_requests_shed_total", "counter", "1",
               "requests rejected at submit by admission control"),
    MetricSpec("serving_requests_timeout_total", "counter", "1",
               "requests retired by the deadline sweep"),
    MetricSpec("serving_requests_error_total", "counter", "1",
               "requests retired by fault containment"),
    MetricSpec("serving_admits_total", "counter", "1",
               "requests admitted into a slot"),
    # ---- engine work counters
    MetricSpec("serving_engine_steps_total", "counter", "1",
               "step() calls"),
    MetricSpec("serving_decode_steps_total", "counter", "1",
               "fused decode steps dispatched (token positions per slot)"),
    MetricSpec("serving_prefill_dispatches_total", "counter", "1",
               "prefill dispatches (bucketed chunks or serial prompts)"),
    MetricSpec("serving_tokens_generated_total", "counter", "tokens",
               "tokens delivered to request outputs"),
    MetricSpec("serving_prefill_tokens_total", "counter", "tokens",
               "prompt tokens consumed by prefill dispatches"),
    MetricSpec("serving_trace_dropped_total", "counter", "1",
               "trace events dropped by the bounded ring buffer"),
    *_phase_specs(),
    # ---- fleet gauges
    MetricSpec("serving_queue_depth", "gauge", "1",
               "requests waiting for a slot"),
    MetricSpec("serving_resident_slots", "gauge", "1",
               "occupied slots"),
    MetricSpec("serving_free_slots", "gauge", "1",
               "admissible slots (excludes quarantined)"),
    MetricSpec("serving_quarantined_slots", "gauge", "1",
               "slots removed from the admission pool by containment"),
    MetricSpec("serving_resident_tokens", "gauge", "tokens",
               "committed tokens over queued + resident requests"),
    # ---- latency / throughput histograms
    MetricSpec("serving_ttft_seconds", "histogram", "seconds",
               "submit -> first generated token", LATENCY_BUCKETS),
    MetricSpec("serving_time_to_token_seconds", "histogram", "seconds",
               "per-request mean seconds per generated token after the "
               "first (observed at retirement)", LATENCY_BUCKETS),
    MetricSpec("serving_queue_wait_seconds", "histogram", "seconds",
               "submit -> admission into a slot", LATENCY_BUCKETS),
    MetricSpec("serving_step_seconds", "histogram", "seconds",
               "engine step() wall duration", LATENCY_BUCKETS),
    MetricSpec("serving_tokens_per_step", "histogram", "tokens",
               "tokens delivered per engine step", COUNT_BUCKETS),
    MetricSpec("serving_prefill_chunk_seconds", "histogram", "seconds",
               "prefill chunk dispatch+sync wall duration",
               LATENCY_BUCKETS),
    # ---- paged-KV pool (registered only for kv_layout="paged" engines)
    MetricSpec("serving_pages_alloc_total", "counter", "pages",
               "physical pages taken from the pool", paged_only=True),
    MetricSpec("serving_pages_release_total", "counter", "pages",
               "page references dropped", paged_only=True),
    MetricSpec("serving_page_forks_total", "counter", "pages",
               "copy-on-write forks", paged_only=True),
    MetricSpec("serving_prefix_hits_total", "counter", "pages",
               "prefix-cache pages reused", paged_only=True),
    MetricSpec("serving_prefix_misses_total", "counter", "1",
               "prefix lookups that ended cold", paged_only=True),
    MetricSpec("serving_prefix_evictions_total", "counter", "pages",
               "prefix-cache entries dropped under pressure",
               paged_only=True),
    MetricSpec("serving_pages_free", "gauge", "pages",
               "unowned physical pages", paged_only=True),
    MetricSpec("serving_pages_used", "gauge", "pages",
               "physical pages with ref > 0", paged_only=True),
    MetricSpec("serving_pages_shared", "gauge", "pages",
               "physical pages with ref > 1 (COW-protected)",
               paged_only=True),
    MetricSpec("serving_page_churn_pages", "histogram", "pages",
               "page alloc+release events per engine step", COUNT_BUCKETS,
               paged_only=True),
    # ---- supervised recovery (v1.5; registered by EngineSupervisor)
    MetricSpec("serving_engine_restarts_total", "counter", "1",
               "engine rebuilds performed by the supervisor"),
    MetricSpec("serving_requests_replayed_total", "counter", "1",
               "requests replayed onto a rebuilt engine"),
    MetricSpec("serving_engine_generation", "gauge", "1",
               "current engine generation id (0 = never restarted)"),
    MetricSpec("serving_degraded", "gauge", "1",
               "1 while the crash-loop breaker sheds new submits"),
    MetricSpec("serving_recovery_seconds", "histogram", "seconds",
               "engine death detected -> survivors requeued on the "
               "rebuilt engine", LATENCY_BUCKETS),
)

SPEC_BY_NAME: Dict[str, MetricSpec] = {s.name: s for s in SERVING_METRICS}


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotone push counter (int/float). Never decremented in operation;
    ``reset()`` exists for bench re-baselining only."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Push gauge: last value wins."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v: Union[int, float]) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram with an exact bounded sample window.

    Buckets (cumulative ``le`` counts, Prometheus semantics) plus ``sum``
    and ``count`` are monotone across snapshots. ``percentile(q)`` is
    computed from a bounded ring of the most recent raw observations
    (``window``; exact while ``count <= window``, a recent-window estimate
    after), which is what lets tests reconcile reported percentiles with
    trace span durations bit-for-bit under a virtual clock.
    """

    __slots__ = ("buckets", "bucket_counts", "sum", "count", "max",
                 "_samples")

    def __init__(self, buckets: Tuple[float, ...] = LATENCY_BUCKETS,
                 window: int = 4096):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(set(self.buckets)), \
            "bucket bounds must be strictly increasing"
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self._samples: deque = deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        self.max = max(self.max, v)
        self._samples.append(v)
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    def percentile(self, q: float) -> float:
        """q in [0, 100]; exact over the retained sample window (0.0 when
        empty)."""
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), q))

    def summary(self) -> Dict[str, Any]:
        cum, cumulative = 0, {}
        for b, c in zip(self.buckets, self.bucket_counts):
            cum += c
            cumulative[b] = cum
        return {
            "count": self.count, "sum": self.sum, "max": self.max,
            "p50": self.percentile(50), "p90": self.percentile(90),
            "p99": self.percentile(99), "buckets": cumulative,
        }


@dataclasses.dataclass
class _Entry:
    spec: MetricSpec
    instrument: Optional[Union[Counter, Gauge, Histogram]]
    poll: Optional[Callable[[], Union[int, float]]]


class MetricsRegistry:
    """Name → instrument table with polled-read support and two exporters.

    ``counter``/``gauge`` return a push instrument unless ``poll=`` is
    given, in which case snapshots evaluate the callable (the engine's own
    bookkeeping int stays the single source of truth). Histograms are
    always push. Registering a name from ``SERVING_METRICS`` checks the
    kind matches the frozen spec; unknown names are allowed (callers may
    extend) but must not collide.
    """

    def __init__(self):
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()

    # ---- registration -----------------------------------------------------
    def _spec(self, name: str, kind: str, unit: str, help_: str,
              buckets=None) -> MetricSpec:
        frozen = SPEC_BY_NAME.get(name)
        if frozen is not None:
            assert frozen.kind == kind, \
                (f"{name} is frozen as a {frozen.kind}, not a {kind} "
                 "(SERVING_METRICS names/kinds/units are the v1.3 contract)")
            return frozen
        return MetricSpec(name, kind, unit, help_,
                          tuple(buckets) if buckets else None)

    def _add(self, entry: _Entry) -> None:
        if entry.spec.name in self._entries:
            raise ValueError(f"metric {entry.spec.name!r} already registered")
        self._entries[entry.spec.name] = entry

    def counter(self, name: str, *, poll: Optional[Callable] = None,
                unit: str = "1", help: str = "") -> Optional[Counter]:
        spec = self._spec(name, "counter", unit, help)
        inst = None if poll is not None else Counter()
        self._add(_Entry(spec, inst, poll))
        return inst

    def gauge(self, name: str, *, poll: Optional[Callable] = None,
              unit: str = "1", help: str = "") -> Optional[Gauge]:
        spec = self._spec(name, "gauge", unit, help)
        inst = None if poll is not None else Gauge()
        self._add(_Entry(spec, inst, poll))
        return inst

    def histogram(self, name: str, *, buckets: Optional[Tuple] = None,
                  unit: str = "seconds", help: str = "") -> Histogram:
        spec = self._spec(name, "histogram", unit, help, buckets)
        inst = Histogram(spec.buckets or LATENCY_BUCKETS)
        self._add(_Entry(spec, inst, None))
        return inst

    # ---- reads ------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def names(self) -> List[str]:
        return list(self._entries)

    def spec(self, name: str) -> MetricSpec:
        return self._entries[name].spec

    def value(self, name: str) -> Union[int, float]:
        """Current scalar value of a counter or gauge (polled or push)."""
        e = self._entries[name]
        assert e.spec.kind != "histogram", f"{name} is a histogram"
        return e.poll() if e.poll is not None else e.instrument.value

    def get_histogram(self, name: str) -> Histogram:
        e = self._entries[name]
        assert e.spec.kind == "histogram", f"{name} is not a histogram"
        return e.instrument

    def counters(self) -> Dict[str, Union[int, float]]:
        """name → value for every counter (the monotonicity test surface)."""
        return {n: self.value(n) for n, e in self._entries.items()
                if e.spec.kind == "counter"}

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able observation of every metric: counters/gauges →
        number, histograms → ``Histogram.summary()`` dicts."""
        out: Dict[str, Any] = {}
        for n, e in self._entries.items():
            out[n] = (e.instrument.summary() if e.spec.kind == "histogram"
                      else self.value(n))
        return out

    # ---- exporters --------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (one frozen name per family)."""
        lines: List[str] = []
        for n, e in self._entries.items():
            s = e.spec
            if s.help:
                lines.append(f"# HELP {n} {s.help}")
            lines.append(f"# TYPE {n} {s.kind}")
            if s.kind != "histogram":
                v = self.value(n)
                lines.append(f"{n} {v:.9g}" if isinstance(v, float)
                             else f"{n} {v}")
                continue
            h: Histogram = e.instrument
            cum = 0
            for b, c in zip(h.buckets, h.bucket_counts):
                cum += c
                lines.append(f'{n}_bucket{{le="{b:.9g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum:.9g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"

    def jsonl_line(self, t: Optional[float] = None) -> str:
        """One snapshot as a single JSON line (append to a ``.jsonl``
        stream; ``t`` stamps the observation)."""
        snap = self.snapshot()
        if t is not None:
            snap = {"t": t, **snap}
        return json.dumps(snap, default=float, sort_keys=False)

    def summary_table(self) -> str:
        """Human-readable shutdown table: non-zero counters and gauges,
        then histogram count/p50/p90/p99/max."""
        rows: List[Tuple[str, str]] = []
        hist_rows: List[Tuple[str, str]] = []
        for n, e in self._entries.items():
            if e.spec.kind == "histogram":
                h: Histogram = e.instrument
                if h.count:
                    hist_rows.append(
                        (n, f"n={h.count} p50={h.percentile(50):.4g} "
                            f"p90={h.percentile(90):.4g} "
                            f"p99={h.percentile(99):.4g} max={h.max:.4g} "
                            f"[{e.spec.unit}]"))
            else:
                v = self.value(n)
                if v:
                    rows.append((n, f"{v:.6g}" if isinstance(v, float)
                                 else str(v)))
        if not rows and not hist_rows:
            return "(no observations)"
        width = max(len(n) for n, _ in rows + hist_rows)
        return "\n".join(f"{n:<{width}}  {v}" for n, v in rows + hist_rows)


# ---------------------------------------------------------------------------
# trace recorder
# ---------------------------------------------------------------------------

# Track = (process_name, thread_id): which timeline row an event lands on.
TRACK_ENGINE = ("engine", 0)
TRACK_BOOT = ("boot", 0)


def request_track(uid: int) -> Tuple[str, int]:
    return ("requests", uid)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    name: str
    cat: str
    ph: str            # "X" complete | "i" instant
    track: Tuple[str, int]
    ts: float          # seconds (clock domain of the recorder's owner)
    dur: float         # seconds (0 for instants)
    args: Optional[Dict[str, Any]] = None


class TraceRecorder:
    """Bounded ring buffer of :class:`TraceEvent`; oldest events drop first
    and ``dropped`` counts them, so a long-lived server's recorder is a
    flight recorder, never a leak. Purely host-side; O(1) per event."""

    def __init__(self, capacity: int = 65536):
        assert capacity >= 1
        self.capacity = int(capacity)
        self._events: deque = deque()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def _push(self, ev: TraceEvent) -> None:
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(ev)

    def complete(self, name: str, track: Tuple[str, int], t0: float,
                 t1: float, cat: str = "serving",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """A span [t0, t1] (Chrome "X" complete event)."""
        self._push(TraceEvent(name, cat, "X", track, t0,
                              max(t1 - t0, 0.0), args))

    def instant(self, name: str, track: Tuple[str, int], t: float,
                cat: str = "serving",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._push(TraceEvent(name, cat, "i", track, t, 0.0, args))

    def events(self) -> List[TraceEvent]:
        return list(self._events)

    # ---- export -----------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome Trace Event JSON object (Perfetto-loadable):
        ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with ``ts`` /
        ``dur`` in microseconds and process/thread metadata naming the
        tracks (engine / requests / boot; request tids are uids)."""
        pids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        seen_threads = set()
        for ev in self._events:
            pname, tid = ev.track
            pid = pids.setdefault(pname, len(pids) + 1)
            rec: Dict[str, Any] = {
                "name": ev.name, "cat": ev.cat, "ph": ev.ph,
                "pid": pid, "tid": tid, "ts": ev.ts * 1e6,
            }
            if ev.ph == "X":
                rec["dur"] = ev.dur * 1e6
            if ev.ph == "i":
                rec["s"] = "t"  # thread-scoped instant
            if ev.args:
                rec["args"] = ev.args
            events.append(rec)
            seen_threads.add((pname, tid))
        meta: List[Dict[str, Any]] = []
        for pname, pid in pids.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
        for pname, tid in sorted(seen_threads):
            tname = f"req {tid}" if pname == "requests" else pname
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": pids[pname], "tid": tid,
                         "args": {"name": tname}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped,
                              "format": "repro.serving v1.3"}}

    def write(self, path) -> None:
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.chrome_trace(), default=float))


# ---------------------------------------------------------------------------
# the bundle the engine carries
# ---------------------------------------------------------------------------

class Observability:
    """Registry + (optional) trace recorder behind one injectable clock.

    Construction is cheap and tracing is **off by default** — an engine
    always has a registry (counters/gauges poll its own bookkeeping ints;
    histograms observe at the points the engine already syncs), while the
    ring-buffer recorder only exists when asked for (``trace=True`` or a
    :class:`TraceRecorder`). The engine that adopts this bundle overwrites
    ``clock`` with its own single time source (a ``faults.VirtualClock``
    under an injector), so traces and metrics share the deadline domain.
    One Observability binds to at most one engine.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 trace: Union[bool, TraceRecorder, None] = None,
                 trace_capacity: int = 65536):
        self.clock: Callable[[], float] = clock or rtclock.MONOTONIC
        self.registry = MetricsRegistry()
        if trace is True:
            trace = TraceRecorder(trace_capacity)
        elif trace is False:
            trace = None
        # identity check, not truthiness: an *empty* TraceRecorder is
        # len() == 0 and must still count as tracing-on
        self.trace: Optional[TraceRecorder] = trace
        self.phase_seconds: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._engine = None
        # histogram shortcuts (None until bind_engine registers them)
        self.h_ttft = self.h_ttt = self.h_queue_wait = None
        self.h_step = self.h_tokens_step = self.h_prefill_chunk = None
        self.h_page_churn = None

    def now(self) -> float:
        return self.clock()

    # ---- span helpers -----------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, track: Tuple[str, int] = TRACK_ENGINE,
             cat: str = "phase", args: Optional[Dict[str, Any]] = None):
        """Time a host-side section: accumulates into the phase counter
        (when ``name`` is a known engine phase) and records a trace span
        (when tracing is on). Timestamps come from the bundle clock, so a
        VirtualClock yields exact, deterministic spans."""
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            if name in self.phase_seconds:
                self.phase_seconds[name] += t1 - t0
            if self.trace is not None:
                self.trace.complete(name, track, t0, t1, cat=cat, args=args)

    def instant(self, name: str, track: Tuple[str, int], t: float,
                args: Optional[Dict[str, Any]] = None) -> None:
        if self.trace is not None:
            self.trace.instant(name, track, t, args=args)

    # ---- engine wiring ----------------------------------------------------
    def bind_engine(self, engine) -> None:
        """Register the frozen serving metric set, polled from ``engine``'s
        own bookkeeping (and its :class:`~repro_torch.serving.paging.
        PageAllocator` under the paged layout). Called once by the engine
        constructor."""
        assert self._engine is None, \
            "an Observability binds to exactly one engine"
        self._engine = engine
        reg, e = self.registry, engine
        for name, fn in (
            ("serving_requests_submitted_total", lambda: e.submitted),
            ("serving_requests_completed_total", lambda: e.completed),
            ("serving_requests_cancelled_total", lambda: e.cancelled),
            ("serving_requests_shed_total", lambda: e.sheds),
            ("serving_requests_timeout_total", lambda: e.timeouts),
            ("serving_requests_error_total", lambda: e.errors),
            ("serving_admits_total", lambda: e.admits),
            ("serving_engine_steps_total", lambda: e.engine_steps),
            ("serving_decode_steps_total", lambda: e.steps),
            ("serving_prefill_dispatches_total", lambda: e.prefill_steps),
            ("serving_tokens_generated_total", lambda: e.tokens_generated),
            ("serving_prefill_tokens_total", lambda: e.prefill_tokens),
            ("serving_trace_dropped_total",
             lambda: self.trace.dropped if self.trace is not None else 0),
        ):
            reg.counter(name, poll=fn, unit=SPEC_BY_NAME[name].unit,
                        help=SPEC_BY_NAME[name].help)
        for p in PHASES:
            name = f"serving_phase_{p}_seconds_total"
            reg.counter(name, poll=(lambda p=p: self.phase_seconds[p]),
                        unit="seconds", help=SPEC_BY_NAME[name].help)
        for name, fn in (
            ("serving_queue_depth", lambda: len(e.queue)),
            ("serving_resident_slots",
             lambda: sum(1 for s in e.slots if s is not None)),
            ("serving_free_slots",
             lambda: (len(e.slots)
                      - sum(1 for s in e.slots if s is not None)
                      - len(e.quarantined))),
            ("serving_quarantined_slots", lambda: len(e.quarantined)),
            ("serving_resident_tokens", lambda: e.resident_tokens()),
        ):
            reg.gauge(name, poll=fn, unit=SPEC_BY_NAME[name].unit,
                      help=SPEC_BY_NAME[name].help)
        self.h_ttft = self._hist(reg, "serving_ttft_seconds")
        self.h_ttt = self._hist(reg, "serving_time_to_token_seconds")
        self.h_queue_wait = self._hist(reg, "serving_queue_wait_seconds")
        self.h_step = self._hist(reg, "serving_step_seconds")
        self.h_tokens_step = self._hist(reg, "serving_tokens_per_step")
        self.h_prefill_chunk = self._hist(reg,
                                          "serving_prefill_chunk_seconds")
        if getattr(e, "paged", False):
            a = e.alloc
            for name, fn in (
                ("serving_pages_alloc_total", lambda: a.allocs),
                ("serving_pages_release_total", lambda: a.releases),
                ("serving_page_forks_total", lambda: a.forks),
                ("serving_prefix_hits_total", lambda: a.hits),
                ("serving_prefix_misses_total", lambda: a.misses),
                ("serving_prefix_evictions_total", lambda: a.evictions),
            ):
                reg.counter(name, poll=fn, unit=SPEC_BY_NAME[name].unit,
                            help=SPEC_BY_NAME[name].help)
            for name, fn in (
                ("serving_pages_free", lambda: a.free_pages),
                ("serving_pages_used", lambda: a.used_pages()),
                ("serving_pages_shared", lambda: a.shared_pages()),
            ):
                reg.gauge(name, poll=fn, unit=SPEC_BY_NAME[name].unit,
                          help=SPEC_BY_NAME[name].help)
            self.h_page_churn = self._hist(reg, "serving_page_churn_pages")

    @staticmethod
    def _hist(reg: MetricsRegistry, name: str) -> Histogram:
        spec = SPEC_BY_NAME[name]
        return reg.histogram(name, buckets=spec.buckets, unit=spec.unit,
                             help=spec.help)

    # ---- per-request lifecycle --------------------------------------------
    def request_submitted(self, h) -> None:
        if self.trace is not None:
            self.instant("submitted", request_track(h.uid), h.t_submit,
                         args={"uid": h.uid, "prompt_tokens": len(h.prompt),
                               "truncated": h.truncated})

    def request_admitted(self, h, slot: int,
                         pages: Optional[Dict[str, int]] = None) -> None:
        if self.h_queue_wait is not None:
            self.h_queue_wait.observe(max(h.t_admit - h.t_submit, 0.0))
        if self.trace is not None:
            args = {"uid": h.uid, "slot": slot}
            if pages:
                args.update(pages)
            self.instant("admitted", request_track(h.uid), h.t_admit,
                         args=args)

    def prefill_chunk(self, h, slot: int, t0: float, t1: float,
                      take: int, cursor: int) -> None:
        if self.trace is not None:
            self.trace.complete(
                "prefill_chunk", request_track(h.uid), t0, t1,
                cat="lifecycle",
                args={"slot": slot, "tokens": take, "cursor": cursor})

    def request_first_token(self, h) -> None:
        if self.trace is not None:
            self.instant("first_token", request_track(h.uid), h.t_first,
                         args={"uid": h.uid})

    def request_retired(self, h, slot: Optional[int]) -> None:
        """Observe completion histograms and emit the per-request lifecycle
        spans whose durations reconcile exactly with the
        ``RequestResult`` timestamps (t_submit/t_admit/t_first/t_done)."""
        if self.h_ttft is not None and h.t_first:
            self.h_ttft.observe(h.t_first - h.t_submit)
            if len(h.output) > 1:
                self.h_ttt.observe((h.t_done - h.t_first)
                                   / (len(h.output) - 1))
        if self.trace is None:
            return
        tr, track = self.trace, request_track(h.uid)
        args = {"uid": h.uid, "finish_reason": h.finish_reason,
                "tokens": len(h.output), "truncated": h.truncated}
        if slot is not None:
            args["slot"] = slot
        if h.error:
            args["error"] = h.error
        tr.complete("request", track, h.t_submit, h.t_done, cat="lifecycle",
                    args=args)
        t_admit = h.t_admit if h.t_admit else None
        tr.complete("queued", track, h.t_submit,
                    t_admit if t_admit is not None else h.t_done,
                    cat="lifecycle")
        if t_admit is not None and h.t_first:
            tr.complete("prefill", track, t_admit, h.t_first,
                        cat="lifecycle")
        if h.t_first:
            tr.complete("decode", track, h.t_first, h.t_done,
                        cat="lifecycle")
        tr.instant("retired", track, h.t_done,
                   args={"finish_reason": h.finish_reason})

    # ---- heartbeat digest -------------------------------------------------
    def digest(self) -> Dict[str, Any]:
        """Small flat dict for the heartbeat payload: lifecycle counters
        plus headline latency percentiles (seconds)."""
        reg = self.registry
        out: Dict[str, Any] = {}
        for name in ("serving_requests_submitted_total",
                     "serving_requests_completed_total",
                     "serving_requests_shed_total",
                     "serving_requests_timeout_total",
                     "serving_requests_error_total",
                     "serving_tokens_generated_total",
                     "serving_engine_steps_total"):
            if name in reg:
                out[name] = reg.value(name)
        # supervised serving: generation + restart count ride the heartbeat
        # (HEARTBEAT_SCHEMA 3) so the fleet monitor can spot crash-loopers
        if "serving_engine_generation" in reg:
            out["engine_generation"] = reg.value("serving_engine_generation")
        if "serving_engine_restarts_total" in reg:
            out["engine_restarts"] = reg.value(
                "serving_engine_restarts_total")
        for name, key in (("serving_ttft_seconds", "ttft"),
                          ("serving_queue_wait_seconds", "queue_wait"),
                          ("serving_step_seconds", "step")):
            if name in reg:
                hist = reg.get_histogram(name)
                if hist.count:
                    out[f"{key}_p50_s"] = hist.percentile(50)
                    out[f"{key}_p99_s"] = hist.percentile(99)
        return out
