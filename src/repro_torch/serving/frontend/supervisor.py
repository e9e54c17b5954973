"""Supervised engine recovery: crash-restart, deterministic replay,
hung-step watchdog.

The engine contains per-request faults, and a bare driver fans
``"error"`` out to every client when the engine itself dies. This module
closes the gap: an :class:`EngineSupervisor` owns an engine *factory*
(rebuild from the artifact or the model in memory), wraps the
:class:`~repro_torch.serving.frontend.driver.EngineDriver` lifecycle, and
turns engine death into a recovery instead of a fleet-wide error:

* **Detection** — a crashed ``engine.step()`` reaches the driver's
  ``_fatal`` path, which (under supervision) hands the exception to the
  supervisor instead of retiring handles; a *hung* step is caught by the
  watchdog, which polls ``EngineDriver.step_age()`` (read off the
  injectable engine clock — no raw wall time) against
  ``watchdog_step_timeout_s``.
* **Recovery** — the dead driver is :meth:`~EngineDriver.reap`-ed (its
  non-retired handles harvested), the factory builds a fresh engine with
  a new **generation id**, and every survivor is
  :meth:`~EngineDriver.adopt`-ed into the new driver. Replayed rows
  regenerate from token 0 under the determinism contract (output is a
  pure function of (params, prompt, SamplingParams)) while the handle's
  ``_delivered`` cursor dedups the already-streamed prefix — an SSE
  client sees its stream continue with no duplicate and no gap.
* **Blame** — the request mid-dispatch at the crash is the suspect: a
  single-attributed suspect is retired ``"error"`` immediately and
  blacklisted from replay; an ambiguous multi-suspect crash replays
  everyone but counts strikes, and ``blacklist_after`` strikes condemn
  the repeat offender. A poison request therefore cannot crash-loop the
  fleet: every crash shrinks the suspect set.
* **Circuit breaker** — exponential backoff between restarts;
  ``max_restarts`` crashes inside ``crash_window_s`` opens the breaker
  (**degraded mode**): new submits raise :class:`DegradedError` (the
  HTTP layer maps it to 503 + Retry-After) while replayable work keeps
  finishing. A crash-free window closes the breaker.

The supervisor duck-types the driver's client surface (``submit`` /
``cancel`` / ``call`` / ``results`` / ``stats`` / ``drain`` / ``close``)
so ``ThreadedHttpServer(supervisor)`` and ``serve.py --supervise`` work
unchanged; ``supervisor_status()`` feeds ``/healthz``.

Timing discipline: decisions (watchdog age, crash windows, MTTR spans)
read injectable clocks — the driver's engine clock for step age, the
supervisor's own ``clock`` (default ``repro_torch.runtime.clock.MONOTONIC``,
a ``VirtualClock`` in tests) for everything else. Real-time *sleeping*
(poll interval, backoff) uses interruptible ``threading.Event.wait``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.runtime import clock as rtclock
from repro_torch.serving.api import FINISH_ERROR, RequestResult, SamplingParams
from repro_torch.serving.frontend.driver import DriverHandle, EngineDriver
from repro_torch.serving.frontend.fairness import FairScheduler
from repro_torch.serving.observability import TRACK_ENGINE

__all__ = ["EngineSupervisor", "DegradedError", "StepTimeout"]


class DegradedError(RuntimeError):
    """Raised by :meth:`EngineSupervisor.submit` while the crash-loop
    circuit breaker is open (or the engine is permanently dead): the
    caller should retry after ``retry_after`` seconds. The HTTP layer
    maps this to ``503`` with a ``Retry-After`` header."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class StepTimeout(RuntimeError):
    """Synthesized by the watchdog for a hung ``engine.step()`` — plays
    the role of the crash exception for the recovery path. Carries no
    suspect attribution: ``reap`` blames every engine-resident row."""


class EngineSupervisor:
    """Crash-restart supervisor around an :class:`EngineDriver`.

    ``factory`` is a zero-arg callable returning a **fresh** engine
    (fresh ``Observability`` — the registry and ``bind_engine`` are
    single-bind) each call; ``engine`` optionally seeds generation 0
    with a pre-built engine (e.g. the one ``serve.py`` boot-traced).

    Thread model: client threads call the driver-shaped surface; one
    daemon monitor thread handles crash notifications, runs the
    watchdog, performs recoveries, and ages the breaker. The current
    driver swaps atomically under ``_lock``; ``_gen_ready`` is cleared
    for the duration of a rebuild so clients briefly park instead of
    racing a dead driver.
    """

    def __init__(self, factory: Callable[[], Any], *,
                 engine: Any = None,
                 fairness_factory: Optional[Callable[[], FairScheduler]]
                 = None,
                 max_restarts: int = 3,
                 restart_backoff_s: float = 0.05,
                 backoff_factor: float = 2.0,
                 crash_window_s: float = 30.0,
                 watchdog_step_timeout_s: Optional[float] = None,
                 watchdog_poll_s: float = 0.02,
                 blacklist_after: int = 2,
                 retry_after_s: float = 1.0,
                 resume_timeout_s: float = 30.0,
                 clock: Optional[Callable[[], float]] = None,
                 name: str = "engine-supervisor"):
        self._factory = factory
        self._initial_engine = engine
        self._fairness_factory = fairness_factory or FairScheduler
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.backoff_factor = backoff_factor
        self.crash_window_s = crash_window_s
        self.watchdog_step_timeout_s = watchdog_step_timeout_s
        self.watchdog_poll_s = watchdog_poll_s
        self.blacklist_after = blacklist_after
        self.retry_after_s = retry_after_s
        self.resume_timeout_s = resume_timeout_s
        self._clock = clock if clock is not None else rtclock.MONOTONIC
        self._lock = threading.RLock()
        self._driver: Optional[EngineDriver] = None
        self.generation = 0
        self.restarts = 0
        self.replayed = 0           # requests adopted onto rebuilt engines
        self.degraded = False
        self.dead = False           # factory failed: no more recoveries
        self.blacklist: set = set()
        self.crash_counts: Dict[int, int] = {}   # uid -> suspect strikes
        self.crash_times: List[float] = []
        self.recoveries: List[Dict[str, Any]] = []
        self.last_crash: Optional[str] = None
        self._recovery_durations: List[float] = []
        self._prior_results: List[RequestResult] = []
        self._prior_stats = {"submitted": 0, "frontend_sheds": 0,
                             "frontend_cancelled": 0, "frontend_timeouts": 0}
        self._crash_q: deque = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._gen_ready = threading.Event()
        self._thread = threading.Thread(target=self._monitor, name=name,
                                        daemon=True)
        self._started = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "EngineSupervisor":
        if self._started:
            return self
        self._started = True
        eng = self._initial_engine if self._initial_engine is not None \
            else self._factory()
        self._initial_engine = None
        self._bind(eng)
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            drv = self._driver
        return drv.drain(timeout) if drv is not None else True

    def close(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._started and self._thread.is_alive():
            self._thread.join(timeout)
        with self._lock:
            drv = self._driver
        if drv is not None:
            drv.close(timeout)
        self._gen_ready.set()  # unpark any submit/call waiter to fail fast

    @property
    def engine(self):
        """The current generation's engine (drain-report / test surface;
        the same only-between-steps rules as ``EngineDriver.engine``)."""
        with self._lock:
            drv = self._driver
        return drv.engine if drv is not None else None

    @property
    def driver(self) -> Optional[EngineDriver]:
        with self._lock:
            return self._driver

    # ------------------------------------------------------------- clients
    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               tenant: Optional[str] = None) -> DriverHandle:
        """Driver-shaped submit. Degraded/dead → :class:`DegradedError`
        (the 503 path); during a rebuild the call parks briefly on
        ``_gen_ready`` and retries once if it raced the crash."""
        h = None
        for _ in range(2):
            with self._lock:
                if self.degraded or self.dead:
                    raise DegradedError(
                        "engine permanently failed" if self.dead else
                        "service degraded: engine is crash-looping, "
                        "shedding new work while replay finishes",
                        retry_after=self.retry_after_s)
            if not self._gen_ready.wait(self.resume_timeout_s):
                raise DegradedError("engine rebuilding",
                                    retry_after=self.retry_after_s)
            with self._lock:
                drv = self._driver
            h = drv.submit(prompt, params, tenant=tenant)
            # "driver closed" here means we raced the crash: the next
            # generation will accept — retry once against it
            if not (h.done and h.error == "driver closed"):
                return h
        return h

    def cancel(self, h: DriverHandle) -> bool:
        drv = h._driver
        return drv.cancel(h) if drv is not None else False

    def call(self, fn: Callable[[Any], Any], timeout: float = 30.0) -> Any:
        """Run ``fn(engine)`` on the current generation's driver thread
        (retrying once across a racing crash)."""
        last: Optional[BaseException] = None
        for _ in range(2):
            if not self._gen_ready.wait(timeout):
                raise RuntimeError("engine rebuilding")
            with self._lock:
                drv = self._driver
            if drv is None:
                raise RuntimeError("supervisor closed")
            try:
                return drv.call(fn, timeout)
            except RuntimeError as e:  # driver died under us — retry once
                last = e
        raise RuntimeError(f"engine unavailable across restart: {last}")

    def results(self) -> List[RequestResult]:
        with self._lock:
            drv = self._driver
            out = list(self._prior_results)
        if drv is not None:
            out.extend(drv.results())
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            drv = self._driver
            prior = dict(self._prior_stats)
            retired_prior = len(self._prior_results)
        cur = drv.stats() if drv is not None else {
            "submitted": 0, "frontend_sheds": 0, "frontend_cancelled": 0,
            "frontend_timeouts": 0, "pending": 0, "live": 0, "retired": 0}
        for k in prior:
            cur[k] += prior[k]
        cur["retired"] += retired_prior
        cur["generation"] = self.generation
        cur["restarts"] = self.restarts
        cur["replayed"] = self.replayed
        return cur

    def supervisor_status(self) -> Dict[str, Any]:
        """Flat JSON-able snapshot for ``/healthz`` and the stats line."""
        with self._lock:
            return {
                "generation": self.generation,
                "restarts": self.restarts,
                "degraded": self.degraded,
                "dead": self.dead,
                "replayed": self.replayed,
                "blacklisted": sorted(self.blacklist),
                "last_crash": self.last_crash,
                "recoveries": len(self.recoveries),
                "watchdog_step_timeout_s": self.watchdog_step_timeout_s,
            }

    # ----------------------------------------------------- monitor thread
    def _on_fatal(self, exc: BaseException) -> None:
        """Driver-thread callback: hand the crash to the monitor."""
        with self._lock:
            self._crash_q.append(exc)
        self._wake.set()

    def _monitor(self) -> None:
        while not self._stop.is_set():
            fired = self._wake.wait(self.watchdog_poll_s)
            if self._stop.is_set():
                return
            if fired:
                self._wake.clear()
            exc: Optional[BaseException] = None
            with self._lock:
                if self._crash_q:
                    exc = self._crash_q.popleft()
            if exc is None:
                exc = self._check_watchdog()
            if exc is not None:
                self._recover(exc)
            else:
                self._maybe_close_breaker()

    def _check_watchdog(self) -> Optional[BaseException]:
        timeout = self.watchdog_step_timeout_s
        if timeout is None:
            return None
        with self._lock:
            drv = self._driver
        if drv is None or drv.fatal_exc is not None:
            return None
        age = drv.step_age()
        if age is not None and age > timeout:
            return StepTimeout(
                f"engine step exceeded watchdog_step_timeout_s={timeout} "
                f"(running {age:.3f}s on the engine clock)")
        return None

    def _maybe_close_breaker(self) -> None:
        with self._lock:
            if not self.degraded or self.dead:
                return
            now = self._clock()
            if not self.crash_times \
                    or now - self.crash_times[-1] > self.crash_window_s:
                self.degraded = False

    # ------------------------------------------------------------ recovery
    def _recover(self, exc: BaseException) -> None:
        t_detect = self._clock()
        self._gen_ready.clear()
        with self._lock:
            old = self._driver
        if old is None:
            return
        suspects, survivors = old.reap(exc)
        self.last_crash = f"{type(exc).__name__}: {exc}"
        kept = self._condemn(old, exc, suspects, survivors, t_detect)
        with self._lock:
            self._prior_results.extend(old.results())
            self._prior_stats["submitted"] += old.submitted
            self._prior_stats["frontend_sheds"] += old.sheds
            self._prior_stats["frontend_cancelled"] += old.cancelled
            self._prior_stats["frontend_timeouts"] += old.timeouts
            self.crash_times.append(t_detect)
            recent = [t for t in self.crash_times
                      if t_detect - t <= self.crash_window_s]
            if len(recent) >= self.max_restarts:
                self.degraded = True
        old.close(timeout=0.1)  # dead or wedged in step(): don't block
        backoff = self.restart_backoff_s * (
            self.backoff_factor ** max(len(recent) - 1, 0))
        if self._stop.wait(backoff):
            self._retire_all(old, kept, exc)
            return
        try:
            eng = self._factory()
        except Exception as e:  # rebuild itself failed: terminal
            with self._lock:
                self.dead = True
            self._retire_all(old, kept, e)
            self._gen_ready.set()
            return
        with self._lock:
            self.generation += 1
            self.restarts += 1
        rec: Dict[str, Any] = {
            "generation": self.generation, "t_detect": t_detect,
            "suspects": list(suspects), "replayed": len(kept),
            "exc": self.last_crash, "t_first_replayed_token": None}
        drv = self._bind(eng)
        for h in kept:
            self._watch_first_replay(h, rec)
            drv.adopt(h)
            with self._lock:
                self.replayed += 1
        t_restored = self._clock()
        rec["t_restored"] = t_restored
        rec["duration_s"] = t_restored - t_detect
        with self._lock:
            self.recoveries.append(rec)
            self._recovery_durations.append(rec["duration_s"])
        reg = eng.obs.registry
        if "serving_recovery_seconds" in reg:
            reg.get_histogram("serving_recovery_seconds").observe(
                rec["duration_s"])
        if eng.obs.trace is not None:
            eng.obs.trace.complete(
                "recovery", TRACK_ENGINE, t_detect, t_restored,
                cat="supervisor",
                args={"generation": self.generation,
                      "replayed": len(kept), "suspects": list(suspects)})
        self._gen_ready.set()

    def _condemn(self, old: EngineDriver, exc: BaseException,
                 suspects: Tuple[int, ...], survivors: List[DriverHandle],
                 now: float) -> List[DriverHandle]:
        """Strike every suspect; blacklist an unambiguous one immediately
        and any uid reaching ``blacklist_after`` strikes. Returns the
        survivors still eligible for replay (blacklisted ones retire
        ``"error"`` exactly once, on the *old* driver so their record
        lands before the generation swap)."""
        with self._lock:
            for uid in suspects:
                self.crash_counts[uid] = self.crash_counts.get(uid, 0) + 1
                if self.crash_counts[uid] >= self.blacklist_after:
                    self.blacklist.add(uid)
            if len(suspects) == 1:
                self.blacklist.add(suspects[0])
            black = set(self.blacklist)
        kept: List[DriverHandle] = []
        for h in survivors:
            if h.uid in black:
                self._retire_error(old, h, exc, now)
            else:
                kept.append(h)
        return kept

    def _retire_error(self, drv: EngineDriver, h: DriverHandle,
                      exc: BaseException, now: float) -> None:
        why = (f"{drv._crash_detail(exc)}; request blacklisted as crash "
               f"suspect (strike {self.crash_counts.get(h.uid, 1)})")
        with drv._cond:
            if h.done:  # never double-retire
                return
            drv._finish_locked(h, RequestResult(
                uid=h.uid, tokens=tuple(h.output),
                finish_reason=FINISH_ERROR, truncated=h.truncated,
                t_submit=h.t_submit, t_first=h.t_first, t_done=now,
                t_admit=h.t_admit, error=why))

    def _retire_all(self, drv: EngineDriver, handles: List[DriverHandle],
                    exc: BaseException) -> None:
        now = self._clock()
        for h in handles:
            self._retire_error(drv, h, exc, now)

    def _watch_first_replay(self, h: DriverHandle,
                            rec: Dict[str, Any]) -> None:
        """One-shot subscriber stamping the first *new* token a replayed
        handle delivers (history replays with index < the pre-crash
        cursor, so they're filtered) — the MTTR endpoint the recovery
        bench reads."""
        d0 = h._delivered

        def watch(ev: tuple) -> None:
            if ev[0] == "token" and ev[1] >= d0 \
                    and rec["t_first_replayed_token"] is None:
                rec["t_first_replayed_token"] = self._clock()

        h.subscribe(watch)

    # ------------------------------------------------------------- binding
    def _bind(self, engine) -> EngineDriver:
        """Build and start the driver for the current generation, carry
        uid allocation forward, and re-register the supervisor's metrics
        on the fresh engine's registry."""
        drv = EngineDriver(engine, fairness=self._fairness_factory(),
                           name=f"engine-driver-gen{self.generation}")
        drv.generation = self.generation
        drv.on_fatal = self._on_fatal
        with self._lock:
            prev = self._driver
        if prev is not None:
            drv._next_uid = max(drv._next_uid, prev._next_uid)
        self._register_metrics(engine)
        drv.start()
        with self._lock:
            self._driver = drv
        self._gen_ready.set()
        return drv

    def _register_metrics(self, engine) -> None:
        reg = engine.obs.registry
        if "serving_engine_restarts_total" in reg:
            return
        reg.counter("serving_engine_restarts_total",
                    poll=lambda: self.restarts,
                    help="engine rebuilds performed by the supervisor")
        reg.counter("serving_requests_replayed_total",
                    poll=lambda: self.replayed,
                    help="requests replayed onto a rebuilt engine")
        reg.gauge("serving_engine_generation",
                  poll=lambda: self.generation,
                  help="current engine generation id (0 = never restarted)")
        reg.gauge("serving_degraded",
                  poll=lambda: int(self.degraded),
                  help="1 while the crash-loop breaker sheds new submits")
        hist = reg.histogram("serving_recovery_seconds", unit="seconds",
                             help="engine death detected -> survivors "
                                  "requeued on the rebuilt engine")
        for d in self._recovery_durations:  # history survives the rebuild
            hist.observe(d)
