"""Thread-safe engine driver: one thread owns the device.

``ServingEngine`` is deliberately single-threaded — ``step()`` mutates
slot state, the page pool, and the compile caches with no locking, and
the v1 ``RequestHandle`` drives ``step()`` from whatever thread consumes
it. That cooperative style stays the in-process baseline; this module
adds the concurrent one:

* :class:`EngineDriver` runs a single daemon thread that is the **only**
  caller of any engine method after ``start()``. Clients talk to the
  driver through thread-safe ``submit`` / ``cancel`` / ``call`` and
  consume per-request queues; a condition variable wakes the driver on
  new work and parks it (no spinning) when the fleet is idle.
* :class:`DriverHandle` mirrors the v1 handle surface (``tokens()``,
  ``result()``, ``cancel()``, the timing fields) but never touches the
  engine: ``tokens()`` reads the handle's own event queue fed by the
  driver at the end of each step — same-step delivery, stream TTFT is
  engine TTFT — and ``result()`` waits on an event instead of stepping.
  ``subscribe(fn)`` replays history then attaches a callback (the HTTP
  layer bridges it onto an asyncio loop).

Admission order is delegated to a :class:`~repro_torch.serving.frontend.
fairness.FairScheduler`: accepted requests wait in per-tenant DRR queues
and the driver offers the engine at most ``free_admissible_slots()``
requests per step, so the engine's strict-FIFO internal queue stays
shallow and the DRR decision is the effective admission order. Engine-
level admission control (v1.1 caps, v1.2 page budgets) still applies to
every offer; an engine shed propagates to the client unchanged
(finish_reason ``"rejected"``).

Determinism is unaffected: tokens are a pure function of (params,
prompt, ``SamplingParams``), so outputs through the driver are
bit-identical to cooperative ``engine.submit`` — regardless of thread
interleaving, which only changes co-batching.

Drain and shutdown: ``drain()`` stops intake (new submits and anything
still waiting in the fair queue shed with ``"rejected"`` — the client
retries another replica) and lets everything already offered to the
engine finish or deadline out; ``close()`` cancels whatever is left and
joins the thread.

Engine death: an exception escaping ``engine.step()`` hits ``_fatal``.
Standalone, every in-flight handle retires ``"error"`` with the crash
detail attached (clients can tell engine death from a contained
per-request fault) and the driver closes. Under an
:class:`~repro_torch.serving.frontend.supervisor.EngineSupervisor`
(``on_fatal`` set), handles are left alive for :meth:`EngineDriver.reap`
/ :meth:`EngineDriver.adopt` migration onto a rebuilt engine: replay
regenerates from token 0 and the ``_delivered`` cursor dedups the
already-streamed prefix.

Every timestamp routes through the engine's injectable clock
(``engine.clock`` — a ``VirtualClock`` under a fault injector), keeping
the static wall-clock guard and the trace-reconciliation guarantee
intact across the frontend.

The reference's module with the port's imports and these changes for an
engine that holds device memory. A retired handle drops the engine's
handle, a reaped driver abandons its engine (``ServingEngine.abandon``: a
step that has not reached the device yet raises instead) and drops it, and
the fatal exception a driver keeps has its traceback as text, without the
frames: so a dead generation is freed with its engine even while clients
keep their handles. An abandoned thread whose step raises exits without
reporting a crash: its generation has already been replaced.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import traceback
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional

from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_REJECTED,
                               FINISH_TIMEOUT, FINISH_ERROR, RequestResult,
                               SamplingParams)
from repro_torch.serving.frontend.fairness import FairScheduler

_DONE = "done"
_TOKEN = "token"


class DriverHandle:
    """Client-side view of one request submitted through the driver.

    Mirrors the v1 ``RequestHandle`` reading surface (``uid``,
    ``prompt``, ``params``, ``output``, ``finish_reason``, ``error``,
    ``truncated``, timing fields, ``done``, ``tokens()``, ``result()``,
    ``cancel()``) but is passive: consuming it never drives the engine.
    ``tokens()`` has single-consumer semantics (one queue per handle);
    any number of ``subscribe`` callbacks may observe in parallel.
    """

    def __init__(self, uid: int, prompt: List[int], params: SamplingParams):
        self.uid = uid
        self.prompt = prompt
        self.params = params
        self.tenant = params.tenant
        self.output: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.truncated = False
        self.t_submit = 0.0
        self.t_admit = 0.0
        self.t_first = 0.0
        self.t_done = 0.0
        self._driver: Optional["EngineDriver"] = None
        self._inner = None              # engine RequestHandle, driver-only
        self._state = "new"             # new -> queued -> engine -> done
        self._delivered = 0             # engine tokens already mirrored
        self._replayed = False          # re-queued after an engine crash
        self._drr_cost: Optional[int] = None
        self._elock = threading.Lock()
        self._events: List[tuple] = []
        self._watchers: List[Callable[[tuple], None]] = []
        self._q: _queue.Queue = _queue.Queue()
        self._done_evt = threading.Event()
        self._result: Optional[RequestResult] = None

    # ------------------------------------------------------------- consume
    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def tokens(self) -> Iterator[int]:
        """Yield each generated token as the driver step that produced it
        completes. Returns when the request retires (check
        ``finish_reason`` / ``result()`` afterwards)."""
        while True:
            ev = self._q.get()
            if ev[0] == _TOKEN:
                yield ev[2]
            else:
                return

    def result(self, timeout: Optional[float] = None) -> RequestResult:
        """Block until the request retires; returns the immutable record.
        Raises ``TimeoutError`` if ``timeout`` (seconds) elapses first."""
        if not self._done_evt.wait(timeout):
            raise TimeoutError(f"request {self.uid} not done "
                               f"after {timeout}s")
        assert self._result is not None
        return self._result

    def cancel(self) -> bool:
        """Thread-safe cancel; False if the request already finished."""
        assert self._driver is not None
        return self._driver.cancel(self)

    def subscribe(self, fn: Callable[[tuple], None]) -> None:
        """Attach an event callback, first replaying history — so a
        subscriber can never miss a token to the race between submit and
        attach. Events are ``("token", index, token_id)`` then exactly one
        ``("done", RequestResult)``. Callbacks run on the driver thread:
        return quickly and do not call back into the driver (except
        ``cancel``, which is re-entrant)."""
        with self._elock:
            history = list(self._events)
            self._watchers.append(fn)
        for ev in history:
            fn(ev)

    # -------------------------------------------------------- driver-side
    def _emit(self, ev: tuple) -> None:
        with self._elock:
            self._events.append(ev)
            watchers = list(self._watchers)
        self._q.put(ev)
        for w in watchers:
            try:
                w(ev)
            except Exception:
                pass  # a broken subscriber must not take down the driver


def _without_frames(exc: BaseException) -> BaseException:
    """``exc`` with its traceback kept as text (``exc.traceback_text``) and
    its frames dropped, along its cause and context chain: the frames hold
    the engine, and the driver keeps its fatal exception after the engine
    has been given up."""
    exc.traceback_text = "".join(traceback.format_exception(exc))
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        e.__traceback__ = None
        e = e.__cause__ or e.__context__
    return exc


class _CallBox:
    __slots__ = ("fn", "evt", "value", "exc")

    def __init__(self, fn):
        self.fn = fn
        self.evt = threading.Event()
        self.value = None
        self.exc: Optional[BaseException] = None


class EngineDriver:
    """Single-threaded owner of a ``ServingEngine`` with a thread-safe
    frontend surface.

    Threading rules (the v1.4 contract):

    * After ``start()``, **no other thread may call any engine method**
      — use ``submit`` / ``cancel`` / ``call`` instead. ``call(fn)``
      runs ``fn(engine)`` on the driver thread between steps (how the
      HTTP layer snapshots ``health()`` and scrapes the registry without
      racing the step loop).
    * Any number of threads may submit/cancel/consume concurrently; a
      handle's ``tokens()`` iterator is single-consumer.
    * The driver parks on its condition variable when there is no
      waiting, queued, or resident work — an idle server burns no CPU —
      and wakes on submit/cancel/call/drain.
    """

    def __init__(self, engine, *, fairness: Optional[FairScheduler] = None,
                 name: str = "engine-driver"):
        self._eng = engine
        self._clock = engine.clock
        self._fair = fairness if fairness is not None else FairScheduler()
        cap = self._capacity = engine.ecfg.capacity
        self._fair.bind_cost(
            lambda h: min(len(h.prompt), cap) + h.params.max_new_tokens)
        lock = threading.RLock()
        self._cond = threading.Condition(lock)
        self._cancels: deque = deque()
        self._calls: deque = deque()
        self._live: Dict[int, DriverHandle] = {}
        self._results: List[RequestResult] = []
        self._draining = False
        self._closed = False
        self._drained_evt = threading.Event()
        self._next_uid = engine._next_uid
        # supervision surface (EngineSupervisor): on_fatal routes engine
        # death to the supervisor instead of fanning "error" out to every
        # client; generation tags which rebuild this driver belongs to
        self.on_fatal: Optional[Callable[[BaseException], None]] = None
        self.fatal_exc: Optional[BaseException] = None
        self.generation = 0
        self._abandoned = False   # reaped: the loop must exit touching nothing
        self._step_t0: Optional[float] = None  # engine-clock stamp of the
        #                                        in-flight step (watchdog read)
        self.submitted = 0
        self.sheds = 0      # frontend sheds (caps, drain) — engine sheds
        #                     are counted by the engine itself
        self.cancelled = 0  # cancelled before reaching the engine
        self.timeouts = 0   # deadlined before reaching the engine
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._started = False

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "EngineDriver":
        if self._started:
            return self
        self._started = True
        reg = self._eng.obs.registry
        if "serving_frontend_shed_total" not in reg:
            reg.counter("serving_frontend_shed_total",
                        poll=lambda: self.sheds,
                        help="requests shed by the frontend "
                             "(fair-queue caps, drain)")
            reg.gauge("serving_frontend_queue_depth",
                      poll=lambda: len(self._fair),
                      help="requests waiting in the frontend fair queue")
        self._thread.start()
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop intake and wait for the engine to empty. New submits and
        requests still waiting in the fair queue shed with ``"rejected"``;
        work already offered to the engine finishes (or deadlines out)
        normally. Returns True once fully drained."""
        with self._cond:
            if not self._draining:
                self._draining = True
                for h in self._fair.drain():
                    self._shed_locked(h, "server draining")
            self._cond.notify_all()
        return self._drained_evt.wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Cancel everything still in flight and join the driver thread."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._started:
            self._thread.join(timeout)

    @property
    def engine(self):
        """The owned engine. Only for pre-``start()`` wiring and
        post-``close()`` inspection — never call engine methods while the
        driver is running (use :meth:`call`)."""
        return self._eng

    # ------------------------------------------------------------- clients
    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               tenant: Optional[str] = None) -> DriverHandle:
        """Thread-safe submit. Invalid inputs raise synchronously
        (``TypeError`` / ``ValueError`` — the HTTP layer's 400s);
        admission decisions come back through the handle
        (``finish_reason "rejected"`` for sheds)."""
        if params is None:
            params = SamplingParams()
        if tenant is not None:
            params = dataclasses.replace(params, tenant=tenant)
        if isinstance(prompt, (str, bytes)):
            raise TypeError("prompt must be a sequence of token ids, not "
                            "text — tokenize first")
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        h = DriverHandle(self._alloc_uid(), prompt, params)
        h._driver = self
        h.t_submit = self._clock()
        h.truncated = len(prompt) > self._capacity
        with self._cond:
            self.submitted += 1
            if self._closed:
                self._shed_locked(h, "driver closed")
                return h
            if self._draining:
                self._shed_locked(h, "server draining")
                return h
            cap = self._fair.tenant_max_resident_tokens
            if cap is not None and self._fair.cost(h) > cap:
                self._shed_locked(
                    h, f"request needs {self._fair.cost(h)} committed "
                       f"tokens > per-tenant cap {cap} (can never fit)")
                return h
            why = self._fair.push(h)
            if why is not None:
                self._shed_locked(h, why)
                return h
            h._state = "queued"
            self._cond.notify_all()
        return h

    def cancel(self, h: DriverHandle) -> bool:
        with self._cond:
            if h._state == "done":
                return False
            if h._state == "queued" and self._fair.remove(h):
                self.cancelled += 1
                self._finish_locked(h, RequestResult(
                    uid=h.uid, tokens=(), finish_reason=FINISH_CANCELLED,
                    truncated=h.truncated, t_submit=h.t_submit, t_first=0.0,
                    t_done=self._clock(),
                    error="cancelled before admission"))
                return True
            self._cancels.append(h)
            self._cond.notify_all()
            return True

    def call(self, fn: Callable[[Any], Any], timeout: float = 30.0) -> Any:
        """Run ``fn(engine)`` on the driver thread between steps and
        return its value — the one sanctioned way to read engine state
        (health, metrics, compile stats) while the driver runs."""
        if threading.current_thread() is self._thread:
            return fn(self._eng)  # re-entrant (e.g. from a subscriber)
        box = _CallBox(fn)
        with self._cond:
            if self._closed and not self._thread.is_alive():
                raise RuntimeError("driver closed")
            self._calls.append(box)
            self._cond.notify_all()
        if not box.evt.wait(timeout):
            raise TimeoutError("driver call timed out")
        if box.exc is not None:
            raise box.exc
        return box.value

    def results(self) -> List[RequestResult]:
        """Completion records of every request that retired through this
        driver, in retirement order (the drain-table source)."""
        with self._cond:
            return list(self._results)

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {
                "submitted": self.submitted,
                "frontend_sheds": self.sheds,
                "frontend_cancelled": self.cancelled,
                "frontend_timeouts": self.timeouts,
                "pending": len(self._fair),
                "live": len(self._live),
                "retired": len(self._results),
            }

    # ------------------------------------------------------- driver thread
    def _alloc_uid(self) -> int:
        with self._cond:
            uid, self._next_uid = self._next_uid, self._next_uid + 1
            return uid

    def _shed_locked(self, h: DriverHandle, why: str) -> None:
        self.sheds += 1
        self._finish_locked(h, RequestResult(
            uid=h.uid, tokens=(), finish_reason=FINISH_REJECTED,
            truncated=h.truncated, t_submit=h.t_submit, t_first=0.0,
            t_done=self._clock(), error=why))

    def _finish_locked(self, h: DriverHandle, res: RequestResult) -> None:
        if h._replayed:
            # a replayed request's record keeps its original submit/admit/
            # first-token stamps — the client experienced one request, not
            # one per engine generation
            res = dataclasses.replace(
                res, t_submit=h.t_submit or res.t_submit,
                t_admit=h.t_admit or res.t_admit,
                t_first=h.t_first or res.t_first)
        h.finish_reason = res.finish_reason
        h.error = res.error
        h.t_admit, h.t_first, h.t_done = res.t_admit, res.t_first, res.t_done
        h._state = "done"
        h._inner = None  # the engine's handle (and through it the engine)
        h._result = res
        self._results.append(res)
        h._emit((_DONE, res))
        h._done_evt.set()

    def _service_calls_locked(self) -> None:
        while self._calls:
            box = self._calls.popleft()
            try:
                box.value = box.fn(self._eng)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                box.exc = e
            box.evt.set()

    def _apply_cancels_locked(self) -> None:
        while self._cancels:
            h = self._cancels.popleft()
            if h._state == "engine" and not h._inner.done:
                self._eng.cancel(h._inner)
            elif h._state == "queued" and self._fair.remove(h):
                self.cancelled += 1
                self._finish_locked(h, RequestResult(
                    uid=h.uid, tokens=(), finish_reason=FINISH_CANCELLED,
                    truncated=h.truncated, t_submit=h.t_submit, t_first=0.0,
                    t_done=self._clock(),
                    error="cancelled before admission"))

    def _sweep_frontend_locked(self) -> None:
        """Deadline requests still waiting in the fair queue (the engine
        only sweeps what it has been offered)."""
        now = self._clock()
        expired = []
        for h in self._fair.pending():
            d, td = h.params.deadline_s, h.params.ttft_deadline_s
            over = min(x for x in (d, td) if x is not None) \
                if (d is not None or td is not None) else None
            if over is not None and now - h.t_submit >= over:
                expired.append(h)
        for h in expired:
            self._fair.remove(h)
            self.timeouts += 1
            self._finish_locked(h, RequestResult(
                uid=h.uid, tokens=(), finish_reason=FINISH_TIMEOUT,
                truncated=h.truncated, t_submit=h.t_submit, t_first=0.0,
                t_done=now, error="deadline expired in frontend queue"))

    def _offer_locked(self) -> int:
        """Hand the engine up to (free admissible slots − already queued)
        requests in DRR order; engine-level sheds propagate unchanged."""
        eng = self._eng
        offered = 0
        while True:
            room = eng.free_admissible_slots() - len(eng.queue)
            if room <= 0:
                break
            h = self._fair.pop()
            if h is None:
                break
            inner = eng.submit(h.prompt, h.params, uid=h.uid)
            h._inner = inner
            h.truncated = inner.truncated
            if inner.done:  # engine-level shed (caps, page budget)
                self._fair.retire(h)
                self._finish_locked(h, inner.result())
            else:
                h._state = "engine"
                self._live[h.uid] = h
            offered += 1
        return offered

    def _shutdown_locked(self) -> None:
        for h in self._fair.drain():
            self._shed_locked(h, "driver closed")
        for h in list(self._live.values()):
            if not h._inner.done:
                self._eng.cancel(h._inner)

    def _pump(self) -> None:
        """Mirror new engine tokens into handle queues and retire finished
        requests — the per-step fan-out that makes delivery same-step."""
        retired = []
        for h in list(self._live.values()):
            inner = h._inner
            out = inner.output
            while h._delivered < len(out):
                tok = out[h._delivered]
                h.output.append(tok)
                h._delivered += 1
                if not h.t_first:
                    h.t_first = inner.t_first
                    h.t_admit = inner.t_admit
                h._emit((_TOKEN, h._delivered - 1, tok))
            if inner.done:
                retired.append(h)
        if not retired:
            return
        with self._cond:
            for h in retired:
                self._live.pop(h.uid, None)
                self._fair.retire(h)
                self._finish_locked(h, h._inner.result())
            self._cond.notify_all()  # wake a drain() waiter's re-check path

    def _fatal(self, exc: BaseException) -> None:
        """Engine-level failure (not a contained per-request fault).

        Standalone: retire everything with ``"error"`` carrying the crash
        detail (exception type + message), so no client hangs and each
        can tell engine death from a per-request fault. Supervised
        (``on_fatal`` set): leave the non-retired handles untouched — the
        supervisor harvests them with :meth:`reap` and replays them on a
        rebuilt engine — and just hand the exception over."""
        why = self._crash_detail(exc)
        cb = self.on_fatal
        with self._cond:
            self.fatal_exc = exc
            self._closed = True
            self._abandoned = True
            self._fail_calls_locked(why)
            if cb is None:
                now = self._clock()
                for h in list(self._live.values()):
                    self._live.pop(h.uid, None)
                    self._fair.retire(h)
                    self._finish_locked(h, RequestResult(
                        uid=h.uid, tokens=tuple(h.output),
                        finish_reason=FINISH_ERROR, truncated=h.truncated,
                        t_submit=h.t_submit, t_first=h.t_first, t_done=now,
                        t_admit=h.t_admit, error=why))
                for h in self._fair.drain():
                    self._shed_locked(h, why)
            self._drained_evt.set()
            self._cond.notify_all()
        if cb is not None:
            try:
                cb(exc)
            except Exception:  # a broken supervisor must not mask the crash
                pass

    def _crash_detail(self, exc: Optional[BaseException]) -> str:
        if exc is None:
            return f"engine died (generation {self.generation})"
        return (f"engine died (generation {self.generation}): "
                f"{type(exc).__name__}: {exc}")

    def _fail_calls_locked(self, why: str) -> None:
        while self._calls:
            box = self._calls.popleft()
            box.exc = RuntimeError(why)
            box.evt.set()

    def step_age(self) -> Optional[float]:
        """Engine-clock seconds the in-flight ``engine.step()`` has been
        running, or None between steps — the watchdog's only read."""
        t0 = self._step_t0
        return None if t0 is None else self._clock() - t0

    def reap(self, exc: Optional[BaseException] = None):
        """Supervisor-side harvest after engine death (crash or hang).

        Marks the driver closed and abandoned (a still-running loop exits
        without touching handles), fails pending ``call()`` waiters, and
        returns ``(suspects, survivors)``: the uids blamed for the death
        (from ``exc.suspects`` / ``exc.uid``, else every engine-resident
        uid — the hung-step case) and every non-retired handle, engine
        residents first then the fair queue, each in uid order. Safe from
        any thread: the driver thread is either dead (crash) or stuck
        inside ``engine.step()`` (hang), and never holds the condition
        across a step."""
        exc = exc if exc is not None else self.fatal_exc
        with self._cond:
            self.fatal_exc = self.fatal_exc or exc
            self._closed = True
            self._abandoned = True
            self._fail_calls_locked(self._crash_detail(exc))
            suspects = tuple(getattr(exc, "suspects", ()) or ())
            if not suspects and getattr(exc, "uid", None) is not None:
                suspects = (exc.uid,)
            if not suspects and self._eng is not None:
                suspects = tuple(h.uid for h in self._eng.slots
                                 if h is not None)
            live = sorted(self._live.values(), key=lambda h: h.uid)
            self._live.clear()
            queued = sorted(self._fair.drain(), key=lambda h: h.uid)
            if self._eng is not None:
                self._eng.abandon()
                self._eng = None
            self._drained_evt.set()
            self._cond.notify_all()
        return suspects, live + queued

    def adopt(self, h: DriverHandle) -> bool:
        """Re-queue a handle that lived on a previous (crashed) driver.

        The handle keeps its uid, delivered-token count, event history,
        and subscribers; the rebuilt engine regenerates its stream from
        token 0 (the determinism contract) and ``_pump``'s
        ``_delivered``-cursor skips the already-mirrored prefix — clients
        see no duplicate and no gap. Returns False when the handle
        already finished (nothing to replay)."""
        with self._cond:
            if h.done:
                return False
            h._driver = self
            h._inner = None
            h._replayed = True
            self._next_uid = max(self._next_uid, h.uid + 1)
            if self._closed or self._draining:
                self._shed_locked(h, "driver closed" if self._closed
                                  else "server draining")
                return True
            why = self._fair.push(h)
            if why is not None:
                self._shed_locked(h, why)
                return True
            h._state = "queued"
            self._cond.notify_all()
        return True

    def _loop(self) -> None:
        eng = self._eng
        while True:
            with self._cond:
                if self._abandoned:
                    return  # reaped by a supervisor — handles migrated
                self._service_calls_locked()
                if self._closed:
                    self._shutdown_locked()
                self._apply_cancels_locked()
                self._sweep_frontend_locked()
                if not self._closed:
                    self._offer_locked()
                busy = bool(eng.queue) \
                    or any(s is not None for s in eng.slots)
                # pending work behind quarantined slots: step anyway so the
                # quarantine countdown (engine_steps) can advance
                stalled = (len(self._fair) > 0 and not busy
                           and bool(eng.quarantined))
                if self._draining and not busy and not self._live \
                        and not len(self._fair):
                    self._drained_evt.set()
                if self._closed and not busy:
                    self._pump()
                    self._drained_evt.set()
                    return
                if not busy and not stalled:
                    # a cancel can retire an inner handle without a step;
                    # mirror it before parking or its client hangs
                    self._pump()
                    self._cond.wait(0.5)
                    continue
            self._step_t0 = self._clock()
            try:
                eng.step()
            except Exception as e:
                self._step_t0 = None
                if not self._abandoned:
                    self._fatal(_without_frames(e))
                return
            self._step_t0 = None
            if self._abandoned:
                # the watchdog reaped us mid-step (hung-step recovery that
                # eventually woke up): the handles now live on a newer
                # generation — mirroring anything would double-deliver
                return
            self._pump()
