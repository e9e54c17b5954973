"""Continuous-batching serving engine (the reference's
``repro.serving.engine.ServingEngine``, same scheduling and field names),
over the ring or the paged KV layout.

  * ``submit(prompt, SamplingParams(...)) -> RequestHandle`` enqueues;
  * ``step()`` advances the whole fleet one engine step: admission into all
    free slots, one bucketed prefill chunk for every mid-prompt slot, then
    one decode chunk for every decoding slot; it returns the handles that
    finished;
  * ``run()`` drives until drained.

The batch has ``max_slots`` fixed rows. Bucketed admission advances every
mid-prompt row by one power-of-two prefill bucket in a single dispatch
(rows not prefilling ride along with length 0); a long prompt is consumed
``prefill_chunk`` tokens per step, interleaved with shortened decode
chunks. Decode runs ``K`` ``decode_step``s in a Python loop with sampling,
stop-freezing and ``active`` kept on the device, and one host sync per
K-step dispatch (no CUDA graph yet).

Per-request sampling draws token i of a request from (seed, i) alone
(``serving.sampling``, ``jax.random``'s threefry stream), so output is
invariant to fleet composition and chunk boundaries; on the card this also
needs the batch-invariant kernels (every kernel of the path computes a row
the same way whatever shares its batch).

``kv_layout="paged"`` serves from one pool of ``page_size``-token pages
shared by every slot (``serving.paging.PageAllocator`` on the host, the
reference's semantics): admission reserves a request's worst-case pages up
front (the queue head waits for them, FIFO; a request that could never fit
is shed at submit), fully written prompt pages are published to a prefix
cache under their exact token keys, a later request with the same prefix
adopts them and skips their prefill (trimmed to a multiple of
``prefill_chunk`` so chunk boundaries, and hence logits, stay as in a cold
run), and a page shared by more than one holder is copied before any
dispatch writes it (copy-on-write). Streams equal the ring layout's.

Robustness (the reference's, decision for decision): ``deadline_s`` and
``ttft_deadline_s`` are swept at the start of every step (reason
``"timeout"``); ``max_queue`` / ``max_resident_tokens`` shed or block at
submit (``admission_policy``); a decode row whose logits are not all finite
is frozen on the device, flagged in the dispatch's one host sync, and
retired ``"error"`` without its garbage token, as is a prefill finisher
with non-finite logits (whose prompt pages are never published); a
dispatch that raises retires the request it names, or every row of the
dispatch, and the slot sits out ``quarantine_steps`` engine steps. Every
timestamp comes from one injectable clock (``runtime.clock``; a
``serving.faults.VirtualClock`` under an injector), and an engine built
with a ``serving.faults.FaultInjector`` also NaN-poisons chosen rows on the
device; one built without runs no poison operation.

Not ported yet, and rejected when set: observability, pre-unpacked planes
and an attention-backend override.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import decode_step, init_decode_state, prefill_chunk
from repro_torch.runtime import clock as rtclock
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_ERROR,
                                     FINISH_LENGTH, FINISH_REJECTED,
                                     FINISH_STOP, FINISH_TIMEOUT,
                                     RequestHandle, SamplingParams,
                                     make_handle)
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.sampling import sample_tokens_per_request

__all__ = ["EngineConfig", "ServingEngine", "SamplingParams", "RequestHandle",
           "EngineFault", "EngineCrash"]


class EngineCrash(RuntimeError):
    """The engine itself died: not a containable per-dispatch fault.

    Unlike :class:`EngineFault`, which ``_contain`` absorbs, an
    ``EngineCrash`` escapes ``step()``: device state after a crash cannot
    be trusted, so whoever drives the engine must tear it down. ``uid``
    blames one request when the crasher is known; the engine fills
    ``suspects`` with the uids of the dispatch that died (just the blamed
    uid when it was resident)."""

    def __init__(self, msg: str, uid: Optional[int] = None):
        super().__init__(msg)
        self.uid = uid
        self.suspects: Tuple[int, ...] = ()


class EngineFault(RuntimeError):
    """A device-dispatch failure attributed (when possible) to one slot.

    Raised by fault injectors and used as the containment envelope for
    real dispatch exceptions. ``slot`` is the offending batch row, or None
    when the failure cannot be attributed: then every request of the
    dispatch retires (the containment unit is the dispatch, never the
    engine)."""

    def __init__(self, msg: str, slot: Optional[int] = None):
        super().__init__(msg)
        self.slot = slot


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide knobs; per-request behavior lives in ``SamplingParams``."""

    max_slots: int = 4
    capacity: int = 256          # KV-cache length per slot
    eos_id: Optional[int] = None
    attn_backend: Optional[str] = None
    decode_chunk: int = 8        # decode steps per dispatch (K)
    prefill_chunk: int = 64      # max prompt tokens consumed per slot per step
    # admission control (None → unbounded): max_queue caps the requests
    # waiting for a slot, max_resident_tokens the committed tokens (clipped
    # prompt + budget) of queued and resident requests; past a cap a submit
    # is shed ("reject") or drives step() until it fits ("block")
    max_queue: Optional[int] = None
    max_resident_tokens: Optional[int] = None
    admission_policy: str = "reject"
    # engine steps a suspect slot sits out before it is row-reset and
    # returned to the pool (None → only an explicit rehabilitate())
    quarantine_steps: Optional[int] = 2
    decode_chunk_prefilling: int = 2
    preunpack_decode: Optional[bool] = None
    kv_layout: str = "ring"      # "ring" | "paged"
    page_size: int = 16          # tokens per physical page (paged)
    # pool size in pages (None → max_slots · capacity / page_size, the ring
    # footprint; lower overcommits against prefix sharing)
    max_pages: Optional[int] = None
    prefix_cache: bool = True    # copy-on-write prefix reuse (paged)

    # fields of the reference this port does not implement yet, with the
    # only values it accepts
    _UNPORTED = {"attn_backend": (None, "auto"),
                 "preunpack_decode": (None, False)}

    def __post_init__(self):
        if self.max_slots < 1 or self.capacity < 1:
            raise ValueError("max_slots and capacity must be >= 1")
        if min(self.decode_chunk, self.prefill_chunk,
               self.decode_chunk_prefilling) < 1:
            raise ValueError("chunk sizes must be >= 1")
        if self.admission_policy not in ("reject", "block"):
            raise ValueError(f"admission_policy must be 'reject' or 'block', "
                             f"got {self.admission_policy!r}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (None disables)")
        if self.max_resident_tokens is not None \
                and self.max_resident_tokens < 1:
            raise ValueError("max_resident_tokens must be >= 1 (None "
                             "disables)")
        if self.quarantine_steps is not None and self.quarantine_steps < 0:
            raise ValueError("quarantine_steps must be >= 0 (None: only "
                             "rehabilitate())")
        if self.kv_layout not in ("ring", "paged"):
            raise ValueError(f"kv_layout must be 'ring' or 'paged', got "
                             f"{self.kv_layout!r}")
        if self.kv_layout == "paged":
            if self.page_size < 1 or self.capacity % self.page_size:
                raise ValueError(f"capacity {self.capacity} must be a whole "
                                 f"number of pages (page_size "
                                 f"{self.page_size})")
            if self.max_pages is not None and self.max_pages < 1:
                raise ValueError("max_pages must be >= 1")
        for name, allowed in self._UNPORTED.items():
            if getattr(self, name) not in allowed:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (accepted: {allowed})")


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class ServingEngine:
    """Bucketed/chunked-prefill scheduler behind the v1 handle API.

    ``injector`` (optional) implements the ``serving.faults.FaultInjector``
    protocol: it may substitute the engine's clock, raise from a chosen
    dispatch and poison chosen rows' logits with NaN on the device. A
    production engine passes None and its decode loop has no poison
    operation."""

    def __init__(self, model, model_cfg, engine_cfg: EngineConfig, *,
                 injector=None, observability=None):
        if observability is not None:
            raise NotImplementedError("observability is not ported yet")
        self.model = model
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = model.embed.device
        nb = engine_cfg.max_slots
        self.queue: deque[RequestHandle] = deque()
        self.slots: List[Optional[RequestHandle]] = [None] * nb
        # ---- paged KV layout (see _plan_pages for the admission story)
        self.paged = engine_cfg.kv_layout == "paged"
        kv_spec = None
        if self.paged:
            ps = engine_cfg.page_size
            self._per_slot = engine_cfg.capacity // ps
            total = engine_cfg.max_pages
            if total is None:
                total = nb * self._per_slot
            # every block of the port is attention + MLP, so prefix reuse
            # is always sound (the reference turns it off for recurrent
            # mixers, whose state cannot skip the shared prefix)
            self._prefix_reuse = engine_cfg.prefix_cache
            self.alloc = PageAllocator(total, ps,
                                       prefix_cache=self._prefix_reuse)
            # host-authoritative logical→physical page map per slot; pushed
            # to the device table by _page_maintenance
            self._tables = np.zeros((nb, self._per_slot), np.int32)
            self._tables_dirty = False
            self._registered = [0] * nb
            self._cacheable = [False] * nb
            # COW fork targets reserved at admission (so a wrap-time fork
            # can never fail mid-request)
            self._reserve: List[List[int]] = [[] for _ in range(nb)]
            kv_spec = {"page_size": ps, "max_pages": total}
        else:
            self.alloc = None
            self._prefix_reuse = False
        self.state = init_decode_state(model_cfg, nb, engine_cfg.capacity,
                                       device=self.device, kv_spec=kv_spec)
        self.last_tokens = np.zeros((nb,), np.int32)
        self._prompts: List[Optional[List[int]]] = [None] * nb
        self._cursor: List[int] = [0] * nb
        self._slot_arrays = None  # fleet tensors; None → slots changed
        self._next_uid = 0
        self.steps = 0            # decode steps dispatched
        self.prefill_steps = 0    # prefill_chunk dispatches
        self.admits = 0
        # ---- fault containment / admission control state
        self._injector = injector
        clock = getattr(injector, "clock", None) if injector else None
        self._clock = clock if clock is not None else rtclock.MONOTONIC
        # suspect slots → engine step at which they may auto-rehabilitate
        self.quarantined: Dict[int, int] = {}
        self.engine_steps = 0     # step() calls (the injector's schedule)
        self._dispatch_counts = {"prefill": 0, "decode": 0}
        self.completed = 0        # finished stop/length
        self.cancelled = 0
        self.sheds = 0            # rejected at submit
        self.timeouts = 0         # retired by the deadline sweep
        self.errors = 0           # retired by fault containment
        self.submitted = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0

    # ------------------------------------------------------------------ API
    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               uid: Optional[int] = None) -> RequestHandle:
        """Enqueue a request; returns its ``RequestHandle``.

        Admission control: when ``max_queue`` or ``max_resident_tokens`` is
        set and accepting this request would exceed it, the request is
        shed: under ``"reject"`` the handle returns finished with reason
        ``"rejected"``; under ``"block"`` submit drives ``step()`` until the
        fleet drains enough to accept it. A request that could never fit
        (over the token cap alone, or over the page pool) is shed either
        way."""
        if uid is None:
            uid, self._next_uid = self._next_uid, self._next_uid + 1
        h = make_handle(self, prompt, params, uid)
        self._next_uid = max(self._next_uid, h.uid + 1)
        h.t_submit = self._clock()  # the engine clock owns all timestamps
        self.submitted += 1
        stop = frozenset(h.params.stop)
        if self.ecfg.eos_id is not None:
            stop |= {self.ecfg.eos_id}
        h._stop_ids = stop
        h.truncated = len(h.prompt) > self.ecfg.capacity
        never_fits = (self.ecfg.max_resident_tokens is not None
                      and self._committed_tokens(h)
                      > self.ecfg.max_resident_tokens)
        if self.paged and self._worst_pages(h) > self.alloc.n_pages:
            # an empty pool could not hold its worst case: shed now rather
            # than let the queue head wait for pages that can never free
            h.error = (f"page budget ({self._worst_pages(h)} worst-case "
                       f"pages > pool of {self.alloc.n_pages})")
            self._finish(h, FINISH_REJECTED, self._clock())
            return h
        if not self._admissible(h):
            if self.ecfg.admission_policy == "reject" or never_fits:
                # never_fits: blocking would spin forever
                h.error = self._overload_reason(h)
                self._finish(h, FINISH_REJECTED, self._clock())
                return h
            while not self._admissible(h):  # "block"
                if not self.queue and all(s is None for s in self.slots):
                    # drained and still over the cap (e.g. every slot
                    # quarantined): blocking could never succeed
                    h.error = self._overload_reason(h)
                    self._finish(h, FINISH_REJECTED, self._clock())
                    return h
                self.step()
        self.queue.append(h)
        return h

    def _committed_tokens(self, h: RequestHandle) -> int:
        """Token footprint a request commits the engine to: its clipped
        prompt plus its full generation budget."""
        return min(len(h.prompt), self.ecfg.capacity) + h.params.max_new_tokens

    def resident_tokens(self) -> int:
        """Committed tokens across queued + resident requests (the load
        ``max_resident_tokens`` caps)."""
        live = list(self.queue) + [s for s in self.slots if s is not None]
        return sum(self._committed_tokens(h) for h in live)

    def free_admissible_slots(self) -> int:
        """Slots a new admission could take right now (free and not
        quarantined)."""
        return sum(1 for i, s in enumerate(self.slots)
                   if s is None and i not in self.quarantined)

    def _admissible(self, h: RequestHandle) -> bool:
        if self.ecfg.max_queue is not None \
                and len(self.queue) >= self.ecfg.max_queue:
            return False
        if self.ecfg.max_resident_tokens is not None \
                and self.resident_tokens() + self._committed_tokens(h) \
                > self.ecfg.max_resident_tokens:
            return False
        return True

    def _overload_reason(self, h: RequestHandle) -> str:
        if self.ecfg.max_queue is not None \
                and len(self.queue) >= self.ecfg.max_queue:
            return (f"queue full ({len(self.queue)}/{self.ecfg.max_queue} "
                    "waiting)")
        return (f"resident-token cap ({self.resident_tokens()} committed + "
                f"{self._committed_tokens(h)} requested > "
                f"{self.ecfg.max_resident_tokens})")

    # -------------------------------------------------- paged KV internals
    def _worst_pages(self, h: RequestHandle) -> int:
        """Worst-case physical pages a request can hold at once: its
        committed tokens in pages, clipped to the slot's logical ring (a
        wrapping request reuses its own pages). Admission reserves exactly
        this: shared prefix pages cut fresh demand, but a wrap-bound
        request reserves one fork target per shared page."""
        ps = self.ecfg.page_size
        return min(-(-self._committed_tokens(h) // ps), self._per_slot)

    def _plan_pages(self, h: RequestHandle):
        """Reserve the whole worst-case page budget of ``h`` now, or return
        None if the pool cannot cover it yet (the queue head then waits).

        Returns (prompt, shared, fresh, reserve, cacheable): ``shared`` are
        prefix-cache pages adopted read-only (logical pages 0..n-1, whose
        tokens skip prefill); ``fresh`` private pages for the rest of the
        ring; ``reserve`` unmapped fork targets, one per shared page, taken
        only when generation will wrap the ring (every shared page is then
        overwritten and must fork); ``cacheable`` whether the row's own
        prompt pages may be published (never for truncated or wrap-bound
        prompts). The skipped prefix is trimmed to a multiple of
        ``prefill_chunk``, so a warm run replays the cold run's prefill
        dispatches from the skip point and its logits stay the same."""
        ps, cap = self.ecfg.page_size, self.ecfg.capacity
        prompt = list(h.prompt[-cap:])
        plen = len(prompt)
        will_wrap = plen + h.params.max_new_tokens > cap
        n_req = self._worst_pages(h)
        shared: List[int] = []
        n_keys = 0
        if self._prefix_reuse and not h.truncated:
            # page j is lookup-able iff fully prompt-filled; at least one
            # token always prefills (its logits give the first token)
            n_keys = (plen - 1) // ps
            shared = self.alloc.cache_lookup(
                [tuple(prompt[:(j + 1) * ps]) for j in range(n_keys)])
            chunk = self.ecfg.prefill_chunk
            while shared and (len(shared) * ps) % chunk:
                self.alloc.release(shared.pop())  # determinism trim
        need = n_req - len(shared) + (len(shared) if will_wrap else 0)
        if self.alloc.available() < need:
            for pid in shared:
                self.alloc.release(pid)
            return None
        fresh = self.alloc.alloc(need)
        reserve = fresh[n_req - len(shared):]
        fresh = fresh[:n_req - len(shared)]
        self.alloc.hits += len(shared)
        self.alloc.misses += 1 if n_keys > len(shared) else 0
        cacheable = self._prefix_reuse and not h.truncated and not will_wrap
        return prompt, shared, fresh, reserve, cacheable

    def _page_maintenance(self, copies=(), clear=()):
        """Apply the step's device-side page bookkeeping: COW copies
        (``pool[dst] = pool[src]``, one indexed copy per pool leaf across
        all layers), invalidation of freshly allocated pages (their
        ``pages_pos`` to -1: a recycled page's stale positions would
        otherwise pass the mask), and the push of the host page tables."""
        pool = self.state["pool"]
        if copies:
            dev = self.device
            src = torch.tensor([a for a, _ in copies], device=dev)
            dst = torch.tensor([b for _, b in copies], device=dev)
            for leaf in pool.values():
                leaf[:, dst] = leaf[:, src]
        if clear:
            pool["pages_pos"][:, torch.tensor(list(clear),
                                              device=self.device)] = -1
        self.state["table"].copy_(torch.from_numpy(self._tables))
        self._tables_dirty = False

    def _fork_writes(self, spans):
        """Copy-on-write, before the dispatch that writes: for each write
        span (slot, first position, token count), a touched logical page
        whose physical page is shared (ref > 1: held by the prefix cache
        and/or another slot) forks to this row's reserved target; readers
        keep the original bit for bit. Spans are worst case (a row may
        freeze mid-chunk): a wasted fork costs one page copy."""
        ps = self.ecfg.page_size
        copies = []
        for slot, start, n in spans:
            if n <= 0:
                continue
            for p in range(start // ps, (start + n - 1) // ps + 1):
                j = p % self._per_slot
                pid = int(self._tables[slot, j])
                if pid == 0 or self.alloc.ref[pid] <= 1:
                    continue
                new = self._reserve[slot].pop()
                self._tables[slot, j] = new
                self._tables_dirty = True
                copies.append((pid, new))
                self.alloc.release(pid)
                self.alloc.forks += 1
        if copies:
            self._page_maintenance(copies=copies)

    def _register_pages(self, finishers: List[int], row_ok):
        """Publish a finished prompt's fully written pages to the prefix
        cache, at prefill completion (the step that syncs for the first
        token anyway). A row whose completion logits are not finite never
        publishes: its pages must not splice into other requests."""
        ps = self.ecfg.page_size
        for i in finishers:
            if not self._cacheable[i]:
                continue
            if not row_ok[i]:
                self._cacheable[i] = False
                continue
            prompt = self._prompts[i]
            upto = min(self._cursor[i], len(prompt)) // ps
            for j in range(self._registered[i], upto):
                self.alloc.cache_insert(tuple(prompt[:(j + 1) * ps]),
                                        int(self._tables[i, j]))
            self._registered[i] = upto

    def cancel(self, handle: RequestHandle) -> bool:
        """Cancel a queued or resident request; False if already done."""
        if handle.done:
            return False
        try:
            self.queue.remove(handle)
        except ValueError:
            slot = next((i for i, h in enumerate(self.slots) if h is handle),
                        None)
            if slot is None:
                return False
            self._free_slot(slot)
        self._finish(handle, FINISH_CANCELLED, self._clock())
        return True

    def run(self, max_steps: int = 10_000) -> List[RequestHandle]:
        """Drive until queue + slots drain; returns the finished handles."""
        finished: List[RequestHandle] = []
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            finished.extend(self.step())
        return finished

    # ----------------------------------------------------------------- step
    def step(self) -> List[RequestHandle]:
        """Sweep deadlines, admit into all free slots, advance prefill one
        chunk, decode one chunk; returns the requests that finished this
        step (including those retired by the sweep or by containment)."""
        self.engine_steps += 1
        if self._injector is not None:
            self._injector.on_step(self)
        done_now = self._sweep_deadlines()
        self._auto_rehabilitate()
        self._admit()
        done_now = done_now + self._prefill_step()
        dec = [i for i in range(len(self.slots)) if self._decoding(i)]
        if not dec:
            return done_now
        remaining = max(self.slots[i].params.max_new_tokens
                        - len(self.slots[i].output) for i in dec)
        chunk = self.ecfg.decode_chunk
        if any(self._prefilling(i) for i in range(len(self.slots))):
            chunk = min(chunk, self.ecfg.decode_chunk_prefilling)
        n_steps = min(chunk, _pow2ceil(remaining))
        if self.paged:
            # decode writes positions pos..pos+n_steps-1 (worst case); a
            # wrapping row is about to overwrite its oldest pages, which
            # may be cache-shared prefix — fork them first (COW)
            self._fork_writes(
                [(i, len(self._prompts[i]) + len(self.slots[i].output) - 1,
                  n_steps) for i in dec])
            if self._tables_dirty:
                self._page_maintenance()
        poison = self._poison_array(n_steps) if self._injector is not None \
            else None
        try:
            self._guard_dispatch("decode", dec)
            toks, bad = self._decode_loop(n_steps, poison)
        except EngineCrash as exc:  # engine death escapes containment
            self._attribute_crash(exc, dec)
            raise
        except Exception as exc:  # containment unit: this dispatch only
            return done_now + self._contain("decode", dec, exc)
        self.steps += n_steps
        return done_now + self._collect(toks, bad)

    # ------------------------------------------------- deadlines / containment
    def _expired(self, h: RequestHandle, now: float) -> Optional[str]:
        p = h.params
        if p.deadline_s is not None and now - h.t_submit > p.deadline_s:
            return f"deadline_s={p.deadline_s} exceeded"
        if p.ttft_deadline_s is not None and not h.t_first \
                and now - h.t_submit > p.ttft_deadline_s:
            return f"ttft_deadline_s={p.ttft_deadline_s} exceeded"
        return None

    def _sweep_deadlines(self) -> List[RequestHandle]:
        """Retire every queued or resident request past its deadline with
        reason ``"timeout"``, keeping the tokens it produced. A freed slot
        is admissible in this very step; neighbours are untouched."""
        now = self._clock()
        out: List[RequestHandle] = []
        for h in list(self.queue):
            why = self._expired(h, now)
            if why is not None:
                self.queue.remove(h)
                h.error = why
                self._finish(h, FINISH_TIMEOUT, now)
                out.append(h)
        for slot, h in enumerate(self.slots):
            if h is None:
                continue
            why = self._expired(h, now)
            if why is not None:
                self._free_slot(slot)
                h.error = why
                self._finish(h, FINISH_TIMEOUT, now)
                out.append(h)
        return out

    def _poison_array(self, n_steps: int) -> np.ndarray:
        """(B,) int32: the generated-token index at which to NaN each row's
        logits, -1 = never (asked of the injector for every decoding row of
        a dispatch); it reaches the device with the loop's other inputs."""
        poison = np.full((len(self.slots),), -1, np.int32)
        for i, h in enumerate(self.slots):
            if not self._decoding(i):
                continue
            k = self._injector.poison_index(h.uid, len(h.output), n_steps)
            if k is not None:
                poison[i] = k
        return poison

    def _guard_dispatch(self, kind: str, slots: List[int]):
        """Count the dispatch and let the injector veto it (raising
        ``EngineFault``) before the device call, so the batch state is
        never half-written."""
        idx = self._dispatch_counts[kind]
        self._dispatch_counts[kind] = idx + 1
        if self._injector is not None:
            self._injector.before_dispatch(self, kind, idx, slots)

    def _attribute_crash(self, exc: EngineCrash, slots: List[int]) -> None:
        """Stamp an escaping ``EngineCrash`` with its suspects: the blamed
        uid when it is resident in the dying dispatch, else every row of
        the dispatch."""
        if exc.suspects:
            return
        uids = [self.slots[i].uid for i in slots if self.slots[i] is not None]
        if exc.uid is not None and exc.uid in uids:
            exc.suspects = (exc.uid,)
        else:
            exc.suspects = tuple(uids)

    def _contain(self, kind: str, slots: List[int],
                 exc: Exception) -> List[RequestHandle]:
        """Retire the request a failed dispatch names (an ``EngineFault``
        with a slot), or every request of the dispatch, and quarantine
        their slots. The failed dispatch was never applied, so surviving
        rows retry it untouched next step."""
        hit = getattr(exc, "slot", None)
        bad_slots = [hit] if hit is not None and hit in slots else list(slots)
        now = self._clock()
        out: List[RequestHandle] = []
        for slot in bad_slots:
            h = self.slots[slot]
            if h is None:
                continue
            self._free_slot(slot)
            self._quarantine(slot)
            h.error = f"{kind} dispatch failed: {exc!r}"
            self._finish(h, FINISH_ERROR, now)
            out.append(h)
        return out

    def _quarantine(self, slot: int):
        cool = self.ecfg.quarantine_steps
        until = (self.engine_steps + cool) if cool is not None else -1
        self.quarantined[slot] = until

    def _restore(self, slots: List[int]):
        mask = np.zeros((len(self.slots),), bool)
        mask[slots] = True
        self._reset_rows(mask, np.zeros((len(self.slots),), np.int32))
        for s in slots:
            self.quarantined.pop(s, None)
        self._slot_arrays = None

    def _auto_rehabilitate(self):
        """Return suspect slots whose cool-down elapsed to the pool, after
        a row reset (``quarantine_steps=None``: only ``rehabilitate()``)."""
        if self.ecfg.quarantine_steps is None:
            return
        due = [s for s, until in self.quarantined.items()
               if self.engine_steps >= until]
        if due:
            self._restore(due)

    def rehabilitate(self) -> List[int]:
        """Row-reset every quarantined slot and return it to the admission
        pool now; returns the slots restored."""
        back = sorted(self.quarantined)
        if back:
            self._restore(back)
        return back

    # ------------------------------------------------------------ internals
    def _prefilling(self, slot: int) -> bool:
        return (self.slots[slot] is not None
                and self._cursor[slot] < len(self._prompts[slot]))

    def _decoding(self, slot: int) -> bool:
        return (self.slots[slot] is not None
                and self._cursor[slot] >= len(self._prompts[slot]))

    def _free_slot(self, slot: int):
        if self.paged and self.slots[slot] is not None:
            # every retirement (finish, cancel) comes through here, so pages
            # always return: table references drop (cache-held pages stay
            # at ref 1, evictable; private pages free at once), unused fork
            # reserves free, and the device table row is pushed stale-but-
            # harmless (free rows are fully masked) at the next maintenance
            for pid in self._tables[slot]:
                if pid:
                    self.alloc.release(int(pid))
            for pid in self._reserve[slot]:
                self.alloc.release(pid)
            self._reserve[slot] = []
            self._tables[slot, :] = 0
            self._registered[slot] = 0
            self._cacheable[slot] = False
            self._tables_dirty = True
        self.slots[slot] = None
        self._prompts[slot] = None
        self._cursor[slot] = 0
        self._slot_arrays = None

    def _finish(self, h: RequestHandle, reason: str, now: float):
        h.finish_reason = reason
        h.t_done = now
        if reason in (FINISH_STOP, FINISH_LENGTH):
            self.completed += 1
        elif reason == FINISH_CANCELLED:
            self.cancelled += 1
        elif reason == FINISH_TIMEOUT:
            self.timeouts += 1
        elif reason == FINISH_REJECTED:
            self.sheds += 1
        elif reason == FINISH_ERROR:
            self.errors += 1

    def _emit(self, h: RequestHandle, tok: int, now: float) -> bool:
        """Append a generated token; True if it finished the request."""
        h.output.append(tok)
        self.tokens_generated += 1
        if not h.t_first:
            h.t_first = now
        if tok in h._stop_ids:
            self._finish(h, FINISH_STOP, now)
        elif len(h.output) >= h.params.max_new_tokens:
            self._finish(h, FINISH_LENGTH, now)
        else:
            return False
        return True

    def _reset_rows(self, mask: np.ndarray, pos0: np.ndarray):
        """Clear the decode state of the rows in ``mask`` (new admissions),
        in place: row position to ``pos0`` (nonzero when a paged admission
        skips prefix-cached prompt pages), ring positions to -1 and KV to 0.
        The paged pool is physical storage owned by the allocator, not per
        row: ``_page_maintenance`` clears fresh pages and pushes the
        tables instead."""
        m = torch.as_tensor(mask, device=self.device)
        self.state["pos"] = torch.where(
            m, torch.as_tensor(pos0, device=self.device), self.state["pos"])
        if self.paged:
            return
        for cache in self.state["layers"]:
            for name, buf in cache.items():
                shaped = m.reshape((-1,) + (1,) * (buf.dim() - 1))
                buf.masked_fill_(shaped, -1 if name == "pos" else 0)

    def _admit(self):
        """Move queued requests into every free, non-quarantined slot.
        Under the paged
        layout a slot admits only when the queue head's worst-case page
        budget is reservable now; otherwise the head waits (strict FIFO:
        a shorter request behind it never jumps the line) until
        retirements return pages."""
        fresh = np.zeros((len(self.slots),), bool)
        pos0 = np.zeros((len(self.slots),), np.int32)
        clear: List[int] = []
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.queue \
                    or slot in self.quarantined:
                continue
            if self.paged:
                plan = self._plan_pages(self.queue[0])
                if plan is None:
                    break  # the head waits for pages; FIFO holds
                prompt, shared, fresh_pages, reserve, cacheable = plan
                h = self.queue.popleft()
                skip = len(shared) * self.ecfg.page_size
                ids = shared + fresh_pages
                self._tables[slot, :] = 0
                self._tables[slot, :len(ids)] = ids
                self._tables_dirty = True
                self._registered[slot] = len(shared)
                self._cacheable[slot] = cacheable
                self._reserve[slot] = reserve
                clear.extend(fresh_pages)
            else:
                h = self.queue.popleft()
                prompt, skip = list(h.prompt[-self.ecfg.capacity:]), 0
            self.slots[slot] = h
            self._prompts[slot] = prompt
            self._cursor[slot] = skip  # cache-hit tokens never prefill
            pos0[slot] = skip
            h.t_admit = self._clock()
            fresh[slot] = True
            self.admits += 1
        if fresh.any():
            self._reset_rows(fresh, pos0)
            if self.paged:
                self._page_maintenance(clear=clear)
            self._slot_arrays = None

    def _sample_first(self, logits, rows: List[int]) -> torch.Tensor:
        """Token 0 of every row in ``rows`` from its own stream (index 0),
        (B,) int32 on the device; other rows ride along greedy and are
        ignored."""
        nb = logits.shape[0]
        p = {i: self.slots[i].params for i in rows}
        temps = [p[i].temperature if i in p else 0.0 for i in range(nb)]
        seeds = [p[i].seed & 0xFFFFFFFF if i in p else 0 for i in range(nb)]
        tk = tp = None
        if any(p[i].needs_mask for i in rows):
            tk = torch.tensor([p[i].top_k if i in p else 0 for i in range(nb)],
                              dtype=torch.int32, device=self.device)
            tp = torch.tensor([p[i].top_p if i in p else 1.0
                               for i in range(nb)],
                              dtype=torch.float32, device=self.device)
        toks = sample_tokens_per_request(
            logits, torch.tensor(seeds, dtype=torch.int64, device=self.device),
            torch.zeros((nb,), dtype=torch.int32, device=self.device),
            torch.tensor(temps, dtype=torch.float32, device=self.device),
            top_k=tk, top_p=tp, draw=any(t > 0.0 for t in temps))
        return toks

    def _prefill_step(self) -> List[RequestHandle]:
        """Advance every mid-prompt slot by one bucketed chunk; rows whose
        prompt completes sample their first token here."""
        pf = [i for i in range(len(self.slots)) if self._prefilling(i)]
        if not pf:
            return []
        nb = len(self.slots)
        take = {i: min(len(self._prompts[i]) - self._cursor[i],
                       self.ecfg.prefill_chunk) for i in pf}
        length = _pow2ceil(max(take.values()))
        tokens = np.zeros((nb, length), np.int32)
        lengths = np.zeros((nb,), np.int32)
        for i in pf:
            c = self._cursor[i]
            tokens[i, :take[i]] = self._prompts[i][c:c + take[i]]
            lengths[i] = take[i]
        if self.paged:
            # prefill writes only this row's private, unregistered pages
            # (the skip starts past the shared prefix and registration
            # trails the cursor), so these are no-ops — kept as the single
            # COW choke point before every write dispatch
            self._fork_writes([(i, self._cursor[i], take[i]) for i in pf])
            if self._tables_dirty:
                self._page_maintenance()
        try:
            self._guard_dispatch("prefill", pf)
            logits, self.state = prefill_chunk(
                self.model, self.cfg, self.state,
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(lengths).to(self.device))
        except EngineCrash as exc:  # engine death escapes containment
            self._attribute_crash(exc, pf)
            raise
        except Exception as exc:  # cursors untouched: survivors retry as-is
            return self._contain("prefill", pf, exc)
        self.prefill_steps += 1
        self.prefill_tokens += int(lengths.sum())
        finishers = [i for i in pf
                     if self._cursor[i] + take[i] >= len(self._prompts[i])]
        for i in pf:
            self._cursor[i] += take[i]
        if not finishers:
            return []
        if self._injector is not None:
            # token 0's logits can be poisoned too (gen index 0 lives here,
            # not in the decode loop); row-local, so co-batched rows keep
            # their exact logits
            for i in finishers:
                if self._injector.poison_index(self.slots[i].uid, 0, 1) == 0:
                    logits[i] = float("nan")
        # non-finite logits are contained before any token is kept: the
        # row's flag rides the first-token sync (one .cpu() for both)
        row_ok = torch.isfinite(logits).all(dim=-1)
        toks, row_ok = torch.stack(
            [self._sample_first(logits, finishers),
             row_ok.to(torch.int32)]).cpu().numpy()
        if self.paged:
            self._register_pages(finishers, row_ok)
        now = self._clock()
        finished: List[RequestHandle] = []
        for i in [i for i in finishers if not row_ok[i]]:
            h = self.slots[i]
            self._free_slot(i)
            self._quarantine(i)
            h.error = "non-finite logits at prefill completion"
            self._finish(h, FINISH_ERROR, now)
            finished.append(h)
        for i in [i for i in finishers if row_ok[i]]:
            h = self.slots[i]
            if self._emit(h, int(toks[i]), now):
                finished.append(h)
                self._free_slot(i)
            else:
                self.last_tokens[i] = int(toks[i])
                self._slot_arrays = None
        return finished

    def _fleet_arrays(self):
        """Per-slot device tensors for the decode loop, cached until the
        fleet changes: (temps, active, seeds, top_k, top_p, stops) and the
        host flags (masked, draw): any row with top-k/top-p, any row with
        temperature > 0."""
        if self._slot_arrays is None:
            nb = len(self.slots)
            temps = np.zeros((nb,), np.float32)
            seeds = np.zeros((nb,), np.int64)
            top_k = np.zeros((nb,), np.int32)
            top_p = np.ones((nb,), np.float32)
            stop_sets: List[List[int]] = [[] for _ in range(nb)]
            masked = False
            for i in range(nb):
                if not self._decoding(i):
                    continue
                p = self.slots[i].params
                temps[i] = p.temperature
                seeds[i] = p.seed & 0xFFFFFFFF
                top_k[i] = p.top_k
                top_p[i] = p.top_p
                stop_sets[i] = sorted(self.slots[i]._stop_ids)
                masked |= p.needs_mask
            width = _pow2ceil(max(1, max(len(s) for s in stop_sets)))
            stops = np.full((nb, width), -1, np.int32)
            for i, s in enumerate(stop_sets):
                stops[i, :len(s)] = s
            active = np.asarray([self._decoding(i) for i in range(nb)])
            dev = self.device
            self._slot_arrays = tuple(
                torch.from_numpy(a).to(dev)
                for a in (temps, active, seeds, top_k, top_p, stops)
            ) + (masked, bool((temps > 0.0).any()))
        return self._slot_arrays

    def _decode_loop(self, n_steps: int, poison: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """K decode steps with on-device sampling and stop-freezing: one
        copy of the inputs to the device, one host sync at the end. Returns
        (K, B) sampled tokens and (K, B) flags, True where the row's logits
        for that step were not all finite (such a row freezes; the host
        retires it).

        ``poison`` ((B,) int32, -1 = never; given only by an engine with a
        fault injector) NaNs a row's logits on the device when its
        generated-token index equals it."""
        temps, active, seeds, top_k, top_p, stops, masked, draw = \
            self._fleet_arrays()
        nb = len(self.slots)
        gen = np.asarray([len(self.slots[i].output) if self._decoding(i)
                          else 0 for i in range(nb)], np.int32)
        rows = [self.last_tokens, gen] + ([] if poison is None else [poison])
        inputs = torch.from_numpy(np.stack(rows)).to(self.device)
        tok, gen = inputs[0], inputs[1]
        if poison is not None:
            poison = inputs[2]
        out = []
        for _ in range(n_steps):
            logits, self.state = decode_step(self.model, self.cfg, self.state,
                                             tok, active)
            if poison is not None:
                logits = torch.where(((gen == poison) & active)[:, None],
                                     float("nan"), logits)
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            nxt = sample_tokens_per_request(
                logits, seeds, gen, temps, top_k=top_k if masked else None,
                top_p=top_p if masked else None, draw=draw)
            nxt = torch.where(active, nxt, tok)  # frozen rows repeat
            gen = gen + active.to(gen.dtype)
            hit = (nxt[:, None] == stops).any(dim=-1)
            # a non-finite row freezes too: its state is garbage from here
            active = active & ~(hit | bad)
            out += [nxt, bad.to(nxt.dtype)]
            tok = nxt
        flat = torch.stack(out).cpu().numpy()  # the dispatch's one sync
        return flat[0::2], flat[1::2].astype(bool)

    def _collect(self, toks: np.ndarray,
                 bad: np.ndarray) -> List[RequestHandle]:
        """Fold a (K, B) chunk of tokens into the decoding requests; a slot
        stops at its first stop token or at its budget. A step flagged in
        ``bad`` keeps no token: the request retires ``"error"`` and the
        slot is quarantined."""
        finished = []
        now = self._clock()
        for slot, h in enumerate(self.slots):
            if h is None or not self._decoding(slot):
                continue
            for k in range(toks.shape[0]):
                if bad[k, slot]:
                    self._free_slot(slot)
                    self._quarantine(slot)
                    h.error = (f"non-finite logits at generated token "
                               f"{len(h.output)}")
                    self._finish(h, FINISH_ERROR, now)
                    finished.append(h)
                    break
                tok = int(toks[k, slot])
                self.last_tokens[slot] = tok
                if self._emit(h, tok, now):
                    finished.append(h)
                    self._free_slot(slot)
                    break
        return finished

