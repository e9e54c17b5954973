"""Continuous-batching serving engine (the reference's
``repro.serving.engine``: ``ServingEngine`` and ``SerialAdmitEngine``, same
scheduling and field names), over the ring or the paged KV layout.

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
chunks. Decode runs ``K`` ``decode_step``s with sampling, stop-freezing and
``active`` kept on the device, and one host sync per K-step dispatch.

The compiled dispatches (the reference's jit caches): on the card every
dispatch is a CUDA graph (``serving.graphs``), captured at its key's first
use and replayed on the engine's one stream from then on, all graphs in one
memory pool. ``_loop_cache`` holds one K-step decode loop per
``(n_steps, use_mask, stop_w, use_poison, draw)`` (the reference's key and
the port's threefry-draw flag), ``_prefill_cache`` one prefill per
power-of-two bucket; ``warmup()`` captures them all, ``compile_stats()``
and ``memory_stats()`` report them as the reference does. A decode
dispatch's inputs reach the device in one non-blocking copy from pinned
memory and its tokens and finite flags come back in one copy: one host
sync. On the CPU the caches hold the eager bodies under the same keys.

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

Observability (the reference's v1.3): every engine carries an
``Observability`` bundle (``serving.observability``): the frozen metric
registry polled from the engine's own counters, one span per engine phase
(the decode dispatch and its sync apart) and the request lifecycle on the
trace when tracing is on, all host-side around the dispatches; ``health()``
reads the registry.

Threads (the concurrent frontend, ``serving.frontend``): the engine is
single-threaded, and after ``EngineDriver.start()`` the driver's thread is
its only caller; nothing in it depends on which thread that is (the stream
it works on is entered per step, and the host syncs wait on that stream).
A capture that fails or a replay that raises is a ``GraphFailure``, which
escapes containment like an ``EngineCrash``: under a supervisor the engine
is rebuilt. ``abandon()`` (a supervisor's reap) stops a dead engine's
thread at its next dispatch, and on the card each engine holds a stream no
other live engine has, so even a thread that is mid-dispatch never
launches onto a newer generation's stream.

``EngineConfig.attn_backend`` replaces the model config's attention route
for every dispatch (``kernels.chunk_attention``: auto | pallas | stream |
materialized). ``preunpack_decode`` serves from a copy of the model whose
trit-planes are raw int8 trits, unpacked once at init (the plain grouped
route reads them with the same bits as the packed form); None turns it on
where the plain route serves the matmuls anyway (the CPU) and off on the
card, where the ternary kernels unpack in the kernel. The caller's model
keeps its packed planes either way.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import itertools
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.packing import unpack_trits
from repro_torch.kernels.chunk_attention.ops import (BACKENDS,
                                                     reserve_workspace,
                                                     resolve_chunk_backend)
from repro_torch.models import (decode_step, init_decode_state, prefill,
                                prefill_chunk)
from repro_torch.models.transformer import has_attention, is_recurrent
from repro_torch.runtime import clock as rtclock
from repro_torch.runtime.monitor import HealthSnapshot
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_ERROR,
                                     FINISH_LENGTH, FINISH_REJECTED,
                                     FINISH_STOP, FINISH_TIMEOUT,
                                     RequestHandle, SamplingParams,
                                     make_handle)
from repro_torch.serving.graphs import (EagerDispatch, GraphDispatch,
                                        GraphFailure, claim_stream, fetch,
                                        upload)
from repro_torch.serving.observability import TRACK_ENGINE, Observability
from repro_torch.serving.paging import PageAllocator
from repro_torch.serving.sampling import sample_tokens_per_request

__all__ = ["EngineConfig", "ServingEngine", "SerialAdmitEngine",
           "SamplingParams", "RequestHandle", "EngineFault", "EngineCrash"]

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
    """Engine-wide knobs; per-request behavior lives in ``SamplingParams``.

    ``attn_backend`` (None: the model config's) overrides the attention
    route of every dispatch; ``preunpack_decode`` (None: on where the plain
    grouped matmul serves, the CPU) serves raw int8 trit-planes (module
    docstring)."""

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
        if self.attn_backend is not None and self.attn_backend not in BACKENDS:
            raise ValueError(f"unknown chunk-attention backend "
                             f"{self.attn_backend!r} (one of {BACKENDS})")


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _preunpacked(model):
    """A copy of ``model``'s module tree that shares every tensor but the
    trit-planes, which it holds unpacked: int8 trits (n, d) where the
    model has packed uint8 (n, d/4), served by the plain grouped route,
    which each copied layer asks for by name. The model itself is left as
    it was."""
    shared = itertools.chain(
        model.parameters(), model.buffers(),
        (v for m in model.modules() for v in vars(m).values()
         if isinstance(v, torch.Tensor)))
    serve = copy.deepcopy(model, {id(t): t for t in shared})
    for m in serve.modules():
        if getattr(m, "t1p", None) is not None:
            m.t1p, m.t2p = unpack_trits(m.t1p), unpack_trits(m.t2p)
            m.matmul_backend = "grouped"
    return serve


def _plane_bytes(model) -> int:
    return sum(int(m.t1p.nbytes) + int(m.t2p.nbytes) for m in model.modules()
               if getattr(m, "t1p", None) is not None)


class ServingEngine:
    """Bucketed/chunked-prefill scheduler behind the v1 handle API.

    ``injector`` (optional) implements the ``serving.faults.FaultInjector``
    protocol: it may substitute the engine's clock, raise from a chosen
    dispatch and poison chosen rows' logits with NaN on the device. A
    production engine passes None and its decode loop has no poison
    operation.

    ``observability`` (optional) is a ``serving.observability.
    Observability`` bundle; the engine always carries one (a registry-only
    default when none is given), puts it on its own clock and registers the
    frozen serving metrics against its counters. ``Observability(
    trace=True)`` also records the lifecycle and phase trace. All of it is
    host-side around the dispatches: tokens are bit-identical with tracing
    on, off or unconfigured, and no graph-cache axis is added.

    It serves token ids: a model whose config has a stub frontend
    (``embed_inputs`` False) is refused with a ValueError (the reference's
    engine admits it and fails each request's prefill dispatch)."""

    def __init__(self, model, model_cfg, engine_cfg: EngineConfig, *,
                 injector=None, observability: Optional[Observability] = None):
        if not model_cfg.embed_inputs:
            raise ValueError(f"{model_cfg.name} has a stub modality "
                             "frontend; the engine serves token ids")
        self.model = model
        if engine_cfg.attn_backend is not None:
            model_cfg = dataclasses.replace(
                model_cfg, attn_backend=engine_cfg.attn_backend)
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = model.embed.device
        pre = engine_cfg.preunpack_decode
        if pre is None:  # the plain grouped matmul serves on the CPU only
            pre = self.device.type == "cpu"
        self.preunpack_decode = pre
        # what every dispatch reads: built before anything is captured
        self._serve_model = _preunpacked(model) if pre else model
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
            # prefix reuse splices cached KV pages under a later request:
            # sound only when attention is the only stateful mixer (a
            # recurrent rwkv/rglru state summarizes every prior token and
            # cannot skip the shared prefix), so it turns off otherwise,
            # as in the reference
            attn_only = not any(map(is_recurrent, model_cfg.layer_kinds))
            self._prefix_reuse = engine_cfg.prefix_cache and attn_only
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
        # the compiled dispatches: decode loops keyed (n_steps, use_mask,
        # stop_w, use_poison, draw), prefills keyed by bucket (the serial
        # baseline: by prompt length)
        self._loop_cache: Dict[Tuple[int, bool, int, bool, bool], Any] = {}
        self._prefill_cache: Dict[int, Any] = {}
        # on the card: one stream for every dispatch of this engine (no
        # other live engine's), one memory pool for its graphs, and the
        # attention scratch sized for its largest call before anything is
        # captured (dropped with the engine). _capture = False runs the same
        # bodies eagerly (the eager-vs-graph comparison).
        self._stream = self._pool = None
        self._capture = self.device.type == "cuda"
        if self._capture:
            self._stream = claim_stream(self, self.device)
            self._pool = torch.cuda.graph_pool_handle()
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            kv = model_cfg.n_kv_heads
            # rwkv6 reads no KV; the plain attention twins need no scratch
            if has_attention(model_cfg) and resolve_chunk_backend(
                    model_cfg.attn_backend, self.device) == "pallas":
                reserve_workspace(self.device, self._stream, nb, kv,
                                  model_cfg.n_heads // kv,
                                  model_cfg.head_dim, engine_cfg.capacity,
                                  _pow2ceil(engine_cfg.prefill_chunk))
        self._prompts: List[Optional[List[int]]] = [None] * nb
        self._cursor: List[int] = [0] * nb
        self._admit_finished: List[RequestHandle] = []
        self._slot_arrays = None  # fleet arrays; None → slots changed
        self._next_uid = 0
        self.steps = 0            # decode steps dispatched
        self.prefill_steps = 0    # prefill_chunk dispatches
        self.admits = 0
        # ---- fault containment / admission control state
        self._injector = injector
        self._abandoned = False   # abandon(): no further device work
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
        # ---- observability (registry always on; tracing only when asked)
        self.submitted = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.obs = observability if observability is not None \
            else Observability()
        # the engine's clock (a VirtualClock under an injector) stamps the
        # bundle's spans and histogram observations too
        self.obs.clock = self._clock
        self.obs.bind_engine(self)

    @property
    def clock(self):
        """The engine's injectable clock (``runtime.clock`` duck type; a
        ``VirtualClock`` under a fault injector). Frontend layers stamp
        their timestamps through this so every layer shares one time
        base."""
        return self._clock

    def abandon(self) -> None:
        """Give the engine up (a supervisor has replaced it): from now on a
        step raises ``EngineCrash`` before its next dispatch, so a thread
        that wakes inside a step of the dead engine reaches the device no
        more."""
        self._abandoned = True

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the block on the engine's stream (on the card), ordered after
        the caller's stream and before what the caller runs next."""
        if self._stream is None:
            yield
            return
        outer = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(outer)
        with torch.cuda.stream(self._stream):
            yield
        outer.wait_stream(self._stream)

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
        self.obs.request_submitted(h)
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
        otherwise pass the mask), and the push of the host page tables,
        eager and before the dispatch, with no host sync (the ids and the
        tables go by non-blocking copies from pinned memory)."""
        pool = self.state["pool"]
        with self.obs.span("page_maint",
                           args={"copies": len(copies), "clear": len(clear)}):
            if copies or clear:
                n = len(copies)
                ids = upload(np.asarray([a for a, _ in copies]
                                        + [b for _, b in copies]
                                        + list(clear), np.int64), self.device)
                for leaf in pool.values() if copies else ():
                    leaf[:, ids[n:2 * n]] = leaf[:, ids[:n]]
                if clear:
                    pool["pages_pos"][:, ids[2 * n:]] = -1
            self.state["table"].copy_(upload(self._tables, self.device))
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

    # ------------------------------------------------ compiled dispatches
    def warmup(self):
        """Capture every dispatch the engine can need (the reference's
        warmup, which compiles them): the prefill buckets (powers of two up
        to ``prefill_chunk``) and the decode chunks (powers of two up to
        ``decode_chunk``, and ``decode_chunk_prefilling``), each unmasked
        and with top-k/top-p, each with and without the threefry draw.
        Stop-set widths over 1 are still captured at first use. Every warm
        call is a no-op on the live state (rows of length 0, inactive
        rows), so warmup may run at any point of the engine's life."""
        with self._on_stream():
            self._warm_prefill()
            nb = len(self.slots)
            k = self.ecfg.decode_chunk
            chunks = {min(k, n) for n in self._bucket_lengths(k)}
            chunks.add(min(k, self.ecfg.decode_chunk_prefilling))
            use_poison = self._injector is not None
            idle = self._decode_input(np.zeros((nb,), np.int32),
                                      np.full((nb,), -1, np.int32),
                                      self._idle_arrays(1))
            for n in sorted(chunks):
                for masked in (False, True):
                    for draw in (False, True):
                        self._loop_fn(n, masked, 1, use_poison, draw)(idle)
            self._reset_rows(np.zeros((nb,), bool), np.zeros((nb,), np.int32))

    def _warm_prefill(self):
        nb = len(self.slots)
        for length in self._bucket_lengths(self.ecfg.prefill_chunk):
            self._prefill_fn(length)(self._prefill_input(
                np.zeros((nb, length), np.int32), np.zeros((nb,), np.int32)))

    @staticmethod
    def _bucket_lengths(top: int) -> List[int]:
        out = [1]
        while out[-1] < _pow2ceil(top):
            out.append(out[-1] * 2)
        return out

    def compile_stats(self) -> Dict[str, Any]:
        """Occupancy of the dispatch caches (the reference's fields). The
        prefill entries are power-of-two buckets <= prefill_chunk, so
        ``n_prefill_compiles`` is bounded by ``prefill_bucket_bound`` =
        log2(next_pow2(prefill_chunk)) + 1; the decode entries are (chunk
        length, masked sampling, stop-width bucket, poison) keys, plus the
        port's draw flag. The serial baseline caches one prefill per prompt
        length instead. On the card each entry is one captured graph."""
        return {
            "prefill_bucket_lengths": sorted(self._prefill_cache),
            "n_prefill_compiles": len(self._prefill_cache),
            "prefill_bucket_bound":
                _pow2ceil(self.ecfg.prefill_chunk).bit_length(),
            "decode_chunk_lengths": sorted({k[0] for k in self._loop_cache}),
            "n_decode_compiles": len(self._loop_cache),
            "admits": self.admits,
            "prefill_steps": self.prefill_steps,
        }

    def graph_stats(self) -> Dict[str, Any]:
        """Per compiled dispatch: its kind and key, the seconds its capture
        took (0 for an eager body), its replays (calls) and the kernel
        launches each replay runs."""
        rows = [("prefill", k, d) for k, d in sorted(self._prefill_cache.items())]
        rows += [("decode", k, d) for k, d in sorted(self._loop_cache.items())]
        out = [dict(kind=kind, key=key, graph=isinstance(d, GraphDispatch),
                    capture_s=d.capture_s, replays=d.replays,
                    launches=sum(d.launches.values())) for kind, key, d in rows]
        return {"dispatches": out,
                "capture_s": sum(r["capture_s"] for r in out)}

    def memory_stats(self) -> Dict[str, Any]:
        """Resident serving-state bytes (the reference's fields). With
        ``preunpack_decode`` the served planes are int8 trits, so
        ``resident_plane_bytes`` is 4× ``packed_plane_bytes`` (the model's);
        ``param_bytes`` counts the served copy. ``decode_state_bytes`` is
        the live batch state (KV rings or pool, positions, page table)."""
        packed = _plane_bytes(self.model)
        resident = _plane_bytes(self._serve_model)
        serve = self._serve_model
        param_bytes = sum(int(t.nbytes) for t in serve.parameters()) \
            + sum(int(t.nbytes) for t in serve.buffers())
        state_bytes = sum(int(t.nbytes) for t in self._state_leaves())
        out = {
            "preunpack_decode": self.preunpack_decode,
            "packed_plane_bytes": packed,
            "resident_plane_bytes": resident,
            "preunpack_ratio": (resident / packed) if packed else 1.0,
            "param_bytes": param_bytes,
            "decode_state_bytes": state_bytes,
            "resident_total_bytes": param_bytes + state_bytes,
            "kv_layout": self.ecfg.kv_layout,
        }
        out.update(self._kv_bytes())
        return out

    def _state_leaves(self) -> List[torch.Tensor]:
        """Every tensor of the decode state once (a paged attention layer's
        leaves are views of the pool and the shared table; a recurrent
        layer's are its own in either layout)."""
        if self.paged:
            return [self.state["pos"], self.state["table"],
                    *self.state["pool"].values(),
                    *(t for c in self.state["layers"] if "table" not in c
                      for t in c.values())]
        return [self.state["pos"]] + [t for c in self.state["layers"]
                                      for t in c.values()]

    def _kv_bytes(self) -> Dict[str, Any]:
        """KV bytes: the ring's whole allocation is resident per slot; a
        paged pool holds live KV only in used pages, so ``kv_resident_bytes``
        is what the requests cost. The port's pool has one scratch page
        more than the reference's and one table for all layers where the
        reference has one a layer: ``kv_page_bytes`` is equal, the pool's
        bytes differ by that page and those tables."""
        if not self.paged:  # the rings; recurrent states are not KV
            kv = sum(int(t.nbytes) for kind, c in zip(self.cfg.layer_kinds,
                                                      self.state["layers"])
                     if not is_recurrent(kind) for t in c.values())
            return {"kv_pool_bytes": kv, "kv_resident_bytes": kv}
        pool = self.state["pool"]
        pool_bytes = sum(int(t.nbytes) for t in pool.values())
        per_page = pool_bytes // pool["pages_pos"].shape[1]
        table_bytes = int(self.state["table"].nbytes)
        return {"kv_pool_bytes": pool_bytes + table_bytes,
                "kv_page_bytes": per_page,
                # used pages + the always-resident null page + the table
                "kv_resident_bytes":
                    per_page * (self.alloc.used_pages() + 1) + table_bytes}

    def _compile(self, body, idle: np.ndarray, warm=None):
        """The dispatch of ``body``: a CUDA graph on the card (captured now,
        after one eager no-op call of ``warm`` or ``body`` on ``idle``), the
        eager body on the CPU or with capture switched off."""
        if not self._capture:
            return EagerDispatch(body, self.device)
        return GraphDispatch(body, idle, device=self.device,
                             stream=self._stream, pool=self._pool, warm=warm)

    def _loop_fn(self, n_steps: int, use_mask: bool, stop_w: int,
                 use_poison: bool = False, draw: bool = False):
        key = (n_steps, use_mask, stop_w, use_poison, draw)
        if key not in self._loop_cache:
            nb = len(self.slots)
            idle = self._decode_input(np.zeros((nb,), np.int32),
                                      np.full((nb,), -1, np.int32),
                                      self._idle_arrays(stop_w))
            body = functools.partial(
                self._decode_body, use_mask=use_mask, stop_w=stop_w,
                use_poison=use_poison, draw=draw)
            self._loop_cache[key] = self._compile(
                functools.partial(body, n_steps=n_steps), idle,
                warm=functools.partial(body, n_steps=1))
        return self._loop_cache[key]

    def _prefill_fn(self, length: int):
        """One dispatch per power-of-two chunk bucket."""
        if length not in self._prefill_cache:
            self._prefill_cache[length] = self._compile(
                functools.partial(self._prefill_body, length=length),
                self._prefill_input(np.zeros((len(self.slots), length),
                                             np.int32),
                                    np.zeros((len(self.slots),), np.int32)))
        return self._prefill_cache[length]

    @staticmethod
    def _prefill_input(tokens: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """A prefill dispatch's one int32 input: lengths (B,), padded to 16
        bytes (the attention kernel reads them in 16-byte vectors), then
        the tokens (B, L)."""
        pad = -len(lengths) % 4
        return np.concatenate([lengths, np.zeros((pad,), np.int32),
                               tokens.reshape(-1)])

    def _prefill_body(self, inp: torch.Tensor, *, length: int):
        """``_prefill_input``'s layout in; the logits at each row's last
        token (B, V) out."""
        nb = len(self.slots)
        off = nb + -nb % 4
        logits, _ = prefill_chunk(self._serve_model, self.cfg, self.state,
                                  inp[off:].view(nb, length), inp[:nb])
        return logits

    # ----------------------------------------------------------------- step
    def step(self) -> List[RequestHandle]:
        """Sweep deadlines, admit into all free slots, advance prefill one
        chunk, decode one chunk; returns the requests that finished this
        step (including those retired by the sweep or by containment).

        The decode chunk adapts to the largest remaining token budget among
        decoding slots, rounded up to a power of two."""
        with self._on_stream():
            return self._step()

    def _step(self) -> List[RequestHandle]:
        obs = self.obs
        t_step0, tok0, churn0 = self._step_begin()
        self.engine_steps += 1
        if self._injector is not None:
            self._injector.on_step(self)
        self._check_abandoned()
        with obs.span("sweep"):
            done_now = self._sweep_deadlines()
            self._auto_rehabilitate()
        with obs.span("admit"):
            self._admit()
        done_now += self._admit_finished
        self._admit_finished = []
        done_now = done_now + self._prefill_step()
        dec = [i for i in range(len(self.slots)) if self._decoding(i)]
        if not dec:
            self._step_end(t_step0, tok0, churn0)
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
        except (EngineCrash, GraphFailure) as exc:  # engine death
            self._attribute_crash(exc, dec)
            raise
        except Exception as exc:  # containment unit: this dispatch only
            done_now = done_now + self._contain("decode", dec, exc)
            self._step_end(t_step0, tok0, churn0)
            return done_now
        self.steps += n_steps
        with obs.span("collect"):
            done_now = done_now + self._collect(toks, bad)
        self._step_end(t_step0, tok0, churn0)
        return done_now

    def _step_begin(self) -> Tuple[float, int, int]:
        churn = (self.alloc.allocs + self.alloc.releases) if self.paged else 0
        return self._clock(), self.tokens_generated, churn

    def _step_end(self, t0: float, tok0: int, churn0: int):
        """Per-step observations (always on, host arithmetic only): step
        duration, tokens delivered, page churn, and the enclosing "step"
        span when tracing."""
        obs = self.obs
        now = self._clock()
        obs.h_step.observe(now - t0)
        obs.h_tokens_step.observe(self.tokens_generated - tok0)
        if self.paged:
            obs.h_page_churn.observe(
                self.alloc.allocs + self.alloc.releases - churn0)
        if obs.trace is not None:
            obs.trace.complete("step", TRACK_ENGINE, t0, now, cat="engine",
                               args={"engine_step": self.engine_steps})

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
        self._check_abandoned()
        idx = self._dispatch_counts[kind]
        self._dispatch_counts[kind] = idx + 1
        if self._injector is not None:
            self._injector.before_dispatch(self, kind, idx, slots)

    def _check_abandoned(self):
        if self._abandoned:
            raise EngineCrash("engine abandoned: a newer generation serves "
                              "its requests")

    def _attribute_crash(self, exc, slots: List[int]) -> None:
        """Stamp an escaping ``EngineCrash`` (or a ``GraphFailure`` of the
        dispatch's capture or replay) with its suspects: the blamed
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
            with self._on_stream():
                self._restore(back)
        return back

    def health(self) -> HealthSnapshot:
        """Current engine health (``runtime.monitor.HealthSnapshot``):
        every field a read of the registry counters and gauges the
        observability bundle exports, so a snapshot and a metrics scrape
        never disagree."""
        reg = self.obs.registry
        pages = {}
        if self.paged:
            pages = dict(
                pages_free=reg.value("serving_pages_free"),
                pages_used=reg.value("serving_pages_used"),
                pages_shared=reg.value("serving_pages_shared"),
                prefix_hits=reg.value("serving_prefix_hits_total"),
                prefix_misses=reg.value("serving_prefix_misses_total"),
                prefix_evictions=reg.value("serving_prefix_evictions_total"))
        return HealthSnapshot(
            t=self._clock(), steps=self.steps,
            queue_depth=reg.value("serving_queue_depth"),
            resident=reg.value("serving_resident_slots"),
            free_slots=reg.value("serving_free_slots"),
            quarantined_slots=tuple(sorted(self.quarantined)),
            resident_tokens=reg.value("serving_resident_tokens"),
            completed=reg.value("serving_requests_completed_total"),
            cancelled=reg.value("serving_requests_cancelled_total"),
            sheds=reg.value("serving_requests_shed_total"),
            timeouts=reg.value("serving_requests_timeout_total"),
            errors=reg.value("serving_requests_error_total"),
            **pages)

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

    def _mark_first(self, h: RequestHandle, now: float):
        if not h.t_first:
            h.t_first = now
            self.obs.request_first_token(h)

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
        # every retirement comes through here: the one place the lifecycle
        # spans and the completion histograms are emitted
        self.obs.request_retired(h, h._slot)

    def _emit(self, h: RequestHandle, tok: int, now: float) -> bool:
        """Append a generated token; True if it finished the request."""
        h.output.append(tok)
        self.tokens_generated += 1
        self._mark_first(h, now)
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
        tables instead; a recurrent layer's per-row state is cleared in
        either layout (a reused slot must not start from the last request's
        state). Mask and positions reach the device in one non-blocking
        copy."""
        up = upload(np.stack([mask.astype(np.int32),
                              pos0.astype(np.int32)]), self.device)
        m = up[0] != 0
        pos = self.state["pos"]
        pos.copy_(torch.where(m, up[1], pos))
        for cache in self.state["layers"]:
            if "table" in cache:  # a paged attention layer: pool views
                continue
            for name, buf in cache.items():
                shaped = m.reshape((-1,) + (1,) * (buf.dim() - 1))
                buf.masked_fill_(shaped, -1 if name == "pos" else 0)

    def _admit(self):
        """Move queued requests into every free, non-quarantined slot.
        Under the paged layout a slot admits only when the queue head's
        worst-case page budget is reservable now; otherwise the head waits
        (strict FIFO: a shorter request behind it never jumps the line)
        until retirements return pages."""
        fresh = np.zeros((len(self.slots),), bool)
        pos0 = np.zeros((len(self.slots),), np.int32)
        clear: List[int] = []
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.queue \
                    or slot in self.quarantined:
                continue
            page_args = None
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
                page_args = {"pages_shared": len(shared),
                             "pages_fresh": len(fresh_pages),
                             "pages_reserved": len(reserve)}
            else:
                h = self.queue.popleft()
                prompt, skip = list(h.prompt[-self.ecfg.capacity:]), 0
            self.slots[slot] = h
            self._prompts[slot] = prompt
            self._cursor[slot] = skip  # cache-hit tokens never prefill
            pos0[slot] = skip
            h.t_admit = self._clock()
            h._slot = slot
            self.obs.request_admitted(h, slot, pages=page_args)
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
        ignored. The rows' parameters go to the device in one copy."""
        nb = logits.shape[0]
        p = {i: self.slots[i].params for i in rows}
        temps = np.asarray([p[i].temperature if i in p else 0.0
                            for i in range(nb)], np.float32)
        seeds = np.asarray([p[i].seed & 0xFFFFFFFF if i in p else 0
                            for i in range(nb)], np.uint32)
        top_k = np.asarray([p[i].top_k if i in p else 0 for i in range(nb)],
                           np.int32)
        top_p = np.asarray([p[i].top_p if i in p else 1.0
                            for i in range(nb)], np.float32)
        up = upload(np.stack([temps.view(np.int32), seeds.view(np.int32),
                              top_k, top_p.view(np.int32)]), self.device)
        masked = any(p[i].needs_mask for i in rows)
        return sample_tokens_per_request(
            logits, up[1], torch.zeros_like(up[2]),
            up[0].view(torch.float32), top_k=up[2] if masked else None,
            top_p=up[3].view(torch.float32) if masked else None,
            draw=bool((temps > 0.0).any()))

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
        obs = self.obs
        t_pf0 = self._clock()
        try:
            self._guard_dispatch("prefill", pf)
            with obs.span("prefill_dispatch",
                          args={"bucket": length, "rows": len(pf)}):
                logits = self._prefill_fn(length)(
                    self._prefill_input(tokens, lengths))
        except (EngineCrash, GraphFailure) as exc:  # engine death
            self._attribute_crash(exc, pf)
            raise
        except Exception as exc:  # cursors untouched: survivors retry as-is
            return self._contain("prefill", pf, exc)
        t_pf1 = self._clock()
        obs.h_prefill_chunk.observe(t_pf1 - t_pf0)
        self.prefill_steps += 1
        self.prefill_tokens += int(lengths.sum())
        finishers = [i for i in pf
                     if self._cursor[i] + take[i] >= len(self._prompts[i])]
        for i in pf:
            self._cursor[i] += take[i]
            obs.prefill_chunk(self.slots[i], i, t_pf0, t_pf1, take[i],
                              self._cursor[i])
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
        # row's flag rides the first-token sync (one copy back for both)
        with obs.span("prefill_sync"):
            row_ok = torch.isfinite(logits).all(dim=-1)
            toks, row_ok = fetch(torch.stack(
                [self._sample_first(logits, finishers),
                 row_ok.to(torch.int32)]))
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
        finishers = [i for i in finishers if row_ok[i]]
        if not finishers:
            return finished
        with obs.span("sample_collect", args={"rows": len(finishers)}):
            for i in finishers:
                h = self.slots[i]
                if self._emit(h, int(toks[i]), now):
                    finished.append(h)
                    self._free_slot(i)
                else:
                    self.last_tokens[i] = int(toks[i])
                    self._slot_arrays = None
        return finished

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

    def _fleet_arrays(self):
        """Per-slot host arrays of the decode dispatch, cached until the
        fleet changes: (temps, active, seeds, top_k, top_p, stops) and the
        static flags of the loop's key: masked (any row with top-k/top-p),
        the stop-set width bucket, and draw (any row at temperature > 0)."""
        if self._slot_arrays is None:
            nb = len(self.slots)
            temps = np.zeros((nb,), np.float32)
            seeds = np.zeros((nb,), np.uint32)
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
            self._slot_arrays = ((temps, active, seeds, top_k, top_p, stops),
                                 masked, width, bool((temps > 0.0).any()))
        return self._slot_arrays

    def _idle_arrays(self, stop_w: int):
        """Fleet arrays of a dispatch with no active row."""
        nb = len(self.slots)
        return (np.zeros((nb,), np.float32), np.zeros((nb,), bool),
                np.zeros((nb,), np.uint32), np.zeros((nb,), np.int32),
                np.ones((nb,), np.float32), np.full((nb, stop_w), -1,
                                                    np.int32))

    def _decode_input(self, gen: np.ndarray, poison: np.ndarray,
                      arrays) -> np.ndarray:
        """The decode loop's one int32 input (``_decode_body``'s layout):
        rows of B for the last tokens, the generated counts, the poison
        indices, temperatures (f32 bits), active, seeds (u32 bits), top-k,
        top-p (f32 bits), then the (B, W) stop sets."""
        temps, active, seeds, top_k, top_p, stops = arrays
        return np.concatenate([
            self.last_tokens.astype(np.int32), gen, poison,
            temps.view(np.int32), active.astype(np.int32),
            seeds.view(np.int32), top_k, top_p.view(np.int32),
            stops.reshape(-1)])

    def _decode_body(self, inp: torch.Tensor, *, n_steps: int,
                     use_mask: bool, stop_w: int, use_poison: bool,
                     draw: bool) -> torch.Tensor:
        """K decode steps with on-device sampling and stop-freezing over the
        input of ``_decode_input``; returns (2K, B) int32: step k's sampled
        tokens in row 2k, its non-finite flags in row 2k + 1. A flagged row
        freezes (its state is garbage from there; the host retires it).
        With ``use_poison`` a row's logits turn NaN when its generated-token
        index equals its poison index (an engine with an injector only)."""
        nb = len(self.slots)
        rows = inp[:8 * nb].view(8, nb)
        tok, gen, poison = rows[0], rows[1], rows[2]
        temps, top_p = rows[3].view(torch.float32), rows[7].view(torch.float32)
        active, seeds, top_k = rows[4] != 0, rows[5], rows[6]
        stops = inp[8 * nb:].view(nb, stop_w)
        out = []
        for _ in range(n_steps):
            logits, _ = decode_step(self._serve_model, self.cfg, self.state,
                                    tok, active)
            if use_poison:
                logits = torch.where(((gen == poison) & active)[:, None],
                                     float("nan"), logits)
            bad = active & ~torch.isfinite(logits).all(dim=-1)
            nxt = sample_tokens_per_request(
                logits, seeds, gen, temps, top_k=top_k if use_mask else None,
                top_p=top_p if use_mask else None, draw=draw)
            nxt = torch.where(active, nxt, tok)  # frozen rows repeat
            gen = gen + active.to(gen.dtype)
            hit = (nxt[:, None] == stops).any(dim=-1)
            # a non-finite row freezes too: its state is garbage from here
            active = active & ~(hit | bad)
            out += [nxt, bad.to(nxt.dtype)]
            tok = nxt
        return torch.stack(out)

    def _decode_loop(self, n_steps: int, poison: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One K-step decode dispatch: its inputs to the device in one copy,
        the loop (a graph replay on the card), one host sync for its
        outputs. Returns (K, B) sampled tokens and (K, B) non-finite flags.

        ``poison`` ((B,) int32, -1 = never; given only by an engine with a
        fault injector) selects the loop variant that NaNs a row's logits
        on the device when its generated-token index equals it."""
        arrays, masked, stop_w, draw = self._fleet_arrays()
        nb = len(self.slots)
        gen = np.asarray([len(self.slots[i].output) if self._decoding(i)
                          else 0 for i in range(nb)], np.int32)
        inp = self._decode_input(
            gen, np.full((nb,), -1, np.int32) if poison is None else poison,
            arrays)
        with self.obs.span("decode_dispatch",
                           args={"n_steps": n_steps,
                                 "rows": int(arrays[1].sum())}):
            out = self._loop_fn(n_steps, masked, stop_w, poison is not None,
                                draw)(inp)
        with self.obs.span("decode_sync"):
            flat = fetch(out)  # the dispatch's one host sync
        return flat[0::2].copy(), flat[1::2].astype(bool)

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


class SerialAdmitEngine(ServingEngine):
    """The reference's serial-admit baseline: each arriving request is
    prefilled alone, through ``models.prefill`` into a private one-row ring
    state, with one compiled dispatch per distinct prompt length (a CUDA
    graph on the card; up to ``capacity`` of them), and merged into its
    slot; the decode fleet waits while the queue's prompts are consumed one
    by one. Decode is ``ServingEngine``'s, and the prompt walks the same
    ``prefill_chunk`` boundaries as there, so a request's tokens are equal
    on both engines. Ring layout only, as in the reference."""

    def __init__(self, model, model_cfg, engine_cfg: EngineConfig, *,
                 injector=None, observability: Optional[Observability] = None):
        if engine_cfg.kv_layout != "ring":
            raise ValueError(
                "SerialAdmitEngine prefills through prefill() into a "
                "private ring state and merges it by slot — the paged "
                "layout is a bucketed-scheduler feature; use "
                "kv_layout='ring' here")
        super().__init__(model, model_cfg, engine_cfg, injector=injector,
                         observability=observability)
        with self._on_stream():
            self._one = init_decode_state(model_cfg, 1, engine_cfg.capacity,
                                          device=self.device)

    def _warm_prefill(self):
        # the power-of-two prompt lengths only: any other length is still
        # captured at its first admission, the cost this baseline shows
        for length in self._bucket_lengths(self.ecfg.capacity):
            if length > self.ecfg.capacity:
                break
            self._prefill_len_fn(length)(np.zeros((length,), np.int32))

    def _prefill_len_fn(self, length: int):
        """One dispatch per distinct prompt length (prompts are clipped to
        ``capacity`` at admission, which bounds the cache)."""
        if length not in self._prefill_cache:
            self._prefill_cache[length] = self._compile(
                functools.partial(self._serial_body, length=length),
                np.zeros((length,), np.int32))
        return self._prefill_cache[length]

    def _serial_body(self, inp: torch.Tensor, *, length: int):
        logits, _ = prefill(self._serve_model, self.cfg, inp.view(1, length),
                            self.ecfg.capacity, chunk=self.ecfg.prefill_chunk,
                            state=self._one)
        return logits

    def _merge(self, slot: int):
        """Write the private state into row ``slot`` of the batch state:
        every leaf of every layer (ring KV and positions, recurrent states)
        has the row first."""
        self.state["pos"][slot:slot + 1].copy_(self._one["pos"])
        for dst, src in zip(self.state["layers"], self._one["layers"]):
            for name, buf in dst.items():
                buf[slot:slot + 1].copy_(src[name])

    def _first_token(self, logits, p: SamplingParams):
        """Token 0 of one batch-1 logits row and its finite flag, in one
        copy back; row-wise sampling is batch-size-invariant, so this
        equals the bucketed engine's fleet dispatch."""
        up = upload(np.asarray([np.float32(p.temperature).view(np.int32),
                                np.uint32(p.seed & 0xFFFFFFFF).view(np.int32),
                                p.top_k, np.float32(p.top_p).view(np.int32)],
                               np.int32), self.device)
        tok = sample_tokens_per_request(
            logits, up[1:2], torch.zeros_like(up[2:3]),
            up[0:1].view(torch.float32),
            top_k=up[2:3] if p.needs_mask else None,
            top_p=up[3:4].view(torch.float32) if p.needs_mask else None,
            draw=p.temperature > 0.0)
        ok = torch.isfinite(logits[0]).all().to(torch.int32)
        return fetch(torch.stack([tok[0], ok]))

    def _admit(self):
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.queue \
                    or slot in self.quarantined:
                continue
            h = self.queue.popleft()
            self.admits += 1
            prompt = h.prompt[-self.ecfg.capacity:]
            self.slots[slot] = h          # resident before the dispatch so
            self._prompts[slot] = list(prompt)  # containment can attribute
            self._cursor[slot] = 0        # not decoding until token 0 lands
            h.t_admit = self._clock()
            h._slot = slot
            self.obs.request_admitted(h, slot)
            t_pf0 = self._clock()
            try:
                self._guard_dispatch("prefill", [slot])
                with self.obs.span("prefill_dispatch",
                                   args={"bucket": len(prompt), "rows": 1}):
                    logits = self._prefill_len_fn(len(prompt))(
                        np.asarray(prompt, np.int32))
            except (EngineCrash, GraphFailure) as exc:  # engine death
                self._attribute_crash(exc, [slot])
                raise
            except Exception as exc:  # serial admission: batch-1 containment
                self._admit_finished.extend(
                    self._contain("prefill", [slot], exc))
                continue
            self._merge(slot)
            self.prefill_steps += 1
            self.prefill_tokens += len(prompt)
            self.obs.h_prefill_chunk.observe(self._clock() - t_pf0)
            self.obs.prefill_chunk(h, slot, t_pf0, self._clock(),
                                   len(prompt), len(prompt))
            if self._injector is not None \
                    and self._injector.poison_index(h.uid, 0, 1) == 0:
                logits[0] = float("nan")
            with self.obs.span("prefill_sync"):
                tok, row_ok = self._first_token(logits, h.params)
            if not row_ok:
                self._free_slot(slot)
                self._quarantine(slot)
                h.error = "non-finite logits at prefill completion"
                self._finish(h, FINISH_ERROR, self._clock())
                self._admit_finished.append(h)
                continue
            with self.obs.span("sample_collect", args={"rows": 1}):
                tok = int(tok)
            now = self._clock()
            # the prompt is consumed: the base class sees a decoding row
            self._cursor[slot] = len(prompt)
            if not self._emit(h, tok, now):
                self.last_tokens[slot] = tok
                self._slot_arrays = None
                continue
            self._admit_finished.append(h)
            self._free_slot(slot)
