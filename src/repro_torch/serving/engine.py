"""Continuous-batching serving engine, ring KV layout (the reference's
``repro.serving.engine.ServingEngine``, same scheduling and field names).

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
(``serving.sampling``), so output is invariant to fleet composition and
chunk boundaries; on the card this also needs the batch-invariant kernels
(every kernel of the path computes a row the same way whatever shares its
batch).

Not ported yet, and rejected when set away from their defaults: the paged
KV layout, admission caps, deadlines, quarantine, fault injection,
observability, pre-unpacked planes and an attention-backend override.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import decode_step, init_decode_state, prefill_chunk
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_LENGTH,
                                     FINISH_STOP, RequestHandle,
                                     SamplingParams, make_handle)
from repro_torch.serving.sampling import sample_tokens_per_request

__all__ = ["EngineConfig", "ServingEngine", "SamplingParams", "RequestHandle"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-wide knobs; per-request behavior lives in ``SamplingParams``."""

    max_slots: int = 4
    capacity: int = 256          # KV-cache length per slot
    eos_id: Optional[int] = None
    attn_backend: Optional[str] = None
    decode_chunk: int = 8        # decode steps per dispatch (K)
    prefill_chunk: int = 64      # max prompt tokens consumed per slot per step
    max_queue: Optional[int] = None
    max_resident_tokens: Optional[int] = None
    admission_policy: str = "reject"
    quarantine_steps: Optional[int] = 2
    decode_chunk_prefilling: int = 2
    preunpack_decode: Optional[bool] = None
    kv_layout: str = "ring"
    page_size: int = 16
    max_pages: Optional[int] = None
    prefix_cache: bool = True

    # fields of the reference this port does not implement yet, with the
    # only values it accepts
    _UNPORTED = {"attn_backend": (None, "auto"), "max_queue": (None,),
                 "max_resident_tokens": (None,),
                 "admission_policy": ("reject",), "quarantine_steps": (2,),
                 "preunpack_decode": (None, False), "kv_layout": ("ring",),
                 "page_size": (16,), "max_pages": (None,),
                 "prefix_cache": (True,)}

    def __post_init__(self):
        if self.max_slots < 1 or self.capacity < 1:
            raise ValueError("max_slots and capacity must be >= 1")
        if min(self.decode_chunk, self.prefill_chunk,
               self.decode_chunk_prefilling) < 1:
            raise ValueError("chunk sizes must be >= 1")
        for name, allowed in self._UNPORTED.items():
            if getattr(self, name) not in allowed:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet (accepted: {allowed})")


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


class ServingEngine:
    """Bucketed/chunked-prefill scheduler behind the v1 handle API."""

    def __init__(self, model, model_cfg, engine_cfg: EngineConfig, *,
                 injector=None, observability=None):
        if injector is not None or observability is not None:
            raise NotImplementedError(
                "fault injection and observability are not ported yet")
        self.model = model
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.device = model.embed.device
        nb = engine_cfg.max_slots
        self.queue: deque[RequestHandle] = deque()
        self.slots: List[Optional[RequestHandle]] = [None] * nb
        self.state = init_decode_state(model_cfg, nb, engine_cfg.capacity,
                                       device=self.device)
        self.last_tokens = np.zeros((nb,), np.int32)
        self._prompts: List[Optional[List[int]]] = [None] * nb
        self._cursor: List[int] = [0] * nb
        self._slot_arrays = None  # fleet tensors; None → slots changed
        self._next_uid = 0
        self.steps = 0            # decode steps dispatched
        self.prefill_steps = 0    # prefill_chunk dispatches
        self.admits = 0
        self.engine_steps = 0
        self.completed = 0
        self.cancelled = 0
        self.submitted = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0

    # ------------------------------------------------------------------ API
    def submit(self, prompt, params: Optional[SamplingParams] = None, *,
               uid: Optional[int] = None) -> RequestHandle:
        """Enqueue a request; returns its ``RequestHandle``."""
        if uid is None:
            uid, self._next_uid = self._next_uid, self._next_uid + 1
        h = make_handle(self, prompt, params, uid)
        if h.params.deadline_s is not None \
                or h.params.ttft_deadline_s is not None:
            raise NotImplementedError("request deadlines are not ported yet")
        self._next_uid = max(self._next_uid, h.uid + 1)
        self.submitted += 1
        stop = frozenset(h.params.stop)
        if self.ecfg.eos_id is not None:
            stop |= {self.ecfg.eos_id}
        h._stop_ids = stop
        h.truncated = len(h.prompt) > self.ecfg.capacity
        self.queue.append(h)
        return h

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
        self._finish(handle, FINISH_CANCELLED)
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
        """Admit into all free slots, advance prefill one chunk, decode one
        chunk; returns the requests that finished this step."""
        self.engine_steps += 1
        self._admit()
        done_now = self._prefill_step()
        dec = [i for i in range(len(self.slots)) if self._decoding(i)]
        if not dec:
            return done_now
        remaining = max(self.slots[i].params.max_new_tokens
                        - len(self.slots[i].output) for i in dec)
        chunk = self.ecfg.decode_chunk
        if any(self._prefilling(i) for i in range(len(self.slots))):
            chunk = min(chunk, self.ecfg.decode_chunk_prefilling)
        n_steps = min(chunk, _pow2ceil(remaining))
        toks = self._decode_loop(n_steps)
        self.steps += n_steps
        return done_now + self._collect(toks)

    # ------------------------------------------------------------ internals
    def _prefilling(self, slot: int) -> bool:
        return (self.slots[slot] is not None
                and self._cursor[slot] < len(self._prompts[slot]))

    def _decoding(self, slot: int) -> bool:
        return (self.slots[slot] is not None
                and self._cursor[slot] >= len(self._prompts[slot]))

    def _free_slot(self, slot: int):
        self.slots[slot] = None
        self._prompts[slot] = None
        self._cursor[slot] = 0
        self._slot_arrays = None

    def _finish(self, h: RequestHandle, reason: str):
        h.finish_reason = reason
        h.t_done = time.monotonic()
        if reason in (FINISH_STOP, FINISH_LENGTH):
            self.completed += 1
        elif reason == FINISH_CANCELLED:
            self.cancelled += 1

    def _emit(self, h: RequestHandle, tok: int, now: float) -> bool:
        """Append a generated token; True if it finished the request."""
        h.output.append(tok)
        self.tokens_generated += 1
        if not h.t_first:
            h.t_first = now
        if tok in h._stop_ids:
            self._finish(h, FINISH_STOP)
        elif len(h.output) >= h.params.max_new_tokens:
            self._finish(h, FINISH_LENGTH)
        else:
            return False
        return True

    def _reset_rows(self, mask: np.ndarray):
        """Clear the decode state of the rows in ``mask`` (new admissions):
        ring positions to -1, KV to 0, row position to 0 — in place."""
        m = torch.as_tensor(mask, device=self.device)
        self.state["pos"].masked_fill_(m, 0)
        for cache in self.state["layers"]:
            for name, buf in cache.items():
                shaped = m.reshape((-1,) + (1,) * (buf.dim() - 1))
                buf.masked_fill_(shaped, -1 if name == "pos" else 0)

    def _admit(self):
        fresh = np.zeros((len(self.slots),), bool)
        for slot in range(len(self.slots)):
            if self.slots[slot] is not None or not self.queue:
                continue
            h = self.queue.popleft()
            self.slots[slot] = h
            self._prompts[slot] = list(h.prompt[-self.ecfg.capacity:])
            self._cursor[slot] = 0
            h.t_admit = time.monotonic()
            fresh[slot] = True
            self.admits += 1
        if fresh.any():
            self._reset_rows(fresh)
            self._slot_arrays = None

    def _sample_first(self, logits, rows: List[int]) -> np.ndarray:
        """Token 0 of every row in ``rows`` from its own stream (index 0);
        other rows ride along greedy and are ignored."""
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
            top_k=tk, top_p=tp)
        return toks.cpu().numpy()

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
        logits, self.state = prefill_chunk(
            self.model, self.cfg, self.state,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lengths).to(self.device))
        self.prefill_steps += 1
        self.prefill_tokens += int(lengths.sum())
        finishers = [i for i in pf
                     if self._cursor[i] + take[i] >= len(self._prompts[i])]
        for i in pf:
            self._cursor[i] += take[i]
        if not finishers:
            return []
        toks = self._sample_first(logits, finishers)
        now = time.monotonic()
        finished: List[RequestHandle] = []
        for i in finishers:
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
        fleet changes: (temps, active, seeds, top_k, top_p, stops, masked)."""
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
            ) + (masked,)
        return self._slot_arrays

    def _decode_loop(self, n_steps: int) -> np.ndarray:
        """K decode steps with on-device sampling and stop-freezing; one
        host sync at the end. Returns (K, B) sampled tokens."""
        temps, active, seeds, top_k, top_p, stops, masked = \
            self._fleet_arrays()
        nb = len(self.slots)
        gen = torch.tensor([len(self.slots[i].output) if self._decoding(i)
                            else 0 for i in range(nb)], dtype=torch.int32,
                           device=self.device)
        tok = torch.from_numpy(self.last_tokens).to(self.device)
        out = []
        for _ in range(n_steps):
            logits, self.state = decode_step(self.model, self.cfg, self.state,
                                             tok, active)
            nxt = sample_tokens_per_request(
                logits, seeds, gen, temps, top_k=top_k if masked else None,
                top_p=top_p if masked else None)
            nxt = torch.where(active, nxt, tok)  # frozen rows repeat
            gen = gen + active.to(gen.dtype)
            hit = (nxt[:, None] == stops).any(dim=-1)
            active = active & ~hit
            out.append(nxt)
            tok = nxt
        return torch.stack(out).cpu().numpy()

    def _collect(self, toks: np.ndarray) -> List[RequestHandle]:
        """Fold a (K, B) chunk of tokens into the decoding requests; a slot
        stops at its first stop token or at its budget."""
        finished = []
        now = time.monotonic()
        for slot, h in enumerate(self.slots):
            if h is None or not self._decoding(slot):
                continue
            for k in range(toks.shape[0]):
                tok = int(toks[k, slot])
                self.last_tokens[slot] = tok
                if self._emit(h, tok, now):
                    finished.append(h)
                    self._free_slot(slot)
                    break
        return finished

