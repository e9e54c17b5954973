"""Deterministic fault injection for the port's serving stack (the
reference's ``repro.serving.faults``, same plan, hooks and helpers).

  * :class:`FaultPlan` — a declarative schedule of faults: NaN-poison the
    logits that produce generated token *k* of request *r* (on the device,
    through the engine's real non-finite detection), raise from the *n*-th
    prefill/decode dispatch (before the device call, so state is never
    half-written), jump the engine's clock past a deadline at a chosen
    engine step, kill the engine at a chosen dispatch (``engine_crash``:
    raises ``EngineCrash``, which escapes containment), and hang a chosen
    step (``stall_step``: the injected clock jumps and the hook blocks until
    ``release_stalls()``).
  * :class:`FaultInjector` — the engine-side hook that executes a plan.
    Pass it to ``ServingEngine(..., injector=...)``; an engine built
    without one runs no poison operation in its decode loop.
  * :class:`VirtualClock` — a manually advanced time source, so deadline
    expiry is exact and tests never sleep.
  * :func:`corrupt_artifact_shard` / :func:`truncate_artifact_shard` —
    flip a seeded byte in (or tear the tail off) an on-disk artifact and
    return exactly what was damaged.

The keystone property: under any plan, requests the plan does not touch
finish with outputs bit-identical to a fault-free run. The same plan fires
at the same dispatch indices in this engine and in the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["VirtualClock", "FaultPlan", "FaultInjector",
           "corrupt_artifact_shard", "truncate_artifact_shard"]


class VirtualClock:
    """A deterministic ``time.perf_counter`` stand-in: only advances when
    told to. An engine built with an injector carrying one stamps every
    timestamp (submit, first token, finish) from it."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        assert dt >= 0.0, "time only moves forward"
        self.now += dt
        return self.now


@dataclasses.dataclass(frozen=True)
class _NanFault:
    uid: int          # request to poison
    gen_index: int    # generated-token index whose logits go NaN


@dataclasses.dataclass(frozen=True)
class _DispatchFault:
    kind: str                 # "prefill" | "decode"
    index: int                # which dispatch of that kind (0-based count)
    uid: Optional[int] = None  # attribute to this request's slot (else the
    #                            whole dispatch is the containment unit)


@dataclasses.dataclass(frozen=True)
class _ClockStall:
    at_step: int      # engine step() ordinal (1-based, first step is 1)
    advance_s: float  # seconds the virtual clock jumps before that step


@dataclasses.dataclass(frozen=True)
class _EngineCrashFault:
    kind: str                  # "prefill" | "decode"
    index: int                 # which dispatch of that kind (0-based count)
    uid: Optional[int] = None  # blame this request (else the whole dispatch
    #                            is suspect — ambiguous attribution)


@dataclasses.dataclass(frozen=True)
class _StallStep:
    at_step: int      # engine step() ordinal (1-based) that hangs
    hang_s: float     # VirtualClock seconds the step appears to take


class FaultPlan:
    """A schedulable set of faults, fully determined at construction.

    The plan is data, not callbacks — two runs of the same plan against the
    same trace inject the same faults at the same points, which is what
    lets a test diff survivor outputs bit for bit against a fault-free
    run. ``seed`` feeds only the artifact-corruption helpers
    (choosing which byte to flip); the serving-side schedule is exact.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.nans: List[_NanFault] = []
        self.dispatch_faults: List[_DispatchFault] = []
        self.stalls: List[_ClockStall] = []
        self.crashes: List[_EngineCrashFault] = []
        self.step_stalls: List[_StallStep] = []

    # ------------------------------------------------------------- authoring
    def nan_logits(self, uid: int, gen_index: int) -> "FaultPlan":
        """NaN the logits that would produce generated token ``gen_index``
        of request ``uid`` (0 = the prefill-finisher token)."""
        assert gen_index >= 0
        self.nans.append(_NanFault(uid, gen_index))
        return self

    def dispatch_error(self, kind: str, index: int,
                       uid: Optional[int] = None) -> "FaultPlan":
        """Raise :class:`~repro_torch.serving.engine.EngineFault` from the
        ``index``-th dispatch of ``kind`` ("prefill" | "decode"), attributed
        to ``uid``'s slot when given (else unattributed — the engine must
        contain the whole dispatch)."""
        assert kind in ("prefill", "decode"), kind
        self.dispatch_faults.append(_DispatchFault(kind, index, uid))
        return self

    def stall_clock(self, at_step: int, advance_s: float) -> "FaultPlan":
        """Jump the virtual clock forward by ``advance_s`` seconds at the
        start of engine step ``at_step`` — the deterministic way to expire
        a deadline mid-flight."""
        self.stalls.append(_ClockStall(at_step, advance_s))
        return self

    def engine_crash(self, kind: str, index: int,
                     uid: Optional[int] = None) -> "FaultPlan":
        """Raise :class:`~repro_torch.serving.engine.EngineCrash` from the
        ``index``-th dispatch of ``kind`` — engine death, not a contained
        fault: the exception escapes ``step()`` to its caller.
        ``uid`` marks the poison request (the engine attributes it as the
        sole suspect when resident); omitted, every participating row is
        suspect (ambiguous attribution)."""
        assert kind in ("prefill", "decode"), kind
        self.crashes.append(_EngineCrashFault(kind, index, uid))
        return self

    def stall_step(self, at_step: int, hang_s: float) -> "FaultPlan":
        """Hang engine step ``at_step``: the injector advances the
        VirtualClock by ``hang_s`` and then blocks inside ``on_step``
        until :meth:`FaultInjector.release_stalls` — to whoever drives the
        engine, the step never returns. Every caller that plans one must
        call ``release_stalls()`` (in a ``finally``), or its thread stays
        blocked."""
        assert hang_s >= 0.0
        self.step_stalls.append(_StallStep(at_step, hang_s))
        return self

    def describe(self) -> Dict[str, Any]:
        """JSON-able summary of the plan."""
        return {
            "seed": self.seed,
            "nan_logits": [dataclasses.asdict(f) for f in self.nans],
            "dispatch_errors": [dataclasses.asdict(f)
                                for f in self.dispatch_faults],
            "clock_stalls": [dataclasses.asdict(f) for f in self.stalls],
            "engine_crashes": [dataclasses.asdict(f) for f in self.crashes],
            "step_stalls": [dataclasses.asdict(f) for f in self.step_stalls],
        }


class FaultInjector:
    """Executes a :class:`FaultPlan` against one engine.

    The engine calls three hooks (see ``ServingEngine``):

      * ``on_step(engine)``     — start of every ``step()``; applies clock
        stalls scheduled for that step.
      * ``before_dispatch(engine, kind, index, slots)`` — may raise
        ``EngineFault`` per the plan (once per planned fault).
      * ``poison_index(uid, gen0, n_steps)`` — the gen-index in
        ``[gen0, gen0 + n_steps)`` at which to NaN that request's logits,
        or None.

    ``clock`` (a :class:`VirtualClock` or None for real time) becomes the
    engine's single time source. One injector drives one engine: fired
    dispatch faults are consumed, so a retried dispatch (survivors repeat
    the step a contained fault skipped) is not re-failed.
    """

    def __init__(self, plan: Optional[FaultPlan] = None,
                 clock: Optional[VirtualClock] = None):
        self.plan = plan or FaultPlan()
        self.clock = clock
        self._fired: set = set()
        self.log: List[Tuple[str, Any]] = []  # what actually fired, in order
        # stall_step machinery: the hook blocks here until release_stalls()
        # (or the test tears the run down); stall_engaged lets a test wait
        # for the hang to actually be in progress before asserting on it
        self._stall_gate = threading.Event()
        self.stall_engaged = threading.Event()

    # --------------------------------------------------------- engine hooks
    def on_step(self, engine):
        for s in self.plan.stalls:
            key = ("stall", s.at_step, s.advance_s)
            if engine.engine_steps == s.at_step and key not in self._fired:
                self._fired.add(key)
                if self.clock is None:
                    raise RuntimeError("stall_clock needs a VirtualClock")
                self.clock.advance(s.advance_s)
                self.log.append(("stall", dataclasses.asdict(s)))
        for s in self.plan.step_stalls:
            key = ("stall_step", s.at_step)
            if engine.engine_steps == s.at_step and key not in self._fired:
                self._fired.add(key)
                if self.clock is None:
                    raise RuntimeError("stall_step needs a VirtualClock")
                # the step "takes" hang_s on the injected clock, then the
                # calling thread wedges until released — exactly what a hung
                # device call looks like from outside
                self.clock.advance(s.hang_s)
                self.log.append(("stall_step", dataclasses.asdict(s)))
                self.stall_engaged.set()
                self._stall_gate.wait()

    def release_stalls(self) -> None:
        """Unblock every fired (and future) ``stall_step`` hang, so the
        blocked thread can return and the process can wind down."""
        self._stall_gate.set()

    def before_dispatch(self, engine, kind: str, index: int,
                        slots: List[int]):
        from repro_torch.serving.engine import EngineCrash, EngineFault

        for f in self.plan.crashes:
            key = ("crash", f.kind, f.index)
            if f.kind != kind or f.index != index or key in self._fired:
                continue
            self._fired.add(key)
            self.log.append(("crash", dataclasses.asdict(f)))
            raise EngineCrash(
                f"injected engine crash at {kind} dispatch #{index}",
                uid=f.uid)
        for f in self.plan.dispatch_faults:
            key = ("dispatch", f.kind, f.index)
            if f.kind != kind or f.index != index or key in self._fired:
                continue
            self._fired.add(key)
            slot = None
            if f.uid is not None:
                slot = next((i for i, h in enumerate(engine.slots)
                             if h is not None and h.uid == f.uid), None)
            self.log.append(("dispatch", dataclasses.asdict(f)))
            raise EngineFault(
                f"injected {kind} dispatch fault #{index}", slot=slot)

    def poison_index(self, uid: int, gen0: int,
                     n_steps: int) -> Optional[int]:
        for f in self.plan.nans:
            if f.uid == uid and gen0 <= f.gen_index < gen0 + n_steps:
                key = ("nan", f.uid, f.gen_index)
                if key not in self._fired:
                    self._fired.add(key)
                    self.log.append(("nan", dataclasses.asdict(f)))
                return f.gen_index
        return None


# ---------------------------------------------------------------------------
# artifact corruption (the torn/corrupt-shard axis of the plan)
# ---------------------------------------------------------------------------

def _load_manifest(artifact_dir) -> Dict[str, Any]:
    from repro_torch.artifacts.format import MANIFEST_NAME

    return json.loads((Path(artifact_dir) / MANIFEST_NAME).read_text())


def corrupt_artifact_shard(artifact_dir, *, seed: int = 0,
                           tensor: Optional[str] = None,
                           xor: int = 0xFF) -> Dict[str, Any]:
    """Flip one seeded byte inside a committed artifact buffer.

    Picks (deterministically from ``seed``) a tensor buffer — or a buffer
    of the named ``tensor`` — and XORs one in-range byte of its shard.
    Returns {tensor, buffer, shard, shard_offset, buffer_offset, crc32}
    describing the damage, so a test can assert the reader's
    checksum-failure report names exactly this buffer.
    """
    manifest = _load_manifest(artifact_dir)
    rng = np.random.default_rng(seed)
    names = sorted(manifest["tensors"])
    if tensor is None:
        tensor = names[int(rng.integers(len(names)))]
    rec = manifest["tensors"][tensor]
    bufs = sorted(rec["buffers"])
    bname = bufs[int(rng.integers(len(bufs)))]
    buf = rec["buffers"][bname]
    off = buf["offset"] + int(rng.integers(buf["nbytes"]))
    path = Path(artifact_dir) / buf["shard"]
    mask = (xor & 0xFF) or 0x01  # xor=0 would be a no-op "corruption"
    with open(path, "r+b") as f:
        f.seek(off)
        byte = f.read(1)
        f.seek(off)
        f.write(bytes([byte[0] ^ mask]))
    return {"tensor": tensor, "buffer": bname, "shard": buf["shard"],
            "shard_offset": off, "buffer_offset": off - buf["offset"],
            "crc32": buf["crc32"]}


def truncate_artifact_shard(artifact_dir, *, seed: int = 0,
                            drop_bytes: int = 1) -> Dict[str, Any]:
    """Tear the tail off a seeded shard file (a torn copy / partial
    download). Returns {shard, old_size, new_size}; the reader's
    ``verify="sizes"`` fast mode must reject the artifact without reading
    any tensor bytes."""
    manifest = _load_manifest(artifact_dir)
    rng = np.random.default_rng(seed)
    shard = manifest["shards"][int(rng.integers(len(manifest["shards"])))]
    path = Path(artifact_dir) / shard["file"]
    old = path.stat().st_size
    new = max(old - int(drop_bytes), 0)
    with open(path, "r+b") as f:
        f.truncate(new)
    return {"shard": shard["file"], "old_size": old, "new_size": new}
