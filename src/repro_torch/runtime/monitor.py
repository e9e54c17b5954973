"""Heartbeats + straggler detection for multi-host training, and the
serving-side health snapshot built on the same idiom (a copy of the
reference's ``repro.runtime.monitor``, heartbeat schema 3).

Each host writes a heartbeat file (step, wall time, step duration) every step;
the rank-0 monitor reads all heartbeats and flags:

  * **dead hosts**  — no heartbeat within `dead_after_s`,
  * **stragglers**  — per-step time > `straggler_factor` × fleet median,
  * **clock-skewed hosts** — heartbeat timestamp in the *future* by more than
    `skew_tolerance_s`: a skewed clock would otherwise make a host look
    freshly alive forever, hiding a real death behind a bad NTP sync.

On a real fleet the orchestrator restarts dead hosts from the latest
checkpoint (straggler *mitigation by exclusion*). Here the detector's
decision logic is exercised directly by unit tests.

:class:`HealthSnapshot` is the per-request analogue for the serving engine:
one frozen record of queue depth, slot occupancy, and the fault-containment
counters (sheds, timeouts, quarantines), produced by
``ServingEngine.health()`` each time it is asked and writable as a heartbeat
(``snapshot.beat(monitor)``) so a serving host shows up in the same fleet
assessment as a training host.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime import clock as rtclock

#: Heartbeat payload schema version. History:
#:   1 (implicit) — {host, step, t, step_time_s, **metrics}; pre-PR-8
#:     payloads carry no "schema" key and are read as v1.
#:   2 — adds "schema" and (for serving hosts) the observability metrics
#:     digest. Readers must tolerate missing keys beyond {host, t}: the
#:     fleet never upgrades atomically, so one detector version always
#:     overlaps older writers.
#:   3 — supervised serving hosts add "engine_generation" and
#:     "engine_restarts" (via the digest) so the fleet monitor can spot
#:     crash-looping hosts; readers default both to 0 (a host that never
#:     reports them has simply never restarted its engine).
HEARTBEAT_SCHEMA = 3


@dataclasses.dataclass
class HeartbeatMonitor:
    """Per-host heartbeat writer."""

    run_dir: str
    host_id: int = 0

    def __post_init__(self):
        self._dir: Optional[Path] = None  # created once, on first beat

    def beat(self, step: int, step_time_s: float, **metrics):
        if self._dir is None:
            d = Path(self.run_dir) / "heartbeats"
            d.mkdir(parents=True, exist_ok=True)
            self._dir = d
        tmp = self._dir / f".host{self.host_id:04d}.tmp"
        payload = {"schema": HEARTBEAT_SCHEMA, "host": self.host_id,
                   "step": step, "t": rtclock.wall_now(),
                   "step_time_s": step_time_s, **metrics}
        tmp.write_text(json.dumps(payload))
        tmp.rename(self._dir / f"host{self.host_id:04d}.json")


@dataclasses.dataclass
class StragglerDetector:
    """Rank-0 fleet health assessment from heartbeat files."""

    run_dir: str
    dead_after_s: float = 120.0
    straggler_factor: float = 2.0
    skew_tolerance_s: float = 5.0

    def read(self) -> List[Dict]:
        """Parse every heartbeat file, tolerating *any* schema version: a
        payload needs only ``host`` and ``t`` to be assessable (liveness
        and skew are timestamp properties); everything else is normalized
        — missing ``schema`` reads as v1, missing ``step_time_s`` as None
        (the host is alive but contributes nothing to the straggler
        median). A fleet mid-upgrade therefore never KeyErrors the
        detector."""
        d = Path(self.run_dir) / "heartbeats"
        if not d.exists():
            return []
        out = []
        for p in sorted(d.glob("host*.json")):
            try:
                b = json.loads(p.read_text())
            except (json.JSONDecodeError, OSError):
                continue  # torn read: skip this cycle
            if not isinstance(b, dict) or "host" not in b or "t" not in b:
                continue  # unassessable payload: skip, don't crash
            b.setdefault("schema", 1)
            b.setdefault("step", 0)
            b.setdefault("step_time_s", None)
            b.setdefault("engine_generation", 0)
            b.setdefault("engine_restarts", 0)
            out.append(b)
        return out

    def assess(self, now: Optional[float] = None) -> Dict:
        now = rtclock.wall_now() if now is None else now
        beats = self.read()
        if not beats:
            return {"healthy": [], "dead": [], "stragglers": [],
                    "skewed": [], "median_step_s": None}
        # a timestamp from the future is a broken clock, not a fresh beat:
        # the host's liveness cannot be assessed, so it is flagged instead
        # of silently counting as alive until its skew drains
        skewed = [b["host"] for b in beats
                  if b["t"] - now > self.skew_tolerance_s]
        dead = [b["host"] for b in beats
                if b["host"] not in skewed and now - b["t"] > self.dead_after_s]
        alive = [b for b in beats
                 if b["host"] not in dead and b["host"] not in skewed]
        times = [b["step_time_s"] for b in alive
                 if b["step_time_s"] is not None]
        med = float(np.median(times)) if times else None
        stragglers = [b["host"] for b in alive
                      if med and b["step_time_s"] is not None
                      and b["step_time_s"] > self.straggler_factor * med]
        healthy = [b["host"] for b in alive if b["host"] not in stragglers]
        return {"healthy": healthy, "dead": dead, "stragglers": stragglers,
                "skewed": skewed, "median_step_s": med}


@dataclasses.dataclass(frozen=True)
class HealthSnapshot:
    """One observation of a serving engine's health (``engine.health()``).

    Gauges describe the instant the snapshot was taken; counters are
    monotone totals since engine construction, so a monitor can difference
    two snapshots for rates. ``quarantined_slots`` lists slots a contained
    fault removed from the admission pool (``engine.rehabilitate()``
    returns them after a row reset).
    """

    t: float                      # wall time of the observation
    steps: int                    # decode dispatches so far (counter)
    queue_depth: int              # requests waiting for a slot (gauge)
    resident: int                 # occupied slots (gauge)
    free_slots: int               # admissible slots (gauge)
    quarantined_slots: Tuple[int, ...]  # suspect slots, out of the pool
    resident_tokens: int          # committed tokens of queued+resident work
    completed: int                # finished stop/length (counter)
    cancelled: int                # finished cancelled (counter)
    sheds: int                    # rejected at submit by admission control
    timeouts: int                 # retired by deadline sweep (counter)
    errors: int                   # retired by fault containment (counter)
    # ---- page-pool gauges (paged KV engines only; None/0 under the ring
    # layout so pre-paging snapshots and heartbeats stay comparable)
    pages_free: Optional[int] = None    # unowned physical pages (gauge)
    pages_used: Optional[int] = None    # pages with ref > 0 (gauge)
    pages_shared: Optional[int] = None  # pages with ref > 1, COW-protected
    prefix_hits: int = 0          # prefix-cache pages reused (counter)
    prefix_misses: int = 0        # lookups that ended cold (counter)
    prefix_evictions: int = 0     # cache entries dropped under pressure

    def beat(self, monitor: HeartbeatMonitor, step_time_s: float = 0.0,
             metrics: Optional[Dict] = None):
        """Publish this snapshot through the training-side heartbeat file
        protocol, so one :class:`StragglerDetector` watches both kinds of
        host. ``metrics`` (e.g. ``engine.obs.digest()``) merges extra
        flat keys into the payload — the serving metrics digest rides the
        same file."""
        extra = {k: v for k, v in dataclasses.asdict(self).items()
                 if k not in ("t", "steps")}
        if metrics:
            extra.update(metrics)
        monitor.beat(self.steps, step_time_s, **extra)

    def summary(self) -> str:
        """One log line (what ``launch/serve.py`` prints)."""
        q = ",".join(map(str, self.quarantined_slots)) or "-"
        line = (f"queue={self.queue_depth} resident={self.resident} "
                f"free={self.free_slots} quarantined=[{q}] "
                f"tokens={self.resident_tokens} done={self.completed} "
                f"cancelled={self.cancelled} shed={self.sheds} "
                f"timeout={self.timeouts} error={self.errors}")
        if self.pages_free is not None:
            line += (f" pages={self.pages_used}u/{self.pages_free}f"
                     f"/{self.pages_shared}s prefix={self.prefix_hits}h"
                     f"/{self.prefix_misses}m/{self.prefix_evictions}e")
        return line
