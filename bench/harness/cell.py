"""One run of one cell: set-up, the loop's window, the check, the metrics.

The order matters for what each number means:

  1. set-up (``setup_s``): the program's kernels built (a no-op once they
     are cached in the checkout), the weights made on the device from the
     seed, the model and the engine built, every dispatch the engine can
     need captured (``warmup``), and the traffic's pool drawn;
  2. the loop, to its steady state and through the window (traced runs:
     the program's trace of the window, the device trace of a part);
  3. the device's memory peak, read before anything else runs;
  4. the program freed, then the check against the reference (not timed);
  5. the metrics, each by its reader.
"""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
from typing import Any, Callable, List, Optional

import torch

from harness import check, counts, program, trace as trace_mod, traffic
from harness import spec as spec_mod
from harness import weights, work
from harness.window import Window, failed
from repro_torch.serving.observability import PHASES

#: seconds of the window under the device profiler in a traced run
PROFILE_S = 2.0
#: entries of each list of the breakdown
TOP = 10
#: the program's phase spans, innermost first (page_maint nests in the
#: others), then the step around them
NESTING = ("page_maint",) + tuple(p for p in PHASES if p != "page_maint") \
    + ("step",)


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    setup_s: float
    window: Window
    device: Optional[trace_mod.DeviceTrace]
    dispatches: Optional[List[work.Dispatch]]
    shapes: counts.Shapes
    peaks: Optional[dict]
    mixer_flops: Callable[[int], float]
    slots: int
    #: padded rows from which the program sends a ternary call to B3
    small_rows: int
    #: the profiled stretch of a traced run: (start, end, counters at start,
    #: counters at end), left out of what reads the whole window
    excluded: Optional[tuple] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    def note(self, msg: str) -> None:
        self.notes.append(msg)

    def seconds(self) -> float:
        """The window's seconds, without the profiled stretch."""
        x = self.excluded
        return self.window.seconds - (x[1] - x[0] if x else 0.0)

    def counter(self, name: str) -> float:
        """A program counter's increase over the window, without the
        profiled stretch."""
        x = self.excluded
        return self.window.counter(name) - (x[3][name] - x[2][name]
                                            if x else 0.0)

    def window_dispatches(self) -> Optional[List[work.Dispatch]]:
        """The window's dispatches, without the profiled stretch's."""
        if self.dispatches is None or self.excluded is None:
            return self.dispatches
        x0, x1 = self.excluded[:2]
        return [d for d in self.dispatches if not x0 <= d.t <= x1]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def breakdown(dev: trace_mod.DeviceTrace, events) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the program's phase the host was in (the innermost phase span
    around the gap's middle; "step" inside a step outside every phase; the
    benchmark's "loop" outside every step)."""
    by_name: dict = {}
    for name, a, b in dev.ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans = [(e.ts, e.ts + e.dur, e.name) for e in events
             if e.ph == "X" and e.name in NESTING]
    rank = {p: i for i, p in enumerate(NESTING)}
    gaps = []
    for a, b in sorted(dev.gaps(), key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        around = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(around, key=lambda s: rank[s[2]])[2] if around else "loop"
        gaps.append([name, b - a])
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": gaps}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False, log=print, profile_s: float = PROFILE_S,
        stats=None) -> dict:
    """One run of ``cell``; returns the result's object. ``control`` and
    ``stats`` are for calibration (``check.compare``)."""
    config = cell.config
    c = config["config"]
    mix = cell.traffic
    ref = spec_mod.reference(config)
    cfg = program.model_config(config)
    group = c["quantization"]["group_size"]
    spec = ref.param_spec(c)
    fdt = program.float_dtype(cfg)
    if device.type == "cuda":
        program.build_kernels()
    model = program.build_model(cfg, spec, weights.make(
        spec, seed, device, fdt, group), group, device)
    eng = program.engine(model, cfg, mix)
    requests = traffic.pool(mix, c["vocab_size"], seed)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    tracer = trace_mod.Tracer(eng, seconds, profile_s,
                              lambda: program.counters(eng)) \
        if trace else None
    window = spec_mod.loop(mix["loop"])(
        eng, requests, mix, seconds, counters=lambda: program.counters(eng),
        hooks=tracer)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    log(f"window {window.seconds:.3f} s: {window.tokens} tokens, "
        f"{len(window.finished())} finished, {len(window.submitted())} "
        f"submitted")
    events = tracer.recorder.events() if tracer else None
    dev_trace = tracer.device if tracer else None
    excluded = tracer.excluded if tracer else None
    if tracer:
        tracer.engine = None
    del eng, model, tracer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = check.compare(window, cell, seed, device, fdt, ref, control,
                            stats)
    _sync(device)
    log(f"check {time.perf_counter() - t_check:.3f} s")

    ctx = Context(
        setup_s, window, dev_trace,
        work.dispatches(events, window, {r.uid: len(r.req.prompt)
                                         for r in window.records})
        if events is not None else None,
        counts.Shapes.of(spec, group, torch.finfo(
            program.activation_dtype(cfg)).bits // 8),
        counts.PEAKS.get(torch.cuda.get_device_name(device))
        if device.type == "cuda" else None,
        lambda ctx_len: ref.mixer_flops(c, ctx_len),
        int(mix["engine"]["max_slots"]), program.small_m_threshold(),
        excluded)
    metrics = {}
    for m in cell.metrics:
        v = spec_mod.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    for n in ctx.notes:
        log(n)
    dev: dict[str, Any] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result: dict[str, Any] = {
        "correct": check.passed(numbers),
        "attempted": len(window.submitted()), "failed": failed(window),
        "metrics": metrics, "device": dev}
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s()
        dev["window_s"] = dev_trace.window_s
        result["breakdown"] = breakdown(dev_trace, events)
    result["checks"] = numbers
    return result
