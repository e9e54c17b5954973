"""The port's observability (metrics registry, trace, ``health()``, the
heartbeat monitor) against the reference's ``repro.serving.observability``
and ``repro.runtime.monitor``.

Both engines serve the same PTQTP-quantized smoke qwen2-1.5b (the reference
quantizes, the port loads the same bytes) under the same workload, each on
its own package's ``VirtualClock`` ticked between steps, so every timestamp
is deterministic: the registry's counters and gauges, every histogram's
summary, the ``health()`` snapshot and the trace (each event's name, track,
kind, time, duration and arguments, in order) must be equal, on both
schedulers and layouts, with and without a fault plan. The frozen schema is
the reference's; tokens and the dispatch caches do not depend on tracing;
no raw wall-clock call hides in the port's serving or model layers.

The port's own extension (``observability.PORT_METRICS``, ``PORT_PHASES``,
``PORT_SPANS``: the input builds apart from the launches, prefill rows
computed, device seconds, set-up's compiles) is declared after the
reference's schema and dropped from the port's side before the comparison,
so every name, value and event the reference has is still compared
exactly, but a prefill dispatch's shape (its ``bucket``, and the port's
``row_bucket``): the port's prefill keys are its own (a row bucket of the
mid-prompt slots at one length), and each side's shape is checked on its
own. The extension's own tests hold it to what it counts.
"""

import bisect
import dataclasses
import json
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.runtime import monitor as jmonitor
from repro.serving import observability as jobs
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.runtime import monitor
from repro_torch.serving import (SerialAdmitEngine, ServingEngine, faults,
                                 observability as obs)
from repro_torch.serving import EngineConfig, SamplingParams

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def both():
    """(reference namespace, port namespace) on the shared quantized bytes."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    ref = SimpleNamespace(
        name="reference", params=params, cfg=jcfg,
        Engines={"bucketed": jserving.ServingEngine,
                 "serial": jserving.SerialAdmitEngine},
        EngineConfig=jserving.EngineConfig, SP=jserving.SamplingParams,
        FaultPlan=jserving.FaultPlan, FaultInjector=jserving.FaultInjector,
        VirtualClock=jserving.VirtualClock, Observability=jobs.Observability)
    port = SimpleNamespace(
        name="port", params=model, cfg=cfg,
        Engines={"bucketed": ServingEngine, "serial": SerialAdmitEngine},
        EngineConfig=EngineConfig, SP=SamplingParams,
        FaultPlan=faults.FaultPlan, FaultInjector=faults.FaultInjector,
        VirtualClock=faults.VirtualClock, Observability=obs.Observability)
    return ref, port


def traced(ns, scheduler="bucketed", plan=None, trace=True, **ecfg):
    """An engine of package ``ns`` on a VirtualClock (started past zero, so
    no timestamp looks unset) with a trace-enabled bundle."""
    clock = ns.VirtualClock(start=1000.0)
    inj = ns.FaultInjector(plan(ns.FaultPlan()) if plan else ns.FaultPlan(),
                           clock=clock)
    kw = dict(dict(max_slots=2, capacity=32), **ecfg)
    eng = ns.Engines[scheduler](ns.params, ns.cfg, ns.EngineConfig(**kw),
                                injector=inj,
                                observability=ns.Observability(trace=trace))
    return eng, clock


def drive(eng, clock, dt=0.125):
    while eng.queue or any(s is not None for s in eng.slots):
        clock.advance(dt)
        eng.step()


def observed(eng):
    """Everything the two packages' bundles must agree on."""
    reg = eng.obs.registry
    hists = {n: reg.get_histogram(n).summary() for n in reg.names()
             if reg.spec(n).kind == "histogram"}
    scalars = {n: reg.value(n) for n in reg.names()
               if reg.spec(n).kind != "histogram"}
    events = [] if eng.obs.trace is None else [
        (e.name, e.cat, e.ph, e.track, e.ts, e.dur, e.args)
        for e in eng.obs.trace.events()]
    return dict(names=reg.names(), scalars=scalars, hists=hists,
                health=dataclasses.asdict(eng.health()), events=events,
                digest=eng.obs.digest())


def reference_part(rec):
    """The port's records without its declared extension (the names of
    ``observability.PORT_METRICS``, the spans of ``PORT_SPANS``): what the
    reference's records must equal."""
    ours = obs.PORT_NAMES
    return dict(rec,
                names=[n for n in rec["names"] if n not in ours],
                scalars={n: v for n, v in rec["scalars"].items()
                         if n not in ours},
                hists={n: v for n, v in rec["hists"].items()
                       if n not in ours},
                events=[e for e in rec["events"]
                        if e[0] not in obs.PORT_SPANS])


#: a prefill dispatch's shape: the port's (rows, length) keys are its own
#: (a power-of-two row bucket at one length), the reference's a length
#: bucket over every slot. What the dispatch served (its ``rows``, the
#: mid-prompt slots) is compared; each side's shape has its own tests.
SHAPE_ARGS = ("bucket", "row_bucket")


def _without_shape(events):
    return [e[:6] + ({k: v for k, v in e[6].items() if k not in SHAPE_ARGS},)
            if e[0] == "prefill_dispatch" else e for e in events]


def assert_same(ref, port):
    assert port["names"] == ref["names"]
    assert port["scalars"] == ref["scalars"]
    assert port["hists"] == ref["hists"]
    assert port["health"] == ref["health"]
    assert port["digest"] == ref["digest"]
    # the trace's events per track, in the same order, at the same times
    ref_events = _without_shape(ref["events"])
    port_events = _without_shape(port["events"])
    tracks = {e[3] for e in ref_events} | {e[3] for e in port_events}
    for track in sorted(tracks):
        assert [e for e in port_events if e[3] == track] == \
            [e for e in ref_events if e[3] == track], track
    assert port_events == ref_events


# ---------------------------------------------------------------- the schema
def test_frozen_schema_equals_reference():
    ours = len(obs.SERVING_METRICS) - len(obs.PORT_METRICS)
    assert obs.SERVING_METRICS[:ours] == tuple(
        obs.MetricSpec(**dataclasses.asdict(s)) for s in jobs.SERVING_METRICS)
    assert obs.PHASES[:len(obs.PHASES) - len(obs.PORT_PHASES)] == jobs.PHASES
    assert obs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    assert obs.COUNT_BUCKETS == jobs.COUNT_BUCKETS
    assert monitor.HEARTBEAT_SCHEMA == jmonitor.HEARTBEAT_SCHEMA == 3
    assert [f.name for f in dataclasses.fields(monitor.HealthSnapshot)] == \
        [f.name for f in dataclasses.fields(jmonitor.HealthSnapshot)]


@pytest.mark.parametrize("mod", [obs, jobs], ids=["port", "reference"])
def test_frozen_kind_and_duplicates_enforced(mod):
    reg = mod.MetricsRegistry()
    with pytest.raises(AssertionError):
        reg.gauge("serving_requests_completed_total")  # frozen: counter
    reg.counter("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total")


def _fill(mod):
    """The same operations on a registry and a recorder of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.counter("serving_requests_completed_total", help="done").inc(3)
    box = {"n": 5}
    reg.gauge("serving_queue_depth", poll=lambda: box["n"])
    h = reg.histogram("serving_ttft_seconds", buckets=mod.LATENCY_BUCKETS,
                      help="ttft")
    for v in (0.0004, 0.3, 0.3, 7.0, 99.0):
        h.observe(v)
    reg.histogram("h_seconds", buckets=(1.0, 2.0)).observe(1.5)
    tr = mod.TraceRecorder(capacity=4)
    for i in range(6):
        tr.instant(f"e{i}", ("engine", 0), float(i))
    tr.complete("step", ("engine", 0), 1.0, 1.5, args={"engine_step": 1})
    tr.instant("first_token", mod.request_track(3), 1.25)
    return reg, tr


def test_exporters_equal_reference_and_round_trip(tmp_path):
    reg, tr = _fill(obs)
    jreg, jtr = _fill(jobs)
    text = reg.render_prometheus()
    assert text == jreg.render_prometheus()
    assert 'serving_ttft_seconds_bucket{le="+Inf"} 5' in text
    assert "serving_queue_depth 5" in text
    # Prometheus text parses back to the registry's values
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if line and not line.startswith("#"))
    assert float(samples["serving_requests_completed_total"]) == 3
    assert float(samples["serving_ttft_seconds_count"]) == 5
    assert float(samples["serving_ttft_seconds_sum"]) == pytest.approx(
        reg.get_histogram("serving_ttft_seconds").sum)
    line = reg.jsonl_line(t=5.0)
    assert line == jreg.jsonl_line(t=5.0)
    snap = json.loads(line)
    assert snap["t"] == 5.0 and snap["serving_requests_completed_total"] == 3
    assert snap["serving_ttft_seconds"]["count"] == 5
    assert reg.summary_table() == jreg.summary_table()
    assert tr.chrome_trace() == jtr.chrome_trace()
    assert tr.dropped == 4 and len(tr) == 4
    tr.write(tmp_path / "trace.json")
    assert json.loads((tmp_path / "trace.json").read_text()) == \
        tr.chrome_trace()


# --------------------------------------------------- engines: equal records
def _workload(ns, eng, clock):
    """Requests of one, two and several chunks, greedy and sampled (one
    top-k/top-p), submitted across virtual time, one cancelled mid-run."""
    hs = [eng.submit([1, 2, 3], ns.SP(max_new_tokens=4))]
    clock.advance(0.5)
    hs.append(eng.submit(list(range(5, 45)),
                         ns.SP(max_new_tokens=5, temperature=0.8, seed=3)))
    hs.append(eng.submit([4, 5], ns.SP(max_new_tokens=3, temperature=0.8,
                                       top_k=20, top_p=0.9, seed=9)))
    victim = eng.submit(list(range(60, 80)), ns.SP(max_new_tokens=30))
    clock.advance(0.25)
    eng.step()
    hs.append(eng.submit([7] * 12, ns.SP(max_new_tokens=6)))
    clock.advance(0.125)
    eng.step()
    victim.cancel()
    drive(eng, clock)
    return [(h.uid, h.output, h.finish_reason) for h in hs + [victim]]


def _faulty(p):
    return (p.nan_logits(uid=1, gen_index=2).nan_logits(uid=4, gen_index=0)
            .stall_clock(at_step=6, advance_s=60.0))


@pytest.mark.parametrize("scheduler,layout,plan", [
    ("bucketed", "ring", None), ("bucketed", "paged", None),
    ("bucketed", "ring", _faulty), ("bucketed", "paged", _faulty),
    ("serial", "ring", None), ("serial", "ring", _faulty)],
    ids=["ring", "paged", "ring-faults", "paged-faults", "serial",
         "serial-faults"])
def test_registry_health_and_trace_equal_reference(both, scheduler, layout,
                                                   plan):
    got = {}
    for ns in both:
        eng, clock = traced(ns, scheduler, plan, kv_layout=layout,
                            page_size=8, max_queue=4, prefill_chunk=16,
                            decode_chunk=4)
        streams = _workload(ns, eng, clock)
        got[ns.name] = (streams, observed(eng))
    assert got["port"][0] == got["reference"][0]
    assert_same(got["reference"][1], reference_part(got["port"][1]))
    rec = got["port"][1]
    if scheduler == "bucketed":
        # both slots (the fewest rows, 8 at length 16, exceed 2) at the one
        # length; the reference's buckets are powers of two up to 16
        shapes = [e[6] for e in rec["events"] if e[0] == "prefill_dispatch"]
        assert shapes and all(a["bucket"] == 16 and a["row_bucket"] == 2
                              for a in shapes)
        assert {e[6]["bucket"] for e in got["reference"][1]["events"]
                if e[0] == "prefill_dispatch"} <= {1, 2, 4, 8, 16}
    assert set(obs.PORT_NAMES) <= set(rec["names"])
    assert {"prefill_build", "capture"} <= {e[0] for e in rec["events"]}
    names = {e[0] for e in rec["events"]}
    assert {"step", "admit", "prefill_dispatch", "prefill_sync",
            "decode_dispatch", "decode_sync", "collect", "request",
            "first_token", "retired"} <= names, names
    if plan is not None:
        assert rec["scalars"]["serving_requests_error_total"] >= 1
    if layout == "paged":
        assert rec["health"]["pages_used"] is not None
    assert rec["scalars"]["serving_requests_cancelled_total"] == 1


def test_health_reads_the_registry_and_beats_schema_3(both, tmp_path):
    _, port = both
    eng, clock = traced(port)
    eng.submit([1, 2], SamplingParams(max_new_tokens=2))
    drive(eng, clock)
    snap, reg = eng.health(), eng.obs.registry
    assert snap.completed == reg.value("serving_requests_completed_total")
    assert snap.queue_depth == reg.value("serving_queue_depth")
    assert snap.free_slots == reg.value("serving_free_slots")
    d = eng.obs.digest()
    assert d["serving_requests_completed_total"] == snap.completed
    assert "ttft_p50_s" in d
    snap.beat(monitor.HeartbeatMonitor(str(tmp_path), host_id=0),
              step_time_s=0.1, metrics=d)
    # the reference's detector reads the port's heartbeat, and the port's
    # the same file alike
    [beat] = jmonitor.StragglerDetector(str(tmp_path)).read()
    assert beat == monitor.StragglerDetector(str(tmp_path)).read()[0]
    assert beat["schema"] == 3 and beat["queue_depth"] == 0
    assert beat["serving_requests_completed_total"] == 1
    assert beat["engine_generation"] == 0  # schema-3 default
    assert "healthy" in monitor.StragglerDetector(str(tmp_path)).assess()


def test_old_and_torn_heartbeats_parse_as_in_reference(tmp_path):
    d = tmp_path / "heartbeats"
    d.mkdir()
    (d / "host0000.json").write_text(json.dumps(
        {"host": 0, "step": 12, "t": 1000.0}))
    (d / "host0001.json").write_text(json.dumps(
        {"schema": 2, "host": 1, "step": 12, "t": 1000.0,
         "step_time_s": 0.5, "serving_requests_completed_total": 3}))
    (d / "host0002.json").write_text("{not json")
    (d / "host0003.json").write_text(json.dumps([1, 2, 3]))
    port = monitor.StragglerDetector(str(tmp_path), dead_after_s=120.0)
    ref = jmonitor.StragglerDetector(str(tmp_path), dead_after_s=120.0)
    assert port.read() == ref.read()
    assert [b["host"] for b in port.read()] == [0, 1]
    assert port.assess(now=1001.0) == ref.assess(now=1001.0)
    assert port.assess(now=1001.0)["median_step_s"] == 0.5


def test_trace_overflow_reaches_registry(both):
    _, port = both
    eng, clock = traced(port)
    eng.obs.trace.capacity = 4
    eng.submit([1, 2, 3], SamplingParams(max_new_tokens=4))
    drive(eng, clock)
    assert eng.obs.trace.dropped > 0
    assert eng.obs.registry.value("serving_trace_dropped_total") \
        == eng.obs.trace.dropped


def test_counters_monotone_and_pool_conserved(both):
    """Every counter is non-decreasing across the steps of a faulty paged
    run, and the page pool never over-counts."""
    _, port = both
    eng, clock = traced(port, plan=_faulty, kv_layout="paged", page_size=8,
                        prefix_cache=False)
    for i in range(5):
        eng.submit(list(range(1 + i, 10 + i)), SamplingParams(
            max_new_tokens=6, seed=i, deadline_s=30.0))
    prev = eng.obs.registry.counters()
    while eng.queue or any(s is not None for s in eng.slots):
        clock.advance(0.25)
        eng.step()
        cur = eng.obs.registry.counters()
        assert all(cur[n] >= prev[n] for n in cur), (prev, cur)
        reg = eng.obs.registry
        assert reg.value("serving_pages_free") \
            + reg.value("serving_pages_used") <= eng.alloc.n_pages
        prev = cur
    assert eng.obs.registry.value("serving_pages_used") == 0


# ------------------------------------------------------- zero perturbation
@pytest.mark.parametrize("scheduler", ["bucketed", "serial"])
def test_zero_perturbation(both, scheduler):
    """Tokens and the dispatch caches are the same with tracing on, off and
    unconfigured."""
    _, port = both
    runs = []
    for bundle in (None, obs.Observability(trace=False),
                   obs.Observability(trace=True)):
        eng = port.Engines[scheduler](
            port.params, port.cfg, EngineConfig(max_slots=2, capacity=32),
            observability=bundle)
        hs = [eng.submit([5, 9, 17, 2], SamplingParams(
                  max_new_tokens=6, temperature=0.8, seed=11)),
              eng.submit([1, 2], SamplingParams(max_new_tokens=4))]
        eng.run()
        runs.append(([h.result().tokens for h in hs], eng.compile_stats(),
                     sorted(eng._loop_cache)))
    assert runs[0] == runs[1] == runs[2]


# ------------------------------------------------------ the one clock
def test_no_raw_wall_clock_in_serving_or_models():
    """Every timestamp of the port's serving and model layers goes through
    ``repro_torch.runtime.clock``, so a VirtualClock covers all of them."""
    src = ROOT / "src" / "repro_torch"
    pat = re.compile(r"\btime\.(time|perf_counter|monotonic)\s*\(")
    offenders = [f"{p.relative_to(src)}:{i}"
                 for layer in ("serving", "models")
                 for p in sorted((src / layer).rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if pat.search(line)]
    assert not offenders, offenders


# ------------------------------------------------- the port's extension
def test_port_extension_is_disjoint_and_after_the_reference(both):
    """The port's names, phases and span names are none of the reference's
    and come after all of them: in the schema, in ``PHASES`` and in a
    bound engine's registry."""
    ref_names = {s.name for s in jobs.SERVING_METRICS}
    n = len(obs.PORT_METRICS)
    assert obs.SERVING_METRICS[-n:] == obs.PORT_METRICS
    assert obs.PORT_NAMES == {s.name for s in obs.PORT_METRICS}
    assert not obs.PORT_NAMES & ref_names
    assert obs.PHASES[-len(obs.PORT_PHASES):] == obs.PORT_PHASES
    assert not set(obs.PORT_PHASES) & set(jobs.PHASES)
    assert {f"serving_phase_{p}_seconds_total" for p in obs.PORT_PHASES} \
        <= obs.PORT_NAMES
    spans = {}
    for ns in both:
        eng, clock = traced(ns, kv_layout="paged", page_size=8)
        _workload(ns, eng, clock)
        spans[ns.name] = {e.name for e in eng.obs.trace.events()}
        if ns.name == "port":
            names = eng.obs.registry.names()
            first = min(names.index(n) for n in obs.PORT_NAMES)
            assert all(n in obs.PORT_NAMES for n in names[first:])
            assert [n for n in names if n in obs.PORT_NAMES] == \
                [s.name for s in obs.PORT_METRICS]
    assert not set(obs.PORT_SPANS) & spans["reference"]
    assert set(obs.PORT_SPANS) <= spans["port"]


class _Ticking(faults.VirtualClock):
    """A scripted clock: every read advances it 1 ms, so each span of the
    engine has its own start and end."""

    def __call__(self) -> float:
        return self.advance(1e-3)


def ticking(port, scheduler="bucketed", **ecfg):
    clock = _Ticking(start=1000.0)
    kw = dict(dict(max_slots=2, capacity=32, prefill_chunk=16,
                   decode_chunk=4), **ecfg)
    eng = port.Engines[scheduler](
        port.params, port.cfg, EngineConfig(**kw),
        injector=faults.FaultInjector(faults.FaultPlan(), clock=clock),
        observability=obs.Observability(trace=True))
    return eng, clock


@pytest.mark.parametrize("scheduler,layout", [
    ("bucketed", "ring"), ("bucketed", "paged"), ("serial", "ring")])
def test_prefill_rows_count_slots_times_bucket(both, scheduler, layout):
    """``serving_prefill_rows_total`` is Σ rows × length (the spans'
    ``row_bucket`` × ``bucket``) over the ``prefill_dispatch`` spans (the
    serial engine: Σ prompt lengths); the rows needed,
    ``serving_prefill_tokens_total``, are fewer."""
    _, port = both
    eng, clock = ticking(port, scheduler, kv_layout=layout, page_size=8)
    _workload(port, eng, clock)
    spans = [e for e in eng.obs.trace.events()
             if e.name == "prefill_dispatch"]
    reg = eng.obs.registry
    assert len(spans) == reg.value("serving_prefill_dispatches_total") >= 3
    rows = reg.value("serving_prefill_rows_total")
    assert rows == sum(e.args.get("row_bucket", 1) * e.args["bucket"]
                       for e in spans)
    # two slots are fewer than the fewest compact rows (8 at length 16)
    assert reg.value("serving_prefill_compact_total") == 0
    if scheduler == "bucketed":
        assert all(e.args["row_bucket"] == len(eng.slots) for e in spans)
    needed = reg.value("serving_prefill_tokens_total")
    if scheduler == "serial":
        assert rows == needed
    else:
        assert 0 < needed < rows


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_phases_are_disjoint_and_chunks_span_their_dispatch(both, layout):
    """On a scripted clock no two phase spans of a step overlap but
    ``page_maint`` inside its parent (``host_step_ms`` sums the phase
    counters), every phase lies inside its step, and each request's
    ``prefill_chunk`` span holds the start of its ``prefill_dispatch``
    span (the benchmark pairs them by time)."""
    _, port = both
    eng, clock = ticking(port, kv_layout=layout, page_size=8)
    _workload(port, eng, clock)
    events = eng.obs.trace.events()
    phases = sorted((e for e in events if e.name in obs.PHASES),
                    key=lambda e: e.ts)
    top = [e for e in phases if e.name != "page_maint"]
    assert {"prefill_build", "decode_build"} <= {e.name for e in top}
    for a, b in zip(top, top[1:]):
        assert a.ts + a.dur <= b.ts, (a, b)
    maint = [e for e in phases if e.name == "page_maint"]
    assert maint or layout == "ring"
    for m in maint:
        assert any(p.ts <= m.ts and m.ts + m.dur <= p.ts + p.dur
                   and p.name in ("admit", "prefill_build", "decode_build")
                   for p in top), m
    steps = [e for e in events if e.name == "step"]
    for p in top:
        assert any(s.ts <= p.ts and p.ts + p.dur <= s.ts + s.dur
                   for s in steps), p
    chunks = [e for e in events if e.name == "prefill_chunk"]
    starts = sorted(e.ts for e in events if e.name == "prefill_dispatch")
    assert chunks and starts
    for c in chunks:
        i = bisect.bisect_left(starts, c.ts)
        assert i < len(starts) and starts[i] <= c.ts + c.dur, c


def test_capture_counters_equal_the_dispatch_caches(both):
    """After ``warmup()`` the compiles counted equal the dispatch caches, one
    boot-track span each (its kind, key and kernel nodes: none for an
    eager body); a workload of stop-set width 1 adds none, a request with
    two stop ids one (its width-2 decode loop)."""
    _, port = both
    eng, clock = ticking(port)
    eng.warmup()
    reg = eng.obs.registry

    def compiled():
        return len(eng._prefill_cache) + len(eng._loop_cache)

    n = reg.value("serving_graph_captures_total")
    assert n == compiled() > 0
    spans = [e for e in eng.obs.trace.events() if e.name == obs.CAPTURE_SPAN]
    assert len(spans) == n
    assert all(e.track == obs.TRACK_BOOT and e.args["kernels"] == 0
               for e in spans)
    assert {tuple(e.args["key"]) for e in spans
            if e.args["kind"] == "decode"} == set(eng._loop_cache)
    assert sorted(tuple(e.args["key"]) for e in spans
                  if e.args["kind"] == "prefill") == sorted(eng._prefill_cache)
    capture_s = reg.value("serving_graph_capture_seconds_total")
    assert capture_s == pytest.approx(sum(e.dur for e in spans))
    assert 0 < capture_s < reg.value("serving_warmup_seconds_total")
    assert [d["kernels"] for d in eng.graph_stats()["dispatches"]] == \
        [0] * n
    eng.submit([1, 2, 3], SamplingParams(max_new_tokens=5))
    eng.submit([4, 5], SamplingParams(max_new_tokens=3, temperature=0.8,
                                      seed=1))
    eng.run()
    assert reg.value("serving_graph_captures_total") == n == compiled()
    eng.submit([6, 7], SamplingParams(max_new_tokens=4, stop={3, 9}))
    eng.run()
    assert reg.value("serving_graph_captures_total") == n + 1 == compiled()


@pytest.mark.parametrize("scheduler", ["bucketed", "serial"])
def test_device_spans_of_eager_dispatches_are_the_engine_clock(both,
                                                              scheduler):
    """On the CPU a dispatch's device span is the engine's clock around the
    call (one tick of the scripted clock): every prefill dispatch and
    every decode step is timed, each span taken once."""
    _, port = both
    eng, clock = ticking(port, scheduler)
    _workload(port, eng, clock)
    reg = eng.obs.registry
    dispatches = reg.value("serving_prefill_dispatches_total")
    assert reg.value("serving_prefill_device_timed_total") == dispatches
    assert reg.value("serving_prefill_device_seconds_total") == \
        pytest.approx(1e-3 * dispatches)
    steps = reg.value("serving_decode_steps_total")
    assert reg.value("serving_decode_device_timed_total") == steps > 0
    decodes = sum(e.name == "decode_dispatch"
                  for e in eng.obs.trace.events())
    assert reg.value("serving_decode_device_seconds_total") == \
        pytest.approx(1e-3 * decodes)
    assert eng._untimed == []


def test_spans_are_profiler_ranges_on_one_clock():
    """Under a CPU ``torch.profiler`` every span is also a profiler range of
    its name: after the offset of one mark, its start agrees with the
    recorder's within 100 µs; without a profiler none is opened."""
    from torch.profiler import ProfilerActivity, profile

    bundle = obs.Observability(trace=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with bundle.span("mark"):
            pass
        for _ in range(3):
            with bundle.span("admit"):
                sum(range(20000))
            with bundle.span("prefill_build"):
                sum(range(5000))
    with bundle.span("decode_build"):
        pass
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(e.start_ns() / 1e9)
    rec = {}
    for e in bundle.trace.events():
        rec.setdefault(e.name, []).append(e.ts)
    assert "decode_build" not in ranges
    [mark] = ranges["mark"]
    off = mark - rec["mark"][0]
    for name in ("admit", "prefill_build"):
        assert len(ranges[name]) == len(rec[name]) == 3
        for got, want in zip(sorted(ranges[name]), rec[name]):
            assert abs(got - off - want) < 100e-6, (name, got - off, want)
