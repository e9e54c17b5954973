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
"""

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


def assert_same(ref, port):
    assert port["names"] == ref["names"]
    assert port["scalars"] == ref["scalars"]
    assert port["hists"] == ref["hists"]
    assert port["health"] == ref["health"]
    assert port["digest"] == ref["digest"]
    # the trace's events per track, in the same order, at the same times
    tracks = {e[3] for e in ref["events"]} | {e[3] for e in port["events"]}
    for track in sorted(tracks):
        assert [e for e in port["events"] if e[3] == track] == \
            [e for e in ref["events"] if e[3] == track], track
    assert port["events"] == ref["events"]


# ---------------------------------------------------------------- the schema
def test_frozen_schema_equals_reference():
    assert obs.SERVING_METRICS == tuple(
        obs.MetricSpec(**dataclasses.asdict(s)) for s in jobs.SERVING_METRICS)
    assert obs.PHASES == jobs.PHASES
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
    assert_same(got["reference"][1], got["port"][1])
    rec = got["port"][1]
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
