"""The port's supervised recovery against the reference's
(``tests/test_recovery.py``, case by case): crash, rebuild and replay,
suspects and the blacklist, the hung-step watchdog, the circuit breaker,
shutdown races, the heartbeat fields and the launcher's signals.

Both packages serve the same PTQTP-quantized smoke qwen2-1.5b (the
reference quantizes, the port loads the same bytes). Every case runs as a
scenario on each package with that package's engine, supervisor, driver,
server and fault plan; inside it the reference test's own assertions hold,
and the records it returns must be equal: streams and finish reasons,
error texts, suspects, blacklist, strikes, generation, restarts,
``replayed``, the breaker's state, HTTP statuses and bodies (without
request ids and timings) and the heartbeat fields. The launcher cases run
``python -m repro_torch.launch.serve --device cpu`` in a subprocess beside
the reference's launcher.

Every wait is bounded; every supervisor and driver is closed, and every
stall released, in a ``finally``. The watchdog case waits for the
recovery record, not for the generation counter, which is bumped before
the survivors are adopted; so every case that returns the supervisor's
record after a crash first waits for all of its recovery records.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.runtime.monitor as jmonitor
import repro.serving as jserving
import repro.serving.frontend as jfrontend
import repro_torch.runtime.monitor as pmonitor
import repro_torch.serving as pserving
import repro_torch.serving.frontend as pfrontend
from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.convert import from_jax_params

ROOT = Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

pytestmark = pytest.mark.timeout(300)  # a wedged recovery must fail fast

ECFG = dict(max_slots=2, capacity=64, decode_chunk=2, prefill_chunk=16)


def _wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(scope="module")
def both():
    """(reference, port): each package's serving, frontend and monitor
    modules, its launcher's command and its copy of the shared quantized
    model."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    ref = SimpleNamespace(name="reference", params=params, cfg=jcfg,
                          S=jserving, F=jfrontend, M=jmonitor,
                          serve=["-m", "repro.launch.serve"])
    port = SimpleNamespace(name="port", params=model, cfg=cfg,
                           S=pserving, F=pfrontend, M=pmonitor,
                           serve=["-m", "repro_torch.launch.serve",
                                  "--device", "cpu"])
    return ref, port


def run_both(both, scenario):
    """``scenario(ns)`` on each package (the reference test's assertions
    inside); the records it returns must be equal. Returns the port's."""
    got = {ns.name: scenario(ns) for ns in both}
    assert got["port"] == got["reference"]
    return got["port"]


def _engine(ns, plan=None):
    inj = ns.S.FaultInjector(plan) if plan is not None else None
    return ns.S.ServingEngine(ns.params, ns.cfg, ns.S.EngineConfig(**ECFG),
                              injector=inj)


def _oracle(ns, jobs):
    """Crash-free reference streams for [(prompt, sampling kwargs), ...]."""
    eng = _engine(ns)
    hs = [eng.submit(p, ns.S.SamplingParams(**sp)) for p, sp in jobs]
    eng.run()
    return [tuple(h.output) for h in hs]


def _supervisor(ns, plans, clocks=None, **kw):
    """A started supervisor whose factory arms ``plans(FaultPlan)[g]`` on
    generation g (clean past the end of the list) and ``clocks[g]`` likewise;
    its injectors are kept as ``._injectors``."""
    built = {"n": 0}
    injectors = []
    armed = plans(ns.S.FaultPlan)

    def factory():
        g = built["n"]
        built["n"] += 1
        plan = armed[g] if g < len(armed) else ns.S.FaultPlan()
        clock = clocks[g] if clocks is not None and g < len(clocks) else None
        inj = ns.S.FaultInjector(plan, clock=clock)
        injectors.append(inj)
        return ns.S.ServingEngine(ns.params, ns.cfg,
                                  ns.S.EngineConfig(**ECFG), injector=inj)

    kw.setdefault("restart_backoff_s", 0.01)
    sup = ns.F.EngineSupervisor(factory, **kw)
    sup._injectors = injectors
    return sup.start()


def _together(sup, reqs):
    """Submit ``[(prompt, SamplingParams), ...]`` while the driver's thread
    waits on its lock, so the engine is offered them in one pass and they
    are co-resident from its first step: a crash planned for the first
    dispatches then has them all as suspects, however the threads are
    scheduled."""
    with sup.driver._cond:
        return [sup.submit(p, sp) for p, sp in reqs]


def _close(sup):
    for inj in sup._injectors:
        inj.release_stalls()
    sup.close()


def _sup_record(sup):
    return dict(generation=sup.generation, restarts=sup.restarts,
                replayed=sup.replayed, blacklist=sorted(sup.blacklist),
                strikes=dict(sup.crash_counts), degraded=sup.degraded,
                dead=sup.dead,
                suspects=[r["suspects"] for r in sup.recoveries],
                excs=[r["exc"] for r in sup.recoveries])


def _result(res):
    return res.finish_reason, tuple(res.tokens), res.error


def _post(base, obj, path="/v1/completions", method="POST"):
    data = json.dumps(obj).encode() if obj is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _sse(base, obj):
    req = urllib.request.Request(base + "/v1/completions",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    tokens, result = [], None
    with urllib.request.urlopen(req, timeout=120) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "token" in ev:
                tokens.append(ev["token"])
            else:
                result = ev
    return tokens, result


def _body(obj):
    return {k: v for k, v in obj.items()
            if k not in ("id", "ttft_s", "queue_wait_s")}


# ---------------------------------------------------------------------------
# crash → rebuild → replay, bit-identical
# ---------------------------------------------------------------------------

class TestCrashReplay:
    def test_crash_mid_decode_replays_bit_identical(self, both):
        def scenario(ns):
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=8, seed=0)),
                    ([1, 2, 3], dict(max_new_tokens=8, seed=1))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 2)],
                              blacklist_after=9)
            try:
                events = [[], []]
                handles = _together(sup, [(p, ns.S.SamplingParams(**sp))
                                          for p, sp in jobs])
                for i, h in enumerate(handles):
                    h.subscribe(events[i].append)
                results = [h.result(timeout=120) for h in handles]
                assert [r.finish_reason for r in results] == \
                    ["length", "length"]
                assert [tuple(r.tokens) for r in results] == ref
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                for i, evs in enumerate(events):
                    toks = [e for e in evs if e[0] == "token"]
                    assert [e[1] for e in toks] == list(range(8))
                    assert tuple(e[2] for e in toks) == ref[i]
                assert sup.generation == 1 and sup.restarts == 1
                assert sup.replayed == 2 and not sup.blacklist
                st = sup.stats()
                assert st["retired"] == 2 and st["generation"] == 1
                return ref, [_result(r) for r in results], _sup_record(sup)
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_single_suspect_retires_error_exactly_once(self, both):
        def scenario(ns):
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=16, seed=3)),
                    ([1, 2, 3], dict(max_new_tokens=8, seed=4))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(
                ns, lambda FP: [FP().engine_crash("decode", 1, uid=0)])
            try:
                suspect = sup.submit(jobs[0][0],
                                     ns.S.SamplingParams(**jobs[0][1]))
                victim = sup.submit(jobs[1][0],
                                    ns.S.SamplingParams(**jobs[1][1]))
                assert (suspect.uid, victim.uid) == (0, 1)
                res_s = suspect.result(timeout=120)
                res_v = victim.result(timeout=120)
                assert res_s.finish_reason == "error"
                assert "engine died (generation 0)" in res_s.error
                assert "EngineCrash" in res_s.error
                assert "blacklisted as crash suspect" in res_s.error
                assert suspect.error == res_s.error
                assert res_v.finish_reason == "length"
                assert tuple(res_v.tokens) == ref[1]
                assert sup.blacklist == {0}
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                once = [r.uid for r in sup.results()].count(0)
                assert once == 1
                assert sup.replayed == 1
                return (ref, _result(res_s), _result(res_v), once,
                        _sup_record(sup))
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_poison_request_blacklisted_on_second_strike(self, both):
        def scenario(ns):
            poison = ([5, 9, 17, 2], dict(max_new_tokens=32, seed=5))
            victim = ([1, 2, 3], dict(max_new_tokens=4, seed=6))
            ref = _oracle(ns, [poison, victim])
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 1),
                                              FP().engine_crash("decode", 4)],
                              blacklist_after=2)
            try:
                hp, hv = _together(sup, [
                    (poison[0], ns.S.SamplingParams(**poison[1])),
                    (victim[0], ns.S.SamplingParams(**victim[1]))])
                res_p = hp.result(timeout=120)
                res_v = hv.result(timeout=120)
                assert res_v.finish_reason == "length"
                assert tuple(res_v.tokens) == ref[1]
                assert res_p.finish_reason == "error"
                assert "strike 2" in res_p.error
                assert sup.blacklist == {hp.uid}
                assert sup.crash_counts[hp.uid] == 2
                assert _wait_until(lambda: sup.generation == 2)
                assert _wait_until(lambda: len(sup.recoveries) == 2)
                assert not sup.degraded
                return ref, _result(res_p), _result(res_v), _sup_record(sup)
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_crash_before_first_token_replays_clean(self, both):
        def scenario(ns):
            jobs = [([5, 9], dict(max_new_tokens=6, seed=7)),
                    ([1, 2, 3], dict(max_new_tokens=6, seed=8))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 0)],
                              blacklist_after=9)
            try:
                hs = _together(sup, [(p, ns.S.SamplingParams(**sp))
                                     for p, sp in jobs])
                got = [tuple(h.result(timeout=120).tokens) for h in hs]
                assert got == ref
                assert sup.generation == 1
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                return got, _sup_record(sup)
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_crash_mid_prefill_dedups_decoding_survivor(self, both):
        def scenario(ns):
            long_prompt = list(range(1, 40))  # > prefill_chunk → chunked
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=12, seed=9))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(ns,
                              lambda FP: [FP().engine_crash("prefill", 3)])
            try:
                survivor = sup.submit(jobs[0][0],
                                      ns.S.SamplingParams(**jobs[0][1]))
                assert _wait_until(lambda: len(survivor.output) >= 2)
                suspect = sup.submit(long_prompt, ns.S.SamplingParams(
                    max_new_tokens=12, seed=10))
                res_s = suspect.result(timeout=120)
                res_v = survivor.result(timeout=120)
                assert res_s.finish_reason == "error"
                assert "blacklisted" in res_s.error
                assert res_v.finish_reason == "length"
                assert tuple(res_v.tokens) == ref[0]
                assert sup.blacklist == {suspect.uid}
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                return ref, _result(res_s), _result(res_v), _sup_record(sup)
            finally:
                _close(sup)

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# SSE continuity across a crash (the wire-level dedup assertion)
# ---------------------------------------------------------------------------

class TestHttpRecovery:
    def test_sse_stream_continues_across_crash(self, both):
        def scenario(ns):
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=10, seed=0)),
                    ([1, 2, 3], dict(max_new_tokens=10, seed=1))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 2)],
                              blacklist_after=9)
            try:
                srv = ns.F.ThreadedHttpServer(sup).start()
            except BaseException:
                _close(sup)
                raise
            base = f"http://{srv.host}:{srv.port}"
            try:
                outs = [None, None]

                def fire(i):
                    p, sp = jobs[i]
                    outs[i] = _sse(base, {
                        "prompt": list(p), "stream": True,
                        "max_new_tokens": sp["max_new_tokens"],
                        "seed": sp["seed"]})

                ths = [threading.Thread(target=fire, args=(i,))
                       for i in (0, 1)]
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(timeout=120)
                assert not any(th.is_alive() for th in ths)
                assert all(o is not None for o in outs)
                for i, (tokens, result) in enumerate(outs):
                    assert result["finish_reason"] == "length"
                    assert tuple(tokens) == ref[i]
                assert sup.generation == 1
                return ([(tokens, _body(result)) for tokens, result in outs],
                        _sup_record(sup)["generation"])
            finally:
                srv.stop()
                _close(sup)

        run_both(both, scenario)

    def test_unsupervised_crash_maps_to_500_with_detail(self, both):
        def scenario(ns):
            eng = _engine(ns, ns.S.FaultPlan().engine_crash("decode", 0))
            driver = ns.F.EngineDriver(eng).start()
            try:
                srv = ns.F.ThreadedHttpServer(driver).start()
            except BaseException:
                driver.close()
                raise
            base = f"http://{srv.host}:{srv.port}"
            try:
                status, _h, body = _post(base, {"prompt": [1, 2, 3],
                                                "max_new_tokens": 4})
                assert status == 500
                assert "engine died (generation 0)" in body["error"]
                assert "EngineCrash" in body["error"]
                return status, _body(body)
            finally:
                srv.stop()
                driver.close()

        run_both(both, scenario)

    def test_degraded_sheds_503_with_retry_after(self, both):
        def scenario(ns):
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 1),
                                              FP().engine_crash("decode", 0)],
                              max_restarts=2, crash_window_s=300.0,
                              retry_after_s=7.0, blacklist_after=9)
            try:
                srv = ns.F.ThreadedHttpServer(sup).start()
            except BaseException:
                _close(sup)
                raise
            base = f"http://{srv.host}:{srv.port}"
            try:
                SP = ns.S.SamplingParams
                hs = _together(sup, [
                    ([5, 9, 17], SP(max_new_tokens=8, seed=0)),
                    ([1, 2, 3], SP(max_new_tokens=8, seed=1))])
                results = [h.result(timeout=120) for h in hs]
                assert all(r.finish_reason == "length" for r in results)
                assert _wait_until(lambda: sup.degraded)
                assert _wait_until(lambda: len(sup.recoveries) == 2)
                assert sup.restarts == 2
                status, headers, body = _post(base, {"prompt": [1, 2],
                                                     "max_new_tokens": 2})
                assert status == 503
                assert headers.get("Retry-After") == "7"
                assert body["degraded"] is True
                assert "degraded" in body["error"]
                h_status, _h, health = _post(base, None, path="/healthz",
                                             method="GET")
                assert health["supervisor"]["degraded"] is True
                assert health["supervisor"]["restarts"] == 2
                return ([_result(r) for r in results], status,
                        headers.get("Retry-After"), body, h_status,
                        health["supervisor"], _sup_record(sup))
            finally:
                srv.stop()
                _close(sup)

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# watchdog: a hung step is a crash
# ---------------------------------------------------------------------------

class TestWatchdog:
    def test_hung_step_recovers_and_replays(self, both):
        """stall_step wedges the driver thread inside step() after jumping
        the virtual clock past the watchdog budget: the supervisor reaps it,
        rebuilds and replays; the stalled thread, released, exits without
        touching the migrated handles. The rebuilt generation runs on a
        virtual clock too, so its first steps (the reference compiles its
        programs in them) cannot outlast the watchdog's budget on a loaded
        machine: the one hang is the planned one."""
        def scenario(ns):
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=8, seed=11)),
                    ([1, 2, 3], dict(max_new_tokens=8, seed=12))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(
                ns, lambda FP: [FP().stall_step(at_step=3, hang_s=60.0)],
                clocks=[ns.S.VirtualClock(), ns.S.VirtualClock()],
                watchdog_step_timeout_s=5.0, blacklist_after=9)
            try:
                hs = _together(sup, [(p, ns.S.SamplingParams(**sp))
                                     for p, sp in jobs])
                inj = sup._injectors[0]
                assert inj.stall_engaged.wait(timeout=60)
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                rec = sup.recoveries[0]
                assert rec["exc"].startswith("StepTimeout")
                inj.release_stalls()  # the wedged thread wakes, exits
                got = [tuple(h.result(timeout=120).tokens) for h in hs]
                assert got == ref
                assert sup.replayed == 2
                assert all(len(h.output) == 8 for h in hs)
                return got, _sup_record(sup)
            finally:
                _close(sup)

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# breaker lifecycle + terminal factory failure
# ---------------------------------------------------------------------------

class TestBreaker:
    def test_breaker_closes_after_quiet_window(self, both):
        def scenario(ns):
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 0)],
                              max_restarts=1, crash_window_s=0.2,
                              blacklist_after=9)
            try:
                SP = ns.S.SamplingParams
                hs = _together(sup, [
                    ([1, 2, 3], SP(max_new_tokens=4, seed=0)),
                    ([4, 5], SP(max_new_tokens=4, seed=1))])
                results = [h.result(timeout=120) for h in hs]
                assert all(r.finish_reason == "length" for r in results)
                assert _wait_until(lambda: sup.restarts == 1)
                assert _wait_until(lambda: len(sup.recoveries) == 1)
                assert _wait_until(lambda: not sup.degraded)
                h2 = sup.submit([4, 5], SP(max_new_tokens=2, seed=1))
                r2 = h2.result(timeout=120)
                assert r2.finish_reason == "length"
                return ([_result(r) for r in results + [r2]],
                        _sup_record(sup))
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_factory_failure_is_terminal(self, both):
        def scenario(ns):
            built = {"n": 0}

            def factory():
                if built["n"] >= 1:
                    raise RuntimeError("no artifact to rebuild from")
                built["n"] += 1
                return _engine(ns, ns.S.FaultPlan().engine_crash("decode", 0))

            sup = ns.F.EngineSupervisor(factory,
                                        restart_backoff_s=0.01).start()
            try:
                h = sup.submit([1, 2, 3],
                               ns.S.SamplingParams(max_new_tokens=4))
                res = h.result(timeout=120)
                assert res.finish_reason == "error"
                assert _wait_until(lambda: sup.dead)
                with pytest.raises(ns.F.DegradedError,
                                   match="permanently failed") as e:
                    sup.submit([4, 5], ns.S.SamplingParams(max_new_tokens=2))
                status = sup.supervisor_status()
                assert status["dead"] is True
                return _result(res), str(e.value), e.value.retry_after, \
                    status
            finally:
                sup.close()

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# drain/close vs crash races
# ---------------------------------------------------------------------------

class TestShutdownRaces:
    def test_drain_racing_a_crash_never_hangs(self, both):
        def scenario(ns):
            jobs = [([5, 9, 17, 2], dict(max_new_tokens=8, seed=13)),
                    ([1, 2, 3], dict(max_new_tokens=8, seed=14))]
            ref = _oracle(ns, jobs)
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 1)],
                              blacklist_after=9)
            try:
                hs = _together(sup, [(p, ns.S.SamplingParams(**sp))
                                     for p, sp in jobs])
                assert _wait_until(lambda: all(h._delivered > 0 for h in hs))
                assert sup.drain(timeout=60.0)
                got = [tuple(h.result(timeout=120).tokens) for h in hs]
                assert got == ref
                return got
            finally:
                _close(sup)

        run_both(both, scenario)

    def test_close_is_idempotent_after_crash(self, both):
        def scenario(ns):
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 0)],
                              blacklist_after=9)
            try:
                SP = ns.S.SamplingParams
                hs = _together(sup, [
                    ([1, 2, 3], SP(max_new_tokens=4, seed=0)),
                    ([4, 5], SP(max_new_tokens=4, seed=1))])
                results = [h.result(timeout=120) for h in hs]
                assert all(r.finish_reason == "length" for r in results)
                assert _wait_until(lambda: len(sup.recoveries) == 1)
            finally:
                _close(sup)
            sup.close()  # a second close is a no-op, not an error
            return [_result(r) for r in results], _sup_record(sup)

        run_both(both, scenario)

    def test_unsupervised_driver_close_after_fatal(self, both):
        def scenario(ns):
            eng = _engine(ns, ns.S.FaultPlan().engine_crash("decode", 0))
            driver = ns.F.EngineDriver(eng).start()
            try:
                h = driver.submit([1, 2, 3],
                                  ns.S.SamplingParams(max_new_tokens=4))
                res = h.result(timeout=120)
                assert res.finish_reason == "error"
                assert "engine died (generation 0)" in res.error
                assert h.error == res.error
                assert driver.fatal_exc is not None
                drained = driver.drain(timeout=10.0)
                assert drained
            finally:
                driver.close()
            driver.close()
            return _result(res), type(driver.fatal_exc).__name__, drained

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# heartbeat schema 3: generation + restarts ride the fleet protocol
# ---------------------------------------------------------------------------

class TestHeartbeat:
    def test_heartbeat_carries_generation_and_restarts(self, both, tmp_path):
        def scenario(ns):
            beat_dir = tmp_path / ns.name
            sup = _supervisor(ns, lambda FP: [FP().engine_crash("decode", 0)],
                              blacklist_after=9)
            try:
                SP = ns.S.SamplingParams
                hs = _together(sup, [
                    ([1, 2, 3], SP(max_new_tokens=4, seed=0)),
                    ([4, 5], SP(max_new_tokens=4, seed=1))])
                for h in hs:
                    assert h.result(timeout=120).finish_reason == "length"
                digest = sup.call(lambda eng: eng.obs.digest())
                assert digest["engine_generation"] == 1
                assert digest["engine_restarts"] == 1
                snap = sup.call(lambda eng: eng.health())
                snap.beat(ns.M.HeartbeatMonitor(str(beat_dir)),
                          metrics=digest)
            finally:
                _close(sup)
            beats = ns.M.StragglerDetector(str(beat_dir)).read()
            assert beats[0]["engine_generation"] == 1
            assert beats[0]["engine_restarts"] == 1
            return ({k: digest[k] for k in ("engine_generation",
                                            "engine_restarts")},
                    sorted(beats[0]), beats[0]["engine_generation"],
                    beats[0]["engine_restarts"])

        run_both(both, scenario)

    def test_detector_tolerates_pre_supervision_payloads(self, both,
                                                         tmp_path):
        def scenario(ns):
            d = tmp_path / ns.name / "heartbeats"
            d.mkdir(parents=True)
            (d / "host0000.json").write_text(json.dumps(
                {"host": 0, "t": 1.0, "step": 3}))  # v1: no supervision keys
            beats = ns.M.StragglerDetector(str(tmp_path / ns.name)).read()
            assert beats[0]["engine_generation"] == 0
            assert beats[0]["engine_restarts"] == 0
            return beats

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# the launcher: flag validation + second-signal force quit
# ---------------------------------------------------------------------------

def test_serve_supervise_requires_http(both):
    """``--supervise`` without ``--http`` is a usage error (rc 2) on both
    launchers, run in a subprocess."""
    def scenario(ns):
        out = subprocess.run(
            [sys.executable, *ns.serve, "--supervise"], cwd=ROOT,
            capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        assert out.returncode == 2, out.stderr
        assert "--supervise requires --http" in out.stderr
        return out.returncode, out.stderr.splitlines()[-1].split(
            ": error: ")[-1]

    run_both(both, scenario)


@pytest.mark.slow
def test_serve_second_sigint_force_quits_nonzero(both):
    """The first SIGINT drains; a second one quits at once with rc
    128 + SIGINT = 130, on both launchers."""
    def scenario(ns):
        proc = subprocess.Popen(
            [sys.executable, *ns.serve, "--no-quantize", "--requests", "8",
             "--max-new", "500", "--slots", "2"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                            "PYTHONUNBUFFERED": "1"})
        try:
            booted = False
            for line in proc.stdout:
                if line.startswith("[serve] boot"):
                    booted = True
                    break
            assert booted, "serve never finished booting"
            proc.send_signal(signal.SIGINT)
            forced = False
            for line in proc.stdout:
                if "draining" in line:               # first acknowledged,
                    proc.send_signal(signal.SIGINT)  # now really mean it
                if "force quit" in line:
                    forced = True
                    break
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        assert forced, "second signal never hit the force-quit handler"
        assert rc == 128 + signal.SIGINT, rc
        return forced, rc

    run_both(both, scenario)


# ---------------------------------------------------------------------------
# the port's own: a dead engine stops, a broken graph is a crash
# ---------------------------------------------------------------------------

def test_abandoned_engine_reaches_the_device_no_more(both):
    """``abandon()`` (what a supervisor's reap calls): the next step raises
    ``EngineCrash`` before any dispatch, and the reaped driver drops the
    engine."""
    _, port = both
    eng = _engine(port)
    eng.submit([5, 9, 17, 2], port.S.SamplingParams(max_new_tokens=8))
    eng.step()
    counts = dict(eng._dispatch_counts)
    eng.abandon()
    with pytest.raises(port.S.EngineCrash, match="abandoned"):
        eng.step()
    assert eng._dispatch_counts == counts
    driver = port.F.EngineDriver(_engine(port))
    driver.reap()
    assert driver.engine is None


def test_graph_failure_reaches_the_supervisor_as_a_crash(both):
    """A dispatch whose capture or replay fails raises ``GraphFailure``: the
    engine's containment lets it through with every row of the dispatch as
    a suspect, and a supervisor rebuilds and replays bit-identically."""
    from repro_torch.serving.graphs import GraphFailure

    _, port = both
    jobs = [([5, 9, 17, 2], dict(max_new_tokens=8, seed=0)),
            ([1, 2, 3], dict(max_new_tokens=8, seed=1))]
    ref = _oracle(port, jobs)
    built = []

    def factory():
        eng = _engine(port)
        if not built:
            def broken(n_steps, poison=None):
                raise GraphFailure("CUDA graph replay failed: injected")
            eng._decode_loop = broken
        built.append(eng)
        return eng

    sup = port.F.EngineSupervisor(factory, restart_backoff_s=0.01,
                                  blacklist_after=9).start()
    try:
        hs = _together(sup, [(p, port.S.SamplingParams(**sp))
                             for p, sp in jobs])
        got = [tuple(h.result(timeout=120).tokens) for h in hs]
    finally:
        sup.close()
    assert got == ref
    assert built[0].errors == 0 and not built[0].quarantined
    [rec] = sup.recoveries
    assert rec["exc"] == "GraphFailure: CUDA graph replay failed: injected"
    assert sorted(rec["suspects"]) == [h.uid for h in hs]
