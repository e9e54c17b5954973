"""The port's concurrent serving frontend against the reference's
(``tests/test_http_frontend.py``, case by case): the fair scheduler, the
engine driver, the HTTP endpoint and the launcher's graceful shutdown.

Both packages serve the same PTQTP-quantized smoke qwen2-1.5b (the
reference quantizes, the port loads the same bytes). Every case runs as a
scenario on each package with that package's engine, driver, scheduler,
server and fault harness; inside it the reference test's own assertions
hold, and the records it returns (DRR orders and sheds, streams, finish
reasons and error texts, HTTP statuses, ``Retry-After`` and JSON bodies
without request ids and timings) must be equal. The launcher case runs
``python -m repro_torch.launch.serve --device cpu`` in a subprocess beside
the reference's launcher.

Every wait is bounded, and every driver and server is closed in a
``finally``.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro.serving.frontend as jfrontend
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

pytestmark = pytest.mark.timeout(300)  # a deadlocked driver must fail fast


def _wait_until(pred, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(scope="module")
def both():
    """(reference, port): each package's serving and frontend modules and
    its copy of the shared quantized model."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    ref = SimpleNamespace(name="reference", params=params, cfg=jcfg,
                          S=jserving, F=jfrontend,
                          serve=["-m", "repro.launch.serve"])
    port = SimpleNamespace(name="port", params=model, cfg=cfg,
                           S=pserving, F=pfrontend,
                           serve=["-m", "repro_torch.launch.serve",
                                  "--device", "cpu"])
    return ref, port


def run_both(both, scenario):
    """``scenario(ns)`` on each package (the reference test's assertions
    inside); the records it returns must be equal. Returns the port's."""
    got = {ns.name: scenario(ns) for ns in both}
    assert got["port"] == got["reference"]
    return got["port"]


def _engine(ns, ecfg=None, plan=None, clock=None):
    inj = ns.S.FaultInjector(plan, clock=clock) \
        if (plan is not None or clock is not None) else None
    return ns.S.ServingEngine(
        ns.params, ns.cfg, ecfg or ns.S.EngineConfig(max_slots=2, capacity=64),
        injector=inj)


def _body(obj):
    """A JSON body without its request id and timings."""
    return {k: v for k, v in obj.items()
            if k not in ("id", "ttft_s", "queue_wait_s")}


# ---------------------------------------------------------------------------
# FairScheduler: DRR order, weights, caps, no credit banking
# ---------------------------------------------------------------------------

def _req(tenant="", cost=10):
    return types.SimpleNamespace(params=types.SimpleNamespace(tenant=tenant),
                                 cost=cost)


def _fs(ns, **kw):
    kw.setdefault("cost", lambda h: h.cost)
    return ns.F.FairScheduler(**kw)


class TestFairScheduler:
    def test_single_tenant_is_fifo(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=100)
            hs = [_req() for _ in range(5)]
            pushed = [fs.push(h) for h in hs]
            popped = [fs.pop() for _ in range(5)]
            assert pushed == [None] * 5 and popped == hs
            assert fs.pop() is None and len(fs) == 0
            return [hs.index(h) for h in popped]

        run_both(both, scenario)

    def test_drr_alternates_between_backlogged_tenants(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=20)
            for _ in range(6):
                fs.push(_req("A", 10))
                fs.push(_req("B", 10))
            order = [fs.pop().params.tenant for _ in range(8)]
            assert order == ["A", "A", "B", "B", "A", "A", "B", "B"]
            return order

        run_both(both, scenario)

    def test_weights_scale_bandwidth(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=10, weights={"A": 2.0})
            for _ in range(6):
                fs.push(_req("A", 10))
                fs.push(_req("B", 10))
            order = [fs.pop().params.tenant for _ in range(6)]
            assert order == ["A", "A", "B", "A", "A", "B"]
            return order

        run_both(both, scenario)

    def test_empty_queue_forfeits_deficit(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=100)
            fs.push(_req("A", 10))
            a = fs.pop()
            deficit = fs._tenants["A"].deficit
            assert deficit == 0.0  # reset on empty, not 90
            fs.retire(a)
            assert "A" not in fs._tenants  # fully idle tenants are dropped
            return deficit, sorted(fs._tenants)

        run_both(both, scenario)

    def test_resident_token_cap_blocks_then_frees(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=100, tenant_max_resident_tokens=25)
            hs = [_req("A", 10) for _ in range(4)]
            for h in hs:
                fs.push(h)
            served = [fs.pop(), fs.pop()]
            assert served == hs[:2]
            capped = fs.pop()
            assert capped is None            # 20 + 10 > 25: capped
            inflight = fs.inflight_by_tenant()
            assert inflight == {"A": 20}
            fs.retire(served[0])             # room frees...
            assert fs.pop() is hs[2]         # ...and the queue moves again
            return inflight, fs.inflight_by_tenant(), fs.pending_by_tenant()

        run_both(both, scenario)

    def test_capped_tenant_does_not_starve_others(self, both):
        def scenario(ns):
            fs = _fs(ns, quantum=100, tenant_max_resident_tokens=15)
            fs.push(_req("A", 10))
            fs.push(_req("A", 10))
            fs.push(_req("B", 10))
            order = [fs.pop().params.tenant, fs.pop().params.tenant]
            assert order == ["A", "B"]  # A capped: skipped, no stall
            return order

        run_both(both, scenario)

    def test_max_pending_sheds(self, both):
        def scenario(ns):
            fs = _fs(ns, max_pending=2)
            assert fs.push(_req()) is None and fs.push(_req()) is None
            why = fs.push(_req())
            assert why is not None and "full" in why
            return why

        run_both(both, scenario)

    def test_remove_and_drain(self, both):
        def scenario(ns):
            fs = _fs(ns)
            a, b = _req("A"), _req("B")
            fs.push(a)
            fs.push(b)
            removed = [fs.remove(a), fs.remove(a)]
            assert removed == [True, False]
            drained = fs.drain()
            assert drained == [b] and len(fs) == 0
            return removed, len(drained)

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# EngineDriver: bit-identity, concurrency under faults, cancel/drain
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 17, 2], [1, 2], [3, 4, 5], [7, 11, 13, 17, 19]]


def _coop_reference(ns, reqs, ecfg=None):
    """Fault-free cooperative run of (prompt, SamplingParams) pairs →
    {(prompt, seed): tokens}."""
    eng = _engine(ns, ecfg)
    hs = [(p, sp, eng.submit(p, sp)) for p, sp in reqs]
    eng.run()
    return {(tuple(p), sp.seed): tuple(h.output) for p, sp, h in hs}


class TestEngineDriver:
    def test_bit_identical_to_cooperative(self, both):
        def scenario(ns):
            SP = ns.S.SamplingParams
            reqs = [(PROMPTS[i], SP(max_new_tokens=6, seed=i))
                    for i in range(3)]
            reqs.append((PROMPTS[3], SP(max_new_tokens=6, temperature=0.9,
                                        seed=41)))
            ref = _coop_reference(ns, reqs)
            driver = ns.F.EngineDriver(_engine(ns)).start()
            try:
                hs = [driver.submit(p, sp) for p, sp in reqs]
                streamed = list(hs[0].tokens())
                out = []
                for (p, sp), h in zip(reqs, hs):
                    res = h.result(timeout=120)
                    assert res.finish_reason == "length"
                    assert res.tokens == ref[(tuple(p), sp.seed)]
                    out.append((res.finish_reason, res.tokens))
                assert tuple(streamed) == ref[(tuple(PROMPTS[0]), 0)]
                assert driver.drain(timeout=60)
            finally:
                driver.close()
            return sorted(ref.items()), out, streamed

        run_both(both, scenario)

    def test_many_threads_with_faults_no_deadlock(self, both):
        """12 requests from 6 threads, NaN fault on uid 3: no deadlock,
        valid reasons, one victim, survivors equal a fault-free run. Which
        request gets uid 3 depends on the threads' order, so the record
        holds the oracle, the reasons and the survivors' agreement."""
        def scenario(ns):
            SP = ns.S.SamplingParams
            n_threads, per_thread = 6, 2
            reqs = [(PROMPTS[i % len(PROMPTS)],
                     SP(max_new_tokens=8, temperature=0.9, seed=i))
                    for i in range(n_threads * per_thread)]
            ref = _coop_reference(ns, reqs)
            ecfg = ns.S.EngineConfig(max_slots=2, capacity=64,
                                     quarantine_steps=None)
            plan = ns.S.FaultPlan().nan_logits(uid=3, gen_index=1)
            driver = ns.F.EngineDriver(_engine(ns, ecfg, plan=plan)).start()
            out = {}

            def client(t):
                for j in range(per_thread):
                    i = t * per_thread + j
                    p, sp = reqs[i]
                    h = driver.submit(p, sp)
                    toks = list(h.tokens())
                    out[i] = (h, tuple(toks), h.result(timeout=0.0))

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            try:
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=240)
                assert not any(th.is_alive() for th in threads), \
                    "driver deadlocked"
            finally:
                driver.close()
            assert sorted(out) == list(range(len(reqs)))
            victims, reasons = [], []
            for i, (h, toks, res) in out.items():
                assert res.finish_reason in ns.S.FINISH_REASONS
                assert toks == res.tokens
                reasons.append(res.finish_reason)
                if res.uid == 3:
                    victims.append(res.error)
                    assert res.finish_reason == "error"
                    assert "non-finite logits" in res.error
                else:
                    assert res.finish_reason == "length"
                    p, sp = reqs[i]
                    assert res.tokens == ref[(tuple(p), sp.seed)]
            assert len(victims) == 1
            return sorted(ref.items()), sorted(reasons), len(victims)

        run_both(both, scenario)

    def test_cancel_queued_and_resident(self, both):
        def scenario(ns):
            SP = ns.S.SamplingParams
            driver = ns.F.EngineDriver(_engine(
                ns, ns.S.EngineConfig(max_slots=1, capacity=64))).start()
            try:
                a = driver.submit(PROMPTS[0], SP(max_new_tokens=32))
                b = driver.submit(PROMPTS[1], SP(max_new_tokens=32))
                assert _wait_until(lambda: driver.stats()["live"] == 1)
                assert b.cancel()
                rb = b.result(timeout=60)
                assert rb.finish_reason == "cancelled" and rb.tokens == ()
                assert "before admission" in rb.error
                again = b.cancel()
                assert not again  # already finished
                assert a.cancel()  # resident: routed to engine.cancel
                ra = a.result(timeout=60)
                assert ra.finish_reason in ("cancelled", "length")
                cancelled = driver.stats()["frontend_cancelled"]
                assert cancelled == 1
            finally:
                driver.close()
            return rb.finish_reason, rb.tokens, rb.error, again, cancelled

        run_both(both, scenario)

    def test_drain_sheds_queue_and_finishes_residents(self, both):
        def scenario(ns):
            SP = ns.S.SamplingParams
            driver = ns.F.EngineDriver(_engine(
                ns, ns.S.EngineConfig(max_slots=1, capacity=64))).start()
            try:
                a = driver.submit(PROMPTS[0], SP(max_new_tokens=64))
                b = driver.submit(PROMPTS[1], SP(max_new_tokens=4))
                assert _wait_until(lambda: driver.stats()["live"] == 1)
                assert driver.drain(timeout=120)
                ra = a.result(timeout=0.0)
                assert ra.finish_reason == "length"
                rb = b.result(timeout=0.0)
                assert rb.finish_reason == "rejected" \
                    and "draining" in rb.error
                late = driver.submit(PROMPTS[2], SP(max_new_tokens=4))
                rl = late.result(timeout=60)
                assert rl.finish_reason == "rejected"
            finally:
                driver.close()
            return ([ra.finish_reason, ra.tokens],
                    [rb.finish_reason, rb.error], [rl.finish_reason, rl.error])

        run_both(both, scenario)

    def test_call_and_stats_while_running(self, both):
        def scenario(ns):
            SP = ns.S.SamplingParams
            driver = ns.F.EngineDriver(_engine(ns)).start()
            try:
                h = driver.submit(PROMPTS[0], SP(max_new_tokens=16))
                snap = driver.call(lambda eng: eng.health())
                assert snap is not None
                with pytest.raises(TypeError) as e_text:
                    driver.submit("text prompt")
                with pytest.raises(ValueError) as e_empty:
                    driver.submit([])
                res = h.result(timeout=120)
                assert res.finish_reason == "length"
                s = driver.stats()
                assert s["submitted"] == 1 and s["retired"] == 1
                prom = driver.call(
                    lambda eng: eng.obs.registry.render_prometheus())
                assert "serving_frontend_shed_total" in prom
            finally:
                driver.close()
            return (res.tokens, s, str(e_text.value), str(e_empty.value),
                    sorted(vars(snap)))

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# HTTP endpoint over a loopback socket
# ---------------------------------------------------------------------------

def _post(base, obj, path="/v1/completions", method="POST"):
    """(status, headers, parsed JSON body) — HTTP errors included."""
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
        headers = dict(resp.headers)
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            ev = json.loads(line[len("data: "):])
            if "token" in ev:
                tokens.append(ev["token"])
            else:
                result = ev
    return tokens, result, headers


def _serving(ns, engine, fairness=None):
    """A started driver over ``engine`` and a server in front of it."""
    driver = ns.F.EngineDriver(engine, fairness=fairness).start()
    try:
        srv = ns.F.ThreadedHttpServer(driver).start()
    except BaseException:
        driver.close(timeout=60)
        raise
    return driver, srv, f"http://{srv.host}:{srv.port}"


def _close(driver, srv):
    srv.stop()
    driver.close(timeout=60)


class TestHttpServer:
    def test_wire_bit_identical_and_request_id(self, both):
        def scenario(ns):
            SP = ns.S.SamplingParams
            reqs = [(PROMPTS[i], SP(max_new_tokens=6, seed=i))
                    for i in range(3)]
            ref = _coop_reference(ns, reqs)
            driver, srv, base = _serving(ns, _engine(ns))
            bodies = []
            try:
                for p, sp in reqs:
                    status, headers, body = _post(base, {
                        "prompt": p, "max_new_tokens": 6, "seed": sp.seed})
                    assert status == 200
                    assert body["finish_reason"] == "length"
                    assert tuple(body["tokens"]) == ref[(tuple(p), sp.seed)]
                    assert headers["X-Request-Id"] == str(body["id"])
                    bodies.append((status, _body(body)))
                toks, result, headers = _sse(base, {
                    "prompt": PROMPTS[0], "max_new_tokens": 6, "seed": 0,
                    "stream": True})
                assert tuple(toks) == ref[(tuple(PROMPTS[0]), 0)]
                assert result["finish_reason"] == "length"
                assert tuple(result["tokens"]) == tuple(toks)
                assert "X-Request-Id" in headers
            finally:
                _close(driver, srv)
            return bodies, toks, _body(result), headers["Content-Type"]

        run_both(both, scenario)

    def test_healthz_and_metrics(self, both):
        def scenario(ns):
            driver, srv, base = _serving(ns, _engine(ns))
            try:
                status, _h, body = _post(base, None, path="/healthz",
                                         method="GET")
                assert status == 200 and body["ok"] is True
                req = urllib.request.Request(base + "/metrics")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert resp.status == 200
                    ctype = resp.headers["Content-Type"]
                    assert ctype.startswith("text/plain")
                    text = resp.read().decode()
            finally:
                _close(driver, srv)
            assert "# TYPE" in text
            assert "serving_frontend_shed_total" in text
            assert "serving_frontend_queue_depth" in text
            types_ = sorted(ln for ln in text.splitlines()
                            if ln.startswith("# TYPE"))
            if ns.name == "port":
                # the port's declared extension of the schema, after the
                # reference's names; the reference's are compared exactly
                ours = pserving.observability.PORT_NAMES
                assert {ln.split()[2] for ln in types_} >= ours
                types_ = [ln for ln in types_ if ln.split()[2] not in ours]
            return status, sorted(body), ctype, types_

        run_both(both, scenario)

    def test_http_errors(self, both):
        def scenario(ns):
            driver, srv, base = _serving(ns, _engine(ns))
            try:
                got = [_post(base, None, path="/nope", method="GET"),
                       _post(base, None, method="GET"),  # completions
                       _post(base, {"prompt": "text"}),
                       _post(base, {"prompt": [1, 2], "bogus": 1}),
                       _post(base, {"prompt": []}),
                       _post(base, {"prompt": [1], "temperature": -1})]
            finally:
                _close(driver, srv)
            assert [g[0] for g in got] == [404, 405, 400, 400, 400, 400]
            assert "error" in got[-1][2]
            return [(status, body) for status, _h, body in got]

        run_both(both, scenario)

    def test_rejected_maps_429_with_retry_after(self, both):
        def scenario(ns):
            fair = ns.F.FairScheduler(tenant_max_resident_tokens=8)
            driver, srv, base = _serving(ns, _engine(ns), fairness=fair)
            try:
                status, headers, body = _post(
                    base, {"prompt": [1, 2, 3], "max_new_tokens": 16})
            finally:
                _close(driver, srv)
            assert status == 429
            assert headers["Retry-After"] == "1"
            assert body["finish_reason"] == "rejected"
            assert "never fit" in body["error"]
            return status, headers["Retry-After"], _body(body)

        run_both(both, scenario)

    def test_frontend_timeout_maps_504(self, both):
        """A request that deadlines in the fair queue (the slot held by a
        long request, the virtual clock jumped past its TTFT budget)."""
        def scenario(ns):
            clock = ns.S.VirtualClock()
            eng = _engine(ns, ns.S.EngineConfig(max_slots=1, capacity=64),
                          plan=ns.S.FaultPlan(), clock=clock)
            driver, srv, base = _serving(ns, eng)
            try:
                hog = driver.submit([1, 2, 3],
                                    ns.S.SamplingParams(max_new_tokens=400))
                got = {}

                def post():
                    got["resp"] = _post(base, {"prompt": [4, 5],
                                               "max_new_tokens": 4,
                                               "ttft_deadline_s": 5.0})

                th = threading.Thread(target=post)
                th.start()
                assert _wait_until(lambda: driver.stats()["live"] == 1
                                   and driver.stats()["pending"] == 1)
                driver.call(lambda _eng: clock.advance(10.0))
                th.join(timeout=120)
                assert not th.is_alive()
                status, _headers, body = got["resp"]
                assert status == 504
                assert body["finish_reason"] == "timeout"
                hog.cancel()
            finally:
                _close(driver, srv)
            return status, _body(body)

        run_both(both, scenario)

    def test_engine_error_maps_500(self, both):
        def scenario(ns):
            plan = ns.S.FaultPlan().nan_logits(uid=0, gen_index=0)
            ecfg = ns.S.EngineConfig(max_slots=2, capacity=64,
                                     quarantine_steps=None)
            driver, srv, base = _serving(ns, _engine(ns, ecfg, plan=plan))
            try:
                status, _h, body = _post(base, {"prompt": [1, 2],
                                                "max_new_tokens": 4})
            finally:
                _close(driver, srv)
            assert status == 500
            assert body["finish_reason"] == "error"
            return status, _body(body)

        run_both(both, scenario)

    def test_disconnect_mid_stream_cancels(self, both):
        def scenario(ns):
            driver, srv, base = _serving(ns, _engine(ns))
            try:
                body = json.dumps({"prompt": [1, 2, 3],
                                   "max_new_tokens": 300,
                                   "stream": True}).encode()
                s = socket.create_connection((srv.host, srv.port),
                                             timeout=60)
                s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                           f"Content-Type: application/json\r\n"
                           f"Content-Length: {len(body)}\r\n\r\n").encode()
                          + body)
                buf = b""
                while b"data: " not in buf:  # a token on the wire
                    chunk = s.recv(4096)
                    assert chunk, "stream closed before first token"
                    buf += chunk
                s.close()  # the client walks away mid-generation
                assert _wait_until(lambda: any(
                    r.finish_reason == "cancelled"
                    for r in driver.results()))
                cancelled = [r for r in driver.results()
                             if r.finish_reason == "cancelled"]
            finally:
                _close(driver, srv)
            assert cancelled, "disconnect did not cancel the request"
            assert len(cancelled[0].tokens) < 300  # it stopped early
            return len(cancelled), buf.split(b"\r\n")[0]

        run_both(both, scenario)


# ---------------------------------------------------------------------------
# the launcher: graceful signal-driven shutdown (subprocess)
# ---------------------------------------------------------------------------

def _launch(ns, *args):
    return subprocess.Popen(
        [sys.executable, *ns.serve, *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                        "PYTHONUNBUFFERED": "1"})


def _booted(proc):
    for line in proc.stdout:
        if line.startswith("[serve] boot"):
            return True
    return False


@pytest.mark.slow
def test_serve_sigint_drains_and_flushes(both, tmp_path):
    """SIGINT mid-run: queued requests cancel, residents finish, the drain
    tables print, --metrics-out flushes, exit code 0; on both launchers."""
    def scenario(ns):
        metrics = tmp_path / f"{ns.name}.prom"
        proc = _launch(ns, "--no-quantize", "--requests", "6", "--max-new",
                       "200", "--slots", "2", "--metrics-out", str(metrics))
        try:
            assert _booted(proc), "serve never finished booting"
            proc.send_signal(signal.SIGINT)
            out = proc.stdout.read()
            rc = proc.wait(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        assert rc == 0, out
        assert "drained:" in out
        assert "request latency (ms):" in out       # full epilogue ran
        assert metrics.exists() and "# TYPE" in metrics.read_text()
        return rc, "drained:" in out, "request latency (ms):" in out

    run_both(both, scenario)


# ---------------------------------------------------------------------------
# the port's engine carries what the frontend reads
# ---------------------------------------------------------------------------

FRONTEND_READS = ("clock", "ecfg", "obs", "queue", "slots", "quarantined",
                  "_next_uid", "free_admissible_slots", "cancel", "step",
                  "submit", "health")


def test_driver_builds_on_a_port_engine(both):
    """``EngineDriver`` reads ``engine.clock``: the port's engine has it, as
    the reference's does, with and without a fault injector (whose
    ``VirtualClock`` then stamps the driver's handles), and every other
    engine attribute the frontend uses."""
    ref, port = both
    for ns in both:
        eng = _engine(ns)
        assert all(hasattr(eng, a) for a in FRONTEND_READS), ns.name
    eng = _engine(port)
    assert eng.clock is eng._clock is pserving.engine.rtclock.MONOTONIC
    assert port.F.EngineDriver(eng)._clock is eng.clock
    clock = port.S.VirtualClock(7.0)
    eng = _engine(port, plan=port.S.FaultPlan(), clock=clock)
    assert eng.clock is clock
    driver = port.F.EngineDriver(eng)
    assert driver._clock is clock
    driver.start()
    try:
        h = driver.submit([1, 2, 3], port.S.SamplingParams(max_new_tokens=2))
        res = h.result(timeout=60)
    finally:
        driver.close()
    assert res.finish_reason == "length" and len(res.tokens) == 2
    assert res.t_submit == res.t_done == 7.0
