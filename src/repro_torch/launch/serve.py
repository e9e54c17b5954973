"""Serving launcher: boot a PTQTP model (from an artifact, or by init and
quantization), then serve a batch of requests through the v1 request API.

``python -m repro_torch.launch.serve --artifact DIR [--verify-artifact sizes]``
``python -m repro_torch.launch.serve --device cuda --warmup``
``python -m repro_torch.launch.serve --device cpu --requests 2 --max-new 4``
``python -m repro_torch.launch.serve --kv-layout paged --page-size 16``
``python -m repro_torch.launch.serve --scheduler serial --trace-out t.json``
``python -m repro_torch.launch.serve --http 127.0.0.1:8000 --supervise``

``repro.launch.serve`` with the same defaults and flags.
With ``--artifact`` the model and its config come from the artifact's
manifest and shards (written by either package): no floating-point weights
are built and nothing is quantized; the boot time is printed by phase.
Without it: the smoke configuration of ``--arch``, group size min(128,
d_model), ``--t-max`` iterations. One request per built-in prompt, each
seeded ``seed + i``. ``--arch`` takes every id of the port's registry:
qwen2-1.5b, qwen1.5-32b and llama3-405b (dense), gemma3-27b (sliding-window
local layers: the ring layout only, as the paged layout refuses a window
narrower than the capacity), deepseek-moe-16b and grok-1-314b (mixture of
experts), recurrentgemma-2b (RG-LRU and local attention; paged only at a
capacity within its window) and rwkv6-3b (attention-free). With a
recurrent mixer the paged layout keeps each row's recurrent state beside
the pool and the prefix cache is off (printed at boot), as in the
reference. A model with a stub modality frontend
(``embed_inputs=False``) is refused, as the reference's launcher refuses
it.

``--attn-backend`` picks the attention route of every dispatch
(``kernels.chunk_attention``): ``auto`` the hand-written kernel on the card
and the plain streaming walk on the CPU, ``pallas`` the kernel (the card
only), ``stream`` and ``materialized`` the plain twins. On the CPU the
engine serves pre-unpacked int8 trit-planes (``preunpack_decode``), and
their resident bytes are printed, as the reference prints them.

``--warmup`` captures every dispatch before serving (CUDA graphs on the
card; their capture seconds are printed). ``--scheduler serial`` serves on
the serial-admit baseline (one dispatch per prompt length; ring layout
only). ``--trace-out trace.json`` records the request lifecycle and the
engine's phases (Chrome/Perfetto JSON; boot phases on their own track);
``--metrics-out metrics.prom`` writes the Prometheus exposition at the end,
and with ``--metrics-interval N`` a one-line digest every N engine steps
and a ``.jsonl`` snapshot stream beside it. The last line is the engine's
``health()`` summary. Tokens are the same with tracing on or off.

``--http HOST:PORT`` serves network traffic instead of the built-in
prompts (``serving.frontend``): one ``EngineDriver`` thread owns the
engine, and ``POST /v1/completions`` (JSON, or SSE with ``"stream":
true``), ``GET /healthz`` and ``GET /metrics`` answer on the port (``:0``
picks a free one); admission is deficit round robin over tenants
(``--tenant-quantum``, ``--tenant-weights``, ``--max-pending``,
``--tenant-max-resident-tokens``). ``--supervise`` wraps the driver in an
``EngineSupervisor``: an engine that dies or hangs a step (the watchdog,
``--watchdog-step-timeout``) is rebuilt, from ``--artifact`` when given
(without a checksum pass), else on the model already in memory, with its
in-flight requests replayed; ``--max-restarts`` crashes within the window
open the circuit breaker (503). Either mode drains on SIGINT/SIGTERM:
intake stops, resident requests finish, the files are written and the
drain tables printed; a second signal quits at once with 128 + signum.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import threading
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.artifacts import load_model, load_model_config, read_manifest
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import clock as rtclock
from repro_torch.serving import (EngineConfig, SamplingParams,
                                 SerialAdmitEngine, ServingEngine)
from repro_torch.serving.observability import TRACK_BOOT, Observability

PROMPTS = [
    "the model computes two trit planes",
    "count 5 6 7",
    "slot 42 holds 7 ;",
    "12 plus 30 equals",
]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _boot_phase(obs, boot, name, **span_args):
    """Time one boot phase into ``boot`` and onto the trace's boot track."""
    t0 = rtclock.now()
    with obs.span(name, track=TRACK_BOOT, cat="boot", args=span_args or None):
        yield
    boot[name] = rtclock.now() - t0


def _install_drain_signals(on_signal):
    """SIGINT/SIGTERM call ``on_signal()`` (a graceful drain); a second
    signal quits at once with rc ``128 + signum``, so a process manager can
    tell a forced kill from a clean shutdown. Returns the previous
    handlers."""
    fired = {"n": 0}

    def _handler(signum, _frame):
        fired["n"] += 1
        if fired["n"] > 1:
            # no more waiting, wherever the main thread is blocked (drain
            # join, step loop, Event.wait); os._exit skips the flushes
            print(f"[serve] force quit (rc {128 + signum})", flush=True)
            os._exit(128 + signum)
        print(f"[serve] {signal.Signals(signum).name}: draining "
              "(signal again to force quit)", flush=True)
        on_signal()

    return [(s, signal.signal(s, _handler))
            for s in (signal.SIGINT, signal.SIGTERM)]


def _drain_report(results, engine, tok, args, dt, jsonl_f, jsonl_path):
    """The shutdown tables and file flushes of the batch and HTTP paths:
    throughput, per-request latency, the registry summary, the health
    line, then --metrics-out and --trace-out."""
    reg = engine.obs.registry
    n_tok = sum(len(r.tokens) for r in results)
    stats = engine.compile_stats()
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, {engine.steps} decode steps, "
          f"{engine.prefill_steps} prefill steps; {stats['n_prefill_compiles']}"
          f" prefill + {stats['n_decode_compiles']} decode dispatches "
          f"compiled)")
    if engine.paged:
        a = engine.alloc
        print(f"[serve] paged KV: {a.n_pages} pages of {a.page_size} tokens; "
              f"prefix cache hits {a.hits}, misses {a.misses}, forks "
              f"{a.forks}, evictions {a.evictions}, peak used {a.peak_used}")
    ttft = sorted(1e3 * r.ttft for r in results if r.t_first)
    if ttft:
        print(f"[serve] ttft ms: median {ttft[len(ttft) // 2]:.1f} "
              f"max {ttft[-1]:.1f}")
    for r in sorted(results, key=lambda r: r.uid)[:4]:
        print(f"  [{r.uid}] ({r.finish_reason}, ttft {1e3 * r.ttft:.1f}ms) -> "
              f"{tok.decode(list(r.tokens))!r}")
    print("[serve] request latency (ms):")
    print(f"  {'uid':>4} {'reason':>9} {'tok':>4} {'queue':>8} "
          f"{'ttft':>8} {'total':>8}")
    for r in sorted(results, key=lambda r: r.uid):
        total = (r.t_done - r.t_submit) if r.t_done else 0.0
        print(f"  {r.uid:>4} {r.finish_reason:>9} {len(r.tokens):>4} "
              f"{1e3 * r.queue_wait:>8.1f} {1e3 * r.ttft:>8.1f} "
              f"{1e3 * total:>8.1f}")
    print("[serve] metrics summary:")
    for line in reg.summary_table().splitlines():
        print(f"  {line}")
    if jsonl_f is not None:
        jsonl_f.write(reg.jsonl_line() + "\n")  # final snapshot
        jsonl_f.close()
        print(f"[serve] metrics snapshots -> {jsonl_path}")
    if args.metrics_out:
        Path(args.metrics_out).write_text(reg.render_prometheus())
        print(f"[serve] metrics -> {args.metrics_out}")
    if args.trace_out:
        engine.obs.trace.write(args.trace_out)
        print(f"[serve] trace ({len(engine.obs.trace)} events) -> "
              f"{args.trace_out}")
    print(f"[serve] health: {engine.health().summary()}")


def _serve_http(engine, tok, args, stop, factory):
    """``--http``: hand the engine to an ``EngineDriver`` (the only thread
    that touches it from here on; under ``--supervise`` an
    ``EngineSupervisor`` that rebuilds it with ``factory``), serve until
    ``stop`` is set (SIGINT/SIGTERM), then drain and print the report of
    the batch path."""
    from repro_torch.serving.frontend import (EngineDriver, EngineSupervisor,
                                              FairScheduler,
                                              ThreadedHttpServer)

    host, _, port = args.http.rpartition(":")
    host = host or "127.0.0.1"
    weights = {}
    for pair in (args.tenant_weights or "").split(","):
        if pair.strip():
            name, _, w = pair.partition("=")
            weights[name.strip()] = float(w or 1.0)

    def make_fair():
        return FairScheduler(
            quantum=args.tenant_quantum, weights=weights,
            max_pending=args.max_pending,
            tenant_max_resident_tokens=args.tenant_max_resident_tokens)

    if args.supervise:
        driver = EngineSupervisor(
            factory, engine=engine, fairness_factory=make_fair,
            max_restarts=args.max_restarts,
            restart_backoff_s=args.restart_backoff,
            watchdog_step_timeout_s=args.watchdog_step_timeout).start()
    else:
        driver = EngineDriver(engine, fairness=make_fair()).start()
    srv = ThreadedHttpServer(driver, host, int(port)).start()
    print(f"[serve] http: listening on http://{srv.host}:{srv.port} "
          "(POST /v1/completions, GET /healthz, GET /metrics"
          f"{'; supervised' if args.supervise else ''})", flush=True)

    t0 = rtclock.now()
    interval = max(args.metrics_interval, 0)
    jsonl_path = (Path(args.metrics_out).with_suffix(".jsonl")
                  if args.metrics_out and interval else None)
    jsonl_f = open(jsonl_path, "w") if jsonl_path else None
    # --metrics-interval is seconds between digests here (there is no step
    # loop to count); engine reads go through the driver's thread
    while not stop.wait(interval if interval else None):
        try:
            print(driver.call(lambda eng: _stats_line(eng, t0)), flush=True)
            if jsonl_f is not None:
                jsonl_f.write(driver.call(
                    lambda eng: eng.obs.registry.jsonl_line()) + "\n")
        except (RuntimeError, TimeoutError) as e:
            # supervised: the engine may be mid-rebuild (or dead)
            print(f"[serve] stats unavailable: {e}", flush=True)

    srv.stop()                      # stop accepting connections first,
    driver.drain(timeout=300.0)     # then let offered work finish
    driver.close()
    dt = rtclock.now() - t0
    results = driver.results()
    front = driver.stats()
    print(f"[serve] drained: {front['retired']} retired "
          f"({front['frontend_sheds']} frontend sheds, "
          f"{front['frontend_cancelled']} cancelled pre-admission)")
    if args.supervise:
        sup = driver.supervisor_status()
        print(f"[serve] supervisor: generation {sup['generation']}, "
              f"{sup['restarts']} restarts, {sup['replayed']} replayed, "
              f"degraded={sup['degraded']}, "
              f"blacklisted={sup['blacklisted']}")
        engine = driver.engine  # the surviving generation
    _drain_report(results, engine, tok, args, dt, jsonl_f, jsonl_path)
    return results


def _stats_line(engine, t_serve0):
    """The periodic one-line digest, read off the registry."""
    reg = engine.obs.registry
    elapsed = max(rtclock.now() - t_serve0, 1e-9)
    done = reg.value("serving_requests_completed_total")
    line = (f"[serve] step {engine.engine_steps}: "
            f"{done / elapsed:.2f} req/s "
            f"resident={reg.value('serving_resident_slots')} "
            f"queue={reg.value('serving_queue_depth')} "
            f"tokens={reg.value('serving_tokens_generated_total')}")
    if "serving_pages_free" in reg:
        line += f" pages_free={reg.value('serving_pages_free')}"
    ttft = reg.get_histogram("serving_ttft_seconds")
    if ttft.count:
        line += f" p99_ttft={1e3 * ttft.percentile(99):.1f}ms"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--artifact", default=None, metavar="PATH",
                    help="boot from a trit-plane artifact (written by "
                         "repro_torch.launch.quantize or repro's) instead of "
                         "init+quantize; --arch and the quantize flags are "
                         "ignored")
    ap.add_argument("--verify-artifact", nargs="?", const="full",
                    choices=("off", "sizes", "full"), default="off",
                    help="artifact integrity check at boot: 'sizes' "
                         "stat-checks shard lengths without reading tensor "
                         "bytes; 'full' (also the value when the flag is "
                         "given bare) re-checksums every buffer")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k truncation (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus sampling mass (1.0 = off)")
    ap.add_argument("--stream", action="store_true",
                    help="consume the first request token-by-token through "
                         "RequestHandle.tokens()")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request end-to-end budget in seconds; an "
                         "expired request retires with finish_reason "
                         "'timeout', keeping the tokens it produced")
    ap.add_argument("--ttft-deadline", type=float, default=None, metavar="S",
                    help="per-request budget for the first token, seconds")
    ap.add_argument("--max-queue", type=int, default=None, metavar="N",
                    help="admission cap on waiting requests (load shedding)")
    ap.add_argument("--max-resident-tokens", type=int, default=None,
                    metavar="N",
                    help="admission cap on the committed token footprint "
                         "(clipped prompt + generation budget) over queued "
                         "plus resident work")
    ap.add_argument("--admission-policy", choices=("reject", "block"),
                    default="reject",
                    help="what submit() does past a cap: 'reject' sheds the "
                         "request (finish_reason 'rejected'), 'block' drives "
                         "engine steps until it fits")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens consumed per slot per engine step")
    ap.add_argument("--scheduler", choices=("bucketed", "serial"),
                    default="bucketed",
                    help="bucketed/chunked admission (default) or the "
                         "serial-admit baseline (one dispatch per prompt "
                         "length)")
    ap.add_argument("--attn-backend",
                    choices=("auto", "pallas", "stream", "materialized"),
                    default="auto",
                    help="attention route (repro_torch.kernels."
                         "chunk_attention): auto = the hand-written CUDA "
                         "kernel on the card, the plain streaming online-"
                         "softmax walk on the CPU; pallas = the CUDA kernel; "
                         "stream / materialized = the plain twins (the "
                         "materialized one: the full score block)")
    ap.add_argument("--kv-layout", choices=("ring", "paged"), default="ring",
                    help="KV-cache storage: 'ring' = contiguous per slot; "
                         "'paged' = fixed-size pages from a shared pool "
                         "with copy-on-write prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per physical KV page (paged layout); must "
                         "divide --capacity")
    ap.add_argument("--max-pages", type=int, default=None, metavar="N",
                    help="physical page pool size (paged layout; default "
                         "slots*capacity/page_size = the ring footprint; "
                         "lower overcommits against prefix sharing)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="copy-on-write prefix-page reuse across requests "
                         "(paged layout; cache-hit prompt pages skip "
                         "prefill)")
    ap.add_argument("--warmup", action="store_true",
                    help="capture every dispatch before serving (CUDA "
                         "graphs on the card)")
    ap.add_argument("--no-quantize", action="store_true",
                    help="serve FP weights (baseline)")
    ap.add_argument("--t-max", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight-init seed; request i samples from its own "
                         "stream seeded seed+i")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace.json of boot phases, "
                         "request lifecycles and engine-step phases")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the Prometheus text exposition of the "
                         "metrics registry at the end; a .jsonl snapshot "
                         "stream is written next to it when "
                         "--metrics-interval is set")
    ap.add_argument("--metrics-interval", type=int, default=0, metavar="N",
                    help="print a one-line stats digest (and append a "
                         "registry snapshot to the JSONL stream) every N "
                         "engine steps (0 = off); in --http mode, every N "
                         "seconds")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="serve over HTTP instead of the built-in prompts: "
                         "POST /v1/completions (SSE with \"stream\": true), "
                         "GET /healthz, GET /metrics; ':0' picks a free "
                         "port; SIGINT/SIGTERM drains")
    ap.add_argument("--supervise", action="store_true",
                    help="(--http) wrap the driver in an EngineSupervisor: "
                         "an engine that dies or hangs a step is rebuilt "
                         "(from --artifact when given, else on the model in "
                         "memory) and its in-flight requests replayed")
    ap.add_argument("--max-restarts", type=int, default=3, metavar="N",
                    help="circuit breaker: N crashes within the crash "
                         "window shed new submits with HTTP 503 and "
                         "Retry-After while replayed work finishes")
    ap.add_argument("--restart-backoff", type=float, default=0.5,
                    metavar="S",
                    help="seconds between an engine's death and its "
                         "rebuild; doubles per crash in the window")
    ap.add_argument("--watchdog-step-timeout", type=float, default=None,
                    metavar="S",
                    help="treat an engine step running longer than S "
                         "seconds (on the engine's clock) as a crash "
                         "(default: no watchdog)")
    ap.add_argument("--tenant-quantum", type=int, default=256, metavar="TOK",
                    help="(--http) deficit round robin: committed tokens "
                         "added to a tenant's deficit per round")
    ap.add_argument("--tenant-weights", default=None, metavar="T=W,...",
                    help="per-tenant weights, e.g. 'paid=4,free=1' "
                         "(default 1.0)")
    ap.add_argument("--max-pending", type=int, default=None, metavar="N",
                    help="(--http) cap on requests waiting in the fair "
                         "queue across tenants; past it submits shed with "
                         "HTTP 429")
    ap.add_argument("--tenant-max-resident-tokens", type=int, default=None,
                    metavar="N",
                    help="(--http) per-tenant cap on committed tokens "
                         "inside the engine")
    args = ap.parse_args(argv)
    if args.supervise and args.http is None:
        ap.error("--supervise requires --http (the batch path has no "
                 "driver to supervise)")
    if args.kv_layout == "paged":
        if args.scheduler == "serial":
            ap.error("--kv-layout paged requires the bucketed scheduler "
                     "(the serial baseline prefills into a private ring)")
        if args.capacity % args.page_size:
            ap.error(f"--capacity {args.capacity} must be a whole number of "
                     f"pages (--page-size {args.page_size})")

    dev = resolve_device(args.device)
    # one bundle for the process: boot spans land on its trace before the
    # engine exists, then the engine binds its registry
    obs = Observability(trace=args.trace_out is not None)
    boot = {}
    t_boot = rtclock.now()
    if args.artifact:
        cfg = load_model_config(read_manifest(args.artifact))
        if not cfg.embed_inputs:
            ap.error(f"artifact model {cfg.name} has a stub modality "
                     "frontend; token serving applies to LM archs")
        with _boot_phase(obs, boot, "artifact_load",
                         verify=args.verify_artifact):
            model, cfg, manifest = load_model(
                args.artifact, verify=args.verify_artifact, device=dev,
                timings=boot)
        stats = manifest.get("stats", {})
        print(f"[serve] artifact: {manifest['arch']} "
              f"({stats.get('n_quantized', '?')} quantized kernels, "
              f"{stats.get('total_bytes', 0) / 1e6:.2f} MB; verify "
              f"{args.verify_artifact})")
        print("[serve] boot by phase: " + ", ".join(
            f"{k} {1e3 * v:.1f}ms" for k, v in boot.items()))
    else:
        cfg = configs.get_smoke_config(args.arch)
        if not cfg.embed_inputs:  # reject stub archs before any boot work
            ap.error(f"{args.arch} has a stub modality frontend; token "
                     "serving applies to LM archs")
        with _boot_phase(obs, boot, "weight_init"):
            gen = torch.Generator(device=dev).manual_seed(args.seed)
            model = init_params(cfg, gen, device=dev)
        if not args.no_quantize:
            with _boot_phase(obs, boot, "quantize", t_max=args.t_max):
                gs = min(128, cfg.d_model)
                model, report = quantize_tree(
                    model, PTQTPConfig(group_size=gs, t_max=args.t_max))
                _sync(dev)
            tot = report["__total__"]
            print(f"[serve] PTQTP: {tot['n_quantized']} kernels, "
                  f"{tot['compression']:.2f}x compression, "
                  f"{boot['quantize']:.1f}s")

    tok = ByteTokenizer()
    cls = ServingEngine if args.scheduler == "bucketed" else SerialAdmitEngine
    ecfg = EngineConfig(
        max_slots=args.slots, capacity=args.capacity,
        prefill_chunk=args.prefill_chunk, attn_backend=args.attn_backend,
        max_queue=args.max_queue,
        max_resident_tokens=args.max_resident_tokens,
        admission_policy=args.admission_policy,
        kv_layout=args.kv_layout, page_size=args.page_size,
        max_pages=args.max_pages, prefix_cache=args.prefix_cache)
    with _boot_phase(obs, boot, "engine_init", scheduler=args.scheduler):
        engine = cls(model, cfg, ecfg, observability=obs)
    mem = engine.memory_stats()
    if engine.paged:
        why = ("" if engine._prefix_reuse or not args.prefix_cache else
               " (a recurrent mixer's state cannot skip a shared prefix)")
        print(f"[serve] paged KV: pool {engine.alloc.n_pages} pages x "
              f"{args.page_size} tokens ({mem['kv_pool_bytes'] / 1e6:.2f} MB"
              f", {mem['kv_page_bytes'] / 1e3:.1f} KB/page across layers), "
              f"prefix cache {'on' if engine._prefix_reuse else 'off'}{why}")
    if mem["preunpack_decode"]:
        # pre-unpacked planes are int8 trits, 4x the packed bytes
        print(f"[serve] resident planes "
              f"{mem['resident_plane_bytes'] / 1e6:.2f} MB "
              f"({mem['preunpack_ratio']:.1f}x packed "
              f"{mem['packed_plane_bytes'] / 1e6:.2f} MB, preunpack_decode); "
              f"decode state {mem['decode_state_bytes'] / 1e6:.2f} MB; "
              f"total resident {mem['resident_total_bytes'] / 1e6:.2f} MB")

    def engine_factory():
        # a supervised rebuild: reload the artifact (no checksum pass; it
        # sheds whatever state the dying generation may have corrupted),
        # else reuse the model in memory; each generation gets a fresh
        # Observability (bind_engine binds once)
        m = model
        if args.artifact:
            m, _, _ = load_model(args.artifact, verify="off", device=dev)
        return cls(m, cfg, ecfg, observability=Observability(
            trace=args.trace_out is not None))
    if args.warmup:
        with _boot_phase(obs, boot, "warmup"):
            engine.warmup()
            _sync(dev)
        stats = engine.compile_stats()
        print(f"[serve] warmup: {stats['n_prefill_compiles']} prefill + "
              f"{stats['n_decode_compiles']} decode dispatches "
              f"({engine.graph_stats()['capture_s']:.2f}s of capture) in "
              f"{boot['warmup']:.1f}s")
    # graceful drain on SIGINT/SIGTERM, armed before the boot line so a
    # signal may come the moment boot is announced
    draining = threading.Event()
    previous = _install_drain_signals(draining.set)
    try:
        print(f"[serve] boot {rtclock.now() - t_boot:.2f}s on {dev}",
              flush=True)
        if args.http is not None:
            return _serve_http(engine, tok, args, draining, engine_factory)
        return _serve_batch(engine, tok, args, draining)
    finally:
        for s, h in previous:
            signal.signal(s, h)


def _serve_batch(engine, tok, args, draining):
    """The built-in prompts, one request each, driven to the end (queued
    requests are cancelled once ``draining`` is set)."""
    handles = []
    for i in range(args.requests):
        prompt = tok.encode(PROMPTS[i % len(PROMPTS)], eos=False)
        h = engine.submit(prompt, SamplingParams(
            max_new_tokens=args.max_new, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, seed=args.seed + i,
            deadline_s=args.deadline, ttft_deadline_s=args.ttft_deadline))
        if h.done:  # shed at submit (admission-policy reject past a cap)
            print(f"[serve] WARNING: request {h.uid} {h.finish_reason}: "
                  f"{h.error}")
        elif h.truncated:
            print(f"[serve] WARNING: request {h.uid} prompt ({len(prompt)} "
                  f"tokens) exceeds --capacity {args.capacity}; only the "
                  f"last {args.capacity} tokens will be served")
        handles.append(h)

    t0 = rtclock.now()
    if args.stream and handles and not handles[0].done:
        # tokens arrive in the engine step that produced them; the rest of
        # the fleet advances through the same steps
        pieces = [tok.decode([t]) for t in handles[0].tokens()]
        print(f"[serve] streamed [{handles[0].uid}] -> {''.join(pieces)!r} "
              f"(ttft {1e3 * handles[0].result().ttft:.1f}ms)")
    interval = max(args.metrics_interval, 0)
    jsonl_path = (Path(args.metrics_out).with_suffix(".jsonl")
                  if args.metrics_out and interval else None)
    jsonl_f = open(jsonl_path, "w") if jsonl_path else None
    reg = engine.obs.registry
    while engine.queue or any(s is not None for s in engine.slots):
        if draining.is_set():
            for h in list(engine.queue):  # stop admitting: queued work
                engine.cancel(h)          # never reaches a slot
        engine.step()
        if interval and engine.engine_steps % interval == 0:
            print(_stats_line(engine, t0))
            if jsonl_f is not None:
                jsonl_f.write(reg.jsonl_line() + "\n")
    _sync(engine.device)
    dt = rtclock.now() - t0
    results = [h.result() for h in handles]
    if draining.is_set():
        n_cancelled = sum(r.finish_reason == "cancelled" for r in results)
        print(f"[serve] drained: {len(results) - n_cancelled} finished, "
              f"{n_cancelled} cancelled in queue")
    _drain_report(results, engine, tok, args, dt, jsonl_f, jsonl_path)
    return results


if __name__ == "__main__":
    main()
