"""Serving launcher: boot a PTQTP model (from an artifact, or by init and
quantization), then serve a batch of requests through the v1 request API.

``python -m repro_torch.launch.serve --artifact DIR [--verify-artifact sizes]``
``python -m repro_torch.launch.serve --device cuda --warmup``
``python -m repro_torch.launch.serve --device cpu --requests 2 --max-new 4``
``python -m repro_torch.launch.serve --kv-layout paged --page-size 16``
``python -m repro_torch.launch.serve --scheduler serial --trace-out t.json``

The batch path of ``repro.launch.serve`` with the same defaults and flags
(the HTTP frontend, its tenants and the supervisor are not ported yet).
With ``--artifact`` the model and its config come from the artifact's
manifest and shards (written by either package): no floating-point weights
are built and nothing is quantized; the boot time is printed by phase.
Without it: the smoke configuration of ``--arch``, group size min(128,
d_model), ``--t-max`` iterations. One request per built-in prompt, each
seeded ``seed + i``.

``--warmup`` captures every dispatch before serving (CUDA graphs on the
card; their capture seconds are printed). ``--scheduler serial`` serves on
the serial-admit baseline (one dispatch per prompt length; ring layout
only). ``--trace-out trace.json`` records the request lifecycle and the
engine's phases (Chrome/Perfetto JSON; boot phases on their own track);
``--metrics-out metrics.prom`` writes the Prometheus exposition at the end,
and with ``--metrics-interval N`` a one-line digest every N engine steps
and a ``.jsonl`` snapshot stream beside it. The last line is the engine's
``health()`` summary. Tokens are the same with tracing on or off.
"""

from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.artifacts import load_model
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
                         "engine steps (0 = off)")
    args = ap.parse_args(argv)
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
    with _boot_phase(obs, boot, "engine_init", scheduler=args.scheduler):
        engine = cls(model, cfg, EngineConfig(
            max_slots=args.slots, capacity=args.capacity,
            prefill_chunk=args.prefill_chunk, max_queue=args.max_queue,
            max_resident_tokens=args.max_resident_tokens,
            admission_policy=args.admission_policy,
            kv_layout=args.kv_layout, page_size=args.page_size,
            max_pages=args.max_pages, prefix_cache=args.prefix_cache),
            observability=obs)
    if args.warmup:
        with _boot_phase(obs, boot, "warmup"):
            engine.warmup()
            _sync(dev)
        stats = engine.compile_stats()
        print(f"[serve] warmup: {stats['n_prefill_compiles']} prefill + "
              f"{stats['n_decode_compiles']} decode dispatches "
              f"({engine.graph_stats()['capture_s']:.2f}s of capture) in "
              f"{boot['warmup']:.1f}s")
    print(f"[serve] boot {rtclock.now() - t_boot:.2f}s on {dev}", flush=True)

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
        engine.step()
        if interval and engine.engine_steps % interval == 0:
            print(_stats_line(engine, t0))
            if jsonl_f is not None:
                jsonl_f.write(reg.jsonl_line() + "\n")
    _sync(dev)
    dt = rtclock.now() - t0
    results = [h.result() for h in handles]
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
    for r in sorted(results, key=lambda r: r.uid)[:4]:
        print(f"  [{r.uid}] ({r.finish_reason}, ttft {1e3 * r.ttft:.1f}ms) -> "
              f"{tok.decode(list(r.tokens))!r}")
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
    return results


if __name__ == "__main__":
    main()
