"""Serving launcher: boot a PTQTP model (from an artifact, or by init and
quantization), then serve a batch of requests through the v1 request API.

``python -m repro_torch.launch.serve --artifact DIR [--verify-artifact sizes]``
``python -m repro_torch.launch.serve --device cuda``
``python -m repro_torch.launch.serve --device cpu --requests 2 --max-new 4``
``python -m repro_torch.launch.serve --kv-layout paged --page-size 16``

The batch path of ``repro.launch.serve`` with the same defaults. With
``--artifact`` the model and its config come from the artifact's manifest
and shards (written by either package): no floating-point weights are
built and nothing is quantized; the boot time is printed by phase.
Without it: the smoke configuration of ``--arch``, group size min(128,
d_model), ``--t-max`` iterations. One request per built-in prompt, each
seeded ``seed + i``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.artifacts import load_model
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import clock as rtclock
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

PROMPTS = [
    "the model computes two trit planes",
    "count 5 6 7",
    "slot 42 holds 7 ;",
    "12 plus 30 equals",
]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=128)
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt tokens consumed per slot per engine step")
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
    ap.add_argument("--no-quantize", action="store_true",
                    help="serve FP weights (baseline)")
    ap.add_argument("--t-max", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0,
                    help="weight-init seed; request i samples from its own "
                         "stream seeded seed+i")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu for the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.kv_layout == "paged" and args.capacity % args.page_size:
        ap.error(f"--capacity {args.capacity} must be a whole number of "
                 f"pages (--page-size {args.page_size})")

    dev = resolve_device(args.device)
    t_boot = rtclock.now()
    if args.artifact:
        boot = {}
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
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        model = init_params(cfg, gen, device=dev)
        if not args.no_quantize:
            t0 = rtclock.now()
            gs = min(128, cfg.d_model)
            model, report = quantize_tree(
                model, PTQTPConfig(group_size=gs, t_max=args.t_max))
            _sync(dev)
            tot = report["__total__"]
            print(f"[serve] PTQTP: {tot['n_quantized']} kernels, "
                  f"{tot['compression']:.2f}x compression, "
                  f"{rtclock.now() - t0:.1f}s")

    tok = ByteTokenizer()
    engine = ServingEngine(model, cfg, EngineConfig(
        max_slots=args.slots, capacity=args.capacity,
        prefill_chunk=args.prefill_chunk, kv_layout=args.kv_layout,
        page_size=args.page_size, max_pages=args.max_pages,
        prefix_cache=args.prefix_cache))
    print(f"[serve] boot {rtclock.now() - t_boot:.2f}s on {dev}", flush=True)

    handles = []
    for i in range(args.requests):
        prompt = tok.encode(PROMPTS[i % len(PROMPTS)], eos=False)
        h = engine.submit(prompt, SamplingParams(
            max_new_tokens=args.max_new, temperature=args.temperature,
            seed=args.seed + i))
        if h.truncated:
            print(f"[serve] WARNING: request {h.uid} prompt ({len(prompt)} "
                  f"tokens) exceeds --capacity {args.capacity}; only the "
                  f"last {args.capacity} tokens will be served")
        handles.append(h)

    t0 = rtclock.now()
    engine.run()
    _sync(dev)
    dt = rtclock.now() - t0
    results = [h.result() for h in handles]
    n_tok = sum(len(r.tokens) for r in results)
    print(f"[serve] {len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, {engine.steps} decode steps, "
          f"{engine.prefill_steps} prefill steps)")
    if engine.paged:
        a = engine.alloc
        print(f"[serve] paged KV: {a.n_pages} pages of {a.page_size} tokens; "
              f"prefix cache hits {a.hits}, misses {a.misses}, forks "
              f"{a.forks}, evictions {a.evictions}, peak used {a.peak_used}")
    for r in sorted(results, key=lambda r: r.uid)[:4]:
        print(f"  [{r.uid}] ({r.finish_reason}, ttft {1e3 * r.ttft:.1f}ms) -> "
              f"{tok.decode(list(r.tokens))!r}")
    return results


if __name__ == "__main__":
    main()
