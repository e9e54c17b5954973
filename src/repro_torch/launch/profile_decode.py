"""Where a decode step's time goes on the card.

    python -m repro_torch.launch.profile_decode [--kv-layout paged]

Builds the full-size qwen2-1.5b with random weights from seed 0,
PTQTP-quantizes it on the card (G = 128, t_max = 20), then profiles two
things, each on the ring or (``--kv-layout paged``) the paged layout:

  * the model: 8 rows filled with 512 random tokens through
    ``prefill_chunk``, then 8 ``decode_step`` calls of the whole fleet,
    eager, without the engine and sampling (each row's logical pages on
    distinct physical pages under the paged layout);
  * the engine: ``ServingEngine`` (8 slots, capacity 1024, decode chunk 8)
    with 8 greedy requests of 512 random prompt tokens, past their
    prefill; its K = 8 decode dispatches (the loop with sampling and
    stop-freezing) replayed from their CUDA graph, and the same dispatches
    with capture off (eager), in one run.

For each it prints, beside the card's name and power limit:

  * host milliseconds per decode step (synchronized wall clock, profiler
    off; an engine dispatch ends in its one host sync);
  * device-busy milliseconds per step (sum of kernel times under
    ``torch.profiler``; one stream, so kernels do not overlap) and the
    device's idle share of the step;
  * kernel launches per step, the device ms of B1, B2/B4 and the norm,
    and the kernels by device time.

It needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import configs
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.kernels._build import device_us
from repro_torch.models import (decode_step, init_decode_state, init_params,
                                prefill_chunk)
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

ARCH = "qwen2-1.5b"
SLOTS, CONTEXT, STEPS, SEED = 8, 512, 8, 0
DISPATCHES = 4          # timed and profiled engine dispatches of STEPS each
# the columns of PERF.md's table: kernel name fragment -> column
COLUMNS = (("ternary_matvec", "B1"), ("chunk_attention", "B2/B4"),
           ("rms_norm", "norm"))


def profiled(fn, steps, gpu, what):
    """Host ms a step of ``fn()`` (``steps`` decode steps, ending in a
    sync) with the profiler off, then device-busy ms a step, launches a
    step and the kernels by device time under ``torch.profiler``;
    printed, and returned as a dict."""
    fn()  # warm-up
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    rows = [(e.key, device_us(e) / 1e3 / steps, e.count / steps)
            for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    cols = {col: sum(ms for name, ms, _ in rows if frag in name)
            for frag, col in COLUMNS}
    print(f"{gpu} | {what}: host {host_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step, idle share {1 - busy_ms / host_ms:.1%}, "
          f"{launches:.0f} launches/step; "
          + ", ".join(f"{c} {ms:.3f} ms" for c, ms in cols.items()))
    for name, ms, count in rows[:15]:
        print(f"  {ms:9.4f} ms/step  {count:6.1f}x  {name[:90]}")
    return {"what": what, "host_ms_per_step": host_ms,
            "device_busy_ms_per_step": busy_ms,
            "launches_per_step": launches, "columns_ms": cols,
            "kernels": [{"name": n[:120], "ms_per_step": ms, "per_step": c}
                        for n, ms, c in rows]}


def engine_dispatches(model, cfg, args, capture):
    """A ``ServingEngine`` past the prefill of 8 requests of CONTEXT
    tokens, and a callable running DISPATCHES of its K-step decode
    dispatches (each ends in its one host sync)."""
    kw = {} if args.kv_layout == "ring" else dict(kv_layout="paged",
                                                  page_size=args.page_size)
    eng = ServingEngine(model, cfg, EngineConfig(
        max_slots=SLOTS, capacity=1024, prefill_chunk=64, decode_chunk=STEPS,
        **kw))
    eng._capture = capture
    rng = np.random.default_rng(SEED)
    budget = 1 + 4 * DISPATCHES * STEPS
    for _ in range(SLOTS):
        eng.submit(rng.integers(0, cfg.vocab_size, CONTEXT).tolist(),
                   SamplingParams(max_new_tokens=budget))
    while any(eng._prefilling(i) for i in range(SLOTS)) or eng.queue:
        eng.step()

    def run():
        for _ in range(DISPATCHES):
            eng.step()
        torch.cuda.synchronize()

    return eng, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kv-layout", choices=("ring", "paged"), default="ring")
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cfg = configs.get_config(ARCH)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    model, _ = quantize_tree(model, PTQTPConfig(group_size=128, t_max=20))
    cap = CONTEXT + 4 * STEPS
    kv_spec = None
    if args.kv_layout == "paged":
        n = cap // args.page_size
        kv_spec = {"page_size": args.page_size, "max_pages": SLOTS * n}
    state = init_decode_state(cfg, SLOTS, cap, device=dev, kv_spec=kv_spec)
    if kv_spec is not None:
        state["table"].copy_(torch.arange(1, SLOTS * n + 1, dtype=torch.int32,
                                          device=dev).reshape(SLOTS, n))
    rng = np.random.default_rng(SEED)
    for c0 in range(0, CONTEXT, 64):
        n = min(64, CONTEXT - c0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (SLOTS, n)).astype(np.int32))
        _, state = prefill_chunk(model, cfg, state, toks.to(dev),
                                 torch.full((SLOTS,), n, dtype=torch.int32,
                                            device=dev))
    tok = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    active = torch.ones((SLOTS,), dtype=torch.bool, device=dev)

    def steps():
        for _ in range(STEPS):
            decode_step(model, cfg, state, tok, active)
        torch.cuda.synchronize()

    where = f"{ARCH}, {args.kv_layout} KV, {SLOTS} rows at context {CONTEXT}"
    out = [profiled(steps, STEPS, gpu, f"{where}, decode_step (eager)")]
    del state
    for capture in (True, False):
        eng, run = engine_dispatches(model, cfg, args, capture)
        out.append(profiled(run, DISPATCHES * STEPS, gpu,
                            f"{where}, engine K={STEPS} dispatch "
                            f"({'graph replay' if capture else 'eager'})"))
        del eng, run
        torch.cuda.empty_cache()
    print(json.dumps({"gpu": gpu, "kv_layout": args.kv_layout,
                      "runs": out}))


if __name__ == "__main__":
    main()
