"""Where a decode step's time goes on the card.

    python -m repro_torch.launch.profile_decode [--kv-layout paged]

Builds the full-size qwen2-1.5b with random weights from seed 0,
PTQTP-quantizes it on the card (G = 128, t_max = 20), fills 8 rows with
512 random tokens through ``prefill_chunk``, then runs 8 decode steps of
the whole fleet under ``torch.profiler``. With ``--kv-layout paged`` the
cache is the paged pool (``--page-size`` tokens a page), each row's
logical pages on distinct physical pages. It prints, beside the card's
name and power limit:

  * host milliseconds per step (synchronized wall clock, profiler off);
  * device-busy milliseconds per step (sum of kernel times; one stream, so
    kernels do not overlap) and the device's idle share of the step;
  * kernel launches per step, and the kernels by device time.

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

ARCH = "qwen2-1.5b"
SLOTS, CONTEXT, STEPS, SEED = 8, 512, 8, 0


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

    def steps(n):
        for _ in range(n):
            decode_step(model, cfg, state, tok, active)
        torch.cuda.synchronize()

    steps(2)  # warm-up
    t0 = time.perf_counter()
    steps(STEPS)
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps(STEPS)
    rows = [(e.key, device_us(e) / 1e3 / STEPS, e.count / STEPS)
            for e in prof.key_averages() if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"{gpu} | {ARCH}, {args.kv_layout} KV, {SLOTS} rows at context "
          f"{CONTEXT}: host "
          f"{host_ms:.3f} ms/step, device busy {busy_ms:.3f} ms/step, idle "
          f"share {1 - busy_ms / host_ms:.1%}, {launches:.0f} launches/step")
    for name, ms, count in rows[:15]:
        print(f"  {ms:9.4f} ms/step  {count:6.1f}x  {name[:90]}")
    print(json.dumps({"gpu": gpu, "kv_layout": args.kv_layout,
                      "host_ms_per_step": host_ms,
                      "device_busy_ms_per_step": busy_ms,
                      "launches_per_step": launches,
                      "kernels": [{"name": n[:120], "ms_per_step": ms,
                                   "per_step": c} for n, ms, c in rows]}))


if __name__ == "__main__":
    main()
