#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases (any failure exits non-zero):

  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/*/csrc/*.cu`` (one nvcc each, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's full-width shapes (tolerances below), and check that the
     decode and prefill ternary-matmul kernels give bit-identical rows;
  3. drive the port's main path: qwen2-1.5b at full width (28 layers, d 1536,
     12/2 heads, d_ff 8960, vocab 151936, bf16), random weights from a seeded
     generator, PTQTP-quantized on the card (G = 128, t_max = 20), served by
     ``ServingEngine`` (8 slots, capacity 1024, prefill chunk 64, decode
     chunk 8): 8 greedy requests with 64-600 prompt tokens and 32 new tokens
     each. Every request must finish, every kernel must have launched, and
     two requests served alone must give the same tokens as in the fleet:
     the longest, and one whose prompt ends in a one-token prefill bucket
     alone but in a wider bucket in the fleet;
  4. time each kernel at the main path's shapes beside its plain version,
     one PyTorch library call computing the same function, and its bound.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
# and f32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# stated tolerances of kernel vs plain version (both sum in f32, in another
# order): ternary matmul relative to the output's scale, attention absolute;
# RMSNorm elementwise relative, f32 outputs, and one bf16 step (2^-7 of the
# value) where the f32 result sits on a bf16 rounding boundary
MM_RTOL = 1e-4
ATTN_TOL = 1e-4
NORM_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}

GROUP = 128
SLOTS, CAPACITY, PREFILL_CHUNK, DECODE_CHUNK = 8, 1024, 64, 8
N_REQUESTS, MAX_NEW, SEED = 8, 32, 0


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: the CUDA kernels' own time,
    summed by ``torch.profiler`` over ``reps`` calls after one warm-up call.
    A loop of small launches is bound by the host, so CUDA events around it
    would time the host; the profiler times the kernels. Raises if the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels._build import device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / reps


# ----------------------------------------------------------------- shapes
def linear_shapes(cfg):
    """(name, n, d, count per forward) of every quantized linear layer."""
    hd = cfg.head_dim
    per_layer = [("wq", cfg.n_heads * hd, cfg.d_model),
                 ("wk", cfg.n_kv_heads * hd, cfg.d_model),
                 ("wv", cfg.n_kv_heads * hd, cfg.d_model),
                 ("wo", cfg.d_model, cfg.n_heads * hd),
                 ("wi", cfg.d_ff, cfg.d_model),
                 ("wg", cfg.d_ff, cfg.d_model),
                 ("mlp_wo", cfg.d_model, cfg.d_ff)]
    out = [(name, n, d, cfg.n_layers) for name, n, d in per_layer]
    return out + [("lm_head", cfg.vocab_size, cfg.d_model, 1)]


def matmul_cost(n, d, m, group=GROUP):
    """(bytes, flops) of one y = x·Ŵᵀ call, bf16 x and y (the main path's):
    planes, α, x and y each moved once; 2·m·n·d flops of the equivalent
    dense product."""
    nbytes = 2 * n * d // 4 + 8 * n * (d // group) + 2 * m * d + 2 * m * n
    return nbytes, 2 * m * n * d


def bound_ms(nbytes, flops, peak_flops=BF16_FLOPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------- phase 2: kernels
def random_planes(n, d, gen, dev):
    import torch

    from repro_torch.core.packing import pack_trits

    t1 = torch.randint(-1, 2, (n, d), generator=gen, device=dev,
                       dtype=torch.int8)
    t2 = torch.randint(-1, 2, (n, d), generator=gen, device=dev,
                       dtype=torch.int8)
    alpha = torch.rand((n, d // GROUP, 2), generator=gen, device=dev) * 0.05
    return pack_trits(t1), pack_trits(t2), alpha


def check_ternary(cfg, dev):
    import torch

    from repro_torch.kernels.ternary_matmul import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = worst_abs = 0.0
    for name, n, d, _ in linear_shapes(cfg):
        t1p, t2p, alpha = random_planes(n, d, gen, dev)
        x = torch.randn((512, d), generator=gen, device=dev).to(torch.bfloat16)
        for m in (1, 8):
            y = ops.ternary_matvec(x[:m].contiguous(), t1p, t2p, alpha, GROUP)
            worst, worst_abs = _close(y, ref.ternary_matmul_grouped(
                x[:m], t1p, t2p, alpha, GROUP), f"matvec {name} m={m}",
                worst, worst_abs)
            _same_rounding(ops.ternary_matvec, x[:m], t1p, t2p, alpha, y,
                           f"matvec {name} m={m}")
        for m in (128, 200, 512):
            y = ops.ternary_matmul_tiled(x[:m].contiguous(), t1p, t2p, alpha,
                                         GROUP)
            worst, worst_abs = _close(y, ref.ternary_matmul_grouped(
                x[:m], t1p, t2p, alpha, GROUP), f"matmul {name} m={m}",
                worst, worst_abs)
            _same_rounding(ops.ternary_matmul_tiled, x[:m], t1p, t2p, alpha,
                           y, f"matmul {name} m={m}")
            for r0 in (0, m - 8):  # first rows, and the ragged last rows
                rows = ops.ternary_matvec(x[r0:r0 + 8].contiguous(), t1p, t2p,
                                          alpha, GROUP)
                if not torch.equal(rows, y[r0:r0 + 8]):
                    raise AssertionError(
                        f"{name} m={m}: matvec rows {r0}..{r0 + 7} differ "
                        "from the tiled kernel's (must be bit-identical)")
        del t1p, t2p, alpha, x
    log(f"ternary kernels == plain (max abs err {worst_abs:.2e}, max err / "
        f"scale {worst:.2e} <= "
        f"{MM_RTOL}); matvec rows bit-identical to tiled rows; bf16 outputs "
        "equal the f32 outputs rounded")
    return worst_abs


def _same_rounding(kern, x, t1p, t2p, alpha, y32, what):
    """The kernel's bf16 output must equal its f32 output cast to bf16."""
    import torch

    yb = kern(x.contiguous(), t1p, t2p, alpha, GROUP, torch.bfloat16)
    if not torch.equal(yb, y32.to(torch.bfloat16)):
        raise AssertionError(f"{what}: bf16 output differs from the f32 "
                             "output rounded to bf16")


def _close(got, want, what, worst_rel, worst_abs):
    """Check max |got - want| / max |want| <= MM_RTOL; returns the running
    worst (relative, absolute) errors."""
    import torch

    torch.cuda.synchronize()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    if not err / scale <= MM_RTOL:
        raise AssertionError(f"{what}: max |kernel - plain| / max|plain| = "
                             f"{err / scale:.3e} > {MM_RTOL}")
    return max(worst_rel, err / scale), max(worst_abs, err)


def attention_inputs(b, L, cap, kv, g, hd, ring, fill, gen, dev):
    """Chunk-attention operands: row r holds the ``fill[r]`` positions before
    its chunk (so rows past cap have wrapped), ring bf16 or int8."""
    import torch

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = rnd(b, L, kv, g, hd).to(torch.bfloat16)
    kn = rnd(b, L, kv, hd).to(torch.bfloat16)
    vn = rnd(b, L, kv, hd).to(torch.bfloat16)
    ks = vs = None
    if ring == "int8":
        kc = torch.randint(-127, 128, (b, cap, kv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, cap, kv, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((b, cap, kv), generator=gen, device=dev) * 0.02
        vs = torch.rand((b, cap, kv), generator=gen, device=dev) * 0.02
    else:
        kc = rnd(b, cap, kv, hd).to(torch.bfloat16)
        vc = rnd(b, cap, kv, hd).to(torch.bfloat16)
    pos_buf = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
    for r, n in enumerate(fill):
        p = torch.arange(max(0, n - cap), n, device=dev, dtype=torch.int32)
        pos_buf[r, p % cap] = p
    pos0 = torch.tensor(fill, dtype=torch.int32, device=dev)
    positions = pos0[:, None] + torch.arange(L, dtype=torch.int32,
                                             device=dev)[None]
    lengths = torch.full((b,), L, dtype=torch.int32, device=dev)
    lengths[1] = 0  # a row that rides along
    return [q, kn, vn, kc, ks, vc, vs, pos_buf, positions, lengths]


def check_attention(cfg, dev):
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fill = [0, 300, 1023, 1024, 1500, 2900, 64, 700]  # partly full + wrapped
    worst = 0.0
    for L in (1, 64):
        for ring in ("bfloat16", "int8"):
            args = attention_inputs(SLOTS, L, CAPACITY, kv, g, hd, ring, fill,
                                    gen, dev)
            got = ops.chunk_attention_cuda(*args)
            want = ref.chunk_attention_stream(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= ATTN_TOL:
                raise AssertionError(f"chunk_attention L={L} {ring}: max err "
                                     f"{err:.3e} > {ATTN_TOL}")
            worst = max(worst, err)
    log(f"chunk_attention == plain (max abs err {worst:.2e} <= {ATTN_TOL}) "
        "for L in (1, 64), bf16 and int8 rings, wrapped and partly filled")
    return worst


def check_rms_norm(cfg, dev):
    """The norm kernel against its plain version at the main path's shapes
    (8 rows of one token at decode, 8 x 64 at prefill), and its rows in an
    (8, 1, d) call against the same rows inside an (8, 64, d) call: they
    must be bit-identical. The plain version's differing elements there are
    counted and logged (``torch.mean`` picks its order from the shape)."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(4)
    d = cfg.d_model
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(
        torch.bfloat16)
    worst = 0.0
    gaps = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((SLOTS, PREFILL_CHUNK, d), generator=gen,
                        device=dev).to(dtype)
        one = x[:, :1].contiguous()
        for name, xs in (("decode", one), ("prefill", x)):
            got = ops.rms_norm(scale, xs, cfg.norm_eps)
            want = ref.rms_norm_plain(scale, xs, cfg.norm_eps)
            torch.cuda.synchronize()
            err = float(((got.float() - want.float()).abs()
                         / want.float().abs().clamp_min(1e-30)).max())
            tol = NORM_RTOL[str(dtype).split(".")[-1]]
            if not err <= tol:
                raise AssertionError(f"rms_norm {name} {dtype}: max relative "
                                     f"err {err:.3e} > {tol}")
            worst = max(worst, float((got.float() - want.float()).abs().max()))
        if not torch.equal(ops.rms_norm(scale, one, cfg.norm_eps),
                           ops.rms_norm(scale, x, cfg.norm_eps)[:, :1]):
            raise AssertionError(f"rms_norm {dtype}: rows of an (8, 1, d) call "
                                 "differ from the same rows in (8, 64, d)")
        gaps[str(dtype)] = int((ref.rms_norm_plain(scale, one, cfg.norm_eps)
                                != ref.rms_norm_plain(scale, x, cfg.norm_eps)
                                [:, :1]).sum())
    log(f"rms_norm == plain (max abs err {worst:.2e}; relative tolerances "
        f"{NORM_RTOL}); kernel rows bit-identical across (8, 1, d) and "
        f"(8, 64, d) calls; the plain version's rows differ there in "
        f"{gaps} of {SLOTS * d} elements")
    return worst


# ------------------------------------------------------- phase 3: main path
def build_model(cfg, dev):
    import torch

    from repro_torch.core.ptqtp import PTQTPConfig
    from repro_torch.core.quantize_model import quantize_tree
    from repro_torch.models import init_params

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, report = quantize_tree(model, PTQTPConfig(group_size=GROUP,
                                                     t_max=20))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return model, report, time.perf_counter() - t0


def make_prompts(cfg):
    """Prompts of 64-600 random token ids; the first has 2·64 + 1 tokens, so
    its last prefill chunk holds one token (bucket 1 when served alone)."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 601, N_REQUESTS)
    lens[0] = 2 * PREFILL_CHUNK + 1
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]


def final_buckets(lens):
    """The prefill bucket (padded chunk length) in which each prompt's last
    chunk runs, when all are admitted at once: every dispatch advances each
    mid-prompt row by min(rest, PREFILL_CHUNK) and pads to the next power of
    two of the longest take (``ServingEngine._prefill_step``)."""
    rest, out = list(lens), {}
    while any(rest):
        take = [min(r, PREFILL_CHUNK) for r in rest]
        bucket = 1 << (max(take) - 1).bit_length()
        for i, (r, t) in enumerate(zip(rest, take)):
            if r and r == t:
                out[i] = bucket
        rest = [r - t for r, t in zip(rest, take)]
    return out


def serve(model, cfg, prompts):
    """Serve ``prompts`` greedily; returns (results, decode seconds, decode
    tokens, kernel launches per decode step, engine). The launches per step
    are those of the engine's own decode loops in this run, over its decode
    steps."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

    eng = ServingEngine(model, cfg, EngineConfig(
        max_slots=SLOTS, capacity=CAPACITY, prefill_chunk=PREFILL_CHUNK,
        decode_chunk=DECODE_CHUNK))
    decode_s = [0.0]
    in_decode = dict.fromkeys(launch_counts(), 0)
    inner = eng._decode_loop

    def timed(n_steps):  # the loop ends in a host sync, so wall time is device time
        before = launch_counts()
        t0 = time.perf_counter()
        out = inner(n_steps)
        decode_s[0] += time.perf_counter() - t0
        for k, n in launch_counts().items():
            in_decode[k] += n - before[k]
        return out

    eng._decode_loop = timed
    handles = [eng.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
               for p in prompts]
    eng.run()
    results = [h.result() for h in handles]
    per_step = {k: n / eng.steps for k, n in in_decode.items()}
    return (results, decode_s[0], eng.tokens_generated - len(prompts),
            per_step, eng)


def main_path(cfg, dev):
    from repro_torch.kernels import launch_counts, reset_launch_counts

    model, report, quant_s = build_model(cfg, dev)
    prompts = make_prompts(cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    results, decode_s, decode_tok, per_step, eng = serve(model, cfg, prompts)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    bad = [r.uid for r in results
           if r.finish_reason not in ("length", "stop") or not r.tokens]
    if bad:
        raise AssertionError(f"requests {bad} did not finish")
    # the longest prompt, and the one whose last chunk runs in bucket 1 alone
    # but in a wider bucket in the fleet (the case a shape-dependent norm
    # reduction would break)
    fleet_buckets = final_buckets([len(p) for p in prompts])
    one = [i for i in range(len(prompts))
           if final_buckets([len(prompts[i])])[0] == 1 < fleet_buckets[i]]
    if not one:
        raise AssertionError(f"no prompt ends in bucket 1 alone and a wider "
                             f"bucket in the fleet ({fleet_buckets})")
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    for i in (longest, one[0]):
        solo = serve(model, cfg, [prompts[i]])[0]
        if solo[0].tokens != results[i].tokens:
            raise AssertionError(f"request {i} alone gave {solo[0].tokens}, "
                                 f"in the fleet {results[i].tokens}")
    ttft = sorted(r.ttft for r in results)
    return dict(model=model, report=report, quant_s=quant_s, counts=counts,
                wall=wall, decode_s=decode_s, decode_tok=decode_tok,
                ttft=ttft, engine=eng, prompts=prompts, results=results,
                per_step=per_step,
                solo=dict(longest=(longest, len(prompts[longest])),
                          bucket_1=(one[0], len(prompts[one[0]]),
                                    fleet_buckets[one[0]])))


# -------------------------------------------------------- phase 4: timings
def time_ternary(model, cfg, dev):
    """Kernel, plain and library times of the quantized linear layers of
    one decode step (all 197 at m = 8, matvec) and one prefill dispatch
    (the 196 block layers at m = 512, tiled; the lm_head of a prefill reads
    one row per slot, m = 8, through the matvec), walking the model's own
    layers so the weights stream from HBM as on the main path, with bf16
    outputs as the model asks for them."""
    import torch

    from repro_torch.core.quantize_model import dequantize_kernel
    from repro_torch.kernels.ternary_matmul import ops, ref
    from repro_torch.models.common import Dense

    all_layers = [m for m in model.modules() if isinstance(m, Dense)]
    out = {}
    for key, m, kern, reps in (("ternary_matvec", SLOTS, ops.ternary_matvec, 5),
                               ("ternary_matmul", SLOTS * PREFILL_CHUNK,
                                ops.ternary_matmul_tiled, 2)):
        layers = [layer for layer in all_layers
                  if m < ops.SMALL_M_THRESHOLD or layer is not model.lm_head]
        dense_w = [dequantize_kernel(layer.quant, torch.bfloat16)
                   for layer in layers]
        xs = {d: torch.randn((m, d), device=dev).to(torch.bfloat16)
              for d in {cfg.d_model, cfg.d_ff}}

        def run_kernel():
            for layer in layers:
                kern(xs[layer.d_in], layer.t1p, layer.t2p, layer.alpha, GROUP,
                     torch.bfloat16)

        def run_plain():
            for layer in layers:
                ref.ternary_matmul_grouped(xs[layer.d_in], layer.t1p,
                                           layer.t2p, layer.alpha, GROUP)

        def run_library():
            for layer, w in zip(layers, dense_w):
                torch.nn.functional.linear(xs[layer.d_in], w)

        nbytes = flops = 0
        for layer in layers:
            b, f = matmul_cost(layer.d_out, layer.d_in, m)
            nbytes, flops = nbytes + b, flops + f
        bound, by = bound_ms(nbytes, flops)
        shapes = {(layer.d_out, layer.d_in): layer for layer in layers}
        per_shape = {f"{n}x{d}": 1e3 * device_ms(
            lambda layer=layer: kern(xs[layer.d_in], layer.t1p, layer.t2p,
                                     layer.alpha, GROUP, torch.bfloat16), 10)
            for (n, d), layer in shapes.items()}
        out[key] = dict(ms=device_ms(run_kernel, reps),
                        plain_ms=device_ms(run_plain, max(1, reps // 2)),
                        library_ms=device_ms(run_library, reps),
                        bound_ms=bound, bound_by=by, bytes=nbytes,
                        flops=flops, calls=len(layers), m=m,
                        us_per_call=per_shape)
    return out


def time_attention(cfg, dev, fill):
    """Kernel, plain and SDPA times of the 28 attention reads of one decode
    step (L = 1) and one prefill dispatch (L = 64), over 28 distinct bf16
    rings filled as ``fill`` (one ring per layer, as on the main path)."""
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(3)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    out = {}
    for key, L, reps in (("decode", 1, 10), ("prefill", PREFILL_CHUNK, 3)):
        layers = [attention_inputs(SLOTS, L, CAPACITY, kv, g, hd, "bfloat16",
                                   fill, gen, dev)
                  for _ in range(cfg.n_layers)]
        for a in layers:
            a[9].fill_(L)  # every row active, as in a full decode step

        def run_kernel():
            for a in layers:
                ops.chunk_attention_cuda(*a)

        def run_plain():
            for a in layers:
                ref.chunk_attention_stream(*a)

        sdpa_args = [_sdpa_operands(a, CAPACITY) for a in layers]

        def run_library():
            for q, k, v, mask in sdpa_args:
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)

        # bytes this run's data needs: the visible ring entries' k and v,
        # the positions, the queries and chunk keys, the f32 output
        a = layers[0]
        visible = int(ref.history_mask(a[7], a[8], CAPACITY).any(1).sum())
        per_layer = (visible * kv * hd * 2 * 2 + a[7].numel() * 4
                     + (a[0].numel() + a[1].numel() + a[2].numel()) * 2
                     + a[0].numel() * 4)
        flops = 4 * SLOTS * kv * g * L * (visible // SLOTS + L) * hd
        bound, by = bound_ms(per_layer * cfg.n_layers, flops * cfg.n_layers)
        out[key] = dict(ms=device_ms(run_kernel, reps),
                        plain_ms=device_ms(run_plain, max(1, reps // 2)),
                        library_ms=device_ms(run_library, reps),
                        bound_ms=bound, bound_by=by, L=L,
                        bytes=per_layer * cfg.n_layers)
    return out


def time_rms_norm(model, cfg, dev):
    """Kernel, plain and library times of the norms of one decode step
    (2 per layer and the final one, 8 rows of one token each, bf16), each
    with its own layer's scale as on the main path."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref
    from repro_torch.models.common import RMSNorm

    norms = [m.scale for m in model.modules() if isinstance(m, RMSNorm)]
    d, eps = cfg.d_model, cfg.norm_eps
    x = torch.randn((SLOTS, 1, d), device=dev).to(torch.bfloat16)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    nbytes = len(norms) * (2 * x.numel() * 2 + d * 2)
    flops = len(norms) * 4 * x.numel()  # x² accumulated, two products
    bound, by = bound_ms(nbytes, flops, F32_FLOPS)
    return dict(
        ms=device_ms(lambda: [ops.rms_norm(w, x, eps) for w in norms], 10),
        plain_ms=device_ms(
            lambda: [ref.rms_norm_plain(w, x, eps) for w in norms], 10),
        library_ms=None if lib is None else device_ms(
            lambda: [lib(x, (d,), w, eps) for w in norms], 10),
        bound_ms=bound, bound_by=by, calls=len(norms))


def _sdpa_operands(a, cap):
    """The same attention for ``scaled_dot_product_attention``: keys are the
    ring followed by the chunk, the visibility rule as a boolean mask."""
    import torch

    from repro_torch.kernels.chunk_attention import ref

    q, kn, vn, kc, _, vc, _, pos_buf, positions, lengths = a
    hist = ref.history_mask(pos_buf, positions, cap)
    own = ref.chunk_mask(positions, lengths, cap)
    mask = torch.cat([hist, own], dim=-1)[:, None]       # (B, 1, L, cap+L)
    b, L, kv, g, hd = q.shape
    qh = q.reshape(b, L, kv * g, hd).transpose(1, 2)
    k = torch.cat([kc, kn], dim=1).transpose(1, 2)       # (B, KV, cap+L, hd)
    v = torch.cat([vc, vn], dim=1).transpose(1, 2)
    return qh, k, v, mask


# ------------------------------------------------------------------- main
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on a GPU", file=sys.stderr)
        return 2
    try:
        from repro_torch import configs
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout of the repository "
              f"({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    log(f"card: {gpu}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = _build.build(_build.kernel_sources())
    log(f"built {len(libs)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s: {[p.name for p in libs]}")

    cfg = configs.get_config("qwen2-1.5b")
    mm_err = check_ternary(cfg, dev)
    attn_err = check_attention(cfg, dev)
    norm_err = check_rms_norm(cfg, dev)

    mp = main_path(cfg, dev)
    counts = mp["counts"]
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({counts})")
    tot = mp["report"]["__total__"]
    decode_steps = mp["engine"].steps
    log(f"{gpu} | quantize {mp['quant_s']:.2f}s "
        f"({tot['n_quantized']} kernels, {tot['compression']:.2f}x)")
    log(f"{gpu} | served {len(mp['results'])} requests "
        f"({sum(len(p) for p in mp['prompts'])} prompt tokens) in "
        f"{mp['wall']:.2f}s; TTFT median {mp['ttft'][len(mp['ttft']) // 2]:.3f}s "
        f"max {mp['ttft'][-1]:.3f}s; decode {mp['decode_tok']} tokens in "
        f"{mp['decode_s']:.3f}s = {mp['decode_tok'] / mp['decode_s']:.1f} tok/s "
        f"({decode_steps} decode steps, {mp['engine'].prefill_steps} prefill "
        f"dispatches)")
    log(f"{gpu} | launches on the main path: {counts}; per decode step of "
        f"its decode loops: {mp['per_step']}")
    (li, ll), (oi, ol, ob) = mp["solo"]["longest"], mp["solo"]["bucket_1"]
    log(f"solo == fleet tokens for request {li} (longest prompt, {ll} "
        f"tokens) and request {oi} ({ol} tokens: last prefill chunk in "
        f"bucket 1 alone, {ob} in the fleet)")

    fill = [len(p) + MAX_NEW // 2 for p in mp["prompts"]]
    model = mp.pop("model")
    mp.pop("engine")
    tern = time_ternary(model, cfg, dev)
    norm = time_rms_norm(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    attn = time_attention(cfg, dev, fill)
    for name, t in list(tern.items()) + [("chunk_attention/" + k, v)
                                         for k, v in attn.items()] + [
            ("rms_norm", norm)]:
        lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        log(f"{gpu} | {name}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib_ms} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound")
        if "us_per_call" in t:
            log(f"{gpu} | {name} device us per call, by n x d (m = {t['m']}): "
                + ", ".join(f"{k} {v:.1f}" for k, v in t["us_per_call"].items()))

    kernels = [
        dict(name="ternary_matvec", route="cuda",
             source="src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
             replaces="src/repro/kernels/ternary_matmul/kernel.py:175",
             launches=counts["ternary_matvec"],
             launches_per_decode_step=mp["per_step"]["ternary_matvec"],
             max_abs_err=mm_err,
             work="all 197 linear layers of one decode step, m=8",
             **{k: tern["ternary_matvec"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="ternary_matmul", route="cuda",
             source="src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
             replaces="src/repro/kernels/ternary_matmul/kernel.py:91",
             launches=counts["ternary_matmul"],
             launches_per_decode_step=mp["per_step"]["ternary_matmul"],
             max_abs_err=mm_err,
             work="the 196 block linear layers of one prefill dispatch, m=512",
             **{k: tern["ternary_matmul"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="chunk_attention", route="cuda",
             source="src/repro_torch/kernels/chunk_attention/csrc/chunk_attention.cu",
             replaces="src/repro/kernels/chunk_attention/kernel.py:197",
             launches=counts["chunk_attention"],
             launches_per_decode_step=mp["per_step"]["chunk_attention"],
             max_abs_err=attn_err,
             work="28 attention reads of one decode step, L=1, bf16 ring",
             **{k: attn["decode"][k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        dict(name="rms_norm", route="cuda",
             source="src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
             replaces="src/repro/models/common.py:78",
             launches=counts["rms_norm"],
             launches_per_decode_step=mp["per_step"]["rms_norm"],
             max_abs_err=norm_err,
             work=f"{norm['calls']} norms of one decode step, 8 rows "
                  "of d=1536, bf16; "
                  "replaces an XLA-fused function, not a Pallas kernel",
             **{k: norm[k] for k in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
    ]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
