#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout. Phases (any failure exits non-zero):

  1. print the card's name and power limit; build every CUDA kernel from
     ``src/repro_torch/kernels/*/csrc/*.cu`` (one nvcc each, in parallel);
  2. hold each kernel against its plain PyTorch version on the card at the
     main paths' full-width shapes (tolerances below): the ternary matmuls
     (bf16 x on the tensor cores, f32 x on the FMA kernels, the route of
     each logged; decode and prefill rows bit-identical, also for row
     windows off the 8-token grid), chunk attention on the ring
     (B2) and on a paged pool under a shuffled table with null pages (B4,
     also bit for bit against B2 on the gathered ring), the norm, decode
     attention over an int8 ring with a row masked everywhere (B5), and the
     trit search on an 8960x1536 matrix and the 151936x1536 lm_head with
     α from one real ridge step (B6, planes exactly equal); the split-KV
     attention kernel (B2, B4, B5) must also give each row the same bits
     alone as in the batch of 8, and at L = 1 as at l = 0 of L = 64 with
     length 1;
  3. the quantize path: qwen2-1.5b at full width (28 layers, d 1536, 12/2
     heads, d_ff 8960, vocab 151936, bf16), random weights from a seeded
     generator, PTQTP-quantized on the card (G = 128, t_max = 20), its trit
     step on B6;
  4. the ring serving path: that model served by ``ServingEngine`` (8
     slots, capacity 1024, prefill chunk 64, decode chunk 8): 8 greedy
     requests with 64-600 prompt tokens and 32 new tokens each. Every
     request must finish, every kernel of the path must have launched, and
     two requests served alone must give the same tokens as in the fleet:
     the longest, and one whose prompt ends in a one-token prefill bucket
     alone but in a wider bucket in the fleet;
  5. the paged serving path (``kv_layout="paged"``, page size 16, prefix
     cache on): (a) the same fleet, tokens equal to the ring's; (b) 8
     requests sharing a 512-token prefix with tails of 16-200 tokens, cold
     and then warm (after one request has published the prefix), tokens
     equal to the ring's and prefix-cache hits > 0; (c) one request with
     that prefix that wraps the 1024-token ring (990 prompt tokens, 64
     new): tokens equal to the ring's, at least one copy-on-write fork, and
     a later request with the prefix still gives its cold tokens; (d) after
     the drain the allocator's invariants hold and every page the prefix
     cache does not hold is free;
  6. (e) the artifact round trip at full width: the quantized model written
     by ``ArtifactWriter`` (its bytes unchanged) to a temporary directory,
     loaded onto the card with every crc32 checked, every tensor equal byte
     for byte, the ring fleet and the paged fleet (a) served from it with
     the ring phase's tokens; a small second artifact torn (refused by
     ``verify="sizes"``) and bit-flipped (passed by "sizes", refused by
     "full"); its size and the seconds of the write, fsync and each boot
     phase;
  7. (f) the artifact the JAX package wrote (``tests/torch_fixtures/``,
     smoke qwen2, f32 activations: the FMA kernels) served on the ring and
     paged layouts with the JAX engine's committed greedy streams, and the
     bucket-1 request alone;
  8. (g) containment at full width: the ring fleet with one request's
     logits NaN'd inside a K-step dispatch and another's at its prefill
     finisher; both retire "error" with the clean run's tokens so far,
     every other stream is unchanged, both slots sit out the quarantine and
     come back; the same plan on the paged layout with the shared-prefix
     fleet, where the prefill victim's own prompt pages never enter the
     prefix cache; the host syncs per decode dispatch equal those of a
     production engine (e);
  9. decode attention through its op, the only entry point of B5, for the
     28 layers of one decode step;
 10. time each kernel at its path's shapes beside its plain version, one
     PyTorch library call computing the same function where one exists,
     and its bound; and the threefry sampling draw per decode step.

Every serving phase runs through the engine's CUDA graphs (one per
dispatch key, captured at first use or by ``warmup()``; the timed fleets
are warmed first, and the main fleet must capture nothing more). Since
slice 7 also:

 11. the host syncs of every replayed decode dispatch of phases 4, (e) and
     (g): exactly one, also right after the fleet changed;
 12. graph against eager (the same bodies, capture off): the main fleet
     on the ring and paged layouts, greedy and sampled (temperature 0.8,
     top-k/top-p on some rows), equal streams, decode tok/s and ms a step
     of both;
 13. the main fleet traced and untraced: equal streams, tok/s of both;
 14. ``SerialAdmitEngine`` (one graph per prompt length): the bucketed
     engine's streams;
 15. C.2: the unquantized bf16 model served in the main fleet and alone
     for the longest and the bucket-1 request: equal streams.

Since slice 8 (the concurrent frontend, ``serving.frontend``):

 16. (h) HTTP: a fresh engine, not warmed, behind ``EngineDriver`` and
     ``ThreadedHttpServer`` on 127.0.0.1:0; the ring fleet posted from 8
     client threads (half as SSE streams), so the driver's thread captures
     its graphs while the clients are live, then posted again (replays):
     every stream equal to phase 4's, ``/healthz`` and ``/metrics``
     answering during each run; tok/s and TTFT through HTTP beside phase
     4's in-process figures;
 17. (i) supervised recovery: an ``EngineSupervisor`` whose factory builds
     ring engines on the same model, the HTTP server in front; three
     rounds of the ring fleet, each generation dying in its own way (an
     ambiguous crash mid-decode, a crash blamed on a poison request, a
     hung step caught by the watchdog): the survivors' streams equal phase
     4's with every SSE token index once, the poison request retires
     "error" once, and device memory once generation 3 has settled exceeds
     generation 1's by no more than generation 3's graph tensors and
     attention scratch; each recovery's seconds, time to the first
     replayed token and the new generation's capture seconds, and the
     card's allocated and reserved bytes after each generation.

Each phase's engines and graph pools are freed before the next; the run's
total seconds are printed.

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
# order; the bf16 ternary layers on the tensor cores, whose f32 accumulation
# is not IEEE-sequential): ternary matmul relative to the output's scale,
# attention absolute; RMSNorm elementwise relative, f32 outputs, and one
# bf16 step (2^-7 of the value) where the f32 result sits on a bf16
# rounding boundary
MM_RTOL = 1e-4
ATTN_TOL = 1e-4
NORM_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DECODE_TOL = 1e-4  # B5, absolute: outputs are convex mixes of values ~ 1

GROUP = 128
SLOTS, CAPACITY, PREFILL_CHUNK, DECODE_CHUNK = 8, 1024, 64, 8
N_REQUESTS, MAX_NEW, SEED = 8, 32, 0
PAGE = 16                   # tokens per KV page on the paged path
SHARED_PREFIX = 512         # a multiple of PAGE and PREFILL_CHUNK
TAILS = (16, 200)           # distinct tails after the shared prefix
WRAP_PROMPT, WRAP_NEW = 990, 64
FIXTURES = ROOT / "tests" / "torch_fixtures"


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


# kernels each serving path must launch
RING_PATH = ("ternary_matvec", "ternary_matmul", "chunk_attention", "rms_norm")
PAGED_PATH = ("ternary_matvec", "ternary_matmul", "chunk_attention_paged",
              "rms_norm")


def need(counts, kernels, path):
    """Fail unless every kernel of ``kernels`` launched on ``path``."""
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {path}: {missing} "
                             f"({counts})")


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


def matvec_windows(m):
    """Row windows [a, b) of an m-row x for the matvec-vs-tiled gate: on the
    kernels' 8-token grid, off it, ending at the ragged edge, one row."""
    return ((0, 8), (m - 8, m), (3, 12), (m - 11, m), (5, 6))


def check_ternary(cfg, dev):
    """Both ternary kernels against the plain version at every linear
    layer's shape: bf16 x (the main path's, tensor cores) at m = 1, 8
    (matvec) and 128, 200, 512 (tiled), f32 x (FMA kernels) at m = 8 and
    200; matvec rows bit-identical to the tiled kernel's on and off the
    8-token grid; bf16 outputs equal to the f32 outputs rounded."""
    import torch

    from repro_torch.kernels.ternary_matmul import ops, ref

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = worst_abs = 0.0
    cases = ((torch.bfloat16, (1, 8), (128, 200, 512)),
             (torch.float32, (8,), (200,)))
    for name, n, d, _ in linear_shapes(cfg):
        t1p, t2p, alpha = random_planes(n, d, gen, dev)
        x32 = torch.randn((512, d), generator=gen, device=dev)
        for dtype, vec_ms, tiled_ms in cases:
            x = x32.to(dtype)
            bf16 = dtype == torch.bfloat16
            for m in vec_ms:
                what = f"matvec {name} {dtype} m={m}"
                y = ops.ternary_matvec(x[:m].contiguous(), t1p, t2p, alpha,
                                       GROUP)
                worst, worst_abs = _close(y, ref.ternary_matmul_grouped(
                    x[:m], t1p, t2p, alpha, GROUP), what, worst, worst_abs)
                if bf16:
                    _same_rounding(ops.ternary_matvec, x[:m], t1p, t2p, alpha,
                                   y, what)
            for m in tiled_ms:
                what = f"matmul {name} {dtype} m={m}"
                y = ops.ternary_matmul_tiled(x[:m].contiguous(), t1p, t2p,
                                             alpha, GROUP)
                worst, worst_abs = _close(y, ref.ternary_matmul_grouped(
                    x[:m], t1p, t2p, alpha, GROUP), what, worst, worst_abs)
                if bf16:
                    _same_rounding(ops.ternary_matmul_tiled, x[:m], t1p, t2p,
                                   alpha, y, what)
                for a, b in matvec_windows(m):
                    rows = ops.ternary_matvec(x[a:b].contiguous(), t1p, t2p,
                                              alpha, GROUP)
                    if not torch.equal(rows, y[a:b]):
                        raise AssertionError(
                            f"{what}: matvec rows {a}..{b - 1} differ from the "
                            "tiled kernel's (must be bit-identical)")
        del t1p, t2p, alpha, x, x32
    routes = {str(dt).split(".")[-1]: ops.route(dt)
              for dt in (torch.bfloat16, torch.float32)}
    log(f"ternary kernels == plain (max abs err {worst_abs:.2e}, max err / "
        f"scale {worst:.2e} <= {MM_RTOL}); routes by x dtype: {routes}; "
        "matvec rows bit-identical to tiled rows for windows "
        f"{list(matvec_windows(512))} (m = 512; likewise at 128 and 200); "
        "bf16 outputs equal the f32 outputs rounded")
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


def first_token(args, pos_at):
    """The L = 1 operands of an L = 64 case's l = 0 query: q, k_new, v_new
    and positions (at index ``pos_at``) cut to their first token."""
    return [a[:, :1].contiguous() if i in (0, 1, 2, pos_at) else a
            for i, a in enumerate(args)]


def row_of(args, i, shared=()):
    """Row i of every per-row operand as a batch of one (fresh, aligned
    copies); the operands at the indices in ``shared`` (a paged pool) are
    passed whole."""
    return [a if a is None or j in shared else a[i:i + 1].clone()
            for j, a in enumerate(args)]


def same_rows(kernel, args64, pos_at, what, shared=()):
    """The split-KV walk's batch invariance at the main path's shapes: with
    lengths 1, the L = 1 call's rows equal l = 0 of the L = 64 call, and
    every row alone (B = 1) equals its row in the batch of 8, bit for bit.
    Returns the L = 1 operands."""
    import torch

    args1 = first_token(args64, pos_at)
    out1, out64 = kernel(*args1), kernel(*args64)
    if not torch.equal(out64[:, :1], out1):
        raise AssertionError(f"{what}: rows at L = 1 differ from l = 0 of "
                             "L = 64 with length 1")
    for args, out in ((args1, out1), (args64, out64)):
        for i in range(out.shape[0]):
            if not torch.equal(kernel(*row_of(args, i, shared)),
                               out[i:i + 1]):
                raise AssertionError(f"{what}: row {i} alone differs from "
                                     f"the batch (L = {out.shape[1]})")
    return args1


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
    for ring in ("bfloat16", "int8"):
        args = attention_inputs(SLOTS, PREFILL_CHUNK, CAPACITY, kv, g, hd,
                                ring, fill, gen, dev)
        args[9].fill_(1)
        same_rows(ops.chunk_attention_cuda, args, 8, f"B2 {ring}")
    log(f"chunk_attention == plain (max abs err {worst:.2e} <= {ATTN_TOL}) "
        "for L in (1, 64), bf16 and int8 rings, wrapped and partly filled; "
        "rows bit-identical alone and in the batch of 8, and at L = 1 and "
        "L = 64 with length 1")
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


def paged_operands(a, ps, rng):
    """The ring operands ``a`` (``attention_inputs``) scattered into a pool
    of ps-slot pages under a shuffled table, about one logical page in ten
    left on the null page 0 (pos -1). Returns (paged args, the gathered
    virtual ring's args for B2)."""
    import numpy as np
    import torch

    from repro_torch.kernels.chunk_attention import ref

    q, kn, vn, kc, ks, vc, vs, pos_buf, positions, lengths = a
    b, cap = pos_buf.shape
    n = cap // ps
    table = (1 + rng.permutation(b * n)).reshape(b, n)
    table[rng.random((b, n)) < 0.1] = 0
    table = torch.from_numpy(table.astype(np.int32)).to(pos_buf.device)
    ids = table.reshape(-1).long()
    mapped = ids != 0

    def pool(ring, fill):
        if ring is None:
            return None
        out = torch.full((b * n + 1, ps) + tuple(ring.shape[2:]), fill,
                         dtype=ring.dtype, device=ring.device)
        out[ids[mapped]] = ring.reshape((b * n, ps) + tuple(ring.shape[2:]))[
            mapped]
        return out

    pools = [pool(kc, 0), pool(ks, 0), pool(vc, 0), pool(vs, 0),
             pool(pos_buf, -1)]
    gathered = [None if p is None else ref.gather_pages(p, table)
                for p in pools]
    return ([q, kn, vn, *pools, table, positions, lengths],
            [q, kn, vn, *gathered, positions, lengths])


def check_paged_attention(cfg, dev):
    """B4 against its plain version, and bit for bit against B2 on the
    gathered virtual ring, at L = 1 and 64, bf16 and int8 pools."""
    import numpy as np
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    rng = np.random.default_rng(5)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fill = [0, 300, 1023, 1024, 1500, 2900, 64, 700]
    worst = 0.0
    for L in (1, 64):
        for ring in ("bfloat16", "int8"):
            args = attention_inputs(SLOTS, L, CAPACITY, kv, g, hd, ring, fill,
                                    gen, dev)
            paged, gathered = paged_operands(args, PAGE, rng)
            got = ops.chunk_attention_paged_cuda(*paged)
            b2 = ops.chunk_attention_cuda(*gathered)
            want = ref.chunk_attention_paged_stream(*paged)
            torch.cuda.synchronize()
            if not torch.equal(got, b2):
                raise AssertionError(f"paged attention L={L} {ring}: B4 "
                                     "differs from B2 on the gathered ring")
            err = float((got - want).abs().max())
            if not err <= ATTN_TOL:
                raise AssertionError(f"paged attention L={L} {ring}: max err "
                                     f"{err:.3e} > {ATTN_TOL}")
            worst = max(worst, err)
    for ring in ("bfloat16", "int8"):
        args = attention_inputs(SLOTS, PREFILL_CHUNK, CAPACITY, kv, g, hd,
                                ring, fill, gen, dev)
        args[9].fill_(1)
        paged, gathered = paged_operands(args, PAGE, rng)
        paged1 = same_rows(ops.chunk_attention_paged_cuda, paged, 9,
                           f"B4 {ring}", shared=(3, 4, 5, 6, 7))
        if not torch.equal(ops.chunk_attention_paged_cuda(*paged1),
                           ops.chunk_attention_cuda(
                               *first_token(gathered, 8))):
            raise AssertionError(f"B4 {ring}: L = 1 differs from B2 on the "
                                 "gathered ring")
    log(f"chunk_attention_paged == plain (max abs err {worst:.2e} <= "
        f"{ATTN_TOL}) and == B2 on the gathered ring bit for bit, for L in "
        f"(1, 64), bf16 and int8 pools of {PAGE}-slot pages, shuffled table "
        "with null pages; rows bit-identical alone and in the batch of 8, "
        "and at L = 1 and L = 64 with length 1")
    return worst


def decode_inputs(b, s, kv, g, hd, fill, gen, dev):
    """Decode-attention operands: row r's int8 ring holds positions up to
    ``fill[r]`` (the token just written), row 1 holds nothing (every slot
    masked)."""
    import torch

    q = torch.randn((b, kv, g, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    k8 = torch.randint(-127, 128, (b, s, kv, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, (b, s, kv, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((b, s, kv), generator=gen, device=dev) * 0.02
    vs = torch.rand((b, s, kv), generator=gen, device=dev) * 0.02
    pos_buf = torch.full((b, s), -1, dtype=torch.int32, device=dev)
    for r, n in enumerate(fill):
        if r == 1:
            continue
        p = torch.arange(max(0, n - s + 1), n + 1, device=dev,
                         dtype=torch.int32)
        pos_buf[r, p % s] = p
    pos = torch.tensor(fill, dtype=torch.int32, device=dev)
    return [q, k8, ks, v8, vs, pos_buf, pos]


def check_decode_attention(cfg, dev):
    """B5 against its plain version at (8, 1024, 2, 6, 128), window None
    and 256; the row masked everywhere returns the uniform mean of v."""
    import torch

    from repro_torch.kernels.decode_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(6)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fill = [0, 300, 1023, 1024, 1500, 2900, 64, 700]
    worst = 0.0
    for window in (None, 256):
        args = decode_inputs(SLOTS, CAPACITY, kv, g, hd, fill, gen, dev)
        got = ops.decode_attention_cuda(*args, window=window)
        want = ref.decode_attention_plain(*args, window=window)
        mean_v = (args[3][1].float() * args[4][1][..., None]).mean(0)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_mean = float((got[1] - mean_v[:, None]).abs().max())
        if not max(err, err_mean) <= DECODE_TOL:
            raise AssertionError(f"decode attention window={window}: max err "
                                 f"{err:.3e}, masked row vs mean of v "
                                 f"{err_mean:.3e} > {DECODE_TOL}")
        worst = max(worst, err)
        for i in range(SLOTS):
            if not torch.equal(ops.decode_attention_cuda(*row_of(args, i),
                                                         window=window),
                               got[i:i + 1]):
                raise AssertionError(f"decode attention window={window}: "
                                     f"row {i} alone differs from the batch")
    log(f"decode_attention == plain (max abs err {worst:.2e} <= {DECODE_TOL})"
        " for window None and 256; the row masked everywhere gives the "
        "uniform mean of v; rows bit-identical alone and in the batch of 8")
    return worst


def ridge_alpha(w):
    """α of one real ridge step of the quantizer from its sign init (t¹ =
    t² = sign(w), λ grown by the condition-number rule), for group-rows w."""
    import torch

    from repro_torch.core import ptqtp

    cfg = ptqtp.PTQTPConfig()
    t = torch.where(w >= 0.0, 1.0, -1.0)
    lam = torch.full((w.shape[0],), cfg.lambda_init, device=w.device)
    sums = ptqtp._ridge_sums(t, t, w)
    _, kappa = ptqtp._ridge_solve(sums, lam)
    lam = torch.where(kappa >= cfg.cond_bound, torch.clamp(
        lam * torch.sqrt(kappa / cfg.cond_bound), max=cfg.lambda_max), lam)
    return ptqtp._ridge_solve(sums, lam)[0]


def search_inputs(cfg, dev, n, seed):
    """An (n, d_model) weight as the model's init draws it, as (R, 128)
    group-rows, with α from one ridge step."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((n * cfg.d_model // GROUP, GROUP), generator=gen,
                    device=dev) / cfg.d_model ** 0.5
    return w, ridge_alpha(w)


def check_trit_search(cfg, dev):
    """B6's planes against the plain version's, exactly, on an 8960x1536
    matrix and the 151936x1536 lm_head."""
    import torch

    from repro_torch.kernels.ptqtp_search import ops, ref

    rows = 0
    for n, seed in ((cfg.d_ff, 7), (cfg.vocab_size, 8)):
        w, alpha = search_inputs(cfg, dev, n, seed)
        t1, t2 = ops.ptqtp_search_cuda(w, alpha)
        p1, p2 = torch.empty_like(w), torch.empty_like(w)
        ref.ptqtp_search_plain(w, alpha, p1, p2)
        torch.cuda.synchronize()
        bad = int((t1 != p1).sum()) + int((t2 != p2).sum())
        if bad:
            raise AssertionError(f"trit search {n}x{cfg.d_model}: {bad} plane "
                                 "entries differ from the plain version")
        rows += w.shape[0]
        del w, alpha, t1, t2, p1, p2
    log(f"ptqtp_search == plain exactly on {cfg.d_ff}x{cfg.d_model} and "
        f"{cfg.vocab_size}x{cfg.d_model} ({rows} group-rows of {GROUP})")
    return 0.0


# ------------------------------------------------------- phase 3: main path
def quantize_path(cfg, dev):
    """Quantize the served model (its trit step on B6), the launch counts
    reset just before and read just after. Returns (model, report, seconds,
    launches)."""
    import torch

    from repro_torch.core.ptqtp import PTQTPConfig
    from repro_torch.core.quantize_model import quantize_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    model, report = quantize_tree(model, PTQTPConfig(group_size=GROUP,
                                                     t_max=20))
    torch.cuda.synchronize()
    return model, report, time.perf_counter() - t0, launch_counts()


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


def make_engine(model, cfg, injector=None, *, warm=False, capture=True,
                observability=None, cls=None, **ecfg):
    """A ``ServingEngine`` (or ``cls``) whose decode dispatches are timed
    and whose kernel launches inside them are counted (``eng.smoke``).
    ``warm`` captures every dispatch first (``warmup()``), so a timed
    fleet replays graphs only; ``capture=False`` runs the same bodies
    eagerly (the eager-vs-graph comparison)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import EngineConfig, ServingEngine

    eng = (cls or ServingEngine)(model, cfg, EngineConfig(
        max_slots=SLOTS, capacity=CAPACITY, prefill_chunk=PREFILL_CHUNK,
        decode_chunk=DECODE_CHUNK, **ecfg), injector=injector,
        observability=observability)
    eng._capture = capture
    eng.smoke = dict(decode_s=0.0, in_decode=dict.fromkeys(launch_counts(),
                                                           0), captures=[])
    compile_ = eng._compile

    def stamped(*args, **kw):  # (clock at the capture's end, its seconds)
        dispatch = compile_(*args, **kw)
        eng.smoke["captures"].append((time.perf_counter(),
                                      dispatch.capture_s))
        return dispatch

    eng._compile = stamped
    if warm:
        warmup(eng)
    inner = eng._decode_loop

    def timed(n_steps, poison=None):  # ends in a host sync: wall = device
        before = launch_counts()
        t0 = time.perf_counter()
        out = inner(n_steps, poison)
        eng.smoke["decode_s"] += time.perf_counter() - t0
        for k, n in launch_counts().items():
            eng.smoke["in_decode"][k] += n - before[k]
        return out

    eng._decode_loop = timed
    return eng


def warmup(eng):
    """``eng.warmup()`` with the card's reserved bytes read around it after
    emptying the allocator's cache: what the graphs' pool keeps (plus the
    few static input buffers). Stored in ``eng.smoke``."""
    import torch

    gc_free()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    eng.smoke["warmup_s"] = time.perf_counter() - t0
    gc_free()
    eng.smoke["pool_bytes"] = torch.cuda.memory_reserved() - r0
    eng.smoke["compiled"] = eng.compile_stats()


def gc_free():
    """Free what dead engines hold (graphs and their pools included)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def sampled_params(n, max_new=MAX_NEW):
    """Temperature 0.8 for every request, top-k and/or top-p on some."""
    from repro_torch.serving import SamplingParams

    return [SamplingParams(max_new_tokens=max_new, temperature=0.8, seed=i,
                           top_k=50 if i % 2 else 0,
                           top_p=0.9 if i % 3 == 0 else 1.0)
            for i in range(n)]


def serve_on(eng, prompts, max_new=MAX_NEW, params=None):
    """Serve ``prompts`` on ``eng``, greedily unless ``params`` are given;
    returns their results."""
    from repro_torch.serving import SamplingParams

    params = params or [SamplingParams(max_new_tokens=max_new)
                        for _ in prompts]
    handles = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run()
    return [h.result() for h in handles]


def per_step(eng):
    """Kernel launches per decode step of the engine's own decode loops."""
    return {k: n / max(eng.steps, 1) for k, n in eng.smoke["in_decode"].items()}


def serve(model, cfg, prompts, max_new=MAX_NEW, params=None, **ecfg):
    """Serve ``prompts`` (greedy unless ``params``) on a fresh engine;
    returns (results, decode seconds, decode tokens, kernel launches per
    decode step, engine)."""
    eng = make_engine(model, cfg, **ecfg)
    results = serve_on(eng, prompts, max_new, params)
    return (results, eng.smoke["decode_s"],
            eng.tokens_generated - len(prompts), per_step(eng), eng)


def main_path(cfg, dev, model):
    from repro_torch.kernels import launch_counts, reset_launch_counts

    prompts = make_prompts(cfg)
    reset_launch_counts()
    eng = make_engine(model, cfg, warm=True)
    syncs = count_syncs(eng)
    t0 = time.perf_counter()
    results = serve_on(eng, prompts)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    decode_s, decode_tok = eng.smoke["decode_s"], eng.tokens_generated - len(
        prompts)
    # warmup() left nothing for the fleet to capture
    compiled = {k: v for k, v in eng.compile_stats().items()
                if k not in ("admits", "prefill_steps")}
    if any(eng.smoke["compiled"][k] != v for k, v in compiled.items()):
        raise AssertionError(f"the fleet compiled more after warmup(): "
                             f"{eng.smoke['compiled']} -> {compiled}")
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
    return dict(counts=counts,
                wall=wall, decode_s=decode_s, decode_tok=decode_tok,
                ttft=ttft, engine=eng, prompts=prompts, results=results,
                per_step=per_step(eng), graphs=eng.graph_stats(),
                steps=eng.steps, syncs=syncs,
                warmup_s=eng.smoke["warmup_s"],
                pool_bytes=eng.smoke["pool_bytes"],
                compiled=eng.smoke["compiled"],
                solo=dict(longest=(longest, len(prompts[longest])),
                          bucket_1=(one[0], len(prompts[one[0]]),
                                    fleet_buckets[one[0]])))


def paged_path(cfg, dev, model, mp):
    """The paged serving path, (a)-(d) of the module docstring. The ring
    references of (b) and (c) run first; then the launch counts are reset
    and only paged engines run until they are read."""
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    fleet = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(TAILS[0], TAILS[1] + 1, N_REQUESTS)]
    wrap = prefix + rng.integers(0, cfg.vocab_size,
                                 WRAP_PROMPT - SHARED_PREFIX).tolist()
    ring_b = serve(model, cfg, fleet)[0]
    ring_c = serve(model, cfg, [wrap], WRAP_NEW)[0][0]
    paged = dict(kv_layout="paged", page_size=PAGE, prefix_cache=True)

    def same(got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            if g.tokens != w.tokens:
                raise AssertionError(f"{what}: request {i} gave {g.tokens} "
                                     f"paged, {w.tokens} on the ring")

    reset_launch_counts()
    # (a) the ring path's fleet
    res_a, dec_s, dec_tok, steps_a, eng_a = serve(model, cfg, mp["prompts"],
                                                  warm=True, **paged)
    same(res_a, mp["results"], "(a) main fleet")
    # (b) the shared-prefix fleet, cold (all admitted at once: nothing is
    # cached yet), then warm on an engine where one request has published
    # the prefix
    cold_eng = make_engine(model, cfg, warm=True, **paged)
    cold = serve_on(cold_eng, fleet)
    same(cold, ring_b, "(b) cold shared-prefix fleet")
    eng = make_engine(model, cfg, warm=True, **paged)
    serve_on(eng, [prefix + [1]], 1)
    pf0 = eng.prefill_tokens
    warm = serve_on(eng, fleet)
    same(warm, ring_b, "(b) warm shared-prefix fleet")
    hits = eng.alloc.hits
    if not hits > 0:
        raise AssertionError("(b) the warm fleet found no prefix page cached")
    saved = cold_eng.prefill_tokens - (eng.prefill_tokens - pf0)
    # (c) a request with the prefix that wraps the ring, then the prefix again
    forks0 = eng.alloc.forks
    got_c = serve_on(eng, [wrap], WRAP_NEW)[0]
    same([got_c], [ring_c], "(c) wrapping request")
    forks = eng.alloc.forks - forks0
    if not forks > 0:
        raise AssertionError("(c) the wrapping request forked no page")
    same(serve_on(eng, fleet[:1]), ring_b[:1], "(c) prefix after the wrap")
    counts = launch_counts()
    # (d) drained: invariants hold, only the prefix cache holds pages
    for e in (eng_a, cold_eng, eng):
        e.alloc.check()
        if e.alloc.used_pages() != e.alloc.cached_pages():
            raise AssertionError(f"{e.alloc.used_pages()} pages in use after "
                                 f"the drain, {e.alloc.cached_pages()} cached")
    return dict(counts=counts, per_step=steps_a, decode_s=dec_s,
                tokens_a=[r.tokens for r in res_a], steps=eng_a.steps,
                warmup_s=eng_a.smoke["warmup_s"],
                pool_bytes=eng_a.smoke["pool_bytes"],
                decode_tok=dec_tok, ttft=sorted(r.ttft for r in res_a),
                ttft_cold=sorted(r.ttft for r in cold),
                ttft_warm=sorted(r.ttft for r in warm), hits=hits,
                misses=eng.alloc.misses, forks=forks, saved=saved,
                cold_prefill=cold_eng.prefill_tokens,
                prompt_tokens=sum(len(p) for p in fleet),
                pages=eng.alloc.n_pages, peak=eng.alloc.peak_used,
                fleet=fleet, ring_b=ring_b,
                cold_cached=cold_eng.alloc.cached_pages())


# ------------------------------------------------- phases 8-10: slice 6
def count_syncs(eng):
    """Count the host syncs of each of ``eng``'s decode dispatches replayed
    from a graph (``torch.cuda``'s sync-debug warnings; a blocking copy
    counts as one too). Returns the list that fills, one (fleet arrays
    rebuilt, syncs) pair a replay: a dispatch after the fleet changed also
    sends the per-slot arrays. A dispatch whose graph was captured in the
    call (which synchronizes for the capture) is left out."""
    import warnings

    import torch

    inner, per_dispatch = eng._decode_loop, []

    def counted(n_steps, poison=None):
        rebuilt = eng._slot_arrays is None
        graphs = len(eng._loop_cache)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = inner(n_steps, poison)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        if len(eng._loop_cache) == graphs:
            per_dispatch.append((rebuilt, sum(
                "called a synchronizing" in str(w.message) for w in seen)))
        return out

    eng._decode_loop = counted
    return per_dispatch


def write_model_artifact(out, model, cfg, **writer_kw):
    """Write an already quantized model through ``ArtifactWriter``
    (``add_quantized`` / ``add_fp`` over ``to_reference_tree``): its bytes
    go to disk unchanged. One group commit at the end, so the append and
    the fsync time apart. Returns (path, append s, fsync + publish s)."""
    from repro_torch.artifacts import ArtifactWriter
    from repro_torch.artifacts import format as afmt
    from repro_torch.convert import to_reference_tree
    from repro_torch.core.ptqtp import PTQTPConfig
    from repro_torch.core.quantize_model import QuantizedKernel

    t0 = time.perf_counter()
    w = ArtifactWriter(out, arch=cfg.name, commit_every=1 << 30,
                       model_config=afmt.model_config_to_json(cfg),
                       ptqtp_config=afmt.ptqtp_config_to_json(
                           PTQTPConfig(group_size=GROUP, t_max=20)),
                       **writer_kw)
    for path, leaf in afmt.iter_tree_leaves(to_reference_tree(model, cfg)):
        if isinstance(leaf, QuantizedKernel):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    t1 = time.perf_counter()
    final = w.finalize()
    return final, t1 - t0, time.perf_counter() - t1


def damaged_copies(model, cfg, dev, tmp):
    """A second, small artifact (layer 0's attention and the norms), damaged
    two ways: a torn shard must fail ``verify="sizes"``, a flipped byte
    must pass it and fail ``verify="full"``."""
    import shutil

    from repro_torch.artifacts import ArtifactError, ArtifactWriter
    from repro_torch.artifacts import format as afmt
    from repro_torch.artifacts import load_artifact
    from repro_torch.convert import to_reference_tree
    from repro_torch.core.ptqtp import PTQTPConfig
    from repro_torch.serving.faults import (corrupt_artifact_shard,
                                            truncate_artifact_shard)

    tree = to_reference_tree(model, cfg)
    b0 = tree["blocks"]["b0"]
    w = ArtifactWriter(tmp / "small", arch=cfg.name,
                       model_config=afmt.model_config_to_json(cfg),
                       ptqtp_config=afmt.ptqtp_config_to_json(
                           PTQTPConfig(group_size=GROUP, t_max=20)))
    for name in ("wq", "wk", "wv", "wo"):
        qk = b0["attn"][name]["kernel"]
        w.add_quantized(f"/layer0/attn/{name}/kernel", type(qk)(
            qk.t1p[:1], qk.t2p[:1], qk.alpha[:1], qk.d_in, qk.d_out,
            qk.group_size), source_shape=(1, qk.d_in, qk.d_out),
            source_dtype=cfg.param_dtype)
    w.add_fp("/layer0/attn_norm/scale", b0["attn_norm"]["scale"][:1])
    w.add_fp("/final_norm/scale", tree["final_norm"]["scale"])
    small = w.finalize()
    load_artifact(small, verify="full", device=dev)
    torn, flipped = tmp / "torn", tmp / "flipped"
    shutil.copytree(small, torn)
    shutil.copytree(small, flipped)
    cut = truncate_artifact_shard(torn, seed=0, drop_bytes=7)
    flip = corrupt_artifact_shard(flipped, seed=3)
    load_artifact(flipped, verify="sizes", device=dev)  # sizes are intact
    caught = []
    for where, mode in ((torn, "sizes"), (flipped, "full")):
        try:
            load_artifact(where, verify=mode, device=dev)
        except ArtifactError as e:
            caught.append(str(e))
        else:
            raise AssertionError(f"verify={mode!r} accepted the damaged "
                                 f"copy {where.name}")
    if flip["tensor"] not in caught[1] or "truncated" not in caught[0]:
        raise AssertionError(f"damage reports name the wrong place: "
                             f"{caught} for {cut}, {flip}")
    return cut, flip


def bytes_equal(a, b) -> bool:
    import torch

    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def artifact_path(cfg, dev, model, mp):
    """(e) the full-width artifact round trip: write the quantized model,
    load it onto the card with every crc32 checked, require byte-identical
    tensors, serve the ring fleet and the paged fleet (a) from it with the
    ring phase's tokens, and refuse damaged copies of a small artifact."""
    import shutil
    import tempfile

    from repro_torch.artifacts import load_model
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_artifact_"))
    try:
        art, write_s, fsync_s = write_model_artifact(tmp / "full", model,
                                                     cfg)
        nbytes = sum(f.stat().st_size for f in art.iterdir())
        boot = {}
        t0 = time.perf_counter()
        loaded, lcfg, manifest = load_model(art, verify="full", device=dev,
                                            timings=boot)
        boot_s = time.perf_counter() - t0
        if lcfg != cfg:
            raise AssertionError(f"the manifest's config {lcfg} is not {cfg}")
        a, b = model.state_dict(), loaded.state_dict()
        if list(a) != list(b):
            raise AssertionError("the loaded model has other tensors")
        diff = [k for k in a if not (b[k].device.type == dev.type
                                     and bytes_equal(a[k], b[k]))]
        if diff:
            raise AssertionError(f"tensors differ after the round trip: "
                                 f"{diff[:5]}")
        want = [r.tokens for r in mp["results"]]
        runs = {}
        for layout in ("ring", "paged"):
            kw = {} if layout == "ring" else dict(kv_layout="paged",
                                                  page_size=PAGE)
            eng = make_engine(loaded, cfg, **kw)
            syncs = count_syncs(eng)
            reset_launch_counts()
            got = [r.tokens for r in serve_on(eng, mp["prompts"])]
            runs[layout] = (launch_counts(), syncs)
            if got != want:
                bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
                raise AssertionError(f"(e) {layout} fleet from the artifact: "
                                     f"requests {bad} differ from the ring "
                                     f"phase's tokens")
        cut, flip = damaged_copies(model, cfg, dev, tmp)
        del loaded
        return dict(nbytes=nbytes, write_s=write_s, fsync_s=fsync_s,
                    boot=boot, boot_s=boot_s, runs=runs, cut=cut, flip=flip,
                    tensors=len(manifest["tensors"]),
                    stats=manifest["stats"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def fixture_path(dev):
    """(f) the artifact written by the JAX package
    (``tests/torch_fixtures/make_artifact_fixture.py``), served on the card
    through the kernels (f32 activations: the FMA routes) with the JAX
    engine's committed greedy streams, the fleet and the bucket-1 request
    alone. A mismatch fails the run as it is."""
    from repro_torch.artifacts import load_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

    spec = json.loads((FIXTURES / "qwen2_smoke_streams.json").read_text())
    model, cfg, _ = load_model(FIXTURES / "qwen2_smoke_artifact",
                               verify="full", device=dev)
    reqs = [(r["prompt"], r["max_new_tokens"]) for r in spec["requests"]]

    def run(rs, layout):
        eng = ServingEngine(model, cfg, EngineConfig(
            **spec["engine"], kv_layout=layout, page_size=8))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in rs]
        eng.run()
        return [h.output for h in hs]

    reset_launch_counts()
    got = {layout: run(reqs, layout) for layout in ("ring", "paged")}
    solo = run([reqs[spec["solo"]["index"]]], "ring")[0]
    counts = launch_counts()
    for layout, streams in got.items():
        if streams != spec["streams"]:
            raise AssertionError(f"(f) {layout}: the port served {streams}, "
                                 f"the JAX engine {spec['streams']}")
    if solo != spec["solo"]["tokens"]:
        raise AssertionError(f"(f) the bucket-1 request alone: {solo}, the "
                             f"JAX engine {spec['solo']['tokens']}")
    return dict(counts=counts, n=len(reqs),
                tokens=sum(len(t) for t in spec["streams"]))


NAN_DECODE = (2, 6)   # (request, generated-token index) NaN'd mid-dispatch
NAN_PREFILL = 5       # request whose prefill-finisher logits are NaN'd


def contained(model, cfg, prompts, clean, what, **ecfg):
    """Serve ``prompts`` under the NaN plan step by step; require the two
    victims retired "error" with the clean run's tokens so far, every
    other stream equal to ``clean``, and each victim's slot quarantined
    for ``quarantine_steps`` steps, then restored. Returns (engine, syncs
    per decode dispatch, launch counts)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.faults import FaultInjector, FaultPlan

    (dv, dk), pv = NAN_DECODE, NAN_PREFILL
    plan = FaultPlan().nan_logits(dv, dk).nan_logits(pv, 0)
    eng = make_engine(model, cfg, injector=FaultInjector(plan), **ecfg)
    syncs = count_syncs(eng)
    reset_launch_counts()
    hs = [eng.submit(p, SamplingParams(max_new_tokens=MAX_NEW))
          for p in prompts]
    history = []
    while eng.queue or any(s is not None for s in eng.slots)             or eng.quarantined:  # idle steps let the quarantine lapse
        eng.step()
        history.append((eng.engine_steps, dict(eng.quarantined)))
    counts = launch_counts()
    for i, h in enumerate(hs):
        want = list(clean[i])
        if i in (dv, pv):
            cut = dk if i == dv else 0
            if h.finish_reason != "error" or h.output != want[:cut]:
                raise AssertionError(f"(g) {what}: victim {i} ended "
                                     f"{h.finish_reason!r} with "
                                     f"{len(h.output)} tokens ({h.error})")
        elif h.output != want:
            raise AssertionError(f"(g) {what}: request {i} differs from the "
                                 f"clean run")
    cool = eng.ecfg.quarantine_steps
    for slot in {s for _, q in history for s in q}:
        steps = [(t, q[slot]) for t, q in history if slot in q]
        first, until = steps[0]
        if until != first + cool or [t for t, _ in steps] != list(
                range(first, until)):
            raise AssertionError(f"(g) {what}: slot {slot} quarantined at "
                                 f"steps {[t for t, _ in steps]} until "
                                 f"{until}, not {cool} steps")
    if len({s for _, q in history for s in q}) != 2:
        raise AssertionError(f"(g) {what}: quarantine history {history}")
    return eng, syncs, counts


def containment_path(cfg, dev, model, mp, pp):
    """(g) containment at full width: the ring fleet with one request NaN'd
    inside a K-step dispatch and one at its prefill finisher; then the same
    plan on the paged layout with the shared-prefix fleet, where the
    prefill victim's own prompt pages must stay out of the prefix cache."""
    ring, ring_syncs, ring_counts = contained(
        model, cfg, mp["prompts"], [r.tokens for r in mp["results"]],
        "ring")
    need(ring_counts, RING_PATH, "the ring containment path")
    paged, paged_syncs, paged_counts = contained(
        model, cfg, pp["fleet"], [r.tokens for r in pp["ring_b"]], "paged",
        kv_layout="paged", page_size=PAGE, prefix_cache=True)
    need(paged_counts, PAGED_PATH, "the paged containment path")
    own = len(pp["fleet"][NAN_PREFILL]) // PAGE - SHARED_PREFIX // PAGE
    cached = paged.alloc.cached_pages()
    if cached != pp["cold_cached"] - own or paged.alloc.evictions:
        raise AssertionError(f"(g) paged: {cached} pages cached, the clean "
                             f"cold run {pp['cold_cached']}; the victim "
                             f"owns {own}")
    paged.alloc.check()
    return dict(ring_syncs=ring_syncs, paged_syncs=paged_syncs,
                errors=(ring.errors, paged.errors), own=own, cached=cached,
                counts=(ring_counts, paged_counts))


# ---------------------------------------------- phases 11-16: slice 7
def graphs_path(cfg, dev, model, mp, pp):
    """Graph against eager, in this run: the main fleet and the paged fleet
    (a), greedy and sampled (temperature 0.8, top-k/top-p on some rows),
    each served by an engine whose dispatches are CUDA graphs and by one
    that runs the same bodies eagerly; the streams must be equal. The
    greedy graph runs are those of phases 4 and 5; the sampled graph
    engines are warmed first too. Returns the decode seconds and tokens
    and the TTFTs of each run."""
    out = {}
    for layout in ("ring", "paged"):
        kw = {} if layout == "ring" else dict(kv_layout="paged",
                                              page_size=PAGE)
        graph_greedy = mp if layout == "ring" else pp
        for mode in ("greedy", "sampled"):
            params = None if mode == "greedy" else sampled_params(
                len(mp["prompts"]))
            runs = {}
            for capture in ((False,) if mode == "greedy" else (True, False)):
                res, dec_s, dec_tok, _, eng = serve(
                    model, cfg, mp["prompts"], params=params, warm=capture,
                    capture=capture, **kw)
                runs[capture] = dict(
                    tokens=[r.tokens for r in res], decode_s=dec_s,
                    decode_tok=dec_tok, ttft=sorted(r.ttft for r in res),
                    steps=eng.steps)
                del eng
                gc_free()
            if mode == "greedy":
                runs[True] = dict(
                    tokens=[r.tokens for r in mp["results"]]
                    if layout == "ring" else pp["tokens_a"],
                    decode_s=graph_greedy["decode_s"],
                    decode_tok=graph_greedy["decode_tok"],
                    ttft=graph_greedy["ttft"], steps=graph_greedy["steps"])
            if runs[True]["tokens"] != runs[False]["tokens"]:
                bad = [i for i, (g, e) in enumerate(zip(
                    runs[True]["tokens"], runs[False]["tokens"])) if g != e]
                raise AssertionError(f"{layout} {mode}: graph and eager "
                                     f"streams differ for requests {bad}")
            out[(layout, mode)] = runs
    return out


def traced_path(cfg, dev, model, mp):
    """The main fleet on warmed engines with tracing on, then with the
    default (registry-only) bundle: streams equal to phase 4's, the
    trace's events, and each run's decode tok/s (phase 4's run is the
    first untraced one)."""
    from repro_torch.serving import Observability

    want = [r.tokens for r in mp["results"]]
    rates = {True: [], False: []}
    events = 0
    for trace in (True, False):
        eng = make_engine(model, cfg, warm=True,
                          observability=Observability(trace=trace))
        got = [r.tokens for r in serve_on(eng, mp["prompts"])]
        if got != want:
            raise AssertionError(f"trace={trace}: the fleet gave other "
                                 f"tokens")
        rates[trace].append((eng.tokens_generated - len(want))
                            / eng.smoke["decode_s"])
        if trace:
            events = len(eng.obs.trace)
            health = eng.health().summary()
        del eng
        gc_free()
    return dict(rates=rates, events=events, health=health)


def serial_path(cfg, dev, model, mp):
    """``SerialAdmitEngine`` (one graph per prompt length, each request
    prefilled alone) on the main fleet: the bucketed engine's streams."""
    from repro_torch.serving import SerialAdmitEngine

    eng = make_engine(model, cfg, cls=SerialAdmitEngine)
    t0 = time.perf_counter()
    res = serve_on(eng, mp["prompts"])
    wall = time.perf_counter() - t0
    got = [r.tokens for r in res]
    want = [r.tokens for r in mp["results"]]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        raise AssertionError(f"serial admission: requests {bad} differ from "
                             f"the bucketed engine's tokens")
    stats = eng.compile_stats()
    if stats["n_prefill_compiles"] != len({len(p) for p in mp["prompts"]}):
        raise AssertionError(f"serial prefill dispatches: {stats}")
    return dict(wall=wall, ttft=sorted(r.ttft for r in res), stats=stats,
                capture_s=eng.graph_stats()["capture_s"],
                decode_s=eng.smoke["decode_s"],
                decode_tok=eng.tokens_generated - len(res))


def dense_path(cfg, dev, mp):
    """C.2: the unquantized bf16 model (``--no-quantize``'s path, dense
    layers on ``models.common.dense``) served in the main fleet and alone
    for the longest request and the one whose last prefill chunk is bucket
    1 alone (a wider bucket, so another GEMM m, in the fleet): equal
    streams. Returns the fleet's decode time and TTFTs."""
    import torch

    from repro_torch.models import common, init_params

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    # why the fixed-shape blocks: for each linear layer of a block and the
    # lm_head, rows 0-7 of a 512-row product (a prefill bucket of 64 in the
    # fleet) against the same rows alone (bucket 1), through one F.linear
    # and through the row blocks
    gen = torch.Generator(device=dev).manual_seed(SEED)
    block = model.layers[0]
    plain = {}
    for name, layer in (("wq", block.attn.wq), ("wk", block.attn.wk),
                        ("wo", block.attn.wo), ("wi", block.mlp.wi),
                        ("mlp.wo", block.mlp.wo), ("lm_head", model.lm_head)):
        x = torch.randn((512, layer.d_in), generator=gen, device=dev).to(
            torch.bfloat16)
        w = layer.weight
        plain[name] = int((torch.nn.functional.linear(x[:8], w)
                           != torch.nn.functional.linear(x, w)[:8]).sum())
        fixed = int((common.dense(layer, x[:8])
                     != common.dense(layer, x)[:8]).sum())
        if fixed:
            raise AssertionError(f"C.2: the fixed-row dense route's {name} "
                                 f"rows differ alone and in a 512-row call "
                                 f"({fixed} elements)")
    prompts = mp["prompts"]
    res, dec_s, dec_tok, _, eng = serve(model, cfg, prompts, warm=True)
    del eng
    longest, one = mp["solo"]["longest"][0], mp["solo"]["bucket_1"][0]
    for i in (longest, one):
        solo = serve(model, cfg, [prompts[i]])[0][0].tokens
        if solo != res[i].tokens:
            raise AssertionError(f"C.2: dense request {i} alone gave "
                                 f"{solo}, in the fleet {res[i].tokens}")
    del model
    gc_free()
    return dict(decode_s=dec_s, decode_tok=dec_tok,
                ttft=sorted(r.ttft for r in res), longest=longest, one=one,
                plain_diff=plain)


def decode_attention_path(cfg, dev):
    """Decode attention through its op (``decode_attention``, B5's only
    entry point) for the 28 layers of one decode step at full width, the
    launch counts reset just before and read just after."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.decode_attention import decode_attention

    gen = torch.Generator(device=dev).manual_seed(9)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fill = [600, 300, 1023, 1024, 1500, 2900, 64, 700]
    layers = [decode_inputs(SLOTS, CAPACITY, kv, g, hd, fill, gen, dev)
              for _ in range(cfg.n_layers)]
    reset_launch_counts()
    outs = [decode_attention(*a) for a in layers]
    counts = launch_counts()
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise AssertionError("decode attention gave non-finite outputs")
    return counts, layers


def split_line(cfg, per_step):
    """The split-KV partition and grid of the attention kernel at the main
    path's decode (L = 1) and prefill (L = 64) shapes."""
    from repro_torch.kernels.chunk_attention.ops import (PART_SLOTS,
                                                         ROW_TILE,
                                                         split_ranges)

    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    n_ring = len(split_ranges(CAPACITY))
    grids = {}
    for L in (1, PREFILL_CHUNK):
        grid = (n_ring + len(split_ranges(L)), -(-L * g // ROW_TILE),
                kv * SLOTS)
        grids[L] = f"{grid} = {grid[0] * grid[1] * grid[2]} blocks"
    return (f"split-KV attention: cap {CAPACITY} -> n_part {n_ring} ring "
            f"parts of {PART_SLOTS} slots + 1 chunk part (L <= "
            f"{PART_SLOTS}), {ROW_TILE} query rows a block; grid at L = 1 "
            f"{grids[1]}, at L = {PREFILL_CHUNK} {grids[PREFILL_CHUNK]}; one "
            f"launch per read (combine in the kernel), {per_step:.1f} "
            "attention launches per decode step")


# ------------------------------------------------- phases (h)-(i): slice 8
HTTP_CLIENT_TIMEOUT = 300  # seconds a client waits for its response


def post_fleet(base, prompts, max_new=MAX_NEW, sse=lambda i: i % 2 == 0):
    """Post ``prompts`` (greedy, ``max_new`` new tokens) to ``base``'s
    ``/v1/completions`` from one client thread each, the ``sse(i)`` ones as
    SSE streams. Returns (one dict a request: tokens, the indices of its
    SSE token events, its result body, client seconds to the first token
    event and to the end; the fleet's wall seconds)."""
    import threading
    import urllib.request

    out = [None] * len(prompts)

    def client(i):
        stream = sse(i)
        body = json.dumps({"prompt": prompts[i], "max_new_tokens": max_new,
                           "stream": stream}).encode()
        req = urllib.request.Request(
            base + "/v1/completions", data=body,
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        rec = dict(sse=stream, tokens=[], indices=[], result=None,
                   first_s=None)
        try:
            with urllib.request.urlopen(req, timeout=HTTP_CLIENT_TIMEOUT) \
                    as resp:
                if not stream:
                    rec["result"] = json.loads(resp.read())
                    rec["tokens"] = rec["result"]["tokens"]
                for raw in resp if stream else ():
                    line = raw.decode().strip()
                    if not line.startswith("data: ") \
                            or line == "data: [DONE]":
                        continue
                    ev = json.loads(line[len("data: "):])
                    if "token" in ev:
                        if rec["first_s"] is None:
                            rec["first_s"] = time.perf_counter() - t0
                        rec["tokens"].append(ev["token"])
                        rec["indices"].append(ev["index"])
                    else:
                        rec["result"] = ev
        except Exception as e:  # reported by the gate below
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["end_s"] = time.perf_counter() - t0
        out[i] = rec

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=HTTP_CLIENT_TIMEOUT + 60)
    wall = time.perf_counter() - t0
    if any(th.is_alive() for th in threads):
        raise AssertionError("an HTTP client never returned")
    return out, wall


def same_streams(got, want, what):
    """Every request's tokens equal ``want``'s, each SSE token index given
    once and in order, the result body's tokens the stream's."""
    for i, (g, w) in enumerate(zip(got, want)):
        if "error" in g or g["result"] is None:
            raise AssertionError(f"{what}: request {i} failed: "
                                 f"{g.get('error', 'no result event')}")
        if g["result"]["finish_reason"] != "length":
            raise AssertionError(f"{what}: request {i} ended "
                                 f"{g['result']['finish_reason']}: "
                                 f"{g['result']['error']}")
        if tuple(g["tokens"]) != tuple(w) \
                or tuple(g["result"]["tokens"]) != tuple(w):
            raise AssertionError(f"{what}: request {i} gave {g['tokens']}, "
                                 f"phase 4 {list(w)}")
        if g["sse"] and g["indices"] != list(range(len(w))):
            raise AssertionError(f"{what}: request {i}'s SSE token indices "
                                 f"{g['indices']} (duplicated or missing)")


def poll_endpoints(base, stop):
    """Ask ``/healthz`` and ``/metrics`` in turn until ``stop`` is set;
    returns the count of 200 answers of each."""
    import urllib.request

    ok = {"/healthz": 0, "/metrics": 0}
    while not stop.is_set():
        for path in ok:
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                body = resp.read()
                if resp.status == 200 and (
                        path == "/metrics" or json.loads(body)["ok"]):
                    ok[path] += 1
    return ok


def http_path(cfg, dev, model, mp):
    """(h): a fresh engine, not warmed, behind ``EngineDriver`` and
    ``ThreadedHttpServer``; the ring fleet posted twice from 8 client
    threads (half SSE): the first run captures the graphs on the driver's
    thread while the clients and the endpoint poller are live, the second
    replays them. Both give phase 4's tokens. Launch counts reset just
    before and read just after."""
    import threading

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving.frontend import EngineDriver, ThreadedHttpServer

    want = [r.tokens for r in mp["results"]]
    reset_launch_counts()
    eng = make_engine(model, cfg)
    driver = EngineDriver(eng).start()
    try:
        srv = ThreadedHttpServer(driver).start()
    except BaseException:
        driver.close()
        raise
    base = f"http://{srv.host}:{srv.port}"
    runs = []
    try:
        for run in ("capture", "replay"):
            dec0 = (eng.smoke["decode_s"], eng.tokens_generated, eng.steps)
            stop, polled = threading.Event(), {}
            poller = threading.Thread(
                target=lambda: polled.update(poll_endpoints(base, stop)))
            poller.start()
            try:
                got, wall = post_fleet(base, mp["prompts"])
            finally:
                stop.set()
                poller.join(timeout=120)
            same_streams(got, want, f"(h) {run}")
            if not (polled.get("/healthz") and polled.get("/metrics")):
                raise AssertionError(f"(h) {run}: /healthz and /metrics "
                                     f"answered {polled} times")
            n_tok = sum(len(g["tokens"]) for g in got)
            runs.append(dict(
                run=run, wall=wall, tokens=n_tok, polled=polled,
                decode_s=eng.smoke["decode_s"] - dec0[0],
                decode_tok=eng.tokens_generated - dec0[1] - len(got),
                steps=eng.steps - dec0[2],
                ttft=sorted(g["result"]["ttft_s"] for g in got),
                client_ttft=sorted(g["first_s"] for g in got if g["sse"]),
                graphs=driver.call(lambda e: (
                    len(e._loop_cache) + len(e._prefill_cache),
                    e.graph_stats()["capture_s"]))))
    finally:
        srv.stop()
        driver.close()
    return dict(runs=runs, counts=launch_counts())


def settled_bytes(eng):
    """Device bytes the live ``eng`` may hold beyond another generation
    of the same engine: its graphs' static inputs and outputs (the live
    tensors of its graph pool) and its attention scratch, each rounded up
    to the allocator's 512-byte blocks. The margin of (i)'s memory gate."""
    from repro_torch.kernels.chunk_attention import ops as ca_ops

    def nbytes(t):
        return -(-t.numel() * t.element_size() // 512) * 512

    key = (eng._stream.device_index, eng._stream.cuda_stream)
    scratch = list(ca_ops._WORKSPACES.get(key, ())) + [
        t for ws in ca_ops._RETIRED.get(key, ()) for t in ws]
    dispatches = list(eng._loop_cache.values()) + list(
        eng._prefill_cache.values())
    return sum(nbytes(t) for t in scratch) + sum(
        nbytes(d.static_in) + nbytes(d.out) for d in dispatches)


def recovery_path(cfg, dev, model, mp):
    """(i): an ``EngineSupervisor`` (and the HTTP server in front of it)
    whose factory builds ring engines on the model already on the card,
    each with a fresh ``FaultPlan``; three rounds of the ring fleet over
    HTTP (half SSE), each armed on the live generation: generation 0 dies
    of a crash at a decode dispatch of half the fleet or more (ambiguous),
    generation 1 of a crash blamed on a poison request resident since the
    round began, generation 2 hangs a step of half the fleet or more (its
    clock virtual) until the watchdog rebuilds. After each round the
    survivors' streams equal phase 4's (every SSE index once), and once
    generation 1, 2 and 3 have settled the dead ones are collected and
    device memory is read: generation 3's may exceed generation 1's by
    ``settled_bytes`` of generation 3's engine at most. Launch counts reset just before and read just after."""
    import threading
    import weakref

    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import SamplingParams
    from repro_torch.serving.faults import (FaultInjector, FaultPlan,
                                            VirtualClock)
    from repro_torch.serving.frontend import (EngineSupervisor,
                                              ThreadedHttpServer)
    from repro_torch.serving.graphs import collect_garbage

    want = [r.tokens for r in mp["results"]]
    poison_prompt = np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, 16).tolist()  # decoding from the round's 1st step
    injectors, engines = [], []

    def factory():
        clock = VirtualClock() if len(injectors) == 2 else None
        injectors.append(FaultInjector(FaultPlan(), clock=clock))
        eng = make_engine(model, cfg, injector=injectors[-1])
        engines.append(weakref.ref(eng))
        return eng

    def settle(sup, gen):
        """Wait for the driver's thread between steps, collect the dead
        generations, read the card's memory."""
        sup.call(lambda e: None)
        collect_garbage()
        torch.cuda.synchronize()
        live = [r() for r in engines if r() is not None]
        if len(live) != 1 or sup.generation != gen:
            raise AssertionError(f"(i) generation {sup.generation} settled "
                                 f"with {len(live)} engines alive")
        eng = live[0]
        return dict(generation=gen, allocated=torch.cuda.memory_allocated(),
                    reserved=torch.cuda.memory_reserved(),
                    margin=settled_bytes(eng),
                    state=eng.memory_stats()["decode_state_bytes"],
                    captures=list(eng.smoke["captures"]),
                    capture_s=eng.graph_stats()["capture_s"],
                    graphs=len(eng._loop_cache) + len(eng._prefill_cache))

    reset_launch_counts()
    sup = EngineSupervisor(factory, restart_backoff_s=0.0, max_restarts=9,
                           blacklist_after=9, watchdog_step_timeout_s=5.0)
    sup.start()
    srv = None
    rounds, mem = [], []
    try:
        srv = ThreadedHttpServer(sup).start()
        base = f"http://{srv.host}:{srv.port}"
        for gen in range(3):
            plan = injectors[gen].plan
            poison = None
            if gen == 1:    # blamed on one request, resident from the start
                n_dec = sup.call(lambda e: e._dispatch_counts["decode"])
                poison = sup.submit(poison_prompt,
                                    SamplingParams(max_new_tokens=MAX_NEW))
                plan.engine_crash("decode", n_dec + 1, uid=poison.uid)
            fleet = {}
            clients = threading.Thread(target=lambda: fleet.update(zip(
                ("got", "wall"), post_fleet(base, mp["prompts"]))))
            clients.start()
            if gen != 1:
                # armed between two steps once half the fleet decodes, so
                # that several requests are suspects: generation 0 crashes
                # at the next decode dispatch, generation 2 hangs the next
                # step (on its virtual clock) until the watchdog fires
                def arm(e):
                    if sum(map(e._decoding, range(len(e.slots)))) < 4:
                        return False
                    if gen == 0:
                        plan.engine_crash("decode",
                                          e._dispatch_counts["decode"])
                    else:
                        plan.stall_step(at_step=e.engine_steps + 1,
                                        hang_s=60.0)
                    return True

                t0 = time.perf_counter()
                while not sup.call(arm):
                    if time.perf_counter() - t0 > HTTP_CLIENT_TIMEOUT:
                        raise AssertionError("(i) half the fleet never "
                                             "decoded at once")
            clients.join(timeout=HTTP_CLIENT_TIMEOUT + 120)
            if clients.is_alive() or "got" not in fleet:
                raise AssertionError(f"(i) round {gen + 1}: the clients "
                                     f"never finished")
            got, wall = fleet["got"], fleet["wall"]
            if gen == 2:  # the wedged thread wakes, launches nothing, exits
                injectors[2].release_stalls()
                for th in threading.enumerate():
                    if th.name == "engine-driver-gen2":
                        th.join(timeout=60)
                        if th.is_alive():
                            raise AssertionError("(i) the released thread "
                                                 "of generation 2 hangs")
            same_streams(got, want, f"(i) round {gen + 1}")
            rounds.append(dict(wall=wall, tokens=sum(len(g["tokens"])
                                                     for g in got)))
            if poison is not None:
                res = poison.result(timeout=HTTP_CLIENT_TIMEOUT)
                n_err = [r.uid for r in sup.results()].count(poison.uid)
                if res.finish_reason != "error" or n_err != 1 \
                        or "blacklisted" not in res.error:
                    raise AssertionError(
                        f"(i) the poison request ended {res.finish_reason} "
                        f"({n_err} records): {res.error}")
            if len(sup.recoveries) != gen + 1:
                raise AssertionError(f"(i) round {gen + 1}: "
                                     f"{len(sup.recoveries)} recoveries")
            mem.append(settle(sup, gen + 1))
        counts = launch_counts()
    finally:
        for inj in injectors:
            inj.release_stalls()
        if srv is not None:
            srv.stop()
        sup.close()
    excs = [r["exc"].split(":")[0] for r in sup.recoveries]
    if excs != ["EngineCrash", "EngineCrash", "StepTimeout"] \
            or len(sup.recoveries[0]["suspects"]) < 2 \
            or len(sup.recoveries[1]["suspects"]) != 1:
        raise AssertionError(f"(i) recoveries {sup.recoveries}")
    if mem[2]["allocated"] - mem[0]["allocated"] > mem[2]["margin"]:
        raise AssertionError(f"(i) device memory grew across generations: "
                             f"{mem}")
    # the supervisor's clock is rtclock.MONOTONIC, time.perf_counter
    recs = [dict(generation=r["generation"], suspects=len(r["suspects"]),
                 replayed=r["replayed"], exc=r["exc"].split(":")[0],
                 duration_s=r["duration_s"],
                 first_token_s=r["t_first_replayed_token"] - r["t_detect"],
                 first_captures=[c for t, c in m["captures"]
                                 if t <= r["t_first_replayed_token"]],
                 capture_s=m["capture_s"], graphs=m["graphs"])
            for r, m in zip(sup.recoveries, mem)]
    return dict(recoveries=recs, memory=mem, rounds=rounds, counts=counts,
                blacklist=sorted(sup.blacklist), restarts=sup.restarts)


def log_http(gpu, hp, mp):
    """(h)'s lines: each run through HTTP beside phase 4 in process."""
    med = lambda xs: xs[len(xs) // 2]  # noqa: E731
    for r in hp["runs"]:
        log(f"{gpu} | (h) HTTP, {r['run']} run: phase 4's tokens in every "
            f"stream; {r['tokens']} tokens in {r['wall']:.3f}s = "
            f"{r['tokens'] / r['wall']:.1f} tok/s through HTTP; decode"
            f"{' (its captures included)' if r['run'] == 'capture' else ''} "
            f"{r['decode_tok'] / r['decode_s']:.1f} tok/s, "
            f"{1e3 * r['decode_s'] / r['steps']:.3f} ms and "
            f"{r['decode_tok'] / r['steps']:.2f} rows a decode step (phase 4 "
            f"in process: {mp['decode_tok'] / mp['decode_s']:.1f} tok/s, "
            f"{1e3 * mp['decode_s'] / mp['steps']:.3f} ms, "
            f"{mp['decode_tok'] / mp['steps']:.2f} rows); TTFT "
            f"median {med(r['ttft']):.3f}s max {r['ttft'][-1]:.3f}s (phase "
            f"4: {med(mp['ttft']):.3f}s, {mp['ttft'][-1]:.3f}s), SSE client "
            f"TTFT median {med(r['client_ttft']):.3f}s max "
            f"{r['client_ttft'][-1]:.3f}s; {r['graphs'][0]} graphs "
            f"({r['graphs'][1]:.2f}s of capture so far); /healthz and "
            f"/metrics answered {r['polled']} during the run")


def log_recovery(gpu, rp):
    """(i)'s lines: each recovery's seconds, each generation's bytes."""
    for r in rp["recoveries"]:
        log(f"{gpu} | (i) recovery to generation {r['generation']} "
            f"({r['exc']}, {r['suspects']} suspects, {r['replayed']} "
            f"replayed): duration_s {r['duration_s']:.4f}, first replayed "
            f"token after {r['first_token_s']:.3f}s, of which the new "
            f"generation's first captures {sum(r['first_captures']):.3f}s "
            f"({len(r['first_captures'])} graphs; {r['graphs']} graphs, "
            f"{r['capture_s']:.3f}s in its round)")
    for m in rp["memory"]:
        log(f"{gpu} | (i) generation {m['generation']} settled: "
            f"memory_allocated {m['allocated']} bytes, memory_reserved "
            f"{m['reserved']} bytes; the generation's own: decode state "
            f"(KV ring, positions) {m['state']} bytes, graph tensors and "
            f"attention scratch {m['margin']} bytes (the margin)")
    grew = rp["memory"][2]["allocated"] - rp["memory"][0]["allocated"]
    log(f"(i) survivors gave phase 4's tokens in all {len(rp['rounds'])} "
        f"rounds, every SSE index once; the poison request retired 'error' "
        f"once (blacklist {rp['blacklist']}); {rp['restarts']} restarts; "
        f"generation 3 holds {grew} bytes more than generation 1 (margin "
        f"{rp['memory'][2]['margin']})")


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


def time_paged_attention(cfg, dev, fill):
    """Kernel, plain and SDPA times of the 28 paged attention reads of one
    decode step (L = 1), over 28 distinct bf16 pools of 16-slot pages
    under shuffled tables (one per layer, as on the paged path); SDPA runs
    with a boolean mask on each gathered ring."""
    import numpy as np
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    layers, sdpa_args = [], []
    for _ in range(cfg.n_layers):
        a = attention_inputs(SLOTS, 1, CAPACITY, kv, g, hd, "bfloat16", fill,
                             gen, dev)
        a[9].fill_(1)
        paged, gathered = paged_operands(a, PAGE, rng)
        layers.append(paged)
        sdpa_args.append(_sdpa_operands(gathered, CAPACITY))
    # bytes this run's data needs: the visible slots' k and v in the pool,
    # every logical slot's position, the table, q, the chunk, the output
    a = layers[0]
    pos_ring = ref.gather_pages(a[7], a[8])
    visible = int(ref.history_mask(pos_ring, a[9], CAPACITY).any(1).sum())
    per_layer = (visible * kv * hd * 2 * 2 + pos_ring.numel() * 4
                 + a[8].numel() * 4
                 + (a[0].numel() + a[1].numel() + a[2].numel()) * 2
                 + a[0].numel() * 4)
    flops = 4 * SLOTS * kv * g * (visible // SLOTS + 1) * hd
    bound, by = bound_ms(per_layer * cfg.n_layers, flops * cfg.n_layers)
    return dict(
        ms=device_ms(lambda: [ops.chunk_attention_paged_cuda(*p)
                              for p in layers], 10),
        plain_ms=device_ms(lambda: [ref.chunk_attention_paged_stream(*p)
                                    for p in layers], 5),
        library_ms=device_ms(lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True)
            for q, k, v, m in sdpa_args], 10),
        bound_ms=bound, bound_by=by, bytes=per_layer * cfg.n_layers)


def time_decode_attention(cfg, dev, layers):
    """Kernel, plain and SDPA times of B5 over the 28 int8 rings of the
    decode-attention path; SDPA runs on rings dequantized beforehand (the
    dequantization is not timed) with a boolean mask."""
    import torch

    from repro_torch.kernels.decode_attention import ops, ref

    kv, hd = cfg.n_kv_heads, cfg.head_dim
    sdpa_args = []
    nbytes = flops = 0
    slot_bytes = kv * (hd + 4)  # one slot's int8 rows and f32 scales
    for q, k8, ks, v8, vs, pos_buf, pos in layers:
        k = (k8.float() * ks[..., None]).to(torch.bfloat16).transpose(1, 2)
        v = (v8.float() * vs[..., None]).to(torch.bfloat16).transpose(1, 2)
        vis = ref.visible(pos_buf, pos, None)
        sdpa_args.append((q.reshape(SLOTS, -1, 1, hd), k, v,
                          vis[:, None, None, :]))
        # what this run's data needs: k and v of the visible slots, v of
        # every slot of a row that sees nothing (its output is the mean of
        # v), every position, q, pos and the f32 output; a masked slot adds
        # exactly 0 to a row that sees something
        n_vis = int(vis.sum())
        blind = int((~vis.any(1)).sum())
        nbytes += ((2 * n_vis + blind * CAPACITY) * slot_bytes
                   + pos_buf.numel() * 4 + q.numel() * (2 + 4)
                   + pos.numel() * 4)
        flops += 2 * cfg.n_heads * hd * (2 * n_vis + blind * CAPACITY)
    bound, by = bound_ms(nbytes, flops)
    return dict(
        ms=device_ms(lambda: [ops.decode_attention_cuda(*a)
                              for a in layers], 10),
        plain_ms=device_ms(lambda: [ref.decode_attention_plain(*a)
                                    for a in layers], 5),
        library_ms=device_ms(lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True)
            for q, k, v, m in sdpa_args], 10),
        bound_ms=bound, bound_by=by, bytes=nbytes)


def time_trit_search(cfg, dev):
    """Kernel and plain times of one trit step over the lm_head
    (151936x1536 as group-rows of 128). No single PyTorch call computes
    the 9-candidate argmin with its tie rule, so there is no library
    time."""
    import torch

    from repro_torch.kernels.ptqtp_search import ops, ref

    w, alpha = search_inputs(cfg, dev, cfg.vocab_size, 8)
    t1, t2 = torch.empty_like(w), torch.empty_like(w)
    nbytes = w.numel() * (4 + 4 + 4) + alpha.numel() * 4
    bound, by = bound_ms(nbytes, 45 * w.numel(), F32_FLOPS)
    out = dict(ms=device_ms(lambda: ops.ptqtp_search_cuda(w, alpha,
                                                          (t1, t2)), 5),
               plain_ms=device_ms(lambda: ref.ptqtp_search_plain(
                   w, alpha, t1, t2), 2),
               library_ms=None, bound_ms=bound, bound_by=by, bytes=nbytes)
    del w, alpha, t1, t2
    torch.cuda.empty_cache()
    return out


def time_sampling(cfg, dev):
    """Device and host milliseconds of one decode step's sampling call for
    8 rows over the vocabulary: greedy only (the draw skipped), and with
    the threefry draw (rows at temperature 0.8)."""
    import torch

    from repro_torch.serving.sampling import sample_tokens_per_request

    logits = torch.randn((SLOTS, cfg.vocab_size), device=dev)
    seeds = torch.arange(SLOTS, dtype=torch.int64, device=dev)
    idx = torch.zeros((SLOTS,), dtype=torch.int32, device=dev)
    out = {}
    for name, t, draw in (("greedy", 0.0, False), ("threefry", 0.8, True)):
        temps = torch.full((SLOTS,), t, device=dev)

        def call():
            return sample_tokens_per_request(logits, seeds, idx, temps,
                                             draw=draw)

        dev_ms = device_ms(call, 10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        out[name] = dict(device_ms=dev_ms,
                         host_ms=(time.perf_counter() - t0) * 1e3 / 10)
    return out


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
    paged_err = check_paged_attention(cfg, dev)
    decode_err = check_decode_attention(cfg, dev)
    search_err = check_trit_search(cfg, dev)

    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), "the quantize path")
    tot = report["__total__"]
    log(f"{gpu} | quantize {quant_s:.2f}s, the trit step on B6 "
        f"({qcounts['ptqtp_search']} launches; {tot['n_quantized']} kernels, "
        f"{tot['compression']:.2f}x)")

    mp = main_path(cfg, dev, model)
    counts = mp["counts"]
    need(counts, RING_PATH, "the ring serving path")
    decode_steps = mp["engine"].steps
    log(f"{gpu} | served {len(mp['results'])} requests "
        f"({sum(len(p) for p in mp['prompts'])} prompt tokens) in "
        f"{mp['wall']:.2f}s; TTFT median {mp['ttft'][len(mp['ttft']) // 2]:.3f}s "
        f"max {mp['ttft'][-1]:.3f}s; decode {mp['decode_tok']} tokens in "
        f"{mp['decode_s']:.3f}s = {mp['decode_tok'] / mp['decode_s']:.1f} tok/s "
        f"({decode_steps} decode steps, {mp['engine'].prefill_steps} prefill "
        f"dispatches)")
    log(f"{gpu} | launches on the ring path: {counts}; per decode step of "
        f"its decode loops: {mp['per_step']}")
    log(f"{gpu} | warmup() captured {mp['compiled']['n_prefill_compiles']} "
        f"prefill + {mp['compiled']['n_decode_compiles']} decode graphs in "
        f"{mp['warmup_s']:.2f}s ({mp['graphs']['capture_s']:.2f}s of "
        f"capture), graph pool {mp['pool_bytes']} bytes reserved; the fleet "
        f"captured nothing more; host ms per decode step "
        f"{1e3 * mp['decode_s'] / decode_steps:.3f}")
    log("capture seconds (kind, key, s, replays, launches a replay): "
        + "; ".join(f"{d['kind']} {d['key']} {d['capture_s']:.3f} "
                    f"{d['replays']} {d['launches']}"
                    for d in mp["graphs"]["dispatches"]))
    (li, ll), (oi, ol, ob) = mp["solo"]["longest"], mp["solo"]["bucket_1"]
    log(f"solo == fleet tokens for request {li} (longest prompt, {ll} "
        f"tokens) and request {oi} ({ol} tokens: last prefill chunk in "
        f"bucket 1 alone, {ob} in the fleet)")
    mp.pop("engine")
    log(split_line(cfg, mp["per_step"]["chunk_attention"]))

    gc_free()
    pp = paged_path(cfg, dev, model, mp)
    need(pp["counts"], PAGED_PATH, "the paged serving path")
    if pp["counts"]["chunk_attention"]:
        raise AssertionError("the paged path launched the ring kernel")
    med = lambda xs: xs[len(xs) // 2]  # noqa: E731
    log(f"{gpu} | paged (a): the ring path's fleet gives the ring's tokens; "
        f"TTFT median {med(pp['ttft']):.3f}s max {pp['ttft'][-1]:.3f}s; "
        f"decode {pp['decode_tok']} tokens in {pp['decode_s']:.3f}s = "
        f"{pp['decode_tok'] / pp['decode_s']:.1f} tok/s")
    log(f"{gpu} | paged (b): {N_REQUESTS} requests sharing a {SHARED_PREFIX}"
        f"-token prefix ({pp['prompt_tokens']} prompt tokens) give the "
        f"ring's tokens cold and warm; warm: {pp['hits']} prefix pages hit, "
        f"{pp['saved']} of {pp['cold_prefill']} prefill tokens saved; TTFT "
        f"median cold {med(pp['ttft_cold']):.3f}s warm "
        f"{med(pp['ttft_warm']):.3f}s, max cold {pp['ttft_cold'][-1]:.3f}s "
        f"warm {pp['ttft_warm'][-1]:.3f}s")
    log(f"{gpu} | paged (c): a {WRAP_PROMPT}-token request with the prefix "
        f"wraps the {CAPACITY}-token ring with the ring's tokens, forking "
        f"{pp['forks']} pages; the prefix afterwards gives its cold tokens; "
        f"(d) pool of {pp['pages']} pages, peak {pp['peak']} in use, back to "
        f"the prefix cache's pages after the drain")
    log(f"{gpu} | launches on the paged path: {pp['counts']}; per decode "
        f"step of (a)'s decode loops: {pp['per_step']}")

    gc_free()
    ar = artifact_path(cfg, dev, model, mp)
    for layout, path in (("ring", RING_PATH), ("paged", PAGED_PATH)):
        need(ar["runs"][layout][0], path, f"the {layout} fleet from the "
             f"artifact")
    b = ar["boot"]
    log(f"{gpu} | (e) artifact: {ar['nbytes']} bytes in {ar['tensors']} "
        f"tensors ({ar['stats']['bytes_per_weight']:.4f} B/weight); write "
        f"{ar['write_s']:.3f}s, fsync and publish {ar['fsync_s']:.3f}s; boot "
        f"{ar['boot_s']:.3f}s = manifest {b['manifest_read']:.4f}s, sizes "
        f"{b['shard_size_check']:.4f}s, mmap {b['mmap']:.4f}s, verify (crc32) "
        f"{b['checksum']:.3f}s, assemble {b['tensor_assemble']:.4f}s, copy to "
        f"the device {b['device_copy']:.3f}s, model build "
        f"{b['model_build']:.3f}s")
    log(f"(e) every tensor byte-identical after the round trip; the ring and "
        f"paged fleets from the artifact give the ring phase's tokens; a torn "
        f"shard ({ar['cut']['shard']}, -7 bytes) fails verify='sizes', a "
        f"flipped byte in {ar['flip']['tensor']}:{ar['flip']['buffer']} "
        f"passes it and fails verify='full'")
    gc_free()
    fx = fixture_path(dev)
    need(fx["counts"], ("ternary_matvec", "chunk_attention",
                        "chunk_attention_paged", "rms_norm"),
         "the JAX package's artifact")
    log(f"(f) the JAX package's artifact: {fx['n']} requests, "
        f"{fx['tokens']} tokens equal to the JAX engine's on the ring and "
        f"paged layouts, and the bucket-1 request alone; launches "
        f"{fx['counts']}")
    gc_free()
    cp = containment_path(cfg, dev, model, mp, pp)
    prod = ar["runs"]["ring"][1] + ar["runs"]["paged"][1]
    prod = prod + mp["syncs"]
    syncs = dict(prod)
    for rebuilt, n in prod + cp["ring_syncs"] + cp["paged_syncs"]:
        if syncs.setdefault(rebuilt, n) != n:
            raise AssertionError(
                f"host syncs per decode dispatch differ: production {prod}, "
                f"with the NaN plan ring {cp['ring_syncs']} paged "
                f"{cp['paged_syncs']} ((fleet arrays rebuilt, syncs) each)")
    if syncs != {False: 1, True: 1}:
        raise AssertionError(f"host syncs per replayed decode dispatch "
                             f"(fleet arrays rebuilt: syncs) {syncs}, not 1")
    log(f"(g) containment at full width: both victims retired 'error' with "
        f"the clean tokens so far, every other stream unchanged, both slots "
        f"quarantined 2 steps and restored, on the ring and paged layouts; "
        f"the paged prefill victim's {cp['own']} own prompt pages never "
        f"entered the prefix cache ({cp['cached']} cached); host syncs per "
        f"decode dispatch {syncs.get(False)} ({syncs.get(True)} after the "
        f"fleet changed) with and without the injector ({len(prod)}, "
        f"{len(cp['ring_syncs']) + len(cp['paged_syncs'])} dispatches)")

    gc_free()
    gp = graphs_path(cfg, dev, model, mp, pp)
    for (layout, mode), runs in gp.items():
        g, e = runs[True], runs[False]
        log(f"{gpu} | graph vs eager, {layout} {mode}: equal streams; decode "
            f"{g['decode_tok'] / g['decode_s']:.1f} vs "
            f"{e['decode_tok'] / e['decode_s']:.1f} tok/s, "
            f"{1e3 * g['decode_s'] / g['steps']:.3f} vs "
            f"{1e3 * e['decode_s'] / e['steps']:.3f} ms a decode step; TTFT "
            f"median {med(g['ttft']):.3f} vs {med(e['ttft']):.3f}s, max "
            f"{g['ttft'][-1]:.3f} vs {e['ttft'][-1]:.3f}s")
    gc_free()
    tp = traced_path(cfg, dev, model, mp)
    log(f"{gpu} | traced vs untraced: equal streams; decode tok/s traced "
        f"{tp['rates'][True][0]:.1f}, untraced {tp['rates'][False][0]:.1f} "
        f"(phase 4: {mp['decode_tok'] / mp['decode_s']:.1f}); "
        f"{tp['events']} trace events; health: {tp['health']}")
    gc_free()
    sp = serial_path(cfg, dev, model, mp)
    log(f"{gpu} | SerialAdmitEngine: the bucketed engine's streams; "
        f"{sp['stats']['n_prefill_compiles']} prefill graphs (one per prompt "
        f"length, {sp['capture_s']:.2f}s of capture in all); fleet "
        f"{sp['wall']:.2f}s, TTFT median {med(sp['ttft']):.3f}s max "
        f"{sp['ttft'][-1]:.3f}s; decode {sp['decode_tok'] / sp['decode_s']:.1f}"
        f" tok/s")
    gc_free()
    dp = dense_path(cfg, dev, mp)
    from repro_torch.models.common import DENSE_ROW_BLOCK
    log(f"{gpu} | C.2 dense bf16 (F.linear in {DENSE_ROW_BLOCK}-row blocks): "
        f"requests {dp['longest']} (longest) and {dp['one']} (bucket 1 "
        f"alone) give their fleet tokens alone; fleet decode "
        f"{dp['decode_tok'] / dp['decode_s']:.1f} tok/s, TTFT median "
        f"{med(dp['ttft']):.3f}s; elements of rows 0-7 that one F.linear "
        f"gives other bits alone than in a 512-row call, by layer: "
        f"{dp['plain_diff']} (the row blocks: none)")

    gc_free()
    t0 = time.perf_counter()
    hp = http_path(cfg, dev, model, mp)
    need(hp["counts"], RING_PATH, "the HTTP path")
    log_http(gpu, hp, mp)
    log(f"(h) launches on the HTTP path: {hp['counts']}; "
        f"{time.perf_counter() - t0:.1f}s")
    gc_free()
    t0 = time.perf_counter()
    rp = recovery_path(cfg, dev, model, mp)
    need(rp["counts"], RING_PATH, "the supervised path")
    log_recovery(gpu, rp)
    log(f"(i) launches on the supervised path: {rp['counts']}; "
        f"{time.perf_counter() - t0:.1f}s")

    gc_free()
    dcounts, dlayers = decode_attention_path(cfg, dev)
    need(dcounts, ("decode_attention",), "the decode-attention op")

    fill = [len(p) + MAX_NEW // 2 for p in mp["prompts"]]
    tern = time_ternary(model, cfg, dev)
    norm = time_rms_norm(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    attn = time_attention(cfg, dev, fill)
    pattn = time_paged_attention(cfg, dev, fill)
    dattn = time_decode_attention(cfg, dev, dlayers)
    del dlayers
    search = time_trit_search(cfg, dev)
    draw = time_sampling(cfg, dev)
    for name, t in list(tern.items()) + [("chunk_attention/" + k, v)
                                         for k, v in attn.items()] + [
            ("rms_norm", norm), ("chunk_attention_paged", pattn),
            ("decode_attention", dattn), ("ptqtp_search", search)]:
        lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        log(f"{gpu} | {name}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib_ms} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound")
        if "us_per_call" in t:
            log(f"{gpu} | {name} device us per call, by n x d (m = {t['m']}): "
                + ", ".join(f"{k} {v:.1f}" for k, v in t["us_per_call"].items()))
    log(f"{gpu} | sampling per decode step (8 rows x {cfg.vocab_size}): "
        + "; ".join(f"{k} device {v['device_ms']:.3f} ms, host "
                    f"{v['host_ms']:.3f} ms" for k, v in draw.items()))

    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="ternary_matvec", route="cuda",
             source="src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
             replaces="src/repro/kernels/ternary_matmul/kernel.py:175",
             launches=counts["ternary_matvec"],
             launches_per_decode_step=mp["per_step"]["ternary_matvec"],
             max_abs_err=mm_err,
             work="all 197 linear layers of one decode step, m=8, bf16 x "
                  "on the tensor cores (mma.sync)",
             **{k: tern["ternary_matvec"][k] for k in timed}),
        dict(name="ternary_matmul", route="cuda",
             source="src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu",
             replaces="src/repro/kernels/ternary_matmul/kernel.py:91",
             launches=counts["ternary_matmul"],
             launches_per_decode_step=mp["per_step"]["ternary_matmul"],
             max_abs_err=mm_err,
             work="the 196 block linear layers of one prefill dispatch, "
                  "m=512, bf16 x on the tensor cores (mma.sync)",
             **{k: tern["ternary_matmul"][k] for k in timed}),
        dict(name="chunk_attention", route="cuda",
             source="src/repro_torch/kernels/chunk_attention/csrc/chunk_attention.cu",
             replaces="src/repro/kernels/chunk_attention/kernel.py:197",
             launches=counts["chunk_attention"],
             launches_per_decode_step=mp["per_step"]["chunk_attention"],
             max_abs_err=attn_err,
             work="28 attention reads of one decode step, L=1, bf16 ring",
             **{k: attn["decode"][k] for k in timed}),
        dict(name="rms_norm", route="cuda",
             source="src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
             replaces="src/repro/models/common.py:78",
             launches=counts["rms_norm"],
             launches_per_decode_step=mp["per_step"]["rms_norm"],
             max_abs_err=norm_err,
             work=f"{norm['calls']} norms of one decode step, 8 rows "
                  "of d=1536, bf16; "
                  "replaces an XLA-fused function, not a Pallas kernel",
             **{k: norm[k] for k in timed}),
        dict(name="chunk_attention_paged", route="cuda",
             source="src/repro_torch/kernels/chunk_attention/csrc/chunk_attention.cu",
             replaces="src/repro/kernels/chunk_attention/kernel.py:149",
             launches=pp["counts"]["chunk_attention_paged"],
             launches_per_decode_step=pp["per_step"]["chunk_attention_paged"],
             max_abs_err=paged_err,
             work="28 paged attention reads of one decode step, L=1, bf16 "
                  "pool of 16-slot pages; launches are the paged path's; "
                  "library: SDPA with a boolean mask on the gathered ring",
             **{k: pattn[k] for k in timed}),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/chunk_attention/csrc/chunk_attention.cu",
             replaces="src/repro/kernels/decode_attention/kernel.py:63",
             launches=dcounts["decode_attention"],
             launches_per_decode_step=mp["per_step"]["decode_attention"],
             max_abs_err=decode_err,
             work="28 reads of (8, 1024, 2, 6, 128) int8 rings through its "
                  "op (no serving path uses it, as in the reference); "
                  "library: SDPA on the rings dequantized beforehand",
             **{k: dattn[k] for k in timed}),
        dict(name="ptqtp_search", route="cuda",
             source="src/repro_torch/kernels/ptqtp_search/csrc/ptqtp_search.cu",
             replaces="src/repro/kernels/ptqtp_search/kernel.py:53",
             launches=qcounts["ptqtp_search"],
             launches_per_decode_step=mp["per_step"]["ptqtp_search"],
             max_abs_err=search_err,
             work="one trit step over the 151936x1536 lm_head as 128-wide "
                  "group-rows; launches are the quantize path's; no single "
                  "PyTorch call computes the 9-candidate argmin with its "
                  "first-wins tie rule, so library_ms is null",
             **{k: search[k] for k in timed}),
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
