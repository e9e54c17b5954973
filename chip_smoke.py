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

Since slice 9 (the sliding-window and mixture-of-experts decoders), after
the phases above:

 18. (j) gemma3-27b at full width (d 5376, 32/16 heads, hd 168, d_ff
     21504, GeGLU, vocab 262144, window 1024, bf16), cut to 8 layers (one
     period of 5 local + 1 global and the 2-local rest), random weights
     from a seeded generator quantized on the card (G = 128, t_max = 20;
     B6): 8 greedy requests of 64-1800 prompt tokens (two past the
     1024-slot local rings, which wrap; the global ring holds 4096), 32
     new tokens each, through CUDA graphs; every request finishes, the
     longest and the bucket-1 request alone give their fleet tokens, graph
     == eager, a paged engine raises the reference's ValueError, and B2 at
     hd 168 matches its plain version alone and in the batch of 8;
 19. (k) deepseek-moe-16b at full width and depth (28 layers: a dense
     layer 0 of d_ff 10944, then 64 routed experts top-6 of d 1408 and 2
     shared, capacity factor 1.25, vocab 102400), quantized on the card:
     the phase-4 fleet on the ring and the paged layout (graph == eager);
     the expert-axis launch equal to one launch per expert bit for bit
     and to the plain version; a row's router probabilities alone, in 8
     and in 512 rows bit for bit; then the no-drop copy (capacity factor
     -1, the same weights): ring == paged, solo == fleet, and warm == cold
     for the shared-prefix fleet on the paged layout. With the published
     factor a request's tokens may depend on its fleet and on the layout
     (capacity is per dispatch, idle rows included, and an idle row reads
     its stale ring but null pages, as in the reference): reported, not
     gated;
 20. (l) the JAX package's smoke gemma3-27b and deepseek-moe-16b artifacts
     (``tests/torch_fixtures/``, f32: the FMA kernels) with the JAX
     engine's committed greedy streams, on the ring (both) and the paged
     layout (deepseek), and the bucket-1 request alone;
 21. the times of the new routes (the expert-axis B1 at cap 1 and 60, B3
     at cap 3072, one MoE layer's three stacks; B2 at hd 168 for a gemma3
     decode step and prefill dispatch) and of B1/B3 at both models' dense
     layers, beside their plain versions, one PyTorch call (``torch.bmm``
     on dequantized stacks, ``F.linear``, SDPA) and their bounds.

Since slice 10 (the recurrent decoders), after the phases above:

 22. (p) the recurrences' hand kernels against their plain versions at the
     paths' shapes: ``rglru_scan`` (8 rows of width 2560; since slice 12
     the fused gate-and-scan, item 30) and ``wkv6`` (8
     rows of 40 heads of 64, bf16 and f32) at decode (S = 1) and prefill
     (S = 64) shapes with ragged and idle rows: the states bit for bit, the
     wkv6 readout within its tolerance; a row alone equals its row in the
     batch of 8, and a 64-step chunk equals 64 one-step calls, bit for bit;
 23. (m) recurrentgemma-2b at full width and depth (26 layers, 2 RG-LRU
     (width 2560 in 10 blocks) : 1 local attention (10/1 heads, hd 256,
     window 2048), d 2560, d_ff 7680 GeGLU, vocab 256000), quantized on
     the card: 8 greedy requests of 64-3000 prompt tokens (two past the
     2048-slot local rings, which wrap) at capacity 4096, 32 new tokens
     each, through CUDA graphs: every request finishes, solo == fleet
     (longest, bucket 1), graph == eager, ``SerialAdmitEngine`` ==
     bucketed (two requests), a paged engine at 4096 raises the
     reference's ValueError, and at capacity 2048 (prompts cut to 1900)
     ring == paged with B4 launched and prefix reuse off; B2 at hd 256 and
     G 10 against its plain version, rows alone and in the batch;
 24. (n) rwkv6-3b at full width and depth (32 layers, d 2560, 40 heads of
     64, d_ff 8960, vocab 65536), quantized on the card: phase 4's fleet
     with its last prompt a 4000-token one, at capacity 4096, on the ring
     and the paged layout: ring == paged, solo == fleet, graph == eager,
     serial == bucketed, the decode state's bytes equal at capacity 1024
     and 4096 (O(1)), and the shared-prefix fleet with prefix reuse off and
     no prefill token saved; no attention kernel launches;
 25. (o) the JAX package's smoke recurrentgemma-2b and rwkv6-3b artifacts
     (f32: the FMA kernels) with the JAX engine's committed greedy streams
     on the ring (both) and the paged layout (rwkv6), and the bucket-1
     request alone;
 26. the times of B1/B3 at both models' layers, B2 at hd 256 (L = 1 and
     64) and B4 at hd 256, and of ``rglru_scan`` and ``wkv6`` (a decode
     step's and a prefill dispatch's layers) beside their plain versions,
     one PyTorch call where one computes the same function, and their
     bounds.

Since slice 11 (the norm fused with the residual add, ``wkv6`` staged in
shared memory), within the phases above:

 27. ``add_rms_norm`` at qwen2-1.5b's, gemma3-27b's, recurrentgemma-2b's
     and rwkv6-3b's widths and at 16384 (the route wider than a lane's
     registers), bf16 and f32: x + delta equal to PyTorch's add and h
     equal to the norm kernel's ``rms_norm`` of it, bit for bit, h within
     the norm's tolerance of the plain version, and a row the same bits
     alone, in an (8, 1, d) call and in an (8, 64, d) call; every serving
     path must launch it (each norm after a residual add is one launch);
 28. ``wkv6`` also at S = 200 (six 32-step tiles and a ragged seventh)
     with the ragged and idle rows: the state bit for bit, a row alone ==
     its row in the batch, a chunk == 200 one-step calls;
 29. the times of the 56 fused norms and the one plain norm of a qwen2
     decode step beside PyTorch's ``x + y`` then ``F.rms_norm`` and
     ``F.rms_norm`` alone, the step's norms as before the fusion (56 adds
     and 57 norms), ``wkv6`` at S = 1, 64 and 200, and qwen2's graph
     decode step as ``launch/profile_decode.py`` profiles it (launches
     and device-busy ms a step).

Since slice 12 (the RG-LRU's gate-and-scan in one launch, the
stub-frontend archs), within and after the phases above:

 30. (p) ``rglru_scan`` is the RG-LRU's whole gate-and-scan (the gates'
     biases and sigmoids, a, its input multiplier, the scan, the GELU and
     the output gate): held against its plain version at 8 rows of 2560
     in 10 blocks, S = 1, 64 and 200, bf16 and f32, output and h bit for
     bit, rows alone == batch and a chunk == steps; timed at S = 1 and 64
     for (m)'s 18 layers beside its plain version; and
     (m)'s graph decode step profiled as ``launch/profile_decode.py
     --arch recurrentgemma-2b`` profiles it (launches, device-busy ms);
 31. (q) musicgen-large at full width and depth (48 layers, d 2048, 32
     heads of 64, d_ff 8192, GELU, vocab 2048) and phi-3-vision-4.2b at
     full width, 8 of 32 layers (d 3072, hd 96, vocab 32064), bf16,
     quantized on the card: 8 rows of 64-600 seeded N(0, 1) frame
     embeddings through ``prefill_chunk`` in chunks of 64 on a ring of
     1024, then 32 ``decode_step`` calls on the next embeddings, eager
     (the engine takes token ids): every kernel of the path launches (B1,
     B3, B2, the norm), the longest and the shortest row alone give the
     batch's logits bit for bit, the last decode step's logits agree with
     one 32-step prefill chunk of the same embeddings (``STUB_TOL``);
     prefill tok/s, decode ms a step and quantize seconds; B2 at hd 64
     and 96 (one query head a kv head) against its plain version; B1 and
     B3 against theirs at every linear layer of both archs; B1, B3 and B2
     timed at both archs' shapes.

Since slice 13 (the engine's last two options, the quantizer's
remainder and the baselines), within the qwen2-1.5b phases:

 32. (r) the engine's options on phase 4's quantized model and fleet, each
     route on one engine through CUDA graphs (the fleet twice: its graphs
     captured at first use, then every dispatch a replay, one host sync
     each, nothing captured and the same tokens), then the longest and the
     bucket-1 request alone on it with their fleet tokens: ``attn_backend``
     ``pallas`` (phase 4's bits; B2 28 launches a decode step), ``stream``
     and ``materialized`` on the ring and ``stream`` on the paged layout
     (B2 and B4 never launched); ``preunpack_decode=True`` (resident planes
     4× the packed bytes, B1 and B3 never launched, the caller's model
     still packed; int8 planes under ``backend="auto"`` on the card
     raise, the served copy names ``grouped``). Decode tok/s, TTFT median and the tokens apart from
     the ``pallas`` fleet, with the first step that differs;
 33. (s) ``quantize_with_history`` (G 128, t_max 20; its trit step on B6)
     and the baselines (PTQTP, RTN at 2, 3 and 4 bits, GPTQ, AWQ at 3 bits,
     BiLLM) on seeded N(0, 0.02) f32 weights of qwen2-1.5b's shapes: one
     layer's q, k, o, gate and down and the lm_head, with a seeded N(0, 1)
     calibration x of 128 rows: the errors never increase, the planes and
     iterations equal ``ptqtp_quantize``'s, the last error equals
     ``ptqtp_error``; every result finite and every code in range; the
     seconds and relative errors, and the reference's ordering tests
     beside them (printed, not gated: random weights).

Since slice 14 (training on the card), after every other phase:

 34. (t) the norm's backward kernels (``rms_norm_bwd``, and
     ``add_rms_norm_bwd`` with the residual stream's gradient) against the
     plain backward written out at every width of ``check_add_rms_norm``
     (1536, 5376, 2560, 16384), bf16 and f32, on 8 x 512 rows (tolerances
     ``NORM_BWD_TOL``), the same bits at a second call; qwen2-1.5b at full
     width and depth (bf16, remat full) trained through ``Trainer`` for 6
     steps of 8 x 512 tokens of the synthetic corpus (AdamW, lr 1e-3): the
     loss falls, every loss finite, the norms' forward and backward
     kernels launched (counts reset just before, read just after); step
     seconds, tokens/s, peak memory, the hand kernels' launches, and one
     more step under the profiler (kernels a step, device busy ms). The
     step's norm backwards timed against their bound, the plain backward
     and ``aten._fused_rms_norm_backward``; the dense layers' 128-row
     blocks (y, dx and dw, dw one f32-accumulated product) held against
     the f32 product at every distinct dense shape (``FIXED_ROWS_TOL``),
     beside one ``F.linear``'s errors, and timed against one ``F.linear``
     (forward and backward). Then a
     2-layer full-width copy (free disk checked first) trained 4 steps
     straight, and again preempted after step 2 (``guard.request()``) and
     resumed from its checkpoint: losses and every state tensor equal bit
     for bit; its last checkpoint through ``launch/quantize.py
     --from-checkpoint`` on the card (B6; FP leaves equal the trained
     model's), and 8 greedy requests served from that artifact (B1, B3,
     B2 launched; two alone with their fleet tokens).

Since slice 15 (training the recurrent archs), after (t):

 35. (u) the recurrences' backward kernels (``rglru_scan_bwd``,
     ``wkv6_bwd``) against their plain backwards written out: the RG-LRU at
     recurrentgemma-2b's 8 x 2560 in 10 blocks, the WKV at rwkv6-3b's 40
     heads of 64 and the smoke config's 4 heads of 16, at S = 64, 200 (a
     ragged tile) and 512, bf16 and f32, ragged and idle rows, a random
     prior state (``RECURRENT_BWD_TOL``); the same bits at a second call,
     the reduced gradients (dba, dbx, dlam; du, dscale) included; the
     forwards that write the backward's tile checkpoints equal those that
     do not, bit for bit. recurrentgemma-2b and rwkv6-3b at full width and
     depth (bf16, remat full, B 8 x S 512 of the synthetic corpus, 4 steps
     through ``Trainer``): every loss finite, the loss falls, the
     recurrences' forward and backward kernels and the norm's launched and
     their plain versions called no time (counts reset just before, read
     just after); step seconds, tokens/s, peak memory, and one profiled
     step's kernels and device-busy ms. The backward kernels timed as a
     training step runs them, against their bound and plain backwards
     (``rglru_scan_bwd`` with its registers, shared bytes and blocks an SM
     since slice 17). deepseek-moe-16b's 2-layer full-width copy trained 2
     steps twice from one seed: losses, every state tensor and every
     gradient of a further batch equal bit for bit. Each arch's copy
     (recurrentgemma-2b's first period of 3 layers, so that it holds an
     attention layer; rwkv6-3b's 2 layers) preempted after step 2 and
     resumed: losses and every state
     tensor equal bit for bit; recurrentgemma-2b's checkpoint through
     ``launch/quantize.py --from-checkpoint`` (B6) and 8 greedy requests
     served from the artifact (B1, B3, B2 launched; two alone with their
     fleet tokens).

Since slice 18 (sharding rules and the dry run):

 36. (v) the one-GPU mesh, after (r): an NCCL process group of one
     (``HashStore``) and ``launch.mesh.make_mesh((1, 1), ("data",
     "model"))`` on the card; phase 3's quantized qwen2-1.5b placed leaf by
     leaf by the port's specs (``sharding.partition.param_specs``) with
     ``distribute_tensor``, every local shard equal to its tensor byte for
     byte; ``constrain`` under the train rules on an (8, 512, 1536) bf16
     hidden ``DTensor``: no collective (``CommDebugMode``) and the same
     bytes; the main fleet served with the decode rules installed, its
     streams equal to phase 4's; the process group destroyed; the dry run
     of qwen2-1.5b ``train_4k`` and quantized ``decode_32k`` on the single
     mesh in subprocesses (the fake backend on the CPU), their seconds.
     One card holds only a 1 x 1 mesh: nothing here is a multi-GPU
     figure. After (u), (t)'s and (u)'s steady step seconds beside
     ``model_flops`` at the H100 bf16 data-sheet peak, as a share (a line
     of its own, no gate).

Each phase's engines and graph pools are freed before the next; the run's
total seconds are printed.

Output: progress lines, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s
# and f32 FLOP/s outside the tensor cores, from the port's roofline module
try:
    from repro_torch.roofline.analysis import (BF16_FLOPS, F32_FLOPS,
                                               HBM_BYTES_PER_S)
except ImportError:  # not a checkout (or no PyTorch): main() says so
    BF16_FLOPS = F32_FLOPS = HBM_BYTES_PER_S = None

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
    """Device milliseconds per call of ``fn``: ``fn`` captured into a CUDA
    graph (after one call on the capture stream, which sizes the attention
    scratch and raises shared-memory limits before the capture), the graph
    replayed once, then ``reps`` times between two CUDA events. A replay
    launches every kernel of the call back to back without the host, so a
    loop of small launches is timed on the device, not in Python (it adds
    the graph's gaps between kernels, ~1 µs each). Summing
    ``torch.profiler``'s kernel times, as these timings once did, undercounts
    late in a long run: the profiler drops kernel events (PERF.md §6)."""
    import gc

    import torch

    from repro_torch.kernels.chunk_attention.ops import release_workspace

    dev = torch.cuda.current_device()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    release_workspace(dev, side.cuda_stream)
    gc.collect()
    torch.cuda.empty_cache()
    return ms


# kernels each serving path must launch
RING_PATH = ("ternary_matvec", "ternary_matmul", "chunk_attention", "rms_norm",
             "add_rms_norm")
PAGED_PATH = ("ternary_matvec", "ternary_matmul", "chunk_attention_paged",
              "rms_norm", "add_rms_norm")


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


# the model widths the fused norm is held at: qwen2-1.5b, gemma3-27b,
# recurrentgemma-2b and rwkv6-3b (2560 both), and llama3-405b's 16384 (the
# two-pass route: wider than a lane's registers hold)
FUSED_NORM_WIDTHS = (1536, 5376, 2560, 16384)


def check_add_rms_norm(dev):
    """``add_rms_norm`` at the models' widths, bf16 and f32, at decode (8
    rows of one token) and prefill (8 x 64) shapes: x_new equal to
    PyTorch's add bit for bit, h equal to the norm kernel's ``rms_norm`` of
    x_new bit for bit and to the plain version within ``NORM_RTOL``, and
    each row of an (8, 1, d) call, and one row alone, bit-identical to its
    row in the (8, 64, d) call. Returns the largest abs err against the
    plain version."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for d in FUSED_NORM_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device=dev)).to(dtype)
            x, y = (torch.randn((SLOTS, PREFILL_CHUNK, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            full_sum, full_h = ops.add_rms_norm(scale, x, y)
            for name, sl in (("decode", slice(0, 1)),
                             ("prefill", slice(None))):
                xs, ys = x[:, sl].contiguous(), y[:, sl].contiguous()
                got_sum, got = ops.add_rms_norm(scale, xs, ys)
                want_sum, want = ref.add_rms_norm_plain(scale, xs, ys)
                torch.cuda.synchronize()
                what = f"add_rms_norm d={d} {name} {dtype}"
                if not torch.equal(got_sum, xs + ys):
                    raise AssertionError(f"{what}: x + delta differs from "
                                         "PyTorch's add")
                if not torch.equal(got, ops.rms_norm(scale, got_sum)):
                    raise AssertionError(f"{what}: h differs from rms_norm "
                                         "of x + delta")
                if not (torch.equal(got_sum, full_sum[:, sl])
                        and torch.equal(got, full_h[:, sl])):
                    raise AssertionError(f"{what}: rows differ from the same "
                                         "rows in (8, 64, d)")
                err = float(((got.float() - want.float()).abs()
                             / want.float().abs().clamp_min(1e-30)).max())
                tol = NORM_RTOL[str(dtype).split(".")[-1]]
                if not err <= tol:
                    raise AssertionError(f"{what}: max relative err "
                                         f"{err:.3e} > {tol}")
                worst = max(worst,
                            float((got.float() - want.float()).abs().max()))
            one_sum, one = ops.add_rms_norm(scale, x[3:4, 7:8].contiguous(),
                                            y[3:4, 7:8].contiguous())
            if not (torch.equal(one_sum, full_sum[3:4, 7:8])
                    and torch.equal(one, full_h[3:4, 7:8])):
                raise AssertionError(f"add_rms_norm d={d} {dtype}: a row "
                                     "alone differs from its row in "
                                     "(8, 64, d)")
    log(f"add_rms_norm at d {FUSED_NORM_WIDTHS}, bf16 and f32: x + delta "
        f"== PyTorch's add and h == rms_norm(x + delta) bit for bit; h == "
        f"plain (max abs err {worst:.2e}; relative tolerances {NORM_RTOL}); "
        "rows of (8, 1, d) calls and a row alone bit-identical to their "
        "rows in (8, 64, d)")
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

    eng = (cls or ServingEngine)(model, cfg, EngineConfig(**{
        **dict(max_slots=SLOTS, capacity=CAPACITY,
               prefill_chunk=PREFILL_CHUNK, decode_chunk=DECODE_CHUNK),
        **ecfg}), injector=injector,
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
    longest, one = solo_gates(model, cfg, prompts, results, "main path")
    fleet_buckets = final_buckets([len(p) for p in prompts])
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
                          bucket_1=(one, len(prompts[one]),
                                    fleet_buckets[one])))


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


#: the layouts each committed JAX-written fixture is served on (gemma3's
#: and recurrentgemma's sliding windows refuse paging at the fixtures'
#: capacity, as in the reference)
FIXTURE_LAYOUTS = {"qwen2": ("ring", "paged"), "gemma3": ("ring",),
                   "deepseek": ("ring", "paged"),
                   "recurrentgemma": ("ring",), "rwkv6": ("ring", "paged")}


def fixture_path(dev, name):
    """(f), (l): the artifact the JAX package wrote for ``name``
    (``tests/torch_fixtures/make_artifact_fixture.py``), served on the
    card through the kernels (f32 activations: the FMA routes) with the
    JAX engine's committed greedy streams on each of its layouts (the
    paged streams are the ring's unless the fixture has its own), and the
    bucket-1 request alone on the ring, the launch counts reset just before
    and read just after. A mismatch fails the run as it is."""
    from repro_torch.artifacts import load_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import has_attention
    from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

    spec = json.loads((FIXTURES / f"{name}_smoke_streams.json").read_text())
    model, cfg, _ = load_model(FIXTURES / f"{name}_smoke_artifact",
                               verify="full", device=dev)
    reqs = [(r["prompt"], r["max_new_tokens"]) for r in spec["requests"]]
    paged = spec.get("paged", {})
    want = {"ring": spec["streams"],
            "paged": paged.get("streams", spec["streams"])}

    def run(rs, layout):
        eng = ServingEngine(model, cfg, EngineConfig(
            **spec["engine"], kv_layout=layout,
            page_size=paged.get("page_size", 8)))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in rs]
        eng.run()
        return [h.output for h in hs]

    reset_launch_counts()
    got = {layout: run(reqs, layout) for layout in FIXTURE_LAYOUTS[name]}
    solo = run([reqs[spec["solo"]["index"]]], "ring")[0]
    counts = launch_counts()
    for layout, streams in got.items():
        if streams != want[layout]:
            raise AssertionError(f"{name} {layout}: the port served "
                                 f"{streams}, the JAX engine {want[layout]}")
    if solo != spec["solo"]["tokens"]:
        raise AssertionError(f"{name}: the bucket-1 request alone {solo}, "
                             f"the JAX engine {spec['solo']['tokens']}")
    kinds = set(cfg.layer_kinds)
    attention = has_attention(cfg)
    kernels = ["ternary_matvec", "rms_norm", "add_rms_norm"]
    if attention:
        kernels.append("chunk_attention")
    if attention and "paged" in got:
        kernels.append("chunk_attention_paged")
    if cfg.moe is not None:
        kernels.append("ternary_matvec_experts")
    if "rwkv" in kinds:
        kernels.append("wkv6")
    if any(k.startswith("rglru") for k in kinds):
        kernels.append("rglru_scan")
    need(counts, kernels, f"the JAX package's {name} artifact")
    return dict(counts=counts, layouts=list(got), n=len(reqs),
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


# ------------------------------------------------ phases (r)-(s): slice 13
def first_apart(got, want):
    """The first decode step at which any request's tokens differ, or
    None."""
    steps = [next((i for i, (a, b) in enumerate(zip(g.tokens, w.tokens))
                   if a != b), None) for g, w in zip(got, want)]
    steps = [i for i in steps if i is not None]
    return min(steps) if steps else None


def option_run(model, cfg, prompts, what, **ecfg):
    """One engine option on one engine: the fleet twice (the first pass
    captures its graphs at first use, the second replays only: one host
    sync a decode dispatch, nothing captured, the same tokens; launch
    counts reset just before it and read just after), then the longest and
    the bucket-1 request alone with their fleet tokens."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    eng = make_engine(model, cfg, **ecfg)
    cold = serve_on(eng, prompts)
    finished(cold, what)
    compiled = eng.compile_stats()
    eng.smoke["decode_s"], eng.smoke["in_decode"] = 0.0, dict.fromkeys(
        launch_counts(), 0)
    steps0, tok0 = eng.steps, eng.tokens_generated
    syncs = count_syncs(eng)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve_on(eng, prompts)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    same_tokens(results, cold, f"{what}: the second pass")
    for k in ("n_prefill_compiles", "n_decode_compiles"):
        if eng.compile_stats()[k] != compiled[k]:
            raise AssertionError(f"{what}: the second pass captured more")
    if not syncs or any(n != 1 for _, n in syncs):
        raise AssertionError(f"{what}: host syncs per replayed decode "
                             f"dispatch {syncs}, not 1")
    steps = eng.steps - steps0
    out = dict(results=results, counts=counts, wall=wall,
               ttft=sorted(r.ttft for r in results),
               decode_tok=eng.tokens_generated - tok0 - len(prompts),
               decode_s=eng.smoke["decode_s"], steps=steps,
               per_step={k: n / max(steps, 1)
                         for k, n in eng.smoke["in_decode"].items()},
               memory=eng.memory_stats(), dispatches=len(syncs))
    fleet_buckets = final_buckets([len(p) for p in prompts])
    one = next(i for i in range(len(prompts))
               if final_buckets([len(prompts[i])])[0] == 1
               < fleet_buckets[i])
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    for i in (longest, one):
        solo = serve_on(eng, [prompts[i]])[0]
        if solo.tokens != results[i].tokens:
            raise AssertionError(f"{what}: request {i} alone gave "
                                 f"{solo.tokens}, in the fleet "
                                 f"{results[i].tokens}")
    return out


def options_path(cfg, dev, model, mp):
    """(r): the attention backends and ``preunpack_decode`` on phase 4's
    model and fleet (the module docstring, item 32)."""
    import torch

    prompts = mp["prompts"]
    planes = {n: m.t1p.dtype for n, m in model.named_modules()
              if getattr(m, "t1p", None) is not None}
    runs = {}
    for name, ecfg in (("pallas", dict(attn_backend="pallas")),
                       ("stream", dict(attn_backend="stream")),
                       ("materialized", dict(attn_backend="materialized")),
                       ("paged stream", dict(attn_backend="stream",
                                             kv_layout="paged",
                                             page_size=PAGE)),
                       ("preunpack", dict(preunpack_decode=True))):
        t0 = time.perf_counter()
        runs[name] = r = option_run(model, cfg, prompts, f"(r) {name}",
                                    **ecfg)
        r["phase_s"] = time.perf_counter() - t0
        gc_free()
    pal = runs["pallas"]
    same_tokens(pal["results"], mp["results"], "(r) pallas against auto")
    if pal["per_step"]["chunk_attention"] != cfg.n_layers:
        raise AssertionError(f"(r) pallas: {pal['per_step']} launches a "
                             f"decode step, not {cfg.n_layers} of B2")
    for name in ("stream", "materialized", "paged stream"):
        c = runs[name]["counts"]
        if c["chunk_attention"] or c["chunk_attention_paged"]:
            raise AssertionError(f"(r) {name} launched an attention "
                                 f"kernel: {c}")
    need(runs["paged stream"]["counts"],
         ("ternary_matvec", "ternary_matmul", "add_rms_norm"),
         "(r) paged stream")
    pre = runs["preunpack"]
    mem = pre["memory"]
    if not mem["preunpack_decode"] or mem["resident_plane_bytes"] != \
            4 * mem["packed_plane_bytes"]:
        raise AssertionError(f"(r) preunpack memory_stats {mem}")
    if pre["counts"]["ternary_matvec"] or pre["counts"]["ternary_matmul"]:
        raise AssertionError(f"(r) preunpack launched B1/B3: "
                             f"{pre['counts']}")
    need(pre["counts"], ("chunk_attention", "add_rms_norm"), "(r) preunpack")
    after = {n: m.t1p.dtype for n, m in model.named_modules()
             if getattr(m, "t1p", None) is not None}
    if after != planes or set(after.values()) != {torch.uint8}:
        raise AssertionError("(r) preunpack changed the caller's planes")
    # raw int8 planes reach the plain route on the card only by name: the
    # served copy asks for "grouped", and ``auto`` refuses them
    from repro_torch.core.packing import unpack_trits
    from repro_torch.kernels.ternary_matmul import ops
    lin = next(m for m in model.modules() if getattr(m, "t1p", None)
               is not None)
    x = torch.zeros((1, lin.d_in), device=dev, dtype=torch.bfloat16)
    try:
        ops.ternary_matmul(x, unpack_trits(lin.t1p), unpack_trits(lin.t2p),
                           lin.alpha, group_size=lin.group_size)
    except ValueError:
        pass
    else:
        raise AssertionError("(r) int8 planes under backend 'auto' were "
                             "served on the card")
    for r in runs.values():
        r["apart"] = tokens_apart(r["results"], pal["results"])
        r["first"] = first_apart(r["results"], pal["results"])
    for r in runs.values():
        del r["results"]
    return runs


def log_options(gpu, runs):
    med = lambda xs: xs[len(xs) // 2]  # noqa: E731
    for name, r in runs.items():
        log(f"{gpu} | (r) {name}: decode {r['decode_tok']} tokens in "
            f"{r['decode_s']:.3f}s = {r['decode_tok'] / r['decode_s']:.1f} "
            f"tok/s ({1e3 * r['decode_s'] / r['steps']:.3f} ms a decode "
            f"step, {r['dispatches']} replayed decode dispatches, one host "
            f"sync each); TTFT median {med(r['ttft']):.3f}s max "
            f"{r['ttft'][-1]:.3f}s; {r['apart']} tokens apart from the "
            f"pallas fleet (first at decode step {r['first']}); solo == "
            f"fleet; the phase {r['phase_s']:.1f}s"
            + (" (paged: the second pass adopts the first's cached prefix "
               "pages)" if name.startswith("paged") else ""))
    log(f"(r) launches a decode step: "
        + "; ".join(f"{n} {dict((k, v) for k, v in r['per_step'].items() if v)}"
                    for n, r in runs.items()))
    m = runs["preunpack"]["memory"]
    log(f"{gpu} | (r) preunpack_decode: resident planes "
        f"{m['resident_plane_bytes']} bytes = {m['preunpack_ratio']:.1f}x "
        f"packed {m['packed_plane_bytes']}; param bytes {m['param_bytes']}")


# the matrices of (s): (name, n, d) of one qwen2-1.5b layer and the lm_head
BASELINE_SHAPES = (("q", 1536, 1536), ("k", 256, 1536), ("o", 1536, 1536),
                   ("gate", 8960, 1536), ("down", 1536, 8960),
                   ("lm_head", 151936, 1536))


def baselines_path(dev):
    """(s): ``quantize_with_history`` and the baselines at full shapes (the
    module docstring, item 33). Returns {matrix: {method: (seconds,
    relative error)}} and the history's gates."""
    import torch

    from repro_torch.core import ptqtp
    from repro_torch.core.baselines import (awq_quantize, billm_quantize,
                                            gptq_quantize, rtn_quantize)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = ptqtp.PTQTPConfig(group_size=GROUP, t_max=20)
    table, hist = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel(w, w_hat):
        if not bool(torch.isfinite(w_hat).all()):
            raise AssertionError(f"(s) {name}: non-finite values")
        return float(torch.linalg.norm(w - w_hat) / torch.linalg.norm(w))

    for name, n, d in BASELINE_SHAPES:
        w = torch.randn((n, d), generator=gen, device=dev) * 0.02
        x = torch.randn((128, d), generator=gen, device=dev)
        reset_launch_counts()
        (q, errs), hs = timed(lambda: ptqtp.quantize_with_history(w, cfg))
        launches = launch_counts()["ptqtp_search"]
        need({"ptqtp_search": launches}, ("ptqtp_search",),
             f"(s) {name} quantize_with_history")
        e = errs.cpu()
        if not bool((e[1:] <= e[:-1] + 1e-4 * e[0]).all()):
            raise AssertionError(f"(s) {name}: the error rose: {e.tolist()}")
        full, ps = timed(lambda: ptqtp.ptqtp_quantize(w, cfg))
        if full.iters != q.iters or not torch.equal(full.t1, q.t1) \
                or not torch.equal(full.t2, q.t2):
            raise AssertionError(f"(s) {name}: the history's planes or "
                                 f"iterations ({q.iters}) are not "
                                 f"ptqtp_quantize's ({full.iters})")
        err = float(ptqtp.ptqtp_error(w, q))
        last = float(e[-1] / torch.linalg.norm(w).cpu())
        if abs(last - err) > 1e-5 * err:
            raise AssertionError(f"(s) {name}: last error {last}, "
                                 f"ptqtp_error {err}")
        hist[name] = dict(s=hs, iters=q.iters, b6=launches, first=float(e[0]),
                          last=float(e[-1]), err=err)
        row = {"PTQTP": (ps, rel(w, ptqtp.ptqtp_dequantize(full)))}
        del q, errs, full
        for bits in (2, 3, 4):
            (w_hat, meta), t = timed(lambda: rtn_quantize(w, bits=bits,
                                                          group_size=GROUP))
            codes = meta["q"]
            if int(codes.min()) < 0 or int(codes.max()) > 2 ** bits - 1:
                raise AssertionError(f"(s) {name} RTN{bits}: codes out of "
                                     f"range")
            row[f"RTN{bits}"] = (t, rel(w, w_hat))
            del w_hat, meta, codes
        (w_hat, meta), t = timed(lambda: gptq_quantize(w, x, bits=3,
                                                       group_size=GROUP))
        steps = w_hat / meta["scale"].repeat_interleave(GROUP, dim=1)
        codes = steps.round()
        if (steps - codes).abs().max() > 1e-3 or codes.min() < -4 \
                or codes.max() > 3:
            raise AssertionError(f"(s) {name} GPTQ: codes out of range")
        row["GPTQ3"] = (t, rel(w, w_hat), float(torch.linalg.norm(
            x @ (w - w_hat).T)))
        del w_hat, meta, steps, codes
        (w_hat, meta), t = timed(lambda: awq_quantize(w, x, bits=3,
                                                      group_size=GROUP))
        row["AWQ3"] = (t, rel(w, w_hat), float(meta["ratio"]))
        del w_hat, meta
        (w_hat, meta), t = timed(lambda: billm_quantize(w, x))
        row["BiLLM"] = (t, rel(w, w_hat))
        del w_hat, meta
        w_rtn = rtn_quantize(w, bits=3, group_size=GROUP)[0]
        row["RTN3 x-weighted"] = float(torch.linalg.norm(x @ (w - w_rtn).T))
        table[name] = row
        del w, x, w_rtn
        gc_free()
    return table, hist


def log_baselines(gpu, table, hist):
    for name, h in hist.items():
        log(f"{gpu} | (s) {name} quantize_with_history: {h['iters']} "
            f"iterations in {h['s']:.3f}s ({h['b6']} B6 launches), error "
            f"{h['first']:.4f} -> {h['last']:.4f} (never rose), "
            f"ptqtp_error {h['err']:.6f}; planes and iterations "
            f"ptqtp_quantize's")
    for name, row in table.items():
        log(f"{gpu} | (s) {name} seconds / relative error: "
            + "; ".join(f"{k} {v[0]:.3f}s {v[1]:.5f}"
                        for k, v in row.items() if isinstance(v, tuple))
            + f"; AWQ ratio {row['AWQ3'][2]:.4f}")
        order = dict(
            ptqtp_beats_billm=row["PTQTP"][1] < row["BiLLM"][1],
            ptqtp_beats_rtn2=row["PTQTP"][1] < row["RTN2"][1],
            rtn4_beats_ptqtp=row["RTN4"][1] < row["PTQTP"][1],
            ptqtp_within_1_35_of_rtn3=row["PTQTP"][1] < 1.35 * row["RTN3"][1],
            gptq_x_weighted_within_1_02_of_rtn3=row["GPTQ3"][2]
            <= 1.02 * row["RTN3 x-weighted"])
        log(f"(s) {name} the reference's ordering tests (printed, not "
            f"gated): {order}")


# -------------------------------------------------------- phase 4: timings
def time_ternary(model, dev):
    """Kernel, plain and library times of the quantized linear layers (the
    ``Dense`` ones: MoE expert stacks are ``time_experts``') of
    one decode step (all 197 at m = 8, matvec) and one prefill dispatch
    (the 196 block layers at m = 512, tiled; the lm_head of a prefill reads
    one row per slot, m = 8, through the matvec), walking the model's own
    layers so the weights stream from HBM as on the main path, with bf16
    outputs as the model asks for them."""
    import torch

    from repro_torch.core.quantize_model import dequantize_kernel
    from repro_torch.kernels.ternary_matmul import ops, ref
    from repro_torch.models.common import Dense

    all_layers = [m for m in model.modules()
                  if isinstance(m, Dense) and m.t1p is not None]
    out = {}
    for key, m, kern, reps in (("ternary_matvec", SLOTS, ops.ternary_matvec, 5),
                               ("ternary_matmul", SLOTS * PREFILL_CHUNK,
                                ops.ternary_matmul_tiled, 2)):
        layers = [layer for layer in all_layers
                  if m < ops.SMALL_M_THRESHOLD or layer is not model.lm_head]
        dense_w = [dequantize_kernel(layer.quant, torch.bfloat16)
                   for layer in layers]
        xs = {d: torch.randn((m, d), device=dev).to(torch.bfloat16)
              for d in {layer.d_in for layer in layers}}

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
        worst = worst_abs = 0.0  # each layer's kernel against its plain
        for layer in layers:
            x = xs[layer.d_in]
            worst, worst_abs = _close(
                kern(x, layer.t1p, layer.t2p, layer.alpha, GROUP),
                ref.ternary_matmul_grouped(x, layer.t1p, layer.t2p,
                                           layer.alpha, GROUP),
                f"{key} {layer.d_out}x{layer.d_in} m={m}", worst, worst_abs)
        out[key] = dict(ms=device_ms(run_kernel, reps),
                        plain_ms=device_ms(run_plain, max(1, reps // 2)),
                        library_ms=device_ms(run_library, reps),
                        bound_ms=bound, bound_by=by, bytes=nbytes,
                        flops=flops, calls=len(layers), m=m,
                        us_per_call=per_shape, max_abs_err=worst_abs)
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
                        bytes=per_layer * cfg.n_layers,
                        max_abs_err=attention_err(
                            ops.chunk_attention_cuda,
                            ref.chunk_attention_stream, layers[0]))
    return out


def time_rms_norm(model, cfg, dev):
    """Times of the norms of one decode step (2 per layer and the final
    one, 8 rows of one token each, bf16, each with its own layer's scale
    as on the main path): the first, after the embedding, alone
    (``rms_norm``), and the other 56 each fused with the residual add
    before it (``add_rms_norm``). Beside each: its plain version, its
    bound, and PyTorch's calls for the same function (``x + y`` then
    ``F.rms_norm``, and ``F.rms_norm`` alone). Also, in this run, the whole
    step's norms as the path runs them now (56 fused + 1) and as it ran
    them before the fusion (56 adds + 57 ``rms_norm`` launches)."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref
    from repro_torch.models.common import RMSNorm

    norms = [m.scale for m in model.modules() if isinstance(m, RMSNorm)]
    first, fused = norms[0], norms[1:]
    d, eps = cfg.d_model, cfg.norm_eps
    gen = torch.Generator(device=dev).manual_seed(6)
    x, y = (torch.randn((SLOTS, 1, d), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    lib = torch.nn.functional.rms_norm
    n = x.numel()
    one = bound_ms(2 * n * 2 + d * 2, 4 * n, F32_FLOPS)  # x², two products
    many = bound_ms(len(fused) * (4 * n * 2 + d * 2),
                    len(fused) * 5 * n, F32_FLOPS)  # + the add
    out = dict(
        rms_norm=dict(
            ms=device_ms(lambda: ops.rms_norm(first, x, eps), 50),
            plain_ms=device_ms(lambda: ref.rms_norm_plain(first, x, eps), 50),
            library_ms=device_ms(lambda: lib(x, (d,), first, eps), 50),
            bound_ms=one[0], bound_by=one[1], calls=1),
        add_rms_norm=dict(
            ms=device_ms(lambda: [ops.add_rms_norm(w, x, y, eps)
                                  for w in fused], 10),
            plain_ms=device_ms(lambda: [ref.add_rms_norm_plain(w, x, y, eps)
                                        for w in fused], 10),
            library_ms=device_ms(lambda: [lib(x + y, (d,), w, eps)
                                          for w in fused], 10),
            library_norm_only_ms=device_ms(lambda: [lib(x, (d,), w, eps)
                                                    for w in fused], 10),
            bound_ms=many[0], bound_by=many[1], calls=len(fused)))
    out["step"] = dict(
        ms=device_ms(lambda: [ops.rms_norm(first, x, eps)]
                     + [ops.add_rms_norm(w, x, y, eps) for w in fused], 10),
        before_ms=device_ms(lambda: [ops.rms_norm(first, x, eps)]
                            + [ops.rms_norm(w, x + y, eps) for w in fused],
                            10),
        calls=len(norms))
    return out


def time_paged_attention(cfg, dev, fill, capacity=CAPACITY, n_layers=None):
    """Kernel, plain and SDPA times of the paged attention reads of one
    decode step (L = 1): ``n_layers`` (all of cfg's: qwen2's and
    deepseek's 28) distinct bf16 pools of 16-slot pages at ``capacity``
    under shuffled tables (one per layer, as on the paged path); SDPA runs
    with a boolean mask on each gathered ring."""
    import numpy as np
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(10)
    rng = np.random.default_rng(10)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    n_layers = n_layers or cfg.n_layers
    layers, sdpa_args = [], []
    for _ in range(n_layers):
        a = attention_inputs(SLOTS, 1, capacity, kv, g, hd, "bfloat16", fill,
                             gen, dev)
        a[9].fill_(1)
        paged, gathered = paged_operands(a, PAGE, rng)
        layers.append(paged)
        sdpa_args.append(_sdpa_operands(gathered, capacity))
    # bytes this run's data needs: the visible slots' k and v in the pool,
    # every logical slot's position, the table, q, the chunk, the output
    a = layers[0]
    pos_ring = ref.gather_pages(a[7], a[8])
    visible = int(ref.history_mask(pos_ring, a[9], capacity).any(1).sum())
    per_layer = (visible * kv * hd * 2 * 2 + pos_ring.numel() * 4
                 + a[8].numel() * 4
                 + (a[0].numel() + a[1].numel() + a[2].numel()) * 2
                 + a[0].numel() * 4)
    flops = 4 * SLOTS * kv * g * (visible // SLOTS + 1) * hd
    bound, by = bound_ms(per_layer * n_layers, flops * n_layers)
    return dict(
        ms=device_ms(lambda: [ops.chunk_attention_paged_cuda(*p)
                              for p in layers], 10),
        plain_ms=device_ms(lambda: [ref.chunk_attention_paged_stream(*p)
                                    for p in layers], 5),
        library_ms=device_ms(lambda: [
            torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=m, enable_gqa=True)
            for q, k, v, m in sdpa_args], 10),
        bound_ms=bound, bound_by=by, bytes=per_layer * n_layers,
        max_abs_err=attention_err(ops.chunk_attention_paged_cuda,
                                  ref.chunk_attention_paged_stream,
                                  layers[0]))


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


def graph_step(cfg, model, gpu):
    """A model's decode step as ``launch/profile_decode.py`` profiles it:
    the engine's K-step decode dispatch (8 requests of 512 tokens, past
    their prefill) replayed from its CUDA graph under ``torch.profiler``:
    launches, device-busy and host ms a step (its lines are printed), and
    the hand kernels' launches a step from the graph's own count."""
    import argparse

    import torch

    from repro_torch.launch import profile_decode as pd

    eng, run = pd.engine_dispatches(
        model, cfg, argparse.Namespace(kv_layout="ring", page_size=PAGE),
        True)
    out = pd.profiled(run, pd.DISPATCHES * pd.STEPS, gpu,
                      f"{cfg.name}, ring KV, engine decode dispatch (graph "
                      "replay)")
    graph = max(eng._loop_cache.values(), key=lambda g: g.replays)
    k = next(key[0] for key, g in eng._loop_cache.items() if g is graph)
    out["K"] = k
    out["hand"] = {name: n / k for name, n in graph.launches.items() if n}
    del eng, run, graph
    gc_free()
    torch.cuda.synchronize()
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


def attention_err(kernel, plain, args):
    """max |kernel - plain| over one read's operands; raises past ATTN_TOL."""
    import torch

    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= ATTN_TOL:
        raise AssertionError(f"{getattr(kernel, '__name__', kernel)}: max "
                             f"err {err:.3e} > {ATTN_TOL}")
    return err


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


# ------------------------------------------------- phases (j)-(l): slice 9
GEMMA_LAYERS = 8        # one period (5 local + 1 global) + the 2-local rest
GEMMA_CAPACITY = 4096   # the global ring; the local rings hold the window
GEMMA_MAX_PROMPT = 1800


def gemma_prompts(cfg):
    """8 prompts of 64-1800 random ids: the first 2·64 + 1 tokens (its last
    chunk is bucket 1 alone), two past the 1024-slot local rings (1800 and
    1100 tokens: those rings wrap, the 4096-slot global ring does not)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    lens = rng.integers(64, GEMMA_MAX_PROMPT + 1, N_REQUESTS)
    lens[0], lens[1], lens[2] = 2 * PREFILL_CHUNK + 1, GEMMA_MAX_PROMPT, 1100
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]


def solo_gates(model, cfg, prompts, results, what, **ecfg):
    """Serve alone the longest prompt and one whose last chunk runs in
    bucket 1 alone but in a wider bucket in the fleet; each must give its
    fleet tokens. Returns their indices."""
    fleet_buckets = final_buckets([len(p) for p in prompts])
    one = [i for i in range(len(prompts))
           if final_buckets([len(prompts[i])])[0] == 1 < fleet_buckets[i]]
    if not one:
        raise AssertionError(f"{what}: no prompt ends in bucket 1 alone and "
                             f"a wider bucket in the fleet ({fleet_buckets})")
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    for i in (longest, one[0]):
        solo = serve(model, cfg, [prompts[i]], **ecfg)[0]
        if solo[0].tokens != results[i].tokens:
            raise AssertionError(f"{what}: request {i} alone gave "
                                 f"{solo[0].tokens}, in the fleet "
                                 f"{results[i].tokens}")
    return longest, one[0]


def finished(results, what, max_new=MAX_NEW):
    bad = [r.uid for r in results
           if r.finish_reason != "length" or len(r.tokens) != max_new]
    if bad:
        raise AssertionError(f"{what}: requests {bad} did not finish with "
                             f"{max_new} tokens")


def same_tokens(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.tokens != w.tokens:
            raise AssertionError(f"{what}: request {i} gave {g.tokens}, "
                                 f"against {w.tokens}")


def tokens_apart(got, want):
    """Tokens of ``got`` that differ from ``want`` (request by request)."""
    return sum(a != b for g, w in zip(got, want)
               for a, b in zip(g.tokens, w.tokens))


def fleet_run(model, cfg, prompts, **ecfg):
    """The fleet on a warmed engine, the launch counts reset just before
    and read just after: (results, counts, engine, wall seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    eng = make_engine(model, cfg, warm=True, **ecfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = serve_on(eng, prompts)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    for k, n in eng.smoke["compiled"].items():
        if k in ("admits", "prefill_steps"):
            continue
        if eng.compile_stats()[k] != n:
            raise AssertionError("the fleet compiled more after warmup()")
    return results, counts, eng, wall


def fleet_stats(eng, results, wall):
    ttft = sorted(r.ttft for r in results)
    dec_tok = eng.tokens_generated - len(results)
    return dict(wall=wall, ttft=ttft, decode_tok=dec_tok,
                decode_s=eng.smoke["decode_s"], steps=eng.steps,
                per_step=per_step(eng), warmup_s=eng.smoke["warmup_s"])


def attention_rings(cfg, capacity):
    """(ring slots, window) of each attention layer of ``cfg`` at
    ``capacity``: a local layer's ring holds min(window, capacity) slots."""
    from repro_torch.models.transformer import is_recurrent

    return [(min(cfg.window, capacity), cfg.window) if k.startswith("local")
            else (capacity, None) for k in cfg.layer_kinds
            if not is_recurrent(k)]


def check_attention_layers(cfg, dev, capacity):
    """B2 at a model's head dim against its plain version on the card, at
    its path's shapes: 8 rows, its kv heads and group, L = 1 and 64, each
    distinct ring of its attention layers at ``capacity`` (gemma3: local
    rings of 1024 under the window and the global ring of 4096; hd 168,
    G 2; recurrentgemma: local rings of 2048, hd 256, G 10), bf16 and int8;
    every row alone equals its row in the batch of 8, and L = 1 equals
    l = 0 of L = 64 with length 1."""
    import functools

    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(12)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    fill = [0, 300, 1023, 1024, 1500, 2900, 64, 1800]
    worst = 0.0
    rings = sorted(set(attention_rings(cfg, capacity)),
                   key=lambda r: (r[0], r[1] is None))
    for cap, window in rings:
        kern = functools.partial(ops.chunk_attention_cuda, window=window)
        for ring in ("bfloat16", "int8"):
            for L in (1, PREFILL_CHUNK):
                args = attention_inputs(SLOTS, L, cap, kv, g, hd, ring, fill,
                                        gen, dev)
                got = kern(*args)
                want = ref.chunk_attention_stream(*args, window=window)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not err <= ATTN_TOL:
                    raise AssertionError(
                        f"chunk_attention hd {hd} G {g} cap {cap} L={L} "
                        f"{ring}: max err {err:.3e} > {ATTN_TOL}")
                worst = max(worst, err)
            args = attention_inputs(SLOTS, PREFILL_CHUNK, cap, kv, g, hd,
                                    ring, fill, gen, dev)
            args[9].fill_(1)
            same_rows(kern, args, 8, f"B2 hd {hd} cap {cap} {ring}")
    log(f"chunk_attention at hd {hd}, G {g} == plain (max abs err "
        f"{worst:.2e} <= {ATTN_TOL}) on rings (slots, window) {rings}, bf16 "
        "and int8, L in (1, 64); rows bit-identical alone and in the batch "
        "of 8, and at L = 1 and L = 64 with length 1")
    return worst


def gemma_path(dev):
    """(j) gemma3-27b at full width, cut to 8 layers: quantize on the card,
    serve the fleet on the ring (local rings of 1024 slots, the global one
    of 4096) through CUDA graphs; solo == fleet, graph == eager, the paged
    layout refused as the reference refuses it, B2 at hd 168 against its
    plain version."""
    from repro_torch import configs

    cfg = configs.get_config("gemma3-27b").scaled(n_layers=GEMMA_LAYERS)
    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), "(j) the quantize path")
    ring = dict(capacity=GEMMA_CAPACITY)
    prompts = gemma_prompts(cfg)
    results, counts, eng, wall = fleet_run(model, cfg, prompts, **ring)
    need(counts, RING_PATH, "(j) gemma3-27b's ring path")
    finished(results, "(j)")
    caps = sorted({c["k"].shape[1] for c in eng.state["layers"]})
    if caps != [cfg.window, GEMMA_CAPACITY]:
        raise AssertionError(f"(j) ring sizes {caps}")
    stats = fleet_stats(eng, results, wall)
    eng = None
    gc_free()
    solo = solo_gates(model, cfg, prompts, results, "(j) solo", **ring)
    eager = serve(model, cfg, prompts, capture=False, **ring)[0]
    same_tokens(eager, results, "(j) eager vs graph")
    try:
        make_engine(model, cfg, kv_layout="paged", page_size=PAGE, **ring)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("(j) a paged engine took sliding windows")
    if "paged KV layout requires full-capacity attention layers" not in \
            refused:
        raise AssertionError(f"(j) paged refusal: {refused}")
    gc_free()
    attn_err = check_attention_layers(cfg, dev, GEMMA_CAPACITY)
    return dict(cfg=cfg, model=model, report=report, quant_s=quant_s,
                qcounts=qcounts, counts=counts, prompts=prompts,
                solo=solo, refused=refused, attn_err=attn_err, **stats)


def check_experts(moe, cfg, dev):
    """The expert-axis launch (B1 and B3 with the expert on the grid's z
    axis) at the (k) path's shapes: one MoE layer's three stacks at cap 1
    (decode), 60 (a capped 64-token prefill bucket) and 3072 (the no-drop
    copy's): each expert's rows bit for bit those of a launch of its matrix
    alone, and within MM_RTOL of the plain version. Returns the worst
    absolute error."""
    import torch

    from repro_torch.kernels.ternary_matmul import ops, ref

    gen = torch.Generator(device=dev).manual_seed(13)
    worst = worst_abs = 0.0
    stacks = (moe.experts.wi, moe.experts.wg, moe.experts.wo)
    for m in (1, 60, 3072):
        one = ops.ternary_matvec if m < ops.SMALL_M_THRESHOLD \
            else ops.ternary_matmul_tiled
        for st in stacks:
            x = torch.randn((st.n_experts, m, st.d_in), generator=gen,
                            device=dev).to(torch.bfloat16)
            y = ops.ternary_matmul_experts(x, st.t1p, st.t2p, st.alpha,
                                           group_size=GROUP,
                                           out_dtype=torch.bfloat16)
            y32 = ops.ternary_matmul_experts(x, st.t1p, st.t2p, st.alpha,
                                             group_size=GROUP)
            if not torch.equal(y, y32.to(torch.bfloat16)):
                raise AssertionError(f"experts m={m}: bf16 output is not the "
                                     "f32 output rounded")
            for e in range(st.n_experts):
                if not torch.equal(y32[e], one(x[e].contiguous(), st.t1p[e],
                                               st.t2p[e], st.alpha[e],
                                               GROUP)):
                    raise AssertionError(
                        f"experts m={m} {st.d_out}x{st.d_in}: expert {e} of "
                        "the stacked launch differs from its own launch")
                worst, worst_abs = _close(
                    y32[e], ref.ternary_matmul_grouped(
                        x[e], st.t1p[e], st.t2p[e], st.alpha[e], GROUP),
                    f"experts m={m} expert {e}", worst, worst_abs)
            del x, y, y32
    log(f"expert-axis ternary launch == one launch per expert bit for bit "
        f"and == plain (max abs err {worst_abs:.2e}, max err / scale "
        f"{worst:.2e} <= {MM_RTOL}) for {stacks[0].n_experts} experts of "
        f"{[f'{s.d_out}x{s.d_in}' for s in stacks]} at cap 1, 60, 3072")
    return worst_abs


def router_invariance(moe, cfg, dev):
    """A row's router probabilities (f32 product in 128-row blocks, then
    softmax) have the same bits alone, in 8 rows and in 512."""
    import torch

    from repro_torch.models.moe import router_probs

    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((512, cfg.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    full = router_probs(moe, x)
    eight = router_probs(moe, x[:8])
    if not torch.equal(full[:8], eight):
        raise AssertionError("router probabilities of rows 0-7 differ in "
                             "512 rows and in 8")
    for i in (0, 3, 7):
        if not torch.equal(router_probs(moe, x[i:i + 1]), full[i:i + 1]):
            raise AssertionError(f"router probabilities of row {i} differ "
                                 "alone and in 512 rows")


def deepseek_path(dev):
    """(k) deepseek-moe-16b at full width and depth: quantize on the card,
    the phase-4 fleet on the ring and the paged layout with the published
    capacity factor (graph == eager), the expert-axis launch and the
    router at the path's shapes; then the no-drop copy (capacity factor
    -1) for ring == paged, solo == fleet and warm == cold, which the capped
    config does not promise: its capacity is per dispatch, idle rows
    included, as the reference's, and an idle slot's row reads its stale
    ring on the ring layout but null pages on the paged one (the
    reference's engines differ there too). How far the capped config's
    streams move is reported."""
    import dataclasses

    import numpy as np

    from repro_torch import configs

    cfg = configs.get_config("deepseek-moe-16b")
    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), "(k) the quantize path")
    prompts = make_prompts(cfg)
    results, counts, eng, wall = fleet_run(model, cfg, prompts)
    need(counts, RING_PATH + ("ternary_matvec_experts",),
         "(k) deepseek-moe-16b's ring path")
    finished(results, "(k) ring")
    stats = fleet_stats(eng, results, wall)
    eng = None
    paged = dict(kv_layout="paged", page_size=PAGE, prefix_cache=True)
    presults, pcounts, peng, pwall = fleet_run(model, cfg, prompts, **paged)
    need(pcounts, PAGED_PATH + ("ternary_matvec_experts",),
         "(k) deepseek-moe-16b's paged path")
    finished(presults, "(k) paged")
    capped_paged = tokens_apart(presults, results)
    pstats = fleet_stats(peng, presults, pwall)
    peng = None
    gc_free()
    eager = serve(model, cfg, prompts, capture=False)[0]
    same_tokens(eager, results, "(k) eager vs graph")
    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    alone = serve(model, cfg, [prompts[longest]])[0][0].tokens
    capped_solo = sum(a != b for a, b in zip(alone, results[longest].tokens))
    moe = model.layers[1].moe
    experts_err = check_experts(moe, cfg, dev)
    router_invariance(moe, cfg, dev)
    gc_free()

    # the no-drop copy: the same weights, capacity factor -1
    nd = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=-1.0))
    nresults, ncounts, neng, nwall = fleet_run(model, nd, prompts)
    need(ncounts, RING_PATH + ("ternary_matvec_experts",
                               "ternary_matmul_experts"),
         "(k) the no-drop copy's ring path")
    finished(nresults, "(k) no-drop")
    nstats = fleet_stats(neng, nresults, nwall)
    neng = None
    gc_free()
    npaged = serve(model, nd, prompts, **paged)[0]
    same_tokens(npaged, nresults, "(k) no-drop paged vs ring")
    nsolo = solo_gates(model, nd, prompts, nresults, "(k) no-drop solo")
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    fleet = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(TAILS[0], TAILS[1] + 1, N_REQUESTS)]
    cold_eng = make_engine(model, nd, **paged)
    cold = serve_on(cold_eng, fleet)
    warm_eng = make_engine(model, nd, **paged)
    serve_on(warm_eng, [prefix + [1]], 1)
    warm = serve_on(warm_eng, fleet)
    same_tokens(warm, cold, "(k) no-drop warm vs cold")
    hits = warm_eng.alloc.hits
    if not hits > 0:
        raise AssertionError("(k) the warm fleet found no prefix page cached")
    cold_eng = warm_eng = None
    gc_free()
    return dict(cfg=cfg, nd=nd, model=model, report=report, quant_s=quant_s,
                counts=counts, pcounts=pcounts, ncounts=ncounts,
                prompts=prompts, experts_err=experts_err,
                capped_solo=(longest, capped_solo), capped_paged=capped_paged,
                nsolo=nsolo, hits=hits,
                paged=pstats, nodrop=nstats, **stats)


def time_experts(moe, dev, m, reps):
    """Kernel, plain and ``torch.bmm`` times of one MoE layer's three
    stacked expert products (wi, wg, wo over all E experts, as the
    reference's dispatch computes every expert's cap rows) at ``m`` rows an
    expert, bf16 x and outputs. The library call multiplies the stacks
    dequantized to bf16 (not timed)."""
    import torch

    from repro_torch.core.quantize_model import dequantize_kernel
    from repro_torch.kernels.ternary_matmul import ops, ref

    stacks = (moe.experts.wi, moe.experts.wg, moe.experts.wo)
    xs = [torch.randn((st.n_experts, m, st.d_in), device=dev).to(
        torch.bfloat16) for st in stacks]
    dense_w = [dequantize_kernel(st.quant, torch.bfloat16).transpose(1, 2)
               for st in stacks]
    nbytes = flops = 0
    for st in stacks:
        b, f = matmul_cost(st.d_out, st.d_in, m)
        nbytes, flops = nbytes + st.n_experts * b, flops + st.n_experts * f
    bound, by = bound_ms(nbytes, flops)
    def experts_kernel():
        for x, st in zip(xs, stacks):
            ops.ternary_matmul_experts(x, st.t1p, st.t2p, st.alpha,
                                       group_size=GROUP,
                                       out_dtype=torch.bfloat16)

    def experts_plain():
        for x, st in zip(xs, stacks):
            ref.ternary_matmul_experts(x, st.t1p, st.t2p, st.alpha, GROUP)

    def experts_bmm():
        for x, w in zip(xs, dense_w):
            torch.bmm(x, w)

    out = dict(ms=device_ms(experts_kernel, reps),
               plain_ms=device_ms(experts_plain, 1),
               library_ms=device_ms(experts_bmm, reps), bound_ms=bound,
               bound_by=by, bytes=nbytes, flops=flops, m=m)
    del xs, dense_w
    gc_free()
    return out


def time_attention_layers(cfg, dev, fill, capacity):
    """Kernel, plain and SDPA times of the attention reads of one decode
    step (L = 1) and one prefill dispatch (L = 64) of a model at
    ``capacity``, bf16 rings filled as ``fill``: (j) gemma3's 7 local rings
    of 1024 slots (window 1024 = the ring, so the reach is the ring's) and
    its global ring of 4096 at hd 168; (m) recurrentgemma's 8 local rings of
    2048 at hd 256."""
    import torch

    from repro_torch.kernels.chunk_attention import ops, ref

    gen = torch.Generator(device=dev).manual_seed(15)
    kv, g, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    caps = [cap for cap, _ in attention_rings(cfg, capacity)]
    out = {}
    for key, L, reps in (("decode", 1, 10), ("prefill", PREFILL_CHUNK, 3)):
        layers = [attention_inputs(SLOTS, L, cap, kv, g, hd, "bfloat16",
                                   fill, gen, dev) for cap in caps]
        for a in layers:
            a[9].fill_(L)
        sdpa_args = [_sdpa_operands(a, cap) for a, cap in zip(layers, caps)]
        nbytes = flops = 0
        for a, cap in zip(layers, caps):
            visible = int(ref.history_mask(a[7], a[8], cap).any(1).sum())
            nbytes += (visible * kv * hd * 2 * 2 + a[7].numel() * 4
                       + (a[0].numel() + a[1].numel() + a[2].numel()) * 2
                       + a[0].numel() * 4)
            flops += 4 * SLOTS * kv * g * L * (visible // SLOTS + L) * hd
        bound, by = bound_ms(nbytes, flops)
        out[key] = dict(
            ms=device_ms(lambda: [ops.chunk_attention_cuda(*a)
                                  for a in layers], reps),
            plain_ms=device_ms(lambda: [ref.chunk_attention_stream(*a)
                                        for a in layers], max(1, reps // 2)),
            library_ms=device_ms(lambda: [
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True)
                for q, k, v, mask in sdpa_args], reps),
            bound_ms=bound, bound_by=by, L=L, bytes=nbytes,
            max_abs_err=max(attention_err(ops.chunk_attention_cuda,
                                          ref.chunk_attention_stream, a)
                            for a in layers))
        del layers, sdpa_args
        gc_free()
    return out


def log_fleet(gpu, what, st):
    med = st["ttft"][len(st["ttft"]) // 2]
    log(f"{gpu} | {what}: TTFT median {med:.3f}s max {st['ttft'][-1]:.3f}s; "
        f"decode {st['decode_tok']} tokens in {st['decode_s']:.3f}s = "
        f"{st['decode_tok'] / st['decode_s']:.1f} tok/s ({st['steps']} decode "
        f"steps, {1e3 * st['decode_s'] / max(st['steps'], 1):.3f} ms a step); "
        f"fleet {st['wall']:.2f}s; warmup() {st['warmup_s']:.2f}s")


def slice9_phases(gpu, dev):
    """(j)-(l): gemma3-27b and deepseek-moe-16b at full width, the JAX
    package's smoke artifacts of both; then the new routes' times. Returns
    their rows of the ``kernels`` line."""
    import torch

    t0 = time.perf_counter()
    gp = gemma_path(dev)
    gcfg = gp["cfg"]
    tot = gp["report"]["__total__"]
    log(f"{gpu} | (j) gemma3-27b ({GEMMA_LAYERS} of {62} layers, d "
        f"{gcfg.d_model}, {gcfg.n_heads}/{gcfg.n_kv_heads} heads, hd "
        f"{gcfg.head_dim}, d_ff {gcfg.d_ff}, vocab {gcfg.vocab_size}, window "
        f"{gcfg.window}): quantize {gp['quant_s']:.2f}s on B6 "
        f"({gp['qcounts']['ptqtp_search']} launches, {tot['n_quantized']} "
        f"kernels, {tot['compression']:.2f}x)")
    log_fleet(gpu, f"(j) ring fleet of {N_REQUESTS} ({sum(map(len, gp['prompts']))} "
              f"prompt tokens, {sorted(map(len, gp['prompts']))})", gp)
    log(f"(j) every request finished; solo == fleet for requests "
        f"{gp['solo']} (longest, bucket 1 alone); graph == eager; the paged "
        f"engine refused: {gp['refused']!r}; launches {gp['counts']}; per "
        f"decode step {gp['per_step']}; {time.perf_counter() - t0:.1f}s")
    gfill = [len(p) + MAX_NEW // 2 for p in gp["prompts"]]
    gtern = time_ternary(gp["model"], dev)
    del gp["model"]
    gc_free()
    gattn = time_attention_layers(gcfg, dev, gfill, GEMMA_CAPACITY)

    t0 = time.perf_counter()
    dp = deepseek_path(dev)
    dcfg = dp["cfg"]
    tot = dp["report"]["__total__"]
    log(f"{gpu} | (k) deepseek-moe-16b ({dcfg.n_layers} layers, d "
        f"{dcfg.d_model}, {dcfg.moe.n_experts} experts top-{dcfg.moe.top_k} "
        f"of d {dcfg.moe.d_expert}, {dcfg.moe.n_shared} shared, capacity "
        f"factor {dcfg.moe.capacity_factor}): quantize {dp['quant_s']:.2f}s "
        f"on B6 ({tot['n_quantized']} kernels, {tot['compression']:.2f}x)")
    log_fleet(gpu, "(k) ring fleet", dp)
    log_fleet(gpu, "(k) paged fleet", dp["paged"])
    log_fleet(gpu, "(k) no-drop copy, ring fleet", dp["nodrop"])
    li, nd = dp["capped_solo"]
    log(f"(k) graph == eager; with the published capacity factor the "
        f"longest request ({li}) alone differs from the fleet in {nd} of "
        f"{MAX_NEW} tokens and the paged fleet from the ring's in "
        f"{dp['capped_paged']} of {N_REQUESTS * MAX_NEW} (capacity per "
        f"dispatch, idle rows included: not gated); the no-drop copy: ring "
        f"== paged, solo == fleet for requests {dp['nsolo']}, warm == cold "
        f"on the paged layout ({dp['hits']} prefix pages hit); router "
        f"rows bit-identical alone, in 8 and in 512; launches ring "
        f"{dp['counts']}, paged {dp['pcounts']}, no-drop {dp['ncounts']}; "
        f"{time.perf_counter() - t0:.1f}s")
    moe = dp["model"].layers[1].moe
    n_moe = sum(k.endswith("+moe") for k in dcfg.layer_kinds)
    t_dec = time_experts(moe, dev, 1, 5)
    t_cap = time_experts(moe, dev, 60, 3)
    t_nd = time_experts(moe, dev, 3072, 2)
    dtern = time_ternary(dp["model"], dev)
    del dp["model"], moe
    gc_free()
    dfill = [len(p) + MAX_NEW // 2 for p in dp["prompts"]]
    dattn = time_attention(dcfg, dev, dfill)
    dpattn = time_paged_attention(dcfg, dev, dfill)

    t0 = time.perf_counter()
    lp = {}
    for name in ("gemma3", "deepseek"):
        lp[name] = fixture_path(dev, name)
        gc_free()
    for name, r in lp.items():
        log(f"(l) the JAX package's {name} artifact: {r['n']} requests, "
            f"{r['tokens']} tokens equal to the JAX engine's on "
            f"{r['layouts']}, and the bucket-1 request alone; launches "
            f"{r['counts']}")
    log(f"(l) {time.perf_counter() - t0:.1f}s")

    named = [("gemma3-27b B1", gtern["ternary_matvec"]),
             ("gemma3-27b B3", gtern["ternary_matmul"]),
             ("gemma3-27b B2 hd 168 L=1", gattn["decode"]),
             ("gemma3-27b B2 hd 168 L=64", gattn["prefill"]),
             ("deepseek-moe-16b B1 (dense layers)", dtern["ternary_matvec"]),
             ("deepseek-moe-16b B3 (dense layers)", dtern["ternary_matmul"]),
             ("deepseek-moe-16b B2 L=1", dattn["decode"]),
             ("deepseek-moe-16b B2 L=64", dattn["prefill"]),
             ("deepseek-moe-16b B4 L=1", dpattn),
             ("deepseek-moe-16b experts cap 1 (one layer)", t_dec),
             ("deepseek-moe-16b experts cap 60 (one layer)", t_cap),
             ("deepseek-moe-16b experts cap 3072 (one layer)", t_nd)]
    for name, t in named:
        log(f"{gpu} | {name}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound")
    log(f"{gpu} | deepseek-moe-16b experts of a decode step ({n_moe} MoE "
        f"layers at cap 1): {n_moe * t_dec['ms']:.3f} ms, bound "
        f"{n_moe * t_dec['bound_ms']:.4f} ms; every expert's planes read "
        f"({t_dec['bytes'] * n_moe / 1e9:.2f} GB a step)")

    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    src = "src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu"
    attn_src = ("src/repro_torch/kernels/chunk_attention/csrc/"
                "chunk_attention.cu")
    b1, b3 = ("src/repro/kernels/ternary_matmul/kernel.py:175",
              "src/repro/kernels/ternary_matmul/kernel.py:91")
    b2, b4 = ("src/repro/kernels/chunk_attention/kernel.py:197",
              "src/repro/kernels/chunk_attention/kernel.py:149")

    def row(name, source, replaces, counts, per_step, t, work):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=counts[name.split(" ")[0]],
                    launches_per_decode_step=per_step[name.split(" ")[0]],
                    max_abs_err=t["max_abs_err"], work=work,
                    **{k: t[k] for k in timed})

    per_model = [
        row("ternary_matvec (gemma3-27b)", src, b1, gp["counts"],
            gp["per_step"], gtern["ternary_matvec"],
            "the 57 linear layers of one (j) decode step, m=8, bf16; "
            "launches are the (j) ring path's"),
        row("ternary_matmul (gemma3-27b)", src, b3, gp["counts"],
            gp["per_step"], gtern["ternary_matmul"],
            "the 56 block linear layers of one (j) prefill dispatch, "
            "m=512, bf16"),
        row("ternary_matvec (deepseek-moe-16b)", src, b1, dp["counts"],
            dp["per_step"], dtern["ternary_matvec"],
            "the quantized Dense layers (attention, shared experts, layer "
            "0's MLP but its d_in-10944 wo, lm_head) of one (k) decode "
            "step, m=8, bf16"),
        row("ternary_matmul (deepseek-moe-16b)", src, b3, dp["counts"],
            dp["per_step"], dtern["ternary_matmul"],
            "those layers but the lm_head in one (k) prefill dispatch, "
            "m=512, bf16"),
        row("chunk_attention (deepseek-moe-16b)", attn_src, b2,
            dp["counts"], dp["per_step"], dattn["decode"],
            "28 reads of one (k) decode step, L=1, 16 kv heads, bf16 ring "
            "of 1024; library: SDPA with a boolean mask"),
        row("chunk_attention_paged (deepseek-moe-16b)", attn_src, b4,
            dp["pcounts"], dp["paged"]["per_step"], dpattn,
            "28 paged reads of one (k) decode step, L=1, 16-slot pages; "
            "launches are the (k) paged path's"),
    ]
    return per_model + [
        dict(name="ternary_matvec_experts", route="cuda", source=src,
             replaces="src/repro/kernels/ternary_matmul/kernel.py:175",
             launches=dp["counts"]["ternary_matvec_experts"],
             launches_per_decode_step=dp["per_step"][
                 "ternary_matvec_experts"],
             max_abs_err=dp["experts_err"],
             work="one deepseek-moe-16b MoE layer's three stacked expert "
                  "products (64 experts, 2048<->1408) at cap 1, the decode "
                  "step's, bf16 x on the tensor cores, the expert on the "
                  "grid's z axis; launches are the (k) ring path's; "
                  "library: torch.bmm on the stacks dequantized to bf16",
             **{k: t_dec[k] for k in timed}),
        dict(name="ternary_matmul_experts", route="cuda", source=src,
             replaces="src/repro/kernels/ternary_matmul/kernel.py:91",
             launches=dp["ncounts"]["ternary_matmul_experts"],
             launches_per_decode_step=dp["nodrop"]["per_step"][
                 "ternary_matmul_experts"],
             max_abs_err=dp["experts_err"],
             work="one deepseek-moe-16b MoE layer's three stacked expert "
                  "products at cap 3072 (the no-drop copy's 64-token "
                  "prefill bucket), bf16 x on the tensor cores; launches are "
                  "the (k) no-drop ring path's (the published capacity "
                  "factor caps a bucket at 60 rows: the matvec); library: "
                  "torch.bmm on the stacks dequantized to bf16",
             **{k: t_nd[k] for k in timed}),
        dict(name="chunk_attention_hd168", route="cuda",
             source="src/repro_torch/kernels/chunk_attention/csrc/"
                    "chunk_attention.cu",
             replaces="src/repro/kernels/chunk_attention/kernel.py:197",
             launches=gp["counts"]["chunk_attention"],
             launches_per_decode_step=gp["per_step"]["chunk_attention"],
             max_abs_err=gp["attn_err"],
             work="the 8 attention reads of one gemma3-27b decode step at "
                  "hd 168 (7 local rings of 1024 slots, 1 global of 4096), "
                  "L=1, bf16; launches are the (j) ring path's; library: "
                  "SDPA with a boolean mask",
             **{k: gattn["decode"][k] for k in timed}),
    ]


# ------------------------------------------------ phases (m)-(p): slice 10
RG_CAPACITY = 4096        # (m) the ring fleet; the local rings hold 2048
RG_MAX_PROMPT = 3000
RG_PAGED_CAPACITY = 2048  # (m) ring == paged, capacity within the window
RG_PAGED_PROMPT = 1900
RWKV_CAPACITY, RWKV_LONG = 4096, 4000
# stated tolerances of the recurrences' kernels against their plain
# versions on the same inputs. The scans' states are a product and a sum
# a step, each rounded on its own in both (no contraction): exactly equal.
# The wkv6 readout sums hd products in another order than the plain
# version's reduction, then normalises the head: (relative, absolute) per
# element, f32 within 1e-4 of outputs ~ 1, bf16 within one bf16 step of the
# value (2^-7) plus 2^-7 (a step of one pre-norm y moves the head's mean
# and variance, so every element of the head).
SCAN_TOL = 0.0
# wkv6 stages a chunk in tiles of 32 steps: this S spans six full tiles and
# a ragged seventh (the gates and a time), beside the paths' S = 1 and 64
WKV_LONG = 200
WKV_TOL = {"float32": (0.0, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
# how each recurrence kernel's operands are laid out: the state's index,
# the lengths', the per-step operands (cut per step) and the per-row ones
# (rglru_scan: the gate products ya, yx as (B, S, R), c, g, h, lengths)
RECURRENCES = {
    "rglru_scan": dict(state=4, lengths=5, steps=(0, 1, 2, 3),
                       rows=(0, 1, 2, 3, 4, 5)),
    "wkv6": dict(state=5, lengths=6, steps=(0, 1, 2, 3),
                 rows=(0, 1, 2, 3, 5, 6)),
}


def recurrent_lengths(s):
    """Per-row lengths of an ``s``-step chunk: full, ragged and idle rows."""
    return [s, max(s - 3, 0), 0, s, 1, s, s // 2, s]


# operations of the fused RG-LRU a (row, step, channel), each
# transcendental one: 2 bias adds, 2 sigmoids (exp, add, divide), -8·sp·r,
# exp, 2·log a, exp, 1 − ·, max, sqrt, i·c, the product, the scan's product
# and sum, the tanh-GELU (x³ in 2, an FMA as 2, β·, tanh, 1 +, 2 products)
# and the output's product
GATED_OPS = 30


def gate_blocks(y, n_blocks):
    """(B, S, R) → the gates' batched-product layout (n_blocks, B·S, rb),
    its blocks a 128-row multiple apart, as ``bmm_fixed_rows`` returns."""
    import torch

    b, s, r = y.shape
    m = b * s
    buf = torch.zeros((n_blocks, -(-m // 128) * 128, r // n_blocks),
                      dtype=y.dtype, device=y.device)
    buf[:, :m] = y.reshape(m, n_blocks, r // n_blocks).transpose(0, 1)
    return buf[:, :m]


def gated_inputs(s, dtype, gen, dev):
    """The fused ``rglru_scan``'s operands at recurrentgemma-2b's width
    (8 rows of 2560 in 10 blocks): ya, yx, c, g ~ N(0, 1) as (B, S, R) in
    ``dtype``, h ~ N(0, 1), the ragged and idle rows' lengths; and
    ``route(fn)``, which calls the kernel or a plain version on them with
    the gates in their batched-product layout, biases ~ N(0, 0.1) and Λ
    as the model initialises it (``route.operands(args)``: those
    arguments, for timing)."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config("recurrentgemma-2b")
    r, nb = cfg.rglru_width, cfg.rglru_blocks

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    ba, bx = rnd(r, std=0.1), rnd(r, std=0.1)
    lam = torch.linspace(-4.3, -0.7, r, device=dev).to(dtype)
    args = [rnd(SLOTS, s, r), rnd(SLOTS, s, r), rnd(SLOTS, s, r),
            rnd(SLOTS, s, r), torch.randn((SLOTS, r), generator=gen,
                                          device=dev),
            torch.tensor(recurrent_lengths(s), dtype=torch.int32, device=dev)]

    def operands(ya, yx, c, g, h, lengths):
        return [gate_blocks(ya, nb), gate_blocks(yx, nb), ba, bx, c, g, lam,
                h, lengths]

    def route(fn, **kw):
        return lambda *a: fn(*operands(*a), **kw)

    route.operands = lambda a: operands(*a)
    return args, route


def wkv_inputs(b, s, nh, hd, dtype, gen, dev):
    """``wkv6`` operands: r, k, v ~ 0.5 in ``dtype``, a decay w ∈ (0, 1)
    as the model makes it, u ~ 0.1, state ~ 0.1, scale ~ 1."""
    import torch

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    r, k, v = (rnd(b, s, nh, hd, std=0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(b, s, nh, hd, std=0.5) - 1.0))
    u = rnd(nh, hd, std=0.1).to(dtype)
    state = rnd(b, nh, hd, hd, std=0.1)
    lengths = torch.tensor(recurrent_lengths(s), dtype=torch.int32,
                           device=dev)
    scale = (1.0 + rnd(nh * hd, std=0.1)).to(dtype)
    return [r, k, v, w, u, state, lengths, scale]


def run_recurrence(kern, args, spec):
    """``kern`` on the operands with a copy of the state: (out, state)."""
    args = list(args)
    args[spec["state"]] = args[spec["state"]].clone()
    return kern(*args), args[spec["state"]]


def recurrence_invariance(kern, args, spec, what):
    """A recurrence kernel's batch and chunk invariance at the path's
    shapes, bit for bit: each row alone (B = 1) gives its output and state
    rows of the batch of 8; and with every row full, one S-step call gives
    the outputs and the state of S one-step calls."""
    import torch

    out, st = run_recurrence(kern, args, spec)
    for i in range(out.shape[0]):
        one = [a[i:i + 1].clone() if j in spec["rows"] else a
               for j, a in enumerate(args)]
        o, s1 = run_recurrence(kern, one, spec)
        if not (torch.equal(o, out[i:i + 1]) and torch.equal(s1, st[i:i + 1])):
            raise AssertionError(f"{what}: row {i} alone differs from the "
                                 "batch of 8")
    s = args[0].shape[1]
    full = list(args)
    full[spec["lengths"]] = torch.full_like(args[spec["lengths"]], s)
    chunk, st_chunk = run_recurrence(kern, full, spec)
    stepped = list(full)
    stepped[spec["state"]] = full[spec["state"]].clone()
    stepped[spec["lengths"]] = torch.ones_like(full[spec["lengths"]])
    outs = [kern(*[a[:, t:t + 1].contiguous() if j in spec["steps"] else a
                   for j, a in enumerate(stepped)]) for t in range(s)]
    if not (torch.equal(torch.cat(outs, dim=1), chunk)
            and torch.equal(stepped[spec["state"]], st_chunk)):
        raise AssertionError(f"{what}: one {s}-step call differs from {s} "
                             "one-step calls")


def check_recurrences(dev):
    """(p) ``rglru_scan`` (the fused gate-and-scan) and ``wkv6`` against
    their plain versions on the card at the (m)/(n) paths' shapes: 8 rows
    at decode (S = 1), of a prefill dispatch (S = 64) and at S = 200,
    ragged and idle rows among them; recurrentgemma-2b's RG-LRU width 2560
    in 10 blocks; rwkv6-3b's 40 heads of 64; bf16 (the served dtype) and
    f32 (the smoke artifacts'). Then their batch and chunk invariance
    (``recurrence_invariance``). Returns the largest errors {kernel: max
    abs err}."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    gen = torch.Generator(device=dev).manual_seed(20)
    rg = configs.get_config("recurrentgemma-2b")
    rw = configs.get_config("rwkv6-3b")
    nh, hd = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    worst = {"rglru_scan": 0.0, "wkv6": 0.0}
    for s in (1, PREFILL_CHUNK, WKV_LONG):
        for dtype in (torch.bfloat16, torch.float32):
            args, route = gated_inputs(s, dtype, gen, dev)
            spec = RECURRENCES["rglru_scan"]
            kern = route(scan_ops.rglru_gated_scan_cuda)
            got, got_h = run_recurrence(kern, args, spec)
            want, want_h = run_recurrence(
                route(scan_ref.rglru_gated_scan_plain), args, spec)
            torch.cuda.synchronize()
            err = max(float((got.float() - want.float()).abs().max()),
                      float((got_h - want_h).abs().max()))
            if not err <= SCAN_TOL:
                raise AssertionError(f"rglru_scan S={s} {dtype}: max err "
                                     f"{err:.3e} > {SCAN_TOL}")
            worst["rglru_scan"] = max(worst["rglru_scan"], err)
            recurrence_invariance(kern, args, spec,
                                  f"rglru_scan S={s} {dtype}")
        for dtype in (torch.bfloat16, torch.float32):
            args = wkv_inputs(SLOTS, s, nh, hd, dtype, gen, dev)
            spec = RECURRENCES["wkv6"]
            got, got_s = run_recurrence(wkv_ops.wkv6_cuda, args, spec)
            want, want_s = run_recurrence(wkv_ref.wkv6_plain, args, spec)
            torch.cuda.synchronize()
            rel, tol = WKV_TOL[str(dtype).split(".")[-1]]
            diff = (got.float() - want.float()).abs()
            over = diff - rel * want.float().abs()
            if not float(over.max()) <= tol:
                raise AssertionError(
                    f"wkv6 S={s} {dtype}: max err {float(diff.max()):.3e} "
                    f"past {rel:.2e}·|y| + {tol:.2e}")
            state_err = float((got_s - want_s).abs().max())
            if not state_err <= SCAN_TOL:
                raise AssertionError(f"wkv6 S={s} {dtype}: state err "
                                     f"{state_err:.3e} > {SCAN_TOL}")
            worst["wkv6"] = max(worst["wkv6"], float(diff.max()))
            recurrence_invariance(wkv_ops.wkv6_cuda, args, spec,
                                  f"wkv6 S={s} {dtype}")
    log(f"rglru_scan (the fused gate-and-scan, bf16 and f32) == plain bit "
        f"for bit (R {rg.rglru_width} in {rg.rglru_blocks} blocks) and wkv6 "
        f"== plain (max abs err {worst['wkv6']:.2e}: f32 within "
        f"{WKV_TOL['float32'][1]}, bf16 within 2^-7·|y| + 2^-7; states bit "
        f"for bit; {nh} heads of {hd}) at S = 1, S = {PREFILL_CHUNK} and S "
        f"= {WKV_LONG} (six 32-step tiles and a ragged seventh) with ragged "
        "and idle rows; rows bit-identical alone and in the batch of 8, and "
        "a chunk equal to one step at a time")
    return worst


def time_recurrence(name, dev, n_layers):
    """Kernel and plain times of one kernel's calls in one decode step
    (S = 1) and one prefill dispatch (S = 64) of its model: distinct
    operands per layer (recurrentgemma-2b's 18 RG-LRU layers at width 2560
    in bf16, rwkv6-3b's 32 layers of 40 heads of 64 in bf16), every row
    full; for
    wkv6 also the kernel alone at S = ``WKV_LONG`` (its plain version's
    graph would hold ~10^5 launches: not timed). No single PyTorch call
    computes either, so library_ms is null. Bound: the bytes each call must
    move (inputs read once, outputs and state written once) against the
    f32 operations at 67 TFLOP/s."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}
    shapes = [("decode", 1, 20), ("prefill", PREFILL_CHUNK, 3)]
    if name == "wkv6":
        shapes.append(("long", WKV_LONG, 3))
    for key, s, reps in shapes:
        if name == "rglru_scan":
            r = configs.get_config("recurrentgemma-2b").rglru_width
            layers = []
            for _ in range(n_layers):
                args, route = gated_inputs(s, torch.bfloat16, gen, dev)
                args[RECURRENCES[name]["lengths"]].fill_(s)
                layers.append(route.operands(args))
            kern = scan_ops.rglru_gated_scan_cuda
            plain = scan_ref.rglru_gated_scan_plain
            n = SLOTS * s * r
            # ya, yx, c, g read and the output written in bf16; h read and
            # written; lengths; lam and the two biases
            nbytes = 5 * 2 * n + 8 * SLOTS * r + 4 * SLOTS + 3 * 2 * r
            flops = GATED_OPS * n
        else:
            cfg = configs.get_config("rwkv6-3b")
            hd = cfg.rwkv_head_dim
            nh = cfg.d_model // hd
            layers = [wkv_inputs(SLOTS, s, nh, hd, torch.bfloat16, gen, dev)
                      for _ in range(n_layers)]
            for a in layers:
                a[RECURRENCES[name]["lengths"]].fill_(s)
            kern, plain = wkv_ops.wkv6_cuda, wkv_ref.wkv6_plain
            n = SLOTS * s * nh * hd
            nbytes = (3 * 2 + 4 + 2) * n + 2 * SLOTS * nh * hd * hd * 4 \
                + 2 * 2 * nh * hd + 4 * SLOTS
            # a head and step: y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i
            # (2 hd^2), S = w S + k v (3 hd^2), the readout and norm O(hd)
            flops = SLOTS * s * nh * (5 * hd * hd + 12 * hd)
        bound, by = bound_ms(nbytes * n_layers, flops * n_layers, F32_FLOPS)
        out[key] = dict(
            ms=device_ms(lambda: [kern(*a) for a in layers], reps),
            plain_ms=None if key == "long" else device_ms(
                lambda: [plain(*a) for a in layers], max(1, reps // 2)),
            library_ms=None, bound_ms=bound, bound_by=by, S=s,
            bytes=nbytes * n_layers)
        del layers
        gc_free()
    return out


def rg_prompts(cfg):
    """8 prompts of 64-3000 random ids: the first 2·64 + 1 tokens (its last
    chunk is bucket 1 alone), two past the 2048-slot local rings (3000 and
    2200 tokens: those rings wrap)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    lens = rng.integers(64, RG_MAX_PROMPT + 1, N_REQUESTS)
    lens[0], lens[1], lens[2] = 2 * PREFILL_CHUNK + 1, RG_MAX_PROMPT, 2200
    return [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]


def serial_gate(model, cfg, prompts, results, what, **ecfg):
    """``SerialAdmitEngine`` on the fleet's two shortest prompts gives
    their fleet tokens. Returns their indices."""
    from repro_torch.serving import SerialAdmitEngine

    idx = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))[:2]
    got = serve(model, cfg, [prompts[i] for i in idx], cls=SerialAdmitEngine,
                **ecfg)[0]
    same_tokens(got, [results[i] for i in idx], what)
    return idx


def recurrentgemma_path(dev):
    """(m) recurrentgemma-2b at full width and depth: quantize on the card,
    the fleet on the ring at capacity 4096 (local rings of 2048, two
    prompts past them) through CUDA graphs; solo == fleet, graph == eager,
    serial == bucketed, the paged layout refused at 4096 as the reference
    refuses it, and at capacity 2048 (prompts cut to 1900) ring == paged
    with prefix reuse off."""
    from repro_torch import configs

    cfg = configs.get_config("recurrentgemma-2b")
    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), "(m) the quantize path")
    ring = dict(capacity=RG_CAPACITY)
    prompts = rg_prompts(cfg)
    results, counts, eng, wall = fleet_run(model, cfg, prompts, **ring)
    need(counts, RING_PATH + ("rglru_scan",), "(m) recurrentgemma-2b's ring "
         "path")
    finished(results, "(m)")
    caps = sorted({c["k"].shape[1] for c in eng.state["layers"] if "k" in c})
    if caps != [cfg.window]:
        raise AssertionError(f"(m) ring sizes {caps}")
    stats = fleet_stats(eng, results, wall)
    eng = None
    gc_free()
    solo = solo_gates(model, cfg, prompts, results, "(m) solo", **ring)
    eager = serve(model, cfg, prompts, capture=False, **ring)[0]
    same_tokens(eager, results, "(m) eager vs graph")
    serial = serial_gate(model, cfg, prompts, results,
                         "(m) serial vs bucketed", **ring)
    try:
        make_engine(model, cfg, kv_layout="paged", page_size=PAGE, **ring)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("(m) a paged engine took a window narrower "
                             "than its capacity")
    if "paged KV layout requires full-capacity attention layers" not in \
            refused:
        raise AssertionError(f"(m) paged refusal: {refused}")
    gc_free()
    small = dict(capacity=RG_PAGED_CAPACITY)
    short = [p[:RG_PAGED_PROMPT] for p in prompts]
    ring_short = serve(model, cfg, short, **small)[0]
    presults, pcounts, peng, pwall = fleet_run(
        model, cfg, short, kv_layout="paged", page_size=PAGE,
        prefix_cache=True, **small)
    need(pcounts, PAGED_PATH + ("rglru_scan",), "(m) recurrentgemma-2b's "
         "paged path")
    if pcounts["chunk_attention"]:
        raise AssertionError("(m) the paged path launched the ring kernel")
    if peng._prefix_reuse:
        raise AssertionError("(m) prefix reuse on with a recurrent mixer")
    same_tokens(presults, ring_short, "(m) paged vs ring at capacity 2048")
    pstats = fleet_stats(peng, presults, pwall)
    peng = None
    gc_free()
    attn_err = check_attention_layers(cfg, dev, RG_CAPACITY)
    return dict(cfg=cfg, model=model, report=report, quant_s=quant_s,
                qcounts=qcounts, counts=counts, pcounts=pcounts,
                prompts=prompts, solo=solo, serial=serial, refused=refused,
                attn_err=attn_err, paged=pstats, **stats)


def rwkv_path(dev):
    """(n) rwkv6-3b at full width and depth: quantize on the card, the
    phase-4 fleet with its last prompt replaced by a 4000-token one at
    capacity 4096 on the ring and the paged layout through CUDA graphs
    (ring == paged); solo == fleet (the 4000-token request and the
    bucket-1 one), graph == eager, serial == bucketed; the decode state's
    bytes at capacity 4096 equal those at 1024 (O(1) in the context); the
    shared-prefix fleet on the paged layout with prefix reuse off and no
    prefill token saved."""
    import numpy as np

    from repro_torch import configs

    cfg = configs.get_config("rwkv6-3b")
    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), "(n) the quantize path")
    rng = np.random.default_rng(SEED + 11)
    prompts = make_prompts(cfg)[:N_REQUESTS - 1] + [
        rng.integers(0, cfg.vocab_size, RWKV_LONG).tolist()]
    cap = dict(capacity=RWKV_CAPACITY)
    path = ("ternary_matvec", "ternary_matmul", "rms_norm", "add_rms_norm",
            "wkv6")
    results, counts, eng, wall = fleet_run(model, cfg, prompts, **cap)
    need(counts, path, "(n) rwkv6-3b's ring path")
    if counts["chunk_attention"] or counts["chunk_attention_paged"]:
        raise AssertionError("(n) an attention-free model read a KV cache")
    finished(results, "(n) ring")
    state_bytes = {RWKV_CAPACITY: eng.memory_stats()["decode_state_bytes"]}
    stats = fleet_stats(eng, results, wall)
    eng = None
    gc_free()
    state_bytes[CAPACITY] = make_engine(
        model, cfg, capacity=CAPACITY).memory_stats()["decode_state_bytes"]
    if len(set(state_bytes.values())) != 1:
        raise AssertionError(f"(n) decode state bytes by capacity "
                             f"{state_bytes}: not O(1)")
    paged = dict(kv_layout="paged", page_size=PAGE, prefix_cache=True)
    presults, pcounts, peng, pwall = fleet_run(model, cfg, prompts, **paged,
                                               **cap)
    need(pcounts, path, "(n) rwkv6-3b's paged path")
    same_tokens(presults, results, "(n) paged vs ring")
    pstats = fleet_stats(peng, presults, pwall)
    peng = None
    gc_free()
    solo = solo_gates(model, cfg, prompts, results, "(n) solo", **cap)
    eager = serve(model, cfg, prompts, capture=False, **cap)[0]
    same_tokens(eager, results, "(n) eager vs graph")
    serial = serial_gate(model, cfg, prompts, results,
                         "(n) serial vs bucketed", **cap)
    prefix = rng.integers(0, cfg.vocab_size, SHARED_PREFIX).tolist()
    fleet = [prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(TAILS[0], TAILS[1] + 1, N_REQUESTS)]
    cold = serve(model, cfg, fleet, **paged)[0]
    warm_eng = make_engine(model, cfg, **paged)
    serve_on(warm_eng, [prefix + [1]], 1)
    before = warm_eng.prefill_tokens
    warm = serve_on(warm_eng, fleet)
    saved = sum(map(len, fleet)) - (warm_eng.prefill_tokens - before)
    if warm_eng._prefix_reuse or warm_eng.alloc.hits or saved:
        raise AssertionError(f"(n) prefix reuse with a recurrent mixer: "
                             f"{warm_eng.alloc.hits} hits, {saved} saved")
    same_tokens(warm, cold, "(n) shared-prefix fleet warm vs cold")
    warm_eng = None
    gc_free()
    return dict(cfg=cfg, model=model, report=report, quant_s=quant_s,
                qcounts=qcounts, counts=counts, pcounts=pcounts,
                prompts=prompts, solo=solo, serial=serial, saved=saved,
                state_bytes=state_bytes, paged=pstats, **stats)


def slice10_phases(gpu, dev):
    """(m)-(p): recurrentgemma-2b and rwkv6-3b at full width and depth, the
    JAX package's smoke artifacts of both, the recurrences' kernels against
    their plain versions; then the times. Returns their rows of the
    ``kernels`` line."""
    t0 = time.perf_counter()
    rerr = check_recurrences(dev)
    log(f"(p) {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    mp = recurrentgemma_path(dev)
    rcfg = mp["cfg"]
    tot = mp["report"]["__total__"]
    log(f"{gpu} | (m) recurrentgemma-2b ({rcfg.n_layers} layers, d "
        f"{rcfg.d_model}, {rcfg.n_heads}/{rcfg.n_kv_heads} heads, hd "
        f"{rcfg.head_dim}, d_ff {rcfg.d_ff}, vocab {rcfg.vocab_size}, RG-LRU "
        f"{rcfg.rglru_width} in {rcfg.rglru_blocks} blocks, window "
        f"{rcfg.window}): quantize {mp['quant_s']:.2f}s on B6 "
        f"({mp['qcounts']['ptqtp_search']} launches, {tot['n_quantized']} "
        f"kernels, {tot['compression']:.2f}x)")
    log_fleet(gpu, f"(m) ring fleet of {N_REQUESTS} "
              f"({sum(map(len, mp['prompts']))} prompt tokens, "
              f"{sorted(map(len, mp['prompts']))})", mp)
    log_fleet(gpu, f"(m) paged fleet at capacity {RG_PAGED_CAPACITY}",
              mp["paged"])
    log(f"(m) every request finished; solo == fleet for requests "
        f"{mp['solo']} (longest, bucket 1 alone); graph == eager; serial == "
        f"bucketed for requests {mp['serial']}; the paged engine at "
        f"{RG_CAPACITY} refused: {mp['refused']!r}; at {RG_PAGED_CAPACITY} "
        f"ring == paged, prefix reuse off; launches ring {mp['counts']}, "
        f"paged {mp['pcounts']}; per decode step {mp['per_step']}; "
        f"{time.perf_counter() - t0:.1f}s")
    rfill = [min(len(p), RG_CAPACITY) + MAX_NEW // 2 for p in mp["prompts"]]
    rtern = time_ternary(mp["model"], dev)
    rstep = graph_step(rcfg, mp["model"], gpu)
    del mp["model"]
    gc_free()
    rattn = time_attention_layers(rcfg, dev, rfill, RG_CAPACITY)
    n_local = len(attention_rings(rcfg, RG_CAPACITY))
    rpattn = time_paged_attention(rcfg, dev, [min(f, RG_PAGED_CAPACITY - 1)
                                              for f in rfill],
                                  capacity=RG_PAGED_CAPACITY,
                                  n_layers=n_local)
    n_rec = sum(k.startswith("rglru") for k in rcfg.layer_kinds)
    tscan = time_recurrence("rglru_scan", dev, n_rec)

    t0 = time.perf_counter()
    np_ = rwkv_path(dev)
    wcfg = np_["cfg"]
    tot = np_["report"]["__total__"]
    log(f"{gpu} | (n) rwkv6-3b ({wcfg.n_layers} layers, d {wcfg.d_model}, "
        f"{wcfg.d_model // wcfg.rwkv_head_dim} heads of "
        f"{wcfg.rwkv_head_dim}, d_ff {wcfg.d_ff}, vocab {wcfg.vocab_size}): "
        f"quantize {np_['quant_s']:.2f}s on B6 "
        f"({np_['qcounts']['ptqtp_search']} launches, {tot['n_quantized']} "
        f"kernels, {tot['compression']:.2f}x)")
    log_fleet(gpu, f"(n) ring fleet of {N_REQUESTS} "
              f"({sum(map(len, np_['prompts']))} prompt tokens, "
              f"{sorted(map(len, np_['prompts']))})", np_)
    log_fleet(gpu, "(n) paged fleet", np_["paged"])
    log(f"(n) ring == paged; solo == fleet for requests {np_['solo']}; "
        f"graph == eager; serial == bucketed for requests {np_['serial']}; "
        f"decode state bytes by capacity {np_['state_bytes']}; the "
        f"shared-prefix fleet: prefix reuse off, {np_['saved']} prefill "
        f"tokens saved; launches ring {np_['counts']}, paged "
        f"{np_['pcounts']}; per decode step {np_['per_step']}; "
        f"{time.perf_counter() - t0:.1f}s")
    wtern = time_ternary(np_["model"], dev)
    del np_["model"]
    gc_free()
    twkv = time_recurrence("wkv6", dev, wcfg.n_layers)

    t0 = time.perf_counter()
    for name in ("recurrentgemma", "rwkv6"):
        r = fixture_path(dev, name)
        gc_free()
        log(f"(o) the JAX package's {name} artifact: {r['n']} requests, "
            f"{r['tokens']} tokens equal to the JAX engine's on "
            f"{r['layouts']}, and the bucket-1 request alone; launches "
            f"{r['counts']}")
    log(f"(o) {time.perf_counter() - t0:.1f}s")

    named = [("recurrentgemma-2b B1", rtern["ternary_matvec"]),
             ("recurrentgemma-2b B3", rtern["ternary_matmul"]),
             ("recurrentgemma-2b B2 hd 256 G 10 L=1", rattn["decode"]),
             ("recurrentgemma-2b B2 hd 256 G 10 L=64", rattn["prefill"]),
             ("recurrentgemma-2b B4 hd 256 G 10 L=1", rpattn),
             ("rwkv6-3b B1", wtern["ternary_matvec"]),
             ("rwkv6-3b B3", wtern["ternary_matmul"]),
             ("rglru_scan S=1", tscan["decode"]),
             ("rglru_scan S=64", tscan["prefill"]),
             ("wkv6 S=1", twkv["decode"]),
             ("wkv6 S=64", twkv["prefill"]),
             (f"wkv6 S={WKV_LONG}", twkv["long"])]
    for name, t in named:
        lib = "—" if t["library_ms"] is None else f"{t['library_ms']:.3f} ms"
        plain = ("not timed" if t["plain_ms"] is None
                 else f"{t['plain_ms']:.3f} ms")
        log(f"{gpu} | {name}: kernel {t['ms']:.4f} ms, plain "
            f"{plain}, library {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound")
    log(f"{gpu} | recurrentgemma-2b graph decode step (launch/"
        f"profile_decode.py's dispatch, K={rstep['K']}): "
        f"{rstep['launches_per_step']:.0f} launches/step, device busy "
        f"{rstep['device_busy_ms_per_step']:.3f} ms/step, host "
        f"{rstep['host_ms_per_step']:.3f} ms/step; by column "
        f"{rstep['columns_ms']}; the graph's hand-kernel launches a step "
        f"{rstep['hand']}")

    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    src = "src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu"
    attn_src = ("src/repro_torch/kernels/chunk_attention/csrc/"
                "chunk_attention.cu")
    b1, b3 = ("src/repro/kernels/ternary_matmul/kernel.py:175",
              "src/repro/kernels/ternary_matmul/kernel.py:91")
    b2, b4 = ("src/repro/kernels/chunk_attention/kernel.py:197",
              "src/repro/kernels/chunk_attention/kernel.py:149")

    def row(name, source, replaces, counts, per_step, t, err, work):
        kernel = name.split(" ")[0]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=counts[kernel],
                    launches_per_decode_step=per_step[kernel],
                    max_abs_err=err, work=work, **{k: t[k] for k in timed})

    mm_err = max(rtern["ternary_matvec"]["max_abs_err"],
                 rtern["ternary_matmul"]["max_abs_err"])
    wmm_err = max(wtern["ternary_matvec"]["max_abs_err"],
                  wtern["ternary_matmul"]["max_abs_err"])
    return [
        row("ternary_matvec (recurrentgemma-2b)", src, b1, mp["counts"],
            mp["per_step"], rtern["ternary_matvec"], mm_err,
            f"the {rtern['ternary_matvec']['calls']} linear layers of one "
            "(m) decode step, m=8, bf16; launches are the (m) ring path's"),
        row("ternary_matmul (recurrentgemma-2b)", src, b3, mp["counts"],
            mp["per_step"], rtern["ternary_matmul"], mm_err,
            f"the {rtern['ternary_matmul']['calls']} block linear layers of "
            "one (m) prefill dispatch, m=512, bf16"),
        row("ternary_matvec (rwkv6-3b)", src, b1, np_["counts"],
            np_["per_step"], wtern["ternary_matvec"], wmm_err,
            f"the {wtern['ternary_matvec']['calls']} linear layers of one "
            "(n) decode step, m=8, bf16; launches are the (n) ring path's"),
        row("ternary_matmul (rwkv6-3b)", src, b3, np_["counts"],
            np_["per_step"], wtern["ternary_matmul"], wmm_err,
            f"the {wtern['ternary_matmul']['calls']} block linear layers of "
            "one (n) prefill dispatch, m=512, bf16"),
        row("chunk_attention (recurrentgemma-2b, hd 256)", attn_src, b2,
            mp["counts"], mp["per_step"], rattn["decode"], mp["attn_err"],
            f"the {n_local} local reads of one (m) decode step, hd 256, 1 kv "
            "head of 10 queries, rings of 2048, L=1, bf16; launches are the "
            "(m) ring path's; library: SDPA with a boolean mask"),
        row("chunk_attention_paged (recurrentgemma-2b, hd 256)", attn_src,
            b4, mp["pcounts"], mp["paged"]["per_step"], rpattn,
            rpattn["max_abs_err"],
            f"the {n_local} paged reads of one (m) decode step at capacity "
            f"{RG_PAGED_CAPACITY}, 16-slot pages, L=1; launches are the (m) "
            "paged path's; library: SDPA on the gathered ring"),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
             replaces="src/repro/models/rglru.py:117",
             launches=mp["counts"]["rglru_scan"],
             launches_per_decode_step=mp["per_step"]["rglru_scan"],
             max_abs_err=rerr["rglru_scan"],
             work=f"the {n_rec} RG-LRU gate-and-scans of one (m) decode "
                  "step (the gates' biases and sigmoids, a, its input "
                  "multiplier, the scan, the GELU and the output gate), 8 "
                  "rows of width 2560, S=1, bf16; launches are the (m) ring "
                  "path's; replaces the XLA-fused gates and lax.scan "
                  "(src/repro/models/rglru.py:117-124, _lru_scan :75), not "
                  "a Pallas kernel; no single PyTorch call computes it, so "
                  "library_ms is null; *_S64: the same 18 layers at S = 64",
             ms_S64=tscan["prefill"]["ms"],
             plain_ms_S64=tscan["prefill"]["plain_ms"],
             bound_ms_S64=tscan["prefill"]["bound_ms"],
             graph_step=dict((k, rstep[k]) for k in (
                 "launches_per_step", "device_busy_ms_per_step",
                 "host_ms_per_step", "columns_ms", "hand")),
             **{k: tscan["decode"][k] for k in timed}),
        dict(name="wkv6", route="cuda",
             source="src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             replaces="src/repro/models/rwkv6.py:128",
             launches=np_["counts"]["wkv6"],
             launches_per_decode_step=np_["per_step"]["wkv6"],
             max_abs_err=rerr["wkv6"],
             work=f"the {wcfg.n_layers} WKV steps with their group norm of "
                  "one (n) decode step, 8 rows of 40 heads of 64, S=1, "
                  "bf16; launches are the (n) ring path's; replaces an "
                  "XLA-fused lax.scan and _group_norm, not a Pallas kernel; "
                  "no single PyTorch call computes it, so library_ms is "
                  f"null; *_S64 and *_S{WKV_LONG}: the same 32 layers at "
                  f"S = 64 and S = {WKV_LONG}",
             ms_S64=twkv["prefill"]["ms"],
             plain_ms_S64=twkv["prefill"]["plain_ms"],
             bound_ms_S64=twkv["prefill"]["bound_ms"],
             **{f"ms_S{WKV_LONG}": twkv["long"]["ms"],
                f"bound_ms_S{WKV_LONG}": twkv["long"]["bound_ms"]},
             **{k: twkv["decode"][k] for k in timed}),
    ]


# ------------------------------------------------------ phase (q): slice 12
# the stub-frontend archs, (arch, layers kept: None is every layer)
STUB_ARCHS = (("musicgen-large", None), ("phi-3-vision-4.2b", 8))
STUB_DECODE = 32
# decode == prefill: the logits after 32 decode steps against one 32-step
# prefill chunk of the same embeddings from the same state, within
# STUB_TOL of each row's largest |logit|: both run every layer's ternary
# rows on one program (B1 and B3 bit for bit), but the chunk's attention
# sums its in-chunk keys in another order than the ring reads of 32 decode
# steps, and the bf16 activations round the difference at every layer (the
# bf16 logits alone are a step apart). The sound readings on the H100 are
# 1.693e-02 (musicgen-large) and 1.277e-02 (phi-3-vision-4.2b, 8 layers),
# the same in every run; 2^-5 is 1.8x the larger. The control, each row's
# decode logits against another row's chunk logits, must read above it
STUB_TOL = 2.0 ** -5


def stub_prompts(cfg, dev):
    """8 prompts of 64-600 seeded N(0, 1) frame embeddings (the first 2·64
    + 1 long, the second 600) as one (8, 600, D) tensor with their lengths,
    and the 32 decode steps' embeddings (32, 8, D); bf16 as the model's
    activations."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED + 12)
    lens = rng.integers(64, 601, N_REQUESTS)
    lens[0], lens[1] = 2 * PREFILL_CHUNK + 1, 600
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    emb = torch.randn((N_REQUESTS, int(lens.max()), cfg.d_model),
                      generator=gen, device=dev).to(torch.bfloat16)
    dec = torch.randn((STUB_DECODE, N_REQUESTS, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    return emb, [int(n) for n in lens], dec


def clone_state(state):
    return {"pos": state["pos"].clone(),
            "layers": [{k: v.clone() for k, v in c.items()}
                       for c in state["layers"]]}


def stub_run(model, cfg, emb, lens, dec, rows, dev):
    """``rows`` of the prompts through ``prefill_chunk`` in chunks of up to
    64 on a fresh ring of capacity 1024, then 32 ``decode_step`` calls on
    the next embeddings, eager. Returns each row's prefill logits, the
    decode logits (32, rows, V), the state after the prefill, and the
    prefill and decode seconds (synchronised)."""
    import torch

    from repro_torch.models import decode_step, init_decode_state, prefill_chunk

    lens = [lens[i] for i in rows]
    emb, dec = emb[rows], dec[:, rows]
    state = init_decode_state(cfg, len(rows), CAPACITY, device=dev)
    final = [None] * len(rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c0 in range(0, max(lens), PREFILL_CHUNK):
        take = [max(0, min(PREFILL_CHUNK, n - c0)) for n in lens]
        width = max(take)
        logits, state = prefill_chunk(
            model, cfg, state, emb[:, c0:c0 + width],
            torch.tensor(take, dtype=torch.int32, device=dev))
        for i, n in enumerate(lens):
            if c0 < n <= c0 + PREFILL_CHUNK:
                final[i] = logits[i]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after = clone_state(state)
    out = []
    t0 = time.perf_counter()
    for t in range(STUB_DECODE):
        logits, state = decode_step(model, cfg, state, dec[t])
        out.append(logits)
    torch.cuda.synchronize()
    return (torch.stack(final), torch.stack(out), after, prefill_s,
            time.perf_counter() - t0)


def stub_path(arch, n_layers, dev):
    """(q) one stub-frontend arch at full width (``n_layers`` of its layers,
    or all), random weights quantized on the card, served from embeddings
    eager (the engine takes token ids): the fleet of 8 rows, the launch
    counts reset just before and read just after; the longest and the
    shortest row alone give the fleet's logits bit for bit; the last decode
    step's logits within STUB_TOL of the row's largest |logit| of one
    32-step prefill chunk of the same embeddings, with equal argmax in
    every row, and each row's logits further than STUB_TOL from another
    row's chunk logits (the control: the gate tells rows apart). ``err``:
    the largest |Δ| over the row's largest |logit|; ``control``: the
    smallest such reading against another row; ``margin``: each row's top-2
    gap in the chunk's logits, over its largest |logit|."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import prefill_chunk

    cfg = configs.get_config(arch)
    if n_layers:
        cfg = cfg.scaled(n_layers=n_layers)
    model, report, quant_s, qcounts = quantize_path(cfg, dev)
    need(qcounts, ("ptqtp_search",), f"(q) {arch}'s quantize path")
    emb, lens, dec = stub_prompts(cfg, dev)
    rows = list(range(N_REQUESTS))
    stub_run(model, cfg, emb, lens, dec, rows[:1], dev)  # loads the kernels
    reset_launch_counts()
    first, steps, after, prefill_s, decode_s = stub_run(model, cfg, emb, lens,
                                                        dec, rows, dev)
    counts = launch_counts()
    need(counts, RING_PATH, f"(q) {arch} from embeddings")
    if not (torch.isfinite(first).all() and torch.isfinite(steps).all()):
        raise AssertionError(f"(q) {arch}: logits not finite")
    shortest = min(rows, key=lambda i: lens[i])
    longest = max(rows, key=lambda i: lens[i])
    for i in (longest, shortest):
        f1, s1, _, _, _ = stub_run(model, cfg, emb, lens, dec, [i], dev)
        if not (torch.equal(f1[0], first[i]) and torch.equal(s1[:, 0],
                                                             steps[:, i])):
            raise AssertionError(f"(q) {arch}: row {i} alone gave other "
                                 "logits than in the batch of 8")
    chunk, _ = prefill_chunk(
        model, cfg, after, dec.transpose(0, 1).contiguous(),
        torch.full((N_REQUESTS,), STUB_DECODE, dtype=torch.int32,
                   device=dev))
    want, got = chunk.float(), steps[-1].float()
    peak = want.abs().amax(-1)
    rel = (got - want).abs().amax(-1) / peak
    control = (got - want.roll(1, 0)).abs().amax(-1) / peak
    top2 = want.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]) / peak
    same = got.argmax(-1) == want.argmax(-1)
    if not (bool((rel <= STUB_TOL).all()) and bool(same.all())
            and bool((control > STUB_TOL).all())):
        raise AssertionError(
            f"(q) {arch}: decode vs prefill max |Δ logit| over the row's "
            f"largest {rel.tolist()} (tolerance {STUB_TOL}; the control, "
            f"against another row: {control.tolist()}), argmax equal in "
            f"rows {same.tolist()}")
    return dict(cfg=cfg, model=model, report=report, quant_s=quant_s,
                qcounts=qcounts, counts=counts, lens=lens,
                prefill_tok_s=sum(lens) / prefill_s,
                decode_ms=1e3 * decode_s / STUB_DECODE, err=float(rel.max()),
                control=float(control.min()), margin=margin.tolist(),
                solo=(longest, shortest))


def stub_phases(gpu, dev):
    """(q): musicgen-large (48 layers) and phi-3-vision-4.2b (8 of 32) at
    full width from embeddings; then B1 and B3 held against their plain
    version at every linear layer of both and timed there, and B2 at hd 64
    and hd 96. Returns their rows of the ``kernels`` line."""
    t_all = time.perf_counter()
    rows, attn = [], {}
    src = "src/repro_torch/kernels/ternary_matmul/csrc/ternary_matmul.cu"
    attn_src = ("src/repro_torch/kernels/chunk_attention/csrc/"
                "chunk_attention.cu")
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for arch, n_layers in STUB_ARCHS:
        t0 = time.perf_counter()
        q = stub_path(arch, n_layers, dev)
        cfg = q["cfg"]
        tot = q["report"]["__total__"]
        log(f"{gpu} | (q) {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, {cfg.mlp_type}, vocab {cfg.vocab_size}) from "
            f"embeddings: quantize {q['quant_s']:.2f}s on B6 "
            f"({q['qcounts']['ptqtp_search']} launches, {tot['n_quantized']} "
            f"kernels, {tot['compression']:.2f}x); prefill of "
            f"{sum(q['lens'])} embeddings ({sorted(q['lens'])}) "
            f"{q['prefill_tok_s']:.1f} tok/s; decode {q['decode_ms']:.3f} ms "
            f"a step (eager, 8 rows)")
        log(f"(q) {arch}: rows {q['solo']} (longest, shortest) alone == the "
            f"batch bit for bit; the last decode step vs a 32-step prefill "
            f"chunk: max |Δ logit| {q['err']:.3e} of the row's largest "
            f"(<= {STUB_TOL}; the control against another row: "
            f"{q['control']:.3e} at least), argmax equal in every row (the "
            f"chunk's top-2 gaps over the row's largest |logit|: "
            f"{[round(m, 5) for m in q['margin']]}, "
            f"{sum(m > 2 * q['err'] for m in q['margin'])} of {N_REQUESTS} "
            f"over twice the largest |Δ|); launches {q['counts']}; "
            f"{time.perf_counter() - t0:.1f}s")
        fill = [n + STUB_DECODE // 2 for n in q["lens"]]
        err = check_attention_layers(cfg, dev, CAPACITY)
        # every Dense layer of the model held against its plain version at
        # the path's m (the per-layer check in time_ternary), then timed
        tern = time_ternary(q["model"], dev)
        mm_err = max(tern[k]["max_abs_err"] for k in tern)
        for key, tpu, work in (
                ("ternary_matvec",
                 "src/repro/kernels/ternary_matmul/kernel.py:175",
                 f"the {tern['ternary_matvec']['calls']} linear layers of "
                 f"one {arch} decode step ({cfg.n_layers} layers), m=8, "
                 "bf16"),
                ("ternary_matmul",
                 "src/repro/kernels/ternary_matmul/kernel.py:91",
                 f"the {tern['ternary_matmul']['calls']} block linear layers "
                 f"of one {arch} prefill chunk of 8 rows ({cfg.n_layers} "
                 "layers), m=512, bf16")):
            rows.append(dict(
                name=f"{key} ({arch})", route="cuda", source=src,
                replaces=tpu, launches=q["counts"][key], max_abs_err=mm_err,
                work=f"{work}; launches are the (q) {arch} fleet's (prefill "
                     "and 32 decode steps, eager); library: F.linear on the "
                     "dequantized bf16 weights",
                **{k: tern[key][k] for k in timed}))
        del q["model"]
        gc_free()
        t = time_attention_layers(cfg, dev, fill, CAPACITY)
        attn[arch] = t
        rows.append(dict(
            name=f"chunk_attention ({arch}, hd {cfg.head_dim})", route="cuda",
            source=attn_src,
            replaces="src/repro/kernels/chunk_attention/kernel.py:197",
            launches=q["counts"]["chunk_attention"],
            max_abs_err=max(err, t["decode"]["max_abs_err"]),
            work=f"the {cfg.n_layers} attention reads of one {arch} decode "
                 f"step, hd {cfg.head_dim}, {cfg.n_kv_heads} kv heads of one "
                 "query head, rings of 1024, L=1, bf16; launches are the (q) "
                 "fleet's; library: SDPA with a boolean mask; *_L64: a "
                 "64-token prefill chunk of the same layers",
            ms_L64=t["prefill"]["ms"], plain_ms_L64=t["prefill"]["plain_ms"],
            bound_ms_L64=t["prefill"]["bound_ms"],
            library_ms_L64=t["prefill"]["library_ms"],
            **{k: t["decode"][k] for k in timed}))
        for key in ("decode", "prefill"):
            tk = t[key]
            log(f"{gpu} | (q) {arch} B2 hd {cfg.head_dim} G 1 L={tk['L']}: "
                f"kernel {tk['ms']:.4f} ms, plain {tk['plain_ms']:.3f} ms, "
                f"library {tk['library_ms']:.3f} ms, bound "
                f"{tk['bound_ms']:.4f} ms ({tk['bound_by']}) -> "
                f"{tk['bound_ms'] / tk['ms']:.1%} of bound")
    for r in (r for r in rows if r["name"].startswith("ternary")):
        log(f"{gpu} | (q) {r['name']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) -> "
            f"{r['bound_ms'] / r['ms']:.1%} of bound")
    log(f"(q) {time.perf_counter() - t_all:.1f}s")
    return rows


# ---------------------------------------------------- phase (t): slice 14
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 6, 1e-3
RESUME_LAYERS, RESUME_STEPS, RESUME_AT = 2, 4, 2
# stated tolerances of the norm's backward kernels against the plain
# backward, each relative to the tensor's largest |value|: f32 1e-5 (dx;
# dscale 1e-4: 32-row tiles summed in another order than torch.sum's), bf16
# one bf16 step (2^-7)
NORM_BWD_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
NORM_BWD_DSCALE_F32 = 1e-4
# stated tolerance of the dense layers' 128-row blocks (y, dx, dw) against
# the f32 product of the same bf16 inputs, relative to its element (plus
# 1e-5 of the largest for the f32 sums' order): one bf16 rounding (8
# significand bits) moves an element by at most 2^-8 of it
FIXED_ROWS_TOL = 2.0 ** -8
# hand kernels the training path must launch: the norms forward (twice, with
# remat) and backward
TRAIN_PATH = ("rms_norm", "add_rms_norm", "rms_norm_bwd", "add_rms_norm_bwd")
# operations of the norm's backward an element: x², ĝ = dy·s and ĝ·x
# (2 FMAs as 2 each, 1), then x·r, ·mean, −, ·r (4), dscale's dy·(x·r) and
# its sum (3), the residual add (1)
NORM_BWD_OPS = 13


def check_norm_backward(dev):
    """The norm's backward kernels, alone and with add_rms_norm's residual
    gradient, against the plain backward written out at every width of
    ``FUSED_NORM_WIDTHS`` (16384: the forward's two-pass width), bf16 and
    f32, on the training shape's 8 x 512 rows; a second call gives the same
    bits. Returns the largest abs err."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref

    gen = torch.Generator(device=dev).manual_seed(14)
    worst = 0.0
    for d in FUSED_NORM_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x, dy, dres = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, d),
                                       generator=gen, device=dev).to(dtype)
                           for _ in range(3))
            scale = (1 + 0.1 * torch.randn((d,), generator=gen,
                                           device=dev)).to(dtype)
            for res in (None, dres):
                got = ops.rms_norm_backward(scale, x, dy, 1e-6, res)
                want = ref.rms_norm_backward_plain(scale, x, dy, 1e-6, res)
                again = ops.rms_norm_backward(scale, x, dy, 1e-6, res)
                torch.cuda.synchronize()
                what = (f"{'add_' if res is not None else ''}rms_norm "
                        f"backward d={d} {name}")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what}: a second call gave other "
                                         "bits")
                for part, g, w in (("dx", got[0], want[0]),
                                   ("dscale", got[1], want[1])):
                    g, w = g.float(), w.float()
                    err = float((g - w).abs().max()
                                / w.abs().max().clamp_min(1e-30))
                    tol = NORM_BWD_TOL[name]
                    if part == "dscale" and dtype == torch.float32:
                        tol = NORM_BWD_DSCALE_F32
                    if not err <= tol:
                        raise AssertionError(f"{what}: {part} err {err:.3e} "
                                             f"of the largest > {tol}")
                    worst = max(worst, float((g - w).abs().max()))
    log(f"(t) norm backward at d {FUSED_NORM_WIDTHS}, bf16 and f32, "
        f"{TRAIN_BATCH}x{TRAIN_SEQ} rows, alone and with the residual "
        f"gradient: == plain backward (max abs err {worst:.2e}; tolerances "
        f"{NORM_BWD_TOL} of the largest, f32 dscale {NORM_BWD_DSCALE_F32}); "
        "a second call gives the same bits")
    return worst


def make_trainer(cfg, dev, steps, ckpt=None, log_fn=None):
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamW
    from repro_torch.training import Trainer, TrainerConfig

    return Trainer(cfg, AdamW(lr=TRAIN_LR),
                   DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                              seed=SEED),
                   TrainerConfig(total_steps=steps, log_interval=1,
                                 ckpt_dir=ckpt, ckpt_interval=10 ** 9,
                                 seed=SEED),
                   log_fn=log_fn or (lambda msg: None), device=dev)


def event_ms(fn, reps):
    """Milliseconds per call of ``fn`` between two CUDA events around
    ``reps`` calls (after one warm call): for work whose kernels run long
    beside the host's launches (autograd through large products)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def train_full(cfg, dev, steps=TRAIN_STEPS, tag="(t)"):
    """(t): qwen2-1.5b at full width and depth trained on the card through
    ``Trainer`` (B 8, S 512, remat full, bf16), the launch counts reset just
    before and read just after; then one more step under the profiler
    (kernels launched and device-busy ms a step). (u) trains the recurrent
    archs the same way."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build, launch_counts, reset_launch_counts

    trainer = make_trainer(cfg, dev, steps)
    state = trainer.init_state()
    n_params = sum(p.numel() for p in state["params"].parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state=state)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]
    times = [h["time_s"] for h in trainer.history]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag} non-finite losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} the loss did not fall: {losses}")
    batch = trainer._batch(trainer.loader.batch_at(steps))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer._step_fn(state, batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and _build.device_us(e) > 0]
    busy = sum(_build.device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_build.device_us, reverse=True)[:6]
    return dict(losses=losses, times=times, wall=wall, counts=counts,
                peak=peak, n_params=n_params, state=state,
                launches=sum(e.count for e in kernels), busy_ms=busy,
                top=[(e.key[:60], _build.device_us(e) / 1e3, e.count)
                     for e in top])


def kernels_a_call(fn, most, what):
    """The kernels one call of ``fn`` launches (``_build.graph_kernels``:
    its CUDA graph's kernel nodes); fails above ``most``."""
    from repro_torch.kernels import _build

    n = _build.graph_kernels(fn)
    if not 0 < n <= most:
        raise AssertionError(f"{what}: {n} kernels a call, not 1..{most}")
    return n


def time_norm_backward(cfg, dev, per_step):
    """The norm backwards of one training step at the training shape
    (8 x 512 rows of d 1536, bf16), as many of each as a step launches
    (``per_step``): those with no residual gradient (``rms_norm_bwd``: the
    norm after the embedding, and the last norm, whose residual stream is
    unused) and those with it (``add_rms_norm_bwd``); beside each the
    plain backward, the bound and PyTorch's own backward of ``F.rms_norm``
    (``aten._fused_rms_norm_backward``, plus the residual add)."""
    import torch

    from repro_torch.kernels.rms_norm import ops, ref

    d, eps = cfg.d_model, cfg.norm_eps
    gen = torch.Generator(device=dev).manual_seed(15)
    x, dy, dres = (torch.randn((TRAIN_BATCH * TRAIN_SEQ, d), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for _ in range(3))
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device=dev)).to(
        torch.bfloat16)
    aten = torch.ops.aten
    lib = getattr(aten, "_fused_rms_norm_backward", None)
    rstd = (aten._fused_rms_norm(x, [d], w, eps)[1] if lib is not None
            else None)
    n = x.numel()

    def lib_call(add):
        dx, dw = lib(dy, x, [d], rstd, w, [True, True])
        return (dx + dres if add else dx), dw

    out = {}
    for name, res in (("rms_norm_bwd", None), ("add_rms_norm_bwd", dres)):
        calls = per_step[name]
        nbytes = calls * ((4 if res is not None else 3) * n * 2 + 2 * d * 2)
        b = bound_ms(nbytes, calls * NORM_BWD_OPS * n, F32_FLOPS)
        out[name] = dict(
            ms=device_ms(lambda: [ops.rms_norm_backward(w, x, dy, eps, res)
                                  for _ in range(calls)], 5),
            plain_ms=device_ms(lambda: [ref.rms_norm_backward_plain(
                w, x, dy, eps, res) for _ in range(calls)], 3),
            library_ms=(None if lib is None else device_ms(
                lambda: [lib_call(res is not None) for _ in range(calls)],
                5)),
            bound_ms=b[0], bound_by=b[1], calls=calls,
            kernels_a_call=kernels_a_call(
                lambda: ops.rms_norm_backward(w, x, dy, eps, res), 2, name))
    return out


def fixed_rows_grads(cfg, dev):
    """The dense layers' fixed 128-row blocks in a training step, at every
    distinct dense shape of ``cfg`` and 8 x 512 rows, bf16: y, dx and dw
    of ``linear_fixed_rows`` (y and dx by the blocks, dw by one product
    over all rows) held against the f32 product of the same inputs, each
    element within ``FIXED_ROWS_TOL`` of it plus 1e-5 of the largest (one
    bf16 rounding of an f32-accumulated sum). Beside them, as a share of
    the largest, the worst error of the blocks, of one ``F.linear`` and,
    for dw, of the blocks' 32 dw summed in bf16 (what autograd of the
    blocked forward gave before dw became one product), and the share of
    one ``F.linear``'s elements beyond the tolerance. Then forward +
    backward timed (CUDA events; these products run long beside the
    host's launches) for the lm_head and the MLP's down projection."""
    import torch

    from repro_torch.models.common import DENSE_ROW_BLOCK, linear_fixed_rows

    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(16)
    hd = cfg.head_dim
    shapes = {"lm_head": (cfg.vocab_size, cfg.d_model),
              "attn_q": (cfg.n_heads * hd, cfg.d_model),
              "attn_kv": (cfg.n_kv_heads * hd, cfg.d_model),
              "attn_o": (cfg.d_model, cfg.n_heads * hd),
              "mlp_wi": (cfg.d_ff, cfg.d_model),
              "mlp_wo": (cfg.d_model, cfg.d_ff)}
    rows = TRAIN_BATCH * TRAIN_SEQ
    out, errs = {}, {}
    for name, (n_out, d_in) in shapes.items():
        x = torch.randn((rows, d_in), generator=gen,
                        device=dev).to(torch.bfloat16).requires_grad_()
        w = (torch.randn((n_out, d_in), generator=gen, device=dev)
             * d_in ** -0.5).to(torch.bfloat16).requires_grad_()
        dy = torch.randn((rows, n_out), generator=gen,
                         device=dev).to(torch.bfloat16)

        def step(f, with_y=False):
            y = f(x, w)
            grads = torch.autograd.grad(y, (x, w), dy)
            return (y.detach(),) + grads if with_y else grads

        got = step(linear_fixed_rows, True)
        one = step(F.linear, True)
        errs[name] = {}
        with torch.no_grad():
            xf, wf, dyf = x.float(), w.float(), dy.float()
            for part, g, o, f32 in zip(
                    ("y", "dx", "dw"), got, one,
                    (lambda: xf @ wf.t(), lambda: dyf @ wf,
                     lambda: dyf.t() @ xf)):
                exact = f32()
                big = exact.abs().max()
                tol = FIXED_ROWS_TOL * exact.abs() + 1e-5 * big
                bad = int(((g.float() - exact).abs() > tol).sum())
                if bad:
                    raise AssertionError(
                        f"(t) {name} {part}: {bad} elements of the 128-row "
                        "blocks' product differ from the f32 product by "
                        f"more than {FIXED_ROWS_TOL} of it")
                e = errs[name][part] = {
                    "blocks": float((g.float() - exact).abs().max() / big),
                    "one": float((o.float() - exact).abs().max() / big),
                    "one_beyond": float(((o.float() - exact).abs() > tol)
                                        .float().mean())}
                if part == "dw":
                    blocked = None
                    for i in range(0, rows, DENSE_ROW_BLOCK):
                        blk = slice(i, i + DENSE_ROW_BLOCK)
                        term = dy[blk].t() @ x[blk]
                        blocked = term if blocked is None else blocked + term
                    e["bf16_sum"] = float((blocked.float() - exact).abs()
                                          .max() / big)
                    del blocked
                del exact, tol
            del xf, wf, dyf
        del got, one
        if name in ("lm_head", "mlp_wo"):
            out[name] = dict(
                fixed_ms=event_ms(lambda: step(linear_fixed_rows), 3),
                one_ms=event_ms(lambda: step(F.linear), 3))
        del x, w, dy
    return out, errs


def resume_path(cfg, dev, tmp, layers=RESUME_LAYERS, tag="(t)"):
    """(t): the 2-layer full-width copy trained 4 steps straight, and again
    preempted (``guard.request()``) after step 2, resumed from its
    checkpoint to step 4: the losses and every tensor of the state equal
    the uninterrupted run's bit for bit. Returns the run's numbers; the
    step-4 checkpoint stays in ``tmp``. (u) runs it on the recurrent archs
    (``layers`` of them)."""
    import torch

    from repro_torch.artifacts.format import iter_tree_leaves
    from repro_torch.runtime import PreemptionGuard, latest_step
    from repro_torch.training import state_tree

    small = cfg.scaled(n_layers=layers)
    whole = make_trainer(small, dev, RESUME_STEPS)
    s_whole = whole.fit(state=whole.init_state())
    guard = PreemptionGuard(signals=())
    first = make_trainer(small, dev, RESUME_STEPS, str(tmp),
                         lambda m: f"step {RESUME_AT} " in m
                         and guard.request())
    saves, loads = [], []

    def timed(fn, into):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            into.append(time.perf_counter() - t0)
            return out
        return call

    first.ckpt.save = timed(first.ckpt.save, saves)
    first.fit(state=first.init_state(), guard=guard)
    if latest_step(tmp) != RESUME_AT or len(first.history) != RESUME_AT:
        raise AssertionError(f"{tag} preemption: {len(first.history)} steps, "
                             f"checkpoint {latest_step(tmp)}")
    second = make_trainer(small, dev, RESUME_STEPS, str(tmp))
    second.ckpt.save = timed(second.ckpt.save, saves)
    second.ckpt.restore_latest = timed(second.ckpt.restore_latest, loads)
    s_res = second.fit()
    steps = [h["step"] for h in first.history + second.history]
    losses = [h["loss"] for h in first.history + second.history]
    want = [h["loss"] for h in whole.history]
    if steps != list(range(1, RESUME_STEPS + 1)) or losses != want:
        raise AssertionError(f"{tag} resumed losses {losses} (steps {steps}) "
                             f"!= uninterrupted {want}")
    a, b = (dict(iter_tree_leaves(state_tree(s, small)))
            for s in (s_whole, s_res))
    apart = [k for k in a if not torch.equal(a[k], b[k])]
    if apart or sorted(a) != sorted(b):
        raise AssertionError(f"{tag} resumed state differs from the "
                             f"uninterrupted run's at {apart[:5]}")
    nbytes = sum(p.stat().st_size for p in Path(tmp).rglob("*.npz"))
    n = sum(p.numel() for p in s_res["params"].parameters())
    return dict(cfg=small, losses=losses, saves=saves, loads=loads,
                leaves=len(a), ckpt_bytes=nbytes // 2, n_params=n,
                params=s_res["params"])


def quantize_serve_path(rp, dev, tmp, tag="(t)"):
    """(t): the resumed run's last checkpoint through ``launch/quantize.py
    --from-checkpoint`` on the card (B6; the config from the checkpoint's
    manifest), its FP leaves byte-equal to the trained model's; then 8
    greedy requests served from the artifact on warmed graphs (B1, B3, B2
    launched), two of them alone with their fleet tokens."""
    import contextlib
    import io

    import torch

    from repro_torch.artifacts import load_artifact, load_model
    from repro_torch.artifacts.format import iter_tree_leaves
    from repro_torch.convert import to_reference_tree
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import quantize as quantize_launch

    art = Path(tmp) / "artifact"
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        quantize_launch.main(["--from-checkpoint", str(tmp), "--out",
                              str(art), "--device", str(dev)])
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    qcounts = launch_counts()
    need(qcounts, ("ptqtp_search",), f"{tag} quantize --from-checkpoint")
    tree, manifest = load_artifact(art)
    stored = dict(iter_tree_leaves(tree))
    trained = dict(iter_tree_leaves(to_reference_tree(rp["params"],
                                                      rp["cfg"])))
    fp = [p for p, r in manifest["tensors"].items() if r["kind"] == "fp"]
    for path in fp:
        if not torch.equal(stored[path], trained[path].cpu()):
            raise AssertionError(f"{tag} artifact leaf {path} differs from the "
                                 "trained model's")
    model, cfg, _ = load_model(art, device=dev)
    if cfg.n_layers != rp["cfg"].n_layers:
        raise AssertionError(f"{tag} the artifact's config has "
                             f"{cfg.n_layers} layers")
    prompts = make_prompts(cfg)
    results, counts, eng, wall = fleet_run(model, cfg, prompts)
    need(counts, ("ternary_matvec", "ternary_matmul", "chunk_attention"),
         f"{tag} serving the checkpoint's artifact")
    finished(results, f"{tag} serving the checkpoint's artifact")
    stats = fleet_stats(eng, results, wall)
    del eng
    longest, one = solo_gates(model, cfg, prompts, results,
                              f"{tag} serving the checkpoint's artifact")
    return dict(quant_s=quant_s, qcounts=qcounts, counts=counts,
                stats=stats, solo=(longest, one), fp=len(fp),
                n_quantized=manifest["stats"]["n_quantized"],
                nbytes=manifest["stats"]["total_bytes"],
                printed=printed.getvalue().count("[quantize] #"))


def training_phases(gpu, dev, step_seconds):
    """(t): training on the card (the module docstring). Returns its rows
    of the ``kernels`` line; its steady step seconds go into
    ``step_seconds``."""
    import shutil
    import tempfile

    import torch

    from repro_torch import configs

    t_all = time.perf_counter()
    cfg = configs.get_config("qwen2-1.5b")
    err = check_norm_backward(dev)
    log(f"(t) {time.perf_counter() - t_all:.1f}s in")
    gc_free()
    tr = train_full(cfg, dev)
    need(tr["counts"], TRAIN_PATH, "(t) the training path")
    steady = tr["times"][1:]
    step_s = sum(steady) / len(steady)
    step_seconds["(t) qwen2-1.5b"] = (cfg, step_s)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"{gpu} | (t) qwen2-1.5b trained at full width and depth "
        f"({tr['n_params']} params, bf16, remat full, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, AdamW lr {TRAIN_LR}): losses "
        f"{[round(v, 4) for v in tr['losses']]}; step seconds "
        f"{[round(v, 3) for v in tr['times']]} (the first builds and "
        f"warms); steady {step_s:.3f} s a step = {tokens / step_s:.0f} "
        f"tokens/s; peak memory {tr['peak']} bytes; fit {tr['wall']:.1f}s")
    log(f"{gpu} | (t) launches of the {TRAIN_STEPS} steps: "
        f"{ {k: v for k, v in tr['counts'].items() if v} }; one more step "
        f"under the profiler: {tr['launches']} kernels, device busy "
        f"{tr['busy_ms']:.1f} ms; top: "
        + "; ".join(f"{k} {ms:.1f} ms x{c}" for k, ms, c in tr["top"])
        + f"; (t) {time.perf_counter() - t_all:.1f}s in")
    state = tr.pop("state")
    del state
    gc_free()
    per_step = {k: tr["counts"][k] // TRAIN_STEPS
                for k in ("rms_norm_bwd", "add_rms_norm_bwd")}
    norm = time_norm_backward(cfg, dev, per_step)
    fixed, fixed_errs = fixed_rows_grads(cfg, dev)
    for name, t in norm.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"{gpu} | (t) {name} x {t['calls']} (8 x 512 rows of "
            f"{cfg.d_model}, bf16): kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound; "
            f"{t['kernels_a_call']} kernels a call")
    log(f"(t) dense layers at 4096 rows, bf16: the 128-row blocks' y, dx "
        f"and dw within {FIXED_ROWS_TOL} of the f32 product (+ 1e-5 of the "
        f"largest) at {list(fixed_errs)}; worst error of the largest, "
        "blocks / one F.linear (its share beyond the tolerance) / the "
        "blocks' dw summed in bf16: "
        + "; ".join(
            f"{k} " + ", ".join(
                f"{part} {e['blocks']:.2e} / {e['one']:.2e} "
                f"({e['one_beyond']:.1e})"
                + (f" / {e['bf16_sum']:.2e}" if part == "dw" else "")
                for part, e in v.items())
            for k, v in fixed_errs.items()))
    log(f"{gpu} | (t) forward + backward at 4096 rows, bf16 (CUDA events): "
        + "; ".join(f"{k}: 128-row blocks {v['fixed_ms']:.3f} ms, one "
                    f"F.linear {v['one_ms']:.3f} ms"
                    for k, v in fixed.items())
        + f"; (t) {time.perf_counter() - t_all:.1f}s in")
    gc_free()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        from repro_torch.models.transformer import Transformer
        n = sum(p.numel() for p in Transformer(
            cfg.scaled(n_layers=RESUME_LAYERS), dtype=torch.bfloat16,
            device="meta").parameters())
        # two checkpoints (bf16 params, f32 moments: 10 bytes a param) and
        # the artifact (under 2 bytes a param)
        need_bytes = 2 * 10 * n + 2 * n
        free = shutil.disk_usage(tmp).free
        if free < need_bytes:
            raise AssertionError(f"(t) {free} bytes free under {tmp}; the "
                                 f"resume gate needs {need_bytes}")
        t0 = time.perf_counter()
        rp = resume_path(cfg, dev, tmp)
        log(f"{gpu} | (t) {RESUME_LAYERS}-layer full-width copy "
            f"({rp['n_params']} params): preempted after step {RESUME_AT}, "
            f"resumed to {RESUME_STEPS}: losses "
            f"{[round(v, 4) for v in rp['losses']]} and all {rp['leaves']} "
            f"state tensors equal the uninterrupted run's bit for bit; "
            f"checkpoint {rp['ckpt_bytes']} bytes, saves "
            f"{[round(s, 2) for s in rp['saves']]} s, load "
            f"{[round(s, 2) for s in rp['loads']]} s; "
            f"{time.perf_counter() - t0:.1f}s")
        gc_free()
        t0 = time.perf_counter()
        qs = quantize_serve_path(rp, dev, tmp)
        del rp
        st = qs["stats"]
        log(f"{gpu} | (t) launch/quantize.py --from-checkpoint: "
            f"{qs['n_quantized']} kernels on B6 "
            f"({qs['qcounts']['ptqtp_search']} launches) in "
            f"{qs['quant_s']:.2f}s, {qs['nbytes']} bytes; {qs['fp']} FP "
            f"leaves equal the trained model's; served {N_REQUESTS} "
            f"requests from it: launches {qs['counts']}; requests "
            f"{qs['solo']} alone == fleet; TTFT median "
            f"{st['ttft'][len(st['ttft']) // 2]:.3f}s; decode "
            f"{st['decode_tok'] / st['decode_s']:.1f} tok/s; "
            f"{time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"(t) {time.perf_counter() - t_all:.1f}s")
    src = "src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu"
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    work = {"rms_norm_bwd": f"the {per_step['rms_norm_bwd']} norm "
                            "backwards with no residual gradient (after "
                            "the embedding; the last norm)",
            "add_rms_norm_bwd": f"the {per_step['add_rms_norm_bwd']} "
                                "norm backwards with the residual stream's "
                                "gradient"}
    return [dict(
        name=name, route="cuda", source=src,
        replaces="src/repro/models/common.py:78",
        launches=tr["counts"][name],
        launches_per_train_step=tr["counts"][name] / TRAIN_STEPS,
        max_abs_err=err,
        work=f"{work[name]} of one qwen2-1.5b training step (8 x 512 rows "
             "of 1536, bf16), backward; replaces jax.grad of the "
             "reference's rms_norm (XLA, no Pallas kernel); launches are "
             "the full-depth training run's; library: "
             "aten._fused_rms_norm_backward (F.rms_norm's backward), plus "
             "the residual gradient's add for the fused ones",
        kernels_a_call=norm[name]["kernels_a_call"],
        **{k: norm[name][k] for k in timed}) for name in work]


# ------------------------------------------- phase (u): slice 15
# the sequence lengths the backward kernels are held at: (m)'s prefill
# chunk, a ragged tile (six 32-step tiles and an eighth of 8) and the
# training shape's 512
RECURRENT_BWD_S = (PREFILL_CHUNK, WKV_LONG, TRAIN_SEQ)
# stated tolerances of the recurrences' backward kernels against their
# plain backwards, each relative to the gradient tensor's largest |value|:
# f32 sums in other orders (the reverse chains over 512 steps, dlam, du and
# dscale over 4096 rows and steps); bf16 one rounding of an intermediate
# that lands on the other side of a bf16 boundary (2^-8 of it) carried
# through at most two more bf16 roundings
RECURRENT_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
# the recurrent archs trained at full width and depth, and their copies
# preempted and resumed (recurrentgemma-2b's copy is its first period, 3
# layers: with 2 it would hold no attention layer and serving its artifact
# would launch no B2)
RECURRENT_TRAIN_STEPS = 4
RECURRENT_RESUME_LAYERS = {"recurrentgemma-2b": 3, "rwkv6-3b": 2}
MOE_DET_LAYERS, MOE_DET_STEPS = 2, 2
# operations of the RG-LRU's backward a (row, step, channel), each
# transcendental one: the gates again (≈ 20, as in GATED_OPS), the chain's
# recompute (2) and reverse chain (2), the GELU's backward (≈ 14), the
# gradients' products and sums (≈ 22)
GATED_BWD_OPS = 60
# operations of the WKV's backward that the function needs, an element of a
# head's state and step: the state's recompute (k·v, then w·S + kv: 3), dr
# (2), the carried gradient of the state (w·D + r·dy: 3), dw (2), dk (2)
# and dv (2). The u-bonus terms are rank 1 (r_i k_i dy_j v_j), so they and
# the group norm's backward cost a channel, not an element, a head and
# step: the u-terms (dy·v, Σ r·u·k, du and the shares of dr, dk and dv: 15)
# and the norm (its statistics again 4, x̂ 2, dscale 2, the input's
# gradient 8)
WKV_BWD_OPS = 14
WKV_BWD_VEC_OPS = 31


def plain_calls():
    """Count the calls of the recurrences' plain versions, forward and
    backward (the ops modules call them through their ``ref`` module): a
    dict of counts, and a function that puts the originals back."""
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    calls, saved = {}, []
    for mod, name in ((scan_ref, "rglru_gated_scan_plain"),
                      (scan_ref, "rglru_gated_scan_backward_plain"),
                      (wkv_ref, "wkv6_plain"),
                      (wkv_ref, "wkv6_backward_plain")):
        fn = getattr(mod, name)
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        saved.append((mod, name, fn))
        setattr(mod, name, counted)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return calls, restore


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def _bwd_gate(what, names, got, again, want, dtype, reduced):
    """Each gradient within ``RECURRENT_BWD_TOL`` of the plain backward's
    (relative to its largest); a second call gives the same bits, the
    ``reduced`` ones (summed over rows and steps) included. Returns the
    largest abs err and the worst relative one."""
    import torch

    tol = RECURRENT_BWD_TOL[str(dtype).split(".")[-1]]
    worst_abs = worst_rel = 0.0
    for name, g, a, w in zip(names, got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"{what}: {name} differs at a second call"
                                 + (" (a reduced gradient)" if name in reduced
                                    else ""))
        err = _rel_err(g, w)
        if not err <= tol:
            raise AssertionError(f"{what}: {name} err {err:.3e} of the "
                                 f"largest > {tol}")
        worst_rel = max(worst_rel, err)
        worst_abs = max(worst_abs, float((g.float() - w.float()).abs().max()))
    return worst_abs, worst_rel


def check_recurrent_backward(dev):
    """(u) ``rglru_scan_bwd`` and ``wkv6_bwd`` against their plain
    backwards written out: recurrentgemma-2b's RG-LRU (8 rows of 2560 in
    10 blocks) and rwkv6-3b's WKV (8 rows, 40 heads of 64), at S =
    ``RECURRENT_BWD_S`` with ragged and idle rows, bf16 and f32, from a
    random state; the forward kernel writes the checkpoints the backward
    reads, and its output is held bit for bit against the forward without
    them. A second call gives the same bits, the reduced gradients (dba,
    dbx, dlam; du, dscale) too. Returns {kernel: (max abs err, worst
    relative err)}."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    gen = torch.Generator(device=dev).manual_seed(25)
    heads = [(c.d_model // c.rwkv_head_dim, c.rwkv_head_dim)
             for c in (configs.get_config("rwkv6-3b"),
                       configs.get_smoke_config("rwkv6-3b"))]
    worst = {"rglru_scan_bwd": (0.0, 0.0), "wkv6_bwd": (0.0, 0.0)}

    def fold(name, e):
        worst[name] = tuple(max(a, b) for a, b in zip(worst[name], e))

    for s in RECURRENT_BWD_S:
        for dtype in (torch.bfloat16, torch.float32):
            what = f"(u) rglru_scan_bwd S={s} {str(dtype).split('.')[-1]}"
            args, route = gated_inputs(s, dtype, gen, dev)
            ops_args = route.operands(args)
            ya, yx, ba, bx, c, g, lam, h, lengths = ops_args
            b, _, r = c.shape
            ckpt = torch.empty((b, -(-s // 32), r), dtype=torch.float32,
                               device=dev)
            out = scan_ops.rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam,
                                                 h.clone(), lengths, ckpt)
            plain_out = scan_ops.rglru_gated_scan_cuda(
                ya, yx, ba, bx, c, g, lam, h.clone(), lengths)
            if not torch.equal(out, plain_out):
                raise AssertionError(f"{what}: the forward with checkpoints "
                                     "differs from the forward without")
            dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            got, again = (scan_ops.rglru_gated_scan_backward_cuda(
                ya, yx, ba, bx, c, g, lam, ckpt, lengths, dout)
                for _ in range(2))
            want = scan_ref.rglru_gated_scan_backward_plain(
                ya, yx, ba, bx, c, g, lam, h, lengths, dout)
            torch.cuda.synchronize()
            fold("rglru_scan_bwd", _bwd_gate(
                what, ("dya", "dyx", "dba", "dbx", "dc", "dg", "dlam"), got,
                again, want, dtype, ("dba", "dbx", "dlam")))
            del args, ops_args, got, again, want
        for dtype, (nh, hd) in ((d, h) for d in (torch.bfloat16,
                                                 torch.float32)
                                for h in heads):
            what = (f"(u) wkv6_bwd S={s} {str(dtype).split('.')[-1]} "
                    f"{nh} heads of {hd}")
            r_, k_, v_, w_, u_, st, lengths, sc = wkv_inputs(
                SLOTS, s, nh, hd, dtype, gen, dev)
            ckpt = torch.empty((SLOTS, nh, -(-s // 32), hd, hd),
                               dtype=torch.float32, device=dev)
            yraw = torch.empty((SLOTS, s, nh * hd), dtype=dtype, device=dev)
            out = wkv_ops.wkv6_cuda(r_, k_, v_, w_, u_, st.clone(), lengths,
                                    sc, ckpt=ckpt, yraw=yraw)
            if not torch.equal(out, wkv_ops.wkv6_cuda(
                    r_, k_, v_, w_, u_, st.clone(), lengths, sc)):
                raise AssertionError(f"{what}: the forward with checkpoints "
                                     "differs from the forward without")
            dout = torch.randn(out.shape, generator=gen, device=dev).to(dtype)
            got, again = (wkv_ops.wkv6_backward_cuda(
                r_, k_, v_, w_, u_, lengths, sc, ckpt, yraw, dout)
                for _ in range(2))
            want = wkv_ref.wkv6_backward_plain(r_, k_, v_, w_, u_, st,
                                               lengths, sc, dout)
            torch.cuda.synchronize()
            fold("wkv6_bwd", _bwd_gate(
                what, ("dr", "dk", "dv", "dw", "du", "dscale"), got, again,
                want, dtype, ("du", "dscale")))
            del got, again, want, ckpt, yraw
            gc_free()
    log(f"(u) rglru_scan_bwd (R 2560 in 10 blocks) and wkv6_bwd "
        f"({' and '.join(f'{n} heads of {d}' for n, d in heads)}) == their "
        f"plain backwards at S = {RECURRENT_BWD_S}, bf16 "
        f"and f32, 8 rows with ragged and idle ones, from a random state "
        f"(worst abs / relative errors: rglru_scan_bwd "
        f"{worst['rglru_scan_bwd'][0]:.2e} / {worst['rglru_scan_bwd'][1]:.2e}, "
        f"wkv6_bwd {worst['wkv6_bwd'][0]:.2e} / {worst['wkv6_bwd'][1]:.2e}; "
        f"tolerances {RECURRENT_BWD_TOL} of each tensor's largest); a second "
        "call gives the same bits, the reduced gradients too; the forwards "
        "with checkpoints equal those without bit for bit")
    return worst


def time_recurrent_backward(dev, per_step):
    """The recurrences' backward kernels as one training step of (u) runs
    them (``per_step`` calls each, at B 8 × S 512, bf16, every row full):
    kernel ms (the calls captured into a graph), the plain backward's ms
    (CUDA events, one layer's call times the calls: its graph would hold
    thousands of launches and every state), and the bound (bytes: every
    input read once, every gradient written once; operations: f32 at 67
    TFLOP/s). No single PyTorch call computes either: library none.
    ``rglru_scan_bwd`` also reports its kernel's registers a thread, shared
    bytes a block and blocks an SM (``ops.backward_resources``)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels.rglru_scan import ops as scan_ops
    from repro_torch.kernels.rglru_scan import ref as scan_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref

    gen = torch.Generator(device=dev).manual_seed(26)
    s, bf16 = TRAIN_SEQ, torch.bfloat16
    out = {}
    # the RG-LRU: ya, yx, c, g and dout read, dya, dyx, dc and dg written
    # (bf16), the checkpoints read
    calls = per_step["rglru_scan_bwd"]
    args, route = gated_inputs(s, bf16, gen, dev)
    args[RECURRENCES["rglru_scan"]["lengths"]].fill_(s)
    ya, yx, ba, bx, c, g, lam, h, lengths = route.operands(args)
    b, _, r = c.shape
    ckpt = torch.empty((b, -(-s // 32), r), dtype=torch.float32, device=dev)
    scan_ops.rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h.clone(),
                                   lengths, ckpt)
    dout = torch.randn(c.shape, generator=gen, device=dev).to(bf16)
    n = b * s * r
    nbytes = 9 * 2 * n + ckpt.numel() * 4 + 6 * 2 * r
    bound, by = bound_ms(calls * nbytes, calls * GATED_BWD_OPS * n,
                         F32_FLOPS)
    out["rglru_scan_bwd"] = dict(
        ms=device_ms(lambda: [scan_ops.rglru_gated_scan_backward_cuda(
            ya, yx, ba, bx, c, g, lam, ckpt, lengths, dout)
            for _ in range(calls)], 3),
        plain_ms=calls * event_ms(lambda: scan_ref.
                                  rglru_gated_scan_backward_plain(
                                      ya, yx, ba, bx, c, g, lam, h, lengths,
                                      dout), 1),
        library_ms=None, bound_ms=bound, bound_by=by, calls=calls,
        bytes=calls * nbytes, kernels_a_call=kernels_a_call(
            lambda: scan_ops.rglru_gated_scan_backward_cuda(
                ya, yx, ba, bx, c, g, lam, ckpt, lengths, dout), 2,
            "rglru_scan_bwd"),
        resources=scan_ops.backward_resources(bf16))
    del args, ya, yx, c, g, dout, ckpt
    gc_free()
    # the WKV: r, k, v, dout and the readout read in bf16, w f32, the
    # checkpoints f32; dr, dk, dv written in bf16, dw f32
    calls = per_step["wkv6_bwd"]
    rw = configs.get_config("rwkv6-3b")
    nh, hd = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    r_, k_, v_, w_, u_, st, lengths, sc = wkv_inputs(SLOTS, s, nh, hd, bf16,
                                                     gen, dev)
    lengths.fill_(s)
    ckpt = torch.empty((SLOTS, nh, -(-s // 32), hd, hd), dtype=torch.float32,
                       device=dev)
    yraw = torch.empty((SLOTS, s, nh * hd), dtype=bf16, device=dev)
    wkv_ops.wkv6_cuda(r_, k_, v_, w_, u_, st.clone(), lengths, sc,
                      ckpt=ckpt, yraw=yraw)
    dout = torch.randn(yraw.shape, generator=gen, device=dev).to(bf16)
    n = SLOTS * s * nh * hd
    nbytes = (5 * 2 + 4) * n + (3 * 2 + 4) * n + ckpt.numel() * 4 \
        + 4 * 2 * nh * hd
    flops = SLOTS * s * nh * (WKV_BWD_OPS * hd * hd + WKV_BWD_VEC_OPS * hd)
    bound, by = bound_ms(calls * nbytes, calls * flops, F32_FLOPS)
    out["wkv6_bwd"] = dict(
        ms=device_ms(lambda: [wkv_ops.wkv6_backward_cuda(
            r_, k_, v_, w_, u_, lengths, sc, ckpt, yraw, dout)
            for _ in range(calls)], 3),
        plain_ms=calls * event_ms(lambda: wkv_ref.wkv6_backward_plain(
            r_, k_, v_, w_, u_, st, lengths, sc, dout), 1),
        library_ms=None, bound_ms=bound, bound_by=by, calls=calls,
        bytes=calls * nbytes, kernels_a_call=kernels_a_call(
            lambda: wkv_ops.wkv6_backward_cuda(
                r_, k_, v_, w_, u_, lengths, sc, ckpt, yraw, dout), 2,
            "wkv6_bwd"))
    del r_, k_, v_, w_, ckpt, yraw, dout
    gc_free()
    return out


def train_recurrent(arch, dev, gpu, step_seconds):
    """(u): ``arch`` at full width and depth trained through ``Trainer``
    (``train_full``: bf16, remat full, B 8 × S 512 of the synthetic corpus,
    ``RECURRENT_TRAIN_STEPS`` steps): every loss finite, the loss falls,
    the recurrence's forward and backward kernels and the norm's launched
    (counts reset just before, read just after) and its plain versions,
    forward and backward, called no time. The steady step seconds go
    into ``step_seconds``."""
    from repro_torch import configs

    cfg = configs.get_config(arch)
    kern = "rglru_scan" if arch == "recurrentgemma-2b" else "wkv6"
    calls, restore = plain_calls()
    try:
        tr = train_full(cfg, dev, RECURRENT_TRAIN_STEPS, "(u)")
    finally:
        restore()
    need(tr["counts"], TRAIN_PATH + (kern, kern + "_bwd"),
         f"(u) training {arch}")
    if any(calls.values()):
        raise AssertionError(f"(u) training {arch} called plain versions: "
                             f"{calls}")
    steady = tr["times"][1:]
    step_s = sum(steady) / len(steady)
    step_seconds[f"(u) {arch}"] = (cfg, step_s)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"{gpu} | (u) {arch} trained at full width and depth "
        f"({tr['n_params']} params, bf16, remat full, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ}, AdamW lr {TRAIN_LR}): losses "
        f"{[round(v, 4) for v in tr['losses']]}; step seconds "
        f"{[round(v, 3) for v in tr['times']]} (the first builds and "
        f"warms); steady {step_s:.3f} s a step = {tokens / step_s:.0f} "
        f"tokens/s; peak memory {tr['peak']} bytes; fit {tr['wall']:.1f}s; "
        f"plain versions called: {calls}")
    log(f"{gpu} | (u) {arch}: launches of the {RECURRENT_TRAIN_STEPS} "
        f"steps: { {k: v for k, v in tr['counts'].items() if v} }; one more "
        f"step under the profiler: {tr['launches']} kernels, device busy "
        f"{tr['busy_ms']:.1f} ms; top: "
        + "; ".join(f"{k} {ms:.1f} ms x{c}" for k, ms, c in tr["top"]))
    del tr["state"]
    gc_free()
    return tr


def moe_determinism(dev, gpu):
    """(u) deepseek-moe-16b's 2-layer full-width copy (a dense layer and an
    MoE layer of 64 experts) trained 2 steps twice from the same seed: the
    losses and every state tensor equal bit for bit; then the gradients
    of one more batch taken twice on the trained model: every gradient
    equal bit for bit (the dispatch's gathers and the combine's sums run
    in a fixed order backward)."""
    import torch

    from repro_torch import configs
    from repro_torch.artifacts.format import iter_tree_leaves
    from repro_torch.training import state_tree
    from repro_torch.training.train_step import grads_of

    cfg = configs.get_config("deepseek-moe-16b").scaled(
        n_layers=MOE_DET_LAYERS)
    runs = []
    for _ in range(2):
        t = make_trainer(cfg, dev, MOE_DET_STEPS)
        state = t.fit(state=t.init_state())
        runs.append(([h["loss"] for h in t.history],
                     dict(iter_tree_leaves(state_tree(state, cfg))), t,
                     state))
    (la, a, t, state), (lb, b, _, _) = runs
    if la != lb:
        raise AssertionError(f"(u) deepseek-moe-16b: losses {la} != {lb}")
    apart = [k for k in a if not torch.equal(a[k], b[k])]
    if apart:
        raise AssertionError(f"(u) deepseek-moe-16b: state tensors differ "
                             f"between two runs at {apart[:5]}")
    n_state = len(a)
    del runs, a, b
    batch = t._batch(t.loader.batch_at(MOE_DET_STEPS))
    (l1, g1), (l2, g2) = (grads_of(state["params"], cfg, batch)
                          for _ in range(2))
    bad = [i for i, (x, y) in enumerate(zip(g1, g2)) if not torch.equal(x, y)]
    if bad or not torch.equal(l1, l2):
        names = [n for n, _ in state["params"].named_parameters()]
        raise AssertionError(f"(u) deepseek-moe-16b: gradients differ "
                             f"between two calls at "
                             f"{[names[i] for i in bad[:5]]}")
    n = sum(p.numel() for p in state["params"].parameters())
    log(f"{gpu} | (u) deepseek-moe-16b {MOE_DET_LAYERS}-layer full-width "
        f"copy ({n} params, {cfg.moe.n_experts} experts): two "
        f"{MOE_DET_STEPS}-step runs from one seed gave losses "
        f"{[round(v, 4) for v in la]} and all {n_state} state tensors bit "
        f"for bit; all {len(g1)} gradients of a further batch "
        "equal bit for bit at a second call")
    del state, t, g1, g2
    gc_free()


def recurrent_training_phases(gpu, dev, step_seconds):
    """(u): the recurrent archs' training on the card (the module
    docstring). Returns its rows of the ``kernels`` line; the steady step
    seconds go into ``step_seconds``."""
    import shutil
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.models.transformer import Transformer

    t_all = time.perf_counter()
    bwd_err = check_recurrent_backward(dev)
    log(f"(u) {time.perf_counter() - t_all:.1f}s in")
    gc_free()
    trained = {arch: train_recurrent(arch, dev, gpu, step_seconds)
               for arch in ("recurrentgemma-2b", "rwkv6-3b")}
    log(f"(u) {time.perf_counter() - t_all:.1f}s in")
    counts = {"rglru_scan_bwd": trained["recurrentgemma-2b"]["counts"],
              "wkv6_bwd": trained["rwkv6-3b"]["counts"]}
    per_step = {k: c[k] // RECURRENT_TRAIN_STEPS for k, c in counts.items()}
    timing = time_recurrent_backward(dev, per_step)
    for name, t in timing.items():
        log(f"{gpu} | (u) {name} x {t['calls']} (a training step's, 8 x 512, "
            f"bf16): kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.1f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}; {t['bytes']} "
            f"bytes) -> {t['bound_ms'] / t['ms']:.1%} of bound; "
            f"{t['kernels_a_call']} kernels a call; library: none"
            + (f"; {t['resources']}" if "resources" in t else ""))
    moe_determinism(dev, gpu)
    log(f"(u) {time.perf_counter() - t_all:.1f}s in")
    for arch, layers in RECURRENT_RESUME_LAYERS.items():
        cfg = configs.get_config(arch)
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_u_"))
        try:
            n = sum(p.numel() for p in Transformer(
                cfg.scaled(n_layers=layers), dtype=torch.bfloat16,
                device="meta").parameters())
            need_bytes = 2 * 10 * n + 2 * n
            free = shutil.disk_usage(tmp).free
            if free < need_bytes:
                raise AssertionError(f"(u) {free} bytes free under {tmp}; "
                                     f"the resume gate needs {need_bytes}")
            t0 = time.perf_counter()
            rp = resume_path(cfg, dev, tmp, layers, "(u)")
            log(f"{gpu} | (u) {arch}: {layers}-layer full-width copy "
                f"({rp['n_params']} params): preempted after step "
                f"{RESUME_AT}, resumed to {RESUME_STEPS}: losses "
                f"{[round(v, 4) for v in rp['losses']]} and all "
                f"{rp['leaves']} state tensors equal the uninterrupted run's "
                f"bit for bit; checkpoint {rp['ckpt_bytes']} bytes, saves "
                f"{[round(s, 2) for s in rp['saves']]} s, load "
                f"{[round(s, 2) for s in rp['loads']]} s; "
                f"{time.perf_counter() - t0:.1f}s")
            gc_free()
            if arch == "recurrentgemma-2b":
                t0 = time.perf_counter()
                qs = quantize_serve_path(rp, dev, tmp, "(u)")
                st = qs["stats"]
                log(f"{gpu} | (u) {arch}: launch/quantize.py "
                    f"--from-checkpoint: {qs['n_quantized']} kernels on B6 "
                    f"({qs['qcounts']['ptqtp_search']} launches) in "
                    f"{qs['quant_s']:.2f}s, {qs['nbytes']} bytes; {qs['fp']} "
                    f"FP leaves equal the trained model's; served "
                    f"{N_REQUESTS} requests from it: launches {qs['counts']}; "
                    f"requests {qs['solo']} alone == fleet; TTFT median "
                    f"{st['ttft'][len(st['ttft']) // 2]:.3f}s; decode "
                    f"{st['decode_tok'] / st['decode_s']:.1f} tok/s; "
                    f"{time.perf_counter() - t0:.1f}s")
            del rp
            gc_free()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"(u) {time.perf_counter() - t_all:.1f}s")
    sources = {"rglru_scan_bwd": ("src/repro_torch/kernels/rglru_scan/csrc/"
                                  "rglru_scan.cu",
                                  "src/repro/models/rglru.py:117"),
               "wkv6_bwd": ("src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
                            "src/repro/models/rwkv6.py:128")}
    work = {"rglru_scan_bwd": "the RG-LRU's gate-and-scan backward (gates, "
                              "reverse chain from the tile checkpoints, "
                              "output gate; dba, dbx and dlam summed in row "
                              "order), recurrentgemma-2b's",
            "wkv6_bwd": "the WKV scan's and group norm's backward (states "
                        "recomputed on chip from the tile checkpoints; du "
                        "and dscale summed in row order), rwkv6-3b's"}
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [dict(
        name=name, route="cuda", source=sources[name][0],
        replaces=sources[name][1], launches=counts[name][name],
        launches_per_train_step=per_step[name],
        max_abs_err=bwd_err[name][0], max_rel_err=bwd_err[name][1],
        work=f"{work[name]} {per_step[name]} calls of one training step (8 "
             "x 512, bf16); replaces jax.grad of the reference's layer (XLA, "
             "no Pallas kernel); launches are the full-depth training run's; "
             "no single PyTorch call computes it (library null)",
        kernels_a_call=timing[name]["kernels_a_call"],
        **{k: timing[name][k] for k in timed}) for name in work]


# ---------------------------------------------------- phase (v): slice 18
# dry-run cells of (v), each in its own process on the fake backend
DRYRUN_CELLS = (("train_4k", ()), ("decode_32k", ("--quantized",)))
# the single-pod production mesh's axes, whose specs (v) places on the card
PRODUCTION_MESH = {"data": 16, "model": 16}


def bytes_of(t):
    """A tensor's bytes as a flat uint8 view (contiguous copy if needed)."""
    import torch

    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def mesh_phase(gpu, cfg, dev, model, mp):
    """(v): the one-GPU mesh (the module docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import partition as part
    from repro_torch.sharding.api import activation_sharding, constrain

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
        leaves = part.param_leaves(model)
        # the production plan's specs (on the card's 1 x 1 mesh every rule
        # would fall back to replication): each Shard lands on an axis of
        # size 1, so every local shard is the whole tensor
        spec_of = part.param_specs(model, PRODUCTION_MESH)
        if set(spec_of) != set(leaves):
            raise AssertionError(f"(v) specs and leaves differ: "
                                 f"{sorted(set(spec_of) ^ set(leaves))[:4]}")
        t0 = time.perf_counter()
        nbytes = 0
        for name, t in leaves.items():
            dt = distribute_tensor(t.detach(), mesh,
                                   part.placements(spec_of[name], mesh))
            local = dt.to_local()
            if (tuple(local.shape) != tuple(t.shape)
                    or not torch.equal(bytes_of(local), bytes_of(t))):
                raise AssertionError(f"(v) {name}: the local shard of "
                                     f"{spec_of[name]} differs from the "
                                     f"tensor")
            nbytes += local.numel() * local.element_size()
            del dt, local
        place_s = time.perf_counter() - t0
        sharded = sum(any(a is not None for a in s) for s in spec_of.values())
        if not sharded:
            raise AssertionError("(v) no leaf has a sharded spec")
        rules = part.activation_rules(mesh, mode="train")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        h = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32).to(torch.bfloat16)
        x = DTensor.from_local(h, mesh, [Replicate(), Replicate()],
                               run_check=False)
        comm = CommDebugMode()
        with activation_sharding(rules), comm:
            y = constrain(x, "hidden")
        torch.cuda.synchronize()
        if comm.get_total_counts():
            raise AssertionError(f"(v) constrain on the 1 x 1 mesh ran "
                                 f"collectives: {comm.get_comm_counts()}")
        if (tuple(y.placements) != (Shard(0), Replicate())
                or not torch.equal(bytes_of(y.to_local()), bytes_of(h))):
            raise AssertionError(f"(v) constrain gave {y.placements} or "
                                 f"other bytes")
        del x, y, h
        with activation_sharding(part.activation_rules(mesh, mode="decode")):
            res, dec_s, dec_tok, _, eng = serve(model, cfg, mp["prompts"],
                                                warm=True)
        del eng
        for i, (g, w) in enumerate(zip(res, mp["results"])):
            if g.tokens != w.tokens:
                raise AssertionError(f"(v) request {i} gave {g.tokens} under "
                                     f"the decode rules, {w.tokens} in phase 4")
    finally:
        dist.destroy_process_group()
    log(f"{gpu} | (v) 1 x 1 mesh (data, model) on the card, NCCL group of "
        f"one: {len(leaves)} leaves of the quantized qwen2-1.5b ({nbytes} "
        f"bytes; {sharded} sharded on the 16 x 16 plan) placed by the "
        f"port's specs with distribute_tensor in {place_s:.2f}s, every local "
        f"shard equal "
        f"to its tensor byte for byte; constrain under the train rules on an "
        f"({TRAIN_BATCH}, {TRAIN_SEQ}, {cfg.d_model}) bf16 hidden DTensor: "
        f"no collective, same bytes; the main fleet under the decode rules: "
        f"phase 4's streams, decode {dec_tok / dec_s:.1f} tok/s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        # both cells at once, each in its own process
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             cfg.name, "--shape", shape, "--mesh", "single", "--out", out,
             *flags], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            for shape, flags in DRYRUN_CELLS]
        try:
            done = [(shape, flags, proc.communicate(timeout=600)[1],
                     proc.returncode, time.perf_counter() - t0)
                    for (shape, flags), proc in zip(DRYRUN_CELLS, procs)]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for shape, flags, err, rc, wall in done:
            if rc:
                raise AssertionError(f"(v) the dry run of {shape} failed: "
                                     f"{err[-2000:]}")
            tag = f"{cfg.name}__{shape}__single" + ("__q" if flags else "")
            r = json.loads((Path(out) / f"{tag}.json").read_text())
            if not (r["n_chips"] == 256 and r["flops_per_chip"] > 0):
                raise AssertionError(f"(v) dry run {tag}: {r['n_chips']} "
                                     f"chips, {r['flops_per_chip']} FLOPs")
            t = r["roofline"]
            log(f"(v) dry run {tag} (counts on the fake 16 x 16 mesh, CPU; "
                f"H100 data-sheet peaks): done {wall:.1f}s after the start "
                f"of both; policy "
                f"{r['policy']}, {r['flops_per_chip']:.4g} FLOPs, "
                f"{r['traffic_bytes_per_chip']:.4g} bytes, "
                f"{r['collective_bytes_per_chip']:.4g} collective bytes a "
                f"chip; dominant {t['dominant']}, bound "
                f"{t['step_lower_bound_s']:.4g} s")


def log_step_shares(gpu, step_seconds):
    """(v), after (u): each training phase's steady step seconds
    (``step_seconds``: {what: (config, s)}) beside ``model_flops`` of its
    step at the bf16 data-sheet peak (no gate)."""
    from repro_torch.roofline.analysis import PEAK_FLOPS, model_flops

    info = {"global_batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "kind": "train"}
    parts = []
    for what, (cfg, step_s) in step_seconds.items():
        mf = model_flops(cfg, info, train=True)
        parts.append(f"{what} {step_s:.3f} s a step, model_flops {mf:.4g} "
                     f"= {mf / PEAK_FLOPS:.4f} s at the peak -> "
                     f"{mf / PEAK_FLOPS / step_s:.1%}")
    log(f"{gpu} | (v) training steps (B {TRAIN_BATCH} x S {TRAIN_SEQ}) "
        f"against 6·N·D at the H100 bf16 data-sheet peak "
        f"({PEAK_FLOPS:.4g} FLOP/s): " + "; ".join(parts))


# ------------------------------------------------------------------- main
def qwen2_phases(gpu, dev):
    """Phases 2-17 and (e)-(i) on full-width qwen2-1.5b (the module
    docstring); returns their rows of the ``kernels`` line."""
    import torch

    from repro_torch import configs

    cfg = configs.get_config("qwen2-1.5b")
    mm_err = check_ternary(cfg, dev)
    attn_err = check_attention(cfg, dev)
    norm_err = check_rms_norm(cfg, dev)
    fused_err = check_add_rms_norm(dev)
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
    fx = fixture_path(dev, "qwen2")
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
    t0 = time.perf_counter()
    opts = options_path(cfg, dev, model, mp)
    log_options(gpu, opts)
    log(f"(r) {time.perf_counter() - t0:.1f}s")

    gc_free()
    t0 = time.perf_counter()
    mesh_phase(gpu, cfg, dev, model, mp)
    log(f"(v) {time.perf_counter() - t0:.1f}s")

    gc_free()
    dcounts, dlayers = decode_attention_path(cfg, dev)
    need(dcounts, ("decode_attention",), "the decode-attention op")

    fill = [len(p) + MAX_NEW // 2 for p in mp["prompts"]]
    tern = time_ternary(model, dev)
    norm = time_rms_norm(model, cfg, dev)
    gc_free()
    step = graph_step(cfg, model, gpu)
    del model
    torch.cuda.empty_cache()
    attn = time_attention(cfg, dev, fill)
    pattn = time_paged_attention(cfg, dev, fill)
    dattn = time_decode_attention(cfg, dev, dlayers)
    del dlayers
    search = time_trit_search(cfg, dev)
    draw = time_sampling(cfg, dev)
    gc_free()
    t0 = time.perf_counter()
    log_baselines(gpu, *baselines_path(dev))
    log(f"(s) {time.perf_counter() - t0:.1f}s")
    for name, t in list(tern.items()) + [("chunk_attention/" + k, v)
                                         for k, v in attn.items()] + [
            ("rms_norm", norm["rms_norm"]),
            ("add_rms_norm", norm["add_rms_norm"]),
            ("chunk_attention_paged", pattn),
            ("decode_attention", dattn), ("ptqtp_search", search)]:
        lib_ms = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.3f}"
        log(f"{gpu} | {name}: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib_ms} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) -> "
            f"{t['bound_ms'] / t['ms']:.1%} of bound")
        if "us_per_call" in t:
            log(f"{gpu} | {name} device us per call, by n x d (m = {t['m']}): "
                + ", ".join(f"{k} {v:.1f}" for k, v in t["us_per_call"].items()))
    fn, st = norm["add_rms_norm"], norm["step"]
    log(f"{gpu} | add_rms_norm x {fn['calls']}: library F.rms_norm alone "
        f"{fn['library_norm_only_ms']:.3f} ms; the {st['calls']} "
        f"norms of a decode step as the path runs them (1 rms_norm + "
        f"{fn['calls']} add_rms_norm) {st['ms']:.3f} ms, as before the "
        f"fusion ({fn['calls']} adds + {st['calls']} rms_norm) "
        f"{st['before_ms']:.3f} ms")
    log(f"{gpu} | qwen2 graph decode step (launch/profile_decode.py, the "
        f"engine's K={step['K']} dispatch replayed): "
        f"{step['launches_per_step']:.0f} launches/step, device busy "
        f"{step['device_busy_ms_per_step']:.3f} ms/step, host "
        f"{step['host_ms_per_step']:.3f} ms/step (before the fused norm, "
        f"PERF.md §5: 1436 launches, 4.52 ms busy); the graph's hand-kernel "
        f"launches a step "
        f"{step['hand']}")
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
             work="the norm after the embedding of one decode step, 8 rows "
                  "of d=1536, bf16 (the only one no residual add precedes); "
                  "replaces an XLA-fused function, not a Pallas kernel; "
                  "library: F.rms_norm",
             **{k: norm["rms_norm"][k] for k in timed}),
        dict(name="add_rms_norm", route="cuda",
             source="src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
             replaces="src/repro/models/common.py:78",
             launches=counts["add_rms_norm"],
             launches_per_decode_step=mp["per_step"]["add_rms_norm"],
             max_abs_err=max(norm_err, fused_err),
             work=f"the {norm['add_rms_norm']['calls']} norms of one decode "
                  "step that follow a residual add, each fused with it, 8 "
                  "rows of d=1536, bf16; replaces the reference's x + y and "
                  "rms_norm, which XLA fuses (no Pallas kernel); library: "
                  "x + y then F.rms_norm (F.rms_norm alone in "
                  "library_norm_only_ms); step_ms: all 57 norms of the step "
                  "as the path runs them, step_before_ms: 56 adds and 57 "
                  "rms_norm launches, as before the fusion",
             library_norm_only_ms=norm["add_rms_norm"]["library_norm_only_ms"],
             step_ms=norm["step"]["ms"],
             step_before_ms=norm["step"]["before_ms"],
             **{k: norm["add_rms_norm"][k] for k in timed}),
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
    return kernels


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
        from repro_torch import configs  # noqa: F401  (a checkout's package)
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

    kernels = qwen2_phases(gpu, dev)
    gc_free()
    kernels += slice9_phases(gpu, dev)
    gc_free()
    kernels += slice10_phases(gpu, dev)
    gc_free()
    kernels += stub_phases(gpu, dev)
    gc_free()
    step_seconds = {}
    kernels += training_phases(gpu, dev, step_seconds)
    gc_free()
    kernels += recurrent_training_phases(gpu, dev, step_seconds)
    log_step_shares(gpu, step_seconds)
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
