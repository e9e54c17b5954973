"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels build at
first use) and skips elsewhere. The file imports neither JAX nor the
reference package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions, in
f32 (bf16 ternary layers on the tensor cores, whose f32 accumulation is
not IEEE-sequential): ternary matmul rtol = atol = 1e-4 (|y| ~ 10), and
1e-4 of each row's own scale for x spanning many binades; attention (ring,
paged and decode) 1e-4 (outputs are convex mixes of values ~ 1), RMSNorm
rtol 1e-5 in f32 and one bf16 step (2^-7 of the value) in bf16. Exact: the
decode and prefill matmul kernels give bit-identical rows, also for
windows of x off the kernels' 8-token grid and at ragged m and n, the paged
attention kernel equals the ring kernel on the gathered ring, the trit
search equals its plain version, the norm kernel's rows do not depend on
how many rows share the call, the fused add and norm gives PyTorch's add
and the norm kernel's result of it, and the engine's greedy streams do not
depend on the fleet, for the ring and the paged layout. The split-KV
attention kernel gives a row the same bits alone and in a batch of 8 with
other fills, in an L = 1 call and at l = 0 of an L = 64 call with length 1,
over the ring and over a paged pool (B2, B4), and over B5's int8 ring.
A quantized model written to an artifact and loaded onto the card holds
byte-identical tensors and serves the same tokens; an engine with a fault
injector contains a NaN row with one host sync per decode dispatch, as
one without does, and only the injector's engine runs the poison.
The engine's dispatches replayed from CUDA graphs give the eager bodies'
streams token for token (greedy and sampled, ring and paged), a request
alone the same as in the fleet, the serial-admit baseline the bucketed
engine's; a decode dispatch syncs the host once, also after the fleet
changed; the launch counts grow by each graph's capture per replay.
Behind the concurrent frontend: an engine captures its graphs on the
driver's thread while another thread builds engines and copies to and
from the card, with the eager bodies' streams; device memory stays flat
across three supervisor rebuilds (a dead generation's graphs, pool, KV and
attention scratch are freed with it); a released thread of an abandoned
engine launches nothing, and the new generation's stream is not its.
The MoE experts' stacked ternary launch gives each expert the bits of its
own launch, and the attention kernels take gemma3-27b's head dim of 168.
The recurrences (``rglru_scan``, ``wkv6``) equal their plain versions
(the scans' states exactly: a product and a sum a step, rounded on their
own in both; the wkv6 readout f32 within 1e-4, bf16 within one bf16 step
plus 2^-7: its sums run in another order), give a row the same bits alone
and in a batch, and a chunk the bits of one step at a time (wkv6 also over
several of its 32-step tiles with a ragged last one); the recurrent
smoke models serve the same streams alone, in the fleet and on the paged
layout. The RG-LRU's fused gate-and-scan equals its plain version (the
op-by-op composition around the plain scan) bit for bit at S = 1, 64 and
over ragged tiles, f32 and bf16, with the same row and chunk invariance.
The attention kernels take the stub-frontend archs' head dims of 64
(musicgen-large) and 96 (phi-3-vision-4.2b), one query head a kv head.
Training: the norm's backward kernels (alone and with add_rms_norm's
residual gradient) against the plain backward written out, f32 within
1e-5 of the tensor's largest |value| (dscale 1e-4: its 32-row tiles sum
in another order than torch.sum), bf16 within one bf16 step of it, at
every width the forward takes, and the same bits at a second call;
autograd through both wrappers launches them; the smoke qwen2 trained on
the card, preempted and resumed from its checkpoint, equals the
uninterrupted run bit for bit.
"""

import dataclasses
import threading
import time
import warnings
import weakref

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.artifacts import (ArtifactWriter, format as afmt,
                                   load_model)
from repro_torch.convert import to_reference_tree
from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.core.packing import pack_trits, unpack_trits
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import quantize_tree
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention import ops as ca_ops
from repro_torch.kernels.chunk_attention import ref as ca_ref
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.ptqtp_search import ops as ps_ops
from repro_torch.kernels.ptqtp_search import ref as ps_ref
from repro_torch.kernels.rglru_scan import ops as scan_ops
from repro_torch.kernels.rglru_scan import ref as scan_ref
from repro_torch.kernels.rms_norm import ops as norm_ops
from repro_torch.kernels.rms_norm import ref as norm_ref
from repro_torch.kernels.ternary_matmul import ops as tm_ops
from repro_torch.kernels.ternary_matmul import ref as tm_ref
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6 import ref as wkv_ref
from repro_torch.models import init_params
from repro_torch.serving import (EngineConfig, Observability,
                                 SamplingParams, SerialAdmitEngine,
                                 ServingEngine)
from repro_torch.serving import graphs
from repro_torch.serving.graphs import GraphDispatch
from repro_torch.serving.faults import FaultInjector, FaultPlan, VirtualClock
from repro_torch.serving.frontend import EngineDriver, EngineSupervisor

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(rng, n, d, g, dev):
    t1 = torch.from_numpy(rng.integers(-1, 2, (n, d)).astype(np.int8))
    t2 = torch.from_numpy(rng.integers(-1, 2, (n, d)).astype(np.int8))
    alpha = torch.from_numpy(
        rng.uniform(0.01, 0.1, (n, d // g, 2)).astype(np.float32))
    return pack_trits(t1).to(dev), pack_trits(t2).to(dev), alpha.to(dev)


# matvec windows [a, b) of an m-row x: on the 8-token grid of both kernels'
# passes, off it, ending at the ragged edge, and single rows
def _windows(m):
    return ((0, 9), (3, 12), (m - 11, m), (5, 6), (m - 1, m))


@pytest.mark.parametrize("m", [200, 203])       # m a multiple of 8, and not
@pytest.mark.parametrize("n", [200, 198, 256])  # n off the 16-feature grid, and on it
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [32, 64, 128])
def test_ternary_kernels_match_plain_and_each_other(cuda, g, dtype, n, m):
    rng = np.random.default_rng(g)
    d = 512
    t1p, t2p, alpha = _planes(rng, n, d, g, cuda)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(
        cuda, dtype)
    plain = tm_ref.ternary_matmul_grouped(x, t1p, t2p, alpha, g)
    tiled = tm_ops.ternary_matmul_tiled(x, t1p, t2p, alpha, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(tiled, plain, rtol=1e-4, atol=1e-4)
    assert tm_ops.route(dtype) == ("mma" if dtype == torch.bfloat16 else "fma")
    for a, b in _windows(m):
        vec = tm_ops.ternary_matvec(x[a:b].contiguous(), t1p, t2p, alpha, g)
        assert torch.equal(vec, tiled[a:b]), (a, b)
        if dtype == torch.bfloat16:  # bf16 outputs round as a cast would
            vb = tm_ops.ternary_matvec(x[a:b].contiguous(), t1p, t2p, alpha,
                                       g, torch.bfloat16)
            assert torch.equal(vb, vec.to(torch.bfloat16)), (a, b)
    if dtype == torch.bfloat16:
        yb = tm_ops.ternary_matmul_tiled(x, t1p, t2p, alpha, g, torch.bfloat16)
        assert torch.equal(yb, tiled.to(torch.bfloat16))


@pytest.mark.parametrize("g", [32, 64, 128])
def test_ternary_bf16_spanning_binades(cuda, g):
    """bf16 x whose rows are scaled by 2^-24 .. 2^24 and whose entries span
    2^-8 .. 2^8 within a row: every row of the tiled kernel within 1e-4 of
    that row's own scale (max |plain row|), and matvec rows bit-identical
    to tiled rows."""
    rng = np.random.default_rng(40 + g)
    m, n, d = 150, 136, 1024
    x = (rng.standard_normal((m, d)) * 2.0 ** rng.integers(-8, 9, (m, d))
         * 2.0 ** rng.integers(-24, 25, (m, 1)))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda, torch.bfloat16)
    t1p, t2p, alpha = _planes(rng, n, d, g, cuda)
    plain = tm_ref.ternary_matmul_grouped(x, t1p, t2p, alpha, g)
    tiled = tm_ops.ternary_matmul_tiled(x, t1p, t2p, alpha, g)
    torch.cuda.synchronize()
    err = (tiled - plain).abs().amax(1) / plain.abs().amax(1)
    assert float(err.max()) <= 1e-4, float(err.max())
    for a, b in _windows(m):
        vec = tm_ops.ternary_matvec(x[a:b].contiguous(), t1p, t2p, alpha, g)
        assert torch.equal(vec, tiled[a:b]), (a, b)


@pytest.mark.parametrize("m", [1, 60, 200])    # decode, capped prefill, B3
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ternary_expert_axis_equals_per_expert_launches(cuda, dtype, m):
    """The MoE experts' stacked launch (the expert on the grid's z axis):
    each expert's rows bit for bit those of a launch of its matrix alone,
    within 1e-4 of the plain version, each launch counted once under the
    stacked route's own name."""
    rng = np.random.default_rng(m)
    e, n, d, g = 5, 200, 512, 128
    planes = [_planes(rng, n, d, g, cuda) for _ in range(e)]
    t1p, t2p, alpha = (torch.stack([pl[i] for pl in planes])
                       for i in range(3))
    x = torch.from_numpy(rng.standard_normal((e, m, d)).astype(
        np.float32)).to(cuda, dtype)
    before = dict(tm_ops._build.LAUNCHES)
    got = tm_ops.ternary_matmul_experts(x, t1p, t2p, alpha, group_size=g)
    kind = "ternary_matvec" if m < 128 else "ternary_matmul"
    after = dict(tm_ops._build.LAUNCHES)
    assert after[kind + "_experts"] - before[kind + "_experts"] == 1
    assert after[kind] == before[kind]
    one = (tm_ops.ternary_matvec if m < 128 else tm_ops.ternary_matmul_tiled)
    plain = tm_ref.ternary_matmul_experts(x, t1p, t2p, alpha, g)
    torch.cuda.synchronize()
    for i in range(e):
        assert torch.equal(got[i], one(x[i].contiguous(), t1p[i], t2p[i],
                                       alpha[i], g)), i
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    if dtype == torch.bfloat16:
        yb = tm_ops.ternary_matmul_experts(x, t1p, t2p, alpha, group_size=g,
                                           out_dtype=torch.bfloat16)
        assert torch.equal(yb, got.to(torch.bfloat16))


def _attention_case(rng, b, L, kv, g, hd, cap, ring, dev):
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    q, kn, vn = f32(b, L, kv, g, hd), f32(b, L, kv, hd), f32(b, L, kv, hd)
    ks = vs = None
    if ring == "int8":
        kc = torch.from_numpy(rng.integers(-127, 128, (b, cap, kv, hd)).astype(
            np.int8)).to(dev)
        vc = torch.from_numpy(rng.integers(-127, 128, (b, cap, kv, hd)).astype(
            np.int8)).to(dev)
        ks = torch.from_numpy(rng.uniform(0.005, 0.02, (b, cap, kv)).astype(
            np.float32)).to(dev)
        vs = torch.from_numpy(rng.uniform(0.005, 0.02, (b, cap, kv)).astype(
            np.float32)).to(dev)
    else:
        dt = getattr(torch, ring)
        kc, vc = f32(b, cap, kv, hd).to(dt), f32(b, cap, kv, hd).to(dt)
        q, kn, vn = q.to(dt), kn.to(dt), vn.to(dt)
    pb = np.full((b, cap), -1, np.int32)
    pos0 = np.zeros((b,), np.int64)
    for r in range(b):
        pos0[r] = cap + rng.integers(1, cap) if r % 2 else rng.integers(0, cap)
        for p in range(max(0, pos0[r] - cap), pos0[r]):
            pb[r, p % cap] = p
    positions = (pos0[:, None] + np.arange(L)[None, :]).astype(np.int32)
    lengths = np.asarray([L, 0, 1, L][:b], np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return [q, kn, vn, kc, ks, vc, vs, t(pb), t(positions), t(lengths)]


@pytest.mark.parametrize("backend", ["stream", "materialized"])
def test_plain_attention_twins_rows_do_not_depend_on_the_chunk_length(
        cuda, backend):
    """The ``stream`` and ``materialized`` routes on the card (their fixed
    row blocks): within 1e-4 of the kernel, a row's bits equal at L = 1 and
    as l = 0 of an L = 64 chunk with length 1, and the backend launches no
    attention kernel."""
    rng = np.random.default_rng(23)
    args = _attention_case(rng, 4, 64, 2, 6, 128, 256, "bfloat16", cuda)
    args[9] = torch.tensor([64, 1, 1, 40], dtype=torch.int32, device=cuda)
    reset_launch_counts()
    full = ca_ops.chunk_attention(*args, backend=backend)
    one = list(args)
    for i in (0, 1, 2, 8):
        one[i] = args[i][:, :1].contiguous()
    one[9] = torch.ones_like(args[9])
    first = ca_ops.chunk_attention(*one, backend=backend)
    assert not launch_counts()["chunk_attention"]
    assert torch.equal(first[1:3], full[1:3, :1])
    kern = ca_ops.chunk_attention(*args, backend="pallas")
    assert (full - kern).abs().max() <= 1e-4


def test_int8_plane_route_rows_do_not_depend_on_m(cuda):
    """Raw int8 planes on the card: the plain grouped route in 128-row
    blocks, a row's bits equal alone and among 300 rows, within the
    ternary tolerance of the kernel on the packed planes; a request for
    the kernel, or ``auto``, raises: only ``grouped`` by name serves them
    on the card."""
    rng = np.random.default_rng(24)
    t1p, t2p, alpha = _planes(rng, 256, 512, 128, cuda)
    t1, t2 = unpack_trits(t1p), unpack_trits(t2p)
    x = torch.from_numpy(rng.standard_normal((300, 512)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    reset_launch_counts()
    y = tm_ops.ternary_matmul(x, t1, t2, alpha, group_size=128,
                              backend="grouped")
    assert not launch_counts()["ternary_matvec"] + launch_counts()[
        "ternary_matmul"]
    for lo, hi in ((0, 1), (5, 13), (127, 129), (250, 300)):
        assert torch.equal(tm_ops.ternary_matmul(
            x[lo:hi], t1, t2, alpha, group_size=128, backend="grouped"),
            y[lo:hi])
    kern = tm_ops.ternary_matmul(x, t1p, t2p, alpha, group_size=128)
    assert (y - kern).abs().max() <= 1e-4 * max(1.0, float(y.abs().max()))
    for backend in ("pallas", "auto"):
        with pytest.raises(ValueError, match="requires packed uint8"):
            tm_ops.ternary_matmul(x, t1, t2, alpha, group_size=128,
                                  backend=backend)
        with pytest.raises(ValueError, match="requires packed uint8"):
            tm_ops.ternary_matmul_experts(x[None], t1[None], t2[None],
                                          alpha[None], group_size=128,
                                          backend=backend)


@pytest.mark.parametrize("ring", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,window", [(1, None), (40, None), (40, 50)])
def test_chunk_attention_matches_plain(cuda, L, window, ring):
    rng = np.random.default_rng(L)
    args = _attention_case(rng, 4, L, 2, 6, 128, 96, ring, cuda)
    plain = ca_ref.chunk_attention_stream(*args, window=window)
    got = ca_ops.chunk_attention_cuda(*args, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_matches_plain_and_is_batch_invariant(cuda, dtype,
                                                       scale_dtype):
    rng = np.random.default_rng(3)
    d = 1536
    x = torch.from_numpy(rng.standard_normal((8, 64, d)).astype(
        np.float32)).to(cuda, dtype)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (d,)).astype(
        np.float32)).to(cuda, scale_dtype)
    got = norm_ops.rms_norm(scale, x, 1e-6)
    want = norm_ref.rms_norm_plain(scale, x, 1e-6)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # a row gives the same bits whatever call it sits in
    for b, l in ((slice(None), slice(0, 1)), (slice(0, 1), slice(0, 5)),
                 (slice(3, 4), slice(7, 8))):
        assert torch.equal(norm_ops.rms_norm(scale, x[b, l].contiguous(),
                                             1e-6), got[b, l])


@pytest.mark.parametrize("d", [64, 1536, 2560, 5376, 16384])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_equals_add_then_norm(cuda, dtype, scale_dtype, d):
    """x + delta equals PyTorch's add and h the norm kernel's rms_norm of
    it, bit for bit, at the models' widths (a lane's registers hold the row
    up to 8192 bf16 / 4096 f32 values; wider rows take two passes); h is
    within the norm's tolerance of the plain version, and a row gives the
    same bits whatever call it sits in."""
    rng = np.random.default_rng(d)
    x, y = (torch.from_numpy(rng.standard_normal((8, 16, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(2))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (d,)).astype(
        np.float32)).to(cuda, scale_dtype)
    got_sum, got = norm_ops.add_rms_norm(scale, x, y, 1e-6)
    assert torch.equal(got_sum, x + y)
    assert torch.equal(got, norm_ops.rms_norm(scale, got_sum, 1e-6))
    _, want = norm_ref.add_rms_norm_plain(scale, x, y, 1e-6)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for b, l in ((slice(None), slice(0, 1)), (slice(3, 4), slice(7, 8))):
        s2, h2 = norm_ops.add_rms_norm(scale, x[b, l].contiguous(),
                                       y[b, l].contiguous(), 1e-6)
        assert torch.equal(s2, got_sum[b, l]) and torch.equal(h2, got[b, l])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])  # FMA, tensor cores
def test_engine_runs_kernels_and_is_fleet_invariant(cuda, dtype):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-1.5b"),
                              param_dtype=dtype, activation_dtype=dtype)
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    reset_launch_counts()
    model, _ = quantize_tree(model, PTQTPConfig(group_size=64, t_max=5))
    assert launch_counts()["ptqtp_search"] > 0  # the trit step runs on B6
    rng = np.random.default_rng(0)
    # 129 tokens: the last prefill chunk holds one token; in the fleet it
    # runs beside the 140-token prompt on 2 of the 4 slots, alone on one
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 140, 129)]

    def serve(ps, slots):
        eng = ServingEngine(model, cfg, EngineConfig(
            max_slots=slots, capacity=256, prefill_chunk=64))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=6)) for p in ps]
        eng.run()
        return [h.output for h in hs]

    reset_launch_counts()
    fleet = serve(prompts, 4)
    counts = launch_counts()
    ring_path = ("ternary_matvec", "ternary_matmul", "chunk_attention",
                 "rms_norm", "add_rms_norm")
    assert all(counts[k] > 0 for k in ring_path), counts
    for i in (2, 3):
        assert serve(prompts[i:i + 1], 1)[0] == fleet[i]


def _paged_case(rng, args, ps, dev):
    """Scatter the ring of an attention case into a pool of ps-slot pages
    under a shuffled table, with some logical pages unmapped (table entry 0,
    the null page): returns the paged operands and the gathered ring's."""
    q, kn, vn, kc, ks, vc, vs, pb, positions, lengths = args
    b, cap = pb.shape
    n_pages = cap // ps
    n_phys = b * n_pages + 1
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages)
    table[rng.random((b, n_pages)) < 0.2] = 0
    table_t = torch.from_numpy(table.astype(np.int32)).to(dev)

    def pool(ring, fill):
        p = torch.full((n_phys, ps) + tuple(ring.shape[2:]), fill,
                       dtype=ring.dtype, device=dev)
        for r in range(b):
            for j in range(n_pages):
                if table[r, j]:
                    p[table[r, j]] = ring[r, j * ps:(j + 1) * ps]
        return p

    pools = [pool(kc, 0), None if ks is None else pool(ks, 0), pool(vc, 0),
             None if vs is None else pool(vs, 0), pool(pb, -1)]
    paged = [q, kn, vn, *pools, table_t, positions, lengths]
    gathered = [q, kn, vn] + [None if x is None else
                              ca_ref.gather_pages(x, table_t)
                              for x in pools] + [positions, lengths]
    return paged, gathered


@pytest.mark.parametrize("ring", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,window", [(1, None), (40, None), (40, 50)])
def test_paged_attention_matches_plain_and_ring_kernel(cuda, L, window, ring):
    rng = np.random.default_rng(L + 7)
    args = _attention_case(rng, 4, L, 2, 6, 128, 96, ring, cuda)
    paged, gathered = _paged_case(rng, args, 16, cuda)
    got = ca_ops.chunk_attention_paged_cuda(*paged, window=window)
    ring_kernel = ca_ops.chunk_attention_cuda(*gathered, window=window)
    plain = ca_ref.chunk_attention_paged_stream(*paged, window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, ring_kernel)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(96, None), (100, 40)])
def test_decode_attention_matches_plain(cuda, s, window, qdtype):
    rng = np.random.default_rng(s)
    b, kv, g, hd = 4, 2, 6, 128
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    q = t(rng.standard_normal((b, kv, g, hd)).astype(np.float32)).to(qdtype)
    k8 = t(rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8))
    v8 = t(rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8))
    ks = t(rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32))
    vs = t(rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32))
    pos = np.asarray([5, 2 * s, 70, 3], np.int32)
    pb = np.full((b, s), -1, np.int32)
    for r in range(b):
        for p in range(max(0, pos[r] - s + 1), pos[r] + 1):
            pb[r, p % s] = p
    pb[3] = -1  # a row that sees nothing: the uniform mean of v
    args = [q, k8, ks, v8, vs, t(pb), t(pos)]
    got = da_ops.decode_attention_cuda(*args, window=window)
    plain = da_ref.decode_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    mean_v = (v8[3].float() * vs[3][..., None]).mean(0)        # (KV, hd)
    torch.testing.assert_close(got[3], mean_v[:, None].expand(kv, g, hd),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ring", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("L,window", [(1, None), (40, None), (40, 50)])
def test_attention_head_dim_168(cuda, L, window, ring):
    """gemma3-27b's head dim (168, not a multiple of 16): B2 and B4 within
    1e-4 of the plain version, B4 == B2 bit for bit, a row alone == the row
    in the batch; B5 over an int8 ring within 1e-4 of its plain version."""
    rng = np.random.default_rng(L + 168)
    args = _attention_case(rng, 4, L, 2, 2, 168, 200, ring, cuda)
    plain = ca_ref.chunk_attention_stream(*args, window=window)
    got = ca_ops.chunk_attention_cuda(*args, window=window)
    paged, gathered = _paged_case(rng, args, 8, cuda)
    pgot = ca_ops.chunk_attention_paged_cuda(*paged, window=window)
    ring_kernel = ca_ops.chunk_attention_cuda(*gathered, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    assert torch.equal(pgot, ring_kernel)
    for i in (0, 3):
        assert torch.equal(ca_ops.chunk_attention_cuda(*_row(args, i),
                                                       window=window),
                           got[i:i + 1])
    if L == 1:
        q, _, _, kc, ks, vc, vs, pb, positions, _ = args
        if ring != "int8":
            return
        dargs = [q[:, 0].contiguous(), kc, ks, vc, vs, pb,
                 positions[:, 0].contiguous()]
        dgot = da_ops.decode_attention_cuda(*dargs, window=window)
        dplain = da_ref.decode_attention_plain(*dargs, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(dgot, dplain, rtol=1e-4, atol=1e-4)


# the main path's attention shapes: cap 1024, 16-slot pages, 2 kv heads of
# 6 query heads, hd 128; partly full and wrapped rows
CAP, PAGE, KV, G, HD = 1024, 16, 2, 6, 128
FILLS = [0, 300, 1023, 1024, 1500, 2900, 64, 700]


def _rows_case(rng, L, ring, qdtype, dev):
    """Chunk-attention operands for len(FILLS) rows, lengths 1: row r's
    ring holds the FILLS[r] positions before its chunk. ring: "float" (q's
    dtype) or "int8"."""
    b = len(FILLS)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    f = lambda *s: t(rng.standard_normal(s).astype(np.float32)).to(  # noqa
        qdtype)
    q, kn, vn = f(b, L, KV, G, HD), f(b, L, KV, HD), f(b, L, KV, HD)
    ks = vs = None
    if ring == "int8":
        kc = t(rng.integers(-127, 128, (b, CAP, KV, HD)).astype(np.int8))
        vc = t(rng.integers(-127, 128, (b, CAP, KV, HD)).astype(np.int8))
        ks = t(rng.uniform(0.005, 0.02, (b, CAP, KV)).astype(np.float32))
        vs = t(rng.uniform(0.005, 0.02, (b, CAP, KV)).astype(np.float32))
    else:
        kc, vc = f(b, CAP, KV, HD), f(b, CAP, KV, HD)
    pb = np.full((b, CAP), -1, np.int32)
    for r, n in enumerate(FILLS):
        p = np.arange(max(0, n - CAP), n)
        pb[r, p % CAP] = p
    positions = (np.asarray(FILLS)[:, None] + np.arange(L)[None]).astype(
        np.int32)
    return [q, kn, vn, kc, ks, vc, vs, t(pb), t(positions),
            t(np.ones((b,), np.int32))]


def _first_token(args):
    """The L = 1 call of an L = 64 case's l = 0 query (one chunk key)."""
    return [a[:, :1].contiguous() if i in (0, 1, 2, 8) else a
            for i, a in enumerate(args)]


def _row(args, i):
    """Row i of every operand as a batch of one (fresh, aligned copies)."""
    return [None if a is None else a[i:i + 1].clone() for a in args]


@pytest.mark.parametrize("qdtype,ring", [(torch.bfloat16, "float"),
                                         (torch.bfloat16, "int8"),
                                         (torch.float32, "float"),
                                         (torch.float32, "int8")])
def test_attention_rows_are_invariant_across_batch_and_L(cuda, qdtype, ring):
    """B2 and B4: a row's bits alone (B = 1) and in the batch of 8, at L = 1
    and at l = 0 of L = 64 with length 1; B4 over a shuffled table with null
    pages equals B2 on the gathered ring; both equal the plain version."""
    rng = np.random.default_rng(21)
    a64 = _rows_case(rng, 64, ring, qdtype, cuda)
    a1 = _first_token(a64)
    out1 = ca_ops.chunk_attention_cuda(*a1)
    out64 = ca_ops.chunk_attention_cuda(*a64)
    plain = ca_ref.chunk_attention_stream(*a1)
    torch.cuda.synchronize()
    assert torch.equal(out64[:, :1], out1)
    torch.testing.assert_close(out1, plain, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(out64, ca_ref.chunk_attention_stream(*a64),
                               rtol=1e-4, atol=1e-4)
    for i in (0, 2, 5):
        assert torch.equal(ca_ops.chunk_attention_cuda(*_row(a1, i)),
                           out1[i:i + 1])
        assert torch.equal(ca_ops.chunk_attention_cuda(*_row(a64, i)),
                           out64[i:i + 1])
    paged64, gathered64 = _paged_case(rng, a64, PAGE, cuda)
    paged1 = [a[:, :1].contiguous() if i in (0, 1, 2, 9) else a
              for i, a in enumerate(paged64)]
    p1 = ca_ops.chunk_attention_paged_cuda(*paged1)
    p64 = ca_ops.chunk_attention_paged_cuda(*paged64)
    torch.cuda.synchronize()
    assert torch.equal(p64[:, :1], p1)
    assert torch.equal(p64, ca_ops.chunk_attention_cuda(*gathered64))
    assert torch.equal(p1, ca_ops.chunk_attention_cuda(
        *_first_token(gathered64)))
    torch.testing.assert_close(
        p64, ca_ref.chunk_attention_paged_stream(*paged64), rtol=1e-4,
        atol=1e-4)


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_decode_attention_rows_are_invariant_and_blind_rows(cuda, qdtype,
                                                            window):
    """B5 at (8, 1024, 2, 6, 128): rows alone equal rows in the batch bit for
    bit; the row that sees nothing gives the uniform mean of v over the whole
    ring (every part's in-ring slots, empty ones included)."""
    rng = np.random.default_rng(22)
    b = len(FILLS)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    q = t(rng.standard_normal((b, KV, G, HD)).astype(np.float32)).to(qdtype)
    k8 = t(rng.integers(-127, 128, (b, CAP, KV, HD)).astype(np.int8))
    v8 = t(rng.integers(-127, 128, (b, CAP, KV, HD)).astype(np.int8))
    ks = t(rng.uniform(0.005, 0.02, (b, CAP, KV)).astype(np.float32))
    vs = t(rng.uniform(0.005, 0.02, (b, CAP, KV)).astype(np.float32))
    pb = np.full((b, CAP), -1, np.int32)
    for r, n in enumerate(FILLS):
        if r != 1:  # row 1 sees nothing
            p = np.arange(max(0, n - CAP + 1), n + 1)
            pb[r, p % CAP] = p
    args = [q, k8, ks, v8, vs, t(pb), t(np.asarray(FILLS, np.int32))]
    got = da_ops.decode_attention_cuda(*args, window=window)
    plain = da_ref.decode_attention_plain(*args, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    mean_v = (v8[1].float() * vs[1][..., None]).mean(0)
    torch.testing.assert_close(got[1], mean_v[:, None].expand(KV, G, HD),
                               rtol=1e-4, atol=1e-4)
    for i in (0, 1, 5):
        assert torch.equal(
            da_ops.decode_attention_cuda(*_row(args, i), window=window),
            got[i:i + 1])


@pytest.mark.parametrize("r,g", [(1000, 128), (333, 64), (7, 2000)])
def test_trit_search_equals_plain(cuda, r, g):
    rng = np.random.default_rng(r)
    w = torch.from_numpy(rng.standard_normal((r, g)).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(0.1, 1.0, (r, 2)).astype(np.float32))
    w[0, :8] = 0.0                    # ties: (0, 0) must win
    alpha[1] = torch.tensor([0.5, 0.5])
    w[1, :4] = torch.tensor([0.25, -0.25, 0.75, 1.0])  # midpoints tie
    w, alpha = w.to(cuda), alpha.to(cuda)
    t1, t2 = ps_ops.ptqtp_search_cuda(w, alpha)
    p1, p2 = torch.empty_like(w), torch.empty_like(w)
    ps_ref.ptqtp_search_plain(w, alpha, p1, p2)
    torch.cuda.synchronize()
    assert torch.equal(t1, p1) and torch.equal(t2, p2)


def test_paged_engine_is_fleet_invariant_and_equals_ring(cuda):
    """The paged engine on the card: requests sharing a prefix give the
    same tokens alone, in the fleet (with prefix-cache hits and a wrapping
    request that forks) and on the ring, through B4."""
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    model, _ = quantize_tree(model, PTQTPConfig(group_size=64, t_max=5))
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 64).tolist()
    prompts = [prefix + rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 100, 1)]
    budgets = (6, 6, 120, 6)  # the third wraps its 256-token ring

    def serve(idx, slots, layout):
        eng = ServingEngine(model, cfg, EngineConfig(
            max_slots=slots, capacity=256, prefill_chunk=64,
            kv_layout=layout, page_size=16))
        hs = [eng.submit(prompts[i], SamplingParams(max_new_tokens=budgets[i]))
              for i in idx]
        eng.run()
        return [h.output for h in hs], eng

    serve([0], 1, "paged")  # warm-up: every kernel built
    reset_launch_counts()
    fleet, eng = serve(range(4), 2, "paged")
    counts = launch_counts()
    assert counts["chunk_attention_paged"] > 0 and \
        counts["chunk_attention"] == 0, counts
    assert eng.alloc.hits > 0 and eng.alloc.forks > 0
    eng.alloc.check()
    assert eng.alloc.used_pages() == eng.alloc.cached_pages()
    assert serve(range(4), 2, "ring")[0] == fleet
    for i in range(4):
        assert serve([i], 1, "paged")[0][0] == fleet[i]


def _quantized_smoke(dev):
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    model, _ = quantize_tree(model, PTQTPConfig(group_size=64, t_max=5))
    return model, cfg


def test_artifact_round_trip_on_the_card(cuda, tmp_path):
    """A model quantized on the card, written through ArtifactWriter and
    loaded back onto the card (crc32 checked): every tensor equal byte for
    byte, and the same greedy tokens."""
    model, cfg = _quantized_smoke(cuda)
    w = ArtifactWriter(tmp_path / "a", arch="qwen2-1.5b",
                       model_config=afmt.model_config_to_json(cfg),
                       ptqtp_config=afmt.ptqtp_config_to_json(
                           PTQTPConfig(group_size=64, t_max=5)))
    for path, leaf in afmt.iter_tree_leaves(to_reference_tree(model, cfg)):
        if isinstance(leaf, QuantizedKernel):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    timings = {}
    loaded, lcfg, _ = load_model(w.finalize(), verify="full", device=cuda,
                                 timings=timings)
    assert lcfg == cfg and "device_copy" in timings
    a, b = model.state_dict(), loaded.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert b[k].is_cuda and torch.equal(a[k], b[k]), k
    prompts = [[5, 9, 17, 2], list(range(1, 70)), [7]]

    def serve(m):
        eng = ServingEngine(m, cfg, EngineConfig(max_slots=3, capacity=128))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=6)) for p in prompts]
        eng.run()
        return [h.output for h in hs]

    assert serve(loaded) == serve(model)


def _decode_profile(eng):
    """Wrap the engine's decode loop: per call, whether the fleet's arrays
    were rebuilt (copied to the device anew), the host syncs it made
    (``torch.cuda`` sync-debug warnings) and the kernels the device ran
    (``torch.profiler`` events)."""
    from torch.profiler import ProfilerActivity, profile

    inner, calls = eng._decode_loop, []

    def traced(n_steps, poison=None):
        rebuilt = eng._slot_arrays is None
        graphs = len(eng._loop_cache)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = inner(n_steps, poison)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA)
        syncs = sum("called a synchronizing" in str(m.message)
                    for m in seen)
        # a dispatch whose graph was captured in this call synchronizes for
        # the capture; the others are replays
        calls.append((n_steps, (rebuilt, syncs), kernels,
                      len(eng._loop_cache) > graphs))
        return out

    eng._decode_loop = traced
    return calls


def test_nan_containment_on_the_card(cuda):
    """A NaN row poisoned inside a 4-step dispatch retires "error" with the
    clean run's tokens so far; its neighbour is unchanged; a decode
    dispatch replayed from its graph syncs the host once (its tokens and
    flags out; its inputs go in without a sync, also after the fleet
    changed), with or without an injector; the injector's engine runs more
    device kernels (the poison), the production engine none of them."""
    model, cfg = _quantized_smoke(cuda)
    prompts = [[5, 9, 17, 2], [1, 2, 3]]
    out = {}
    for plan in (None, FaultPlan(), FaultPlan().nan_logits(1, 2)):
        eng = ServingEngine(
            model, cfg, EngineConfig(max_slots=2, capacity=64,
                                     decode_chunk=4),
            injector=None if plan is None else FaultInjector(plan))
        calls = _decode_profile(eng)
        hs = [eng.submit(p, SamplingParams(max_new_tokens=9))
              for p in prompts]
        eng.run()
        out["none" if plan is None else len(plan.nans)] = (
            [(h.output, h.finish_reason) for h in hs], calls,
            dict(eng.quarantined))
    clean, calls_clean, _ = out["none"]
    empty, calls_inj, _ = out[0]
    (keep, victim), calls_nan, quarantined = out[1]
    assert empty == clean
    assert keep == clean[0]
    assert victim == (clean[1][0][:2], "error")
    assert quarantined == {1: 1 + 2}  # step 1 + quarantine_steps
    syncs = {}
    for calls in (calls_clean, calls_inj, calls_nan):
        for _, (rebuilt, n), _, captured in calls:
            if not captured:
                assert syncs.setdefault(rebuilt, n) == n, (calls_clean,
                                                           calls_nan)
    assert syncs == {False: 1, True: 1}, syncs
    assert [c[0] for c in calls_clean] == [c[0] for c in calls_inj]
    assert all(k_inj > k for (_, _, k, _), (_, _, k_inj, _)
               in zip(calls_clean, calls_inj))


def _bf16_smoke(dev):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-1.5b"),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    model, _ = quantize_tree(model, PTQTPConfig(group_size=64, t_max=5))
    return model, cfg


def _graph_serve(model, cfg, prompts, params, capture=True,
                 cls=ServingEngine, **kw):
    eng = cls(model, cfg, EngineConfig(**dict(
        dict(max_slots=4, capacity=256, prefill_chunk=64), **kw)))
    eng._capture = capture
    hs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
    eng.run()
    return [h.output for h in hs], eng


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_graph_and_eager_streams_equal(cuda, layout, sampled):
    """Every dispatch replayed from its CUDA graph gives the eager bodies'
    tokens; a request alone gives its fleet tokens. The fleet's later
    prefills run on 2 of its 4 slots (the rows gathered from the state,
    prefilled and written back); alone, one slot prefills the state in
    place."""
    model, cfg = _bf16_smoke(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 140, 129)]
    params = [SamplingParams(max_new_tokens=9) for _ in prompts]
    if sampled:
        params[0] = SamplingParams(max_new_tokens=9, temperature=0.8, seed=5)
        params[3] = SamplingParams(max_new_tokens=9, temperature=0.8, seed=7,
                                   top_k=20, top_p=0.9)
    kw = dict(kv_layout=layout, page_size=16)
    graph, eng = _graph_serve(model, cfg, prompts, params, **kw)
    eager, eager_eng = _graph_serve(model, cfg, prompts, params,
                                    capture=False, **kw)
    assert graph == eager
    stats = eng.graph_stats()["dispatches"]
    assert stats and all(d["graph"] for d in stats)
    for kind in ("prefill", "decode"):
        assert sum(d["replays"] for d in stats if d["kind"] == kind) \
            == eng._dispatch_counts[kind]
    assert not any(d["graph"] for d in eager_eng.graph_stats()["dispatches"])
    for e in (eng, eager_eng):
        assert e.compile_stats()["prefill_row_buckets"] == [2, 4]
        assert e.prefill_compact > 0
    for i in (2, 3):
        assert _graph_serve(model, cfg, prompts[i:i + 1], params[i:i + 1],
                            max_slots=1, **kw)[0][0] == graph[i]


def test_serial_admit_equals_bucketed_on_the_card(cuda):
    model, cfg = _bf16_smoke(cuda)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 70, 129, 30)]
    params = [SamplingParams(max_new_tokens=7) for _ in prompts]
    params[1] = SamplingParams(max_new_tokens=7, temperature=0.8, seed=3)
    bucketed, _ = _graph_serve(model, cfg, prompts, params)
    serial, eng = _graph_serve(model, cfg, prompts, params,
                               cls=SerialAdmitEngine)
    assert serial == bucketed
    assert eng.compile_stats()["n_prefill_compiles"] == 4
    assert all(isinstance(d, GraphDispatch)
               for d in eng._prefill_cache.values())


def test_one_host_sync_per_decode_dispatch(cuda):
    """After warmup() every decode dispatch is a replay: one host sync
    each under torch.cuda's sync-debug mode, also right after the fleet
    changed; the fleet adds no dispatch to the caches."""
    model, cfg = _bf16_smoke(cuda)
    eng = ServingEngine(model, cfg, EngineConfig(max_slots=2, capacity=128,
                                                 prefill_chunk=16,
                                                 decode_chunk=4))
    eng.warmup()
    before = eng.compile_stats()
    calls = _decode_profile(eng)
    hs = [eng.submit([1, 2, 3], SamplingParams(max_new_tokens=5)),
          eng.submit(list(range(40)), SamplingParams(max_new_tokens=11)),
          eng.submit([4, 5], SamplingParams(max_new_tokens=6,
                                            temperature=0.8, seed=1))]
    eng.run()
    assert all(h.finish_reason == "length" for h in hs)
    assert eng.compile_stats() == dict(before, admits=3,
                                       prefill_steps=eng.prefill_steps)
    assert calls and not any(c[3] for c in calls)
    assert {c[1] for c in calls} == {(False, 1), (True, 1)}, calls


def test_device_spans_take_no_host_sync(cuda):
    """After warmup() the replays' device spans (timing events inside each
    graph) advance the timed counters without a host sync of their own:
    under torch.cuda's sync-debug mode the run's syncs are exactly its
    sync spans (one a decode dispatch, one a prefill that finished a
    prompt); every decode step is timed, and the spans are shorter than
    the decode dispatches' wall time from launch to sync."""
    model, cfg = _bf16_smoke(cuda)
    eng = ServingEngine(model, cfg, EngineConfig(max_slots=2, capacity=128,
                                                 prefill_chunk=16,
                                                 decode_chunk=4),
                        observability=Observability(trace=True))
    eng.warmup()
    reg = eng.obs.registry
    before = reg.counters()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            hs = [eng.submit([1, 2, 3], SamplingParams(max_new_tokens=5)),
                  eng.submit(list(range(40)),
                             SamplingParams(max_new_tokens=11)),
                  eng.submit([4, 5], SamplingParams(max_new_tokens=6,
                                                    temperature=0.8, seed=1))]
            eng.run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert all(h.finish_reason == "length" for h in hs)
    syncs = sum("called a synchronizing" in str(m.message) for m in seen)
    events = eng.obs.trace.events()
    assert syncs == sum(e.name in ("prefill_sync", "decode_sync")
                        for e in events) > 0

    def grew(name):
        return reg.value(name) - before[name]

    steps = grew("serving_decode_steps_total")
    assert grew("serving_decode_device_timed_total") == steps > 0
    assert 0 < grew("serving_prefill_device_timed_total") \
        <= grew("serving_prefill_dispatches_total")
    wall = sum(e.dur for e in events
               if e.name in ("decode_dispatch", "decode_sync"))
    assert 0 < grew("serving_decode_device_seconds_total") < wall
    assert grew("serving_prefill_device_seconds_total") > 0
    assert eng._untimed == []


class _NoEvent:
    """A timing event that records nothing: a graph captured with it holds
    no event node."""

    def record(self, stream=None):
        pass


def test_event_nodes_change_no_token(cuda, monkeypatch):
    """The two timing events inside every graph change no token: the fleet
    served from graphs with them gives, bit for bit, the tokens of graphs
    captured without them and of the eager bodies, on the same kernel
    nodes a graph; their spans timed every decode step."""
    model, cfg = _bf16_smoke(cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 140, 129)]
    params = [SamplingParams(max_new_tokens=9) for _ in prompts]
    params[0] = SamplingParams(max_new_tokens=9, temperature=0.8, seed=5)
    params[3] = SamplingParams(max_new_tokens=9, temperature=0.8, seed=7,
                               top_k=20, top_p=0.9)
    timed, eng = _graph_serve(model, cfg, prompts, params)
    assert eng.decode_timed == eng.steps > 0
    eager, _ = _graph_serve(model, cfg, prompts, params, capture=False)
    monkeypatch.setattr(graphs, "_timing_events",
                        lambda: (_NoEvent(), _NoEvent()))
    monkeypatch.setattr(graphs._Timed, "device_s", lambda self: None)
    bare, bare_eng = _graph_serve(model, cfg, prompts, params)
    assert timed == bare == eager
    assert bare_eng.decode_timed == bare_eng.prefill_timed == 0

    def nodes(e):
        return [(d["kind"], d["key"], d["kernels"])
                for d in e.graph_stats()["dispatches"]]
    assert nodes(eng) == nodes(bare_eng)
    assert all(d["kernels"] > 0 for d in eng.graph_stats()["dispatches"])


def test_replays_count_the_launches_they_run(cuda):
    model, cfg = _bf16_smoke(cuda)
    eng = ServingEngine(model, cfg, EngineConfig(max_slots=2, capacity=64,
                                                 prefill_chunk=16,
                                                 decode_chunk=4))
    eng.warmup()
    key = (4, False, 1, False, False)
    graph = eng._loop_cache[key]
    assert isinstance(graph, GraphDispatch) and graph.capture_s > 0
    # 7 linear layers a block and the lm_head, each step
    assert graph.launches["ternary_matvec"] == 4 * (7 * cfg.n_layers + 1)
    idle = eng._decode_input(np.zeros((2,), np.int32),
                             np.full((2,), -1, np.int32), eng._idle_arrays(1))
    reset_launch_counts()
    with eng._on_stream():
        for _ in range(3):
            graph(idle)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts == {k: 3 * n for k, n in graph.launches.items()}
    assert counts["chunk_attention"] == 3 * 4 * cfg.n_layers


def test_capture_counts_only_the_capturing_threads_launches(cuda):
    """Another thread launches kernels eagerly all through a capture: the
    graph's count holds the body's launches alone."""
    scale = torch.ones(64, device=cuda)
    x, other_x = (torch.randn(4, 64, device=cuda) for _ in range(2))
    norm_ops.add_rms_norm(scale, other_x, other_x)  # loaded before the race
    stop, running = threading.Event(), threading.Event()

    def other():
        while not stop.is_set():
            norm_ops.add_rms_norm(scale, other_x, other_x)
            running.set()

    def body(inp):
        return norm_ops.rms_norm(scale, norm_ops.rms_norm(scale, x))

    worker = threading.Thread(target=other)
    worker.start()
    try:
        assert running.wait(30)
        graph = GraphDispatch(body, np.zeros((4,), np.int32), device=cuda,
                              stream=torch.cuda.Stream(),
                              pool=torch.cuda.graph_pool_handle())
    finally:
        stop.set()
        worker.join(30)
    torch.cuda.synchronize()
    assert {k: n for k, n in graph.launches.items() if n} == {"rms_norm": 2}


def test_capture_survives_collecting_dead_engines(cuda):
    """An engine and its metrics registry hold each other, so a dropped
    engine (and its graphs) waits for the garbage collector. A collection
    during a capture would destroy those graphs mid-capture, which the
    capturing stream refuses: captures run with automatic collection off.
    Here the collector is set to run at nearly every allocation."""
    import gc

    model, cfg = _bf16_smoke(cuda)
    ecfg = EngineConfig(max_slots=2, capacity=64, prefill_chunk=16,
                        decode_chunk=4)
    threshold = gc.get_threshold()
    try:
        for _ in range(3):
            dead = ServingEngine(model, cfg, ecfg)
            dead.submit([1, 2, 3], SamplingParams(max_new_tokens=5)).result()
            del dead
            gc.set_threshold(1)
            eng = ServingEngine(model, cfg, ecfg)
            h = eng.submit(list(range(20)), SamplingParams(max_new_tokens=6))
            h.result()
            gc.set_threshold(*threshold)
            assert h.finish_reason == "length" and len(h.output) == 6
            assert all(isinstance(d, GraphDispatch)
                       for d in eng._loop_cache.values())
    finally:
        gc.set_threshold(*threshold)


# ------------------------------------------------------- concurrent frontend
def _wait_until(pred, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_capture_on_the_driver_thread_while_an_engine_is_built(cuda):
    """An engine that was not warmed captures at first use on the driver's
    thread while another thread builds engines (allocations, a claimed
    stream, scratch) and copies to and from the card, as a supervisor's
    factory does: every capture succeeds, with the eager bodies' streams.
    (That thread draws no random numbers: PyTorch ties the default CUDA
    generator to every capture, so no other thread may draw from it while
    one runs.)"""
    model, cfg = _bf16_smoke(cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 40, 140, 129)]
    params = [SamplingParams(max_new_tokens=9) for _ in prompts]
    eager, _ = _graph_serve(model, cfg, prompts, params, capture=False)
    ecfg = EngineConfig(max_slots=4, capacity=256, prefill_chunk=64)
    stop, built, errors = threading.Event(), [], []

    def build_engines():
        try:
            while not stop.is_set():
                eng = ServingEngine(model, cfg, ecfg)
                x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
                built.append(float(x.sum().item()))  # a synchronous copy
                del eng
        except Exception as e:  # reported below
            errors.append(e)

    driver = EngineDriver(ServingEngine(model, cfg, ecfg)).start()
    th = threading.Thread(target=build_engines, daemon=True)
    th.start()
    try:
        assert _wait_until(lambda: built or errors)
        hs = [driver.submit(p, sp) for p, sp in zip(prompts, params)]
        got = [list(h.result(timeout=300).tokens) for h in hs]
        n_built = len(built)
    finally:
        stop.set()
        th.join(timeout=120)
        driver.close()
    assert not th.is_alive() and not errors, errors
    assert got == eager
    assert n_built >= 2
    stats = driver.engine.graph_stats()["dispatches"]
    assert stats and all(d["graph"] and d["capture_s"] > 0 for d in stats)


def _settled_bytes(eng):
    """Bytes the live ``eng`` may hold beyond another generation's: its
    graphs' static inputs and outputs (its pool's live tensors) and its
    attention scratch, each rounded up to the allocator's 512-byte blocks.
    The margin of the flat-memory gate."""
    def nbytes(t):
        return -(-t.numel() * t.element_size() // 512) * 512

    key = (eng._stream.device_index, eng._stream.cuda_stream)
    scratch = list(ca_ops._WORKSPACES.get(key, ())) + [
        t for ws in ca_ops._RETIRED.get(key, ()) for t in ws]
    dispatches = list(eng._loop_cache.values()) + list(
        eng._prefill_cache.values())
    return sum(nbytes(t) for t in scratch) + sum(
        nbytes(d.static_in) + nbytes(d.out) for d in dispatches)


def test_device_memory_flat_across_supervisor_rebuilds(cuda):
    """Generations 0-2 each serve a fleet, settle, then die on a one-request
    crash; generation 3 serves the fleet too. After each has settled the
    dead generations are gone (engines collected, streams released, their
    scratch dropped) and device memory is that of generation 1 within one
    engine's graph tensors and scratch."""
    model, cfg = _bf16_smoke(cuda)
    ecfg = EngineConfig(max_slots=2, capacity=128, prefill_chunk=16,
                        decode_chunk=4)
    engines = []

    def factory():
        plan = FaultPlan()
        if len(engines) < 3:
            plan = plan.engine_crash("decode", 2)  # the fleet uses #0, #1
        eng = ServingEngine(model, cfg, ecfg, injector=FaultInjector(plan))
        engines.append(weakref.ref(eng))
        return eng

    sup = EngineSupervisor(factory, restart_backoff_s=0.01, max_restarts=9,
                           blacklist_after=9).start()
    mem, keys, margins = [], [], []
    try:
        for g in range(4):
            assert _wait_until(lambda: sup.generation == g
                               and sup.driver is not None)
            hs = [sup.submit([1, 2, 3], SamplingParams(max_new_tokens=8)),
                  sup.submit([4, 5], SamplingParams(max_new_tokens=8,
                                                    temperature=0.8,
                                                    seed=1))]
            assert [h.result(timeout=300).finish_reason for h in hs] == \
                ["length"] * 2
            graphs.collect_garbage()
            torch.cuda.synchronize()
            live = [r() for r in engines if r() is not None]
            assert len(live) == 1 and live[0] is sup.engine
            key = (live[0]._stream.device_index, live[0]._stream.cuda_stream)
            keys.append(key)
            for dead in keys[:-1]:
                assert dead not in graphs._CLAIMED
                assert dead not in ca_ops._WORKSPACES
                assert dead not in ca_ops._RETIRED
            mem.append(torch.cuda.memory_allocated())
            margins.append(_settled_bytes(live[0]))
            del live
            if g < 3:  # a lone request dies with the engine
                crash = sup.submit([7, 8], SamplingParams(max_new_tokens=8))
                assert crash.result(timeout=300).finish_reason == "error"
    finally:
        sup.close()
    assert sup.restarts == 3
    assert mem[3] - mem[1] <= margins[3], (mem, margins)


def test_released_abandoned_thread_never_launches(cuda):
    """A step of generation 0 hangs (the watchdog rebuilds the engine on
    another stream and the requests replay there); when the wedged thread
    is released it launches nothing more, and the new generation's stream
    is not the dead one's."""
    model, cfg = _bf16_smoke(cuda)
    ecfg = EngineConfig(max_slots=2, capacity=128, prefill_chunk=16,
                        decode_chunk=4)
    jobs = [([5, 9, 17, 2], SamplingParams(max_new_tokens=12)),
            ([1, 2, 3], SamplingParams(max_new_tokens=12, temperature=0.8,
                                       seed=2))]
    want, _ = _graph_serve(model, cfg, [p for p, _ in jobs],
                           [sp for _, sp in jobs], max_slots=2,
                           capacity=128, prefill_chunk=16, decode_chunk=4)
    inj = FaultInjector(FaultPlan().stall_step(at_step=3, hang_s=60.0),
                        clock=VirtualClock())
    engines = []

    def factory():
        eng = ServingEngine(model, cfg, ecfg,
                            injector=None if engines else inj)
        engines.append(eng)
        return eng

    sup = EngineSupervisor(factory, watchdog_step_timeout_s=5.0,
                           restart_backoff_s=0.01, blacklist_after=9).start()
    try:
        hs = [sup.submit(p, sp) for p, sp in jobs]
        assert inj.stall_engaged.wait(timeout=120)
        wedged = next(t for t in threading.enumerate()
                      if t.name == "engine-driver-gen0")
        assert _wait_until(lambda: len(sup.recoveries) == 1)
        got = [list(h.result(timeout=300).tokens) for h in hs]
        old, new = engines
        assert old._stream.cuda_stream != new._stream.cuda_stream
        counts, steps = launch_counts(), dict(old._dispatch_counts)
        inj.release_stalls()
        wedged.join(timeout=120)
        assert not wedged.is_alive()
        torch.cuda.synchronize()
        assert launch_counts() == counts  # the new generation is idle
        assert old._dispatch_counts == steps
    finally:
        inj.release_stalls()
        sup.close()
    assert got == want


def _recurrence_checks(kern, plain, args, state_at, lengths_at, steps, rows):
    """kernel vs plain (output, state); a row alone == its batch row; one
    S-step call == S one-step calls (every row full). Returns the output
    pair and the state pair."""
    def run(fn, a):
        a = list(a)
        a[state_at] = a[state_at].clone()
        return fn(*a), a[state_at]

    got, got_s = run(kern, args)
    want, want_s = run(plain, args)
    for i in range(got.shape[0]):
        one = [a[i:i + 1].clone() if j in rows else a
               for j, a in enumerate(args)]
        o, s1 = run(kern, one)
        assert torch.equal(o, got[i:i + 1]) and torch.equal(s1, got_s[i:i + 1])
    s = args[0].shape[1]
    full = list(args)
    full[lengths_at] = torch.full_like(args[lengths_at], s)
    chunk, chunk_s = run(kern, full)
    full[state_at] = full[state_at].clone()
    full[lengths_at] = torch.ones_like(full[lengths_at])
    outs = [kern(*[a[:, t:t + 1].contiguous() if j in steps else a
                   for j, a in enumerate(full)]) for t in range(s)]
    assert torch.equal(torch.cat(outs, 1), chunk)
    assert torch.equal(full[state_at], chunk_s)
    return (got, want), (got_s, want_s)


def _gate_blocks(y, n_blocks):
    """(B, S, R) → the gates' batched-product layout (n_blocks, B·S, rb),
    its blocks a 128-row multiple apart, as ``bmm_fixed_rows`` returns."""
    b, s, r = y.shape
    m = b * s
    buf = torch.zeros((n_blocks, -(-m // 128) * 128, r // n_blocks),
                      dtype=y.dtype, device=y.device)
    buf[:, :m] = y.reshape(m, n_blocks, r // n_blocks).transpose(0, 1)
    return buf[:, :m]


def _gated_scan_case(cuda, dtype, s, nb, rb, seed):
    """The fused RG-LRU gate-and-scan against its plain version on five
    rows (ragged and idle lengths, nonzero biases), R = nb blocks of rb:
    the output and h bit for bit; a row alone == its batch row; one S-step
    call == S one-step calls."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    b, r = 5, nb * rb

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * std).to(dtype)

    ba, bx = rnd(r, std=0.1), rnd(r, std=0.1)
    lam = torch.linspace(-4.3, -0.7, r, device=cuda).to(dtype)
    h = torch.randn((b, r), generator=g, device=cuda)
    lengths = torch.tensor([s, 0, 1, s // 2, s], dtype=torch.int32,
                           device=cuda)

    def route(fn):
        return lambda ya, yx, c, gw, h, lengths: fn(
            _gate_blocks(ya, nb), _gate_blocks(yx, nb), ba, bx, c, gw, lam,
            h, lengths)

    args = [rnd(b, s, r), rnd(b, s, r), rnd(b, s, r), rnd(b, s, r), h,
            lengths]
    (got, want), (got_h, want_h) = _recurrence_checks(
        route(scan_ops.rglru_gated_scan_cuda),
        route(scan_ref.rglru_gated_scan_plain), args, 4, 5, (0, 1, 2, 3),
        (0, 1, 2, 3, 4, 5))
    assert got.dtype == dtype
    assert torch.equal(got, want) and torch.equal(got_h, want_h)


@pytest.mark.parametrize("s", [1, 9])
def test_rglru_scan_matches_plain_and_is_invariant(cuda, s):
    """The case the scan alone was held to, on the fused kernel: f32, R =
    300 as 3 blocks of 100 (a ragged last 32-channel block), S = 1 and 9."""
    _gated_scan_case(cuda, torch.float32, s, 3, 100, 0)


@pytest.mark.parametrize("s", [1, 64, 70])   # 70: two tiles of 32, a ragged third
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_gated_scan_matches_plain_and_is_invariant(cuda, dtype, s):
    """The fused RG-LRU gate-and-scan against its plain version: the
    output and h bit for bit; a row alone == its batch row; one S-step call
    == S one-step calls. R = 3 blocks of 34 (off the kernel's 32-channel
    grid), nonzero biases, ragged and idle rows."""
    _gated_scan_case(cuda, dtype, s, 3, 34, 2)


@pytest.mark.parametrize("ring", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 40])
@pytest.mark.parametrize("hd", [64, 96])
def test_attention_head_dims_of_the_stub_archs(cuda, hd, L, ring):
    """musicgen-large's hd 64 and phi-3-vision-4.2b's hd 96, one query
    head a kv head (MHA): B2 within 1e-4 of its plain version, B4 == B2
    bit for bit, a row alone == its batch row."""
    rng = np.random.default_rng(L + hd)
    args = _attention_case(rng, 4, L, 4, 1, hd, 200, ring, cuda)
    plain = ca_ref.chunk_attention_stream(*args)
    got = ca_ops.chunk_attention_cuda(*args)
    paged, gathered = _paged_case(rng, args, 8, cuda)
    pgot = ca_ops.chunk_attention_paged_cuda(*paged)
    ring_kernel = ca_ops.chunk_attention_cuda(*gathered)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    assert torch.equal(pgot, ring_kernel)
    for i in (0, 3):
        assert torch.equal(ca_ops.chunk_attention_cuda(*_row(args, i)),
                           got[i:i + 1])


@pytest.mark.parametrize("s", [1, 7, 70])   # 70: two tiles of 32, a ragged third
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_matches_plain_and_is_invariant(cuda, dtype, hd, s):
    g = torch.Generator(device=cuda).manual_seed(1)
    b, nh = 4, 3

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std

    r, k, v = (rnd(b, s, nh, hd, std=0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(b, s, nh, hd, std=0.5) - 1.0))
    u = rnd(nh, hd, std=0.1).to(dtype)
    state = rnd(b, nh, hd, hd, std=0.1)
    lengths = torch.tensor([s, 0, 1, s // 2], dtype=torch.int32, device=cuda)
    scale = (1.0 + rnd(nh * hd, std=0.1)).to(dtype)
    (got, want), (got_s, want_s) = _recurrence_checks(
        wkv_ops.wkv6_cuda, wkv_ref.wkv6_plain,
        [r, k, v, w, u, state, lengths, scale], 5, 6, (0, 1, 2, 3),
        (0, 1, 2, 3, 5, 6))
    assert torch.equal(got_s, want_s)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 1e-4
    else:
        assert float((diff - 2.0 ** -7 * want.float().abs()).max()) <= 2.0 ** -7


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_engines_are_fleet_and_layout_invariant(cuda, arch):
    """bf16 smoke models (tensor-core route): every kernel of the path
    launches; a request alone gives its fleet tokens; rwkv6's paged fleet
    and recurrentgemma's at a capacity within its window give the ring's."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    model, _ = quantize_tree(model, PTQTPConfig(group_size=64, t_max=5))
    rng = np.random.default_rng(0)
    cap = 8 if arch == "recurrentgemma-2b" else 256
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in ((5, 8, 3, 7) if cap == 8 else (5, 40, 140, 129))]

    def serve(ps, slots, **kw):
        eng = ServingEngine(model, cfg, EngineConfig(
            max_slots=slots, capacity=cap, prefill_chunk=64, **kw))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=6)) for p in ps]
        eng.run()
        return [h.output for h in hs]

    reset_launch_counts()
    fleet = serve(prompts, 4)
    counts = launch_counts()
    path = ["ternary_matvec", "rms_norm", "add_rms_norm",
            "wkv6" if arch == "rwkv6-3b" else "rglru_scan"]
    assert all(counts[k] > 0 for k in path), counts
    for i in (2, 3):
        assert serve(prompts[i:i + 1], 1)[0] == fleet[i]
    assert serve(prompts, 4, kv_layout="paged", page_size=4) == fleet


# ------------------------------------------------------- training (slice 14)
def _norm_bwd_close(got, want, dtype, what):
    """Within the stated tolerance of the tensor's largest |value|: f32
    1e-5 (dscale 1e-4: 32-row tiles summed in another order than
    torch.sum's), bf16 one bf16 step (2^-7)."""
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    if what == "dscale" and dtype == torch.float32:
        tol = 1e-4
    got, want = got.float(), want.float()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    assert err <= tol, (what, err)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("d", [64, 1536, 2560, 5376, 16384])
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_matches_plain_and_repeats(cuda, dtype, scale_dtype,
                                                     d, res):
    """The norm's backward kernel (with and without add_rms_norm's residual
    gradient) against the plain backward written out, at the models'
    widths (16384: the forward's two-pass width) and 8 x 130 rows (ragged
    against the 32-row dscale tiles); a second call gives the same bits
    (no float atomics)."""
    rng = np.random.default_rng(d + 7 * res)
    x, dy, dres = (torch.from_numpy(rng.standard_normal((8, 130, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (d,)).astype(
        np.float32)).to(cuda, scale_dtype)
    dres = dres if res else None
    before = launch_counts()
    dx, dscale = norm_ops.rms_norm_backward(scale, x, dy, 1e-6, dres)
    name = "add_rms_norm_bwd" if res else "rms_norm_bwd"
    assert launch_counts()[name] == before[name] + 1
    want_dx, want_ds = norm_ref.rms_norm_backward_plain(scale, x, dy, 1e-6,
                                                        dres)
    assert dx.dtype == dtype and dscale.dtype == scale_dtype
    _norm_bwd_close(dx, want_dx, dtype, "dx")
    _norm_bwd_close(dscale, want_ds, scale_dtype, "dscale")
    dx2, dscale2 = norm_ops.rms_norm_backward(scale, x, dy, 1e-6, dres)
    assert torch.equal(dx, dx2) and torch.equal(dscale, dscale2)


def _device_kernels(fn):
    """The kernels one call of ``fn`` launches on the card."""
    from repro_torch.kernels import _build

    return _build.graph_kernels(fn)


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("rows", [1, 31, 33, 70])
@pytest.mark.parametrize("d", [1536, 16384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_backward_tile_edges_and_launches(cuda, dtype, d, rows, res):
    """The norm's backward at the edges of its 32-row tiles (one row, rows
    that fill no tile, one more than a tile, two tiles and a ragged
    third), on the register route (1536) and the two-pass one (16384):
    within the kernel's tolerance of the plain backward, the same bits at
    a second call, one count and at most two kernels a call."""
    rng = np.random.default_rng(rows + 3 * res + d)
    x, dy, dres = (torch.from_numpy(rng.standard_normal((rows, d)).astype(
        np.float32)).to(cuda, dtype) for _ in range(3))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (d,)).astype(
        np.float32)).to(cuda, dtype)
    dres = dres if res else None
    name = "add_rms_norm_bwd" if res else "rms_norm_bwd"
    before = launch_counts()[name]
    dx, dscale = norm_ops.rms_norm_backward(scale, x, dy, 1e-6, dres)
    assert launch_counts()[name] == before + 1
    want_dx, want_ds = norm_ref.rms_norm_backward_plain(scale, x, dy, 1e-6,
                                                        dres)
    _norm_bwd_close(dx, want_dx, dtype, "dx")
    _norm_bwd_close(dscale, want_ds, dtype, "dscale")
    again = norm_ops.rms_norm_backward(scale, x, dy, 1e-6, dres)
    assert torch.equal(dx, again[0]) and torch.equal(dscale, again[1])
    assert _device_kernels(lambda: norm_ops.rms_norm_backward(
        scale, x, dy, 1e-6, dres)) <= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_autograd_on_the_card_runs_the_backward_kernels(cuda, dtype):
    """Through autograd, ``rms_norm`` and ``add_rms_norm`` launch their
    backward kernels and give the plain backward's gradients (the
    kernel's tolerance); an unused residual stream (the last norm's)
    passes no residual gradient."""
    rng = np.random.default_rng(11)
    d = 1536
    x, delta, dy, dres = (torch.from_numpy(rng.standard_normal(
        (4, 33, d)).astype(np.float32)).to(cuda, dtype) for _ in range(4))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, (d,)).astype(
        np.float32)).to(cuda, dtype)
    xa, da, sa = (t.clone().requires_grad_() for t in (x, delta, scale))
    reset_launch_counts()
    gx, gd, gs = torch.autograd.grad(norm_ops.add_rms_norm(sa, xa, da),
                                     (xa, da, sa), (dres, dy))
    assert launch_counts()["add_rms_norm_bwd"] == 1
    assert torch.equal(gx, gd)
    want_dx, want_ds = norm_ref.rms_norm_backward_plain(scale, x + delta, dy,
                                                        1e-5, dres)
    _norm_bwd_close(gx, want_dx, dtype, "dx")
    _norm_bwd_close(gs, want_ds, dtype, "dscale")
    gx, gs = torch.autograd.grad(norm_ops.rms_norm(sa, xa), (xa, sa), dy)
    assert launch_counts()["rms_norm_bwd"] == 1
    want_dx, want_ds = norm_ref.rms_norm_backward_plain(scale, x, dy)
    _norm_bwd_close(gx, want_dx, dtype, "dx")
    _norm_bwd_close(gs, want_ds, dtype, "dscale")
    _, h = norm_ops.add_rms_norm(sa, xa, da)
    gx, = torch.autograd.grad(h, (xa,), dy)
    assert launch_counts()["rms_norm_bwd"] == 2  # no residual gradient


@pytest.mark.parametrize("stacked", [False, True])
def test_fixed_rows_gradients_on_the_card_are_rounded_once(cuda, stacked):
    """bf16 at 1000 rows (8 blocks of 128): dx and dw of
    ``linear_fixed_rows``/``bmm_fixed_rows`` each lie within one bf16
    rounding (2^-8 relative, plus 1e-5 of the largest) of the f32 product
    of the same inputs (dw is one f32-accumulated product, not the
    blocks' dw summed in bf16); the same bits at a second call."""
    from repro_torch.models.common import bmm_fixed_rows, linear_fixed_rows

    rng = np.random.default_rng(4)
    lead = (2,) if stacked else ()
    x, w, dy = (torch.from_numpy(rng.standard_normal(lead + s).astype(
        np.float32)).to(cuda, torch.bfloat16)
        for s in ((1000, 320), (448, 320), (1000, 448)))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    fn = bmm_fixed_rows if stacked else linear_fixed_rows
    got = torch.autograd.grad(fn(xg, wg), (xg, wg), dy)
    again = torch.autograd.grad(fn(xg, wg), (xg, wg), dy)
    xf, wf, dyf = x.float(), w.float(), dy.float()
    for g, a, want in zip(got, again, (dyf @ wf, dyf.transpose(-1, -2) @ xf)):
        assert torch.equal(g, a)
        tol = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
        assert bool(((g.float() - want).abs() <= tol).all())


def test_smoke_training_on_the_card_is_reproducible(cuda, tmp_path):
    """The smoke qwen2 trains on the card through the norm's backward
    kernels; a run preempted after step 2 and resumed from its checkpoint
    gives the losses and parameters of an uninterrupted 4-step run bit
    for bit (the backward has no float atomics; ``F.embedding``'s
    backward sums in a fixed order)."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamW
    from repro_torch.runtime import PreemptionGuard
    from repro_torch.training import Trainer, TrainerConfig, state_tree

    cfg = configs.get_smoke_config("qwen2-1.5b").scaled(remat="full")

    def trainer(ckpt=None, log_fn=lambda m: None):
        return Trainer(cfg, AdamW(lr=3e-3), DataConfig(seq_len=64,
                                                       global_batch=8),
                       TrainerConfig(total_steps=4, log_interval=1,
                                     ckpt_dir=ckpt), log_fn=log_fn,
                       device=cuda)

    reset_launch_counts()
    whole = trainer()
    s_whole = whole.fit()
    counts = launch_counts()
    assert counts["add_rms_norm_bwd"] > 0 and counts["rms_norm_bwd"] > 0
    guard = PreemptionGuard(signals=())
    first = trainer(str(tmp_path),
                    lambda m: "step 2 " in m and guard.request())
    first.fit(guard=guard)
    second = trainer(str(tmp_path))
    s_res = second.fit()
    losses = [h["loss"] for h in first.history + second.history]
    assert losses == [h["loss"] for h in whole.history]
    assert all(np.isfinite(losses))
    a, b = (dict(afmt.iter_tree_leaves(state_tree(s, cfg)))
            for s in (s_whole, s_res))
    for k in a:
        assert torch.equal(a[k], b[k]), k


# tolerances of the recurrences' backward kernels against their plain
# backwards, relative to each gradient's largest |value| (sums in other
# orders; bf16: an intermediate rounded to the other side of a bf16 step,
# carried through at most two more roundings)
RECURRENT_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


def _recurrent_bwd_close(got, again, want, dtype, names):
    for name, g, a, w in zip(names, got, again, want):
        assert torch.equal(g, a), name
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30))
        assert err <= RECURRENT_BWD_TOL[dtype], (name, err)


def _rglru_backward_case(cuda, dtype, s, r, nb, extreme=()):
    """``rglru_scan_bwd`` from the forward kernel's tile checkpoints against
    the plain backward, 5 rows of lengths s, 0, 1, s // 2 and s - 3 (cut
    inside a tile) from a prior state; ``extreme``: (row, value) pairs that
    set that row's first steps of ya and yx to value. The same bits at a
    second call (dba, dbx, dlam summed in row order); the forward with
    checkpoints equals the forward without; one count and at most two
    kernels a call."""
    g = torch.Generator(device=cuda).manual_seed(3)
    b = 5

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g, device=cuda) * std).to(dtype)

    ya, yx = rnd(nb, b * s, r // nb), rnd(nb, b * s, r // nb)
    for row, value in extreme:
        ya[:, row * s:row * s + 3] = value
        yx[:, row * s:row * s + 3] = value
    ba, bx, c, gg = rnd(r, std=0.1), rnd(r, std=0.1), rnd(b, s, r), \
        rnd(b, s, r)
    lam = torch.linspace(-4.3, -0.7, r, device=cuda).to(dtype)
    h = torch.randn((b, r), generator=g, device=cuda)
    lengths = torch.tensor([s, 0, 1, s // 2, max(s - 3, 0)],
                           dtype=torch.int32, device=cuda)
    ckpt = torch.empty((b, -(-s // 32), r), dtype=torch.float32, device=cuda)
    args = (ya, yx, ba, bx, c, gg, lam)
    out = scan_ops.rglru_gated_scan_cuda(*args, h.clone(), lengths, ckpt)
    assert torch.equal(out, scan_ops.rglru_gated_scan_cuda(*args, h.clone(),
                                                           lengths))
    dout = rnd(b, s, r)
    before = launch_counts()["rglru_scan_bwd"]
    got, again = (scan_ops.rglru_gated_scan_backward_cuda(
        *args, ckpt, lengths, dout) for _ in range(2))
    assert launch_counts()["rglru_scan_bwd"] == before + 2
    want = scan_ref.rglru_gated_scan_backward_plain(*args, h, lengths, dout)
    _recurrent_bwd_close(got, again, want, dtype,
                         ("dya", "dyx", "dba", "dbx", "dc", "dg", "dlam"))
    assert _device_kernels(lambda: scan_ops.rglru_gated_scan_backward_cuda(
        *args, ckpt, lengths, dout)) <= 2


# 1 step; 31, 32 and 33 about one 32-step tile; 70 two tiles and a ragged
# third. R 96 in 3 blocks and 160 in 5: three and five blocks of 32
# channels, the operands copied in 16-byte chunks; 100 in 2 blocks of 50:
# not whole chunks, so copied a channel pair at a time, and a last block of
# 4 channels
@pytest.mark.parametrize("r, nb", [(96, 3), (160, 5), (100, 2)])
@pytest.mark.parametrize("s", [1, 7, 31, 32, 33, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_kernel_matches_plain_and_repeats(cuda, dtype, s, r,
                                                         nb):
    """``rglru_scan_bwd`` against the plain backward written out, ragged
    and idle rows, a prior state (``_rglru_backward_case``)."""
    _rglru_backward_case(cuda, dtype, s, r, nb)


# compares the backward's fast reciprocal and square root with the
# intrinsics on every operand of [lo, hi) (bit patterns); compiled from the
# kernel's own source, so it checks the functions the kernel runs
_FAST_PATHS_HARNESS = r"""
#include "SOURCE"
#include <cstdio>
namespace {
__global__ void compare(unsigned lo, unsigned hi, int sqrt_path,
                        unsigned long long* bad) {
  for (unsigned long long u = lo + blockIdx.x * (unsigned long long)blockDim.x
       + threadIdx.x; u < hi; u += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned)u);
    const float a = sqrt_path ? sqrt_rn<true>(x) : rcp_rn<true>(x);
    const float b = sqrt_path ? __fsqrt_rn(x) : __frcp_rn(x);
    if (__float_as_uint(a) != __float_as_uint(b)) atomicAdd(bad, 1ull);
  }
}
}  // namespace
int main() {
  const unsigned ranges[2][3] = {{0x3f800000u, 0x7e800000u, 0},
                                 {0x2b8cbcccu, 0x3f800001u, 1}};
  unsigned long long* bad;
  if (cudaMalloc(&bad, 8) != cudaSuccess) return 2;
  for (const auto& r : ranges) {
    unsigned long long n = 0;
    cudaMemcpy(bad, &n, 8, cudaMemcpyHostToDevice);
    compare<<<132 * 16, 256>>>(r[0], r[1], r[2], bad);
    if (cudaMemcpy(&n, bad, 8, cudaMemcpyDeviceToHost) != cudaSuccess) return 2;
    printf("%s %u %llu\n", r[2] ? "sqrt" : "rcp", r[1] - r[0], n);
  }
  return 0;
}
"""


def test_rglru_fast_paths_equal_the_intrinsics(cuda, tmp_path):
    """Phase A of ``rglru_scan_bwd`` takes the reciprocals' and square
    roots' fast paths alone where its operands allow: ``rcp_rn<true>`` on
    the sigmoid's 1 + e^-z for z > -86, [1, 2^126), and ``sqrt_rn<true>`` on
    the clamped 1 - e2, [1e-12, 1]. On every operand of those ranges they
    give ``__frcp_rn``'s and ``__fsqrt_rn``'s bits (the forward's), so the
    recomputed gates equal the forward's."""
    import subprocess

    from repro_torch.kernels import _build

    harness = tmp_path / "fast_paths.cu"
    harness.write_text(_FAST_PATHS_HARNESS.replace(
        "SOURCE", str(scan_ops._SOURCE)))
    exe = tmp_path / "fast_paths"
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    subprocess.run([_build._nvcc(), *flags, "-o", str(exe), str(harness)],
                   check=True, capture_output=True, timeout=600)
    out = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=300).stdout.split("\n")
    got = {name: (int(n), int(differ)) for name, n, differ in
           (line.split() for line in out if line)}
    assert got == {"rcp": (0x7e800000 - 0x3f800000, 0),
                   "sqrt": (0x3f800001 - 0x2b8cbccc, 0)}, got


@pytest.mark.parametrize("s", [7, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_backward_kernel_exact_gates_out_of_range(cuda, dtype, s):
    """Gate sums far below -86, where 1 + e^-z overflows: the threads that
    hold them take the gates' intrinsics (their slow paths), the others the
    fast paths alone, and the gradients still match the plain backward."""
    _rglru_backward_case(cuda, dtype, s, 96, 3,
                         extreme=((0, -100.0), (3, 100.0)))


# 1 step; 31 and 33 about one 32-step tile; 70 two tiles and a ragged
# third; with rows of lengths s, 0, 1, s // 2 and s - 2 (cut inside a
# 4-step sub-tile: 70 // 2 = 35, 31 - 2 = 29, 33 - 2 = 31, ...)
@pytest.mark.parametrize("s", [1, 7, 31, 33, 70])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_backward_kernel_matches_plain_and_repeats(cuda, dtype, hd, s):
    """``wkv6_bwd`` (the states recomputed from the forward kernel's tile
    checkpoints, the group norm's backward from its saved readout) against
    the plain backward written out, ragged and idle rows, a prior state;
    the same bits at a second call (du, dscale summed in row order); one
    count and two kernels a call."""
    g = torch.Generator(device=cuda).manual_seed(4)
    b, nh = 5, 3

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=g, device=cuda) * std

    r, k, v = (rnd(b, s, nh, hd, std=0.5).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rnd(b, s, nh, hd, std=0.5) - 1.0))
    u = rnd(nh, hd, std=0.1).to(dtype)
    state = rnd(b, nh, hd, hd, std=0.1)
    lengths = torch.tensor([s, 0, 1, s // 2, max(s - 2, 0)],
                           dtype=torch.int32, device=cuda)
    scale = (1.0 + rnd(nh * hd, std=0.1)).to(dtype)
    ckpt = torch.empty((b, nh, -(-s // 32), hd, hd), dtype=torch.float32,
                       device=cuda)
    yraw = torch.empty((b, s, nh * hd), dtype=dtype, device=cuda)
    out = wkv_ops.wkv6_cuda(r, k, v, w, u, state.clone(), lengths, scale,
                            ckpt=ckpt, yraw=yraw)
    assert torch.equal(out, wkv_ops.wkv6_cuda(r, k, v, w, u, state.clone(),
                                              lengths, scale))
    dout = rnd(b, s, nh * hd).to(dtype)
    before = launch_counts()["wkv6_bwd"]
    got, again = (wkv_ops.wkv6_backward_cuda(r, k, v, w, u, lengths, scale,
                                             ckpt, yraw, dout)
                  for _ in range(2))
    assert launch_counts()["wkv6_bwd"] == before + 2
    want = wkv_ref.wkv6_backward_plain(r, k, v, w, u, state, lengths, scale,
                                       dout)
    _recurrent_bwd_close(got, again, want, dtype,
                         ("dr", "dk", "dv", "dw", "du", "dscale"))
    assert _device_kernels(lambda: wkv_ops.wkv6_backward_cuda(
        r, k, v, w, u, lengths, scale, ckpt, yraw, dout)) == 2


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-3b"])
def test_recurrent_smoke_training_on_the_card_is_reproducible(cuda, arch,
                                                              tmp_path):
    """A recurrent smoke arch trains on the card through the recurrences'
    backward kernels (never their plain versions); a run preempted after
    step 2 and resumed from its checkpoint gives the losses and state of
    an uninterrupted 4-step run bit for bit."""
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamW
    from repro_torch.runtime import PreemptionGuard
    from repro_torch.training import Trainer, TrainerConfig, state_tree

    cfg = configs.get_smoke_config(arch).scaled(remat="full")
    kern = "rglru_scan" if arch == "recurrentgemma-2b" else "wkv6"
    ref = scan_ref if arch == "recurrentgemma-2b" else wkv_ref
    plain = ("rglru_gated_scan_plain", "rglru_gated_scan_backward_plain") \
        if arch == "recurrentgemma-2b" else ("wkv6_plain",
                                             "wkv6_backward_plain")

    def trainer(ckpt=None, log_fn=lambda m: None):
        return Trainer(cfg, AdamW(lr=3e-3), DataConfig(seq_len=64,
                                                       global_batch=8),
                       TrainerConfig(total_steps=4, log_interval=1,
                                     ckpt_dir=ckpt), log_fn=log_fn,
                       device=cuda)

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    saved = {n: getattr(ref, n) for n in plain}
    for n in plain:
        setattr(ref, n, refuse)
    try:
        reset_launch_counts()
        whole = trainer()
        s_whole = whole.fit()
        counts = launch_counts()
        assert counts[kern] > 0 and counts[kern + "_bwd"] > 0
        guard = PreemptionGuard(signals=())
        first = trainer(str(tmp_path),
                        lambda m: "step 2 " in m and guard.request())
        first.fit(guard=guard)
        second = trainer(str(tmp_path))
        s_res = second.fit()
    finally:
        for n, fn in saved.items():
            setattr(ref, n, fn)
    losses = [h["loss"] for h in first.history + second.history]
    assert losses == [h["loss"] for h in whole.history]
    assert all(np.isfinite(losses))
    a, b = (dict(afmt.iter_tree_leaves(state_tree(s, cfg)))
            for s in (s_whole, s_res))
    for k in a:
        assert torch.equal(a[k], b[k]), k
