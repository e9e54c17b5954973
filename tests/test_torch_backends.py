"""The engine's last two options against the reference: the attention
backends (``attn_backend``) and pre-unpacked trit-planes
(``preunpack_decode``), on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances: the attention ops' ``stream`` and ``materialized`` backends
agree with the reference's same backend to rtol = atol = 2e-5 (f32 outputs
are convex mixes of values ~ 1, summed in another order); the plain
twins' card route (``row_block``: the chunk walked in fixed row blocks)
to the same, and a row's output in it is bit for bit the same whatever
the chunk's length; the footprints of ``tracked_block_bytes`` are exact;
int8 and uint8 planes give the same bits; the ternary product with int8
planes agrees with the reference's grouped route to rtol = atol = 1e-4
(|y| ~ 10). Token streams are integers and equal the reference engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serving as jserving
from repro.core.packing import pack_trits as jpack_trits
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.kernels.chunk_attention import ops as jca_ops
from repro.kernels.ternary_matmul import ops as jtm_ops
from repro.models import init_params as jinit_params
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.packing import pack_trits, unpack_trits
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention import ops as tca_ops
from repro_torch.kernels.chunk_attention import ref as tca_ref
from repro_torch.kernels.ternary_matmul import ops as ttm_ops
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

torch.set_num_threads(1)

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
MM_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def make_case(rng, b, L, kv, g, hd, cap, *, int8, wrap, lengths):
    """Op inputs with a coherent ring (numpy): the last min(pos0, cap)
    positions before each row's chunk are resident; ``wrap`` starts past
    cap, so the ring has wrapped."""
    q = rng.standard_normal((b, L, kv, g, hd)).astype(np.float32)
    kn = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, (b, cap, kv, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, cap, kv, hd)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (b, cap, kv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (b, cap, kv)).astype(np.float32)
    else:
        kc = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
        vc = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
        ks = vs = None
    pb = np.full((b, cap), -1, np.int32)
    pos0 = np.zeros((b,), np.int64)
    for r in range(b):
        pos0[r] = cap + rng.integers(1, cap) if wrap else rng.integers(0, cap)
        for p in range(max(0, pos0[r] - cap), pos0[r]):
            pb[r, p % cap] = p
    positions = (pos0[:, None] + np.arange(L)[None, :]).astype(np.int32)
    return [q, kn, vn, kc, ks, vc, vs, pb, positions,
            np.asarray(lengths, np.int32)]


def make_paged(rng, case, ps):
    """The ring of ``case`` in a pool of ps-slot pages under a shuffled
    table; row 1's first logical page unmapped (the null page 0)."""
    q, kn, vn, kc, ks, vc, vs, pb, positions, lengths = case
    b, cap = pb.shape
    n = cap // ps
    table = (1 + rng.permutation(b * n)).reshape(b, n).astype(np.int32)
    table[1, 0] = 0

    def pool(ring, fill):
        out = np.full((b * n + 1, ps) + ring.shape[2:], fill, ring.dtype)
        for r in range(b):
            for j in range(n):
                if table[r, j]:
                    out[table[r, j]] = ring[r, j * ps:(j + 1) * ps]
        return out

    return [q, kn, vn, pool(kc, 0), None if ks is None else pool(ks, 0),
            pool(vc, 0), None if vs is None else pool(vs, 0), pool(pb, -1),
            table, positions, lengths]


def _case(layout, L, window, int8, seed):
    rng = np.random.default_rng(seed)
    case = make_case(rng, 3, L, 2, 3, 16, 32, int8=int8,
                     wrap=window is not None, lengths=[L, 0, max(L - 3, 1)])
    return case if layout == "ring" else make_paged(rng, case, 8)


def _ops(layout):
    if layout == "ring":
        return tca_ops.chunk_attention, jca_ops.chunk_attention
    return tca_ops.chunk_attention_paged, jca_ops.chunk_attention_paged


# ------------------------------------------------------- attention backends
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("L", [1, 8])
@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("backend", ["stream", "materialized"])
def test_backend_equals_the_reference_backend(backend, layout, L, window,
                                              int8):
    """Each plain backend against the reference's same backend, ring and
    paged (a shuffled table, an unmapped page), with and without a window
    on a wrapped ring; a length-0 row sees its history only."""
    case = _case(layout, L, window, int8, 10 * L + int8 + (window or 0))
    port, ref = _ops(layout)
    got = port(*map(_t, case), window=window, backend=backend)
    assert got.shape == (3, L, 2, 3, 16) and got.dtype == torch.float32
    want = np.asarray(ref(*map(_j, case), window=window, backend=backend))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    # auto is stream on a CPU tensor
    if backend == "stream":
        assert torch.equal(port(*map(_t, case), window=window), got)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_materialized_unseen_rows_are_uniform_as_in_the_reference(layout):
    """A row that sees nothing (empty ring, length 0): the materialized
    softmax of an all-masked row is uniform over every value, not zero (the
    reference's tests compare only rows that see something); stream gives
    zeros."""
    case = _case(layout, 4, None, False, 3)
    case[-1][:] = 0     # lengths
    case[7][:] = -1     # the ring's (pool's) positions: nothing resident
    port, ref = _ops(layout)
    got = port(*map(_t, case), backend="materialized")
    want = np.asarray(ref(*map(_j, case), backend="materialized"))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    assert got.abs().amax() > 0
    assert not port(*map(_t, case), backend="stream").abs().amax() > 0


@pytest.mark.parametrize("twin", ["stream", "materialized"])
def test_row_blocks_keep_the_result_and_make_rows_invariant(twin):
    """The twins' card route (``row_block``, here 4 rows for a chunk of 11
    or 3): within the tolerance of the reference's backend, and a row's
    bits do not depend on the chunk length its fleet pads it to (the same
    row in a chunk of 3 and of 11, ragged to length 3)."""
    fn = (tca_ref.chunk_attention_stream if twin == "stream"
          else tca_ref.chunk_attention_materialized)
    rng = np.random.default_rng(7)
    case = make_case(rng, 3, 11, 2, 3, 16, 32, int8=True, wrap=True,
                     lengths=[11, 3, 0])
    got = fn(*map(_t, case), window=12, row_block=4)
    want = np.asarray(jca_ops.chunk_attention(*map(_j, case), window=12,
                                              backend=twin))
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    short = list(case)
    for i in (0, 1, 2, 8):
        short[i] = case[i][:, :3]
    short[9] = np.asarray([3, 3, 0], np.int32)
    alone = fn(*map(_t, short), window=12, row_block=4)
    assert torch.equal(alone[1], got[1, :3])


def test_tracked_block_bytes_equal_the_reference():
    """The analytic footprint of ``stream`` and ``materialized`` calls is
    the reference's formula, with its ring and page tiles; ``pallas``
    counts the split-KV workspace."""
    for b, kv, g, L, cap in ((8, 2, 6, 1, 1024), (8, 2, 6, 64, 1024),
                             (3, 4, 1, 16, 4096), (2, 1, 8, 5, 97)):
        for backend in ("stream", "materialized"):
            assert tca_ops.tracked_block_bytes(
                b, kv, g, L, cap, backend=backend) == \
                jca_ops.tracked_block_bytes(b, kv, g, L, cap, backend=backend)
            for ps in (8, 16, 12):
                t = jca_ops.paged_tile(ps, L)
                assert tca_ops.paged_tile(ps, L) == t
                assert tca_ops.tracked_block_bytes(
                    b, kv, g, L, cap, backend=backend, tile=t) == \
                    jca_ops.tracked_block_bytes(b, kv, g, L, cap,
                                                backend=backend, tile=t)
    for ps, L in ((64, 256), (96, 100), (16, 1024), (7, 4096)):
        assert tca_ops.paged_tile(ps, L) == jca_ops.paged_tile(ps, L)
    floats, counters = tca_ops._workspace_size(8, 2, 64 * 6, 128, 8 + 1)
    assert tca_ops.tracked_block_bytes(8, 2, 6, 64, 1024, backend="pallas",
                                       hd=128) == 4 * (floats + counters)
    # the ops record each plain call's footprint, ring and paged, as the
    # reference's do; the kernel route records nothing
    for layout in ("ring", "paged"):
        port, ref = _ops(layout)
        case = _case(layout, 8, None, False, 1)
        for backend in ("stream", "materialized"):
            tca_ops.reset_tracking()
            jca_ops.reset_tracking()
            port(*map(_t, case), backend=backend)
            ref(*map(_j, case), backend=backend)
            assert tca_ops.peak_tracked_bytes() == \
                jca_ops.peak_tracked_bytes() > 0
        tca_ops.reset_tracking()
        with pytest.raises(ValueError, match="CUDA"):
            port(*map(_t, case), backend="pallas")
        assert tca_ops.peak_tracked_bytes() == 0


# ---------------------------------------------------------------- refusals
def test_unknown_attention_backend_raises():
    """As the reference's ops: a ValueError, on either layout; the engine
    refuses the name at construction."""
    for layout in ("ring", "paged"):
        case = _case(layout, 1, None, False, 2)
        port, ref = _ops(layout)
        with pytest.raises(ValueError, match="unknown chunk-attention"):
            ref(*map(_j, case), backend="flash")
        with pytest.raises(ValueError, match="unknown chunk-attention"):
            port(*map(_t, case), backend="flash")
    with pytest.raises(ValueError, match="flash"):
        EngineConfig(attn_backend="flash")


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_pallas_on_a_cpu_tensor_raises(layout):
    """``pallas`` names the CUDA kernel; a CPU tensor has no interpreter."""
    case = _case(layout, 1, None, False, 4)
    port, _ = _ops(layout)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        port(*map(_t, case), backend="pallas")
    assert not any(launch_counts().values())


def test_int8_planes_with_an_explicit_kernel_request_raise():
    """Raw int8 planes are served by the grouped route only; asking the
    kernels for them raises the reference's ValueError, in both packages
    and for the expert stacks; a CPU tensor asked of the kernels raises."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 128)).astype(np.float32)
    t1 = rng.integers(-1, 2, (8, 128)).astype(np.int8)
    alpha = rng.standard_normal((8, 2, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="requires packed uint8"):
        jtm_ops.ternary_matmul(jnp.asarray(x), jnp.asarray(t1),
                               jnp.asarray(t1), jnp.asarray(alpha),
                               group_size=64, backend="pallas")
    with pytest.raises(ValueError, match="requires packed uint8"):
        ttm_ops.ternary_matmul(_t(x), _t(t1), _t(t1), _t(alpha),
                               group_size=64, backend="pallas")
    with pytest.raises(ValueError, match="requires packed uint8"):
        ttm_ops.ternary_matmul_experts(_t(x)[None], _t(t1)[None],
                                       _t(t1)[None], _t(alpha)[None],
                                       group_size=64, backend="pallas")
    packed = pack_trits(_t(t1))
    with pytest.raises(ValueError, match="CUDA"):
        ttm_ops.ternary_matmul(_t(x), packed, packed, _t(alpha),
                               group_size=64, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        ttm_ops.ternary_matmul(_t(x), packed, packed, _t(alpha),
                               group_size=64, backend="xla")


# ------------------------------------------------------------- int8 planes
@pytest.mark.parametrize("m", [1, 5, 200])
def test_int8_and_uint8_planes_give_the_same_bits(m):
    """The plain route on raw int8 trits equals it on the packed planes bit
    for bit (plain and expert stacks, with and without row blocks), and
    the reference's grouped route on either form within MM_TOL."""
    rng = np.random.default_rng(m)
    d, n, g = 256, 48, 64
    x = rng.standard_normal((m, d)).astype(np.float32)
    t1 = rng.integers(-1, 2, (n, d)).astype(np.int8)
    t2 = rng.integers(-1, 2, (n, d)).astype(np.int8)
    alpha = rng.standard_normal((n, d // g, 2)).astype(np.float32)
    p1, p2 = pack_trits(_t(t1)), pack_trits(_t(t2))
    assert torch.equal(unpack_trits(p1), _t(t1))
    raw = ttm_ops.ternary_matmul(_t(x), _t(t1), _t(t2), _t(alpha),
                                 group_size=g)
    packed = ttm_ops.ternary_matmul(_t(x), p1, p2, _t(alpha), group_size=g)
    assert torch.equal(raw, packed)
    grouped = ttm_ops.ternary_matmul(_t(x), _t(t1), _t(t2), _t(alpha),
                                     group_size=g, backend="grouped")
    assert torch.equal(grouped, packed)
    from repro_torch.kernels.ternary_matmul import ref as ttm_ref
    blocked = ttm_ref.ternary_matmul_grouped(_t(x), _t(t1), _t(t2),
                                             _t(alpha), g, row_block=128)
    np.testing.assert_allclose(blocked.numpy(), packed.numpy(), **MM_TOL)
    assert torch.equal(ttm_ref.ternary_matmul_grouped(
        _t(x), p1, p2, _t(alpha), g, row_block=128), blocked)
    ex = ttm_ops.ternary_matmul_experts(_t(x)[None].repeat(2, 1, 1),
                                        _t(t1)[None].repeat(2, 1, 1),
                                        _t(t2)[None].repeat(2, 1, 1),
                                        _t(alpha)[None].repeat(2, 1, 1, 1),
                                        group_size=g)
    assert torch.equal(ex[0], raw) and torch.equal(ex[1], raw)
    for planes in ((t1, t2), (np.asarray(jpack_trits(jnp.asarray(t1))),
                              np.asarray(jpack_trits(jnp.asarray(t2))))):
        want = np.asarray(jtm_ops.ternary_matmul(
            jnp.asarray(x), *map(jnp.asarray, planes), jnp.asarray(alpha),
            group_size=g, backend="grouped"))
        np.testing.assert_allclose(raw.numpy(), want, **MM_TOL)


# ----------------------------------------------------------------- engines
PROMPTS = [np.random.default_rng(i).integers(0, 512, n).tolist()
           for i, n in enumerate((5, 23, 40, 9))]
BUDGETS = (6, 9, 12, 3)
ENGINE = dict(max_slots=3, capacity=48, prefill_chunk=16, decode_chunk=4,
              page_size=8)


@pytest.fixture(scope="module")
def both():
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                               JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return (params, jcfg), (model, cfg)


def _serve(eng, SP):
    hs = [eng.submit(p, SP(max_new_tokens=n)) for p, n in zip(PROMPTS,
                                                              BUDGETS)]
    eng.run()
    return [(list(h.output), h.finish_reason) for h in hs]


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("backend", ["stream", "materialized"])
def test_engine_streams_equal_reference_engine(both, backend, layout):
    """Greedy streams with ``attn_backend`` set on the engine equal the
    reference engine's with the same backend, ring and paged; the
    override reaches the model config the dispatches read."""
    (params, jcfg), (model, cfg) = both
    kw = dict(ENGINE, kv_layout=layout, attn_backend=backend)
    want = _serve(jserving.ServingEngine(params, jcfg,
                                         jserving.EngineConfig(**kw)),
                  jserving.SamplingParams)
    eng = ServingEngine(model, cfg, EngineConfig(**kw))
    assert eng.cfg.attn_backend == backend and cfg.attn_backend == "auto"
    assert _serve(eng, SamplingParams) == want


def test_preunpacked_engine_serves_the_packed_streams(both):
    """``preunpack_decode`` True and False give the same streams (the
    reference engine's, which pre-unpacks on the CPU); the served copy
    holds int8 trits and shares every other tensor with the caller's
    model, which keeps its uint8 planes."""
    (params, jcfg), (model, cfg) = both
    want = _serve(jserving.ServingEngine(params, jcfg,
                                         jserving.EngineConfig(**ENGINE)),
                  jserving.SamplingParams)
    on = ServingEngine(model, cfg, EngineConfig(**ENGINE,
                                                preunpack_decode=True))
    off = ServingEngine(model, cfg, EngineConfig(**ENGINE,
                                                 preunpack_decode=False))
    assert _serve(on, SamplingParams) == want == _serve(off, SamplingParams)
    served, kept = on._serve_model.layers[0].mlp.wi, model.layers[0].mlp.wi
    assert served.t1p.dtype == torch.int8 and kept.t1p.dtype == torch.uint8
    assert (served.matmul_backend, kept.matmul_backend) == ("grouped", "auto")
    assert torch.equal(unpack_trits(kept.t1p), served.t1p)
    assert served.alpha is kept.alpha
    assert on._serve_model.embed is model.embed
    assert off._serve_model is model


def test_launcher_serves_each_attention_backend(capsys):
    """``launch.serve --attn-backend`` on the CPU: every name serves but
    ``pallas``, which needs the card; the pre-unpacked planes' bytes are
    printed as the reference prints them."""
    from repro_torch.launch import serve

    for backend in ("auto", "stream", "materialized"):
        results = serve.main(["--device", "cpu", "--attn-backend", backend,
                              "--requests", "2", "--max-new", "4",
                              "--t-max", "2"])
        assert [len(r.tokens) for r in results] == [4, 4]
    out = capsys.readouterr().out
    assert "resident planes" in out and "4.0x packed" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--attn-backend", "flash"])
