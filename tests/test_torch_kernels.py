"""The port's kernels against the reference package, same inputs.

Inputs are made with numpy from a seed and go through both packages. The
reference runs its Pallas kernels in interpret mode and its plain oracles;
the port runs its plain PyTorch versions (what its wrappers run on CPU
tensors). The CUDA kernels are held against those plain versions on a card
by ``test_torch_cuda.py``.

Tolerances: float32 throughout; the sums run in another order in each
implementation, so outputs agree to rtol = atol = 1e-4 (ternary matmul,
|y| ~ 10), 2e-5 (attention outputs are convex mixes of values ~ 1; the
paged op and decode attention to 1e-5) and rtol = atol = 1e-5 (RMSNorm in
f32; bf16 outputs within one bf16 step, 2^-7 of the value). Integer
outputs must match exactly: packing and the trit-search planes. The paged
attention's plain version equals the port's plain ring walk on the
gathered ring bit for bit.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpack
from repro.kernels.chunk_attention.ops import chunk_attention as jax_chunk_attention
from repro.kernels.chunk_attention.ops import \
    chunk_attention_paged as jax_chunk_attention_paged
from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.ptqtp_search import ops as jps_ops
from repro.kernels.ptqtp_search import ref as jps_ref
from repro.kernels.ternary_matmul import ops as jtm_ops
from repro.kernels.ternary_matmul import ref as jtm_ref
from repro.models.common import rms_norm as jrms_norm
from repro_torch.core import packing as tpack
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.chunk_attention import ops as tca_ops
from repro_torch.kernels.chunk_attention import ref as tca_ref
from repro_torch.kernels.decode_attention import ops as tda_ops
from repro_torch.kernels.ptqtp_search import ops as tps_ops
from repro_torch.kernels.rms_norm import ops as tnorm_ops
from repro_torch.kernels.ternary_matmul import ops as ttm_ops

# The suite runs one xdist worker per core: keep torch to one intra-op
# thread so it does not oversubscribe the CPU that the other workers share.
torch.set_num_threads(1)

MM_TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
PAGED_TOL = DECODE_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, device="cpu"):
    return torch.from_numpy(np.array(a)).to(device)


def _bf16(bits):
    """The value of a bf16 bit pattern, as an int (trits only)."""
    return int(struct.unpack("<f", struct.pack("<I", bits << 16))[0])


# ------------------------------------------------------------------ packing
class TestPacking:
    @pytest.mark.parametrize("shape", [(4,), (3, 64), (2, 5, 128)])
    def test_pack_matches_reference_bytes(self, shape):
        trits = np.random.default_rng(0).integers(-1, 2, shape).astype(np.int8)
        ref = np.asarray(jpack.pack_trits(jnp.asarray(trits)))
        got = tpack.pack_trits(torch.from_numpy(trits)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)

    def test_unpack_roundtrip_and_reference(self):
        trits = np.random.default_rng(1).integers(-1, 2, (7, 128)).astype(
            np.int8)
        packed = np.asarray(jpack.pack_trits(jnp.asarray(trits)))
        ref = np.asarray(jpack.unpack_trits(jnp.asarray(packed)))
        got = tpack.unpack_trits(_t(packed)).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            tpack.pack_trits(torch.from_numpy(got)).numpy(), packed)

    def test_weight_bytes(self):
        for shape, g in (((1536, 1536), 128), ((64, 128), 64)):
            assert tpack.ptqtp_weight_bytes(shape, g) == \
                jpack.ptqtp_weight_bytes(shape, g)


# ------------------------------------------------------------ ternary matmul
def _planes(rng, n, d, g):
    t1 = rng.integers(-1, 2, (n, d)).astype(np.int8)
    t2 = rng.integers(-1, 2, (n, d)).astype(np.int8)
    alpha = rng.uniform(0.01, 0.1, (n, d // g, 2)).astype(np.float32)
    return (np.asarray(jpack.pack_trits(jnp.asarray(t1))),
            np.asarray(jpack.pack_trits(jnp.asarray(t2))), alpha)


class TestTernaryMatmul:
    @pytest.mark.parametrize("g", [32, 64, 128])
    @pytest.mark.parametrize("m", [1, 7, 130])
    def test_plain_matches_reference(self, m, g):
        rng = np.random.default_rng(m * 1000 + g)
        n, d = 96, 256
        t1p, t2p, alpha = _planes(rng, n, d, g)
        x = rng.standard_normal((m, d)).astype(np.float32)
        jargs = (jnp.asarray(x), jnp.asarray(t1p), jnp.asarray(t2p),
                 jnp.asarray(alpha))
        oracle = np.asarray(jtm_ref.ternary_matmul_packed_ref(*jargs, g))
        pallas = np.asarray(jtm_ops.ternary_matmul(
            *jargs, group_size=g, backend="pallas", interpret=True))
        got = ttm_ops.ternary_matmul(_t(x), _t(t1p), _t(t2p), _t(alpha),
                                     group_size=g).numpy()
        assert got.dtype == np.float32 and got.shape == (m, n)
        np.testing.assert_allclose(got, oracle, **MM_TOL)
        np.testing.assert_allclose(got, pallas, **MM_TOL)

    def test_out_dtype_and_leading_dims(self):
        rng = np.random.default_rng(5)
        t1p, t2p, alpha = _planes(rng, 32, 64, 32)
        x = rng.standard_normal((2, 3, 64)).astype(np.float32)
        y = ttm_ops.ternary_matmul(_t(x), _t(t1p), _t(t2p), _t(alpha),
                                   group_size=32, out_dtype=torch.bfloat16)
        assert y.shape == (2, 3, 32) and y.dtype == torch.bfloat16

    def test_cpu_path_launches_nothing(self):
        reset_launch_counts()
        rng = np.random.default_rng(6)
        t1p, t2p, alpha = _planes(rng, 32, 64, 32)
        ttm_ops.ternary_matmul(_t(rng.standard_normal((4, 64), np.float32)),
                               _t(t1p), _t(t2p), _t(alpha), group_size=32)
        assert launch_counts()["ternary_matvec"] == 0

    def test_nibble_table_is_the_kernels_byte_permute(self):
        """All 16 nibbles: the table's register holds the reference's two
        trits of the nibble (the lower k in the low half), and the kernel's
        byte permute gives it at both offsets of every tig, whatever the
        word's other nibbles hold."""
        rng = np.random.default_rng(12)
        for v in range(16):
            want = np.asarray(jpack.unpack_trits(jnp.asarray(
                np.array([v], np.uint8))))[:2]
            reg = ttm_ops.NIBBLE_BF16X2[v]
            assert [_bf16(reg & 0xFFFF), _bf16(reg >> 16)] == want.tolist()
            for tig in range(4):
                other = int(rng.integers(16))
                keep = ~(0xF << 4 * tig | 0xF << 4 * tig + 16) & 0xFFFFFFFF
                word = (int(rng.integers(1 << 32)) & keep | v << 4 * tig
                        | other << 4 * tig + 16)
                assert ttm_ops.trit_pairs(word, tig) == (
                    reg, ttm_ops.NIBBLE_BF16X2[other])

    @pytest.mark.parametrize("g", [32, 64, 128])
    def test_a_fragment_matches_reference_unpack(self, g):
        """Every lane's A registers, over the k16 chunks of each group in the
        kernels' order, fill each of a 16x16 tile's 256 trits once, equal to
        the reference's unpacking of the same packed bytes."""
        rng = np.random.default_rng(g + 11)
        d = 2 * g
        trits = rng.integers(-1, 2, (16, d)).astype(np.int8)
        packed = np.asarray(jpack.pack_trits(jnp.asarray(trits)))
        ref = np.asarray(jpack.unpack_trits(jnp.asarray(packed)))
        words = packed.view("<u4")  # word kc of a row: chunk kc, trit k at bits 2k
        cpg = g // 16
        for grp in range(d // g):
            for c in range(cpg):
                kc = grp * cpg + c
                tile = np.full((16, 16), 9, np.int8)
                for lane in range(32):
                    gid, tig = divmod(lane, 4)
                    lo, hi = int(words[gid, kc]), int(words[gid + 8, kc])
                    regs = ttm_ops.a_fragment(lo, hi, lane)
                    assert (regs[0], regs[2]) == ttm_ops.trit_pairs(lo, tig)
                    assert (regs[1], regs[3]) == ttm_ops.trit_pairs(hi, tig)
                    at = ((gid, 2 * tig), (gid + 8, 2 * tig),
                          (gid, 2 * tig + 8), (gid + 8, 2 * tig + 8))
                    for reg, (row, k) in zip(regs, at):
                        for h in (0, 1):
                            assert tile[row, k + h] == 9
                            tile[row, k + h] = _bf16(reg >> 16 * h & 0xFFFF)
                np.testing.assert_array_equal(tile,
                                              ref[:, 16 * kc:16 * kc + 16])

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        rng = np.random.default_rng(7)
        t1p, t2p, alpha = _planes(rng, 32, 64, 32)
        x = _t(rng.standard_normal((4, 64), np.float32))
        for fn in (ttm_ops.ternary_matvec, ttm_ops.ternary_matmul_tiled):
            with pytest.raises(ValueError, match="CUDA"):
                fn(x, _t(t1p), _t(t2p), _t(alpha), 32)


# ----------------------------------------------------------------- rms norm
class TestRMSNorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(3, 64), (2, 5, 1536)])
    def test_plain_matches_reference(self, shape, dtype):
        rng = np.random.default_rng(len(shape))
        x = rng.standard_normal(shape).astype(np.float32)
        scale = rng.uniform(0.5, 1.5, shape[-1:]).astype(np.float32)
        jdt = getattr(jnp, dtype)
        want = np.asarray(jrms_norm({"scale": jnp.asarray(scale, jdt)},
                                    jnp.asarray(x, jdt), 1e-6)
                          .astype(jnp.float32))
        tdt = getattr(torch, dtype)
        got = tnorm_ops.rms_norm(_t(scale).to(tdt), _t(x).to(tdt), 1e-6)
        assert got.dtype == tdt and tuple(got.shape) == shape
        tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)

    def test_cpu_path_launches_nothing(self):
        reset_launch_counts()
        tnorm_ops.rms_norm(torch.ones(64), torch.randn(4, 64))
        assert launch_counts()["rms_norm"] == 0

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        with pytest.raises(ValueError, match="CUDA"):
            tnorm_ops.rms_norm_cuda(torch.ones(64), torch.randn(4, 64))


# ---------------------------------------------------------- chunk attention
def make_case(rng, b, L, kv, g, hd, cap, *, int8, wrap, lengths=None):
    """A random op input with a coherent ring (numpy): the last
    min(pos0, cap) positions before the chunk start are resident; wrap=True
    starts past cap so the ring has wrapped at least once."""
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
    if lengths is None:
        lengths = rng.integers(0, L + 1, (b,))
    return [q, kn, vn, kc, ks, vc, vs, pb, positions,
            np.asarray(lengths, np.int32)]


def _port_attention(case, window, device="cpu"):
    args = [None if a is None else _t(a, device) for a in case]
    return tca_ops.chunk_attention(*args, window=window)


def _jax_attention(case, window, backend):
    args = [None if a is None else jnp.asarray(a) for a in case]
    return np.asarray(jax_chunk_attention(*args, window=window,
                                          backend=backend, interpret=True))


class TestChunkAttention:
    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("wrap,window", [(False, None), (True, None),
                                             (True, 12)])
    @pytest.mark.parametrize("L", [1, 8])
    def test_plain_matches_reference(self, L, wrap, window, int8):
        rng = np.random.default_rng(100 * L + 10 * wrap + int8)
        case = make_case(rng, b=3, L=L, kv=2, g=3, hd=16, cap=32, int8=int8,
                         wrap=wrap, lengths=[L, 0, max(L - 3, 1)])
        got = _port_attention(case, window).numpy()
        assert got.shape == (3, L, 2, 3, 16) and got.dtype == np.float32
        for backend in ("pallas", "stream"):
            np.testing.assert_allclose(got, _jax_attention(case, window,
                                                           backend),
                                       **ATTN_TOL, err_msg=backend)

    def test_unseen_rows_are_zero(self):
        """An empty ring and a length-0 row: nothing is visible, out = 0."""
        rng = np.random.default_rng(3)
        case = make_case(rng, b=2, L=4, kv=1, g=2, hd=8, cap=16, int8=False,
                         wrap=False, lengths=[0, 0])
        case[7][:] = -1
        assert not _port_attention(case, None).abs().max() > 0

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        rng = np.random.default_rng(5)
        case = make_case(rng, b=2, L=1, kv=1, g=2, hd=16, cap=16, int8=False,
                         wrap=False)
        args = [None if a is None else _t(a) for a in case]
        with pytest.raises(ValueError, match="CUDA"):
            tca_ops.chunk_attention_cuda(*args)

    def test_select_tile_matches_reference(self):
        from repro.kernels.chunk_attention.ops import _select_tile as jsel

        for cap, L in ((32, 1), (1024, 64), (4096, 8), (97, 64), (1024, 1)):
            assert tca_ref._select_tile(cap, L) == jsel(cap, L)

    def test_masks_match_reference(self):
        from repro.kernels.chunk_attention import ref as jref

        rng = np.random.default_rng(4)
        case = make_case(rng, b=3, L=6, kv=1, g=1, hd=4, cap=8, int8=False,
                         wrap=True)
        pb, pos, ln = case[7], case[8], case[9]
        for reach in (8, 3):
            np.testing.assert_array_equal(
                tca_ref.history_mask(_t(pb), _t(pos), reach).numpy(),
                np.asarray(jref.history_mask(jnp.asarray(pb),
                                             jnp.asarray(pos), reach)))
            np.testing.assert_array_equal(
                tca_ref.chunk_mask(_t(pos), _t(ln), reach).numpy(),
                np.asarray(jref.chunk_mask(jnp.asarray(pos), jnp.asarray(ln),
                                           reach)))


# ----------------------------------------------------- paged chunk attention
def make_paged(rng, case, ps):
    """The ring of ``case`` scattered into a pool of ps-slot pages under a
    shuffled table, one logical page of row 1 unmapped (table entry 0, the
    null page, pos -1). Returns the paged operands (numpy)."""
    q, kn, vn, kc, ks, vc, vs, pb, positions, lengths = case
    b, cap = pb.shape
    n = cap // ps
    table = (1 + rng.permutation(b * n)).reshape(b, n).astype(np.int32)
    table[1, 0] = 0
    n_phys = b * n + 1

    def pool(ring, fill):
        out = np.full((n_phys, ps) + ring.shape[2:], fill, ring.dtype)
        for r in range(b):
            for j in range(n):
                if table[r, j]:
                    out[table[r, j]] = ring[r, j * ps:(j + 1) * ps]
        return out

    return [q, kn, vn, pool(kc, 0), None if ks is None else pool(ks, 0),
            pool(vc, 0), None if vs is None else pool(vs, 0), pool(pb, -1),
            table, positions, lengths]


class TestPagedChunkAttention:
    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("wrap,window", [(False, None), (True, None),
                                             (True, 12)])
    @pytest.mark.parametrize("L", [1, 8])
    def test_plain_matches_reference_and_ring_walk(self, L, wrap, window,
                                                   int8):
        rng = np.random.default_rng(200 * L + 10 * wrap + int8)
        case = make_case(rng, b=3, L=L, kv=2, g=3, hd=16, cap=32, int8=int8,
                         wrap=wrap, lengths=[L, 0, max(L - 3, 1)])
        paged = make_paged(rng, case, ps=8)
        targs = [None if a is None else _t(a) for a in paged]
        got = tca_ops.chunk_attention_paged(*targs, window=window)
        assert got.shape == (3, L, 2, 3, 16) and got.dtype == torch.float32
        jargs = [None if a is None else jnp.asarray(a) for a in paged]
        for backend in ("pallas", "stream"):
            want = np.asarray(jax_chunk_attention_paged(
                *jargs, window=window, backend=backend, interpret=True))
            np.testing.assert_allclose(got.numpy(), want, **PAGED_TOL,
                                       err_msg=backend)
        # bit for bit the plain ring walk over the gathered virtual ring
        table = targs[8]
        gathered = [None if a is None else tca_ref.gather_pages(a, table)
                    for a in targs[3:8]]
        ring = tca_ref.chunk_attention_stream(*targs[:3], *gathered,
                                              *targs[9:], window=window)
        assert torch.equal(got, ring)

    def test_gather_pages_matches_reference(self):
        from repro.kernels.chunk_attention import ref as jref

        rng = np.random.default_rng(8)
        pool = rng.standard_normal((9, 4, 2, 3)).astype(np.float32)
        table = rng.integers(0, 9, (3, 5)).astype(np.int32)
        np.testing.assert_array_equal(
            tca_ref.gather_pages(_t(pool), _t(table)).numpy(),
            np.asarray(jref.gather_pages(jnp.asarray(pool),
                                         jnp.asarray(table))))

    def test_cpu_path_launches_nothing_and_wrapper_refuses_cpu(self):
        rng = np.random.default_rng(9)
        case = make_case(rng, b=2, L=1, kv=1, g=2, hd=16, cap=16, int8=False,
                         wrap=False)
        args = [None if a is None else _t(a) for a in make_paged(rng, case,
                                                                 ps=4)]
        reset_launch_counts()
        tca_ops.chunk_attention_paged(*args)
        assert launch_counts()["chunk_attention_paged"] == 0
        with pytest.raises(ValueError, match="CUDA"):
            tca_ops.chunk_attention_paged_cuda(*args)


# --------------------------------------------------------- decode attention
def make_decode_case(rng, b, s, kv, g, hd):
    """q, the int8 ring after the token's write at pos, its scales and
    positions; row b-1 has an empty ring (every slot masked)."""
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    pos = rng.integers(0, 3 * s, (b,)).astype(np.int32)
    pb = np.full((b, s), -1, np.int32)
    for r in range(b - 1):
        for p in range(max(0, pos[r] - s + 1), pos[r] + 1):
            pb[r, p % s] = p
    return [q, k8, ks, v8, vs, pb, pos]


class TestDecodeAttention:
    @pytest.mark.parametrize("window", [None, 10])
    @pytest.mark.parametrize("s", [32, 48])
    def test_plain_matches_reference_and_pallas(self, s, window):
        rng = np.random.default_rng(s + (window or 0))
        case = make_decode_case(rng, b=4, s=s, kv=2, g=3, hd=16)
        got = tda_ops.decode_attention(*[_t(a) for a in case],
                                       window=window).numpy()
        jargs = [jnp.asarray(a) for a in case]
        oracle = np.asarray(jda_ref.decode_attention_ref(*jargs,
                                                         window=window))
        pallas = np.asarray(jda_ops.decode_attention(
            *jargs, window=window, backend="pallas", interpret=True))
        assert got.shape == (4, 2, 3, 16) and got.dtype == np.float32
        np.testing.assert_allclose(got, oracle, **DECODE_TOL)
        np.testing.assert_allclose(got, pallas, **DECODE_TOL)
        # the row that sees nothing: the uniform mean of v over the ring
        v = case[3][3].astype(np.float32) * case[4][3][..., None]
        np.testing.assert_allclose(
            got[3], np.broadcast_to(v.mean(0)[:, None], (2, 3, 16)),
            **DECODE_TOL)

    def test_cpu_path_launches_nothing_and_wrapper_refuses_cpu(self):
        case = [_t(a) for a in make_decode_case(np.random.default_rng(1),
                                                b=2, s=16, kv=1, g=2, hd=16)]
        reset_launch_counts()
        tda_ops.decode_attention(*case)
        assert launch_counts()["decode_attention"] == 0
        with pytest.raises(ValueError, match="CUDA"):
            tda_ops.decode_attention_cuda(*case)


# -------------------------------------------------------------- trit search
class TestTritSearch:
    @pytest.mark.parametrize("r,g", [(40, 128), (333, 64), (7, 10)])
    def test_planes_equal_reference_and_pallas(self, r, g):
        rng = np.random.default_rng(r * g)
        w = rng.standard_normal((r, g)).astype(np.float32)
        alpha = rng.uniform(0.1, 1.0, (r, 2)).astype(np.float32)
        w[0, :4] = 0.0                       # ties: (0, 0) wins
        alpha[1] = 0.5
        w[1, :3] = [0.25, -0.25, 0.75]       # midpoints between candidates
        t1, t2 = tps_ops.ptqtp_search(_t(w), _t(alpha))
        for want in (jps_ref.ptqtp_search_ref(jnp.asarray(w),
                                              jnp.asarray(alpha)),
                     jps_ops.ptqtp_search(jnp.asarray(w), jnp.asarray(alpha),
                                          interpret=True)):
            np.testing.assert_array_equal(t1.numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(t2.numpy(), np.asarray(want[1]))

    def test_out_planes_cpu_path_and_wrapper_refuses_cpu(self):
        rng = np.random.default_rng(2)
        w = _t(rng.standard_normal((6, 32)).astype(np.float32))
        alpha = _t(rng.uniform(0.1, 1.0, (6, 2)).astype(np.float32))
        out = (torch.empty_like(w), torch.empty_like(w))
        reset_launch_counts()
        t1, t2 = tps_ops.ptqtp_search(w, alpha, out=out)
        assert t1 is out[0] and t2 is out[1]
        assert launch_counts()["ptqtp_search"] == 0
        with pytest.raises(ValueError, match="CUDA"):
            tps_ops.ptqtp_search_cuda(w, alpha)
