"""The split-KV walk of the chunk-attention kernel, stated in plain PyTorch,
against the reference package on the CPU.

The Hopper kernel (``kernels/chunk_attention/csrc/chunk_attention.cu``,
B2, B4 and B5) cuts the ring into the parts of ``split_ranges(cap)`` and
the chunk's keys into ``split_ranges(L)``, computes (m, l, acc) per part
and query row, and combines the parts in one order: ring parts first, then
the chunk's. ``split_walk`` below states that walk with the same ranges;
the tests hold it against the reference's materialized oracle, its
streaming walk and (for some cases) its Pallas kernel in interpret mode,
and against its decode-attention oracle for B5's rule. The CPU path of the
port itself keeps ``chunk_attention_stream``; the kernel's bits are held
against its plain version on a card (``test_torch_cuda.py``).

Tolerances: float32 throughout, the sums in another order than the
reference's: rtol = atol = 2e-5 (outputs are convex mixes of values ~ 1).
P stays f32 in the kernel (its P·V is an f32 FMA chain), so no bf16
rounding of P enters the bound. Exact: the ranges themselves, and a row
that sees nothing gives 0 under the chunk op's rule.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunk_attention import ref as jref
from repro.kernels.chunk_attention.ops import chunk_attention as jax_chunk
from repro.kernels.decode_attention import ref as jda_ref
from repro_torch.kernels.chunk_attention import ops as tca_ops
from repro_torch.kernels.chunk_attention import ref as tca_ref
from repro_torch.kernels.chunk_attention.ops import PART_SLOTS, split_ranges
from repro_torch.kernels.decode_attention import ref as tda_ref

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
NEG_INF = -1e30


def _deq(c, scale):
    c = c.to(torch.float32)
    return c if scale is None else c * scale[..., None].to(torch.float32)


def _part(qf, k, v, vis, remask):
    """(m, l, acc) of one part: qf (B, L, KV, G, hd) pre-scaled f32; k/v
    (B, n, KV, hd) f32; vis (B, L, n) bool."""
    x = torch.einsum("blkgd,bnkd->blkgn", qf, k)
    vm = vis[:, :, None, None, :]
    x = torch.where(vm, x, NEG_INF)
    m = x.amax(dim=-1)
    p = torch.exp(x - m[..., None])
    if remask:  # B2/B4: a masked slot adds 0 even while m == -1e30
        p = torch.where(vm, p, 0.0)
    return m, p.sum(dim=-1), torch.einsum("blkgn,bnkd->blkgd", p, v)


def _combine(parts):
    """Parts in order: m = max m_i; l = Σ l_i·w_i, acc = Σ acc_i·w_i with
    w_i = exp(m_i - m), summed in that order; acc / max(l, 1e-30)."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_i, l_i, acc_i in parts:
        w = torch.exp(m_i - m)
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    return acc / torch.clamp(l, min=1e-30)[..., None]


def split_walk(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale, pos_buf,
               positions, lengths, *, window=None):
    """The chunk op (B2, B4 on the gathered ring) as the kernel walks it:
    (B, L, KV, G, hd) f32."""
    hd = q.shape[-1]
    cap, L = k_cache.shape[1], q.shape[1]
    reach = tca_ref.reach_of(cap, window)
    qf = q.to(torch.float32) * (hd ** -0.5)
    k, v = _deq(k_cache, k_scale), _deq(v_cache, v_scale)
    hist = tca_ref.history_mask(pos_buf, positions, reach)
    own = tca_ref.chunk_mask(positions, lengths, reach)
    parts = [_part(qf, k[:, a:z], v[:, a:z], hist[:, :, a:z], True)
             for a, z in split_ranges(cap)]
    kn, vn = k_new.to(torch.float32), v_new.to(torch.float32)
    parts += [_part(qf, kn[:, a:z], vn[:, a:z], own[:, :, a:z], True)
              for a, z in split_ranges(L)]
    return _combine(parts)


def split_walk_decode(q, k8, k_scale, v8, v_scale, pos_buf, pos, *,
                      window=None):
    """The decode op (B5) as the kernel walks it: no chunk parts, no
    re-mask after exp. (B, KV, G, hd) f32."""
    hd = q.shape[-1]
    qf = q.to(torch.float32)[:, None] * (hd ** -0.5)
    k, v = _deq(k8, k_scale), _deq(v8, v_scale)
    vis = tda_ref.visible(pos_buf, pos, window)[:, None]     # (B, 1, S)
    parts = [_part(qf, k[:, a:z], v[:, a:z], vis[:, :, a:z], False)
             for a, z in split_ranges(k8.shape[1])]
    return _combine(parts)[:, 0]


def make_case(rng, b, L, cap, ring, *, fill, lengths, kv=2, g=3, hd=16):
    """numpy operands; row r's ring holds the ``fill[r]`` positions before
    its chunk (fill > cap has wrapped). ring: float32, bfloat16 (q, chunk
    and ring rounded to bf16) or int8 (with scales)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kn, vn = f(b, L, kv, g, hd), f(b, L, kv, hd), f(b, L, kv, hd)
    ks = vs = None
    if ring == "int8":
        kc = rng.integers(-127, 128, (b, cap, kv, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, cap, kv, hd)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (b, cap, kv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (b, cap, kv)).astype(np.float32)
    else:
        kc, vc = f(b, cap, kv, hd), f(b, cap, kv, hd)
    pb = np.full((b, cap), -1, np.int32)
    for r, n in enumerate(fill):
        for p in range(max(0, n - cap), n):
            pb[r, p % cap] = p
    positions = (np.asarray(fill)[:, None] + np.arange(L)[None]).astype(
        np.int32)
    return [q, kn, vn, kc, ks, vc, vs, pb, positions,
            np.asarray(lengths, np.int32)]


def _torch_args(case, ring):
    out = [None if a is None else torch.from_numpy(np.array(a))
           for a in case]
    if ring == "bfloat16":
        for i in (0, 1, 2, 3, 5):
            out[i] = out[i].to(torch.bfloat16)
    return out


def _jax_args(targs):
    """The same values for the reference (bf16 stays bf16)."""
    out = []
    for a in targs:
        if a is None:
            out.append(None)
        elif a.dtype == torch.bfloat16:
            out.append(jnp.asarray(a.float().numpy(), jnp.bfloat16))
        else:
            out.append(jnp.asarray(a.numpy()))
    return out


# cap 300: parts 128, 128, 44 (not a multiple of the part size); cap 256:
# two whole parts. fills: partly full rows (some parts masked for every
# row), a wrapped ring, an empty ring with length 0 (the row sees nothing)
CASES = {
    "partial": dict(cap=300, fill=[5, 150, 299], window=None),
    "wrapped": dict(cap=300, fill=[301, 777, 1000], window=None),
    "window": dict(cap=300, fill=[40, 650, 1000], window=100),
    "one_part_seen": dict(cap=256, fill=[100, 60, 20], window=None),
}


class TestSplitWalk:
    @pytest.mark.parametrize("ring", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("L", [1, 8])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_matches_reference(self, name, L, ring):
        c = CASES[name]
        rng = np.random.default_rng(
            [sorted(CASES).index(name), L, len(ring)])
        case = make_case(rng, 3, L, c["cap"], ring, fill=c["fill"],
                         lengths=[L, 0, max(L - 3, 1)])
        targs = _torch_args(case, ring)
        got = split_walk(*targs, window=c["window"])
        jargs = _jax_args(targs)
        want = np.asarray(jref.chunk_attention_ref(*jargs,
                                                   window=c["window"]))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        stream = np.asarray(jax_chunk(*jargs, window=c["window"],
                                      backend="stream"))
        np.testing.assert_allclose(got.numpy(), stream, **TOL)
        # the port's CPU path (the plain online walk) agrees as well
        np.testing.assert_allclose(
            got.numpy(), tca_ops.chunk_attention(
                *targs, window=c["window"]).numpy(), **TOL)

    @pytest.mark.parametrize("ring", ["bfloat16", "int8"])
    def test_matches_pallas_in_interpret_mode(self, ring):
        rng = np.random.default_rng(11)
        case = make_case(rng, 2, 4, 300, ring, fill=[777, 150],
                         lengths=[4, 2])
        targs = _torch_args(case, ring)
        want = np.asarray(jax_chunk(*_jax_args(targs), window=None,
                                    backend="pallas", interpret=True))
        np.testing.assert_allclose(split_walk(*targs).numpy(), want, **TOL)

    def test_a_part_masked_for_every_row_adds_nothing(self):
        """Rows filled to < 128 positions: parts 1 and 2 of cap 300 hold
        nothing; dropping them from the walk changes no bit."""
        rng = np.random.default_rng(12)
        case = make_case(rng, 2, 3, 300, "float32", fill=[100, 30],
                         lengths=[3, 3])
        targs = _torch_args(case, "float32")
        full = split_walk(*targs)
        hd = targs[0].shape[-1]
        qf = targs[0] * hd ** -0.5
        hist = tca_ref.history_mask(targs[7], targs[8], 300)
        assert not hist[:, :, 128:].any()
        own = tca_ref.chunk_mask(targs[8], targs[9], 300)
        first = _combine([
            _part(qf, targs[3][:, :128], targs[5][:, :128], hist[:, :, :128],
                  True),
            _part(qf, targs[1], targs[2], own, True)])
        assert torch.equal(full, first)

    def test_rows_that_see_nothing_give_zero(self):
        rng = np.random.default_rng(13)
        case = make_case(rng, 2, 4, 300, "int8", fill=[0, 0],
                         lengths=[0, 0])
        got = split_walk(*_torch_args(case, "int8"))
        assert not got.abs().max() > 0

    @pytest.mark.parametrize("ring", ["float32", "bfloat16", "int8"])
    def test_length_one_chunk_at_L1_and_L64(self, ring):
        """A row's query at l = 0 with one chunk key: the same result in an
        L = 1 call and in an L = 64 call with lengths = 1 (one chunk part in
        both), and the reference's."""
        rng = np.random.default_rng(14)
        case = make_case(rng, 3, 64, 1024, ring, fill=[600, 1500, 64],
                         lengths=[1, 1, 1])
        t64 = _torch_args(case, ring)
        t1 = [a[:, :1] if i in (0, 1, 2, 8) else a
              for i, a in enumerate(t64)]
        assert len(split_ranges(1)) == len(split_ranges(64)) == 1
        got1, got64 = split_walk(*t1), split_walk(*t64)
        np.testing.assert_allclose(got64[:, :1].numpy(), got1.numpy(),
                                   rtol=1e-6, atol=1e-6)
        want = np.asarray(jref.chunk_attention_ref(*_jax_args(t1)))
        np.testing.assert_allclose(got1.numpy(), want, **TOL)


class TestSplitWalkDecode:
    @pytest.mark.parametrize("window", [None, 40])
    @pytest.mark.parametrize("s", [96, 300])
    def test_matches_reference_and_blind_row_is_mean_of_v(self, s, window):
        rng = np.random.default_rng(s + (window or 0))
        b, kv, g, hd = 3, 2, 3, 16
        q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
        k8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
        v8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
        pos = np.asarray([5, 2 * s + 7, 70], np.int32)
        pb = np.full((b, s), -1, np.int32)
        for r in range(b - 1):
            for p in range(max(0, pos[r] - s + 1), pos[r] + 1):
                pb[r, p % s] = p
        case = [q, k8, ks, v8, vs, pb, pos]
        got = split_walk_decode(*[torch.from_numpy(a) for a in case],
                                window=window).numpy()
        want = np.asarray(jda_ref.decode_attention_ref(
            *[jnp.asarray(a) for a in case], window=window))
        np.testing.assert_allclose(got, want, **TOL)
        # row 2 sees nothing: every in-ring slot weighs exp(0) = 1 in every
        # part, so the combine gives the uniform mean of v over the ring
        v = v8[2].astype(np.float32) * vs[2][..., None]
        np.testing.assert_allclose(
            got[2], np.broadcast_to(v.mean(0)[:, None], (kv, g, hd)), **TOL)


class TestSplitRanges:
    @pytest.mark.parametrize("n", [1, 96, 128, 300, 1024, 4096])
    def test_ranges_cover_in_order_and_depend_on_n_alone(self, n):
        r = split_ranges(n)
        assert r[0][0] == 0 and r[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        assert all(z - a == PART_SLOTS for a, z in r[:-1])
        assert 0 < r[-1][1] - r[-1][0] <= PART_SLOTS
        # one argument: nothing about the batch, the fill, L or the window
        assert list(inspect.signature(split_ranges).parameters) == ["n"]

    def test_main_path_partition(self):
        """cap 1024: 8 ring parts; a decode step's chunk (L = 1) and a
        64-token prefill chunk both add one part."""
        assert len(split_ranges(1024)) == 8
        assert len(split_ranges(1)) == len(split_ranges(64)) == 1
