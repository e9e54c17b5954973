"""The port's MoE FFN and the plain versions of the kernels' new shapes
against the reference, at smoke size.

``moe_forward`` holds the MoE layers of the reference's smoke grok-1-314b
(4 experts, top-2, no shared expert) and deepseek-moe-16b (8 experts,
top-2, a shared expert) initialised from ``PRNGKey(0)`` — floating-point
and PTQTP-quantized (G = 32) — at capacity factors -1 (no drop), 1.25
(the published one) and 0.5 (a cap under the mean load, so assignments
drop), with and without padding rows under ``valid``. Exact: the dispatch
decisions (each token's experts ``top_e``, the sorted order, ``keep`` and
``dst``, the capacity) and, on a router built to tie, the order of tied
experts (the lower id first, as ``jax.lax.top_k``). Within rtol = atol =
1e-5 (f32 sums in another order; outputs ~ 1): the layer's output.

Plain versions: the expert-axis ternary product against the reference's
``jax.vmap`` of its ternary matmul over the experts (rtol = atol = 1e-4,
|y| ~ 10) and bit for bit against per-expert calls; chunk attention and
decode attention at gemma3-27b's head dim of 168 against the reference's
ops (rtol = atol = 1e-4, outputs are convex mixes of values ~ 1), and the
walk's value dims composed across the 128-dim boundary of the kernel's
passes (exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.kernels.chunk_attention.ops import chunk_attention as jchunk_attention
from repro.kernels.decode_attention import ref as jda_ref
from repro.kernels.ternary_matmul import ops as jtm_ops
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models.common import dense as jdense
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.packing import pack_trits
from repro_torch.kernels.chunk_attention import ops as tca_ops
from repro_torch.kernels.decode_attention import ops as tda_ops
from repro_torch.kernels.ternary_matmul import ops as ttm_ops
from repro_torch.kernels.ternary_matmul import ref as ttm_ref
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_layers(arch, quantized):
    """The reference's first MoE layer params and the port's module with
    the same bytes, and both configs."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    if quantized:
        params, _ = jquantize_tree(params, JPTQTPConfig(group_size=32,
                                                        t_max=3))
    cfg = configs.get_smoke_config(arch)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    jp = jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["moe"])
    layer = len(cfg.prefix_pattern)
    return jp, jcfg, model.layers[layer].moe, cfg


def _ref_dispatch(jp, x, moe, valid):
    """The reference's dispatch decisions, its ``moe_forward`` lines as
    they are."""
    b, s, d = x.shape
    t = b * s
    e, k = moe.n_experts, moe.top_k
    xf = x.reshape(t, d)
    logits = jdense(jp["router"], xf.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    if valid is not None:
        flat_e = jnp.where(jnp.repeat(valid.reshape(t), k), flat_e, e)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    stok = jnp.repeat(jnp.arange(t), k)[order]
    counts = jnp.bincount(se, length=e)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(t * k) - starts[jnp.minimum(se, e - 1)]
    if moe.capacity_factor <= 0:
        cap = t * k
    else:
        cap = int(max(1, round(t * k / e * moe.capacity_factor)))
    keep = (rank < cap) & (se < e)
    dst = jnp.where(keep, se * cap + jnp.clip(rank, 0, cap - 1), e * cap)
    return dict(top_e=top_e, order=order, se=se, stok=stok, keep=keep,
                dst=dst, counts=counts, cap=cap)


def _valid(b, s, rng):
    lens = rng.integers(1, s + 1, (b,))
    lens[0] = s
    return np.arange(s)[None, :] < lens[:, None]


@pytest.mark.parametrize("padded", [False, True], ids=["dense", "padded"])
@pytest.mark.parametrize("cf", [-1.0, 0.5, 1.25])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "ptqtp"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-moe-16b"])
def test_moe_forward_matches_reference(arch, quantized, cf, padded):
    jp, jcfg, layer, cfg = _moe_layers(arch, quantized)
    jm = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    pm = dataclasses.replace(cfg.moe, capacity_factor=cf)
    rng = np.random.default_rng(int(10 * cf) + 20 + 3 * padded + quantized)
    b, s = 3, 8    # T = 24: at cf 1.25 cap 15 (grok), 8 (deepseek)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    valid = _valid(b, s, rng) if padded else None
    jvalid = None if valid is None else jnp.asarray(valid)
    tvalid = None if valid is None else torch.from_numpy(valid)
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x), jm, jcfg.mlp_type,
                                       valid=jvalid))
    got = tmoe.moe_forward(layer, pm, torch.from_numpy(x), tvalid).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    ref = _ref_dispatch(jp, jnp.asarray(x), jm, jvalid)
    ours = tmoe.dispatch(layer, pm, torch.from_numpy(x).reshape(-1,
                                                                 cfg.d_model),
                         None if tvalid is None else tvalid.reshape(-1))
    assert ours["cap"] == ref["cap"] == tmoe.capacity(b * s, pm)
    for name in ("top_e", "order", "se", "stok", "keep", "dst", "counts"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    if cf == 0.5:  # cap under the mean load: some assignments drop
        assert not bool(ours["keep"][ours["se"] < pm.n_experts].all())


def test_tied_router_probabilities_take_the_lower_expert_first():
    """Experts 1 and 3 (and, for half the tokens, 0 and 2) get equal logits
    bit for bit: both packages pick the same experts in the same order,
    the lower id first, and drop the same assignments at capacity."""
    jp, jcfg, layer, cfg = _moe_layers("grok-1-314b", False)
    kern = np.array(jp["router"]["kernel"])
    kern[:, 3] = kern[:, 1]
    kern[:, 2] = kern[:, 0]
    kern[:, 1] += 0.5   # 1 and 3 tie, ahead of 0 and 2 for most tokens
    kern[:, 3] += 0.5
    jp = dict(jp, router={"kernel": jnp.asarray(kern)})
    layer.router.weight.copy_(torch.from_numpy(kern.T.copy()))
    jm = dataclasses.replace(jcfg.moe, capacity_factor=1.25)
    pm = dataclasses.replace(cfg.moe, capacity_factor=1.25)
    x = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)).astype(
        np.float32)
    ours = tmoe.dispatch(layer, pm, torch.from_numpy(x).reshape(16, -1))
    probs = tmoe.router_probs(layer, torch.from_numpy(x).reshape(16, -1))
    assert torch.equal(probs[:, 1], probs[:, 3])
    assert torch.equal(probs[:, 0], probs[:, 2])
    ref = _ref_dispatch(jp, jnp.asarray(x), jm, None)
    for name in ("top_e", "order", "keep", "dst"):
        np.testing.assert_array_equal(ours[name].numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    top = ours["top_e"].numpy()
    assert (top[:, 0] < top[:, 1])[np.isin(top[:, 0], (0, 1))].all()
    want = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x), jm,
                                       jcfg.mlp_type))
    got = tmoe.moe_forward(layer, pm, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_capacity_rounds_as_the_reference():
    """cap = max(1, round(T·k/E·cf)) with Python's round (halves to even),
    T·k when cf <= 0; deepseek's full config at its serving dispatches."""
    moe = configs.get_config("deepseek-moe-16b").moe
    assert tmoe.capacity(8, moe) == 1          # a decode step of 8 slots
    assert tmoe.capacity(512, moe) == 60       # a 64-token prefill bucket
    nodrop = dataclasses.replace(moe, capacity_factor=-1.0)
    assert tmoe.capacity(512, nodrop) == 3072
    small = configs.get_smoke_config("grok-1-314b").moe
    half = dataclasses.replace(small, capacity_factor=1.25)
    assert [tmoe.capacity(t, half) for t in (1, 4, 8, 12)] == \
        [max(1, round(t * 2 / 4 * 1.25)) for t in (1, 4, 8, 12)] == \
        [1, 2, 5, 8]


# --------------------------------------------------------- plain versions
def test_expert_axis_plain_matches_reference_vmap():
    """``ternary_matmul_experts`` on CPU tensors: each expert's rows equal a
    per-expert call of the plain product bit for bit, and the whole equals
    the reference's ``jax.vmap`` of its ternary matmul (its expert route,
    ``models/moe.py``) within 1e-4."""
    rng = np.random.default_rng(3)
    e, m, n, d, g = 4, 6, 48, 128, 32
    t1 = rng.integers(-1, 2, (e, n, d)).astype(np.int8)
    t2 = rng.integers(-1, 2, (e, n, d)).astype(np.int8)
    alpha = rng.uniform(0.01, 0.1, (e, n, d // g, 2)).astype(np.float32)
    x = rng.standard_normal((e, m, d)).astype(np.float32)
    t1p = torch.stack([pack_trits(torch.from_numpy(a)) for a in t1])
    t2p = torch.stack([pack_trits(torch.from_numpy(a)) for a in t2])
    got = ttm_ops.ternary_matmul_experts(torch.from_numpy(x), t1p, t2p,
                                         torch.from_numpy(alpha),
                                         group_size=g)
    assert got.shape == (e, m, n) and got.dtype == torch.float32
    for i in range(e):
        assert torch.equal(got[i], ttm_ref.ternary_matmul_grouped(
            torch.from_numpy(x[i]), t1p[i], t2p[i],
            torch.from_numpy(alpha[i]), g))
    want = jax.vmap(lambda xi, a, b, al: jtm_ops.ternary_matmul(
        xi, a, b, al, group_size=g))(jnp.asarray(x), jnp.asarray(t1p.numpy()),
                                     jnp.asarray(t2p.numpy()),
                                     jnp.asarray(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _attention_case(rng, b, L, kv, g, hd, cap):
    q = rng.standard_normal((b, L, kv, g, hd)).astype(np.float32)
    kn = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, L, kv, hd)).astype(np.float32)
    kc = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, cap, kv, hd)).astype(np.float32)
    pb = np.full((b, cap), -1, np.int32)
    pos0 = rng.integers(0, 3 * cap, (b,))
    for r in range(b):
        for p in range(max(0, pos0[r] - cap), pos0[r]):
            pb[r, p % cap] = p
    positions = (pos0[:, None] + np.arange(L)[None, :]).astype(np.int32)
    lengths = np.asarray([L, 0, max(L - 3, 1)][:b], np.int32)
    return [q, kn, vn, kc, None, vc, None, pb, positions, lengths]


@pytest.mark.parametrize("L,window", [(1, None), (12, None), (12, 8)])
def test_attention_plain_at_head_dim_168(L, window):
    """Chunk attention at hd 168 (gemma3-27b's) against the reference's
    streaming op; its value dims past 128 (the kernel's second pass) are
    separable: zeroing them leaves dims 0-127 bit for bit."""
    rng = np.random.default_rng(L + (window or 0))
    case = _attention_case(rng, 3, L, 2, 2, 168, 16)
    t = [None if a is None else torch.from_numpy(a) for a in case]
    got = tca_ops.chunk_attention(*t, window=window)
    want = np.asarray(jchunk_attention(
        *[None if a is None else jnp.asarray(a) for a in case],
        window=window, backend="stream"))
    assert got.shape == (3, L, 2, 2, 168)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    cut = list(t)
    cut[2] = t[2].clone()
    cut[5] = t[5].clone()
    cut[2][..., 128:] = 0.0
    cut[5][..., 128:] = 0.0
    part = tca_ops.chunk_attention(*cut, window=window)
    assert torch.equal(part[..., :128], got[..., :128])
    assert not bool(part[..., 128:].any())


@pytest.mark.parametrize("window", [None, 6])
def test_decode_attention_plain_at_head_dim_168(window):
    """B5's plain version at hd 168 against the reference's oracle."""
    rng = np.random.default_rng(168 + (window or 0))
    b, s, kv, g, hd = 3, 16, 2, 2, 168
    q = rng.standard_normal((b, kv, g, hd)).astype(np.float32)
    k8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    v8 = rng.integers(-127, 128, (b, s, kv, hd)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, s, kv)).astype(np.float32)
    pos = rng.integers(0, 3 * s, (b,)).astype(np.int32)
    pb = np.full((b, s), -1, np.int32)
    for r in range(b):
        for p in range(max(0, pos[r] - s + 1), pos[r] + 1):
            pb[r, p % s] = p
    case = [q, k8, ks, v8, vs, pb, pos]
    got = tda_ops.decode_attention(*[torch.from_numpy(a) for a in case],
                                   window=window)
    want = np.asarray(jda_ref.decode_attention_ref(
        *[jnp.asarray(a) for a in case], window=window))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
