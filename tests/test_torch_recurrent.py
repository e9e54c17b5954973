"""The recurrent decoders in the port against the reference, at smoke size:
recurrentgemma-2b (RG-LRU layers and sliding-window local attention, 2:1)
and rwkv6-3b (attention-free: the RWKV6 time and channel mixes).

Each arch is initialised by the reference from ``PRNGKey(0)``; the port
loads the same bytes (``from_jax_params``). The recurrences' plain
versions (``kernels/rglru_scan/ref.py``, ``kernels/wkv6/ref.py``, the CPU
stand-ins of the CUDA kernels) run against the reference's scans with
masks, lengths of 0 and the state handed over between calls; the blocks,
the models' logits and caches, chunked and padded prefill, the engines'
greedy streams (ring, paged, ``SerialAdmitEngine``, a reused paged slot),
the quantized leaves, the reference tree and the artifacts follow.

Exact: integers, token streams, planes, tree bytes and artifacts. Floats
within rtol = atol = 2e-4, the reference's own tolerance for its recurrent
prefill tests (``tests/test_prefill.py``): f32 sums in another order
(logits ~ 4).
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import artifacts as jart
from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models.transformer import decode_step as jdecode_step
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_decode_state as jinit_decode_state
from repro.models.transformer import prefill as jprefill
from repro.models.transformer import prefill_chunk as jprefill_chunk
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import SerialAdmitEngine as JSerialAdmitEngine
from repro_torch import artifacts as part
from repro_torch import configs
from repro_torch.artifacts import format as pfmt
from repro_torch.convert import from_jax_params, to_reference_tree
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.core.quantize_model import QuantizedKernel, quantize_tree
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill, prefill_chunk)
from repro_torch.models.common import bmm_fixed_rows
from repro_torch.models.rglru import RGLRU, rglru_forward
from repro_torch.models.rwkv6 import rwkv_channel_forward, rwkv_time_forward
from repro_torch.serving import (EngineConfig, SamplingParams,
                                 SerialAdmitEngine, ServingEngine)

torch.set_num_threads(1)

ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
G, T_MAX = 64, 5
TOL = dict(rtol=2e-4, atol=2e-4)
FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
TIMING = ("created", "finalized")


@functools.lru_cache(maxsize=None)
def _ref(arch):
    """(reference config, its fp params, its quantized tree, report)."""
    jcfg = jconfigs.get_smoke_config(arch)
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    qtree, report = jquantize_tree(params, JPTQTPConfig(group_size=G,
                                                        t_max=T_MAX))
    return jcfg, params, qtree, report


def _port(tree, arch):
    cfg = configs.get_smoke_config(arch)
    return from_jax_params(jax.tree.map(np.asarray, tree), cfg,
                           device="cpu"), cfg


@functools.lru_cache(maxsize=None)
def _quantized(arch):
    jcfg, _, qtree, _ = _ref(arch)
    model, cfg = _port(qtree, arch)
    return jcfg, qtree, cfg, model


def _np(t):
    return t.detach().numpy()


def test_registry_holds_the_recurrent_archs():
    for arch in ARCHS:
        for get in ("get_config", "get_smoke_config"):
            ours = dataclasses.asdict(getattr(configs, get)(arch))
            theirs = dataclasses.asdict(getattr(jconfigs, get)(arch))
            assert ours == theirs, (arch, get)
    assert configs.get_config("recurrentgemma-2b").head_dim == 256
    assert configs.get_config("rwkv6-3b").d_model // 64 == 40


# ------------------------------------------------------------ the scans
def _lengths_mask(lengths, s):
    return np.arange(s)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("split", [0, 3])
def test_rglru_scan_plain_matches_the_reference_scan(split):
    """h_t = a_t h_{t-1} + gx_t over ragged rows (one of length 0), in one
    call or in two with the state handed over; the states of every step
    and the last one within 2e-4 (exact in fact: the same two roundings)."""
    rng = np.random.default_rng(1)
    b, s, r = 4, 7, 24
    a = rng.uniform(0.01, 0.99, (b, s, r)).astype(np.float32)
    gx = (rng.standard_normal((b, s, r)) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((b, r)).astype(np.float32)
    lengths = np.asarray([7, 4, 0, 1], np.int32)
    want, want_h = jrglru._lru_scan(jnp.asarray(a), jnp.asarray(gx),
                                    jnp.asarray(h0),
                                    jnp.asarray(_lengths_mask(lengths, s)))
    h = torch.from_numpy(h0.copy())
    parts = [(0, split), (split, s)] if split else [(0, s)]
    outs = []
    for lo, hi in parts:
        part_len = np.clip(lengths - lo, 0, hi - lo).astype(np.int32)
        outs.append(rglru_scan(torch.from_numpy(a[:, lo:hi].copy()),
                               torch.from_numpy(gx[:, lo:hi].copy()), h,
                               torch.from_numpy(part_len)))
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(_np(h), np.asarray(want_h), **TOL)


def _jax_wkv(r, k, v, w, u, s0, mask, scale, h):
    """The reference's WKV scan (``rwkv6.py``: the step of
    ``rwkv_time_forward``) and its ``_group_norm``, on given operands."""
    def step(st, inp):
        rt, kt, vt, wt, mt = inp
        kv = jnp.einsum("bhi,bhj->bhij", kt, vt)
        yt = jnp.einsum("bhi,bhij->bhj", rt, st + u[None, :, :, None] * kv)
        st_new = wt[..., None] * st + kv
        return jnp.where(mt[:, None, None, None], st_new, st), yt

    xs = tuple(jnp.moveaxis(t, 1, 0) for t in (r, k, v, w, mask))
    s_last, ys = jax.lax.scan(step, s0, xs)
    b, s = r.shape[:2]
    y = jnp.moveaxis(ys, 0, 1).reshape(b, s, -1)
    return jrwkv._group_norm(scale, y, h), s_last


@pytest.mark.parametrize("split", [0, 2])
def test_wkv6_plain_matches_the_reference_scan(split):
    """The WKV readout of every step, group-normed per head, and the state
    after ragged rows (one of length 0), in one call or two with the state
    handed over, within 2e-4."""
    rng = np.random.default_rng(2)
    b, s, nh, hd = 3, 6, 2, 16

    def rnd(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    r, k, v = rnd(b, s, nh, hd, std=0.5), rnd(b, s, nh, hd, std=0.5), \
        rnd(b, s, nh, hd, std=0.5)
    w = np.exp(-np.exp(rnd(b, s, nh, hd, std=0.5) - 1.0)).astype(np.float32)
    u, s0 = rnd(nh, hd, std=0.1), rnd(b, nh, hd, hd, std=0.1)
    scale = 1.0 + rnd(nh * hd, std=0.1)
    lengths = np.asarray([6, 3, 0], np.int32)
    want, want_s = _jax_wkv(*(jnp.asarray(t) for t in (r, k, v, w, u, s0)),
                            jnp.asarray(_lengths_mask(lengths, s)),
                            jnp.asarray(scale), nh)
    state = torch.from_numpy(s0.copy())
    t = [torch.from_numpy(x) for x in (r, k, v, w)]
    parts = [(0, split), (split, s)] if split else [(0, s)]
    outs = []
    for lo, hi in parts:
        part_len = np.clip(lengths - lo, 0, hi - lo).astype(np.int32)
        outs.append(wkv6(*(x[:, lo:hi].contiguous() for x in t),
                         torch.from_numpy(u), state,
                         torch.from_numpy(part_len), torch.from_numpy(scale)))
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(_np(state), np.asarray(want_s), **TOL)


# ------------------------------------------------------------ the blocks
def _layer0(arch, tree_key="b0"):
    """(the reference's layer-0 params, the port's layer 0) of the fp
    smoke model."""
    _, params, _, _ = _ref(arch)
    model, cfg = _port(params, arch)
    node = jax.tree.map(lambda a: a[0], params["blocks"][tree_key])
    return node, model.layers[0], cfg


def _inputs(cfg, b=3, s=5, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    lengths = np.asarray([s, 2, 0], np.int32)[:b]
    return x, lengths


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_rglru_forward_matches_the_reference(with_state, masked):
    node, layer, cfg = _layer0("recurrentgemma-2b")
    x, lengths = _inputs(cfg)
    b, s, _ = x.shape
    r, width = cfg.rglru_width, cfg.conv_width
    rng = np.random.default_rng(4)
    h0 = rng.standard_normal((b, r)).astype(np.float32) if with_state \
        else np.zeros((b, r), np.float32)
    c0 = rng.standard_normal((b, width - 1, r)).astype(np.float32) \
        if with_state else np.zeros((b, width - 1, r), np.float32)
    mask = _lengths_mask(lengths, s) if masked else None
    y, (h_last, conv) = jrglru.rglru_forward(
        node["rec"], jnp.asarray(x), cfg.rglru_blocks,
        state=(jnp.asarray(h0), jnp.asarray(c0)) if with_state else None,
        mask=None if mask is None else jnp.asarray(mask))
    h, c = torch.from_numpy(h0.copy()), torch.from_numpy(c0.copy())
    lens = lengths if masked else np.full((b,), s, np.int32)
    got = rglru_forward(layer.rec, torch.from_numpy(x), h, c,
                        torch.from_numpy(lens))
    rows = lens > 0
    np.testing.assert_allclose(_np(got)[rows], np.asarray(y)[rows], **TOL)
    np.testing.assert_allclose(_np(h), np.asarray(h_last), **TOL)
    np.testing.assert_allclose(_np(c), np.asarray(conv), **TOL)


def _composition(p, x, h, conv, lengths):
    """The RG-LRU layer as the port ran it before its gate-and-scan was one
    call: PyTorch's ops one by one around the scan alone."""
    b, s, _ = x.shape
    xb = p.wx(x)
    gb = torch.nn.functional.gelu(p.wgate(x), approximate="tanh")
    w = p.conv.w.to(x.dtype)
    width = w.shape[0]
    xp = torch.cat([conv, xb], dim=1)
    c = xp[:, 0:s] * w[0]
    for i in range(1, width):
        c = c + xp[:, i:i + s] * w[i]
    c = c + p.conv.b.to(x.dtype)
    idx = (lengths.long()[:, None]
           + torch.arange(width - 1, device=x.device)[None, :])
    conv.copy_(torch.gather(xp, 1, idx[..., None].expand(
        b, width - 1, xp.shape[-1])))

    def block_diag(gate):
        r = c.shape[-1]
        rb = r // p.n_blocks
        xb = c.reshape(-1, p.n_blocks, rb).transpose(0, 1)
        y = bmm_fixed_rows(xb, gate.w.to(c.dtype).transpose(1, 2))
        return y.transpose(0, 1).reshape(b, s, r) + gate.b.to(c.dtype)

    rt = torch.sigmoid(block_diag(p.gate_a)).to(torch.float32)
    it = torch.sigmoid(block_diag(p.gate_x)).to(torch.float32)
    lam = p.lam.to(torch.float32)
    log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * rt
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (it * c.to(torch.float32))
    hs = rglru_scan(a, gated_x, h, lengths)
    return p.wo((gb.to(torch.float32) * hs).to(x.dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_gated_scan_equals_the_composition_it_replaced(size, dtype):
    """``rglru_forward`` through ``rglru_gated_scan`` (on the CPU its plain
    version) gives the output, h and conv tail of the layer's former op by
    op composition bit for bit: smoke width (4 rows) and full width (2560
    in 10 blocks, 3 rows), f32 and bf16, with full, ragged and idle rows,
    nonzero gate biases and a prior state."""
    d, r, nb, b, s = ((64, 64, 4, 4, 6) if size == "smoke"
                      else (2560, 2560, 10, 3, 3))
    lengths = torch.tensor([s, s - 2, 0, 1][:b], dtype=torch.int32)
    rng = np.random.default_rng(7)

    def rnd(shape, std):
        return torch.from_numpy(
            (rng.standard_normal(shape) * std).astype(np.float32)).to(dtype)

    p = RGLRU(d, r, nb, 4, dtype=dtype, device="cpu")
    with torch.no_grad():
        for dense in (p.wx, p.wgate, p.wo):
            dense.weight.copy_(rnd(dense.weight.shape, dense.d_in ** -0.5))
        p.init_random(rnd)
        for wb in (p.conv, p.gate_a, p.gate_x):
            wb.b.copy_(rnd(wb.b.shape, 0.1))
    x = rnd((b, s, d), 1.0)
    h0 = torch.from_numpy(rng.standard_normal((b, r)).astype(np.float32))
    c0 = rnd((b, 3, r), 1.0)
    h1, h2, c1, c2 = h0.clone(), h0.clone(), c0.clone(), c0.clone()
    got = rglru_forward(p, x, h1, c1, lengths)
    want = _composition(p, x, h2, c2, lengths)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(h1, h2) and torch.equal(c1, c2)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_rwkv_mixes_match_the_reference(with_state, masked):
    node, layer, cfg = _layer0("rwkv6-3b")
    x, lengths = _inputs(cfg)
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    rng = np.random.default_rng(5)

    def st(*shape, std=1.0):
        return (rng.standard_normal(shape) * std).astype(np.float32) \
            if with_state else np.zeros(shape, np.float32)

    xt0, s0, xc0 = st(b, d), st(b, d // hd, hd, hd, std=0.1), st(b, d)
    mask = jnp.asarray(_lengths_mask(lengths, s)) if masked else None
    jstate = (jnp.asarray(xt0), jnp.asarray(s0)) if with_state else None
    y, (x_last, s_last) = jrwkv.rwkv_time_forward(
        node["time"], jnp.asarray(x), hd, state=jstate, mask=mask)
    yc, xc_last = jrwkv.rwkv_channel_forward(
        node["chan"], jnp.asarray(x),
        state=jnp.asarray(xc0) if with_state else None, mask=mask)
    lens = torch.from_numpy(lengths if masked else np.full((b,), s,
                                                           np.int32))
    xt, wkv, xc = (torch.from_numpy(a.copy()) for a in (xt0, s0, xc0))
    got = rwkv_time_forward(layer.time, torch.from_numpy(x), xt, wkv, lens)
    got_c = rwkv_channel_forward(layer.chan, torch.from_numpy(x), xc, lens)
    rows = _np(lens) > 0
    np.testing.assert_allclose(_np(got)[rows], np.asarray(y)[rows], **TOL)
    np.testing.assert_allclose(_np(got_c)[rows], np.asarray(yc)[rows], **TOL)
    for mine, theirs in ((xt, x_last), (wkv, s_last), (xc, xc_last)):
        np.testing.assert_allclose(_np(mine), np.asarray(theirs), **TOL)


# ------------------------------------------------------------ the models
STEPS = [("prefill", [[5, 9, 17, 2, 33, 8, 1, 90, 4, 4, 7, 11],
                      [7, 7, 300, 2, 4, 0, 0, 0, 0, 0, 0, 0],
                      [0] * 12], [12, 5, 0]),
         ("decode", [42, 43, 44], [True, True, False]),
         ("prefill", [[11, 12, 13, 14, 0, 0], [0] * 6,
                      [3, 4, 5, 6, 7, 8]], [4, 0, 6]),
         ("decode", [1, 2, 3], [True, True, True])]
B, CAP = 3, 32


def _jlayers(jstate, cfg):
    out = [jstate["prefix"][f"p{i}"] for i in range(len(cfg.prefix_pattern))]
    for i in range(cfg.n_periods):
        for pidx in range(cfg.period):
            out.append(jax.tree.map(lambda a: a[i],
                                    jstate["blocks"][f"b{pidx}"]))
    return out + [jstate["suffix"][f"s{i}"]
                  for i in range(len(cfg.remainder_pattern))]


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_caches_match_the_reference(arch):
    """``forward`` over 16 tokens, ``prefill`` of 12, then chunked serving
    steps (padding, no-op rows, decode with a frozen row): logits within
    2e-4, positions exact, every cache leaf (rings, h, conv, x_time, wkv,
    x_chan) within 2e-4 after every step."""
    jcfg, qtree, cfg, model = _quantized(arch)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 16)).astype(
        np.int32)
    want = np.asarray(jforward(qtree, jcfg, {"tokens": jnp.asarray(tokens)}))
    np.testing.assert_allclose(_np(forward(model, cfg,
                                           torch.from_numpy(tokens))),
                               want, **TOL)
    jl, _ = jprefill(qtree, jcfg, {"tokens": jnp.asarray(tokens[:, :12])},
                     CAP)
    pl, _ = prefill(model, cfg, torch.from_numpy(tokens[:, :12]), CAP)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)

    jstate = jinit_decode_state(jcfg, B, CAP)
    state = init_decode_state(cfg, B, CAP, device="cpu")
    for step, (kind, toks, arg) in enumerate(STEPS):
        tok = np.asarray(toks, np.int32)
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            jl, jstate = jprefill_chunk(qtree, jcfg, jstate,
                                        {"tokens": jnp.asarray(tok)},
                                        jnp.asarray(lens))
            logits, state = prefill_chunk(model, cfg, state,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(lens))
            rows = lens > 0
        else:
            act = np.asarray(arg)
            jl, jstate = jdecode_step(qtree, jcfg, jstate, jnp.asarray(tok),
                                      jnp.asarray(act))
            logits, state = decode_step(model, cfg, state,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(act))
            rows = act
        np.testing.assert_allclose(_np(logits)[rows], np.asarray(jl)[rows],
                                   **TOL, err_msg=f"step {step} logits")
        np.testing.assert_array_equal(_np(state["pos"]),
                                      np.asarray(jstate["pos"]))
        for i, (jl_, layer) in enumerate(zip(_jlayers(jstate, cfg),
                                             state["layers"])):
            assert sorted(layer) == sorted(jl_), i
            for name, leaf in layer.items():
                msg = f"step {step} layer {i} {name}"
                if name == "pos":
                    np.testing.assert_array_equal(_np(leaf),
                                                  np.asarray(jl_[name]),
                                                  err_msg=msg)
                else:
                    np.testing.assert_allclose(_np(leaf),
                                               np.asarray(jl_[name]), **TOL,
                                               err_msg=msg)


def _greedy(model, cfg, state, tok, n):
    out = []
    for _ in range(n):
        logits, state = decode_step(model, cfg, state, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_whole(arch):
    """The reference's ``test_chunked_matches_full`` on the port: a prompt
    of 11 fed in chunks of 4 (a padded tail) gives the whole prompt's
    logits within 2e-4 and the same greedy continuation (recurrentgemma's
    local rings of 8 wrap)."""
    _, _, cfg, model = _quantized(arch)
    prompt = np.random.default_rng(0).integers(1, 400, size=11).tolist()
    cap = 16
    lg_full, st_full = prefill(model, cfg, torch.tensor([prompt],
                                                        dtype=torch.int32),
                               cap)
    st = init_decode_state(cfg, 1, cap, device="cpu")
    for start in range(0, len(prompt), 4):
        chunk = prompt[start:start + 4]
        t = torch.zeros((1, 4), dtype=torch.int32)
        t[0, :len(chunk)] = torch.tensor(chunk)
        lg, st = prefill_chunk(model, cfg, st, t,
                               torch.tensor([len(chunk)], dtype=torch.int32))
    np.testing.assert_allclose(_np(lg), _np(lg_full), **TOL)
    tok = torch.argmax(lg_full, -1).to(torch.int32)
    assert _greedy(model, cfg, st_full, tok, 4) == \
        _greedy(model, cfg, st, tok, 4)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_batch_matches_per_row(arch):
    """The reference's ``test_padded_batch_matches_per_row`` on the port:
    rows of 2, 5 and 3 tokens in one padded 8-token bucket each give their
    solo prefill's logits within 2e-4 and the same state leaves."""
    _, _, cfg, model = _quantized(arch)
    prompts = [[5, 9], [1, 2, 3, 4, 7], [11, 3, 6]]
    cap, L = 16, 8
    st = init_decode_state(cfg, len(prompts), cap, device="cpu")
    toks = torch.zeros((len(prompts), L), dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    lg, st = prefill_chunk(model, cfg, st, toks, lens)
    assert st["pos"].tolist() == lens.tolist()
    for i, p in enumerate(prompts):
        lg1, st1 = prefill(model, cfg, torch.tensor([p], dtype=torch.int32),
                           cap)
        np.testing.assert_allclose(_np(lg[i:i + 1]), _np(lg1), **TOL)
        for layer, layer1 in zip(st["layers"], st1["layers"]):
            for name in ("h", "conv", "x_time", "wkv", "x_chan"):
                if name in layer:
                    np.testing.assert_allclose(_np(layer[name][i:i + 1]),
                                               _np(layer1[name]), **TOL)


# ------------------------------------------------------------ the engines
PROMPTS = [np.random.default_rng(i).integers(0, 512, n).tolist()
           for i, n in enumerate((5, 23, 40, 9))]
BUDGETS = (6, 9, 12, 3)
ENGINE = dict(max_slots=3, capacity=48, prefill_chunk=16, decode_chunk=4)
# recurrentgemma pages at a capacity within its smoke window of 8 only
PAGED = {"recurrentgemma-2b": dict(capacity=8, page_size=4),
         "rwkv6-3b": dict(page_size=8)}


def _engine_kw(arch, layout):
    kw = dict(ENGINE)
    if layout == "paged":
        kw.update(kv_layout="paged", **PAGED[arch])
    return kw


def _serve(eng, sp, prompts=PROMPTS, budgets=BUDGETS):
    hs = [eng.submit(p, sp(max_new_tokens=n))
          for p, n in zip(prompts, budgets)]
    eng.run()
    return [(list(h.output), h.finish_reason) for h in hs]


@pytest.mark.parametrize("layout", ["ring", "paged", "serial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_equal_the_reference_engine(arch, layout):
    """Four requests on three slots (one waits for a freed slot), greedy:
    the port's ``ServingEngine`` on the ring and the paged layout (prefix
    reuse off: recurrent state cannot skip a prefix) and its
    ``SerialAdmitEngine`` give the reference engines' tokens."""
    jcfg, qtree, cfg, model = _quantized(arch)
    jcls, cls = JServingEngine, ServingEngine
    if layout == "serial":
        jcls, cls = JSerialAdmitEngine, SerialAdmitEngine
    kw = _engine_kw(arch, layout)
    want = _serve(jcls(qtree, jcfg, JEngineConfig(**kw)), JSamplingParams)
    eng = cls(model, cfg, EngineConfig(**kw))
    assert _serve(eng, SamplingParams) == want
    assert eng.tokens_generated == sum(BUDGETS)
    if layout == "paged":
        assert not eng._prefix_reuse


@pytest.mark.parametrize("arch", ARCHS)
def test_a_reused_paged_slot_starts_fresh(arch):
    """On one slot under the paged layout a second request follows a first
    one; it gives the tokens it gives in a fresh engine (the recurrent
    state of the slot is cleared at admission, not only its pages)."""
    _, _, cfg, model = _quantized(arch)
    kw = dict(_engine_kw(arch, "paged"), max_slots=1)
    first, second = PROMPTS[2], PROMPTS[1]
    eng = ServingEngine(model, cfg, EngineConfig(**kw))
    both = _serve(eng, SamplingParams, [first, second], [5, 7])
    fresh = _serve(ServingEngine(model, cfg, EngineConfig(**kw)),
                   SamplingParams, [second], [7])
    assert both[1] == fresh[0]
    assert any(len(c["wkv" if arch == "rwkv6-3b" else "h"]) == 1
               for c in eng.state["layers"] if "table" not in c)


def test_recurrentgemma_refuses_paging_past_its_window():
    """Capacity 64 > the smoke window of 8: both engines raise the same
    ``ValueError``."""
    jcfg, qtree, cfg, model = _quantized("recurrentgemma-2b")
    kw = dict(ENGINE, capacity=64, kv_layout="paged", page_size=8)
    with pytest.raises(ValueError) as theirs:
        JServingEngine(qtree, jcfg, JEngineConfig(**kw))
    with pytest.raises(ValueError) as ours:
        ServingEngine(model, cfg, EngineConfig(**kw))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_memory_stats_count_the_reference_state(arch, layout):
    """``decode_state_bytes`` and the KV bytes of the ring equal the
    reference's (recurrent states are state, not KV); on the paged layout
    the pool's page bytes are equal, and the state differs only by the
    port's scratch page and its one table."""
    jcfg, qtree, cfg, model = _quantized(arch)
    kw = _engine_kw(arch, layout)
    got = ServingEngine(model, cfg, EngineConfig(**kw)).memory_stats()
    want = JServingEngine(qtree, jcfg, JEngineConfig(**kw)).memory_stats()
    if layout == "ring":
        for field in ("decode_state_bytes", "kv_pool_bytes",
                      "kv_resident_bytes"):
            assert got[field] == want[field], field
        return
    assert got["kv_page_bytes"] == want["kv_page_bytes"]
    n_pages = ENGINE["max_slots"] * kw["capacity"] // kw["page_size"]
    table = ENGINE["max_slots"] * (kw["capacity"] // kw["page_size"]) * 4
    n_attn = sum(k.startswith("local") for k in cfg.layer_kinds)
    extra = got["kv_page_bytes"] + table * (1 - n_attn)
    assert got["decode_state_bytes"] == want["decode_state_bytes"] + extra
    assert n_pages > 0


# ------------------------------------------------------------ quantize
def _quant_buffers(model):
    return {name: buf for name, buf in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("t1p", "t2p", "alpha")}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_leaves_equal_the_reference(arch):
    """The port's ``quantize_tree`` on the reference's fp weights quantizes
    the leaves of the reference's report (by path: the dense kernels; the
    conv, the gates, ``lam``, ``u``, the mixes and the LoRAs stay fp) into
    its planes, α within rtol 1e-5."""
    _, params, qtree, jreport = _ref(arch)
    model, cfg = _port(params, arch)
    model, report = quantize_tree(model, PTQTPConfig(group_size=G,
                                                     t_max=T_MAX))
    want, _ = _port(qtree, arch)
    got_b, want_b = _quant_buffers(model), _quant_buffers(want)
    assert sorted(got_b) == sorted(want_b)
    for name, buf in want_b.items():
        if name.endswith("alpha"):
            np.testing.assert_allclose(_np(got_b[name]), _np(buf), rtol=1e-5,
                                       atol=0, err_msg=name)
        else:
            assert torch.equal(got_b[name], buf), name
    # the reference reports a scan-stacked leaf once, the port each layer
    theirs = sorted(p for p in jreport if p != "__total__")
    tree = to_reference_tree(model, cfg)
    ours = sorted(path[:-len("/kernel")]
                  for path, leaf in pfmt.iter_tree_leaves(tree)
                  if isinstance(leaf, QuantizedKernel))
    assert ours == sorted(p[:-len("/kernel")] for p in theirs)


# ------------------------------------------------------------ tree, artifacts
def _raw(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), pfmt.dtype_name(a), pfmt.byte_view(a).tobytes())
    a = np.asarray(a)
    return (tuple(a.shape), str(a.dtype),
            np.ascontiguousarray(a).view(np.uint8).tobytes())


def _leaves(tree):
    out = {}
    for path, leaf in jart.format.iter_tree_leaves(tree):
        if hasattr(leaf, "t1p"):
            out[path] = {f: _raw(getattr(leaf, f)) for f in pfmt.QK_BUFFERS}
            out[path]["meta"] = (leaf.d_in, leaf.d_out, leaf.group_size)
        else:
            out[path] = {"data": _raw(leaf)}
    return out


@pytest.mark.parametrize("kind", ["quantized", "fp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_to_reference_tree_round_trips(arch, kind):
    """``to_reference_tree(from_jax_params(p))`` has p's paths, key order
    (insertion order in recurrentgemma's suffix blocks, sorted in the
    stacked ones), shapes, dtypes and bytes."""
    _, params, qtree, _ = _ref(arch)
    ref_tree = qtree if kind == "quantized" else params
    model, cfg = _port(ref_tree, arch)
    tree = to_reference_tree(model, cfg)
    assert list(_leaves(tree)) == list(_leaves(ref_tree))
    assert _leaves(tree) == _leaves(ref_tree)


def _write(pkg, out, arch, tree, cfg, fmt, ptqtp):
    w = pkg.ArtifactWriter(out, arch=arch,
                           model_config=fmt.model_config_to_json(cfg),
                           ptqtp_config=fmt.ptqtp_config_to_json(ptqtp))
    for path, leaf in fmt.iter_tree_leaves(tree):
        if hasattr(leaf, "t1p"):
            w.add_quantized(path, leaf, source_shape=tuple(
                leaf.t1p.shape[:-2]) + (leaf.d_in, leaf.d_out),
                source_dtype=cfg.param_dtype)
        else:
            w.add_fp(path, leaf)
    return w.finalize()


@pytest.mark.parametrize("arch", ARCHS)
def test_artifacts_cross_both_ways(arch, tmp_path):
    """The port's writer over ``to_reference_tree`` and the reference's
    writer over its tree: equal manifests (timing aside) and shard bytes;
    the port's model read back from the reference's artifact equals the
    one it wrote, tensor for tensor."""
    jcfg, qtree, cfg, model = _quantized(arch)
    ours = _write(part, tmp_path / "port", arch, to_reference_tree(model, cfg),
                  cfg, pfmt, PTQTPConfig(group_size=G, t_max=T_MAX))
    theirs = _write(jart, tmp_path / "ref", arch, qtree, jcfg, jart.format,
                    JPTQTPConfig(group_size=G, t_max=T_MAX))
    m_ours = json.loads((ours / "manifest.json").read_text())
    m_theirs = json.loads((theirs / "manifest.json").read_text())
    strip = lambda m: {k: v for k, v in m.items()  # noqa: E731
                       if k not in TIMING}
    assert strip(m_ours) == strip(m_theirs)
    for shard in m_theirs["shards"]:
        assert (ours / shard["file"]).read_bytes() == \
            (theirs / shard["file"]).read_bytes()
    again, _, _ = part.load_model(theirs, device="cpu")
    a, b = model.state_dict(), again.state_dict()
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name,layout", [("recurrentgemma", "ring"),
                                         ("rwkv6", "ring"),
                                         ("rwkv6", "paged")])
def test_committed_fixture_serves_the_reference_streams(name, layout):
    """The JAX-written fixtures of ``make_artifact_fixture.py``: the port
    serves the JAX engine's greedy streams on the layout, and on the ring
    the bucket-1 request alone."""
    art = FIXTURES / f"{name}_smoke_artifact"
    spec = json.loads((FIXTURES / f"{name}_smoke_streams.json").read_text())
    model, cfg, _ = part.load_model(art, device="cpu")
    reqs = [(r["prompt"], r["max_new_tokens"]) for r in spec["requests"]]
    kw = dict(spec["engine"])
    want = spec["streams"]
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=spec["paged"]["page_size"])
        want = spec["paged"]["streams"]

    def serve(rs):
        eng = ServingEngine(model, cfg, EngineConfig(**kw))
        hs = [eng.submit(p, SamplingParams(max_new_tokens=n)) for p, n in rs]
        eng.run()
        return [list(h.output) for h in hs]

    assert serve(reqs) == want
    if layout == "ring":
        solo = spec["solo"]
        assert serve([reqs[solo["index"]]]) == [solo["tokens"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_serve_the_recurrent_archs(arch, tmp_path, capsys):
    """``launch.serve --arch`` on the CPU (paged: the prefix cache printed
    off), and ``launch.quantize`` then ``launch.serve --artifact``."""
    from repro_torch.launch import quantize, serve

    extra = ["--kv-layout", "paged", "--page-size", "8"] \
        if arch == "rwkv6-3b" else []
    serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                "--max-new", "3", "--t-max", "2", *extra])
    out = capsys.readouterr().out
    assert "[serve] 2 requests" in out
    if extra:
        assert "prefix cache off (a recurrent mixer" in out
    art = quantize.main(["--arch", arch, "--device", "cpu", "--out",
                         str(tmp_path / "a"), "--t-max", "2"])
    serve.main(["--artifact", str(art), "--device", "cpu", "--requests", "2",
                "--max-new", "3"])
    assert "[serve] 2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_builds_a_servable_model(arch):
    """``init_params`` (the reference's initializer on the port) gives
    finite logits and the reference's fixed leaves (``lam`` and the decay
    base within 1e-6: XLA rounds its linspace otherwise than
    ``torch.linspace``; norm scales 1, biases and mixes 0 exactly)."""
    cfg = configs.get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    logits = forward(model, cfg, torch.tensor([[1, 2, 3, 4]]))
    assert torch.isfinite(logits).all()
    _, params, _, _ = _ref(arch)
    block = model.layers[0]
    node = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"]["b0"])
    if arch == "rwkv6-3b":
        pairs = [(block.time.decay_base, node["time"]["decay_base"]),
                 (block.time.mu, node["time"]["mu"]),
                 (block.time.ln_x.scale, node["time"]["ln_x"]["scale"])]
    else:
        pairs = [(block.rec.lam, node["rec"]["lam"]),
                 (block.rec.conv.b, node["rec"]["conv"]["b"])]
    for mine, theirs in pairs:
        np.testing.assert_allclose(_np(mine), theirs, rtol=1e-6, atol=0)
