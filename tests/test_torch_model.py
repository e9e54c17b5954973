"""The port's decoder against the reference, step by step, same params.

The reference's smoke qwen2-1.5b (f32) is initialised and PTQTP-quantized
by the reference; the port loads the same bytes (``from_jax_params``). Both
then run the same sequence of ``prefill_chunk`` / ``decode_step`` calls on
the same token ids, including rows that ride along with length 0 or
``active=False`` and enough tokens to wrap the ring. After every call the
logits and every ring-cache leaf are compared.

The same sequence runs on the paged layout, with one shuffled page table
in both packages, and the physical pools are compared leaf by leaf.

Tolerances (f32, sums in another order): logits and float KV rtol = atol =
1e-4; positions exactly; int8 KV codes exactly, their scales to rtol 1e-4.
The port's ``_q8`` multiplies by f32(1/127) as XLA does for the jitted
reference's division, so on equal inputs codes and scales are bit-equal
(``test_q8_equals_jitted_reference``); inside the model the k/v inputs
still differ by float ulps (scales by up to ~8e-7 relative on this input),
so a value at a code's rounding boundary could round apart on another
input — on this one no code does.
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
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_decode_state as jinit_decode_state
from repro.models import init_params as jinit_params
from repro.models import prefill_chunk as jprefill_chunk
from repro.models.attention import _q8 as jq8
from repro.models.attention import paged_cache_init as jpaged_cache_init
from repro.models.common import use_matmul_backend
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill_chunk)
from repro_torch.models.attention import _q8, paged_cache_init

# The suite runs one xdist worker per core: keep torch to one intra-op
# thread so it does not oversubscribe the CPU that the other workers share.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
B, CAP = 3, 16


@pytest.fixture(scope="module")
def quantized():
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    qp, _ = jquantize_tree(params, JPTQTPConfig(group_size=64, t_max=5))
    return qp


# (kind, tokens (B, L) or (B,), lengths or active)
STEPS = [("prefill", [[5, 9, 17, 2, 33, 8, 1, 90],
                      [7, 7, 300, 2, 4, 0, 0, 0],
                      [0] * 8], [8, 5, 0]),
         ("prefill", [[11, 12, 13, 14, 15, 16, 17, 18],
                      [0] * 8,
                      [3, 4, 5, 0, 0, 0, 0, 0]], [8, 0, 3]),
         ("decode", [42, 43, 44], [True, True, False]),
         ("decode", [1, 2, 3], [True, True, True]),
         ("prefill", [[100, 101, 102, 103], [0] * 4, [5, 6, 7, 8]],
          [4, 0, 4])]


def _cache_pairs(jstate, state):
    blocks = jstate["blocks"]["b0"]
    for i, layer in enumerate(state["layers"]):
        for name, leaf in layer.items():
            yield f"layer{i}/{name}", np.asarray(blocks[name][i]), leaf.numpy()


@pytest.mark.parametrize("kv_dtype,backend", [("bfloat16", "default"),
                                              ("int8", "default"),
                                              ("bfloat16", "pallas")])
def test_prefill_and_decode_steps_match_reference(quantized, kv_dtype,
                                                  backend):
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").scaled(
        kv_cache_dtype=kv_dtype,
        attn_backend="pallas" if backend == "pallas" else "auto")
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-1.5b"),
                              kv_cache_dtype=kv_dtype)
    model = from_jax_params(jax.tree.map(np.asarray, quantized), cfg,
                            device="cpu")
    jstate = jinit_decode_state(jcfg, B, CAP)
    state = init_decode_state(cfg, B, CAP, device="cpu")
    mm = "pallas" if backend == "pallas" else "auto"
    for step, (kind, toks, arg) in enumerate(STEPS):
        tok = np.asarray(toks, np.int32)
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            with use_matmul_backend(mm):
                jl, jstate = jprefill_chunk(quantized, jcfg, jstate,
                                            {"tokens": jnp.asarray(tok)},
                                            jnp.asarray(lens))
            logits, state = prefill_chunk(model, cfg, state,
                                          torch.from_numpy(tok),
                                          torch.from_numpy(lens))
            rows = lens > 0  # length-0 rows' logits are unconsumed garbage
        else:
            act = np.asarray(arg)
            with use_matmul_backend(mm):
                jl, jstate = jdecode_step(quantized, jcfg, jstate,
                                          jnp.asarray(tok), jnp.asarray(act))
            logits, state = decode_step(model, cfg, state,
                                        torch.from_numpy(tok),
                                        torch.from_numpy(act))
            rows = act
        np.testing.assert_allclose(logits.numpy()[rows], np.asarray(jl)[rows],
                                   **TOL, err_msg=f"step {step} logits")
        np.testing.assert_array_equal(state["pos"].numpy(),
                                      np.asarray(jstate["pos"]))
        for name, want, got in _cache_pairs(jstate, state):
            msg = f"step {step} {name}"
            if name.endswith("/pos"):
                np.testing.assert_array_equal(got, want, err_msg=msg)
            elif got.dtype == np.int8:
                np.testing.assert_array_equal(got, want, err_msg=msg)
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=msg)


PAGE, MAX_PAGES = 4, 14


def _paged_pairs(jstate, state):
    blocks = jstate["blocks"]["b0"]
    for name, leaf in state["pool"].items():
        for i in range(leaf.shape[0]):
            # the port's pool has one scratch page past the reference's
            yield (f"layer{i}/{name}", np.asarray(blocks[name][i]),
                   leaf[i, :-1].numpy())


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_steps_match_reference(quantized, kv_dtype):
    """The paged layout under one shuffled table (row 2 keeps a logical
    page on the null page): logits and every pool leaf as the reference's,
    and the fully mapped rows' logits bit-equal to the port's own ring
    layout."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").scaled(
        kv_cache_dtype=kv_dtype)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-1.5b"),
                              kv_cache_dtype=kv_dtype)
    model = from_jax_params(jax.tree.map(np.asarray, quantized), cfg,
                            device="cpu")
    spec = {"page_size": PAGE, "max_pages": MAX_PAGES}
    table = (1 + np.random.default_rng(5).permutation(MAX_PAGES))[
        :B * CAP // PAGE].reshape(B, CAP // PAGE).astype(np.int32)
    table[2, 3] = 0  # unmapped: reads as empty, writes are dropped
    jstate = jinit_decode_state(jcfg, B, CAP, kv_spec=spec)
    blk = dict(jstate["blocks"]["b0"])
    blk["table"] = jnp.broadcast_to(jnp.asarray(table)[None],
                                    blk["table"].shape)
    jstate = dict(jstate, blocks={"b0": blk})
    state = init_decode_state(cfg, B, CAP, device="cpu", kv_spec=spec)
    state["table"].copy_(torch.from_numpy(table))
    ring = init_decode_state(cfg, B, CAP, device="cpu")
    for step, (kind, toks, arg) in enumerate(STEPS):
        tok = np.asarray(toks, np.int32)
        if kind == "prefill":
            lens = np.asarray(arg, np.int32)
            jl, jstate = jprefill_chunk(quantized, jcfg, jstate,
                                        {"tokens": jnp.asarray(tok)},
                                        jnp.asarray(lens))
            targs = (torch.from_numpy(tok), torch.from_numpy(lens))
            logits, state = prefill_chunk(model, cfg, state, *targs)
            ring_logits, ring = prefill_chunk(model, cfg, ring, *targs)
            rows = lens > 0
        else:
            act = np.asarray(arg)
            jl, jstate = jdecode_step(quantized, jcfg, jstate,
                                      jnp.asarray(tok), jnp.asarray(act))
            targs = (torch.from_numpy(tok), torch.from_numpy(act))
            logits, state = decode_step(model, cfg, state, *targs)
            ring_logits, ring = decode_step(model, cfg, ring, *targs)
            rows = act
        np.testing.assert_allclose(logits.numpy()[rows], np.asarray(jl)[rows],
                                   **TOL, err_msg=f"step {step} logits")
        # rows 0 and 1 have every page mapped: the ring is the same cache
        assert torch.equal(logits[:2], ring_logits[:2])
        for name, want, got in _paged_pairs(jstate, state):
            msg = f"step {step} {name}"
            if got.dtype in (np.int8, np.int32):
                np.testing.assert_array_equal(got, want, err_msg=msg)
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=msg)
    assert (state["pool"]["pages_pos"][:, 0] == -1).all()  # null page


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_paged_cache_layout_matches_reference(kv_dtype):
    """One layer's paged cache has the reference's leaves, dtypes and
    initial values; its pool holds one scratch page more. Sliding-window
    layers narrower than the capacity are refused, as there."""
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").scaled(
        kv_cache_dtype=kv_dtype)
    cfg = configs.get_smoke_config("qwen2-1.5b").scaled(
        kv_cache_dtype=kv_dtype)
    want = jpaged_cache_init(jcfg, B, CAP, None, jnp.float32,
                             page_size=PAGE, max_pages=MAX_PAGES)
    got = paged_cache_init(cfg, B, CAP, None, torch.float32, "cpu",
                           page_size=PAGE, max_pages=MAX_PAGES)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        ref = np.asarray(want[name])
        trim = leaf if name == "table" else leaf[:-1]
        assert str(leaf.dtype).split(".")[-1] == str(ref.dtype)
        np.testing.assert_array_equal(trim.numpy(), ref, err_msg=name)
    with pytest.raises(ValueError, match="full-capacity"):
        paged_cache_init(cfg, B, CAP, CAP // 2, torch.float32, "cpu",
                         page_size=PAGE, max_pages=MAX_PAGES)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_q8_equals_jitted_reference(dtype):
    """The engine runs the reference's ``_q8`` under ``jax.jit`` (scale =
    max|x| · f32(1/127)); the port's codes and scales equal it bit for
    bit."""
    x = np.random.default_rng(0).standard_normal((64, 64, 2, 128)).astype(
        np.float32) * 3
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16"
                               else jnp.float32)
    want_q, want_s = jax.jit(jq8)(jx)
    tx = torch.from_numpy(x)
    got_q, got_s = _q8(tx.to(torch.bfloat16) if dtype == "bfloat16" else tx)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_forward_matches_reference(quantized):
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    cfg = configs.get_smoke_config("qwen2-1.5b")
    model = from_jax_params(jax.tree.map(np.asarray, quantized), cfg,
                            device="cpu")
    tokens = np.random.default_rng(0).integers(0, 512, (2, 12)).astype(
        np.int32)
    want = np.asarray(jforward(quantized, jcfg,
                               {"tokens": jnp.asarray(tokens)}))
    got = forward(model, cfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unported_block_kinds_raise():
    cfg = configs.get_smoke_config("qwen2-1.5b").scaled(
        block_pattern=("mamba+mlp",))  # a kind no architecture defines
    with pytest.raises(NotImplementedError, match="mamba"):
        init_params(cfg, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = configs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(cfg, 1, 8)
