"""The port's decoder against the reference, step by step, same params.

The reference's smoke qwen2-1.5b (f32) is initialised and PTQTP-quantized
by the reference; the port loads the same bytes (``from_jax_params``). Both
then run the same sequence of ``prefill_chunk`` / ``decode_step`` calls on
the same token ids, including rows that ride along with length 0 or
``active=False`` and enough tokens to wrap the ring. After every call the
logits and every ring-cache leaf are compared.

Tolerances (f32, sums in another order): logits and float KV rtol = atol =
1e-4; ring positions exactly; int8 KV codes within 1 of each other on at
most 0.1 % of entries (a value at a rounding boundary may round either
way), their scales to rtol 1e-4.
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
from repro.models.common import use_matmul_backend
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill_chunk)

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
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, msg
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=msg)


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
        block_pattern=("rwkv",))
    with pytest.raises(NotImplementedError, match="rwkv"):
        init_params(cfg, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = configs.get_smoke_config("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(cfg, 1, 8)
