"""The port's serving engine and sampling against the reference's.

The reference's smoke qwen2-1.5b (f32, G = 64) is initialised and
PTQTP-quantized by the reference; the port serves the same bytes
(``from_jax_params``). Greedy token streams are integers and must be equal
to the reference engine's, token for token, for the float and the int8
ring. Inside the port a request's stream must not depend on the fleet it
shares or on prefill/decode chunk sizes (the reference's determinism
contract). Sampling at temperature > 0 draws from a counter-based hash, not
from ``jax.random``, so there only the contract and the distribution are
checked: greedy rows and the top-k/top-p support mask equal the
reference's exactly.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.serving import sampling as jsampling
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.serving import (EngineConfig, SamplingParams, ServingEngine,
                                 sampling)

# The suite runs one xdist worker per core: keep torch to one intra-op
# thread so it does not oversubscribe the CPU that the other workers share.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

# prompt lengths span one and several prefill chunks; with capacity 48 the
# 40-token prompt plus its budget wraps the ring; four requests on three
# slots, so one waits and is admitted into a freed slot
PROMPTS = [np.random.default_rng(i).integers(0, 512, n).tolist()
           for i, n in enumerate((5, 23, 40, 9))]
BUDGETS = (6, 9, 12, 3)
ENGINE = dict(max_slots=3, capacity=48, prefill_chunk=16, decode_chunk=4)


@pytest.fixture(scope="module")
def quantized():
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    params = jinit_params(jcfg, jax.random.PRNGKey(0))
    qp, _ = jquantize_tree(params, JPTQTPConfig(group_size=64, t_max=5))
    return qp


def _port(quantized, kv_dtype="bfloat16"):
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-1.5b"),
                              kv_cache_dtype=kv_dtype)
    return from_jax_params(jax.tree.map(np.asarray, quantized), cfg,
                           device="cpu"), cfg


def _serve(engine, prompts, params):
    handles = [engine.submit(p, sp) for p, sp in zip(prompts, params)]
    engine.run()
    return [(h.output, h.finish_reason) for h in handles]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_greedy_streams_equal_reference_engine(quantized, kv_dtype):
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b").scaled(
        kv_cache_dtype=kv_dtype)
    model, cfg = _port(quantized, kv_dtype)
    params = [SamplingParams(max_new_tokens=n) for n in BUDGETS]
    from repro.serving import SamplingParams as JSamplingParams

    jparams = [JSamplingParams(max_new_tokens=n) for n in BUDGETS]
    want = _serve(JServingEngine(quantized, jcfg, JEngineConfig(**ENGINE)),
                  PROMPTS, jparams)
    eng = ServingEngine(model, cfg, EngineConfig(**ENGINE))
    got = _serve(eng, PROMPTS, params)
    assert got == want
    assert eng.tokens_generated == sum(BUDGETS)


def test_output_invariant_to_fleet_and_chunks(quantized):
    """A request gives the same tokens alone, co-batched with hot and greedy
    traffic, and under other prefill/decode chunk boundaries, at
    temperature 0 and > 0."""
    model, cfg = _port(quantized)
    prompt = PROMPTS[2]
    for sp in (SamplingParams(max_new_tokens=7, temperature=0.9, seed=41),
               SamplingParams(max_new_tokens=7)):
        solo = ServingEngine(model, cfg, EngineConfig(max_slots=1,
                                                      capacity=64))
        ref = solo.submit(prompt, sp).result().tokens
        assert len(ref) == sp.max_new_tokens

        fleet = ServingEngine(model, cfg, EngineConfig(max_slots=3,
                                                       capacity=64))
        h = fleet.submit(prompt, sp)
        fleet.submit(PROMPTS[0], SamplingParams(max_new_tokens=9,
                                                temperature=3.0, seed=9))
        fleet.submit(PROMPTS[1], SamplingParams(max_new_tokens=3, top_k=5,
                                                temperature=1.0))
        assert h.result().tokens == ref

        chunks = ServingEngine(model, cfg, EngineConfig(
            max_slots=2, capacity=64, decode_chunk=1, prefill_chunk=3))
        h = chunks.submit(prompt, sp)
        chunks.submit([7], SamplingParams(max_new_tokens=8, temperature=0.5,
                                          seed=3))
        assert h.result().tokens == ref


def test_stop_ids_and_cancel(quantized):
    model, cfg = _port(quantized)
    eng = ServingEngine(model, cfg, EngineConfig(**ENGINE))
    first = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=5)) \
        .result().tokens
    h = eng.submit(PROMPTS[0], SamplingParams(max_new_tokens=5,
                                              stop={first[2]}))
    victim = eng.submit(PROMPTS[1], SamplingParams(max_new_tokens=50))
    eng.step()
    assert victim.cancel() and victim.cancelled
    assert h.result().finish_reason == "stop"
    assert h.result().tokens == first[:first.index(first[2]) + 1]


def test_unported_options_raise(quantized):
    for field, value in (("kv_layout", "paged"), ("max_queue", 4),
                         ("preunpack_decode", True)):
        with pytest.raises(NotImplementedError, match=field):
            EngineConfig(**{field: value})
    model, cfg = _port(quantized)
    eng = ServingEngine(model, cfg, EngineConfig(**ENGINE))
    with pytest.raises(NotImplementedError, match="deadline"):
        eng.submit([1, 2], SamplingParams(deadline_s=1.0))


# ----------------------------------------------------------------- sampling
def _logits(seed, b, v):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32)


def test_top_k_top_p_mask_equals_reference():
    logits = _logits(0, 6, 97)
    top_k = np.asarray([0, 1, 5, 0, 40, 3], np.int32)
    top_p = np.asarray([1.0, 0.5, 1.0, 0.3, 0.9, 0.05], np.float32)
    for k, p in ((top_k, None), (None, top_p), (top_k, top_p)):
        want = jsampling.top_k_top_p_mask(
            jnp.asarray(logits), None if k is None else jnp.asarray(k),
            None if p is None else jnp.asarray(p))
        got = sampling.top_k_top_p_mask(
            torch.from_numpy(logits),
            None if k is None else torch.from_numpy(k),
            None if p is None else torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_rows_equal_reference_and_ignore_the_mask():
    logits = _logits(1, 4, 23)
    logits[3, [2, 7]] = logits[3].max() + 1.0  # a tie: first index wins
    temps = np.asarray([0.0, 1.0, 0.0, 0.0], np.float32)
    top_k = np.asarray([0, 3, 2, 0], np.int32)
    top_p = np.asarray([1.0, 0.5, 0.4, 1.0], np.float32)
    keys = jsampling.request_keys(jnp.zeros((4,), jnp.uint32),
                                  jnp.zeros((4,), jnp.int32))
    want = np.asarray(jsampling.sample_tokens_per_request(
        jnp.asarray(logits), keys, jnp.asarray(temps),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p)))
    got = sampling.sample_tokens_per_request(
        torch.from_numpy(logits), torch.zeros(4, dtype=torch.int64),
        torch.zeros(4, dtype=torch.int32), torch.from_numpy(temps),
        top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p)).numpy()
    greedy = temps == 0.0
    np.testing.assert_array_equal(got[greedy], want[greedy])
    np.testing.assert_array_equal(got[greedy], logits.argmax(-1)[greedy])
    assert got[3] == 2


def test_draws_are_position_addressed_and_follow_softmax():
    """Token i of a request depends only on (seed, i, logits): the same
    pair drawn in another row or batch gives the same token. Over many
    indices the draws follow softmax(logits / T) (tolerance 0.02 on each
    frequency, ~4 standard deviations at 8192 draws)."""
    v, n = 5, 8192
    row = torch.tensor([0.5, -1.0, 2.0, 0.0, 1.0])
    seeds = torch.full((n,), 1234, dtype=torch.int64)
    idx = torch.arange(n, dtype=torch.int32)
    temps = torch.full((n,), 0.7)
    toks = sampling.sample_tokens_per_request(row.expand(n, v), seeds, idx,
                                              temps)
    freq = torch.bincount(toks.long(), minlength=v).double() / n
    want = torch.softmax(row.double() / 0.7, -1)
    assert float((freq - want).abs().max()) < 0.02
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))[:64]
    again = sampling.sample_tokens_per_request(
        row.expand(64, v), seeds[perm], idx[perm], temps[perm])
    assert torch.equal(again, toks[perm])


# ---------------------------------------------------------------- isolation
def test_port_imports_neither_jax_nor_the_reference():
    """Importing every module of the port (and chip_smoke.py) loads no
    ``jax`` and no ``repro`` module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_serve_launcher_on_cpu(capsys):
    from repro_torch.launch import serve

    results = serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                          "3", "--t-max", "2"])
    assert [len(r.tokens) for r in results] == [3, 3]
    assert "2 requests, 6 tokens" in capsys.readouterr().out
