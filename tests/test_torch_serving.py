"""The port's serving engine and sampling against the reference's.

The reference's smoke qwen2-1.5b (f32, G = 64) is initialised and
PTQTP-quantized by the reference; the port serves the same bytes
(``from_jax_params``). Token streams are integers and must be equal to the
reference engine's, token for token: greedy for the float and the int8
ring and for the paged layout (with the allocator's hits, misses and forks
equal too), and at temperature 0.8 with top-k/top-p, since the port's draw
is ``jax.random``'s threefry stream (random bits and uniforms bit for bit;
``log`` may differ by an ulp, which moves no token on these inputs). Inside
the port a request's stream must not depend on the fleet it shares, on
prefill/decode chunk sizes (the reference's determinism contract) or on
the KV layout.
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
from repro.serving import SamplingParams as JSamplingParams
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


def test_sampled_streams_equal_reference_engine(quantized):
    """Temperature 0.8, one request also top-k/top-p truncated, one greedy
    beside them: every stream equals the reference engine's."""
    model, cfg = _port(quantized)
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    kw = [dict(temperature=0.8, seed=7), dict(temperature=0.8, seed=2 ** 31,
                                              top_k=20, top_p=0.9),
          dict(), dict(temperature=0.8, seed=2 ** 32 - 1)]
    want = _serve(JServingEngine(quantized, jcfg, JEngineConfig(**ENGINE)),
                  PROMPTS, [JSamplingParams(max_new_tokens=n, **k)
                            for n, k in zip(BUDGETS, kw)])
    got = _serve(ServingEngine(model, cfg, EngineConfig(**ENGINE)), PROMPTS,
                 [SamplingParams(max_new_tokens=n, **k)
                  for n, k in zip(BUDGETS, kw)])
    assert got == want


# ------------------------------------------------------------ paged layout
# a 32-token shared prefix (a multiple of the page size and prefill_chunk)
# with distinct tails; the last request wraps its 64-token ring, so it must
# fork the cached prefix pages it overwrites; two slots, so later requests
# find the earlier ones' pages in the prefix cache
_PREFIX = np.random.default_rng(10).integers(0, 512, 32).tolist()
PAGED_PROMPTS = [_PREFIX + np.random.default_rng(20 + i).integers(
    0, 512, n).tolist() for i, n in enumerate((3, 9, 1, 20))]
PAGED_BUDGETS = (6, 5, 4, 20)
PAGED = dict(max_slots=2, capacity=64, prefill_chunk=16, decode_chunk=4,
             kv_layout="paged", page_size=8)


def test_paged_engine_equals_reference_and_ring(quantized):
    model, cfg = _port(quantized)
    jcfg = jconfigs.get_smoke_config("qwen2-1.5b")
    jeng = JServingEngine(quantized, jcfg, JEngineConfig(**PAGED))
    want = _serve(jeng, PAGED_PROMPTS, [JSamplingParams(max_new_tokens=n)
                                        for n in PAGED_BUDGETS])
    eng = ServingEngine(model, cfg, EngineConfig(**PAGED))
    params = [SamplingParams(max_new_tokens=n) for n in PAGED_BUDGETS]
    assert _serve(eng, PAGED_PROMPTS, params) == want
    counters = ("hits", "misses", "forks", "evictions", "peak_used")
    assert [getattr(eng.alloc, c) for c in counters] == \
        [getattr(jeng.alloc, c) for c in counters]
    assert eng.alloc.hits > 0 and eng.alloc.forks > 0
    ring = ServingEngine(model, cfg, EngineConfig(**dict(PAGED,
                                                         kv_layout="ring")))
    assert _serve(ring, PAGED_PROMPTS, params) == want
    # drained: every page the prefix cache does not hold is free again
    eng.alloc.check()
    assert eng.alloc.used_pages() == eng.alloc.cached_pages()


def test_paged_cancel_fifo_and_shed(quantized):
    """A cancelled request returns its pages at once; the queue head waits
    for pages and nothing jumps it; a request whose worst case exceeds the
    whole pool is shed at submit."""
    model, cfg = _port(quantized)
    # 7 pages of 8 tokens, below one slot's ring of 8 pages
    eng = ServingEngine(model, cfg, EngineConfig(**dict(
        PAGED, max_slots=3, max_pages=7, prefix_cache=False)))
    never = eng.submit(list(range(50)), SamplingParams(max_new_tokens=40))
    assert never.done and never.finish_reason == "rejected"
    assert eng.sheds == 1 and "page budget" in never.error
    big = eng.submit(PAGED_PROMPTS[0], SamplingParams(max_new_tokens=10))
    head = eng.submit(PAGED_PROMPTS[1], SamplingParams(max_new_tokens=3))
    small = eng.submit([5, 6], SamplingParams(max_new_tokens=2))
    eng.step()
    # big holds 6 pages of 7; head needs 6, so it waits, and small (1 page)
    # waits behind it (FIFO)
    assert eng.slots[0] is big and eng.slots[1] is None
    assert list(eng.queue) == [head, small]
    assert eng.alloc.used_pages() == 6
    assert big.cancel()
    assert eng.alloc.used_pages() == 0
    eng.alloc.check()
    solo = ServingEngine(model, cfg, EngineConfig(**PAGED)).submit(
        PAGED_PROMPTS[1], SamplingParams(max_new_tokens=3)).result().tokens
    assert head.result().tokens == solo
    assert small.result().finish_reason == "length"
    assert eng.alloc.used_pages() == 0
    eng.alloc.check()


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


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_threefry_bits_equal_jax(seed):
    """``random_bits`` of (seed, i) equals ``jax.random.bits(fold_in(
    PRNGKey(seed), i), (V,))`` and ``uniform`` its uniform, bit for bit."""
    v = 1000
    idx = [0, 1, 77, 2 ** 31 + 3]
    keys = sampling.request_keys(torch.full((4,), seed, dtype=torch.int64),
                                 torch.tensor(idx, dtype=torch.int64))
    bits = sampling.random_bits(keys, v).numpy()
    u = sampling.uniform(keys, v).numpy()
    tiny = jnp.finfo(jnp.float32).tiny
    for row, i in enumerate(idx):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)),
                                 np.uint32(i))
        want = np.asarray(jax.random.bits(key, (v,), jnp.uint32))
        np.testing.assert_array_equal(bits[row], want.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(key, (v,), jnp.float32,
                                               minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u[row].view(np.int32),
                                      want_u.view(np.int32))


def test_sampled_tokens_equal_reference():
    """Temperature > 0 rows, some with top-k/top-p, many indices: the
    port's tokens equal ``sample_tokens_per_request``'s."""
    b, v = 64, 301
    logits = _logits(4, b, v)
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2 ** 32, b).astype(np.uint32)
    idx = rng.integers(0, 1000, b).astype(np.int32)
    temps = rng.choice([0.0, 0.5, 1.0, 2.0], b).astype(np.float32)
    top_k = rng.choice([0, 1, 7, 50], b).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.3], b).astype(np.float32)
    want = np.asarray(jsampling.sample_tokens_per_request(
        jnp.asarray(logits), jsampling.request_keys(jnp.asarray(seeds),
                                                    jnp.asarray(idx)),
        jnp.asarray(temps), top_k=jnp.asarray(top_k),
        top_p=jnp.asarray(top_p)))
    got = sampling.sample_tokens_per_request(
        torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
        torch.from_numpy(idx), torch.from_numpy(temps),
        top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p))
    np.testing.assert_array_equal(got.numpy(), want)


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
    ``jax`` and no ``repro`` module; the artifact store, the clock, the
    fault harness, the concurrent frontend and both launchers among
    them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.serving.frontend, repro_torch.launch.serve\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "for m in ('serving.paging', 'kernels.ptqtp_search.ops', "
        "'kernels.decode_attention.ops', 'artifacts.format', "
        "'artifacts.reader', 'artifacts.writer', 'runtime.clock', "
        "'serving.faults', 'launch.quantize', 'launch.serve', "
        "'serving.frontend', 'serving.frontend.driver', "
        "'serving.frontend.fairness', 'serving.frontend.server', "
        "'serving.frontend.supervisor'):\n"
        "    assert 'repro_torch.' + m in sys.modules, m\n"
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
