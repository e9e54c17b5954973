"""The port's serving engine on the registry's attention-family archs
against the reference's engine, at smoke size: gemma3-27b (ring only: the
paged layout refuses its sliding window, in both packages), deepseek-moe-16b
and grok-1-314b (MoE), llama3-405b and qwen1.5-32b, on the ring and the
paged layouts.

Both engines serve the reference's PTQTP-quantized smoke model (G = 64,
t_max = 5; the port loads the same bytes). Token streams are integers and
must be equal token for token: greedy, and at temperature 0.8 with top-k
and top-p on some rows (the port's draw is ``jax.random``'s threefry
stream). Four requests on three slots, prompts of 5-40 tokens (past
gemma3's smoke window of 8, in prefill chunks of 16, longer than its local
rings), so one waits for a freed slot; the paged engine shares its pages
with the prefix cache on (prefix reuse is on for every attention-only
model, as in the reference). At deepseek's published capacity factor
(1.25; the smoke config's is -1, no drop) the streams depend on the
layout in the reference itself (capacity is per dispatch and idle rows
route too); the port's equal the reference's layout by layout.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.ptqtp import PTQTPConfig as JPTQTPConfig
from repro.core.quantize_model import quantize_tree as jquantize_tree
from repro.models import init_params as jinit_params
from repro.serving import SamplingParams as JSamplingParams
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.serving import EngineConfig, SamplingParams, ServingEngine

torch.set_num_threads(1)

PROMPTS = [np.random.default_rng(i).integers(0, 512, n).tolist()
           for i, n in enumerate((5, 23, 40, 9))]
BUDGETS = (6, 9, 12, 3)
ENGINE = dict(max_slots=3, capacity=48, prefill_chunk=16, decode_chunk=4)
CASES = [("gemma3-27b", "ring")] + [
    (arch, layout)
    for arch in ("deepseek-moe-16b", "grok-1-314b", "llama3-405b",
                 "qwen1.5-32b")
    for layout in ("ring", "paged")]


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    qtree, _ = jquantize_tree(jinit_params(jcfg, jax.random.PRNGKey(0)),
                              JPTQTPConfig(group_size=64, t_max=5))
    cfg = configs.get_smoke_config(arch)
    model = from_jax_params(jax.tree.map(np.asarray, qtree), cfg,
                            device="cpu")
    return jcfg, qtree, cfg, model


def _params(sp, sampled):
    if not sampled:
        return [sp(max_new_tokens=n) for n in BUDGETS]
    return [sp(max_new_tokens=n, temperature=0.8, seed=i,
               top_k=20 if i % 2 else 0, top_p=0.9 if i == 2 else 1.0)
            for i, n in enumerate(BUDGETS)]


def _serve(eng, params):
    hs = [eng.submit(p, sp) for p, sp in zip(PROMPTS, params)]
    eng.run()
    return [(list(h.output), h.finish_reason) for h in hs]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "t0.8"])
@pytest.mark.parametrize("arch,layout", CASES)
def test_streams_equal_the_reference_engine(arch, layout, sampled):
    jcfg, qtree, cfg, model = _models(arch)
    kw = dict(ENGINE)
    if layout == "paged":
        kw.update(kv_layout="paged", page_size=8)
    want = _serve(JServingEngine(qtree, jcfg, JEngineConfig(**kw)),
                  _params(JSamplingParams, sampled))
    eng = ServingEngine(model, cfg, EngineConfig(**kw))
    got = _serve(eng, _params(SamplingParams, sampled))
    assert got == want
    assert eng.tokens_generated == sum(BUDGETS)
    if layout == "paged":
        assert eng._prefix_reuse


@functools.lru_cache(maxsize=None)
def _capped():
    """deepseek-moe-16b's smoke model at the published capacity factor."""
    jcfg, qtree, cfg, model = _models("deepseek-moe-16b")
    jcfg = jcfg.scaled(moe=dataclasses.replace(jcfg.moe,
                                               capacity_factor=1.25))
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    return jcfg, qtree, cfg, model


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_capped_moe_streams_equal_the_reference_per_layout(layout):
    """At capacity factor 1.25 (cap 1 an expert at a 4-slot decode step)
    assignments drop, and a slot left idle routes its own row too: on the
    ring it reads its stale ring, on the paged layout null pages. So the
    reference's ring and paged streams differ here; the port's equal the
    reference's on each layout."""
    jcfg, qtree, cfg, model = _capped()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, int(n)).tolist()
               for n in rng.integers(5, 40, 4)]
    budgets = [int(b) for b in rng.integers(2, 24, 4)]
    kw = dict(max_slots=4, capacity=64, prefill_chunk=16, decode_chunk=4)

    def run(eng, sp):
        hs = [eng.submit(p, sp(max_new_tokens=n))
              for p, n in zip(prompts, budgets)]
        eng.run()
        return [list(h.output) for h in hs]

    want = {}
    for lay in ("ring", "paged"):
        extra = dict(kv_layout="paged", page_size=8) if lay == "paged" else {}
        want[lay] = run(JServingEngine(qtree, jcfg, JEngineConfig(
            **kw, **extra)), JSamplingParams)
    assert want["ring"] != want["paged"]
    extra = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    got = run(ServingEngine(model, cfg, EngineConfig(**kw, **extra)),
              SamplingParams)
    assert got == want[layout]
