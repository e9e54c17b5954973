"""Write the cross-package fixtures: artifacts written by the JAX package and
the JAX engine's greedy streams for a fixed fleet.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_artifact_fixture.py [ARCH ...]

For each smoke architecture (all by default: qwen2-1.5b, gemma3-27b,
deepseek-moe-16b, recurrentgemma-2b, rwkv6-3b) it writes, next to this
script:

  * ``<name>_smoke_artifact/``: ``repro.artifacts.write_artifact`` of the
    smoke config (f32) initialised from ``PRNGKey(0)`` and PTQTP-quantized
    (G = 64, t_max = 5; a ``d_in`` of 32, deepseek's expert and shared
    ``wo``, stays dense at G = 64, as in the reference);
  * ``<name>_smoke_streams.json``: the engine settings, the four requests
    (prompts from numpy seeds, greedy budgets) and the tokens the JAX
    engine serves from that artifact on the ring layout: for the fleet,
    and for the request whose prompt (33 tokens, prefill chunk 16) ends in
    a one-token prefill bucket when it is served alone, alone; for
    deepseek and rwkv6 also the fleet's tokens on the paged layout (page
    size 8).

gemma3's and recurrentgemma's smoke window is 8, so their prefill chunks
of 16 are longer than their local rings, every prompt but one runs past
the window, and the paged layout refuses them at capacity 64.

The port reads them (``tests/test_torch_artifacts.py`` and
``tests/test_torch_archs.py`` on the CPU, ``chip_smoke.py`` on the card)
and must serve the same tokens.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import jax
import numpy as np

from repro import configs
from repro.artifacts import load_artifact, write_artifact
from repro.core.ptqtp import PTQTPConfig
from repro.models import init_params
from repro.serving import EngineConfig, SamplingParams, ServingEngine

HERE = Path(__file__).resolve().parent

#: arch -> file name stem of its artifact and streams
NAMES = {"qwen2-1.5b": "qwen2", "gemma3-27b": "gemma3",
         "deepseek-moe-16b": "deepseek", "recurrentgemma-2b": "recurrentgemma",
         "rwkv6-3b": "rwkv6"}
# archs whose paged streams are written too (the qwen2 fixture's test
# holds both layouts to its ring streams; gemma3 and recurrentgemma refuse
# paging)
PAGED_STREAMS = ("deepseek-moe-16b", "rwkv6-3b")

ENGINE = dict(max_slots=3, capacity=64, prefill_chunk=16, decode_chunk=4)
LENGTHS = (33, 5, 23, 40)
BUDGETS = (8, 6, 9, 12)
SOLO = 0  # 33 tokens = 16 + 16 + 1: its last chunk is bucket 1 alone
PAGE_SIZE = 8


def prompts():
    return [np.random.default_rng(100 + i).integers(0, 512, n).tolist()
            for i, n in enumerate(LENGTHS)]


def serve(params, cfg, reqs, **kw):
    eng = ServingEngine(params, cfg, EngineConfig(**ENGINE, **kw))
    handles = [eng.submit(p, SamplingParams(max_new_tokens=n))
               for p, n in reqs]
    eng.run()
    return [list(h.output) for h in handles]


def write(arch):
    cfg = configs.get_smoke_config(arch)
    artifact = HERE / f"{NAMES[arch]}_smoke_artifact"
    streams = HERE / f"{NAMES[arch]}_smoke_streams.json"
    if artifact.exists():
        shutil.rmtree(artifact)
    write_artifact(artifact, arch=arch, model_cfg=cfg,
                   ptqtp_cfg=PTQTPConfig(group_size=64, t_max=5),
                   params=init_params(cfg, jax.random.PRNGKey(0)))
    params, _ = load_artifact(artifact, verify="full")
    reqs = list(zip(prompts(), BUDGETS))
    spec = {
        "engine": ENGINE,
        "requests": [{"prompt": p, "max_new_tokens": n} for p, n in reqs],
        "streams": serve(params, cfg, reqs),
        "solo": {"index": SOLO, "tokens": serve(params, cfg,
                                                [reqs[SOLO]])[0]},
    }
    if arch in PAGED_STREAMS:
        spec["paged"] = {"page_size": PAGE_SIZE,
                         "streams": serve(params, cfg, reqs,
                                          kv_layout="paged",
                                          page_size=PAGE_SIZE)}
    streams.write_text(json.dumps(spec) + "\n")
    print(f"wrote {artifact} and {streams}")


def main(argv):
    for arch in argv or list(NAMES):
        write(arch)


if __name__ == "__main__":
    main(sys.argv[1:])
