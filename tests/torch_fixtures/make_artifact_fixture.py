"""Write the cross-package fixture: an artifact written by the JAX package
and the JAX engine's greedy streams for a fixed fleet.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_fixtures/make_artifact_fixture.py

Writes, next to this script:

  * ``qwen2_smoke_artifact/``: ``repro.artifacts.write_artifact`` of the
    smoke qwen2-1.5b (2 layers, d 64, vocab 512, f32) initialised from
    ``PRNGKey(0)`` and PTQTP-quantized (G = 64, t_max = 5);
  * ``qwen2_smoke_streams.json``: the engine settings, the four requests
    (prompts from numpy seeds, greedy budgets) and the tokens the JAX
    engine serves from that artifact on the ring layout: for the fleet,
    and for the request whose prompt (33 tokens, prefill chunk 16) ends in
    a one-token prefill bucket when it is served alone, alone.

The port reads both (``tests/test_torch_artifacts.py`` on the CPU,
``chip_smoke.py`` on the card) and must serve the same tokens.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import numpy as np

from repro import configs
from repro.artifacts import load_artifact, write_artifact
from repro.core.ptqtp import PTQTPConfig
from repro.models import init_params
from repro.serving import EngineConfig, SamplingParams, ServingEngine

HERE = Path(__file__).resolve().parent
ARTIFACT = HERE / "qwen2_smoke_artifact"
STREAMS = HERE / "qwen2_smoke_streams.json"

ENGINE = dict(max_slots=3, capacity=64, prefill_chunk=16, decode_chunk=4)
LENGTHS = (33, 5, 23, 40)
BUDGETS = (8, 6, 9, 12)
SOLO = 0  # 33 tokens = 16 + 16 + 1: its last chunk is bucket 1 alone


def prompts():
    return [np.random.default_rng(100 + i).integers(0, 512, n).tolist()
            for i, n in enumerate(LENGTHS)]


def serve(params, cfg, reqs):
    eng = ServingEngine(params, cfg, EngineConfig(**ENGINE))
    handles = [eng.submit(p, SamplingParams(max_new_tokens=n))
               for p, n in reqs]
    eng.run()
    return [list(h.output) for h in handles]


def main():
    cfg = configs.get_smoke_config("qwen2-1.5b")
    if ARTIFACT.exists():
        shutil.rmtree(ARTIFACT)
    write_artifact(ARTIFACT, arch="qwen2-1.5b", model_cfg=cfg,
                   ptqtp_cfg=PTQTPConfig(group_size=64, t_max=5),
                   params=init_params(cfg, jax.random.PRNGKey(0)))
    params, _ = load_artifact(ARTIFACT, verify="full")
    reqs = list(zip(prompts(), BUDGETS))
    STREAMS.write_text(json.dumps({
        "engine": ENGINE,
        "requests": [{"prompt": p, "max_new_tokens": n} for p, n in reqs],
        "streams": serve(params, cfg, reqs),
        "solo": {"index": SOLO, "tokens": serve(params, cfg,
                                                [reqs[SOLO]])[0]},
    }) + "\n")
    print(f"wrote {ARTIFACT} and {STREAMS}")


if __name__ == "__main__":
    main()
