"""Shared by the benchmark's CPU tests: the harness's paths and a run of a
cell at smoke size on the CPU (the harness's look for a card skipped)."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2 ** 31 + 11   # wider than 32 signed bits, as run seeds may be


def load(name: str):
    with open(DATA / f"{name}.json") as f:
        return json.load(f)


def cell(config: str, trace: bool = False, limit: float = 1e-3):
    """A smoke cell of ``config`` (a file of tests/data) under the smoke
    chat mix, reporting the benchmark's metrics."""
    from harness import check, spec
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    return spec.Cell("smoke", 1, load(config), load("smoke-chat"),
                     {"compare": {n: limit for n in check.NUMBERS}},
                     bench["per_layer" if trace else "end_to_end"])


def run(config: str, trace: bool = False, seconds: float = 3.0,
        control: bool = False, seed: int = SEED):
    """One run on the CPU, on one thread (the smoke model's small products
    gain nothing from more, and test workers share the cores)."""
    import torch

    from harness import cell as cell_mod
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cell_mod.run(cell(config, trace), seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            control=control, log=lambda *a: None,
                            profile_s=0.2)
    finally:
        torch.set_num_threads(threads)
