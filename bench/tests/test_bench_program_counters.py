"""The readers of the program's own counters (the prefill rows computed,
each dispatch's device time, set-up's warmup and compiles): a number on a
smoke window of the program, and None where the program has no such
counter, as before it counted them."""

import bench_smoke
import pytest

from harness import cell, spec
from harness.window import Window

METRICS = ("prefill_row_use", "prefill_device_ms", "decode_device_ms",
           "warmup_s", "capture_s")


@pytest.fixture(scope="module")
def traced():
    return bench_smoke.run("qwen2-smoke", trace=True, seconds=1.0)


@pytest.mark.parametrize("name", METRICS)
def test_reads_a_number_from_the_program(traced, name):
    got = traced["metrics"][name]["value"]
    assert got > 0
    if name == "prefill_row_use":
        assert got <= 100.0
    if name == "warmup_s":
        assert got >= traced["metrics"]["capture_s"]["value"]


def _without_the_counters() -> cell.Context:
    """A window whose program counted none of the new counters."""
    old = {"serving_engine_steps_total": 10.0,
           "serving_decode_steps_total": 40.0,
           "serving_prefill_dispatches_total": 5.0,
           "serving_prefill_tokens_total": 300.0}
    w = Window(0.0, 1.0, [], [], 0, dict.fromkeys(old, 0.0), old)
    return cell.Context(1.0, w, None, None, None, None, None, 1, 128)


@pytest.mark.parametrize("name", METRICS)
def test_none_without_the_counters(name):
    assert spec.reader(name)(_without_the_counters()) is None
