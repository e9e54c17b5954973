"""Every name in BENCHMARK.json finds its files, and the file keeps the
benchmark's own rules."""

import json
import re

import bench_smoke
import pytest

from harness import check, program, spec

with open(bench_smoke.ROOT / "BENCHMARK.json") as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_files_are_found_by_name(cell, trace):
    c = spec.load_cell(cell, trace)
    assert c.chips == 1
    assert c.metrics, "every run reports metrics"
    assert spec.loop(c.traffic["loop"]) is not None
    assert c.limits["compare"]
    assert all(n in check.NUMBERS and isinstance(v, float)
               for n, v in c.limits["compare"].items())
    for m in c.metrics:
        assert callable(spec.reader(m["name"]))
    ref = spec.reference(c.config)
    names = [n for n, _, _ in ref.param_spec(c.config["config"])]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_files_state_what_runs(entry):
    config = spec.read_json(bench_smoke.ROOT / entry["file"])
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    program.model_config(config)    # the program as the file states it


def test_names_units_and_keys():
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
        assert (bench_smoke.BENCH / "traffic" / f"{w['traffic']}.json"
                ).is_file()
