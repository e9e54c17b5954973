"""What one run of one cell needs, found by the names in ``BENCHMARK.json``.

  * the cell: ``workloads[name]``, with its configuration and traffic;
  * the configuration: the file that ``configs[config].file`` names;
  * the traffic mix: ``bench/traffic/<traffic>.json``;
  * the limits that decide ``correct``: ``bench/limits/<cell>.json``;
  * the metrics the cell reports: the ``end_to_end`` entries (``--trace
    0``) or the ``per_layer`` entries (``--trace 1``) that list the cell
    under ``workloads``, or that have no such list; each is read by
    ``bench/metrics/<metric name>.py``;
  * the loop that drives the traffic: ``bench/loops/<loop>.py``;
  * the plain reference: ``bench/reference/<reference>.py``.

A later cell, configuration, mix or metric is a new file and a new entry;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]      # the configuration file
    traffic: Dict[str, Any]     # the traffic file
    limits: Dict[str, Any]      # the limits file
    metrics: List[Dict[str, Any]]  # the metric entries this run reports


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _applies(entry: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, trace: bool, root: Path = ROOT) -> Cell:
    """The cell called ``name`` of ``root/BENCHMARK.json``."""
    bench = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    here = root / "bench"
    traffic = read_json(here / "traffic" / f"{w['traffic']}.json")
    limits = read_json(here / "limits" / f"{name}.json")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, limits, metrics)


def reference(config: Dict[str, Any]):
    """The plain reference module of a configuration."""
    return importlib.import_module(f"reference.{config['reference']}")


def reader(metric: str, root: Path = ROOT):
    """The reader of a metric: ``read(ctx)`` -> a number, or None where it
    finds nothing to read."""
    return load_module(root / "bench" / "metrics" / f"{metric}.py",
                       f"bench_metric_{metric.replace('.', '_')}").read


def loop(kind: str, root: Path = ROOT):
    """The driver of a traffic loop kind: ``drive(...)``."""
    return load_module(root / "bench" / "loops" / f"{kind}.py",
                       f"bench_loop_{kind}").drive
