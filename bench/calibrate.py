"""Readings for the limits of a cell's check, on the card: the program's
numbers on many seeds, and on some of them the control's (the reference in
the precision below the configuration's) and the two faults of the draw
(``check.SIDES``), in one process.

    python3 bench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        --control 3 --seconds <s> [--trace]

Each seed runs the cell as ``run.py`` does (set-up, loop, window, check),
the first ``--control`` seeds with the control and the faults too, and
prints one JSON line: the seed, the compared numbers, the verdict of the
program and of each side against the cell's limits (``verdicts``), and
the end-to-end metrics. Not part of a benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], metavar="FIELD=JSON",
                    help="program fields to set (a witness run, e.g. "
                    'param_dtype=\\"float32\\")')
    args = ap.parse_args()

    import torch

    from harness import cell as cell_mod
    from harness import check, spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, args.trace)
    for kv in args.set:
        field, value = kv.split("=", 1)
        cell.config["program"]["set"][field] = json.loads(value)
        cell.config["program"]["expect"].pop(field, None)
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter() if i else T_START
        stats = {}
        r = cell_mod.run(cell, seed, args.seconds, args.trace,
                         torch.device("cuda", 0), t0,
                         control=i < args.control,
                         log=lambda *a: print(*a, file=sys.stderr, flush=True),
                         stats=stats)
        verdicts = {s: check.passed(r["checks"], s) for s in check.SIDES
                    if any(n.startswith(f"{s}_") for n in r["checks"])}
        print(json.dumps({"seed": seed, "set": args.set, "stats": stats,
                          "correct": r["correct"], "verdicts": verdicts,
                          "checks": r["checks"], "metrics": r["metrics"],
                          "device": r["device"],
                          "breakdown": r.get("breakdown")}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
