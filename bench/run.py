"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (one JSON object) and the numbers the check compared, each
beside its limit, as the last lines of standard error. Exits non-zero, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), and when the process holds JAX or the JAX package after the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the checkout's caches: fixed paths inside it, so that only a cell's first
# run in a checkout builds anything
os.environ.setdefault("TRITON_CACHE_DIR", str(BENCH / "out" / "triton"))
sys.path[:0] = [str(BENCH), str(ROOT / "src")]


def err(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import spec
    cell = spec.load_cell(args.workload, bool(args.trace), ROOT)

    import torch
    if not torch.cuda.is_available():
        err("no CUDA card: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        err(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 2

    from harness import cell as cell_mod, check, isolation
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START, log=err)
    bad = isolation.loaded()
    if bad:
        err(f"the run's process holds {bad}: no result")
        return 3
    for line in check.lines(result["checks"]):
        err(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
