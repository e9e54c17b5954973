"""Dry-run sweep: every runnable (arch × shape) cell on both production
meshes, each in its own subprocess (``python -m repro_torch.launch.dryrun``,
so a failure or the fake process group stays in its process).

    PYTHONPATH=src python -m repro_torch.launch.sweep [--quantized] \\
        [--force] [--only-arch ARCH]

Results are cached as JSON in the dry run's directory (``dryrun_out/``):
a rerun fills only the gaps unless ``--force``. ``--quantized`` adds the
PTQTP-serving variants of the inference shapes on the single-pod mesh, as
the reference's ``cells()`` lists them. Exits 1 if any cell fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

from repro_torch.launch.dryrun import RESULTS_DIR

REPO = Path(__file__).resolve().parents[3]


def cells(include_quantized: bool):
    from repro_torch import configs

    out = []
    for arch, shape in configs.runnable_cells():
        for mesh in ("single", "multi"):
            out.append((arch, shape, mesh, False))
        if include_quantized and shape in ("prefill_32k", "decode_32k",
                                           "long_500k"):
            out.append((arch, shape, "single", True))
    return out


def tag_of(arch, shape, mesh, quantized):
    return f"{arch}__{shape}__{mesh}" + ("__q" if quantized else "")


def run_one(arch, shape, mesh, quantized, out_dir: Path, timeout_s=3600):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--mesh", mesh,
           "--out", str(out_dir)]
    if quantized:
        cmd.append("--quantized")
    src = str(REPO / "src")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                             else ""))
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True,
                              text=True, timeout=timeout_s, env=env)
        rc, so, se = proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:]
    except subprocess.TimeoutExpired:
        rc, so, se = -9, "", "TIMEOUT"
    return rc, time.time() - t0, so, se


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quantized", action="store_true",
                    help="also run PTQTP-quantized inference cells")
    ap.add_argument("--force", action="store_true", help="ignore cache")
    ap.add_argument("--only-arch", default=None)
    args = ap.parse_args(argv)

    out_dir = RESULTS_DIR
    todo = cells(args.quantized)
    if args.only_arch:
        todo = [c for c in todo if c[0] == args.only_arch]
    out_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    pending = [c for c in todo
               if args.force or not (out_dir / f"{tag_of(*c)}.json").exists()]
    n_skip = len(todo) - len(pending)

    failures = []
    for cell in pending:
        tag = tag_of(*cell)
        print(f"[sweep] {tag} ...", flush=True)
        rc, dt, _, se = run_one(*cell, out_dir)
        if rc == 0 and (out_dir / f"{tag}.json").exists():
            print(f"[sweep] {tag} OK ({dt:.0f}s)", flush=True)
        else:
            failures.append(tag)
            print(f"[sweep] {tag} FAILED rc={rc}\n{se}", flush=True)
    print(f"[sweep] done: ok={len(pending) - len(failures)} cached={n_skip} "
          f"failed={len(failures)} of {len(todo)} cells in "
          f"{time.time() - t0:.1f}s")
    if failures:
        print("[sweep] failures:", failures)
        sys.exit(1)


if __name__ == "__main__":
    main()
