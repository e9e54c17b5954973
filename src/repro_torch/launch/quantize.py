"""Offline quantization CLI: FP weights → trit-plane artifact, streamed (the
reference's ``repro.launch.quantize``, same flags and format).

``python -m repro_torch.launch.quantize --arch qwen2-1.5b --out DIR``
``python -m repro_torch.launch.quantize --config full --out DIR`` (full width)
``python -m repro_torch.launch.quantize --device cpu --out DIR`` (no card)

Walks the model one kernel at a time in the reference's layout, quantizes
it on ``--device`` (on the card every trit step runs on the search kernel),
appends the packed trit-planes to the artifact's shards and commits them
in fsync'd groups: an interrupted run resumes from the staging manifest,
skipping what is committed. Serve the result with
``python -m repro_torch.launch.serve --artifact DIR``. Either package reads
the artifact.

Weight source: the port's random initialisation from ``--seed``.
``--from-checkpoint`` (a training checkpoint) is not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs
from repro_torch.artifacts import read_manifest, verify_artifact, write_artifact
from repro_torch.convert import to_reference_tree
from repro_torch.core.ptqtp import PTQTPConfig
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime import clock as rtclock


def _progress_printer(every: int = 1):
    state = {"quantized": 0, "skipped": 0, "fp": 0}

    def progress(ev):
        state[{"quantize": "quantized", "skip": "skipped"}.get(
            ev["action"], "fp")] += 1
        if ev["action"] == "quantize":
            err = (ev.get("error") or {}).get("rel_fro_error")
            err_s = f" err={err:.4f}" if err is not None else ""
            if state["quantized"] % every == 0:
                print(f"[quantize] #{ev['index']:>3} {ev['path']} "
                      f"shape={ev['shape']}{err_s} "
                      f"({ev['elapsed']:.1f}s)", flush=True)
        elif ev["action"] == "skip" and state["skipped"] == 1:
            print("[quantize] resuming: skipping tensors already committed "
                  "in the staging manifest", flush=True)

    progress.state = state
    return progress


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--out", required=True, help="artifact directory to write")
    ap.add_argument("--config", choices=("smoke", "full"), default="smoke",
                    help="model size: smoke (default) or the published "
                         "full-width config")
    ap.add_argument("--from-checkpoint", default=None, metavar="DIR",
                    help="stream FP weights out of a training checkpoint "
                         "(not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--group-size", type=int, default=0,
                    help="PTQTP group size G (0 → min(128, d_model))")
    ap.add_argument("--t-max", type=int, default=20)
    ap.add_argument("--commit-every", type=int, default=None, metavar="N",
                    help="fsync group-commit size: make tensors durable "
                         "every N commits (1 = per tensor; default 8)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore any staging manifest and restart")
    ap.add_argument("--overwrite", action="store_true",
                    help="replace an existing artifact at --out")
    ap.add_argument("--no-error-stats", action="store_true",
                    help="skip the per-kernel approximation-error pass")
    ap.add_argument("--verify", action="store_true",
                    help="re-checksum the finished artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device to quantize on (cuda, or cpu for the "
                         "plain PyTorch version of the search)")
    args = ap.parse_args(argv)
    if args.from_checkpoint:
        raise NotImplementedError(
            "--from-checkpoint needs runtime/checkpoint.py, which the port "
            "does not have yet (ROADMAP A.6)")

    dev = resolve_device(args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.config == "smoke"
           else configs.get_config(args.arch))
    gs = args.group_size or min(128, cfg.d_model)
    pcfg = PTQTPConfig(group_size=gs, t_max=args.t_max)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)

    print(f"[quantize] {args.arch} ({args.config}) from seed {args.seed} on "
          f"{dev} → {args.out}  G={gs} t_max={args.t_max}", flush=True)
    progress = _progress_printer()
    t0 = rtclock.now()
    out = write_artifact(
        args.out, arch=args.arch, model_cfg=cfg, ptqtp_cfg=pcfg,
        params=to_reference_tree(model, cfg),
        compute_error=not args.no_error_stats, progress=progress,
        resume=not args.no_resume, overwrite=args.overwrite,
        commit_every=args.commit_every)
    dt = rtclock.now() - t0

    stats = read_manifest(out)["stats"]
    st = progress.state
    print(f"[quantize] done in {dt:.1f}s: {st['quantized']} kernels "
          f"quantized, {st['fp']} FP leaves, {st['skipped']} resumed; "
          f"{stats['total_bytes'] / 1e6:.2f} MB on disk "
          f"({stats.get('bytes_per_weight', float('nan')):.4f} B/weight, "
          f"{stats['source_fp16_bytes'] / max(stats['quantized_bytes'], 1):.2f}x "
          f"vs fp16)", flush=True)
    if args.verify:
        verify_artifact(out)
        print("[quantize] verify: all checksums OK", flush=True)
    return out


if __name__ == "__main__":
    main()
