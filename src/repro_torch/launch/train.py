"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(the reference's ``repro.launch.train``, same flags, plus ``--device``).

Runs training with the full substrate: the deterministic sharded data,
the microbatched train step, atomic checkpointing with resume, preemption
handling and heartbeats. Smoke size by default (``--full`` for the
published widths); on the card unless ``--device cpu``. Every arch of
the registry trains, the recurrent ones (recurrentgemma-2b, rwkv6-3b)
through the backward kernels of ``rglru_scan`` and ``wkv6``.

    python -m repro_torch.launch.train --device cpu --steps 20
    python -m repro_torch.launch.train --full --steps 4 --seq-len 512 \\
        --ckpt-dir runs/qwen2     # on the card; resumes from runs/qwen2
    python -m repro_torch.launch.train --arch rwkv6-3b --device cpu --steps 5
"""

from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=configs.ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="use the reduced smoke config (default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu for the "
                         "plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 10, 1),
                                   total=args.steps))
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.batch,
                      seed=args.seed)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_interval=args.ckpt_interval, run_dir=args.run_dir,
        grad_compress=args.grad_compress, seed=args.seed)
    trainer = Trainer(cfg, opt, dcfg, tcfg, device=args.device)
    state = trainer.fit()
    last = trainer.history[-1]["loss"] if trainer.history else float("nan")
    first = trainer.history[0]["loss"] if trainer.history else float("nan")
    print(f"[train] done: step {int(state['step'])} "
          f"loss {first:.4f} -> {last:.4f}")
    return state, trainer


if __name__ == "__main__":
    main()
