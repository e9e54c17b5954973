"""Where a chunk-attention read's time goes on the card, stage by stage.

    python -m repro_torch.launch.attention_stages

Builds ``kernels/chunk_attention/csrc/chunk_attention.cu`` with
``CHUNK_ATTENTION_STAGES`` defined: thread 0 of every block then stamps
``clock64()`` at each stage boundary of the split-KV kernel, and
``%globaltimer`` at the block's start, its arrival and the end of the
combine. It runs B2 (the ring kernel) at the main path's shapes (qwen2-1.5b:
8 rows, cap 1024, 2 kv heads of 6 query heads, hd 128, bf16 ring): L = 1
with every row at context 512 (as ``profile_decode``), and L = 1 and 64
with rows filled to 80-616 positions (as ``chip_smoke.py``'s fleet). For
each it prints the kernel's span (first block start to last combine end),
the median over the blocks that ran a part of each part stage, and the
median over the combining blocks of each combine stage, in µs at the SM
clock each block measured (clock64 ticks over globaltimer ns). A warm
call precedes the stamped one. It needs a CUDA device; the stamps cost a
few global stores per stage, so the spans are not the kernel's times.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_attention import ops

SLOTS = 16                      # u64 stamps a block (csrc STAGE_SLOTS)
BLOCKS = 65536                  # blocks stamped (csrc STAGE_BLOCKS)
PART_STAGES = ("slot positions", "copies issued", "K landed", "scores",
               "softmax, V landed", "P.V and partial stored",
               "fence and arrival")
COMBINE_STAGES = ("(m, l) in shared", "weights", "acc loads and output")
CASES = (("L = 1, every row at context 512", 1, [512] * 8),
         ("L = 1, rows at 80-616", 1, [80, 150, 230, 330, 420, 500, 570,
                                        616]),
         ("L = 64, rows at 80-616", 64, [80, 150, 230, 330, 420, 500, 570,
                                         616]))
B, CAP, KV, G, HD = 8, 1024, 2, 6, 128


def _stamped_source() -> Path:
    """A translation unit that defines the macro and includes the kernel
    source; it carries the source's hash, so its build is redone when the
    kernel changes."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "chunk_attention_stages.cu"
    digest = hashlib.sha256(ops._SOURCE.read_bytes()).hexdigest()
    text = (f"// {digest}\n#define CHUNK_ATTENTION_STAGES\n"
            f'#include "{ops._SOURCE.resolve()}"\n')
    if not path.exists() or path.read_text() != text:
        path.write_text(text)
    return path


def _inputs(L, fill, dev, gen):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    pos_buf = torch.full((B, CAP), -1, dtype=torch.int32, device=dev)
    for r, n in enumerate(fill):
        p = torch.arange(max(0, n - CAP), n, device=dev, dtype=torch.int32)
        pos_buf[r, p % CAP] = p
    positions = (torch.tensor(fill, dtype=torch.int32, device=dev)[:, None]
                 + torch.arange(L, dtype=torch.int32, device=dev)[None])
    lengths = torch.full((B,), L, dtype=torch.int32, device=dev)
    return [rnd(B, L, KV, G, HD), rnd(B, L, KV, HD), rnd(B, L, KV, HD),
            rnd(B, CAP, KV, HD), None, rnd(B, CAP, KV, HD), None, pos_buf,
            positions, lengths]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attention_stages needs a CUDA device")
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    source = _stamped_source()
    lib = _build.load(source, {**ops._SIGNATURES,
                               "chunk_attention_stages": [ctypes.c_void_p]})
    ops._SOURCE, plain_source = source, ops._SOURCE
    try:
        gen = torch.Generator(device=dev).manual_seed(3)
        for name, L, fill in CASES:
            args = _inputs(L, fill, dev, gen)
            ops.chunk_attention_cuda(*args)
            torch.cuda.synchronize()
            stamps = np.zeros(BLOCKS * SLOTS, np.uint64)
            _build.check(lib.chunk_attention_stages(stamps.ctypes.data),
                         "chunk_attention_stages")  # clears them
            ops.chunk_attention_cuda(*args)
            torch.cuda.synchronize()
            _build.check(lib.chunk_attention_stages(stamps.ctypes.data),
                         "chunk_attention_stages")
            n_blocks = ((len(ops.split_ranges(CAP))
                         + len(ops.split_ranges(L)))
                        * -(-L * G // ops.ROW_TILE) * KV * B)
            s = stamps[:n_blocks * SLOTS].reshape(n_blocks, SLOTS).astype(
                np.int64)
            ghz = (s[:, 7] - s[:, 0]) / np.maximum(s[:, 12] - s[:, 11], 1)
            ran = s[:, 6] > 0
            last = s[:, 13] > 0
            print(f"{gpu} | B2 {name}: {n_blocks} blocks, {int(ran.sum())} "
                  f"ran a part, {int(last.sum())} combined; span "
                  f"{(s[last, 13].max() - s[:, 11].min()) / 1e3:.2f} us, "
                  f"SM clock {np.median(ghz):.3f} GHz")
            steps = list(zip(range(7), range(1, 8), PART_STAGES))
            for a, z, what in steps:
                us = (s[ran, z] - s[ran, a]) / ghz[ran] / 1e3
                print(f"    part    {what:24s} {np.median(us):7.2f} us")
            for (a, z), what in zip(((7, 8), (8, 9), (9, 10)),
                                    COMBINE_STAGES):
                us = (s[last, z] - s[last, a]) / ghz[last] / 1e3
                print(f"    combine {what:24s} {np.median(us):7.2f} us")
    finally:
        ops._SOURCE = plain_source


if __name__ == "__main__":
    main()
