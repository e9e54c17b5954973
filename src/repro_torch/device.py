"""Device selection shared by the port's entry points.

Entry points take ``device="cuda"`` by default. Asking for CUDA on a machine
without a card raises: nothing falls back to the CPU unless the caller asks
for it (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]
