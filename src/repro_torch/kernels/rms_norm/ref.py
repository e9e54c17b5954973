"""Plain PyTorch version of RMSNorm: the reference's formula
(``repro/models/common.py::rms_norm``), in f32, cast back to x's dtype,

  y = (x · rsqrt(mean(x², -1) + eps)) · scale

It is what the wrapper runs for CPU tensors, and what the CUDA kernel is
held against on the card.
"""

from __future__ import annotations

import torch


def rms_norm_plain(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)
