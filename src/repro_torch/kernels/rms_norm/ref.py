"""Plain PyTorch versions of RMSNorm, the reference's formula
(``repro/models/common.py::rms_norm``), in f32, cast back to x's dtype,

  y = (x · rsqrt(mean(x², -1) + eps)) · scale

and of the residual add before it (``add_rms_norm_plain``: x + delta, then
that norm, as the reference's blocks compute them). They are what the
wrappers run for CPU tensors, and what the CUDA kernel is held against on
the card.
"""

from __future__ import annotations

import torch


def rms_norm_plain(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


def add_rms_norm_plain(scale: torch.Tensor, x: torch.Tensor,
                       delta: torch.Tensor, eps: float = 1e-5):
    x = x + delta
    return x, rms_norm_plain(scale, x, eps)
