"""Plain PyTorch versions of RMSNorm, the reference's formula
(``repro/models/common.py::rms_norm``), in f32, cast back to x's dtype,

  y = (x · rsqrt(mean(x², -1) + eps)) · scale

and of the residual add before it (``add_rms_norm_plain``: x + delta, then
that norm, as the reference's blocks compute them). They are what the
wrappers run for CPU tensors, and what the CUDA kernel is held against on
the card.

``rms_norm_backward_plain`` is the norm's backward written out, in f32,
with r = rsqrt(mean(x²) + eps), x̂ = x·r and ĝ = dy·scale:

  dx     = r · (ĝ − x̂ · mean(ĝ · x̂)),   cast to x's dtype
  dscale = Σ_rows dy · x̂,                cast to scale's dtype

and, given the gradient ``dres`` of the residual stream x + delta itself
(``add_rms_norm``'s first output), dx + dres in x's dtype: the gradient
of both x and delta. It is what the backward kernels are held against.
"""

from __future__ import annotations

from typing import Optional

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


def rms_norm_backward_plain(scale: torch.Tensor, x: torch.Tensor,
                            dy: torch.Tensor, eps: float = 1e-5,
                            dres: Optional[torch.Tensor] = None):
    """(dx, dscale) of ``rms_norm_plain(scale, x, eps)`` for the output's
    gradient ``dy`` (x's shape); with ``dres``, dx + dres."""
    d = x.shape[-1]
    xf = x.to(torch.float32)
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyf = dy.to(torch.float32)
    g = dyf * scale.to(torch.float32)
    m = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (g - xhat * m)).to(x.dtype)
    if dres is not None:
        dx = dx + dres.to(x.dtype)
    dscale = (dyf * xhat).reshape(-1, d).sum(dim=0).to(scale.dtype)
    return dx, dscale
