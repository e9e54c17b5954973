"""Pieces shared by the plain references: the trit-plane storage format,
group dequantization, RMSNorm, and the lower-precision rounding of the
control.

Everything here is plain PyTorch in float32 and imports nothing of the
program. The storage format is the one the benchmark writes the planes in
(``harness/weights.py``): four trits a byte, trit j in bits 2(j % 4) and
2(j % 4) + 1 of byte j // 4, field 0b01 = +1, 0b10 = -1, 0b00 = 0.
"""

from __future__ import annotations

import torch

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8_e4m3fn


def unpack(packed: torch.Tensor) -> torch.Tensor:
    """(n, b) uint8 planes -> (n, 4b) float32 trits."""
    p = packed.to(torch.int32)
    fields = torch.stack([(p >> (2 * i)) & 3 for i in range(4)], dim=-1)
    t = (fields == 1).to(F32) - (fields == 2).to(F32)
    return t.reshape(packed.shape[0], packed.shape[1] * 4)


def dequant(planes, group: int) -> torch.Tensor:
    """W = a1 * T1 + a2 * T2 by groups of ``group`` along d_in: planes is
    (t1p, t2p, alpha) with alpha (n, d_in / group, 2). Returns (n, d_in)
    float32."""
    t1p, t2p, alpha = planes
    t1, t2 = unpack(t1p), unpack(t2p)
    n, d = t1.shape
    a = alpha.to(F32)
    w = (t1.reshape(n, d // group, group) * a[..., 0:1]
         + t2.reshape(n, d // group, group) * a[..., 1:2])
    return w.reshape(n, d)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """x * rsqrt(mean(x^2) + eps) * scale, over the last axis."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.to(F32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's rounding: x scaled per tensor so that its largest
    magnitude is float8_e4m3fn's largest, rounded to that format and
    scaled back, in float32."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Rounding:
    """Where a forward rounds: ``None`` computes in float32 throughout (the
    reference); ``"fp8"`` rounds the inputs of every matrix product, the
    weights, and the keys and values kept for attention to float8_e4m3fn
    (the control: the precision below the bf16 that the configuration
    states)."""

    def __init__(self, mode=None):
        if mode not in (None, "fp8"):
            raise ValueError(f"unknown rounding {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mode is None else fp8(x)

    def linear(self, x, w, bias=None):
        """x @ w^T (+ bias) with both operands rounded."""
        y = self(x) @ self(w).T
        return y if bias is None else y + bias.to(F32)
