"""Round-to-nearest (RTN) uniform quantization at k bits: group-wise
symmetric or asymmetric min-max quantization, the plain PTQ baseline under
the AWQ and GPTQ comparisons (the reference's ``core/baselines/rtn.py``).

The reference is jitted, and XLA computes its divisions by the constant
qmax as products with qmax's f32 reciprocal; so does this port
(``recip``), which keeps the codes at a rounding boundary equal.
"""

from __future__ import annotations

import torch


def recip(k: int) -> float:
    """1 / k rounded to f32, as XLA folds a division by the constant k."""
    return float(torch.tensor(1.0 / k, dtype=torch.float32))


def rtn_quantize(w: torch.Tensor, bits: int = 3, group_size: int = 128,
                 symmetric: bool = False):
    """Quantize (n, d) weights to ``bits`` with per-(row, group) scales
    (``group_size`` <= 0: one group a row).

    Returns (w_hat (n, d) f32, meta) with meta = {"q": int32 codes (n, d/G,
    G), "scale", "zero": (n, d/G, 1) f32}."""
    n, d = w.shape
    g = group_size if group_size > 0 else d
    if d % g:
        raise ValueError(f"d={d} is not a multiple of the group size {g}")
    wg = w.to(torch.float32).reshape(n, d // g, g)
    if symmetric:
        qmax = 2 ** (bits - 1) - 1
        maxabs = wg.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(maxabs * recip(qmax), min=1e-10)
        q = torch.clamp(torch.round(wg / scale), -qmax - 1, qmax)
        w_hat = q * scale
        zero = torch.zeros_like(scale)
    else:
        qmax = 2 ** bits - 1
        lo = wg.amin(dim=-1, keepdim=True)
        hi = wg.amax(dim=-1, keepdim=True)
        scale = torch.clamp((hi - lo) * recip(qmax), min=1e-10)
        zero = torch.round(-lo / scale)
        q = torch.clamp(torch.round(wg / scale) + zero, 0, qmax)
        w_hat = (q - zero) * scale
    return w_hat.reshape(n, d), {"q": q.to(torch.int32), "scale": scale,
                                 "zero": zero}
