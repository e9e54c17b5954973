"""AWQ (Lin et al., 2024): activation-aware per-channel scaling, as the
reference's ``core/baselines/awq.py`` computes it.

A grid of ratios r in [0, 1] gives per-input-channel scales s =
act_scaleʳ (normalized by √(max·min)); W·diag(s) is RTN-quantized, 1/s
folded back, and the r whose Ŵ minimizes ‖(Ŵ − W)·Xᵀ‖² wins (the first of
equal errors, ``argmin``'s rule). The attempts run one after another, each
kept only while it is the best (the reference stacks all of them under
``vmap``: 20 copies of W).
"""

from __future__ import annotations

import torch

from repro_torch.core.baselines.rtn import rtn_quantize


def ratio_grid(n: int):
    """``jnp.linspace(0, 1, n)`` in f32 bit for bit (i / (n - 1), then 1),
    as Python floats; ``torch.linspace`` differs in the last place."""
    if n == 1:
        return [0.0]
    step = torch.arange(n - 1, dtype=torch.float32) / (n - 1)
    return step.tolist() + [1.0]


def awq_quantize(w: torch.Tensor, x: torch.Tensor, bits: int = 3,
                 group_size: int = 128, n_grid: int = 20):
    """Quantize (n, d) weights with activation statistics from x (..., d).

    Returns (w_hat (n, d) f32, {"ratio", "err": 0-d f32})."""
    n, d = w.shape
    w = w.to(torch.float32)
    xf = x.reshape(-1, d).to(torch.float32)
    act_scale = torch.clamp(xf.abs().mean(dim=0), min=1e-8)
    best = None
    for ratio in ratio_grid(n_grid):
        s = torch.pow(act_scale, ratio)
        s = s / torch.sqrt(torch.clamp(s.amax() * s.amin(), min=1e-20))
        s = torch.clamp(s, min=1e-4)
        w_hat = rtn_quantize(w * s[None, :], bits=bits,
                             group_size=group_size)[0] / s[None, :]
        err = (((w_hat - w) @ xf.T) ** 2).sum()
        if best is None or bool(err < best[0]):   # one host sync an attempt
            best = (err, ratio, w_hat)
        del w_hat
    err, ratio, w_hat = best
    return w_hat, {"ratio": torch.tensor(ratio, dtype=torch.float32),
                   "err": err}
