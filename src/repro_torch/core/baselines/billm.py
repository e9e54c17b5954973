"""BiLLM-style binary PTQ (Huang et al., 2024), simplified, as the
reference's ``core/baselines/billm.py`` computes it:

  * the top ``salient_frac`` input columns (by calibration activation
    energy times the column's weight energy; without x, the column norm)
    get residual binarization: two sign planes with per-row α;
  * the other columns are split per row at the median magnitude into two
    groups, each binarized with its own per-row α.

Average bits ≈ 1 + salient_frac (+ bitmap overhead).
"""

from __future__ import annotations

from typing import Optional

import torch


def _sign(w):
    """sign(w) with 0 → +1."""
    s = torch.sign(w)
    return torch.where(s == 0, 1.0, s)


def _residual_binarize(w):
    """Two-plane residual sign binarization with per-row scales."""
    b1 = _sign(w)
    a1 = w.abs().mean(dim=-1, keepdim=True)
    r = w - a1 * b1
    b2 = _sign(r)
    a2 = r.abs().mean(dim=-1, keepdim=True)
    return a1 * b1 + a2 * b2


def median_last(x):
    """``jnp.median`` over the last dim: the mean of the two middle values
    of an even count ((lo + hi)·0.5, its 'midpoint' rule), not
    ``torch.median``'s lower one. A sort, not ``torch.quantile``, which
    refuses more than 2^24 elements."""
    s = torch.sort(x, dim=-1).values
    k = x.shape[-1]
    return (s[..., (k - 1) // 2] + s[..., k // 2]) * 0.5


def _split_binarize(w):
    """Magnitude-split one-plane binarization (per row, two α groups)."""
    mag = w.abs()
    hi = mag > median_last(mag)[:, None]
    sgn = _sign(w)

    def group_alpha(mask):
        cnt = torch.clamp(mask.sum(dim=-1, keepdim=True), min=1.0)
        return (mag * mask).sum(dim=-1, keepdim=True) / cnt

    a_hi = group_alpha(hi.to(torch.float32))
    a_lo = group_alpha((~hi).to(torch.float32))
    return torch.where(hi, a_hi * sgn, a_lo * sgn)


def billm_quantize(w: torch.Tensor, x: Optional[torch.Tensor] = None,
                   salient_frac: float = 0.05):
    """Quantize (n, d) weights. Returns (w_hat (n, d) f32, {"salient": (d,)
    bool, "effective_bits": float})."""
    n, d = w.shape
    w = w.to(torch.float32)
    col_energy = (w * w).sum(dim=0)
    if x is not None:
        xf = x.reshape(-1, d).to(torch.float32)
        col_energy = (xf * xf).sum(dim=0) * col_energy
    k = max(1, int(d * salient_frac))
    salient = col_energy >= torch.sort(col_energy).values[-k]
    w_hat = torch.where(salient[None, :], _residual_binarize(w),
                        _split_binarize(w))
    return w_hat, {"salient": salient,
                   "effective_bits": 1.0 + salient_frac + 1.0 / 128.0}
