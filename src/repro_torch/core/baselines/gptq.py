"""GPTQ (Frantar et al., 2022): Hessian-guided, error-compensated RTN, as
the reference's ``core/baselines/gptq.py`` computes it:

  H = XᵀX + damp·I  from calibration activations (I without them),
  U = the upper Cholesky factor of H⁻¹, then for each column j in order
      q_j = quant(w_j)                    (group-wise symmetric RTN)
      e   = (w_j − q_j) / U[j, j]
      W[:, j+1:] −= e ⊗ U[j, j+1:]        (masked over the full width)

with per-(row, group) scales from the original weights. The column loop is
the reference's, not the blocked lazy-batch variant: d steps of a few
launches each on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.baselines.rtn import recip


def hessian_inv_chol(x: Optional[torch.Tensor], d: int,
                     damp_frac: float = 0.01, device=None) -> torch.Tensor:
    """Upper Cholesky factor of H⁻¹ for H = XᵀX + damp·I (d, d) f32; x
    (..., d) or None (H = I before the damping)."""
    if x is None:
        h = torch.eye(d, dtype=torch.float32, device=device)
    else:
        xf = x.reshape(-1, d).to(torch.float32)
        h = xf.T @ xf
    damp = damp_frac * torch.diagonal(h).mean() + 1e-6
    h = h + damp * torch.eye(d, dtype=torch.float32, device=h.device)
    return torch.linalg.cholesky(torch.linalg.inv(h), upper=True)


def gptq_quantize(w: torch.Tensor, x: Optional[torch.Tensor] = None,
                  bits: int = 3, group_size: int = 128,
                  damp_frac: float = 0.01):
    """Quantize (n, d) weights against calibration activations x (..., d)
    (None: an identity Hessian). Returns (w_hat (n, d) f32, {"scale":
    (n, d/G) f32})."""
    n, d = w.shape
    g = group_size if group_size > 0 else d
    if d % g:
        raise ValueError(f"d={d} is not a multiple of the group size {g}")
    w = w.to(torch.float32)
    qmax = 2 ** (bits - 1) - 1
    maxabs = w.reshape(n, d // g, g).abs().amax(dim=-1)
    scale_g = torch.clamp(maxabs * recip(qmax), min=1e-10)
    u = hessian_inv_chol(x, d, damp_frac, w.device)
    later = torch.arange(d, device=w.device)
    wc = w.clone()
    w_hat = torch.empty_like(w)
    for j in range(d):
        wj, sj = wc[:, j], scale_g[:, j // g]
        qj = torch.clamp(torch.round(wj / sj), -qmax - 1, qmax) * sj
        err = (wj - qj) / torch.clamp(u[j, j], min=1e-10)
        wc -= err[:, None] * (u[j] * (later > j).to(torch.float32))[None, :]
        w_hat[:, j] = qj
    return w_hat, {"scale": scale_g}
