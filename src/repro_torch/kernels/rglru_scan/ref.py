"""Plain PyTorch versions of the RG-LRU's recurrence.

``rglru_scan_plain`` is the reference's ``_lru_scan``
(``repro/models/rglru.py``) with per-row lengths for its mask,

  h_t = a_t · h_{t-1} + gx_t   for t < lengths[b]; h_{t-1} after,

a loop over time with one product and one sum a step (the kernel's two
roundings). ``h`` (B, R) is updated in place to the last step's state.

``rglru_gated_scan_plain`` is the layer around it, from the gates'
block-diagonal products to ``wo``'s input: the reference's
``rglru_forward`` between ``_conv1d`` and ``dense(p["wo"], ...)``, op for
op as PyTorch runs it (each op's result in its own dtype), with the
scan as ``scan`` (``rglru_scan_plain`` unless the caller passes another
route of the same function).

They are what the wrappers run for CPU tensors, and what the CUDA kernel
is held against on the card.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

C = 8.0  # Griffin's recurrence-gate sharpness constant


def rglru_scan_plain(a: torch.Tensor, gx: torch.Tensor, h: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """a, gx (B, S, R) f32; h (B, R) f32 (in place); lengths (B,) int.
    Returns every step's state (B, S, R) f32."""
    s = a.shape[1]
    t = torch.arange(s, device=a.device)
    live = (t[None, :] < lengths.to(a.device)[:, None])[..., None]
    state = h.clone()
    out = []
    for i in range(s):
        state = torch.where(live[:, i], a[:, i] * state + gx[:, i], state)
        out.append(state)
    h.copy_(state)
    return torch.stack(out, dim=1)


def rglru_gated_scan_plain(ya: torch.Tensor, yx: torch.Tensor,
                           ba: torch.Tensor, bx: torch.Tensor,
                           c: torch.Tensor, g: torch.Tensor,
                           lam: torch.Tensor, h: torch.Tensor,
                           lengths: torch.Tensor,
                           scan=rglru_scan_plain) -> torch.Tensor:
    """ya, yx (n_blocks, B·S, R / n_blocks): the products of c through the
    block-diagonal gates a and x, before their biases ba, bx (R,); c (B,
    S, R) the conv output and g (B, S, R) the wgate product, before its
    GELU, in the activation dtype; lam (R,) Λ; h (B, R) f32, advanced in
    place; lengths (B,) int. Returns the input of ``wo``, (B, S, R) in c's
    dtype:

      r = σ(ya + ba), i = σ(yx + bx)      (in c's dtype, then f32)
      a = exp(−8·softplus(Λ)·r),  gx = √max(1 − a², 1e-12) · (i·c)
      h_t = a·h_{t−1} + gx  (``scan``);   y = gelu(g) · h_t
    """
    b, s, r = c.shape

    def gate(y, bias):
        return y.transpose(0, 1).reshape(b, s, r) + bias.to(c.dtype)

    rt = torch.sigmoid(gate(ya, ba)).to(torch.float32)
    it = torch.sigmoid(gate(yx, bx)).to(torch.float32)
    lam = lam.to(torch.float32)
    log_a = -C * torch.logaddexp(lam, torch.zeros_like(lam)) * rt
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (it * c.to(torch.float32))
    hs = scan(a, gated_x, h, lengths)
    gb = F.gelu(g, approximate="tanh")
    return (gb.to(torch.float32) * hs).to(c.dtype)
