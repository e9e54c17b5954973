"""Plain PyTorch version of the RG-LRU scan: the reference's ``_lru_scan``
(``repro/models/rglru.py``) with per-row lengths for its mask,

  h_t = a_t · h_{t-1} + gx_t   for t < lengths[b]; h_{t-1} after,

a loop over time with one product and one sum a step (the kernel's two
roundings). ``h`` (B, R) is updated in place to the last step's state.
It is what the wrapper runs for CPU tensors, and what the CUDA kernel is
held against on the card.
"""

from __future__ import annotations

import torch


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
