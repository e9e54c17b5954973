"""Plain PyTorch version of the RWKV6 recurrence and its group norm: the
reference's scan in ``rwkv_time_forward`` and ``_group_norm``
(``repro/models/rwkv6.py``), with per-row lengths for its mask. Per step:

  y_j  = Σ_i r_i (S_ij + u_i k_i v_j)
  S_ij = w_i S_ij + k_i v_j          (only while t < lengths[b])

then y is rounded to the activation dtype and normalised over each head:
((y − mean) · rsqrt(var + eps)) · scale, in f32, cast back. The state
``S`` (B, H, hd, hd) f32 is updated in place. It is what the wrapper runs
for CPU tensors, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

GROUP_NORM_EPS = 1e-5


def wkv6_plain(r, k, v, w, u, state, lengths, scale,
               eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """r, k, v (B, S, H, hd) in the activation dtype; w (B, S, H, hd) f32;
    u (H, hd); state (B, H, hd, hd) f32 (in place); lengths (B,) int;
    scale (H·hd,). Returns (B, S, H·hd) in r's dtype."""
    b, s, nh, hd = r.shape
    dt = r.dtype
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    uf = u.to(torch.float32)[None, :, :, None]
    t = torch.arange(s, device=r.device)
    live = (t[None, :] < lengths.to(r.device)[:, None])[:, :, None, None,
                                                          None]
    st = state.clone()
    ys = []
    for i in range(s):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        ys.append((rf[:, i, :, :, None] * (st + uf * kv)).sum(dim=-2))
        st = torch.where(live[:, i], w[:, i, :, :, None] * st + kv, st)
    state.copy_(st)
    y = torch.stack(ys, dim=1).to(dt).to(torch.float32)   # (B, S, H, hd)
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + eps)
    return (y.reshape(b, s, nh * hd) * scale.to(torch.float32)).to(dt)
