"""Plain PyTorch version of the RWKV6 recurrence and its group norm: the
reference's scan in ``rwkv_time_forward`` and ``_group_norm``
(``repro/models/rwkv6.py``), with per-row lengths for its mask. Per step:

  y_j  = Σ_i r_i (S_ij + u_i k_i v_j)
  S_ij = w_i S_ij + k_i v_j          (only while t < lengths[b])

then y is rounded to the activation dtype and normalised over each head:
((y − mean) · rsqrt(var + eps)) · scale, in f32, cast back. The state
``S`` (B, H, hd, hd) f32 is updated in place. It is what the wrapper runs
for CPU tensors, and what the CUDA kernel is held against on the card.

``wkv6_backward_plain`` is its backward written out: the gradients that
PyTorch's autograd of ``wkv6_plain`` gives (the group norm's, then the
scan's in reverse, with each step's state before it recomputed forward
from the saved initial state; the rounding of y to the activation dtype
passes the gradient through, rounded to that dtype, as ``jax.grad`` of
``.astype`` does).
"""

from __future__ import annotations

import torch

GROUP_NORM_EPS = 1e-5


def _scan(r, k, v, w, u, state, lengths, before=None):
    """The WKV readouts of every step (B, S, H, hd) f32 from ``state``
    (not modified) and the state after the last live step; ``before``, a
    list, also gets the state before each step."""
    s = r.shape[1]
    rf, kf, vf = (t.to(torch.float32) for t in (r, k, v))
    uf = u.to(torch.float32)[None, :, :, None]
    t = torch.arange(s, device=r.device)
    live = (t[None, :] < lengths.to(r.device)[:, None])[:, :, None, None,
                                                          None]
    st = state.clone()
    ys = []
    for i in range(s):
        kv = kf[:, i, :, :, None] * vf[:, i, :, None, :]
        if before is not None:
            before.append(st)
        ys.append((rf[:, i, :, :, None] * (st + uf * kv)).sum(dim=-2))
        st = torch.where(live[:, i], w[:, i, :, :, None] * st + kv, st)
    return torch.stack(ys, dim=1), st


def _norm_stats(y, eps):
    """Each step and head's mean and rsqrt(var + eps) of y (B, S, H, hd)."""
    mean = y.mean(dim=-1, keepdim=True)
    var = ((y - mean) ** 2).mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def wkv6_plain(r, k, v, w, u, state, lengths, scale,
               eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """r, k, v (B, S, H, hd) in the activation dtype; w (B, S, H, hd) f32;
    u (H, hd); state (B, H, hd, hd) f32 (in place); lengths (B,) int;
    scale (H·hd,). Returns (B, S, H·hd) in r's dtype."""
    b, s, nh, hd = r.shape
    dt = r.dtype
    y, st = _scan(r, k, v, w, u, state, lengths)
    state.copy_(st)
    y = y.to(dt).to(torch.float32)
    mean, rstd = _norm_stats(y, eps)
    y = (y - mean) * rstd
    return (y.reshape(b, s, nh * hd) * scale.to(torch.float32)).to(dt)


def wkv6_backward_plain(r, k, v, w, u, state0, lengths, scale, dout,
                        eps: float = GROUP_NORM_EPS):
    """The gradients of ``wkv6_plain(r, k, v, w, u, state, lengths,
    scale)`` for its output's gradient ``dout`` (B, S, H·hd), with
    ``state0`` the state before the call (the state after it has no
    gradient). Returns (dr, dk, dv) in r's dtype, dw f32, du (H, hd) and
    dscale (H·hd,) in their own dtypes; du and dscale sum over rows and
    steps in f32."""
    b, s, nh, hd = r.shape
    dt = r.dtype
    f32 = torch.float32
    rf, kf, vf = (t.to(f32) for t in (r, k, v))
    uf = u.to(f32)[None, :, :, None]
    t_idx = torch.arange(s, device=r.device)
    live = (t_idx[None, :] < lengths.to(r.device)[:, None])[:, :, None, None,
                                                            None]
    before = []  # the state before each step
    y, _ = _scan(r, k, v, w, u, state0, lengths, before)
    y = y.to(dt).to(f32)                                     # (B, S, H, hd)
    mean, rstd = _norm_stats(y, eps)
    yn = (y - mean) * rstd
    df = dout.to(f32).reshape(b, s, nh, hd)
    scf = scale.to(f32).reshape(nh, hd)
    dscale = (df * yn).reshape(-1, nh * hd).sum(dim=0).to(scale.dtype)
    dyn = df * scf
    dy = rstd * (dyn - dyn.mean(dim=-1, keepdim=True)
                 - yn * (dyn * yn).mean(dim=-1, keepdim=True))
    dy = dy.to(dt).to(f32)
    dr, dk, dv = (torch.zeros_like(rf) for _ in range(3))
    dw = torch.zeros_like(w, dtype=f32)
    du = torch.zeros((b, nh, hd), dtype=f32, device=r.device)
    dst = torch.zeros_like(state0)       # the gradient of the state after t
    for i in range(s - 1, -1, -1):
        st = before[i]
        ki, vi = kf[:, i, :, :, None], vf[:, i, :, None, :]
        kv = ki * vi
        dz = rf[:, i, :, :, None] * dy[:, i, :, None, :]     # d(S + u·kv)
        dr[:, i] = (dy[:, i, :, None, :] * (st + uf * kv)).sum(dim=-1)
        du += (dz * kv).sum(dim=-1)
        lv = live[:, i]
        dkv = dz * uf + torch.where(lv, dst, torch.zeros_like(dst))
        dw[:, i] = torch.where(lv[..., 0], (dst * st).sum(dim=-1),
                               torch.zeros_like(dw[:, i]))
        dk[:, i] = (dkv * vi).sum(dim=-1)
        dv[:, i] = (dkv * ki).sum(dim=-2)
        dst = dz + torch.where(lv, w[:, i, :, :, None] * dst, dst)
    return (dr.to(dt), dk.to(dt), dv.to(dt), dw, du.sum(dim=0).to(u.dtype),
            dscale)
