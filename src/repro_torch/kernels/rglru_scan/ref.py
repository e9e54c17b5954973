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
scan as ``rglru_scan_plain``.

``rglru_gated_scan_backward_plain`` is its backward written out: the
gradients that PyTorch's autograd of ``rglru_gated_scan_plain`` gives,
op by op in the same dtypes (a cast passes the gradient through, rounded
to the input's dtype, as ``jax.grad`` of ``.astype`` does), with the
scan's reverse chain dh_{t−1} += a_t·dh_t and da_t = dh_t·h_{t−1}.

They are what the wrappers run for CPU tensors, and what the CUDA kernels
are held against on the card.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

C = 8.0  # Griffin's recurrence-gate sharpness constant
KEEP_MIN = 1e-12  # the floor of 1 − a² under its square root
GELU_BETA = (2.0 / math.pi) ** 0.5  # √2 · (2/√π) · ½, PyTorch's kBeta
GELU_KAPPA = 0.044715


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
                           lengths: torch.Tensor) -> torch.Tensor:
    """ya, yx (n_blocks, B·S, R / n_blocks): the products of c through the
    block-diagonal gates a and x, before their biases ba, bx (R,); c (B,
    S, R) the conv output and g (B, S, R) the wgate product, before its
    GELU, in the activation dtype; lam (R,) Λ; h (B, R) f32, advanced in
    place; lengths (B,) int. Returns the input of ``wo``, (B, S, R) in c's
    dtype:

      r = σ(ya + ba), i = σ(yx + bx)      (in c's dtype, then f32)
      a = exp(−8·softplus(Λ)·r),  gx = √max(1 − a², 1e-12) · (i·c)
      h_t = a·h_{t−1} + gx;   y = gelu(g) · h_t
    """
    gt = _gates(ya, yx, ba, bx, c, lam)
    hs = rglru_scan_plain(gt["a"], gt["sq"] * gt["ic"], h, lengths)
    gb = F.gelu(g, approximate="tanh")
    return (gb.to(torch.float32) * hs).to(c.dtype)


def _gates(ya, yx, ba, bx, c, lam):
    """The gates of ``rglru_gated_scan_plain`` and what their gradients
    need: sa, si (the sigmoids in c's dtype), rt, it (in f32), lam8 =
    −8·softplus(Λ), log_a, a, e2 = exp(2·log_a), keep_raw = 1 − e2, sq =
    √max(keep_raw, 1e-12), cf = c in f32 and ic = it·cf."""
    b, s, r = c.shape
    f32 = torch.float32

    def gate(y, bias):
        return y.transpose(0, 1).reshape(b, s, r) + bias.to(c.dtype)

    o = {"sa": torch.sigmoid(gate(ya, ba)), "si": torch.sigmoid(gate(yx, bx))}
    o["rt"], o["it"] = o["sa"].to(f32), o["si"].to(f32)
    lamf = lam.to(f32)
    o["lam8"] = -C * torch.logaddexp(lamf, torch.zeros_like(lamf))
    o["log_a"] = o["lam8"] * o["rt"]
    o["a"] = torch.exp(o["log_a"])
    o["e2"] = torch.exp(2.0 * o["log_a"])
    o["keep_raw"] = 1.0 - o["e2"]
    o["sq"] = torch.sqrt(torch.clamp(o["keep_raw"], min=KEEP_MIN))
    o["cf"] = c.to(f32)
    o["ic"] = o["it"] * o["cf"]
    return o


def gelu_tanh_backward_plain(dy: torch.Tensor, x: torch.Tensor
                             ) -> torch.Tensor:
    """The gradient of ``F.gelu(x, approximate="tanh")`` for dy, in f32
    from x's and dy's values, rounded once to x's dtype (PyTorch's
    ``gelu_backward`` formula)."""
    xf, df = x.to(torch.float32), dy.to(torch.float32)
    inner = GELU_BETA * (xf + GELU_KAPPA * (xf * xf * xf))
    th = torch.tanh(inner)
    left = 0.5 * xf
    right = 1.0 + th
    right_d = left * (1.0 - th * th) * (
        GELU_BETA * (1.0 + 3.0 * GELU_KAPPA * (xf * xf)))
    return (df * (0.5 * right + right_d)).to(x.dtype)


def _sigmoid_backward(dy: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """dy·(1 − y)·y of a sigmoid's output y, in f32, rounded to y's
    dtype."""
    yf = y.to(torch.float32)
    return (dy.to(torch.float32) * (1.0 - yf) * yf).to(y.dtype)


def rglru_gated_scan_backward_plain(ya, yx, ba, bx, c, g, lam, h0, lengths,
                                    dout):
    """The gradients of ``rglru_gated_scan_plain(ya, yx, ba, bx, c, g,
    lam, h, lengths)`` for its output's gradient ``dout`` (B, S, R), with
    ``h0`` the state before the call (the forward advanced ``h`` in place;
    the state after it has no gradient). Returns (dya, dyx) (n_blocks, B·S,
    rb), (dba, dbx) (R,), (dc, dg) (B, S, R) and dlam (R,), each in its
    input's dtype. Sums over rows and steps (dba, dbx, dlam) run in f32.

    The clamp of 1 − a² at 1e-12 passes no gradient where it holds (1 −
    exp(2·log_a) in f32 is 0 or at least 2^-24, so it never ties with the
    floor, where ``jax.grad`` of ``jnp.maximum`` would split it)."""
    b, s, r = c.shape
    n, _, rb = ya.shape
    dt = c.dtype
    f32 = torch.float32

    def ungate(dz):
        return dz.reshape(b * s, n, rb).transpose(0, 1).contiguous()

    gt = _gates(ya, yx, ba, bx, c, lam)
    sa, si, rt, it, lam8, a, e2, keep_raw, sq, cf, ic = (
        gt[k] for k in ("sa", "si", "rt", "it", "lam8", "a", "e2",
                        "keep_raw", "sq", "cf", "ic"))
    hs = rglru_scan_plain(a, sq * ic, h0.clone(), lengths)
    gb = F.gelu(g, approximate="tanh")

    dprod = dout.to(f32)
    dg = gelu_tanh_backward_plain((dprod * hs).to(dt), g)
    dhs = dprod * gb.to(f32)
    # the scan backwards: G_t = dhs_t + the carry; a live step passes a_t·G_t
    live = (torch.arange(s, device=c.device)[None, :]
            < lengths.to(c.device)[:, None])
    hprev = torch.cat([h0[:, None].to(f32), hs[:, :-1]], dim=1)
    carry = torch.zeros((b, r), dtype=f32, device=c.device)
    dgx = torch.zeros_like(dhs)
    for t in range(s - 1, -1, -1):
        gt = dhs[:, t] + carry
        lv = live[:, t, None]
        dgx[:, t] = torch.where(lv, gt, torch.zeros_like(gt))
        carry = torch.where(lv, a[:, t] * gt, gt)
    da = dgx * hprev
    dsq = dgx * ic
    dic = dgx * sq
    dit = dic * cf
    dc = (dic * it).to(dt)
    dkeep = torch.where(keep_raw >= KEEP_MIN, dsq / (2.0 * sq),
                        torch.zeros_like(dsq))
    dlog_a = da * a + (-dkeep * e2) * 2.0
    drt = dlog_a * lam8
    dlam8 = (dlog_a * rt).reshape(-1, r).sum(dim=0)
    dlam = ((dlam8 * -C) / (1.0 + torch.exp(-lam.to(f32)))).to(lam.dtype)
    dza = _sigmoid_backward(drt.to(dt), sa)
    dzx = _sigmoid_backward(dit.to(dt), si)
    dba = dza.reshape(-1, r).sum(dim=0).to(ba.dtype)
    dbx = dzx.reshape(-1, r).sum(dim=0).to(bx.dtype)
    return ungate(dza), ungate(dzx), dba, dbx, dc, dg, dlam
