"""RWKV6 "Finch" block (arXiv:2404.05892), the reference's
``repro/models/rwkv6.py``:

  time-mix:
    ddlerp token shift    x_j = x + (shift(x) − x) ⊙ (μ_j + lora_j(x))
    projections           r, k, v, g  (D→D);  g gated with SiLU
    data-dependent decay  w_t = exp(−exp(w0 + tanh(x_w W_a) W_b))  per channel
    per-head WKV state    S_t = diag(w_t) S_{t−1} + k_t v_tᵀ      (hd × hd)
    readout               y_t = r_tᵀ (S_{t−1} + diag(u) k_t v_tᵀ)
    group-norm over heads, ⊙ g, output projection.

  channel-mix:
    k = relu(x_k W_k)²;  y = σ(x_r W_r) ⊙ (k W_v)

The projections are the port's ``Dense`` (PTQTP-quantized: B1/B3); the
token-shift and decay LoRAs are floating-point products in row blocks of
one fixed shape (``bmm_fixed_rows`` / ``linear_fixed_rows``), so a row's
bits do not depend on its batch; the WKV and its group norm run on the
``wkv6`` kernel.

The state is (x_time (B, D), wkv (B, H, hd, hd) f32) for the time mix and
x_chan (B, D) for the channel mix, updated in place; it never joins the
autograd graph (a training forward differentiates the output, not the
state). A chunk's rows are right-padded: row b's first ``lengths[b]``
steps are real; later steps leave the WKV state unchanged, and the shift
states are taken at each row's last real step (length 0 keeps the prior
state).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.common import Dense, bmm_fixed_rows, linear_fixed_rows

MIX_NAMES = ("w", "k", "v", "r", "g")
LORA_R = 32       # token-shift lora rank
DECAY_R = 64      # decay lora rank


def _param(shape, dtype, device, fill=0.0):
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device),
                        requires_grad=False)


class LnX(nn.Module):
    """The group norm's ``scale`` (the reference's ``ln_x`` node)."""

    def __init__(self, d: int, *, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device, 1.0)


class RWKVTime(nn.Module):
    def __init__(self, d: int, head_dim: int, *, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        h = d // head_dim
        n = len(MIX_NAMES)
        self.head_dim = head_dim
        self.mu_x = _param((d,), dtype, device)
        self.mu = _param((n, d), dtype, device)
        self.mix_lora_a = _param((d, n * LORA_R), dtype, device)
        self.mix_lora_b = _param((n, LORA_R, d), dtype, device)
        self.decay_base = nn.Parameter(
            torch.linspace(-6.0, -1.0, d, device=device).to(dtype),
            requires_grad=False)
        self.decay_lora_a = _param((d, DECAY_R), dtype, device)
        self.decay_lora_b = _param((DECAY_R, d), dtype, device)
        self.u = _param((h, head_dim), dtype, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, Dense(d, d, dtype=dtype, device=device))
        self.ln_x = LnX(d, dtype=dtype, device=device)

    @torch.no_grad()
    def init_random(self, normal) -> None:
        """The reference's initializer for the floating-point leaves (not
        its random bits): LoRAs N(0, 0.01²), u N(0, 0.1²)."""
        for t in (self.mix_lora_a, self.mix_lora_b, self.decay_lora_a,
                  self.decay_lora_b):
            t.copy_(normal(t.shape, 0.01))
        self.u.copy_(normal(self.u.shape, 0.1))


class RWKVChannel(nn.Module):
    def __init__(self, d: int, d_ff: int, *, dtype=torch.float32,
                 device="cpu"):
        super().__init__()
        self.mu_k = _param((d,), dtype, device)
        self.mu_r = _param((d,), dtype, device)
        self.wk = Dense(d, d_ff, dtype=dtype, device=device)
        self.wv = Dense(d_ff, d, dtype=dtype, device=device)
        self.wr = Dense(d, d, dtype=dtype, device=device)


def _shifted(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every step: the state's last x, then x[:, :-1]."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def masked_last(x: torch.Tensor, prev: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
    """Each row's x at its last real step (B, ...); rows of length 0 keep
    ``prev``. A gather, so no shape depends on the data."""
    b = x.shape[0]
    idx = torch.clamp(lengths.long() - 1, min=0)
    last = x[torch.arange(b, device=x.device), idx]
    live = (lengths > 0).reshape((-1,) + (1,) * (last.dim() - 1))
    return torch.where(live, last, prev.to(last.dtype))


def _ddlerp(p: RWKVTime, x, x_prev):
    """Data-dependent token shift (B, S, D) -> {name: mixed input}."""
    b, s, d = x.shape
    n = len(MIX_NAMES)
    sx = x_prev - x
    xx = x + sx * p.mu_x.to(x.dtype)
    a = torch.tanh(linear_fixed_rows(xx, p.mix_lora_a.to(x.dtype).t()))
    a = a.reshape(b * s, n, LORA_R).transpose(0, 1)          # (n, m, r)
    adj = bmm_fixed_rows(a, p.mix_lora_b.to(x.dtype).transpose(1, 2))
    adj = adj.transpose(0, 1).reshape(b, s, n, d)
    return {name: x + sx * (p.mu[i].to(x.dtype) + adj[:, :, i])
            for i, name in enumerate(MIX_NAMES)}


def _decay(p: RWKVTime, xw):
    """Per-token per-channel decay w_t ∈ (0, 1), f32."""
    lo = linear_fixed_rows(xw, p.decay_lora_a.to(xw.dtype).t())
    lo = linear_fixed_rows(torch.tanh(lo), p.decay_lora_b.to(xw.dtype).t())
    return torch.exp(-torch.exp(p.decay_base.to(torch.float32)
                                + lo.to(torch.float32)))


def rwkv_time_forward(p: RWKVTime, x: torch.Tensor, x_time: torch.Tensor,
                      wkv_state: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) right-padded; x_time (B, D) and wkv_state (B, H, hd,
    hd) f32 the state, advanced in place. Returns y (B, S, D)."""
    b, s, d = x.shape
    hd = p.head_dim
    h = d // hd
    m = _ddlerp(p, x, _shifted(x, x_time))
    r = p.wr(m["r"]).reshape(b, s, h, hd)
    k = p.wk(m["k"]).reshape(b, s, h, hd)
    v = p.wv(m["v"]).reshape(b, s, h, hd)
    g = F.silu(p.wg(m["g"]))
    w = _decay(p, m["w"]).reshape(b, s, h, hd)
    y = wkv6(r, k, v, w, p.u, wkv_state, lengths, p.ln_x.scale) * g
    x_time.copy_(masked_last(x.detach(), x_time, lengths))
    return p.wo(y)


def rwkv_channel_forward(p: RWKVChannel, x: torch.Tensor,
                         x_chan: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) right-padded; x_chan (B, D) the shift state, advanced in
    place. Returns y (B, S, D)."""
    sx = _shifted(x, x_chan) - x
    xk = x + sx * p.mu_k.to(x.dtype)
    xr = x + sx * p.mu_r.to(x.dtype)
    k = torch.square(torch.relu(p.wk(xk)))
    y = torch.sigmoid(p.wr(xr)) * p.wv(k)
    x_chan.copy_(masked_last(x.detach(), x_chan, lengths))
    return y
