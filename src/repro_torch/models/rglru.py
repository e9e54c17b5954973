"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
reference's ``repro/models/rglru.py``:

  x_b = W_x·x ;  g_b = gelu(W_g·x)
  c_t = conv1d(x_b)                                 (depthwise, width 4)
  r_t = σ(BD_a(c_t));  i_t = σ(BD_x(c_t))           (block-diagonal gates)
  a_t = exp(−c·softplus(Λ) ⊙ r_t)                   (c = 8)
  h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ c_t)
  y   = W_o (g_b ⊙ h)

``wx``, ``wgate`` and ``wo`` are the port's ``Dense`` (PTQTP-quantized:
B1/B3); the block-diagonal gates are floating-point products in row blocks
of one fixed shape (``bmm_fixed_rows``), so a row's bits do not depend on
its batch. Everything from those products to ``wo``'s input (the gates'
biases and sigmoids, a and its input multiplier, the scan, the GELU of
``wgate`` and the output gate) is one ``rglru_gated_scan`` call: one launch
of the ``rglru_scan`` kernel a layer and call on the card.

The state is (h (B, R) f32, conv (B, W−1, R) in the activation dtype),
updated in place; it never joins the autograd graph (a training forward
differentiates the output, not the state). A chunk's rows are
right-padded: row b's first ``lengths[b]`` steps are real; later steps
leave h unchanged and the conv tail is gathered at each row's length
(length 0 keeps the prior state).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.rglru_scan.ops import rglru_gated_scan
from repro_torch.models.common import Dense, bmm_fixed_rows


class WB(nn.Module):
    """A floating-point weight ``w`` and bias ``b`` (the reference's
    ``{"w", "b"}`` nodes: the conv and the block-diagonal gates)."""

    def __init__(self, w_shape, b_shape, *, dtype, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(w_shape, dtype=dtype, device=device),
                              requires_grad=False)
        self.b = nn.Parameter(torch.zeros(b_shape, dtype=dtype, device=device),
                              requires_grad=False)


class RGLRU(nn.Module):
    def __init__(self, d: int, r: int, n_blocks: int, conv_width: int, *,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        rb = r // n_blocks
        self.n_blocks = n_blocks
        self.wx = Dense(d, r, dtype=dtype, device=device)
        self.wgate = Dense(d, r, dtype=dtype, device=device)
        self.conv = WB((conv_width, r), (r,), dtype=dtype, device=device)
        self.gate_a = WB((n_blocks, rb, rb), (r,), dtype=dtype, device=device)
        self.gate_x = WB((n_blocks, rb, rb), (r,), dtype=dtype, device=device)
        self.lam = nn.Parameter(
            torch.linspace(-4.3, -0.7, r, device=device).to(dtype),
            requires_grad=False)
        self.wo = Dense(r, d, dtype=dtype, device=device)

    @torch.no_grad()
    def init_random(self, normal) -> None:
        """The reference's initializer for the floating-point leaves (not
        its random bits): conv N(0, 0.1²), gates N(0, 1/rb)."""
        rb = self.gate_a.w.shape[-1]
        self.conv.w.copy_(normal(self.conv.w.shape, 0.1))
        self.gate_a.w.copy_(normal(self.gate_a.w.shape, rb ** -0.5))
        self.gate_x.w.copy_(normal(self.gate_x.w.shape, rb ** -0.5))


def _block_products(gate: WB, x: torch.Tensor, n_blocks: int
                    ) -> torch.Tensor:
    """x (..., R) through the block-diagonal weight (n_blocks, rb, rb),
    before the bias: (n_blocks, rows of x, rb)."""
    rb = x.shape[-1] // n_blocks
    xb = x.reshape(-1, n_blocks, rb).transpose(0, 1)          # (n, m, rb)
    return bmm_fixed_rows(xb, gate.w.to(x.dtype).transpose(1, 2))


def rglru_forward(p: RGLRU, x: torch.Tensor, h: torch.Tensor,
                  conv: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) right-padded, row b real for its first ``lengths[b]``
    steps; h (B, R) f32 and conv (B, W−1, R) the state, advanced in place.
    Returns y (B, S, D)."""
    b, s, _ = x.shape
    xb = p.wx(x)
    w = p.conv.w.to(x.dtype)                                   # (W, R)
    width = w.shape[0]
    xp = torch.cat([conv, xb], dim=1)                          # (B, W-1+S, R)
    c = xp[:, 0:s] * w[0]
    for i in range(1, width):
        c = c + xp[:, i:i + s] * w[i]
    c = c + p.conv.b.to(x.dtype)
    # the W-1 inputs ending at each row's length (0: the prior tail)
    idx = (lengths.long()[:, None]
           + torch.arange(width - 1, device=x.device)[None, :])
    conv.copy_(torch.gather(xp.detach(), 1, idx[..., None].expand(
        b, width - 1, xp.shape[-1])))
    y = rglru_gated_scan(_block_products(p.gate_a, c, p.n_blocks),
                         _block_products(p.gate_x, c, p.n_blocks),
                         p.gate_a.b, p.gate_x.b, c, p.wgate(x), p.lam, h,
                         lengths)
    return p.wo(y)
