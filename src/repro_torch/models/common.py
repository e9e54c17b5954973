"""Shared building blocks: dense layer (with PTQTP dispatch), RMSNorm, RoPE.

``rms_norm`` is the kernel package's (fixed-order on the card, so rows are
batch-invariant).

A ``Dense`` layer holds either a floating-point ``weight`` (d_out, d_in), as
``torch.nn.Linear`` does, or — after ``quantize_tree`` — the two packed
trit-planes and group scales of a ``QuantizedKernel``; ``dense`` dispatches
on which, so every model serves quantized without architectural change. A
floating-point layer runs ``F.linear`` (the reference leaves this product
to XLA, outside any Pallas kernel) in row blocks of one fixed shape, so
its rows are batch-invariant on the card too; ``linear_fixed_rows`` and
``bmm_fixed_rows`` serve the other floating-point products the same way
(the MoE expert stacks, the recurrent blocks' gates and LoRAs).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.device import dtype_of  # noqa: F401  (re-exported)
from repro_torch.kernels.rms_norm.ops import rms_norm
from repro_torch.kernels.ternary_matmul.ops import ternary_matmul


class Dense(nn.Module):
    """y = x @ Wᵀ (+ bias); W floating point or PTQTP-quantized."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight = nn.Parameter(
            torch.empty((d_out, d_in), dtype=dtype, device=device),
            requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(d_out, dtype=dtype, device=device),
                                  requires_grad=False) if bias else None)
        self.register_buffer("t1p", None)
        self.register_buffer("t2p", None)
        self.register_buffer("alpha", None)
        self.group_size: Optional[int] = None
        #: route of the ternary product (``ternary_matmul``'s ``backend``);
        #: a pre-unpacked serving copy asks for "grouped" by name
        self.matmul_backend = "auto"

    @property
    def quant(self) -> Optional[QuantizedKernel]:
        if self.t1p is None:
            return None
        return QuantizedKernel(self.t1p, self.t2p, self.alpha, self.d_in,
                               self.d_out, self.group_size)

    def set_quantized(self, qk: QuantizedKernel) -> None:
        """Replace the floating-point weight by its trit-planes."""
        if (qk.d_in, qk.d_out) != (self.d_in, self.d_out):
            raise ValueError("quantized kernel shape does not match the layer")
        self.weight = None
        self.t1p, self.t2p, self.alpha = qk.t1p, qk.t2p, qk.alpha
        self.group_size = qk.group_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self, x)


#: rows of one GEMM of a floating-point layer on the card (see ``dense``)
DENSE_ROW_BLOCK = 128


def dense(layer: Dense, x: torch.Tensor) -> torch.Tensor:
    if layer.t1p is not None:
        y = ternary_matmul(x, layer.t1p, layer.t2p, layer.alpha,
                           group_size=layer.group_size, out_dtype=x.dtype,
                           backend=layer.matmul_backend)
    else:
        y = linear_fixed_rows(x, layer.weight.to(x.dtype))
    if layer.bias is not None:
        y = y + layer.bias.to(y.dtype)
    return y


def _by_row_blocks(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` on each block of ``DENSE_ROW_BLOCK`` rows of x (rows on dim
    -2, the last block zero-padded), concatenated and cut back to x's
    rows: every row sees one GEMM shape whatever its batch."""
    m, rows = x.shape[-2], DENSE_ROW_BLOCK
    pad = -m % rows
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    y = torch.cat([fn(x[..., i:i + rows, :]) for i in range(0, m + pad, rows)],
                  dim=-2)
    return y[..., :m, :]


class _FixedRows(torch.autograd.Function):
    """y = x @ wᵀ in fixed-row blocks, x (m, d) and w (n, d), or batched
    over experts, x (E, m, d) and w (E, n, d). Its backward keeps dx in the
    same fixed-row blocks but takes dw as ONE GEMM over all m rows, so dw
    is accumulated in f32 and rounded once to w's dtype, as the reference's
    einsum gradient is. (Autograd of the blocked forward would add the
    blocks' dw in w's dtype: m/128 − 1 extra bf16 roundings a weight.)"""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.dim() == 2:
            return _by_row_blocks(
                x, lambda b: torch.nn.functional.linear(b, w))
        wt = w.transpose(1, 2)
        return _by_row_blocks(x, lambda b: torch.bmm(b, wt))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _by_row_blocks(dy, lambda b: b @ w)
        if ctx.needs_input_grad[1]:
            dw = dy.transpose(-1, -2) @ x
        return dx, dw


def linear_fixed_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ wᵀ in GEMMs of one shape. cuBLAS picks its kernel, and with it a
    row's summation order, by the product's m, so a row's bits would depend
    on how many rows share its call (on the card a request alone and in a
    fleet gave other tokens). So x is cut into blocks of
    ``DENSE_ROW_BLOCK`` rows, the last zero-padded, and each block goes
    through ``F.linear`` alone: every row sees the same GEMM whatever its
    batch. Differentiable through ``_FixedRows``."""
    *lead, d = x.shape
    return _FixedRows.apply(x.reshape(-1, d), w).reshape(*lead, w.shape[0])


def bmm_fixed_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stacked products x[e] @ w[e]ᵀ, x (E, m, d), w (E, n, d) -> (E, m, n),
    in batched GEMMs of one shape (the rows cut into zero-padded blocks of
    ``DENSE_ROW_BLOCK``, as ``linear_fixed_rows``): a row's bits do not
    depend on m. The floating-point MoE expert stacks (the reference leaves
    this product to XLA's einsum)."""
    return _FixedRows.apply(x, w)


class RMSNorm(nn.Module):
    def __init__(self, d: int, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rms_norm(self.scale, x, eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of positions (...,) → each (..., 1, hd/2) f32, broadcast
    over heads. Computed once per forward and shared by every layer."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, rope) -> torch.Tensor:
    """x: (..., H, hd) with ``rope = rope_tables(positions (...,), ...)``."""
    cos, sin = rope
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
