"""Plain PyTorch version of the PTQTP ternary matmul.

The grouped formula of the reference package (``kernels/ternary_matmul/
ops.py::_grouped``): α scales per-group partial sums, in f32,

  y[b, n] = Σ_g α¹[n,g]·(Σ_{j∈g} x[b,j]·T¹[n,j]) + α²[n,g]·(Σ_{j∈g} x[b,j]·T²[n,j])

The plane dtype tags the storage, as in the reference: uint8 planes are
packed (4 trits a byte), int8 planes hold raw trits (``preunpack_decode``'s
copy), used as they are. Both forms give the same bits.

It is what the wrapper runs for CPU tensors and for int8 planes, and what
the CUDA kernels are held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packing import unpack_trits


def _trits(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int8 else unpack_trits(t)


def ternary_matmul_grouped(x, t1p, t2p, alpha, group_size: int = 128,
                           row_block: Optional[int] = None):
    """x (..., d); planes (n, d//4) uint8 packed or (n, d) int8 raw; alpha
    (n, d//G, 2). With ``row_block`` the rows of x go through the products
    in zero-padded blocks of that many rows, so every product has one
    shape whatever m (a row's bits do not depend on its batch on the
    card). Returns (..., n) float32."""
    *lead, d = x.shape
    n = t1p.shape[0]
    g = group_size
    ng = d // g
    xf = x.reshape(-1, ng, g).to(torch.float32)
    t1 = _trits(t1p).reshape(n, ng, g).to(torch.float32)
    t2 = _trits(t2p).reshape(n, ng, g).to(torch.float32)
    a = alpha.to(torch.float32)

    def rows(xb):
        p1 = torch.einsum("bgk,ngk->bgn", xb, t1)
        p2 = torch.einsum("bgk,ngk->bgn", xb, t2)
        return torch.einsum("bgn,ng->bn", p1, a[..., 0]) + torch.einsum(
            "bgn,ng->bn", p2, a[..., 1])

    if row_block is None:
        y = rows(xf)
    else:
        m = xf.shape[0]
        pad = -m % row_block
        if pad:
            xf = torch.cat([xf, xf.new_zeros((pad, ng, g))])
        y = torch.cat([rows(xf[i:i + row_block])
                       for i in range(0, m + pad, row_block)])[:m]
    return y.reshape(*lead, n)


def ternary_matmul_experts(x, t1p, t2p, alpha, group_size: int = 128,
                           row_block: Optional[int] = None):
    """E stacked products, expert by expert: x (E, m, d); planes (E, n,
    d//4) uint8 or (E, n, d) int8; alpha (E, n, d//G, 2). Returns (E, m, n)
    float32."""
    return torch.stack([ternary_matmul_grouped(x[e], t1p[e], t2p[e], alpha[e],
                                               group_size, row_block)
                        for e in range(x.shape[0])])
