"""Plain PyTorch version of the PTQTP ternary matmul.

The grouped formula of the reference package (``kernels/ternary_matmul/
ops.py::_grouped``): α scales per-group partial sums, in f32,

  y[b, n] = Σ_g α¹[n,g]·(Σ_{j∈g} x[b,j]·T¹[n,j]) + α²[n,g]·(Σ_{j∈g} x[b,j]·T²[n,j])

It is what the wrapper runs for CPU tensors, and what the CUDA kernels are
held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import unpack_trits


def ternary_matmul_grouped(x, t1p, t2p, alpha, group_size: int = 128):
    """x (..., d); packed planes (n, d//4) uint8; alpha (n, d//G, 2).

    Returns (..., n) float32."""
    *lead, d = x.shape
    n = t1p.shape[0]
    g = group_size
    ng = d // g
    xf = x.reshape(-1, ng, g).to(torch.float32)
    t1 = unpack_trits(t1p).reshape(n, ng, g).to(torch.float32)
    t2 = unpack_trits(t2p).reshape(n, ng, g).to(torch.float32)
    p1 = torch.einsum("bgk,ngk->bgn", xf, t1)
    p2 = torch.einsum("bgk,ngk->bgn", xf, t2)
    a = alpha.to(torch.float32)
    y = torch.einsum("bgn,ng->bn", p1, a[..., 0]) + torch.einsum(
        "bgn,ng->bn", p2, a[..., 1])
    return y.reshape(*lead, n)


def ternary_matmul_experts(x, t1p, t2p, alpha, group_size: int = 128):
    """E stacked products, expert by expert: x (E, m, d); planes (E, n,
    d//4); alpha (E, n, d//G, 2). Returns (E, m, n) float32."""
    return torch.stack([ternary_matmul_grouped(x[e], t1p[e], t2p[e], alpha[e],
                                               group_size)
                        for e in range(x.shape[0])])
