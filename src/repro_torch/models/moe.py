"""Mixture-of-Experts FFN: top-k routing, capacity-bounded sort-based
dispatch, optional shared experts (DeepSeek-MoE style) — the reference's
``models/moe.py``, step by step.

  1. the f32 router (never quantized), softmax, top-k per token, the k
     probabilities renormalized over the winners;
  2. the (token, slot) assignments sorted by expert id, stably (padding
     rows of a prefill chunk get the overflow id E, after every expert);
  3. per-expert counts, starts, and each assignment's rank in its expert;
  4. the first ``cap`` assignments of each expert gathered into dense
     (E, cap, D) buffers (the rest are dropped);
  5. each expert's FFN (SiLU gate, as the reference's) as one stacked
     product per matrix: ``ternary_matmul_experts`` on the card for
     quantized stacks (one launch, the expert on the grid's z axis), fixed
     128-row batched products for floating-point stacks;
  6. each token's kept contributions summed in ascending expert order,
     each partial sum rounded in the activation dtype, then the shared
     MLP added.

The capacity is per dispatch: cap = max(1, round(T·k/E·cf)) over the T rows
of the call (idle and padding rows included), or T·k when cf <= 0 (no
token is ever dropped). So with cf > 0 a row's output can depend on what
shares its dispatch, as in the reference.

Nothing here syncs the host or makes a shape that depends on the data (the
decode loop is a CUDA graph): counts are a ``scatter_add_`` of ones into
E + 1 bins, the dispatch is a gather from the stable sort, and the combine
is a fixed-order sum (no float atomics: ``index_add_`` on the card would
add a token's contributions in a varying order). Top-k is the first k of a
stable descending sort, so among equal probabilities the lower expert id
comes first, as ``jax.lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.core.quantize_model import QuantizedKernel
from repro_torch.kernels.ternary_matmul.ops import ternary_matmul_experts
from repro_torch.models.common import Dense, bmm_fixed_rows, dense
from repro_torch.models.mlp import MLP


class ExpertDense(nn.Module):
    """E stacked linear maps y[e] = x[e] @ W[e]ᵀ; ``weight`` (E, d_out,
    d_in) floating point, or — after ``quantize_tree`` — stacked packed
    planes (E, d_out, d_in // 4) and scales (E, d_out, d_in // G, 2)."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, *,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        self.n_experts, self.d_in, self.d_out = n_experts, d_in, d_out
        self.weight = nn.Parameter(
            torch.empty((n_experts, d_out, d_in), dtype=dtype, device=device),
            requires_grad=False)
        self.register_buffer("t1p", None)
        self.register_buffer("t2p", None)
        self.register_buffer("alpha", None)
        self.group_size: Optional[int] = None
        #: route of the ternary product, as ``Dense.matmul_backend``
        self.matmul_backend = "auto"

    @property
    def quant(self) -> Optional[QuantizedKernel]:
        if self.t1p is None:
            return None
        return QuantizedKernel(self.t1p, self.t2p, self.alpha, self.d_in,
                               self.d_out, self.group_size)

    def set_quantized(self, qk: QuantizedKernel) -> None:
        """Replace the floating-point stack by its trit-planes."""
        if ((qk.d_in, qk.d_out) != (self.d_in, self.d_out)
                or qk.t1p.shape[0] != self.n_experts):
            raise ValueError("quantized stack does not match the layer")
        self.weight = None
        self.t1p, self.t2p, self.alpha = qk.t1p, qk.t2p, qk.alpha
        self.group_size = qk.group_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, m, d_in) -> (E, m, d_out) in x's dtype."""
        if self.t1p is not None:
            return ternary_matmul_experts(x, self.t1p, self.t2p, self.alpha,
                                          group_size=self.group_size,
                                          out_dtype=x.dtype,
                                          backend=self.matmul_backend)
        return bmm_fixed_rows(x, self.weight.to(x.dtype))


class Experts(nn.Module):
    def __init__(self, n_experts: int, d_model: int, d_expert: int, *,
                 dtype, device):
        super().__init__()
        self.wi = ExpertDense(n_experts, d_model, d_expert, dtype=dtype,
                              device=device)
        self.wg = ExpertDense(n_experts, d_model, d_expert, dtype=dtype,
                              device=device)
        self.wo = ExpertDense(n_experts, d_expert, d_model, dtype=dtype,
                              device=device)

    def forward(self, xe: torch.Tensor) -> torch.Tensor:
        """(E, C, D) -> (E, C, D), each expert's SwiGLU."""
        h = nn.functional.silu(self.wg(xe)) * self.wi(xe)
        return self.wo(h)


class MoE(nn.Module):
    def __init__(self, d_model: int, moe_cfg, mlp_type: str, *, dtype,
                 device):
        super().__init__()
        e, fe = moe_cfg.n_experts, moe_cfg.d_expert
        self.router = Dense(d_model, e, dtype=torch.float32, device=device)
        self.experts = Experts(e, d_model, fe, dtype=dtype, device=device)
        self.shared = (MLP(d_model, moe_cfg.n_shared * fe, mlp_type,
                           dtype=dtype, device=device)
                       if moe_cfg.n_shared else None)


def capacity(t: int, moe_cfg) -> int:
    """Slots per expert of a dispatch of ``t`` rows (Python's ``round``, as
    the reference)."""
    k, e = moe_cfg.top_k, moe_cfg.n_experts
    if moe_cfg.capacity_factor <= 0:
        return t * k  # exact no-drop mode
    return int(max(1, round(t * k / e * moe_cfg.capacity_factor)))


def router_probs(moe: MoE, xf: torch.Tensor) -> torch.Tensor:
    """Softmax of the f32 router logits (T, E). The product runs in the
    fixed 128-row blocks of ``models.common.dense``, so a row's
    probabilities do not depend on its batch."""
    if xf.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MoE router runs in f32: turn TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    return torch.softmax(dense(moe.router, xf.to(torch.float32)), dim=-1)


def dispatch(moe: MoE, moe_cfg, xf: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Routing and dispatch decisions of rows xf (T, D): ``top_p``,
    ``top_e`` (T, k); in the sorted assignment order ``order``, ``se``,
    ``sp``, ``stok``, ``keep``, ``dst`` (T·k,) (the reference's names, the
    overflow slot E·cap for a dropped assignment); ``counts``, ``starts``
    (E,); ``cap``."""
    t = xf.shape[0]
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    dev = xf.device
    probs = router_probs(moe, xf)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    norm = top_p[:, 0]
    for j in range(1, k):
        norm = norm + top_p[:, j]
    top_p = top_p / torch.clamp(norm, min=1e-9)[:, None]

    flat_e = top_e.reshape(-1)
    flat_p = top_p.reshape(-1)
    flat_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    if valid is not None:
        flat_e = torch.where(valid.reshape(t, 1).expand(t, k).reshape(-1),
                             flat_e, torch.full_like(flat_e, e))
    order = torch.sort(flat_e, stable=True).indices
    se, sp, stok = flat_e[order], flat_p[order], flat_tok[order]
    counts = torch.zeros(e + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))[:e]
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=dev) - starts[torch.clamp(se, max=e - 1)]
    cap = capacity(t, moe_cfg)
    keep = (rank < cap) & (se < e)
    dst = torch.where(keep, se * cap + torch.clamp(rank, 0, cap - 1),
                      torch.full_like(se, e * cap))
    return dict(top_p=top_p, top_e=top_e, order=order, se=se, sp=sp,
                stok=stok, keep=keep, dst=dst, counts=counts, starts=starts,
                cap=cap)


def moe_forward(moe: MoE, moe_cfg, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., D) -> (..., D). ``valid`` (x's leading shape) bool marks the
    padding rows of a bucketed prefill chunk: they go to the overflow id, so
    they never take a real token's capacity (their outputs are garbage
    either way). Every row of x counts in the capacity."""
    lead, d = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    e, k = moe_cfg.n_experts, moe_cfg.top_k
    dv = dispatch(moe, moe_cfg, xf, valid)
    cap, counts, starts, stok = dv["cap"], dv["counts"], dv["starts"], \
        dv["stok"]

    # expert ex's slot c holds sorted assignment starts[ex] + c while c is
    # under its count (and cap): a gather, zeros elsewhere
    c = torch.arange(cap, device=x.device)
    src = torch.clamp(starts[:, None] + c[None, :], max=t * k - 1)
    filled = (c[None, :] < counts[:, None])[..., None]
    xe = torch.where(filled, xf[stok[src]], torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
    yf = moe.experts(xe).reshape(e * cap, d)

    # back to (token, slot) order, each token's slots by ascending expert
    inv = torch.empty_like(dv["order"]).scatter_(
        0, dv["order"], torch.arange(t * k, device=x.device))
    dst = dv["dst"][inv].reshape(t, k)
    w = (dv["sp"] * dv["keep"].to(torch.float32))[inv].reshape(t, k)
    se = dv["se"][inv].reshape(t, k)
    asc = torch.sort(se, dim=1, stable=True).indices
    dst, w = torch.gather(dst, 1, asc), torch.gather(w, 1, asc)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + yf[torch.clamp(dst[:, j], max=e * cap - 1)] * \
            w[:, j].to(x.dtype)[:, None]
    if moe.shared is not None:
        y = y + moe.shared(xf)
    return y.reshape(*lead, d)
