"""PTQTP: progressive trit-plane approximation with adaptive ridge regression.

The quantizer of the reference package (paper Sec. 3, Alg. 1/2) in plain
PyTorch, running on whatever device holds the weight:

    W ≈ Ŵ = diag(α¹)·T¹ + diag(α²)·T²,  Tᵏ ∈ {-1,0,1},  α ∈ R²  per group-row.

Semantics kept from the reference: sign init (0 → +1), α = 1 and λ = λ₀ at
start; each iteration refits α by the 2×2 ridge solve with the
condition-number-driven λ growth, then re-picks every trit pair by the
9-candidate search (first candidate in ``CANDIDATES`` order wins ties, a
strict ``<``); the loop stops per matrix when ``max_i ||Δα_i|| < eps`` or
after ``t_max`` iterations, and ends with a final α refit. A stack of
matrices (a MoE layer's experts, ``ptqtp_quantize_stack``) runs at once,
each matrix stopping on its own; a single matrix is a stack of one.

The search (``kernels/ptqtp_search``) is 9 compare-selects over
preallocated planes, walked in row chunks so that a 151936×1536
``lm_head`` needs a few of its own sizes of scratch, never an (R, G, 9)
error tensor. Each chunk goes through the search op, which launches the
Hopper kernel (B6) on CUDA tensors and runs the plain walk on CPU ones;
both give the same planes. (The reference's ``use_search_kernel`` picks
its Pallas kernel or XLA; here the device of the weight decides.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ptqtp_search import ops as search_ops
from repro_torch.kernels.ptqtp_search.ref import CANDIDATES

__all__ = ["CANDIDATES", "PTQTPConfig", "QuantizedTensor", "ptqtp_quantize",
           "ptqtp_quantize_stack", "ptqtp_dequantize", "ptqtp_error",
           "quantize_with_history"]

# Group-rows per search chunk: 2^20 rows of G = 128 is 512 MiB of f32.
_CHUNK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class PTQTPConfig:
    """Hyper-parameters of the PTQTP quantizer (paper Sec. 4.1 defaults)."""

    group_size: int = 128
    t_max: int = 50
    eps: float = 1e-4
    lambda_init: float = 1e-8
    lambda_max: float = 1.0
    cond_bound: float = 1e12

    def __post_init__(self):
        if self.group_size < 2 or self.t_max < 1:
            raise ValueError("group_size must be >= 2 and t_max >= 1")


@dataclasses.dataclass
class QuantizedTensor:
    """t1, t2: int8 planes (n, d); alpha: f32 (n, d // G, 2); iters: int."""

    t1: torch.Tensor
    t2: torch.Tensor
    alpha: torch.Tensor
    group_size: int
    iters: int


def _ridge_sums(t1, t2, w):
    """The five per-row sums of the 2×2 normal equations."""
    return ((t1 * t1).sum(-1), (t1 * t2).sum(-1), (t2 * t2).sum(-1),
            (t1 * w).sum(-1), (t2 * w).sum(-1))


def _ridge_solve(sums, lam):
    """Closed-form 2×2 ridge solve per group-row (Eq. 1/6 + adjugate Eq. 7).

    Returns alpha (R, 2) and kappa (R,), κ = ||A||_F² / |det A| (Eq. 2).
    """
    s11, s12, s22, b1, b2 = sums
    a11 = s11 + lam
    a22 = s22 + lam
    det = a11 * a22 - s12 * s12
    fro2 = a11 * a11 + a22 * a22 + 2.0 * s12 * s12
    kappa = fro2 / torch.clamp(det.abs(), min=1e-30)
    inv_det = 1.0 / torch.where(det.abs() < 1e-30,
                                torch.full_like(det, 1e-30), det)
    alpha1 = (a22 * b1 - s12 * b2) * inv_det
    alpha2 = (-s12 * b1 + a11 * b2) * inv_det
    return torch.stack([alpha1, alpha2], dim=-1), kappa


def _trit_search(w, alpha, t1, t2):
    """Per-element search over the 9 pairs (Eq. 5), written into
    ``t1``/``t2``, in row chunks through the search op. w (R, G) f32;
    alpha (R, 2) f32; t1, t2 (R, G) f32 outputs."""
    rows = max(1, _CHUNK_ELEMS // max(w.shape[1], 1))
    for r0 in range(0, w.shape[0], rows):
        sl = slice(r0, r0 + rows)
        search_ops.ptqtp_search(w[sl], alpha[sl], out=(t1[sl], t2[sl]))


def _quantize_grouped(wg: torch.Tensor, cfg: PTQTPConfig, *,
                      errors: Optional[list] = None, refit: bool = True):
    """Alg. 1/2 on the group-rows wg (S, R, G) of S matrices at once, each
    matrix stopping on its own (the reference vmaps its quantizer over a
    stack's leading axes, and a batched ``while_loop`` freezes a finished
    matrix's carry): a matrix's iterations, sums and searches are those of
    a call on it alone, and once it stops its planes, α and λ stay as they
    were. One host sync an iteration for the whole stack.

    ``errors`` (a list) receives each matrix's ||W − Ŵ||_F (S,) after the
    sign init with α = [1, 1] and after each iteration's search, measured
    with that iteration's α. ``refit=False`` skips the final α refit: α is
    the last iteration's.

    Returns (t1, t2, alpha, iters (S,))."""
    wg = wg.to(torch.float32).contiguous()
    S, R, G = wg.shape
    dev = wg.device
    t1 = torch.where(wg >= 0.0, 1.0, -1.0)
    t2 = t1.clone()
    alpha = torch.ones((S, R, 2), dtype=torch.float32, device=dev)
    lam = torch.full((S, R), cfg.lambda_init, dtype=torch.float32,
                     device=dev)
    active = torch.ones((S,), dtype=torch.bool, device=dev)
    iters = torch.zeros((S,), dtype=torch.int64, device=dev)
    n_active, spare = S, None

    def record(alpha):
        if errors is not None:
            diff = wg - (t1 * alpha[..., 0:1] + t2 * alpha[..., 1:2])
            errors.append(torch.linalg.vector_norm(diff.reshape(S, -1),
                                                   dim=-1))

    record(alpha)
    for _ in range(cfg.t_max):
        sums = _ridge_sums(t1, t2, wg)
        _, kappa = _ridge_solve(sums, lam)
        lam_new = torch.where(
            kappa >= cfg.cond_bound,
            torch.clamp(lam * torch.sqrt(kappa / cfg.cond_bound),
                        max=cfg.lambda_max),
            lam)
        alpha_new, _ = _ridge_solve(sums, lam_new)
        delta = torch.sqrt(((alpha_new - alpha) ** 2).sum(-1)).amax(-1)
        if n_active == S:  # every matrix steps: search in place
            out = (t1, t2)
        else:              # finished matrices keep their planes
            spare = spare or (torch.empty_like(t1), torch.empty_like(t2))
            out = spare
        _trit_search(wg.reshape(S * R, G), alpha_new.reshape(S * R, 2),
                     out[0].reshape(S * R, G), out[1].reshape(S * R, G))
        if n_active < S:
            on = active[:, None, None]
            t1 = torch.where(on, out[0], t1)
            t2 = torch.where(on, out[1], t2)
        record(alpha_new)
        alpha = torch.where(active[:, None, None], alpha_new, alpha)
        lam = torch.where(active[:, None], lam_new, lam)
        iters += active
        active = active & ~(delta < cfg.eps)
        n_active = int(active.sum())
        if not n_active:
            break
    if refit:
        alpha, _ = _ridge_solve(_ridge_sums(t1, t2, wg), lam)
    return t1.to(torch.int8), t2.to(torch.int8), alpha, iters


def ptqtp_quantize_stack(w: torch.Tensor, cfg: Optional[PTQTPConfig] = None
                         ) -> QuantizedTensor:
    """Quantize a stack of S weights (S, n, d) at once, each as
    ``ptqtp_quantize`` quantizes it alone (its own stopping). Returns
    planes (S, n, d), alpha (S, n, d // G, 2) and ``iters`` the most any
    matrix ran."""
    cfg = cfg or PTQTPConfig()
    if w.dim() != 3:
        raise ValueError(f"ptqtp_quantize_stack expects (S, n, d), got "
                         f"{tuple(w.shape)}")
    S, n, d = w.shape
    g = cfg.group_size
    if d % g:
        raise ValueError(f"last dim {d} not divisible by group size {g}")
    t1, t2, alpha, iters = _quantize_grouped(
        w.reshape(S, n * (d // g), g), cfg)
    return QuantizedTensor(t1.reshape(S, n, d), t2.reshape(S, n, d),
                           alpha.reshape(S, n, d // g, 2), g,
                           int(iters.max()) if S else 0)


def ptqtp_quantize(w: torch.Tensor,
                   cfg: Optional[PTQTPConfig] = None) -> QuantizedTensor:
    """Quantize a 2-D weight (n, d) to two trit-planes + group scales."""
    cfg = cfg or PTQTPConfig()
    if w.dim() != 2:
        raise ValueError(f"ptqtp_quantize expects a 2-D matrix, got "
                         f"{tuple(w.shape)}")
    q = ptqtp_quantize_stack(w[None], cfg)
    return QuantizedTensor(q.t1[0], q.t2[0], q.alpha[0], q.group_size,
                           q.iters)


def ptqtp_dequantize(q: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Ŵ = diag(α¹)T¹ + diag(α²)T² with group-wise α."""
    n, d = q.t1.shape
    g = q.group_size
    t1 = q.t1.reshape(n, d // g, g).to(torch.float32)
    t2 = q.t2.reshape(n, d // g, g).to(torch.float32)
    a = q.alpha.to(torch.float32)
    return (t1 * a[..., 0:1] + t2 * a[..., 1:2]).reshape(n, d).to(dtype)


def ptqtp_error(w: torch.Tensor, q: QuantizedTensor) -> torch.Tensor:
    """Relative Frobenius error ||W − Ŵ||_F / max(||W||_F, 1e-30), a 0-d
    f32 tensor on w's device."""
    w = w.to(torch.float32)
    return torch.linalg.norm(w - ptqtp_dequantize(q)) / torch.clamp(
        torch.linalg.norm(w), min=1e-30)


def quantize_with_history(w: torch.Tensor,
                          cfg: Optional[PTQTPConfig] = None):
    """The quantizer's iterations, recording the error after each (the
    reference's unrolled variant: its monotonicity test and the Fig. 3
    ablation). Returns (q, errors (t + 1,)): errors[0] is ||W − Ŵ||_F after
    the sign init with α = [1, 1], errors[i] after iteration i (the ridge
    solves, then the trit search, measured with that iteration's α).

    The iterations, their stop (one host sync each) and the planes are
    ``ptqtp_quantize``'s (the same loop); unlike it, no final α refit:
    ``q.alpha`` is the last iteration's α. On the card the trit step is
    the search kernel (B6)."""
    cfg = cfg or PTQTPConfig()
    if w.dim() != 2:
        raise ValueError(f"quantize_with_history expects a 2-D matrix, got "
                         f"{tuple(w.shape)}")
    n, d = w.shape
    g = cfg.group_size
    if d % g:
        raise ValueError(f"last dim {d} not divisible by group size {g}")
    errors: list = []
    t1, t2, alpha, iters = _quantize_grouped(
        w.reshape(1, n * (d // g), g), cfg, errors=errors, refit=False)
    q = QuantizedTensor(t1.reshape(n, d), t2.reshape(n, d),
                        alpha.reshape(n, d // g, 2), g, int(iters[0]))
    return q, torch.cat(errors)
