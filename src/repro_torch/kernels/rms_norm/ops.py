"""Public wrappers of RMSNorm over the last dim: ``rms_norm``, and
``add_rms_norm``, the residual add and the norm after it in one launch.

On CUDA tensors they launch the hand-written Hopper kernel of
``csrc/rms_norm.cu``, whose per-row reduction order is fixed, so a row's
result does not depend on how many rows share the call (the engine's
determinism contract; ``torch.mean`` on the card does not give that), and
``add_rms_norm``'s norm equals ``rms_norm`` of its sum bit for bit. On CPU
tensors they run the plain versions of ``ref.py``; they never fall back
from a CUDA tensor to them.

Both are differentiable (training): where grad mode is on and x, delta
or scale requires grad, they run through ``torch.autograd.Function``s
whose backward is the kernel's backward (``rms_norm_backward_cuda``:
dx, and dscale summed in a fixed order, no float atomics, so a training
run is bit-reproducible) on a CUDA tensor and the plain backward written
out (``ref.rms_norm_backward_plain``) on any other (CPU, meta). ``add_rms_norm``'s
backward takes the gradients of both its outputs (either may be None:
the last norm's residual stream is unused) and returns one dsum for x
and delta.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rms_norm import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "rms_norm.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rms_norm_launch": [_P, _I, _P, _I, _P, _I, _I,
                                   ctypes.c_float, _P],
               "add_rms_norm_launch": [_P, _P, _I, _P, _I, _P, _P, _I, _I,
                                       ctypes.c_float, _P],
               "rms_norm_bwd_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P,
                                       _I, _I, _I, _I, ctypes.c_float, _P]}
_DTYPES = (torch.float32, torch.bfloat16)
# the backward's tiling: rows a block (4096 rows are 128 blocks on the
# card's 132 SMs), and at most 8 warps a block, as many as fit their rows
# of d f32 dscale sums in the shared-memory budget
BWD_TILE_ROWS = 32
BWD_MAX_WARPS = 8
BWD_SMEM_BUDGET = 128 * 1024


def backward_tiling(rows: int, d: int):
    """(warps a block, rows a block, blocks) of the backward kernel for
    ``rows`` rows of width ``d``: the order of its dscale sums depends on
    these alone, so on (rows, d) only."""
    warps = max(1, min(BWD_MAX_WARPS, BWD_SMEM_BUDGET // (4 * d)))
    return warps, BWD_TILE_ROWS, -(-rows // BWD_TILE_ROWS)


def _check(scale, x, **more):
    """Raise unless x (rows, d) and ``more`` (x's shape and dtype) are
    contiguous, 16-byte aligned f32 or bf16 tensors on one card and scale
    a (d,) f32 or bf16 one there; returns (rows, d)."""
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"x and scale must be float32 or bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    for name, t in more.items():
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {tuple(x.shape)} {x.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if d % (16 // x.element_size()):
        raise ValueError(f"d={d} must fill whole 16-byte vectors")
    for name, t in (("x", x), ("scale", scale), *more.items()):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernel reads in 16-byte vectors
            raise ValueError(f"{name} must be 16-byte aligned")
    return rows, d


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def rms_norm_cuda(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """The Hopper kernel: x (rows, d) contiguous on the card, f32 or bf16;
    scale (d,) f32 or bf16. Returns (rows, d) in x's dtype."""
    rows, d = _check(scale, x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.rms_norm_launch(
        x.data_ptr(), _bf16(x), scale.data_ptr(), _bf16(scale), y.data_ptr(),
        rows, d, float(eps), stream)
    _build.check(status, "rms_norm_launch")
    _build.count("rms_norm")
    return y


def add_rms_norm_cuda(scale: torch.Tensor, x: torch.Tensor,
                      delta: torch.Tensor, eps: float = 1e-5):
    """The Hopper kernel, fused: x and delta (rows, d) contiguous on the
    card in one dtype, f32 or bf16; scale (d,) f32 or bf16. Returns
    (x + delta, rms_norm(x + delta)), both (rows, d) in x's dtype."""
    rows, d = _check(scale, x, delta=delta)
    x_new, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return x_new, y
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.add_rms_norm_launch(
        x.data_ptr(), delta.data_ptr(), _bf16(x), scale.data_ptr(),
        _bf16(scale), x_new.data_ptr(), y.data_ptr(), rows, d, float(eps),
        stream)
    _build.check(status, "add_rms_norm_launch")
    _build.count("add_rms_norm")
    return x_new, y


def rms_norm_backward_cuda(scale: torch.Tensor, x: torch.Tensor,
                           dy: torch.Tensor, eps: float = 1e-5,
                           dres=None):
    """The Hopper backward kernel: x (the norm's input) and dy (its
    output's gradient) (rows, d) contiguous on the card in one dtype, f32
    or bf16; scale (d,); ``dres`` (x's shape and dtype) the gradient of
    add_rms_norm's x + delta, or None. Returns (dx (+ dres) in x's dtype,
    dscale in scale's dtype). Two launches: the rows in tiles of
    ``backward_tiling``, x, dy and dres read once, with each tile's f32
    partial of dscale; then the partials' sum in tile order."""
    more = {"dy": dy} if dres is None else {"dy": dy, "dres": dres}
    rows, d = _check(scale, x, **more)
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    lib = _build.load(_SOURCE, _SIGNATURES)
    warps, tile, blocks = backward_tiling(rows, d)
    dscale = torch.empty_like(scale)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.rms_norm_bwd_launch(
        x.data_ptr(), dy.data_ptr(), 0 if dres is None else dres.data_ptr(),
        _bf16(x), scale.data_ptr(), _bf16(scale), dx.data_ptr(),
        dscale.data_ptr(), partial.data_ptr(), rows, d, tile, warps,
        float(eps), stream)
    _build.check(status, "rms_norm_bwd_launch")
    _build.count("rms_norm_bwd" if dres is None else "add_rms_norm_bwd")
    return dx, dscale


def rms_norm_backward(scale: torch.Tensor, x: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-5, dres=None):
    """(dx (+ dres), dscale) of the norm of x (..., d) for its output's
    gradient dy: the kernel on a CUDA tensor, the plain backward on a CPU
    one."""
    if not x.is_cuda:
        return _ref.rms_norm_backward_plain(scale, x, dy, eps, dres)
    *lead, d = x.shape
    flat = lambda t: t.reshape(-1, d).contiguous()  # noqa: E731
    dx, dscale = rms_norm_backward_cuda(
        scale, flat(x), flat(dy), eps, None if dres is None else flat(dres))
    return dx.reshape(*lead, d), dscale


def _rms_norm_forward(scale, x, eps):
    if not x.is_cuda:
        return _ref.rms_norm_plain(scale, x, eps)
    *lead, d = x.shape
    return rms_norm_cuda(scale, x.reshape(-1, d).contiguous(), eps).reshape(
        *lead, d)


def _add_rms_norm_forward(scale, x, delta, eps):
    if not x.is_cuda:
        return _ref.add_rms_norm_plain(scale, x, delta, eps)
    *lead, d = x.shape
    x_new, y = add_rms_norm_cuda(scale, x.reshape(-1, d).contiguous(),
                                 delta.reshape(-1, d).contiguous(), eps)
    return x_new.reshape(*lead, d), y.reshape(*lead, d)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, x, eps):
        ctx.save_for_backward(scale, x)
        ctx.eps = eps
        return _rms_norm_forward(scale, x, eps)

    @staticmethod
    def backward(ctx, dy):
        scale, x = ctx.saved_tensors
        dx, dscale = rms_norm_backward(scale, x, dy, ctx.eps)
        return dscale, dx, None


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scale, x, delta, eps):
        ctx.set_materialize_grads(False)
        x_new, y = _add_rms_norm_forward(scale, x, delta, eps)
        ctx.save_for_backward(scale, x_new)
        ctx.eps = eps
        return x_new, y

    @staticmethod
    def backward(ctx, dres, dy):
        if dy is None:  # the norm's output unused: the add's gradient alone
            return None, dres, dres, None
        scale, x_new = ctx.saved_tensors
        dsum, dscale = rms_norm_backward(scale, x_new, dy, ctx.eps, dres)
        return dscale, dsum, dsum, None


def _tracked(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """RMSNorm of x (..., d) with ``scale`` (d,); returns x's dtype."""
    if _tracked(scale, x):
        return _RMSNorm.apply(scale, x, eps)
    return _rms_norm_forward(scale, x, eps)


def add_rms_norm(scale: torch.Tensor, x: torch.Tensor, delta: torch.Tensor,
                 eps: float = 1e-5):
    """The residual add and the RMSNorm after it: (x + delta, RMSNorm of
    x + delta with ``scale``), x and delta (..., d) of one shape and dtype;
    both in x's dtype."""
    if _tracked(scale, x, delta):
        return _AddRMSNorm.apply(scale, x, delta, eps)
    return _add_rms_norm_forward(scale, x, delta, eps)
