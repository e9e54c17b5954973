"""Public wrappers of RMSNorm over the last dim: ``rms_norm``, and
``add_rms_norm``, the residual add and the norm after it in one launch.

On CUDA tensors they launch the hand-written Hopper kernel of
``csrc/rms_norm.cu``, whose per-row reduction order is fixed, so a row's
result does not depend on how many rows share the call (the engine's
determinism contract; ``torch.mean`` on the card does not give that), and
``add_rms_norm``'s norm equals ``rms_norm`` of its sum bit for bit. On CPU
tensors they run the plain versions of ``ref.py``; they never fall back
from a CUDA tensor to them.
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
                                       ctypes.c_float, _P]}
_DTYPES = (torch.float32, torch.bfloat16)


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


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """RMSNorm of x (..., d) with ``scale`` (d,); returns x's dtype."""
    if x.device.type == "cpu":
        return _ref.rms_norm_plain(scale, x, eps)
    *lead, d = x.shape
    return rms_norm_cuda(scale, x.reshape(-1, d).contiguous(), eps).reshape(
        *lead, d)


def add_rms_norm(scale: torch.Tensor, x: torch.Tensor, delta: torch.Tensor,
                 eps: float = 1e-5):
    """The residual add and the RMSNorm after it: (x + delta, RMSNorm of
    x + delta with ``scale``), x and delta (..., d) of one shape and dtype;
    both in x's dtype."""
    if x.device.type == "cpu":
        return _ref.add_rms_norm_plain(scale, x, delta, eps)
    *lead, d = x.shape
    x_new, y = add_rms_norm_cuda(scale, x.reshape(-1, d).contiguous(),
                                 delta.reshape(-1, d).contiguous(), eps)
    return x_new.reshape(*lead, d), y.reshape(*lead, d)
