"""Public wrapper of RMSNorm over the last dim.

On a CUDA tensor it launches the hand-written Hopper kernel of
``csrc/rms_norm.cu``, whose per-row reduction order is fixed, so a row's
result does not depend on how many rows share the call (the engine's
determinism contract; ``torch.mean`` on the card does not give that). On a
CPU tensor it runs the plain formula of ``ref.py``; it never falls back
from a CUDA tensor to it.
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
                                   ctypes.c_float, _P]}
_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm_cuda(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """The Hopper kernel: x (rows, d) contiguous on the card, f32 or bf16;
    scale (d,) f32 or bf16. Returns (rows, d) in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, d), got {tuple(x.shape)}")
    rows, d = x.shape
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"x and scale must be float32 or bfloat16, got "
                        f"{x.dtype} and {scale.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale must be ({d},), got {tuple(scale.shape)}")
    if d % (16 // x.element_size()):
        raise ValueError(f"d={d} must fill whole 16-byte vectors")
    for name, t in (("x", x), ("scale", scale)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % 16:  # the kernel reads rows in 16-byte vectors
        raise ValueError("x must be 16-byte aligned")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.rms_norm_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), scale.data_ptr(),
        int(scale.dtype == torch.bfloat16), y.data_ptr(), rows, d, float(eps),
        stream)
    _build.check(status, "rms_norm_launch")
    _build.LAUNCHES["rms_norm"] += 1
    return y


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """RMSNorm of x (..., d) with ``scale`` (d,); returns x's dtype."""
    if x.device.type == "cpu":
        return _ref.rms_norm_plain(scale, x, eps)
    *lead, d = x.shape
    return rms_norm_cuda(scale, x.reshape(-1, d).contiguous(), eps).reshape(
        *lead, d)
