"""Public wrapper of the RG-LRU scan (``repro/models/rglru.py::_lru_scan``).

On CUDA tensors it launches the hand-written Hopper kernel of
``csrc/rglru_scan.cu`` (one thread per row and channel, sequential in
time, a fixed order and rounding); on CPU tensors it runs the plain loop
of ``ref.py``. It never falls back from a CUDA tensor to it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "rglru_scan.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"rglru_scan_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P]}


def rglru_scan_cuda(a: torch.Tensor, gx: torch.Tensor, h: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """The Hopper kernel: a, gx (B, S, R) f32 and h (B, R) f32, contiguous
    on one card; lengths (B,) int32. Updates h in place; returns the states
    (B, S, R) f32."""
    if a.dim() != 3 or gx.shape != a.shape:
        raise ValueError(f"a and gx must be one (B, S, R) shape, got "
                         f"{tuple(a.shape)} and {tuple(gx.shape)}")
    b, s, r = a.shape
    if tuple(h.shape) != (b, r) or tuple(lengths.shape) != (b,):
        raise ValueError(f"h must be ({b}, {r}) and lengths ({b},), got "
                         f"{tuple(h.shape)} and {tuple(lengths.shape)}")
    for name, t, dt in (("a", a, torch.float32), ("gx", gx, torch.float32),
                        ("h", h, torch.float32),
                        ("lengths", lengths, torch.int32)):
        if not t.is_cuda or t.device != a.device:
            raise ValueError(f"{name} must be a CUDA tensor on {a.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hs = torch.empty_like(a)
    if a.numel() == 0:
        return hs
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = lib.rglru_scan_launch(a.data_ptr(), gx.data_ptr(), h.data_ptr(),
                                   lengths.data_ptr(), hs.data_ptr(), b, s, r,
                                   stream)
    _build.check(status, "rglru_scan_launch")
    _build.count("rglru_scan")
    return hs


def rglru_scan(a: torch.Tensor, gx: torch.Tensor, h: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t-1} + gx_t for t < lengths[b] (h carried after);
    h updated in place to the last state. Returns (B, S, R) f32."""
    if a.device.type == "cpu":
        return _ref.rglru_scan_plain(a, gx, h, lengths)
    return rglru_scan_cuda(a.contiguous(), gx.contiguous(), h,
                           lengths.to(torch.int32).contiguous())
