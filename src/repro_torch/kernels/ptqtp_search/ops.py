"""Public wrapper of the fused trit search.

``ptqtp_search(w (R, G) f32, alpha (R, 2) f32, out=None) -> (t1, t2)``,
two (R, G) f32 planes in {-1, 0, 1} (the reference op's contract,
``repro.kernels.ptqtp_search.ops``). ``out`` may name the two planes to
write (contiguous, (R, G) f32), as the quantizer's row chunks do.

On CUDA tensors it launches the hand-written Hopper kernel of
``csrc/ptqtp_search.cu`` (replacing ``ptqtp_search_pallas``); on CPU
tensors it runs the plain compare-select walk of ``ref.py``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ptqtp_search import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "ptqtp_search.cu"
_P = ctypes.c_void_p
_SIGNATURES = {"ptqtp_search_launch": [_P, _P, _P, _P, ctypes.c_longlong,
                                       ctypes.c_int, _P]}


def _outputs(w, out):
    if out is None:
        return torch.empty_like(w), torch.empty_like(w)
    t1, t2 = out
    for name, t in (("t1", t1), ("t2", t2)):
        if (t.dtype != torch.float32 or t.shape != w.shape
                or t.device != w.device or not t.is_contiguous()):
            raise ValueError(f"out {name} must be contiguous float32 "
                             f"{tuple(w.shape)} on {w.device}")
    return t1, t2


def ptqtp_search_cuda(w: torch.Tensor, alpha: torch.Tensor,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hopper kernel; w, alpha (and ``out``) on one CUDA device."""
    if w.dim() != 2:
        raise ValueError(f"w must be (R, G), got {tuple(w.shape)}")
    r, g = w.shape
    for name, t, shape in (("w", w, (r, g)), ("alpha", alpha, (r, 2))):
        if not t.is_cuda or t.device != w.device:
            raise ValueError(f"{name} must be a CUDA tensor on {w.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    t1, t2 = _outputs(w, out)
    if w.numel() == 0:
        return t1, t2
    lib = _build.load(_SOURCE, _SIGNATURES)
    status = lib.ptqtp_search_launch(
        w.data_ptr(), alpha.data_ptr(), t1.data_ptr(), t2.data_ptr(), r, g,
        torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(status, "ptqtp_search_launch")
    _build.count("ptqtp_search")
    return t1, t2


def ptqtp_search(w: torch.Tensor, alpha: torch.Tensor,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t1, t2) f32 planes of group-rows w (R, G) under scales alpha (R, 2)."""
    if w.device.type == "cpu":
        t1, t2 = _outputs(w, out)
        _ref.ptqtp_search_plain(w, alpha, t1, t2)
        return t1, t2
    return ptqtp_search_cuda(w, alpha, out)
