"""Public wrappers of the RG-LRU's recurrence (``repro/models/rglru.py``).

``rglru_gated_scan`` is the layer's gate-and-scan, from the gates'
block-diagonal products to ``wo``'s input. On CUDA tensors it launches the
hand-written Hopper kernel of ``csrc/rglru_scan.cu`` (one launch a layer
and call, counted as ``rglru_scan``: 32 channels of a row a block, the
gates in parallel over steps and channels, the chain a warp, a fixed
order and rounding); on CPU tensors it runs ``ref.rglru_gated_scan_plain``.
It never falls back from a CUDA tensor to its plain version.
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
_L = ctypes.c_longlong
_SIGNATURES = {"rglru_gated_scan_launch": [_P, _P, _L, _L] + [_P] * 8
               + [_I] * 5 + [_P]}
_DTYPES = (torch.float32, torch.bfloat16)


def rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h, lengths
                          ) -> torch.Tensor:
    """The Hopper kernel, one launch. ya, yx (n_blocks, B·S, rb) with rows
    rb apart (the layout ``bmm_fixed_rows`` returns: its blocks may lie
    further apart than B·S rows), c and g (B, S, R) and ba, bx, lam (R,)
    contiguous, all in one dtype (f32 or bf16: the configs keep parameters
    and activations in one); h (B, R) f32 contiguous, updated in place;
    lengths (B,) int32. R = n_blocks·rb with R and rb even; every pointer
    aligned to two elements. Returns (B, S, R) in c's dtype."""
    if c.dim() != 3 or g.shape != c.shape:
        raise ValueError(f"c and g must be one (B, S, R) shape, got "
                         f"{tuple(c.shape)} and {tuple(g.shape)}")
    b, s, r = c.shape
    if ya.dim() != 3 or yx.shape != ya.shape:
        raise ValueError(f"ya and yx must be one (n_blocks, B·S, rb) shape, "
                         f"got {tuple(ya.shape)} and {tuple(yx.shape)}")
    n, m, rb = ya.shape
    if m != b * s or n * rb != r or r % 2 or rb % 2:
        raise ValueError(f"gate products {tuple(ya.shape)} do not cut "
                         f"{tuple(c.shape)} into even blocks")
    shapes = {"ba": (ba, (r,)), "bx": (bx, (r,)), "lam": (lam, (r,)),
              "h": (h, (b, r)), "lengths": (lengths, (b,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    shared = (ya, yx, ba, bx, c, g, lam)
    if c.dtype not in _DTYPES or any(t.dtype != c.dtype for t in shared):
        raise TypeError(f"ya, yx, ba, bx, c, g and lam must share f32 or "
                        f"bf16, got {[t.dtype for t in shared]}")
    for name, t, dt in (("h", h, torch.float32),
                        ("lengths", lengths, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("ya", ya), ("yx", yx), ("ba", ba), ("bx", bx), ("c", c),
                    ("g", g), ("lam", lam), ("h", h), ("lengths", lengths)):
        if not t.is_cuda or t.device != c.device:
            raise ValueError(f"{name} must be a CUDA tensor on {c.device}")
        if name in ("ya", "yx"):
            if t.stride(2) != 1 or t.stride(1) != rb or t.stride(0) % 2:
                raise ValueError(f"{name} must hold rows of {rb} "
                                 f"contiguous elements, got strides "
                                 f"{t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % (2 * t.element_size()):
            raise ValueError(f"{name} must be aligned to two elements")
    out = torch.empty_like(c)
    if out.numel() == 0:
        return out
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    status = lib.rglru_gated_scan_launch(
        ya.data_ptr(), yx.data_ptr(), ya.stride(0), yx.stride(0),
        ba.data_ptr(), bx.data_ptr(), lam.data_ptr(), c.data_ptr(),
        g.data_ptr(), h.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, s,
        r, rb, int(c.dtype == torch.bfloat16), stream)
    _build.check(status, "rglru_gated_scan_launch")
    _build.count("rglru_scan")
    return out


def rglru_gated_scan(ya, yx, ba, bx, c, g, lam, h, lengths) -> torch.Tensor:
    """The RG-LRU's gates, scan and output gate (``ref.
    rglru_gated_scan_plain`` gives the arguments); h advanced in place.
    Returns ``wo``'s input (B, S, R) in c's dtype."""
    if c.device.type == "cpu":
        return _ref.rglru_gated_scan_plain(ya, yx, ba, bx, c, g, lam, h,
                                           lengths)
    return rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h,
                                 lengths.to(torch.int32))
