"""Public wrapper of the RWKV6 recurrence with its head-wise group norm
(``repro/models/rwkv6.py``: the scan of ``rwkv_time_forward`` and
``_group_norm``).

On CUDA tensors it launches the hand-written Hopper kernel of
``csrc/wkv6.cu`` (one block per row and head, the head's state in
registers, the chunk staged in shared memory in tiles of 32 steps, every
sum in a fixed order: no ``bmm``, ``torch.mean`` or ``torch.var`` on the
card); on CPU tensors it runs the plain loop of ``ref.py``. It never falls
back from a CUDA tensor to it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ref as _ref
from repro_torch.kernels.wkv6.ref import GROUP_NORM_EPS

_SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"wkv6_launch": [_P] * 9 + [_I] * 6 + [ctypes.c_float, _P]}
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64)  # the configs' rwkv_head_dim: full width and smoke


def wkv6_cuda(r, k, v, w, u, state, lengths, scale,
              eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """The Hopper kernel. r, k, v (B, S, H, hd) f32 or bf16 and w (B, S, H,
    hd) f32; u (H, hd) and scale (H·hd,) f32 or bf16; state (B, H, hd, hd)
    f32, updated in place; lengths (B,) int32; all contiguous on one card,
    r, k, v and w 16-byte aligned (the kernel stages them in 16-byte
    copies). Returns (B, S, H·hd) in r's dtype."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    b, s, nh, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    shapes = {"k": (k, r.shape), "v": (v, r.shape), "w": (w, r.shape),
              "u": (u, (nh, hd)), "state": (state, (b, nh, hd, hd)),
              "lengths": (lengths, (b,)), "scale": (scale, (nh * hd,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"r, k, v must share f32 or bf16, got {r.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if u.dtype not in _DTYPES or scale.dtype != u.dtype:
        raise TypeError(f"u and scale must share f32 or bf16, got {u.dtype} "
                        f"and {scale.dtype}")
    for name, t, dt in (("w", w, torch.float32), ("state", state,
                                                  torch.float32),
                        ("lengths", lengths, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state), ("lengths", lengths),
                    ("scale", scale)):
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    out = torch.empty((b, s, nh * hd), dtype=r.dtype, device=r.device)
    if out.numel() == 0:
        return out
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), lengths.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(r.dtype == torch.bfloat16),
        int(u.dtype == torch.bfloat16), b, s, nh, hd, float(eps), stream)
    _build.check(status, "wkv6_launch")
    _build.count("wkv6")
    return out


def wkv6(r, k, v, w, u, state, lengths, scale,
         eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """The WKV readout of every step, group-normed per head, (B, S, H·hd)
    in r's dtype; the state advanced in place over each row's first
    ``lengths[b]`` steps."""
    if r.device.type == "cpu":
        return _ref.wkv6_plain(r, k, v, w, u, state, lengths, scale, eps)
    return wkv6_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                     w.contiguous(), u.contiguous(), state,
                     lengths.to(torch.int32).contiguous(),
                     scale.contiguous(), eps)
