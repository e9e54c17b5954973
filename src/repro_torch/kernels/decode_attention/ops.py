"""Public wrapper of one-token decode attention over an int8 ring.

``decode_attention(q, k8, k_scale, v8, v_scale, pos_buf, pos, *,
window=None) -> (B, KV, G, hd) f32``, the reference op's contract
(``repro.kernels.decode_attention``; shapes and mask rule in ``ref.py``).
The serving path does not use it (chunk attention serves decode there, as
in the reference); this op is its only entry point.

On CUDA tensors it launches the hand-written Hopper kernel B5
(``decode_attention_launch``, replacing ``decode_attention_pallas``): the
split-KV chunk-attention kernel of
``kernels/chunk_attention/csrc/chunk_attention.cu`` over the same parts
(``split_ranges``) under the decode op's mask rule (no chunk keys, no
re-mask after exp, no part skipped). On other tensors (CPU, meta) it runs the plain
version of ``ref.py``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_attention.ops import (PART_SLOTS, ROW_TILE,
                                                     split_ranges, workspace)
from repro_torch.kernels.decode_attention import ref as _ref

_SOURCE = (Path(__file__).parent.parent / "chunk_attention" / "csrc"
           / "chunk_attention.cu")
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"decode_attention_launch": [
    _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
    _I, ctypes.c_float, _P]}

MAX_HEAD_DIM = 256  # and a multiple of 8 (csrc MAX_HD)


def _require(t, name, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} must be on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:  # the kernel reads rows in 16-byte vectors
        raise ValueError(f"{name} must be 16-byte aligned")


def decode_attention_cuda(q, k8, k_scale, v8, v_scale, pos_buf, pos, *,
                          window: Optional[int] = None):
    """The Hopper kernel; every tensor on one CUDA device."""
    b, kv, g, hd = q.shape
    s = k8.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("decode_attention_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head dim {hd} must be <= {MAX_HEAD_DIM} and a "
                         "multiple of 8")
    _require(q, "q", q.dtype, (b, kv, g, hd), dev)
    _require(k8, "k8", torch.int8, (b, s, kv, hd), dev)
    _require(v8, "v8", torch.int8, (b, s, kv, hd), dev)
    _require(k_scale, "k_scale", torch.float32, (b, s, kv), dev)
    _require(v_scale, "v_scale", torch.float32, (b, s, kv), dev)
    _require(pos_buf, "pos_buf", torch.int32, (b, s), dev)
    _require(pos, "pos", torch.int32, (b,), dev)
    out = torch.empty((b, kv, g, hd), dtype=torch.float32, device=dev)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    scratch, counters, stream = workspace(dev, b, kv, g, hd,
                                          len(split_ranges(s)))
    lib = _build.load(_SOURCE, _SIGNATURES)
    status = lib.decode_attention_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k8.data_ptr(),
        v8.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        pos_buf.data_ptr(), pos.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), b, s, kv, g, hd, PART_SLOTS, ROW_TILE,
        int(window) if window else s + 1, float(hd ** -0.5), stream)
    _build.check(status, "decode_attention_launch")
    _build.count("decode_attention")
    return out


def decode_attention(q, k8, k_scale, v8, v_scale, pos_buf, pos, *,
                     window: Optional[int] = None):
    """(B, KV, G, hd) f32 decode attention over an int8 ring."""
    if not q.is_cuda:
        return _ref.decode_attention_plain(q, k8, k_scale, v8, v_scale,
                                           pos_buf, pos, window=window)
    return decode_attention_cuda(q, k8, k_scale, v8, v_scale, pos_buf, pos,
                                 window=window)
