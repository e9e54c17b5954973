"""Public wrapper of chunk attention over the ring cache.

``chunk_attention(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
pos_buf, positions, lengths, *, window=None) -> (B, L, KV, G, hd) f32``,
the reference's op contract (see ``ref.py`` for shapes and the mask rule).

On CUDA tensors it launches the hand-written Hopper kernel of
``csrc/chunk_attention.cu`` (replacing ``chunk_attention_pallas``); on CPU
tensors it runs the plain online-softmax walk of ``ref.py``.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_attention import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "chunk_attention.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"chunk_attention_launch": [
    _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
    _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]}

MAX_HEAD_DIM = 128


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


def chunk_attention_cuda(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
                         pos_buf, positions, lengths, *,
                         window: Optional[int] = None):
    """The Hopper kernel; every tensor on one CUDA device."""
    b, L, kv, g, hd = q.shape
    cap = k_cache.shape[1]
    dev = q.device
    if not q.is_cuda:
        raise ValueError("chunk_attention_cuda needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM or hd % 16:
        raise ValueError(f"head dim {hd} must be <= {MAX_HEAD_DIM} and a "
                         "multiple of 16")
    ring_int8 = k_cache.dtype == torch.int8
    if not ring_int8 and k_cache.dtype != q.dtype:
        raise TypeError(f"a float ring must have q's dtype {q.dtype}, got "
                        f"{k_cache.dtype}")
    _require(q, "q", q.dtype, (b, L, kv, g, hd), dev)
    _require(k_new, "k_new", q.dtype, (b, L, kv, hd), dev)
    _require(v_new, "v_new", q.dtype, (b, L, kv, hd), dev)
    _require(k_cache, "k_cache", k_cache.dtype, (b, cap, kv, hd), dev)
    _require(v_cache, "v_cache", k_cache.dtype, (b, cap, kv, hd), dev)
    if ring_int8 != (k_scale is not None and v_scale is not None):
        raise ValueError("an int8 ring needs k_scale and v_scale; a float "
                         "ring takes none")
    if ring_int8:
        _require(k_scale, "k_scale", torch.float32, (b, cap, kv), dev)
        _require(v_scale, "v_scale", torch.float32, (b, cap, kv), dev)
    _require(pos_buf, "pos_buf", torch.int32, (b, cap), dev)
    _require(positions, "positions", torch.int32, (b, L), dev)
    _require(lengths, "lengths", torch.int32, (b,), dev)
    out = torch.empty((b, L, kv, g, hd), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.chunk_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr(),
        int(ring_int8), k_scale.data_ptr() if ring_int8 else None,
        v_scale.data_ptr() if ring_int8 else None, pos_buf.data_ptr(),
        positions.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, L, kv, g, hd, cap, _ref.reach_of(cap, window), float(hd ** -0.5),
        stream)
    _build.check(status, "chunk_attention_launch")
    _build.LAUNCHES["chunk_attention"] += 1
    return out


def chunk_attention(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
                    pos_buf, positions, lengths, *,
                    window: Optional[int] = None):
    """Chunk attention vs (pre-write ring ∪ in-chunk keys); returns
    (B, L, KV, G, hd) float32. ``k_scale``/``v_scale`` are None for float
    rings."""
    if q.device.type == "cpu":
        return _ref.chunk_attention_stream(
            q, k_new, v_new, k_cache, k_scale, v_cache, v_scale, pos_buf,
            positions, lengths, window=window)
    return chunk_attention_cuda(q, k_new, v_new, k_cache, k_scale, v_cache,
                                v_scale, pos_buf, positions, lengths,
                                window=window)
