"""Public wrapper of the RWKV6 recurrence with its head-wise group norm
(``repro/models/rwkv6.py``: the scan of ``rwkv_time_forward`` and
``_group_norm``).

On CUDA tensors it launches the hand-written Hopper kernel of
``csrc/wkv6.cu`` (one block per row and head, the head's state in
registers, the chunk staged in shared memory in tiles of 32 steps, every
sum in a fixed order: no ``bmm``, ``torch.mean`` or ``torch.var`` on the
card); on other tensors (CPU, meta) it runs the plain loop of ``ref.py``. It never falls
back from a CUDA tensor to it.

It is differentiable (training): where grad mode is on and any of r, k,
v, w, u or scale requires grad, it runs through a
``torch.autograd.Function`` whose backward is the hand-written kernel
``wkv6_backward_cuda`` on a CUDA tensor (counted as ``wkv6_bwd``) and
``ref.wkv6_backward_plain`` on any other. dr_t and dw_t need the state
before step t, which the forward keeps only in registers and overwrites;
running it backwards by dividing by w would be inexact, and unstable
where w is small. So the forward kernel also writes the state at the
start of each 32-step tile ((B, H, ⌈S/32⌉, hd, hd) f32: 84 MB a layer at 8
× 512 × 40 heads of 64) and the readout before its norm, and the
backward recomputes each tile's states from its checkpoint on chip
(sub-tile checkpoints in shared memory, a sub-tile's states in
registers; no scratch grows with B·H·hd²). du and dscale
are summed in a fixed order with no float atomics (each block's f32
partial, then a launch that sums them in row order), so a training run
is bit-reproducible.
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
_F = ctypes.c_float
_SIGNATURES = {"wkv6_launch": [_P] * 11 + [_I] * 6 + [_F, _P],
               "wkv6_bwd_launch": [_P] * 17 + [_I] * 6 + [_F, _P]}
TILE = 32  # steps between two of the forward's state checkpoints
_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64)  # the configs' rwkv_head_dim: full width and smoke


def _ckpt_shape(b: int, s: int, nh: int, hd: int):
    return (b, nh, -(-s // TILE), hd, hd)


def _check_saved(name, t, shape, dtype, device):
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous() or t.device != device):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} contiguous "
                         f"on {device}, got {tuple(t.shape)} {t.dtype}")


def _validate(r, k, v, w, u, state, lengths, scale):
    """Raise unless the arguments are as ``wkv6_cuda`` takes them (state
    None: not checked); returns (B, S, H, hd)."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, S, H, hd), got {tuple(r.shape)}")
    b, s, nh, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    shapes = {"k": (k, r.shape), "v": (v, r.shape), "w": (w, r.shape),
              "u": (u, (nh, hd)), "state": (state, (b, nh, hd, hd)),
              "lengths": (lengths, (b,)), "scale": (scale, (nh * hd,))}
    if state is None:
        del shapes["state"]
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
        if t is not None and t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("state", state), ("lengths", lengths),
                    ("scale", scale)):
        if t is None:
            continue
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"{name} must be a CUDA tensor on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return b, s, nh, hd


def wkv6_cuda(r, k, v, w, u, state, lengths, scale,
              eps: float = GROUP_NORM_EPS, ckpt=None, yraw=None
              ) -> torch.Tensor:
    """The Hopper kernel. r, k, v (B, S, H, hd) f32 or bf16 and w (B, S, H,
    hd) f32; u (H, hd) and scale (H·hd,) f32 or bf16; state (B, H, hd, hd)
    f32, updated in place; lengths (B,) int32; all contiguous on one card,
    r, k, v and w 16-byte aligned (the kernel stages them in 16-byte
    copies). Returns (B, S, H·hd) in r's dtype. With ``ckpt`` ((B, H,
    ⌈S/32⌉, hd, hd) f32) and ``yraw`` ((B, S, H·hd) in r's dtype) it also
    writes the state at the start of each tile of 32 steps and the
    readout before its norm, which the backward kernel reads."""
    b, s, nh, hd = _validate(r, k, v, w, u, state, lengths, scale)
    if (ckpt is None) != (yraw is None):
        raise ValueError("ckpt and yraw go together")
    if ckpt is not None:
        _check_saved("ckpt", ckpt, _ckpt_shape(b, s, nh, hd), torch.float32,
                     r.device)
        _check_saved("yraw", yraw, (b, s, nh * hd), r.dtype, r.device)
    out = torch.empty((b, s, nh * hd), dtype=r.dtype, device=r.device)
    if out.numel() == 0:
        return out
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), lengths.data_ptr(), scale.data_ptr(),
        out.data_ptr(), 0 if ckpt is None else ckpt.data_ptr(),
        0 if yraw is None else yraw.data_ptr(),
        int(r.dtype == torch.bfloat16),
        int(u.dtype == torch.bfloat16), b, s, nh, hd, float(eps), stream)
    _build.check(status, "wkv6_launch")
    _build.count("wkv6")
    return out


def wkv6_backward_cuda(r, k, v, w, u, lengths, scale, ckpt, yraw, dout,
                       eps: float = GROUP_NORM_EPS):
    """The Hopper backward kernel: the forward's arguments as ``wkv6_cuda``
    takes them, with ``ckpt`` and ``yraw`` as its forward wrote them and
    ``dout`` (B, S, H·hd) the output's gradient in r's dtype. Returns (dr,
    dk, dv) (B, S, H, hd) in r's dtype, dw f32, du (H, hd) and dscale
    (H·hd,) in u's dtype. Two launches: one block a (row, head), a thread
    two state rows of 8 columns (hd 16: 4), walks the tiles backwards,
    recomputing a tile's states from its checkpoint on chip (sub-tile
    checkpoints in shared memory, a sub-tile's states in registers), and
    writes each block's f32 partials of du and dscale; then their sum over
    rows in row order. The only scratch is those partials, (2, B, H·hd)
    f32."""
    b, s, nh, hd = _validate(r, k, v, w, u, None, lengths, scale)
    _check_saved("ckpt", ckpt, _ckpt_shape(b, s, nh, hd), torch.float32,
                 r.device)
    _check_saved("yraw", yraw, (b, s, nh * hd), r.dtype, r.device)
    _check_saved("dout", dout, (b, s, nh * hd), r.dtype, r.device)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du, dscale = torch.empty_like(u), torch.empty_like(scale)
    if dout.numel() == 0:
        return dr, dk, dv, dw, du.zero_(), dscale.zero_()
    for name, t in (("ckpt", ckpt), ("yraw", yraw), ("dout", dout)):
        if t.data_ptr() % 16:  # staged and read in 16-byte copies
            raise ValueError(f"{name} must be 16-byte aligned")
    part = torch.empty((2, b, nh * hd), dtype=torch.float32, device=r.device)
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    status = lib.wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        ckpt.data_ptr(), yraw.data_ptr(), lengths.data_ptr(),
        scale.data_ptr(), dout.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), part.data_ptr(),
        du.data_ptr(), dscale.data_ptr(), int(r.dtype == torch.bfloat16),
        int(u.dtype == torch.bfloat16), b, s, nh, hd, float(eps), stream)
    _build.check(status, "wkv6_bwd_launch")
    _build.count("wkv6_bwd")
    return dr, dk, dv, dw, du, dscale


class _WKV6(torch.autograd.Function):
    """``wkv6`` with its backward: the kernel's on a CUDA tensor, the plain
    one on any other. The state is advanced in place and has no
    gradient (a training forward starts each layer from a zeroed state
    and reads none after it)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, lengths, scale, eps):
        if not r.is_cuda:
            saved = (state.clone(),)  # the plain backward recomputes
            out = _ref.wkv6_plain(r, k, v, w, u, state, lengths, scale, eps)
        else:
            b, s, nh, hd = r.shape
            r, k, v, w, u, scale = (t.contiguous()
                                    for t in (r, k, v, w, u, scale))
            lengths = lengths.to(torch.int32).contiguous()
            saved = (torch.empty(_ckpt_shape(b, s, nh, hd),
                                 dtype=torch.float32, device=r.device),
                     torch.empty((b, s, nh * hd), dtype=r.dtype,
                                 device=r.device))
            out = wkv6_cuda(r, k, v, w, u, state, lengths, scale, eps,
                            *saved)
        ctx.save_for_backward(r, k, v, w, u, lengths, scale, *saved)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        r, k, v, w, u, lengths, scale, *saved = ctx.saved_tensors
        if not r.is_cuda:
            grads = _ref.wkv6_backward_plain(r, k, v, w, u, saved[0], lengths,
                                             scale, dout, ctx.eps)
        else:
            grads = wkv6_backward_cuda(r, k, v, w, u, lengths, scale,
                                       *saved, dout.contiguous(), ctx.eps)
        dr, dk, dv, dw, du, dscale = grads
        return dr, dk, dv, dw, du, None, None, dscale, None


def wkv6(r, k, v, w, u, state, lengths, scale,
         eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """The WKV readout of every step, group-normed per head, (B, S, H·hd)
    in r's dtype; the state advanced in place over each row's first
    ``lengths[b]`` steps."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, scale)):
        return _WKV6.apply(r, k, v, w, u, state, lengths, scale, eps)
    if not r.is_cuda:
        return _ref.wkv6_plain(r, k, v, w, u, state, lengths, scale, eps)
    return wkv6_cuda(r.contiguous(), k.contiguous(), v.contiguous(),
                     w.contiguous(), u.contiguous(), state,
                     lengths.to(torch.int32).contiguous(),
                     scale.contiguous(), eps)
