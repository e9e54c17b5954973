"""Public wrappers of the RG-LRU's recurrence (``repro/models/rglru.py``).

``rglru_gated_scan`` is the layer's gate-and-scan, from the gates'
block-diagonal products to ``wo``'s input. On CUDA tensors it launches the
hand-written Hopper kernel of ``csrc/rglru_scan.cu`` (one launch a layer
and call, counted as ``rglru_scan``: 32 channels of a row a block, the
gates in parallel over steps and channels, the chain a warp, a fixed
order and rounding); on other tensors (CPU, meta) it runs
``ref.rglru_gated_scan_plain``.
It never falls back from a CUDA tensor to its plain version.

It is differentiable (training): where grad mode is on and any of ya, yx,
ba, bx, c, g or lam requires grad, it runs through a
``torch.autograd.Function`` whose backward is the hand-written kernel
``rglru_gated_scan_backward_cuda`` on a CUDA tensor (counted as
``rglru_scan_bwd``) and ``ref.rglru_gated_scan_backward_plain`` on a CPU
one. The backward needs h_{t−1} at every step, which the forward keeps
only in registers: the forward kernel also writes the state at the start
of each 32-step tile ((B, ⌈S/32⌉, R) f32, 1.3 MB a layer at 8 × 512 ×
2560, against 42 MB for every step's), and the backward recomputes each
tile's chain from it. The backward kernel loads each operand once (the
next tile's copies into shared memory fly through the current tile's
work) and computes each element's gates once (the forward's bits),
keeping what the gradients need through the tile's chains, which two
warps run at once (the recompute forwards, the gradient's carry
backwards). dba, dbx and dlam are summed in a fixed order with no float
atomics (each block's f32 partial, then a launch that sums them in row
order), so a training run is bit-reproducible.
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
_SIGNATURES = {"rglru_gated_scan_launch": [_P, _P, _L, _L] + [_P] * 9
               + [_I] * 5 + [_P],
               "rglru_gated_scan_bwd_launch": [_P, _P, _L, _L] + [_P] * 16
               + [_I] * 5 + [_P],
               "rglru_gated_scan_bwd_resources": [_I, _P]}
TILE = 32  # steps between two of the forward's state checkpoints
_DTYPES = (torch.float32, torch.bfloat16)


def _check(ya, yx, ba, bx, c, g, lam, h, lengths):
    """Raise unless the arguments are as ``rglru_gated_scan_cuda`` takes
    them (h None: not checked); returns (B, S, R, rb)."""
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
    if h is None:
        del shapes["h"]
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    shared = (ya, yx, ba, bx, c, g, lam)
    if c.dtype not in _DTYPES or any(t.dtype != c.dtype for t in shared):
        raise TypeError(f"ya, yx, ba, bx, c, g and lam must share f32 or "
                        f"bf16, got {[t.dtype for t in shared]}")
    for name, t, dt in (("h", h, torch.float32),
                        ("lengths", lengths, torch.int32)):
        if t is not None and t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("ya", ya), ("yx", yx), ("ba", ba), ("bx", bx), ("c", c),
                    ("g", g), ("lam", lam), ("h", h), ("lengths", lengths)):
        if t is None:
            continue
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
    return b, s, r, rb


def _ckpt_shape(b: int, s: int, r: int):
    return (b, -(-s // TILE), r)


def rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h, lengths, ckpt=None
                          ) -> torch.Tensor:
    """The Hopper kernel, one launch. ya, yx (n_blocks, B·S, rb) with rows
    rb apart (the layout ``bmm_fixed_rows`` returns: its blocks may lie
    further apart than B·S rows), c and g (B, S, R) and ba, bx, lam (R,)
    contiguous, all in one dtype (f32 or bf16: the configs keep parameters
    and activations in one); h (B, R) f32 contiguous, updated in place;
    lengths (B,) int32. R = n_blocks·rb with R and rb even; every pointer
    aligned to two elements. Returns (B, S, R) in c's dtype. With ``ckpt``
    ((B, ⌈S/32⌉, R) f32 contiguous) it also writes there the state at the
    start of each tile of 32 steps, which the backward kernel reads."""
    b, s, r, rb = _check(ya, yx, ba, bx, c, g, lam, h, lengths)
    if ckpt is not None and (tuple(ckpt.shape) != _ckpt_shape(b, s, r)
                             or ckpt.dtype != torch.float32
                             or not ckpt.is_contiguous()
                             or ckpt.device != c.device):
        raise ValueError(f"ckpt must be {_ckpt_shape(b, s, r)} f32 "
                         f"contiguous on {c.device}")
    out = torch.empty_like(c)
    if out.numel() == 0:
        return out
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    status = lib.rglru_gated_scan_launch(
        ya.data_ptr(), yx.data_ptr(), ya.stride(0), yx.stride(0),
        ba.data_ptr(), bx.data_ptr(), lam.data_ptr(), c.data_ptr(),
        g.data_ptr(), h.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        0 if ckpt is None else ckpt.data_ptr(), b, s, r, rb,
        int(c.dtype == torch.bfloat16), stream)
    _build.check(status, "rglru_gated_scan_launch")
    _build.count("rglru_scan")
    return out


def rglru_gated_scan_backward_cuda(ya, yx, ba, bx, c, g, lam, ckpt, lengths,
                                   dout):
    """The Hopper backward kernel: the forward's arguments as
    ``rglru_gated_scan_cuda`` takes them, ``ckpt`` the state at each
    tile's start that its forward wrote, and ``dout`` (B, S, R) the
    output's gradient in c's dtype. Returns (dya, dyx) (n_blocks, B·S, rb)
    contiguous, (dba, dbx) (R,), (dc, dg) (B, S, R) and dlam (R,), all in
    c's dtype. Two launches: the gradients (32 channels of a row a block,
    each operand loaded once, each gate computed once) with each block's
    f32 partials of dba, dbx and dlam, then their sum over rows in row
    order. The only scratch is those partials, (3, B, R) f32, whatever
    S; B·S must stay below 2^31."""
    b, s, r, rb = _check(ya, yx, ba, bx, c, g, lam, None, lengths)
    for name, t, shape, dt in (("ckpt", ckpt, _ckpt_shape(b, s, r),
                                torch.float32),
                               ("dout", dout, (b, s, r), c.dtype)):
        if (tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous()
                or t.device != c.device):
            raise ValueError(f"{name} must be {shape} {dt} contiguous on "
                             f"{c.device}, got {tuple(t.shape)} {t.dtype}")
    n = r // rb
    dya = torch.empty((n, b * s, rb), dtype=c.dtype, device=c.device)
    dyx, dc, dg = torch.empty_like(dya), torch.empty_like(c), \
        torch.empty_like(c)
    dba, dbx, dlam = (torch.empty_like(lam) for _ in range(3))
    part = torch.empty((3, b, r), dtype=torch.float32, device=c.device)
    if dout.numel() == 0:
        return dya, dyx, dba.zero_(), dbx.zero_(), dc, dg, dlam.zero_()
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(c.device).cuda_stream
    status = lib.rglru_gated_scan_bwd_launch(
        ya.data_ptr(), yx.data_ptr(), ya.stride(0), yx.stride(0),
        ba.data_ptr(), bx.data_ptr(), lam.data_ptr(), c.data_ptr(),
        g.data_ptr(), ckpt.data_ptr(), lengths.data_ptr(), dout.data_ptr(),
        dya.data_ptr(), dyx.data_ptr(), dc.data_ptr(), dg.data_ptr(),
        part.data_ptr(), dba.data_ptr(), dbx.data_ptr(), dlam.data_ptr(), b,
        s, r, rb, int(c.dtype == torch.bfloat16), stream)
    _build.check(status, "rglru_gated_scan_bwd_launch")
    _build.count("rglru_scan_bwd")
    return dya, dyx, dba, dbx, dc, dg, dlam


def backward_resources(dtype: torch.dtype) -> dict:
    """The backward kernel's resources for ``dtype`` (f32 or bf16) on the
    current card: registers a thread, shared bytes a block (static and
    dynamic), blocks an SM (CUDA's occupancy calculator) and local
    (spilled) bytes a thread. Launches nothing."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype must be f32 or bf16, got {dtype}")
    lib = _build.load(_SOURCE, _SIGNATURES)
    out = (ctypes.c_int * 4)()
    _build.check(lib.rglru_gated_scan_bwd_resources(
        int(dtype == torch.bfloat16), out), "rglru_gated_scan_bwd_resources")
    return dict(zip(("registers", "shared_bytes", "blocks_per_sm",
                     "local_bytes"), out))


class _GatedScan(torch.autograd.Function):
    """``rglru_gated_scan`` with its backward: the kernel's on a CUDA
    tensor, the plain one on any other. h is advanced in place and has
    no gradient (a training forward starts each layer from a zeroed state
    and reads none after it)."""

    @staticmethod
    def forward(ctx, ya, yx, ba, bx, c, g, lam, h, lengths):
        if not c.is_cuda:
            saved = h.clone()  # the plain backward recomputes from h0
            out = _ref.rglru_gated_scan_plain(ya, yx, ba, bx, c, g, lam, h,
                                              lengths)
        else:
            b, s, r = c.shape
            lengths = lengths.to(torch.int32)
            saved = torch.empty(_ckpt_shape(b, s, r), dtype=torch.float32,
                                device=c.device)
            out = rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h,
                                        lengths, saved)
        ctx.save_for_backward(ya, yx, ba, bx, c, g, lam, saved, lengths)
        return out

    @staticmethod
    def backward(ctx, dout):
        ya, yx, ba, bx, c, g, lam, saved, lengths = ctx.saved_tensors
        if not c.is_cuda:
            grads = _ref.rglru_gated_scan_backward_plain(
                ya, yx, ba, bx, c, g, lam, saved, lengths, dout)
        else:
            grads = rglru_gated_scan_backward_cuda(
                ya, yx, ba, bx, c, g, lam, saved, lengths,
                dout.contiguous())
        return (*grads, None, None)


def rglru_gated_scan(ya, yx, ba, bx, c, g, lam, h, lengths) -> torch.Tensor:
    """The RG-LRU's gates, scan and output gate (``ref.
    rglru_gated_scan_plain`` gives the arguments); h advanced in place.
    Returns ``wo``'s input (B, S, R) in c's dtype."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (ya, yx, ba, bx, c, g, lam)):
        return _GatedScan.apply(ya, yx, ba, bx, c, g, lam, h, lengths)
    if not c.is_cuda:
        return _ref.rglru_gated_scan_plain(ya, yx, ba, bx, c, g, lam, h,
                                           lengths)
    return rglru_gated_scan_cuda(ya, yx, ba, bx, c, g, lam, h,
                                 lengths.to(torch.int32))
