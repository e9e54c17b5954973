"""Public wrapper of the PTQTP ternary matmul: y = x @ Ŵᵀ.

On a CUDA tensor it launches one of the two hand-written Hopper kernels of
``csrc/ternary_matmul.cu``, split at ``SMALL_M_THRESHOLD`` as the reference
splits its Pallas kernels:

  * m < 128  -> ``ternary_matvec`` (decode: every linear layer of a step);
  * m >= 128 -> ``ternary_matmul_tiled`` (prefill chunks).

``ternary_matmul_experts`` runs E such products stacked along a leading
expert axis (the MoE FFN's, which the reference vmaps over its experts) in
one launch of the same kernels, the expert on the grid's z axis: expert
e's rows have the bits of a launch of its matrix alone.

bf16 x runs both on the tensor cores (one shared ``mma.sync`` tile
routine), f32 x on the FMA kernels (``route``). Either way both give
bit-identical rows for the same x rows (see the source note), so where a
row lands never changes its result. On a CPU tensor the wrapper runs the
plain grouped formula of ``ref.py``; it never falls back from a CUDA
tensor to it.

The plane dtype tags the storage, as in the reference: uint8 planes are
packed and every route takes them; int8 planes hold raw trits (the
engine's ``preunpack_decode`` copy) and only the plain grouped route
serves them, on the card in row blocks of ``models.common.DENSE_ROW_BLOCK``
(one product shape whatever m: batch-invariant). ``backend`` takes the
reference's names: ``auto`` (the kernels on a CUDA tensor, the plain
route on a CPU one; int8 planes on a CUDA tensor raise, so that no card
path leaves the kernels unasked), ``pallas`` (the kernels: a CPU tensor
or int8 planes raise) and ``grouped`` (the plain route, which the
engine's pre-unpacked copy names).

``NIBBLE_BF16X2``, ``a_fragment`` and ``trit_pairs`` state in Python how
the tensor-core kernels turn packed trits into the A operand of
``mma.sync.m16n8k16`` (the part of those kernels that the CPU tests hold
against the reference's unpacking).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ternary_matmul import ref as _ref

SMALL_M_THRESHOLD = 128
MATVEC_GROUP_SIZES = (32, 64, 128)
BACKENDS = ("auto", "pallas", "grouped")

_SOURCE = Path(__file__).parent / "csrc" / "ternary_matmul.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_SIGNATURES = {"ternary_matvec_launch": _SIG, "ternary_matmul_launch": _SIG,
               "ternary_mma_route": [_I]}

# bf16 bits of a trit by its 2-bit field: 0b01 -> +1, 0b10 -> -1, 0b00 and
# the unused 0b11 -> 0
_TRIT_BF16 = (0x0000, 0x3F80, 0xBF80, 0x0000)
#: nibble of a packed word (two trits, the lower k in bits 0-1) -> the
#: bf16x2 register holding them, the lower k in the low half
NIBBLE_BF16X2 = tuple(_TRIT_BF16[v & 3] | _TRIT_BF16[v >> 2] << 16
                      for v in range(16))


def a_fragment(word_lo: int, word_hi: int, lane: int):
    """The four bf16x2 A registers (a0, a1, a2, a3) of ``mma.sync.m16n8k16``
    that ``lane`` builds from one k16 chunk of a plane, whose tile rows
    gid = lane // 4 and gid + 8 hold the 32-bit words ``word_lo`` and
    ``word_hi`` (trit k at bits 2k). With tig = lane % 4: a0 = row gid,
    k = 2·tig and 2·tig + 1 (the nibble at bit 4·tig); a1 = row gid + 8,
    same k; a2 = row gid, k + 8 (the nibble at bit 4·tig + 16); a3 = row
    gid + 8, k + 8."""
    tig = lane % 4

    def nib(w, shift):
        return NIBBLE_BF16X2[(w >> shift) & 15]

    return (nib(word_lo, 4 * tig), nib(word_hi, 4 * tig),
            nib(word_lo, 4 * tig + 16), nib(word_hi, 4 * tig + 16))


def _byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's ``__byte_perm(x, y, s)``: byte i of the result is byte
    (s >> 4i) & 7 of the 8 bytes y:x."""
    b = x | y << 32
    return sum(((b >> 8 * ((s >> 4 * i) & 7)) & 0xFF) << 8 * i
               for i in range(4))


def trit_pairs(word: int, tig: int):
    """The kernel's ``trit_pairs`` in integer arithmetic: the registers of
    the nibbles at bits 4·tig and 4·tig + 16 of one row's chunk word. Equal
    to ``NIBBLE_BF16X2`` of those nibbles."""
    v = (word >> 4 * tig) & 0x000F000F
    f = (v * 0x41) & 0x03030303
    sel = (f * 0x11 + 0x40404040) & 0xFFFFFFFF
    return (_byte_perm(0x00808000, 0x00BF3F00, sel),
            _byte_perm(0x00808000, 0x00BF3F00, sel >> 16))


@functools.lru_cache(maxsize=None)
def route(dtype) -> str:
    """Which kernels x of ``dtype`` runs on, as the built library's
    launchers decide: "mma" (tensor cores, bf16) or "fma" (f32)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    lib = _build.load(_SOURCE, _SIGNATURES)
    return "mma" if lib.ternary_mma_route(int(dtype == torch.bfloat16)) else "fma"


def _check(x, t1p, t2p, alpha, group_size):
    """Validate a plain (x (m, d), planes (n, d/4)) or a stacked (x (E, m,
    d), planes (E, n, d/4)) product; returns (E or 0, m, n, d)."""
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (m, d) or (E, m, d), got "
                         f"{tuple(x.shape)}")
    lead = tuple(x.shape[:-2])
    m, d = x.shape[-2:]
    n = t1p.shape[-2] if t1p.dim() >= 2 else -1
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("t1p", t1p), ("t2p", t2p)):
        if t.dtype != torch.uint8 or tuple(t.shape) != lead + (n, d // 4):
            raise ValueError(f"{name} must be uint8 {lead + (n, d // 4)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if alpha.dtype != torch.float32 or tuple(alpha.shape) != lead + (
            n, d // group_size, 2):
        raise ValueError(f"alpha must be float32 "
                         f"{lead + (n, d // group_size, 2)}")
    if d % group_size or d % 64:
        raise ValueError(f"d={d} must be a multiple of the group size "
                         f"{group_size} and of 64")
    # the kernels read x and the planes in 16-byte vectors and α as float2
    for name, t, align in (("x", x, 16), ("t1p", t1p, 16), ("t2p", t2p, 16),
                           ("alpha", alpha, 8)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    return (x.shape[0] if lead else 0), m, n, d


def _launch(fn_name, counter, x, t1p, t2p, alpha, group_size, out_dtype):
    ne, m, n, d = _check(x, t1p, t2p, alpha, group_size)
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"out_dtype must be float32 or x's dtype {x.dtype}, "
                        f"got {out_dtype}")
    y = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _build.load(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = getattr(lib, fn_name)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), t1p.data_ptr(),
        t2p.data_ptr(), alpha.data_ptr(), y.data_ptr(),
        int(out_dtype == torch.bfloat16), m, n, d, group_size, max(ne, 1),
        stream)
    _build.check(status, fn_name)
    _build.count(counter + ("_experts" if ne else ""))
    return y


def ternary_matvec(x, t1p, t2p, alpha, group_size: int = 128,
                   out_dtype=torch.float32):
    """Decode kernel (replaces ``ternary_matvec_pallas``): x (m, d) on the
    card, any m (meant for m < 128). Returns (m, n) in ``out_dtype``: f32,
    or x's dtype (the f32 result rounded as ``.to`` would round it). With x
    (E, m, d) and stacked planes, the E products of one launch (counted as
    ``ternary_matvec_experts``)."""
    if group_size not in MATVEC_GROUP_SIZES:
        raise ValueError(f"group size {group_size} not in {MATVEC_GROUP_SIZES}")
    return _launch("ternary_matvec_launch", "ternary_matvec", x, t1p, t2p,
                   alpha, group_size, out_dtype)


def ternary_matmul_tiled(x, t1p, t2p, alpha, group_size: int = 128,
                         out_dtype=torch.float32):
    """Prefill kernel (replaces ``ternary_matmul_pallas``): x (m, d) on the
    card, any m (meant for m >= 128). Returns (m, n) in ``out_dtype`` (f32
    or x's dtype). G must be a multiple of 32, and for bf16 x (the
    tensor-core kernel) one of ``MATVEC_GROUP_SIZES``. Stacked operands as
    for ``ternary_matvec`` (counted as ``ternary_matmul_experts``)."""
    if group_size % 32:
        raise ValueError(f"group size {group_size} must be a multiple of 32")
    if x.dtype == torch.bfloat16 and group_size not in MATVEC_GROUP_SIZES:
        raise ValueError(f"bf16 x: group size {group_size} not in "
                         f"{MATVEC_GROUP_SIZES}")
    return _launch("ternary_matmul_launch", "ternary_matmul", x, t1p, t2p,
                   alpha, group_size, out_dtype)


def _plain_route(backend: str, x, t1p) -> bool:
    """Whether the plain grouped formula serves this call (module
    docstring); raises the reference's ValueError for an unknown backend
    or for int8 planes asked of the kernels, and for int8 planes on a
    CUDA tensor that do not name the grouped route."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if t1p.dtype != torch.uint8:
        if backend == "pallas" or (backend == "auto" and x.is_cuda):
            raise ValueError(
                f"backend {backend!r} requires packed uint8 trit-planes; "
                "pre-unpacked int8 planes are served by the grouped backend")
        return True
    if backend == "pallas" and not x.is_cuda:
        raise ValueError("backend 'pallas' runs the CUDA kernels: x must be "
                         "a CUDA tensor")
    return backend == "grouped" or not x.is_cuda


def _row_block(x):
    """Row block of the plain route: one product shape on the card."""
    if not x.is_cuda:
        return None
    # models.common imports this module: import it at the call
    from repro_torch.models.common import DENSE_ROW_BLOCK
    return DENSE_ROW_BLOCK


def ternary_matmul_experts(x, t1p, t2p, alpha, *, group_size: int = 128,
                           out_dtype=None, backend: str = "auto"):
    """E stacked products y[e] = x[e] @ Ŵ[e]ᵀ: x (E, m, d); planes (E, n,
    d//4) uint8 (or (E, n, d) int8); alpha (E, n, d//G, 2) f32. Returns
    (E, m, n) in ``out_dtype`` (f32 if None). On the card one launch of the
    matvec (m < 128) or the tiled kernel with the expert on the grid's z
    axis; on the CPU, and for int8 planes, the plain grouped formula,
    expert by expert. ``backend``: the module docstring."""
    out_dtype = out_dtype or torch.float32
    if _plain_route(backend, x, t1p):
        return _ref.ternary_matmul_experts(x, t1p, t2p, alpha, group_size,
                                           _row_block(x)).to(out_dtype)
    direct = out_dtype in (torch.float32, x.dtype)
    kern = (ternary_matvec if x.shape[1] < SMALL_M_THRESHOLD
            else ternary_matmul_tiled)
    y = kern(x.contiguous(), t1p, t2p, alpha, group_size,
             out_dtype if direct else torch.float32)
    return y if direct else y.to(out_dtype)


def ternary_matmul(x, t1p, t2p, alpha, *, group_size: int = 128,
                   out_dtype=None, backend: str = "auto"):
    """y = x @ Ŵᵀ. x (..., d); packed planes (n, d//4) uint8 (or raw (n, d)
    int8); alpha (n, d//G, 2) f32. Returns (..., n) in ``out_dtype`` (f32
    if None). ``backend``: the module docstring."""
    out_dtype = out_dtype or torch.float32
    if _plain_route(backend, x, t1p):
        y = _ref.ternary_matmul_grouped(x, t1p, t2p, alpha, group_size,
                                        _row_block(x))
        return y.to(out_dtype)
    *lead, d = x.shape
    x2 = x.reshape(-1, d).contiguous()
    kern = (ternary_matvec if x2.shape[0] < SMALL_M_THRESHOLD
            else ternary_matmul_tiled)
    # the kernels write f32 or x's own dtype; any other goes through f32
    direct = out_dtype in (torch.float32, x.dtype)
    y = kern(x2, t1p, t2p, alpha, group_size,
             out_dtype if direct else torch.float32)
    y = y.reshape(*lead, t1p.shape[0])
    return y if direct else y.to(out_dtype)
