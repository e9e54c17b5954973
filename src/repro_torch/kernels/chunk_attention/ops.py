"""Public wrappers of chunk attention over the ring cache and the paged
pool.

``chunk_attention(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
pos_buf, positions, lengths, *, window=None) -> (B, L, KV, G, hd) f32``,
the reference's op contract (see ``ref.py`` for shapes and the mask rule);
``chunk_attention_paged(q, k_new, v_new, k_pool, k_scale, v_pool, v_scale,
pos_pool, table, positions, lengths, *, window=None)`` is the same op over
the virtual ring ``ring[b, p·ps + o] = pool[table[b, p], o]``.

``backend`` takes the reference's names, mapped onto the port's routes:

  * ``auto`` (the default): ``pallas`` on a CUDA tensor, ``stream`` on a
    CPU one;
  * ``pallas``: the hand-written Hopper kernel of ``csrc/chunk_attention.cu``
    (B2 replacing ``chunk_attention_pallas``, B4 replacing
    ``chunk_attention_paged_pallas``): split-KV over the parts of
    ``split_ranges`` with one fixed combine order per row. A CPU tensor
    raises (no interpreter);
  * ``stream``: the plain online-softmax walk of ``ref.py`` (the paged one
    over the gathered ring);
  * ``materialized``: ``ref.chunk_attention_materialized`` (paged: over the
    gathered ring), the reference's full-score-block oracle.

The plain twins run on either device; on a CUDA tensor they walk the chunk
in blocks of ``PLAIN_ROW_BLOCK`` query rows (``ref.py``), so their rows are
batch-invariant as the kernel's are. They make no host sync and take no
shape from data, so the engine captures them into its CUDA graphs too.

``tracked_block_bytes`` is the reference's analytic footprint of one
call: the f32 score block for ``stream`` and ``materialized`` (the
reference's formula and tile at the call's shapes: ``_select_tile`` over
the ring, ``paged_tile`` over a page; the card's padded row blocks are not
counted), the split-KV workspace (``_workspace_size``) for ``pallas``.
``peak_tracked_bytes`` records it for the plain routes only, whose
footprint the reference's formula describes; the kernel route does no
bookkeeping.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_attention import ref as _ref

_SOURCE = Path(__file__).parent / "csrc" / "chunk_attention.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "chunk_attention_launch": [
        _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    "chunk_attention_paged_launch": [
        _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]}

BACKENDS = ("auto", "pallas", "stream", "materialized")
#: query rows a block of the plain twins on a CUDA tensor (``ref.py``)
PLAIN_ROW_BLOCK = 64
MAX_HEAD_DIM = 256  # and a multiple of 8 (csrc MAX_HD)
PART_SLOTS = 128  # key slots per part of the split-KV walk (csrc MAX_PART)
ROW_TILE = 32     # query rows per block (csrc RT)


@functools.lru_cache(maxsize=None)
def split_ranges(n: int) -> Tuple[Tuple[int, int], ...]:
    """The kernel's parts of ``n`` logical key slots (the ring's cap, or the
    chunk's L): ranges of ``PART_SLOTS`` in order, the last one ragged. They
    depend on ``n`` alone, never on the batch, the lengths, the fill or the
    window; the kernel combines a row's parts in this order, ring parts
    first."""
    return tuple((s, min(s + PART_SLOTS, n)) for s in range(0, n, PART_SLOTS))


_WORKSPACES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
# outgrown workspaces by (device, stream), kept until release_workspace: a
# CUDA graph captured before a growth still reads and writes them at every
# replay
_RETIRED: Dict[tuple, List[Tuple[torch.Tensor, torch.Tensor]]] = {}


def _workspace_size(b: int, kv: int, rows: int, hd: int, n_parts: int):
    """(scratch floats, arrival counters) of a call."""
    n_idx = b * kv * -(-rows // ROW_TILE)
    return n_idx * n_parts * ROW_TILE * (hd + 2), n_idx


@functools.lru_cache(maxsize=None)
def paged_tile(page_size: int, L: int) -> int:
    """Largest divisor of ``page_size`` with L·tile <= the reference's
    tile target: the reference's tile over a page (one tile never spans
    two pages)."""
    target = max(1, _ref._TILE_ELEMS // max(L, 1))
    if page_size <= target:
        return page_size
    return max(d for d in range(1, target + 1) if page_size % d == 0)


def tracked_block_bytes(b: int, kv: int, g: int, L: int, cap: int, *,
                        backend: str, tile: Optional[int] = None,
                        hd: Optional[int] = None) -> int:
    """Analytic peak bytes of one call: the f32 score block of ``stream``
    (L × ``tile``, by default ``_select_tile(cap, L)``) and
    ``materialized`` (L × (cap + L)), as the reference counts them; the
    split-KV workspace of ``pallas`` (its f32 scratch and int32 arrival
    counters; needs ``hd``). ``cap`` is the ring's (paged: the virtual
    ring's) slots."""
    if backend == "pallas":
        floats, n_idx = _workspace_size(
            b, kv, L * g, hd, len(split_ranges(cap)) + len(split_ranges(L)))
        return 4 * (floats + n_idx)
    if backend == "materialized":
        width = cap + L
    else:
        width = tile if tile is not None else _ref._select_tile(cap, L)
    return 4 * b * kv * g * L * width


_TRACK = {"peak_bytes": 0}
_TRACK_LOCK = threading.Lock()


def reset_tracking() -> None:
    with _TRACK_LOCK:
        _TRACK["peak_bytes"] = 0


def peak_tracked_bytes() -> int:
    """Largest footprint ``tracked_block_bytes`` gave a call of a plain
    route since the last ``reset_tracking()``."""
    return _TRACK["peak_bytes"]


def resolve_chunk_backend(backend: Optional[str], device) -> str:
    """``auto``/None → ``pallas`` on a CUDA device, ``stream`` elsewhere;
    another name of ``BACKENDS`` as given; anything else raises the
    reference's ValueError."""
    if backend in (None, "auto"):
        return "pallas" if torch.device(device).type == "cuda" else "stream"
    if backend not in BACKENDS:
        raise ValueError(f"unknown chunk-attention backend {backend!r}")
    return backend


def _route(backend, q, cap, tile=None):
    """Resolve ``backend`` for q and, on a plain route, record the call's
    footprint (the reference's ``tile``); returns the backend and the
    plain twins' ``row_block``."""
    b, L, kv, g, hd = q.shape
    backend = resolve_chunk_backend(backend, q.device)
    if backend != "pallas":
        used = tracked_block_bytes(b, kv, g, L, cap, backend=backend,
                                   tile=tile)
        with _TRACK_LOCK:
            _TRACK["peak_bytes"] = max(_TRACK["peak_bytes"], used)
    return backend, (PLAIN_ROW_BLOCK if q.is_cuda else None)


def _ensure(dev, stream: int, need: int, n_idx: int):
    key = (dev.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < need or ws[1].numel() < n_idx:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the chunk-attention workspace would grow while a CUDA graph "
                "is being captured: reserve_workspace() it for the largest "
                "call before the capture")
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        if ws is not None:
            _RETIRED.setdefault(key, []).append(ws)
        ws = (torch.empty(max(need, have[0]), dtype=torch.float32, device=dev),
              torch.zeros(max(n_idx, have[1], 1024), dtype=torch.int32,
                          device=dev))
        _WORKSPACES[key] = ws
    return ws


def release_workspace(device_index: int, stream: int) -> None:
    """Drop the workspace of a raw ``stream`` and those it outgrew, once
    nothing will launch there or replay a graph captured there (the engine
    that owned the stream is freed, its graphs with it)."""
    _WORKSPACES.pop((device_index, stream), None)
    _RETIRED.pop((device_index, stream), None)


def workspace(dev, b: int, kv: int, rows: int, hd: int, n_parts: int):
    """Scratch for the parts' (m, l, acc) of ``rows`` query rows per (b, kv)
    (f32, uninitialized) and the arrival counters of the in-kernel combine
    (int32, zero; each launch leaves them zero). Both are kept per device
    and stream and grown when a call needs more: launches on one stream
    never overlap, and an allocation per call costs the host-bound decode
    step more than the launch. A growth during a CUDA graph's capture
    raises (the graph would keep the address of scratch sized for another
    call); ``reserve_workspace`` sizes it beforehand."""
    need, n_idx = _workspace_size(b, kv, rows, hd, n_parts)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _ensure(dev, stream, need, n_idx)
    return ws[0], ws[1], stream


def reserve_workspace(dev, stream, b: int, kv: int, g: int, hd: int,
                      cap: int, max_len: int) -> None:
    """Size the workspace of ``stream`` (a ``torch.cuda.Stream``) for every
    call of ``b`` rows over a ring (or virtual ring) of ``cap`` slots with
    chunks of up to ``max_len`` tokens of ``kv`` × ``g`` heads, before any
    of them is captured into a CUDA graph."""
    need, n_idx = _workspace_size(
        b, kv, max_len * g, hd,
        len(split_ranges(cap)) + len(split_ranges(max_len)))
    _ensure(torch.device(dev), stream.cuda_stream, need, n_idx)


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


def _check_common(q, k_new, v_new, k_store, k_scale, v_store, v_scale,
                  positions, lengths, store_rows):
    """Validate the operands both kernels share; ``store_rows`` is the
    leading shape of the k/v storage (ring (B, cap) or pool (P, ps)).
    Returns whether the storage is int8."""
    b, L, kv, g, hd = q.shape
    dev = q.device
    if not q.is_cuda:
        raise ValueError("the chunk-attention kernels need CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"head dim {hd} must be <= {MAX_HEAD_DIM} and a "
                         "multiple of 8")
    int8 = k_store.dtype == torch.int8
    if not int8 and k_store.dtype != q.dtype:
        raise TypeError(f"a float ring must have q's dtype {q.dtype}, got "
                        f"{k_store.dtype}")
    _require(q, "q", q.dtype, (b, L, kv, g, hd), dev)
    _require(k_new, "k_new", q.dtype, (b, L, kv, hd), dev)
    _require(v_new, "v_new", q.dtype, (b, L, kv, hd), dev)
    _require(k_store, "k cache", k_store.dtype, (*store_rows, kv, hd), dev)
    _require(v_store, "v cache", k_store.dtype, (*store_rows, kv, hd), dev)
    if int8 != (k_scale is not None and v_scale is not None):
        raise ValueError("an int8 ring needs k_scale and v_scale; a float "
                         "ring takes none")
    if int8:
        _require(k_scale, "k_scale", torch.float32, (*store_rows, kv), dev)
        _require(v_scale, "v_scale", torch.float32, (*store_rows, kv), dev)
    _require(positions, "positions", torch.int32, (b, L), dev)
    _require(lengths, "lengths", torch.int32, (b,), dev)
    return int8


def chunk_attention_cuda(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
                         pos_buf, positions, lengths, *,
                         window: Optional[int] = None):
    """The Hopper kernel (B2); every tensor on one CUDA device."""
    b, L, kv, g, hd = q.shape
    cap = k_cache.shape[1]
    ring_int8 = _check_common(q, k_new, v_new, k_cache, k_scale, v_cache,
                              v_scale, positions, lengths, (b, cap))
    _require(pos_buf, "pos_buf", torch.int32, (b, cap), q.device)
    out = torch.empty((b, L, kv, g, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    scratch, counters, stream = workspace(
        q.device, b, kv, L * g, hd, len(split_ranges(cap)) + len(
            split_ranges(L)))
    lib = _build.load(_SOURCE, _SIGNATURES)
    status = lib.chunk_attention_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr(),
        int(ring_int8), k_scale.data_ptr() if ring_int8 else None,
        v_scale.data_ptr() if ring_int8 else None, pos_buf.data_ptr(),
        positions.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), b, L, kv, g, hd, cap,
        PART_SLOTS, ROW_TILE, _ref.reach_of(cap, window), float(hd ** -0.5),
        stream)
    _build.check(status, "chunk_attention_launch")
    _build.count("chunk_attention")
    return out


def chunk_attention_paged_cuda(q, k_new, v_new, k_pool, k_scale, v_pool,
                               v_scale, pos_pool, table, positions, lengths,
                               *, window: Optional[int] = None):
    """The Hopper kernel (B4); every tensor on one CUDA device. Table
    entries must be physical page ids in [0, P) (not checked: that would
    need a device sync)."""
    b, L, kv, g, hd = q.shape
    n_phys, ps = k_pool.shape[:2]
    n_pages = table.shape[1] if table.dim() == 2 else -1
    pool_int8 = _check_common(q, k_new, v_new, k_pool, k_scale, v_pool,
                              v_scale, positions, lengths, (n_phys, ps))
    _require(pos_pool, "pos_pool", torch.int32, (n_phys, ps), q.device)
    _require(table, "table", torch.int32, (b, n_pages), q.device)
    cap = n_pages * ps
    out = torch.empty((b, L, kv, g, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    scratch, counters, stream = workspace(
        q.device, b, kv, L * g, hd, len(split_ranges(cap)) + len(
            split_ranges(L)))
    lib = _build.load(_SOURCE, _SIGNATURES)
    status = lib.chunk_attention_paged_launch(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        int(q.dtype == torch.bfloat16), k_pool.data_ptr(), v_pool.data_ptr(),
        int(pool_int8), k_scale.data_ptr() if pool_int8 else None,
        v_scale.data_ptr() if pool_int8 else None, pos_pool.data_ptr(),
        table.data_ptr(), positions.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), counters.data_ptr(), b, L, kv, g,
        hd, ps, n_pages, PART_SLOTS, ROW_TILE, _ref.reach_of(cap, window),
        float(hd ** -0.5), stream)
    _build.check(status, "chunk_attention_paged_launch")
    _build.count("chunk_attention_paged")
    return out


def chunk_attention(q, k_new, v_new, k_cache, k_scale, v_cache, v_scale,
                    pos_buf, positions, lengths, *,
                    window: Optional[int] = None, backend: str = "auto"):
    """Chunk attention vs (pre-write ring ∪ in-chunk keys); returns
    (B, L, KV, G, hd) float32. ``k_scale``/``v_scale`` are None for float
    rings. ``backend``: the module docstring."""
    backend, rows = _route(backend, q, k_cache.shape[1])
    args = (q, k_new, v_new, k_cache, k_scale, v_cache, v_scale, pos_buf,
            positions, lengths)
    if backend == "pallas":
        return chunk_attention_cuda(*args, window=window)
    if backend == "stream":
        return _ref.chunk_attention_stream(*args, window=window,
                                           row_block=rows)
    return _ref.chunk_attention_materialized(*args, window=window,
                                             row_block=rows)


def chunk_attention_paged(q, k_new, v_new, k_pool, k_scale, v_pool, v_scale,
                          pos_pool, table, positions, lengths, *,
                          window: Optional[int] = None, backend: str = "auto"):
    """Chunk attention over a paged ring: pools (P, ps, KV, hd) (int8 with
    (P, ps, KV) f32 scales, or float with scales None), pos_pool (P, ps)
    int32, table (B, n_pages) int32; page 0 is the null page (pos ≡ -1).
    Returns (B, L, KV, G, hd) float32. ``backend``: the module docstring
    (``stream`` and ``materialized`` over the gathered ring)."""
    ps = k_pool.shape[1]
    backend, rows = _route(backend, q, table.shape[1] * ps,
                           paged_tile(ps, q.shape[1]))
    args = (q, k_new, v_new, k_pool, k_scale, v_pool, v_scale, pos_pool,
            table, positions, lengths)
    if backend == "pallas":
        return chunk_attention_paged_cuda(*args, window=window)
    if backend == "stream":
        return _ref.chunk_attention_paged_stream(*args, window=window,
                                                 row_block=rows)
    return _ref.chunk_attention_paged_materialized(*args, window=window,
                                                   row_block=rows)
