"""Plain PyTorch version of chunk attention over the ring cache.

The mask rule and the online-softmax walk of the reference package
(``kernels/chunk_attention/ref.py`` and the ``_stream`` path of its
``ops.py``): the chunk's queries score against the ring *before* the chunk
is written, tile by tile, then against the chunk's own keys as the last
tile. A query at absolute position p sees a key at position s iff
``0 <= p - s < reach``, ``reach = min(window or cap, cap)``; ring slots also
need ``pos >= 0`` and chunk keys ``j < length``. Rows that see nothing
output zeros.

The paged form gathers the virtual ring ``ring[b, p·ps + o] =
pool[table[b, p], o]`` (``gather_pages``, the reference's definition of
paged semantics) and runs the same walk over it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

NEG_INF = -1e30
# target elements per (G·L, tile) score block, as in the reference
_TILE_ELEMS = 8192


def reach_of(cap: int, window: Optional[int]) -> int:
    """Maximum causal distance a query may look back."""
    return min(window, cap) if window else cap


def history_mask(pos_buf, positions, reach: int):
    """(B, L, cap) bool: chunk query l of row b sees ring slot s."""
    d = positions[:, :, None] - pos_buf[:, None, :]
    return (pos_buf[:, None, :] >= 0) & (d >= 0) & (d < reach)


def chunk_mask(positions, lengths, reach: int):
    """(B, L, L) bool: chunk query l sees in-chunk key j (causal + valid)."""
    L = positions.shape[1]
    j = torch.arange(L, device=positions.device)
    valid = j[None, None, :] < lengths[:, None, None]
    d = positions[:, :, None] - positions[:, None, :]
    return valid & (d >= 0) & (d < reach)


def _deq(c, scale):
    c = c.to(torch.float32)
    return c if scale is None else c * scale[..., None].to(torch.float32)


@functools.lru_cache(maxsize=None)
def _select_tile(cap: int, L: int) -> int:
    """Largest divisor of cap with L·tile <= _TILE_ELEMS (reference rule)."""
    target = max(1, _TILE_ELEMS // max(L, 1))
    if cap <= target:
        return cap
    best = 1
    i = 1
    while i * i <= cap:
        if cap % i == 0:
            for d in (i, cap // i):
                if best < d <= target:
                    best = d
        i += 1
    return best if best >= min(target, 64) else cap


def _stream_update(qf, carry, k, v, valid):
    """One online-softmax step. qf (B, KV, G, L, hd) pre-scaled f32; k/v
    (B, C, KV, hd) f32; valid (B, L, C) bool; carry (m, l, acc)."""
    m, l, acc = carry
    s = torch.einsum("bkgld,bckd->bkglc", qf, k)
    vmask = valid[:, None, None]
    s = torch.where(vmask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.where(vmask, torch.exp(s - m_new[..., None]), 0.0)
    acc = acc * alpha[..., None] + torch.einsum("bkglc,bckd->bkgld", p, v)
    l = l * alpha + p.sum(dim=-1)
    return m_new, l, acc


def chunk_attention_stream(q, k_new, v_new, k_cache, k_scale, v_cache,
                           v_scale, pos_buf, positions, lengths, *,
                           window: Optional[int] = None,
                           tile: Optional[int] = None):
    """Online-softmax walk over ring tiles; chunk keys fold in last.

    Shapes: q (B, L, KV, G, hd); k_new/v_new (B, L, KV, hd); ring
    (B, cap, KV, hd) float (scales None) or int8 with (B, cap, KV) f32
    scales; pos_buf (B, cap), positions (B, L), lengths (B,) int32.
    Returns (B, L, KV, G, hd) float32.
    """
    b, L, kv, g, hd = q.shape
    cap = k_cache.shape[1]
    reach = reach_of(cap, window)
    t = min(tile if tile is not None else _select_tile(cap, L), cap)
    while cap % t:
        t -= 1
    qf = q.to(torch.float32).permute(0, 2, 3, 1, 4) * (hd ** -0.5)
    dev = q.device
    carry = (torch.full((b, kv, g, L), NEG_INF, dtype=torch.float32, device=dev),
             torch.zeros((b, kv, g, L), dtype=torch.float32, device=dev),
             torch.zeros((b, kv, g, L, hd), dtype=torch.float32, device=dev))
    for i in range(cap // t):
        sl = slice(i * t, (i + 1) * t)
        k = _deq(k_cache[:, sl], None if k_scale is None else k_scale[:, sl])
        v = _deq(v_cache[:, sl], None if v_scale is None else v_scale[:, sl])
        carry = _stream_update(qf, carry, k, v,
                               history_mask(pos_buf[:, sl], positions, reach))
    m, l, acc = _stream_update(qf, carry, k_new.to(torch.float32),
                               v_new.to(torch.float32),
                               chunk_mask(positions, lengths, reach))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).contiguous()


def gather_pages(pool, table):
    """The logical (B, n_pages·ps, ...) ring of a paged cache:
    ``ring[b, p·ps + o] = pool[table[b, p], o]``. Page 0 is the null page
    (pos ≡ -1), so unmapped entries gather as empty slots."""
    b, n = table.shape
    flat = pool[table.reshape(-1).long()]
    return flat.reshape((b, n * pool.shape[1]) + tuple(pool.shape[2:]))


def chunk_attention_paged_stream(q, k_new, v_new, k_pool, k_scale, v_pool,
                                 v_scale, pos_pool, table, positions, lengths,
                                 *, window: Optional[int] = None,
                                 tile: Optional[int] = None):
    """``chunk_attention_stream`` over the gathered virtual ring: pools
    (P, ps, KV, hd), scales (P, ps, KV) or None, pos_pool (P, ps), table
    (B, n_pages). Returns (B, L, KV, G, hd) float32."""
    def g(x):
        return None if x is None else gather_pages(x, table)

    return chunk_attention_stream(
        q, k_new, v_new, g(k_pool), g(k_scale), g(v_pool), g(v_scale),
        g(pos_pool), positions, lengths, window=window, tile=tile)
