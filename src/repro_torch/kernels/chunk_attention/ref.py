"""Plain PyTorch version of chunk attention over the ring cache.

The mask rule and the online-softmax walk of the reference package
(``kernels/chunk_attention/ref.py`` and the ``_stream`` path of its
``ops.py``): the chunk's queries score against the ring *before* the chunk
is written, tile by tile, then against the chunk's own keys as the last
tile. A query at absolute position p sees a key at position s iff
``0 <= p - s < reach``, ``reach = min(window or cap, cap)``; ring slots also
need ``pos >= 0`` and chunk keys ``j < length``. Rows that see nothing
output zeros.

``chunk_attention_materialized`` is the reference's ``chunk_attention_ref``
(its ``materialized`` backend): the whole (L, cap + L) score block and one
softmax. A row that sees nothing comes out as the uniform mix of every
value there (the softmax of a row of NEG_INF), not zeros, as in the
reference.

The paged form gathers the virtual ring ``ring[b, p·ps + o] =
pool[table[b, p], o]`` (``gather_pages``, the reference's definition of
paged semantics) and runs the same walk over it.

``row_block`` (both twins; the ops pass it for CUDA tensors): the chunk
is zero-padded to a multiple of ``row_block`` query rows and walked in
blocks of that many rows; the ring in tiles chosen for ``row_block`` rows;
the chunk's own keys in tiles of ``row_block`` up to the end of the
query block (later keys are all in a query's future). Every product then
has one shape whatever the chunk's length L, so a row's bits do not
depend on the prefill bucket its fleet puts it in (cuBLAS picks its
kernel, and with it a row's order of summation, by the product's shape).
Without it (CPU tensors) the walk is the reference's: one block of L
rows, the ring in ``_select_tile(cap, L)`` tiles, the chunk's keys as one
last tile of L.
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


def _blocks(L: int, row_block):
    """(padded length, rows a block) of a chunk of L query rows."""
    if row_block is None:
        return L, L
    return -(-L // row_block) * row_block, row_block


def _pad_rows(x, lp: int):
    """x (B, L, ...) zero-padded to (B, lp, ...)."""
    pad = lp - x.shape[1]
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(x.shape[2:]))],
                     dim=1)


def chunk_attention_stream(q, k_new, v_new, k_cache, k_scale, v_cache,
                           v_scale, pos_buf, positions, lengths, *,
                           window: Optional[int] = None,
                           tile: Optional[int] = None,
                           row_block: Optional[int] = None):
    """Online-softmax walk over ring tiles; chunk keys fold in last.

    Shapes: q (B, L, KV, G, hd); k_new/v_new (B, L, KV, hd); ring
    (B, cap, KV, hd) float (scales None) or int8 with (B, cap, KV) f32
    scales; pos_buf (B, cap), positions (B, L), lengths (B,) int32.
    ``row_block``: see the module docstring. Returns (B, L, KV, G, hd)
    float32.
    """
    b, L, kv, g, hd = q.shape
    cap = k_cache.shape[1]
    reach = reach_of(cap, window)
    lp, rows = _blocks(L, row_block)
    t = min(tile if tile is not None else _select_tile(cap, rows), cap)
    while cap % t:
        t -= 1
    positions = _pad_rows(positions, lp)
    qf = _pad_rows(q, lp).to(torch.float32).permute(0, 2, 3, 1, 4) * (
        hd ** -0.5)
    kn = _pad_rows(k_new, lp).to(torch.float32)
    vn = _pad_rows(v_new, lp).to(torch.float32)
    self_mask = chunk_mask(positions, lengths, reach)      # (B, lp, lp)
    dev = q.device
    outs = []
    for r0 in range(0, lp, rows):
        qb, pb = qf[:, :, :, r0:r0 + rows], positions[:, r0:r0 + rows]
        carry = (torch.full((b, kv, g, rows), NEG_INF, dtype=torch.float32,
                            device=dev),
                 torch.zeros((b, kv, g, rows), dtype=torch.float32,
                             device=dev),
                 torch.zeros((b, kv, g, rows, hd), dtype=torch.float32,
                             device=dev))
        for i in range(cap // t):
            sl = slice(i * t, (i + 1) * t)
            k = _deq(k_cache[:, sl],
                     None if k_scale is None else k_scale[:, sl])
            v = _deq(v_cache[:, sl],
                     None if v_scale is None else v_scale[:, sl])
            carry = _stream_update(qb, carry, k, v,
                                   history_mask(pos_buf[:, sl], pb, reach))
        for j0 in range(0, r0 + rows, rows):
            sl = slice(j0, j0 + rows)
            carry = _stream_update(qb, carry, kn[:, sl], vn[:, sl],
                                   self_mask[:, r0:r0 + rows, sl])
        m, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=3)
    return out[:, :, :, :L].permute(0, 3, 1, 2, 4).contiguous()


def chunk_attention_materialized(q, k_new, v_new, k_cache, k_scale, v_cache,
                                 v_scale, pos_buf, positions, lengths, *,
                                 window: Optional[int] = None,
                                 row_block: Optional[int] = None):
    """The reference's ``chunk_attention_ref``: the (L, cap + L) score
    block of history and chunk keys, one softmax, one product with the
    values; shapes as ``chunk_attention_stream``. With ``row_block`` each
    block of rows scores the ring and the chunk's keys up to its own end.
    Returns (B, L, KV, G, hd) float32."""
    b, L, kv, g, hd = q.shape
    cap = k_cache.shape[1]
    reach = reach_of(cap, window)
    lp, rows = _blocks(L, row_block)
    positions = _pad_rows(positions, lp)
    qf = _pad_rows(q, lp).to(torch.float32) * (hd ** -0.5)
    kn = _pad_rows(k_new, lp).to(torch.float32)
    vn = _pad_rows(v_new, lp).to(torch.float32)
    kc = _deq(k_cache, k_scale)                              # (B, cap, KV, hd)
    vc = _deq(v_cache, v_scale)
    self_mask = chunk_mask(positions, lengths, reach)      # (B, lp, lp)
    outs = []
    for r0 in range(0, lp, rows):
        end = r0 + rows
        qb, pb = qf[:, r0:end], positions[:, r0:end]
        s_hist = torch.einsum("blkgd,bskd->bkgls", qb, kc)
        s_hist = torch.where(history_mask(pos_buf, pb, reach)[:, None, None],
                             s_hist, NEG_INF)
        s_self = torch.einsum("blkgd,bjkd->bkglj", qb, kn[:, :end])
        s_self = torch.where(self_mask[:, None, None, r0:end, :end], s_self,
                             NEG_INF)
        p = torch.softmax(torch.cat([s_hist, s_self], dim=-1), dim=-1)
        v_all = torch.cat([vc, vn[:, :end]], dim=1)
        outs.append(torch.einsum("bkgls,bskd->blkgd", p, v_all))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out[:, :L]


def gather_pages(pool, table):
    """The logical (B, n_pages·ps, ...) ring of a paged cache:
    ``ring[b, p·ps + o] = pool[table[b, p], o]``. Page 0 is the null page
    (pos ≡ -1), so unmapped entries gather as empty slots."""
    b, n = table.shape
    flat = pool[table.reshape(-1).long()]
    return flat.reshape((b, n * pool.shape[1]) + tuple(pool.shape[2:]))


def _gathered(twin, q, k_new, v_new, k_pool, k_scale, v_pool, v_scale,
              pos_pool, table, positions, lengths, **kw):
    def g(x):
        return None if x is None else gather_pages(x, table)

    return twin(q, k_new, v_new, g(k_pool), g(k_scale), g(v_pool),
                g(v_scale), g(pos_pool), positions, lengths, **kw)


def chunk_attention_paged_stream(q, k_new, v_new, k_pool, k_scale, v_pool,
                                 v_scale, pos_pool, table, positions, lengths,
                                 *, window: Optional[int] = None,
                                 tile: Optional[int] = None,
                                 row_block: Optional[int] = None):
    """``chunk_attention_stream`` over the gathered virtual ring: pools
    (P, ps, KV, hd), scales (P, ps, KV) or None, pos_pool (P, ps), table
    (B, n_pages). Returns (B, L, KV, G, hd) float32."""
    return _gathered(chunk_attention_stream, q, k_new, v_new, k_pool,
                     k_scale, v_pool, v_scale, pos_pool, table, positions,
                     lengths, window=window, tile=tile, row_block=row_block)


def chunk_attention_paged_materialized(q, k_new, v_new, k_pool, k_scale,
                                       v_pool, v_scale, pos_pool, table,
                                       positions, lengths, *,
                                       window: Optional[int] = None,
                                       row_block: Optional[int] = None):
    """``gather_pages`` then ``chunk_attention_materialized`` (the
    reference's paged ``materialized`` backend)."""
    return _gathered(chunk_attention_materialized, q, k_new, v_new, k_pool,
                     k_scale, v_pool, v_scale, pos_pool, table, positions,
                     lengths, window=window, row_block=row_block)
