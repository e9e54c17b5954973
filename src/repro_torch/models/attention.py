"""GQA attention with the ring or the paged KV cache (the reference's two
layouts).

The ring cache is a ring buffer per layer with per-slot absolute
positions (``pos`` = -1 for empty): ``k``/``v`` (B, cap, KV, hd) in the
activation dtype, or int8 with per-(slot, kv-head) absmax scales when
``kv_cache_dtype == "int8"``. The paged cache virtualizes each row's ring
into ``page_size``-slot pages of one pool shared by every row: leaves
``pages_k``/``pages_v`` (P, ps, KV, hd) (int8 with ``pages_ks``/
``pages_vs`` (P, ps, KV) scales), ``pages_pos`` (P, ps) and a per-row
``table`` (B, n_pages) of physical page ids; logical slot s of row b is
``pool[table[b, s // ps], s % ps]``. Page 0 is the null page (pos ≡ -1,
never written), so unmapped logical pages read as empty; the host-side
``serving.paging.PageAllocator`` owns the ids.

Every serving-time attention read — chunk prefill and single-token decode
(its L = 1 case) — goes through ``repro_torch.kernels.chunk_attention``
(``chunk_attention_paged`` for the paged layout) against (pre-write ring ∪
in-chunk keys) under one mask rule, on the route ``cfg.attn_backend``
names, then the chunk's keys are written.

Unlike the reference, caches are updated in place: a serving step would
otherwise copy every layer's cache. A ring write that the reference drops
(the cap-sentinel slot: right padding, rows with ``active=False``, and
entries a row's own chunk tail overwrites) rewrites the slot's old value
instead, which leaves the ring exactly as the reference's drop does. A
paged write that the reference drops (those, and writes through an
unmapped page) lands on one scratch page past the allocatable pages that
nothing reads, so no index that is read is written twice in one scatter
and neither the null page nor a live page is touched.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.chunk_attention.ops import (chunk_attention,
                                                     chunk_attention_paged)
from repro_torch.models.common import Dense, apply_rope

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg, *, dtype=torch.float32, device="cpu"):
        super().__init__()
        hd = cfg.head_dim
        d = cfg.d_model
        self.wq = Dense(d, cfg.n_heads * hd, bias=cfg.qkv_bias, dtype=dtype,
                        device=device)
        self.wk = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dtype, device=device)
        self.wv = Dense(d, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        dtype=dtype, device=device)
        self.wo = Dense(cfg.n_heads * hd, d, dtype=dtype, device=device)


def _qkv(attn: Attention, cfg, x, rope):
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = attn.wq(x).reshape(b, s, cfg.n_heads, hd)
    k = attn.wk(x).reshape(b, s, cfg.n_kv_heads, hd)
    v = attn.wv(x).reshape(b, s, cfg.n_kv_heads, hd)
    return apply_rope(q, rope), apply_rope(k, rope), v


def attention_forward(attn: Attention, cfg, x, positions, rope, *,
                      window: Optional[int] = None):
    """Full-sequence causal (optionally sliding-window) attention.

    x: (B, S, D); positions: (S,) absolute positions; rope: their
    ``rope_tables``, shaped for (1, S)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(attn, cfg, x, rope)
    q = q.reshape(b, s, kv, g, hd).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k.to(torch.float32)) \
        * (hd ** -0.5)
    dist = positions[:, None] - positions[None, :]
    mask = dist >= 0
    if window is not None:
        mask = mask & (dist < window)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    y = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return attn.wo(y.reshape(b, s, cfg.n_heads * hd).to(x.dtype))


def cache_init(cfg, batch: int, capacity: int, window: Optional[int], dtype,
               device) -> Dict[str, torch.Tensor]:
    """Ring cache; capacity = min(window, max_context) for local layers."""
    cap = min(window, capacity) if window else capacity
    hd = cfg.head_dim
    shape = (batch, cap, cfg.n_kv_heads, hd)
    cache = {"pos": torch.full((batch, cap), -1, dtype=torch.int32,
                               device=device)}
    if cfg.kv_cache_dtype == "int8":
        cache["k"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["v"] = torch.zeros(shape, dtype=torch.int8, device=device)
        cache["k_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


# f32(1/127): the reference's ``max|x| / 127.0`` runs under ``jax.jit``,
# where XLA rewrites division by a constant as a multiply by its f32
# reciprocal; multiplying here gives the reference engine's scales bit for
# bit (a true division differs in ~1 % of them)
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def paged_pool(cfg, n_layers: int, capacity: int, window: Optional[int],
               dtype, device, *, page_size: int, max_pages: int
               ) -> Dict[str, torch.Tensor]:
    """The paged pool of ``n_layers`` layers, each leaf one tensor
    (n_layers, P, ps, ...) so a copy-on-write page copy or a page clear is
    one indexed copy per leaf. P = max_pages + 2: the null page 0, the
    allocatable pages 1..max_pages, and the scratch page P - 1 that dropped
    writes land on (never in a table, never read).

    Sliding-window layers are rejected, as in the reference: paging
    virtualizes one uniform logical capacity per row."""
    if window is not None and window < capacity:
        raise ValueError(
            f"paged KV layout requires full-capacity attention layers "
            f"(window {window} < capacity {capacity}); use the ring layout "
            "for sliding-window models")
    if capacity % page_size:
        raise ValueError(f"page_size {page_size} must divide "
                         f"capacity {capacity}")
    shape = (n_layers, max_pages + 2, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    pool = {"pages_pos": torch.full(shape[:3], -1, dtype=torch.int32,
                                    device=device)}
    kv_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    pool["pages_k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
    pool["pages_v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
    if cfg.kv_cache_dtype == "int8":
        pool["pages_ks"] = torch.zeros(shape[:4], dtype=torch.float32,
                                       device=device)
        pool["pages_vs"] = torch.zeros(shape[:4], dtype=torch.float32,
                                       device=device)
    return pool


def paged_cache_init(cfg, batch: int, capacity: int, window: Optional[int],
                     dtype, device, *, page_size: int, max_pages: int
                     ) -> Dict[str, torch.Tensor]:
    """One layer's paged cache: its ``pages_*`` pool leaves (P, ps, ...)
    (see ``paged_pool``) and a zeroed ``table`` (B, capacity / page_size)
    int32 — every logical page on the null page."""
    pool = paged_pool(cfg, 1, capacity, window, dtype, device,
                      page_size=page_size, max_pages=max_pages)
    cache = {name: leaf[0] for name, leaf in pool.items()}
    cache["table"] = torch.zeros((batch, capacity // page_size),
                                 dtype=torch.int32, device=device)
    return cache


def _q8(x):
    """absmax int8 quantization over the trailing (head) dim."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) * _INV127, min=1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _scatter_slots(buf, idx, vals, keep):
    """buf (B, cap, ...) <- vals (B, S, ...) at ``idx = (rows, slots)``,
    each (B, S), where ``keep``; elsewhere the slot keeps its value (the
    reference's dropped write). Slots of one row are distinct when
    S <= cap (consecutive positions), so the indexed write has no
    collisions and is deterministic. A chunk longer than the ring (a
    sliding-window layer's ring under a wider prefill chunk) keeps only its
    last ``cap`` valid entries, whose slots are again distinct: every slot
    gathers the one kept entry that lands on it, if any, so no two
    positions are ever scattered into one slot (and no shape depends on
    the data)."""
    vals = vals.to(buf.dtype)
    b, s = keep.shape
    cap = buf.shape[1]
    if s > cap:
        slots = torch.arange(cap, device=buf.device)
        hit = keep[:, :, None] & (idx[1][:, :, None] == slots)  # (B, S, cap)
        order = torch.arange(1, s + 1, device=buf.device)[None, :, None]
        j = (hit.to(torch.int64) * order).amax(1) - 1           # (B, cap)
        tail = (1,) * (vals.dim() - 2)
        src = torch.gather(vals, 1, torch.clamp(j, min=0).reshape(
            (b, cap) + tail).expand((b, cap) + tuple(vals.shape[2:])))
        buf.copy_(torch.where((j >= 0).reshape((b, cap) + tail), src, buf))
        return
    k = keep.reshape(keep.shape + (1,) * (vals.dim() - 2))
    buf[idx] = torch.where(k, vals, buf[idx])


def _page_rows(cache, slots, keep):
    """Flat pool rows (B·S,) of logical ring ``slots`` (B, S) through the
    cache's table, for the entries where ``keep``. Entries not kept, or
    whose logical page is unmapped (table entry 0, the null page), get a row
    of the scratch page P - 1 instead. Kept rows are distinct: a row's kept
    slots are distinct (as in the ring), and distinct rows never map a
    written page to the same physical page (the engine forks shared pages
    before any dispatch that writes them)."""
    n_phys, ps = cache["pages_pos"].shape
    slots = slots.long()
    phys = torch.gather(cache["table"], 1,
                        torch.div(slots, ps, rounding_mode="floor")).long()
    flat = torch.where(keep & (phys != 0), phys * ps + slots % ps,
                       (n_phys - 1) * ps)
    return flat.reshape(-1)


def _scatter_pages(pool, rows, vals):
    """Paged analogue of ``_scatter_slots``: pool (P, ps, ...) <- vals
    (B, S, ...) at the flat pool ``rows`` (B·S,) of ``_page_rows``."""
    n_phys, ps = pool.shape[0], pool.shape[1]
    pool.view((n_phys * ps,) + tuple(pool.shape[2:]))[rows] = vals.reshape(
        (-1,) + tuple(vals.shape[2:])).to(pool.dtype)


def _write(cache, slots, keep, k, v, positions):
    if "table" in cache:
        rows = _page_rows(cache, slots, keep)
        scatter = lambda name, vals: _scatter_pages(  # noqa: E731
            cache[name], rows, vals)
        names = ("pages_pos", "pages_k", "pages_v", "pages_ks", "pages_vs")
    else:
        b, s = slots.shape
        idx = (torch.arange(b, device=slots.device)[:, None].expand(b, s),
               slots.long())
        scatter = lambda name, vals: _scatter_slots(  # noqa: E731
            cache[name], idx, vals, keep)
        names = ("pos", "k", "v", "k_scale", "v_scale")
    scatter(names[0], positions.to(torch.int32))
    if names[3] in cache:
        kq, ks = _q8(k)
        vq, vs = _q8(v)
        scatter(names[1], kq)
        scatter(names[2], vq)
        scatter(names[3], ks)
        scatter(names[4], vs)
    else:
        scatter(names[1], k)
        scatter(names[2], v)


def _attend(cfg, cache, q, k, v, positions, lengths, window):
    """Chunk attention of q against (``cache`` before the write ∪ k/v),
    through the ring or the paged op, on ``cfg.attn_backend``."""
    if "table" in cache:
        return chunk_attention_paged(
            q, k, v, cache["pages_k"], cache.get("pages_ks"),
            cache["pages_v"], cache.get("pages_vs"), cache["pages_pos"],
            cache["table"], positions, lengths, window=window,
            backend=cfg.attn_backend)
    return chunk_attention(
        q, k, v, cache["k"], cache.get("k_scale"), cache["v"],
        cache.get("v_scale"), cache["pos"], positions, lengths,
        window=window, backend=cfg.attn_backend)


def _capacity(cache) -> int:
    if "table" in cache:
        return cache["table"].shape[1] * cache["pages_k"].shape[1]
    return cache["k"].shape[1]


def attention_prefill_chunk(attn: Attention, cfg, cache, x, positions,
                            lengths, rope, *, window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Padded-batch chunk prefill: attend to (cache ∪ chunk), then write.

    x: (B, L, D) right-padded chunk; positions: (B, L) int32 absolute
    positions, ``rope`` their ``rope_tables``; lengths: (B,) int32 valid
    counts (0 makes the row a no-op). Returns (y, cache) with the cache
    updated in place.
    """
    b, L, _ = x.shape
    hd = cfg.head_dim
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cap = _capacity(cache)
    q, k, v = _qkv(attn, cfg, x, rope)
    y = _attend(cfg, cache, q.reshape(b, L, kv, g, hd).contiguous(),
                k.contiguous(), v.contiguous(), positions, lengths, window)
    y = attn.wo(y.reshape(b, L, cfg.n_heads * hd).to(x.dtype))

    valid = torch.arange(L, device=x.device)[None, :] < lengths[:, None]
    row_end = positions[:, :1] + lengths[:, None]
    keep = valid & (positions >= row_end - cap)
    _write(cache, positions % cap, keep, k, v, positions)
    return y, cache


def attention_decode(attn: Attention, cfg, cache, x_t, pos, rope, *,
                     window: Optional[int] = None,
                     active: Optional[torch.Tensor] = None):
    """One-token decode. x_t: (B, D); pos: (B,) int32 absolute position,
    ``rope`` its ``rope_tables``.

    Rows with active=False attend with length 0 and leave the cache
    untouched. Returns (y, cache) with the cache updated in place."""
    b, _ = x_t.shape
    hd = cfg.head_dim
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cap = _capacity(cache)
    q = attn.wq(x_t).reshape(b, cfg.n_heads, hd)
    k_t = attn.wk(x_t).reshape(b, kv, hd)
    v_t = attn.wv(x_t).reshape(b, kv, hd)
    q = apply_rope(q, rope)
    k_t = apply_rope(k_t, rope)
    lengths = (active.to(torch.int32) if active is not None
               else torch.ones((b,), dtype=torch.int32, device=x_t.device))
    y = _attend(cfg, cache, q.reshape(b, 1, kv, g, hd).contiguous(),
                k_t[:, None].contiguous(), v_t[:, None].contiguous(),
                pos[:, None].to(torch.int32).contiguous(), lengths, window)
    y = attn.wo(y.reshape(b, cfg.n_heads * hd).to(x_t.dtype))
    keep = (lengths > 0)[:, None]
    _write(cache, (pos % cap)[:, None], keep, k_t[:, None], v_t[:, None],
           pos[:, None])
    return y, cache
