"""GQA attention with the ring KV cache (the reference's ring layout).

The decode cache is a ring buffer per layer with per-slot absolute
positions (``pos`` = -1 for empty): ``k``/``v`` (B, cap, KV, hd) in the
activation dtype, or int8 with per-(slot, kv-head) absmax scales when
``kv_cache_dtype == "int8"``. Every serving-time attention read — chunk
prefill and single-token decode (its L = 1 case) — goes through
``repro_torch.kernels.chunk_attention`` against (pre-write ring ∪ in-chunk
keys) under one mask rule, then the chunk's keys are written.

Unlike the reference, the cache is updated in place: a serving step would
otherwise copy every layer's ring. A write that the reference drops (the
cap-sentinel slot: right padding, rows with ``active=False``, and entries a
row's own chunk tail overwrites) rewrites the slot's old value instead,
which leaves the ring exactly as the reference's drop does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.chunk_attention.ops import chunk_attention
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


def _q8(x):
    """absmax int8 quantization over the trailing (head) dim."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _scatter_slots(buf, idx, vals, keep):
    """buf (B, cap, ...) <- vals (B, S, ...) at ``idx = (rows, slots)``,
    each (B, S), where ``keep``; elsewhere the slot keeps its value (the
    reference's dropped write). Slots of one row are distinct when
    S <= cap (consecutive positions), so the indexed write has no
    collisions and is deterministic; longer chunks write only the kept
    entries."""
    vals = vals.to(buf.dtype)
    if keep.shape[1] > buf.shape[1]:
        buf[idx[0][keep], idx[1][keep]] = vals[keep]
        return
    k = keep.reshape(keep.shape + (1,) * (vals.dim() - 2))
    buf[idx] = torch.where(k, vals, buf[idx])


def _write(cache, slots, keep, k, v, positions):
    b, s = slots.shape
    idx = (torch.arange(b, device=slots.device)[:, None].expand(b, s),
           slots.long())
    _scatter_slots(cache["pos"], idx, positions.to(torch.int32), keep)
    if "k_scale" in cache:
        kq, ks = _q8(k)
        vq, vs = _q8(v)
        _scatter_slots(cache["k"], idx, kq, keep)
        _scatter_slots(cache["v"], idx, vq, keep)
        _scatter_slots(cache["k_scale"], idx, ks, keep)
        _scatter_slots(cache["v_scale"], idx, vs, keep)
    else:
        _scatter_slots(cache["k"], idx, k, keep)
        _scatter_slots(cache["v"], idx, v, keep)


def attention_prefill_chunk(attn: Attention, cfg, cache, x, positions,
                            lengths, rope, *, window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Padded-batch chunk prefill: attend to (ring ∪ chunk), then write.

    x: (B, L, D) right-padded chunk; positions: (B, L) int32 absolute
    positions, ``rope`` their ``rope_tables``; lengths: (B,) int32 valid
    counts (0 makes the row a no-op). Returns (y, cache) with the cache
    updated in place.
    """
    b, L, _ = x.shape
    hd = cfg.head_dim
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cap = cache["k"].shape[1]
    q, k, v = _qkv(attn, cfg, x, rope)
    y = chunk_attention(
        q.reshape(b, L, kv, g, hd).contiguous(), k.contiguous(),
        v.contiguous(), cache["k"], cache.get("k_scale"), cache["v"],
        cache.get("v_scale"), cache["pos"], positions, lengths,
        window=window)
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

    Rows with active=False attend with length 0 and leave the ring
    untouched. Returns (y, cache) with the cache updated in place."""
    b, _ = x_t.shape
    hd = cfg.head_dim
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cap = cache["k"].shape[1]
    q = attn.wq(x_t).reshape(b, cfg.n_heads, hd)
    k_t = attn.wk(x_t).reshape(b, kv, hd)
    v_t = attn.wv(x_t).reshape(b, kv, hd)
    q = apply_rope(q, rope)
    k_t = apply_rope(k_t, rope)
    lengths = (active.to(torch.int32) if active is not None
               else torch.ones((b,), dtype=torch.int32, device=x_t.device))
    y = chunk_attention(
        q.reshape(b, 1, kv, g, hd).contiguous(), k_t[:, None].contiguous(),
        v_t[:, None].contiguous(), cache["k"], cache.get("k_scale"),
        cache["v"], cache.get("v_scale"), cache["pos"],
        pos[:, None].to(torch.int32).contiguous(), lengths, window=window)
    y = attn.wo(y.reshape(b, cfg.n_heads * hd).to(x_t.dtype))
    keep = (lengths > 0)[:, None]
    _write(cache, (pos % cap)[:, None], keep, k_t[:, None], v_t[:, None],
           pos[:, None])
    return y, cache
