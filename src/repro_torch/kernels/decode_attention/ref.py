"""Plain PyTorch version of one-token GQA decode attention over an int8
ring, *after* the token's own write (the reference's
``kernels/decode_attention/ref.py``).

A slot is visible iff ``pos_buf >= 0 ∧ pos_buf <= pos ∧ pos − pos_buf <
(window or S + 1)``. Masked logits are set to -1e30 and the softmax is
taken without a re-mask after ``exp``, so a row whose slots are all masked
returns the uniform mean of v over the whole ring, not zeros — the
reference op and its oracle both do this.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def visible(pos_buf, pos, window: Optional[int]):
    """(B, S) bool: slot s of row b is visible to the query at pos[b]."""
    w_eff = window if window else pos_buf.shape[1] + 1
    pb = pos_buf.to(torch.int64)
    p = pos.to(torch.int64)[:, None]
    return (pb >= 0) & (pb <= p) & (p - pb < w_eff)


def decode_attention_plain(q, k8, k_scale, v8, v_scale, pos_buf, pos, *,
                           window: Optional[int] = None):
    """q (B, KV, G, hd) float; k8/v8 (B, S, KV, hd) int8; scales (B, S, KV)
    f32; pos_buf (B, S) int32; pos (B,) int32 -> (B, KV, G, hd) f32."""
    hd = k8.shape[-1]
    k = k8.to(torch.float32) * k_scale[..., None].to(torch.float32)
    v = v8.to(torch.float32) * v_scale[..., None].to(torch.float32)
    logits = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32), k) \
        * (hd ** -0.5)
    logits = torch.where(visible(pos_buf, pos, window)[:, None, None, :],
                         logits, NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgs,bskd->bkgd", p, v)
