"""Per-request token sampling, on the device.

* Greedy rows (temperature 0) take the argmax, first index on ties — the
  reference's rule, so greedy streams agree token for token.
* ``top_k_top_p_mask`` is the reference's row-wise support mask: one
  stable descending sort serves both top-k and nucleus (top-p) truncation.
* Rows with temperature > 0 draw by Gumbel-max over logits / temperature,
  with noise from a counter-based hash of (seed, i, vocabulary index), i
  the request's generated-token index. The draw is position-addressed and
  touches no shared generator state, so a request's tokens are a function
  of (params, prompt, SamplingParams) only — invariant to fleet, chunk
  boundaries and scheduler, as the determinism contract asks. It is not
  bit-compatible with ``jax.random`` (threefry): at temperature > 0 the
  port and the reference draw different tokens.
"""

from __future__ import annotations

from typing import Optional

import torch

_M32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply), on int64 tensors
    holding values in [0, 2^32); products wrap, the low 32 bits are kept."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def uniform_noise(seeds: torch.Tensor, indices: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """(B, V) uniforms in (0, 1), a pure function of (seed, index, v)."""
    dev = seeds.device
    s = seeds.to(torch.int64) & _M32
    i = indices.to(torch.int64) & _M32
    row = _mix32(_mix32(s ^ 0x9E3779B9) ^ i)                 # (B,)
    v = torch.arange(vocab, dtype=torch.int64, device=dev)
    bits = _mix32(_mix32(row[:, None] ^ ((v[None, :] * 0x85EBCA6B) & _M32)))
    return ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def top_k_top_p_mask(logits: torch.Tensor,
                     top_k: Optional[torch.Tensor] = None,
                     top_p: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Row-wise sampling support: True where a token stays eligible.

    logits (B, V); top_k (B,) int, 0 disables the row; top_p (B,) float,
    1.0 disables the row. Top-p keeps the smallest probability-sorted
    prefix whose mass reaches top_p (the top token always survives)."""
    v = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_l = torch.gather(logits, -1, order)
    keep = torch.ones_like(logits, dtype=torch.bool)
    ar = torch.arange(v, device=logits.device)[None, :]
    if top_k is not None:
        k = torch.where(top_k > 0, top_k, v).to(torch.int64)[:, None]
        keep &= ar < k
    if top_p is not None:
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        tp = top_p.to(torch.float32)[:, None]
        keep &= ((cum - probs) < tp) | (tp >= 1.0)
    return torch.zeros_like(keep).scatter(-1, order, keep)


def sample_tokens_per_request(logits: torch.Tensor, seeds: torch.Tensor,
                              indices: torch.Tensor,
                              temperatures: torch.Tensor, *,
                              top_k: Optional[torch.Tensor] = None,
                              top_p: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """logits (B, V); seeds (B,) request seeds; indices (B,) generated-token
    index per row; temperatures (B,) -> tokens (B,) int32."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp(temperatures.to(torch.float32), min=1e-6)[:, None]
    scaled = logits.to(torch.float32) / t
    if top_k is not None or top_p is not None:
        keep = top_k_top_p_mask(scaled, top_k, top_p)
        scaled = torch.where(keep, scaled, float("-inf"))
    u = uniform_noise(seeds, indices, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperatures <= 0.0, greedy, sampled)
