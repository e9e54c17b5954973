"""Per-request token sampling, on the device.

* Greedy rows (temperature 0) take the argmax, first index on ties — the
  reference's rule, so greedy streams agree token for token.
* ``top_k_top_p_mask`` is the reference's row-wise support mask: one
  stable descending sort serves both top-k and nucleus (top-p) truncation.
* Rows with temperature > 0 draw ``jax.random.categorical(fold_in(
  PRNGKey(seed), i), logits / T)`` bit for bit in its random bits: a torch
  port of threefry-2x32 (``PRNGKey``, ``fold_in`` and the partitionable
  ``random_bits``, whose 32-bit word is ``bits1 ^ bits2`` of
  threefry2x32(key, (0, iota)) — JAX's default since
  ``jax_threefry_partitionable``), then ``uniform(minval=tiny, maxval=1)``,
  Gumbel noise ``-log(-log(u))`` and ``argmax(scaled + gumbel)``, with i
  the request's generated-token index. Bits and uniforms equal JAX's
  exactly; ``log`` may differ by an ulp. The draw is position-addressed
  and touches no shared generator state, so a request's tokens are a
  function of (params, prompt, SamplingParams) only.

The draw runs in eager PyTorch on int64 tensors holding 32-bit words
(a few hundred small launches over the vocabulary); a dispatch with no
row above temperature 0 skips it (``draw=False``), which is exact because
greedy rows never read it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) as ``jax._src.prng._threefry2x32_lowering``;
    every operand an int64 tensor of 32-bit words, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def request_keys(seeds: torch.Tensor,
                 indices: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_in(PRNGKey(seed), i)`` per row: the key words (k1, k2), each
    (B,) int64. ``PRNGKey`` of a 32-bit seed is (0, seed); ``fold_in``
    hashes the count (0, i) under it."""
    s = seeds.to(torch.int64) & _M32
    i = indices.to(torch.int64) & _M32
    return threefry2x32(torch.zeros_like(s), s, torch.zeros_like(i), i)


def random_bits(keys: Tuple[torch.Tensor, torch.Tensor],
                vocab: int) -> torch.Tensor:
    """``jax.random.bits(key, (vocab,))`` per row, (B, V) int64: the
    partitionable form, threefry2x32 of the 64-bit iota split in words."""
    k1, k2 = keys
    lo = torch.arange(vocab, dtype=torch.int64, device=k1.device)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(lo), lo)
    return b1 ^ b2


def uniform(keys: Tuple[torch.Tensor, torch.Tensor],
            vocab: int) -> torch.Tensor:
    """``jax.random.uniform(key, (vocab,), minval=tiny, maxval=1.0)`` per
    row, (B, V) f32: the top 23 bits as the mantissa of a float in [1, 2),
    minus one, times ``maxval - minval`` (1.0 in f32), plus minval, floored
    at minval — so 0 becomes the smallest normal float."""
    bits = (random_bits(keys, vocab) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats + _F32_TINY, min=_F32_TINY)


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
                              top_p: Optional[torch.Tensor] = None,
                              draw: bool = True) -> torch.Tensor:
    """logits (B, V); seeds (B,) request seeds (32-bit); indices (B,)
    generated-token index per row; temperatures (B,) -> tokens (B,) int32.

    ``draw=False`` promises that no row has temperature > 0: the draw is
    skipped and every row takes its argmax (what the full path returns for
    such rows)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not draw:
        return greedy
    t = torch.clamp(temperatures.to(torch.float32), min=1e-6)[:, None]
    scaled = logits.to(torch.float32) / t
    if top_k is not None or top_p is not None:
        keep = top_k_top_p_mask(scaled, top_k, top_p)
        scaled = torch.where(keep, scaled, float("-inf"))
    u = uniform(request_keys(seeds, indices), logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)
    return torch.where(temperatures <= 0.0, greedy, sampled)
