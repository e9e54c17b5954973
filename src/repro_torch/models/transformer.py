"""Decoder LM of attention blocks: ``attn+mlp`` (dense GQA: llama/qwen-
style), ``local+mlp`` (sliding-window attention: gemma3's local layers) and
``attn+moe`` (a mixture-of-experts FFN: deepseek-moe, grok-1).

The reference stacks layers for ``lax.scan``; here they are a
``ModuleList`` and a Python loop. Other block kinds (the recurrent rglru
and rwkv mixers) raise ``NotImplementedError``.

Model API:
  init_params(cfg, generator=None, device="cuda")  -> Transformer
  forward(model, cfg, tokens)                      -> logits (B, S, V)
  init_decode_state(cfg, batch, capacity, device, kv_spec=None) -> state
  prefill(model, cfg, tokens, capacity, chunk=None) -> (logits (B, V), state)
  prefill_chunk(model, cfg, state, tokens, lengths) -> (logits (B, V), state)
  decode_step(model, cfg, state, tokens, active)   -> (logits (B, V), state)

The serving functions update ``state`` in place and return it: no tensor of
the state is ever rebound, so a CUDA graph that captured a dispatch reads
and writes the same storage at every replay.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import Dense, RMSNorm, rope_tables
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import ExpertDense, MoE, moe_forward

SUPPORTED_KINDS = ("attn+mlp", "local+mlp", "attn+moe")


def _check_kinds(cfg) -> None:
    for kind in cfg.layer_kinds:
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} ({cfg.name}) is not ported yet; the "
                f"port runs {SUPPORTED_KINDS}")


def _window(kind: str, cfg) -> Optional[int]:
    return cfg.window if kind.startswith("local") else None


class Block(nn.Module):
    """Attention, then an MLP or (``*+moe`` kinds) a mixture of experts."""

    def __init__(self, cfg, kind: str, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = RMSNorm(d, dtype=dtype, device=device)
        self.attn = attn_mod.Attention(cfg, dtype=dtype, device=device)
        self.mlp_norm = RMSNorm(d, dtype=dtype, device=device)
        if kind.endswith("+moe"):
            self.mlp = None
            self.moe = MoE(d, cfg.moe, cfg.mlp_type, dtype=dtype,
                           device=device)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dtype=dtype,
                           device=device)
            self.moe = None


class Transformer(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        _check_kinds(cfg)
        self.embed = nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device), requires_grad=False)
        self.layers = nn.ModuleList(
            Block(cfg, kind, dtype=dtype, device=device)
            for kind in cfg.layer_kinds)
        self.final_norm = RMSNorm(cfg.d_model, dtype=dtype, device=device)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, dtype=dtype,
                             device=device)


@torch.no_grad()
def init_params(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> Transformer:
    """Random init from ``generator`` (seeded by the caller), directly on
    ``device``: embedding N(0, 0.02²), dense weights (the f32 router and the
    expert stacks too) N(0, 1/d_in), biases 0, norm scales 1 — the
    reference's initializer, not its random bits. An expert stack is drawn
    one expert at a time (no f32 copy of the whole stack)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    model = Transformer(cfg, dtype=dtype, device=dev)

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    model.embed.copy_(normal(model.embed.shape, 0.02))
    for module in model.modules():
        if isinstance(module, Dense):
            module.weight.copy_(normal(module.weight.shape,
                                       1.0 / module.d_in ** 0.5))
        elif isinstance(module, ExpertDense):
            for w in module.weight:
                w.copy_(normal(w.shape, 1.0 / module.d_in ** 0.5))
    return model


def _embed(model: Transformer, cfg, tokens):
    return model.embed[tokens.long()].to(dtype_of(cfg.activation_dtype))


def _mlp_residual(block: Block, cfg, x, valid=None):
    """x + the block's FFN of its normed x. ``valid`` marks a prefill
    chunk's real tokens for the MoE (padding never takes capacity); decode
    passes none, as the reference's ``_block_decode``."""
    h = block.mlp_norm(x, cfg.norm_eps)
    if block.moe is not None:
        return x + moe_forward(block.moe, cfg.moe, h, valid)
    return x + block.mlp(h)


@torch.no_grad()
def forward(model: Transformer, cfg, tokens) -> torch.Tensor:
    """Full-sequence forward. tokens (B, S) -> logits (B, S, V)."""
    x = _embed(model, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    rope = rope_tables(positions[None, :], cfg.head_dim, cfg.rope_theta)
    for kind, block in zip(cfg.layer_kinds, model.layers):
        x = x + attn_mod.attention_forward(
            block.attn, cfg, block.attn_norm(x, cfg.norm_eps), positions,
            rope, window=_window(kind, cfg))
        x = _mlp_residual(block, cfg, x)
    return model.lm_head(model.final_norm(x, cfg.norm_eps))


def init_decode_state(cfg, batch: int, capacity: int, device="cuda",
                      kv_spec: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Any]:
    """Zeroed decode state: per-row positions and one cache per layer.

    ``kv_spec = {"page_size": ps, "max_pages": n}`` selects the paged
    layout for every layer: the state then also holds ``pool`` (each
    ``pages_*`` leaf stacked (n_layers, P, ps, ...), as the reference
    stacks its layers) and one ``table`` (B, n_pages) int32 that every
    layer reads; each layer's cache holds views of them. None keeps a ring
    per layer."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    adt = dtype_of(cfg.activation_dtype)
    state: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if kv_spec is None:
        state["layers"] = [
            attn_mod.cache_init(cfg, batch, capacity, _window(k, cfg), adt,
                                dev)
            for k in cfg.layer_kinds]
        return state
    ps, max_pages = kv_spec["page_size"], kv_spec["max_pages"]
    windows = [_window(k, cfg) for k in cfg.layer_kinds]
    narrow = [w for w in windows if w is not None and w < capacity]
    pool = attn_mod.paged_pool(cfg, cfg.n_layers, capacity,
                               narrow[0] if narrow else None, adt, dev,
                               page_size=ps, max_pages=max_pages)
    table = torch.zeros((batch, capacity // ps), dtype=torch.int32,
                        device=dev)
    state["pool"] = pool
    state["table"] = table
    state["layers"] = [
        dict({name: leaf[i] for name, leaf in pool.items()}, table=table)
        for i in range(cfg.n_layers)]
    return state


@torch.no_grad()
def prefill(model: Transformer, cfg, tokens, capacity: int,
            chunk: Optional[int] = None, state=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process whole prompts into a fresh ring state (the reference's
    ``prefill``). tokens (B, S), every row S tokens with S <= capacity.
    Returns (logits at the last position (B, V), state at position S).

    The reference computes this in one full-sequence pass; here the prompt
    runs through ``prefill_chunk`` in chunks of ``chunk`` tokens (None: one
    chunk of S), the same causal attention in another summation order. With
    ``chunk`` the engine's ``prefill_chunk`` every row equals the bucketed
    engine's rows bit for bit on the card (its kernels are batch-invariant
    and its chunk boundaries the same). ``state`` (B rows, ring layout) is
    reset in place and reused instead of a new one."""
    b, s = tokens.shape
    if not 0 < s <= capacity:
        raise ValueError(f"prompt length {s} must be in [1, {capacity}]")
    if state is None:
        state = init_decode_state(cfg, b, capacity, device=tokens.device)
    else:
        reset_decode_state(state)
    step = chunk or s
    for c0 in range(0, s, step):
        part = tokens[:, c0:c0 + step]
        lengths = torch.full((b,), part.shape[1], dtype=torch.int32,
                             device=tokens.device)
        logits, state = prefill_chunk(model, cfg, state, part, lengths)
    return logits, state


def reset_decode_state(state) -> None:
    """Empty a ring decode state in place: positions 0, ring slots -1, KV
    and scales 0."""
    state["pos"].zero_()
    for cache in state["layers"]:
        for name, buf in cache.items():
            buf.fill_(-1 if name == "pos" else 0)


@torch.no_grad()
def prefill_chunk(model: Transformer, cfg, state, tokens, lengths
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Padded-batch / chunked prefill.

    tokens (B, L) right-padded; lengths (B,) int32 — row r consumes
    positions ``state['pos'][r] .. + lengths[r] - 1`` (0 = no-op row).
    Returns (logits at each row's last valid token (B, V), state)."""
    x = _embed(model, cfg, tokens)
    b, L, _ = x.shape
    lengths = lengths.to(torch.int32)
    pos0 = state["pos"]
    positions = (pos0[:, None]
                 + torch.arange(L, dtype=torch.int32, device=x.device)[None])
    valid = (torch.arange(L, device=x.device)[None, :] < lengths[:, None]
             if cfg.moe is not None else None)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for kind, block, cache in zip(cfg.layer_kinds, model.layers,
                                  state["layers"]):
        y, _ = attn_mod.attention_prefill_chunk(
            block.attn, cfg, cache, block.attn_norm(x, cfg.norm_eps),
            positions, lengths, rope, window=_window(kind, cfg))
        x = _mlp_residual(block, cfg, x + y, valid)
    x = model.final_norm(x, cfg.norm_eps)
    idx = torch.clamp(lengths - 1, min=0).long()
    x_last = x[torch.arange(b, device=x.device), idx]
    pos0.add_(lengths)
    return model.lm_head(x_last), state


@torch.no_grad()
def decode_step(model: Transformer, cfg, state, tokens,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens (B,) int; rows with active=False are frozen:
    their position and cache pass through unchanged."""
    x = _embed(model, cfg, tokens)
    pos = state["pos"]
    rope = rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for kind, block, cache in zip(cfg.layer_kinds, model.layers,
                                  state["layers"]):
        y, _ = attn_mod.attention_decode(
            block.attn, cfg, cache, block.attn_norm(x, cfg.norm_eps), pos,
            rope, window=_window(kind, cfg), active=active)
        x = _mlp_residual(block, cfg, x + y)
    x = model.final_norm(x, cfg.norm_eps)
    pos.add_(active.to(torch.int32) if active is not None else 1)
    return model.lm_head(x), state
