"""Decoder LM of the reference's block kinds: ``attn+mlp`` (dense GQA:
llama/qwen-style), ``local+mlp`` (sliding-window attention: gemma3's and
recurrentgemma's local layers), ``attn+moe`` (a mixture-of-experts FFN:
deepseek-moe, grok-1), ``rglru+mlp`` (recurrentgemma's RG-LRU mixer) and
``rwkv`` (rwkv6's time and channel mixes).

The reference stacks layers for ``lax.scan``; here they are a
``ModuleList`` and a Python loop. Other block kinds raise
``NotImplementedError``.

Model API:
  init_params(cfg, generator=None, device="cuda")  -> Transformer
  forward(model, cfg, tokens)                      -> logits (B, S, V)
  init_decode_state(cfg, batch, capacity, device, kv_spec=None) -> state
  prefill(model, cfg, tokens, capacity, chunk=None) -> (logits (B, V), state)
  prefill_chunk(model, cfg, state, tokens, lengths) -> (logits (B, V), state)
  decode_step(model, cfg, state, tokens, active)   -> (logits (B, V), state)

``tokens`` are token ids, (B, S) or (B,) for ``decode_step``. A
stub-frontend arch (``cfg.embed_inputs`` False: musicgen-large,
phi-3-vision-4.2b) has no ``embed`` parameter and takes the frontend's
float embeddings there instead, (B, S, D) or (B, D), cast to the
activation dtype: the reference's ``batch["embeddings"]`` and its
``decode_step`` on (B, D).

The serving functions update ``state`` in place and return it: no tensor of
the state is ever rebound, so a CUDA graph that captured a dispatch reads
and writes the same storage at every replay. A recurrent layer's cache is
its per-row state (rwkv: ``x_time``, ``wkv``, ``x_chan``; rglru: ``h``,
``conv``); a chunk's right padding and a decode step's inactive rows
(length 0) leave it as it was, as the reference's masks and
``_freeze_rows`` do.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import dtype_of, resolve_device
from repro_torch.kernels.rms_norm.ops import add_rms_norm
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import Dense, RMSNorm, rope_tables
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import ExpertDense, MoE, moe_forward
from repro_torch.models.rglru import RGLRU, rglru_forward
from repro_torch.models.rwkv6 import (RWKVChannel, RWKVTime,
                                      rwkv_channel_forward, rwkv_time_forward)

SUPPORTED_KINDS = ("attn+mlp", "local+mlp", "attn+moe", "rglru+mlp", "rwkv")


def _check_kinds(cfg) -> None:
    for kind in cfg.layer_kinds:
        if kind not in SUPPORTED_KINDS:
            raise NotImplementedError(
                f"block kind {kind!r} ({cfg.name}) is not ported yet; the "
                f"port runs {SUPPORTED_KINDS}")


def _window(kind: str, cfg) -> Optional[int]:
    return cfg.window if kind.startswith("local") else None


def is_recurrent(kind: str) -> bool:
    return kind == "rwkv" or kind.startswith("rglru")


def has_attention(cfg) -> bool:
    return not all(is_recurrent(k) for k in cfg.layer_kinds)


class Block(nn.Module):
    """Attention, then an MLP or (``*+moe`` kinds) a mixture of experts; an
    RG-LRU, then an MLP (``rglru+mlp``); or rwkv6's time mix, then its
    channel mix (``rwkv``), with the reference's norm names."""

    def __init__(self, cfg, kind: str, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.mlp = self.moe = None
        if kind == "rwkv":
            self.time_norm = RMSNorm(d, dtype=dtype, device=device)
            self.time = RWKVTime(d, cfg.rwkv_head_dim, dtype=dtype,
                                 device=device)
            self.chan_norm = RMSNorm(d, dtype=dtype, device=device)
            self.chan = RWKVChannel(d, cfg.d_ff, dtype=dtype, device=device)
            return
        if kind.startswith("rglru"):
            self.rec_norm = RMSNorm(d, dtype=dtype, device=device)
            self.rec = RGLRU(d, cfg.rglru_width or d,
                             cfg.rglru_blocks or cfg.n_heads, cfg.conv_width,
                             dtype=dtype, device=device)
            self.mlp_norm = RMSNorm(d, dtype=dtype, device=device)
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dtype=dtype,
                           device=device)
            return
        self.attn_norm = RMSNorm(d, dtype=dtype, device=device)
        self.attn = attn_mod.Attention(cfg, dtype=dtype, device=device)
        self.mlp_norm = RMSNorm(d, dtype=dtype, device=device)
        if kind.endswith("+moe"):
            self.moe = MoE(d, cfg.moe, cfg.mlp_type, dtype=dtype,
                           device=device)
        else:
            self.mlp = MLP(d, cfg.d_ff, cfg.mlp_type, dtype=dtype,
                           device=device)


class Transformer(nn.Module):
    def __init__(self, cfg, *, dtype, device):
        super().__init__()
        _check_kinds(cfg)
        self.embed = (nn.Parameter(
            torch.empty((cfg.vocab_size, cfg.d_model), dtype=dtype,
                        device=device), requires_grad=False)
            if cfg.embed_inputs else None)
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

    if model.embed is not None:
        model.embed.copy_(normal(model.embed.shape, 0.02))
    for module in model.modules():
        if isinstance(module, Dense):
            module.weight.copy_(normal(module.weight.shape,
                                       1.0 / module.d_in ** 0.5))
        elif isinstance(module, ExpertDense):
            for w in module.weight:
                w.copy_(normal(w.shape, 1.0 / module.d_in ** 0.5))
        elif isinstance(module, (RGLRU, RWKVTime)):
            module.init_random(normal)
    return model


def _embed(model: Transformer, cfg, tokens):
    """Token ids through the embedding, or (stub frontend) the given float
    embeddings, in the activation dtype."""
    adt = dtype_of(cfg.activation_dtype)
    if cfg.embed_inputs:
        return model.embed[tokens.long()].to(adt)
    if not tokens.is_floating_point() or tokens.shape[-1] != cfg.d_model:
        raise TypeError(f"{cfg.name} has a stub frontend: it takes float "
                        f"embeddings (..., {cfg.d_model}), got "
                        f"{tokens.dtype} {tuple(tokens.shape)}")
    return tokens.to(adt).contiguous()


def _add_norm(norm: RMSNorm, x, delta, eps):
    """The residual stream after its pending ``delta`` and the norm of it:
    (x + delta, norm(x + delta)), one ``add_rms_norm`` launch on the card;
    with no delta (after the embedding) (x, norm(x))."""
    if delta is None:
        return x, norm(x, eps)
    return add_rms_norm(norm.scale, x, delta, eps)


def _mlp_block(block: Block, cfg, x, y, valid=None):
    """The FFN half of a block on the residual stream x + y: returns (x +
    y, the FFN's output of its normed sum), the stream and its next pending
    delta. ``valid`` marks a prefill chunk's real tokens for the MoE
    (padding never takes capacity); decode passes none, as the reference's
    ``_block_decode``."""
    x, h = _add_norm(block.mlp_norm, x, y, cfg.norm_eps)
    if block.moe is not None:
        return x, moe_forward(block.moe, cfg.moe, h, valid)
    return x, block.mlp(h)


def _recurrent_block(kind: str, block: Block, cfg, cache, x, delta, lengths):
    """A recurrent block over a right-padded chunk whose input is x + delta
    (B, S, D) (delta None: x): row b's first ``lengths[b]`` steps are real.
    Its cache advances in place. Returns (its input, the pending delta that
    makes its output), as ``_mlp_block``."""
    eps = cfg.norm_eps
    if kind == "rwkv":
        x, h = _add_norm(block.time_norm, x, delta, eps)
        y = rwkv_time_forward(block.time, h, cache["x_time"], cache["wkv"],
                              lengths)
        x, h = _add_norm(block.chan_norm, x, y, eps)
        return x, rwkv_channel_forward(block.chan, h, cache["x_chan"],
                                       lengths)
    x, h = _add_norm(block.rec_norm, x, delta, eps)
    y = rglru_forward(block.rec, h, cache["h"], cache["conv"], lengths)
    return _mlp_block(block, cfg, x, y)


def _recurrent_cache_init(kind: str, cfg, batch: int, dtype, device
                          ) -> Dict[str, torch.Tensor]:
    """Zeroed per-row state of a recurrent layer (the reference's
    ``_block_cache_init``)."""
    d = cfg.d_model
    if kind == "rwkv":
        h, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        return {"x_time": torch.zeros((batch, d), dtype=dtype, device=device),
                "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                                   device=device),
                "x_chan": torch.zeros((batch, d), dtype=dtype, device=device)}
    r = cfg.rglru_width or d
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype,
                                device=device)}


@torch.no_grad()
def forward(model: Transformer, cfg, tokens) -> torch.Tensor:
    """Full-sequence forward. tokens (B, S) -> logits (B, S, V)."""
    x = _embed(model, cfg, tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    rope = (rope_tables(positions[None, :], cfg.head_dim, cfg.rope_theta)
            if has_attention(cfg) else None)
    full = torch.full((b,), s, dtype=torch.int32, device=x.device)
    delta = None  # the residual stream is x + delta (see decode_step)
    for kind, block in zip(cfg.layer_kinds, model.layers):
        if is_recurrent(kind):
            cache = _recurrent_cache_init(kind, cfg, b, x.dtype, x.device)
            x, delta = _recurrent_block(kind, block, cfg, cache, x, delta,
                                        full)
            continue
        x, h = _add_norm(block.attn_norm, x, delta, cfg.norm_eps)
        y = attn_mod.attention_forward(block.attn, cfg, h, positions, rope,
                                       window=_window(kind, cfg))
        x, delta = _mlp_block(block, cfg, x, y)
    _, h = _add_norm(model.final_norm, x, delta, cfg.norm_eps)
    return model.lm_head(h)


def _layer_cache(kind: str, cfg, batch: int, capacity: int, dtype, device):
    if is_recurrent(kind):
        return _recurrent_cache_init(kind, cfg, batch, dtype, device)
    return attn_mod.cache_init(cfg, batch, capacity, _window(kind, cfg),
                               dtype, device)


def init_decode_state(cfg, batch: int, capacity: int, device="cuda",
                      kv_spec: Optional[Dict[str, int]] = None
                      ) -> Dict[str, Any]:
    """Zeroed decode state: per-row positions and one cache per layer.

    ``kv_spec = {"page_size": ps, "max_pages": n}`` selects the paged
    layout for the attention layers: the state then also holds ``pool``
    (each ``pages_*`` leaf stacked (n_attention_layers, P, ps, ...), as the
    reference stacks its layers) and one ``table`` (B, n_pages) int32 that
    every attention layer reads; each attention layer's cache holds views of
    them. A recurrent layer keeps its per-row state in either layout (the
    reference's paged state does too). None keeps a ring per attention
    layer."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    adt = dtype_of(cfg.activation_dtype)
    state: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if kv_spec is None:
        state["layers"] = [_layer_cache(k, cfg, batch, capacity, adt, dev)
                           for k in cfg.layer_kinds]
        return state
    ps, max_pages = kv_spec["page_size"], kv_spec["max_pages"]
    attention = [k for k in cfg.layer_kinds if not is_recurrent(k)]
    windows = [_window(k, cfg) for k in attention]
    narrow = [w for w in windows if w is not None and w < capacity]
    pool = attn_mod.paged_pool(cfg, len(attention), capacity,
                               narrow[0] if narrow else None, adt, dev,
                               page_size=ps, max_pages=max_pages)
    table = torch.zeros((batch, capacity // ps), dtype=torch.int32,
                        device=dev)
    state["pool"] = pool
    state["table"] = table
    layers, i = [], 0
    for kind in cfg.layer_kinds:
        if is_recurrent(kind):
            layers.append(_recurrent_cache_init(kind, cfg, batch, adt, dev))
            continue
        layers.append(dict({name: leaf[i] for name, leaf in pool.items()},
                           table=table))
        i += 1
    state["layers"] = layers
    return state


@torch.no_grad()
def prefill(model: Transformer, cfg, tokens, capacity: int,
            chunk: Optional[int] = None, state=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process whole prompts into a fresh ring state (the reference's
    ``prefill``). tokens (B, S) (or embeddings (B, S, D)), every row S
    tokens with S <= capacity.
    Returns (logits at the last position (B, V), state at position S).

    The reference computes this in one full-sequence pass; here the prompt
    runs through ``prefill_chunk`` in chunks of ``chunk`` tokens (None: one
    chunk of S), the same causal attention in another summation order. With
    ``chunk`` the engine's ``prefill_chunk`` every row equals the bucketed
    engine's rows bit for bit on the card (its kernels are batch-invariant
    and its chunk boundaries the same). ``state`` (B rows, ring layout) is
    reset in place and reused instead of a new one."""
    b, s = tokens.shape[:2]
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
    """Empty a ring decode state in place: positions 0, ring slots -1, KV,
    scales and recurrent states 0."""
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
    Recurrent layers take ``lengths`` as the reference's ``valid`` mask
    (steps past a row's length leave its state as it was); the MoE takes
    ``valid`` itself. Returns (logits at each row's last valid token (B,
    V), state)."""
    x = _embed(model, cfg, tokens)
    b, L, _ = x.shape
    lengths = lengths.to(torch.int32)
    pos0 = state["pos"]
    positions = (pos0[:, None]
                 + torch.arange(L, dtype=torch.int32, device=x.device)[None])
    valid = (torch.arange(L, device=x.device)[None, :] < lengths[:, None]
             if cfg.moe is not None else None)
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if has_attention(cfg) else None)
    delta = None  # the residual stream is x + delta (see decode_step)
    for kind, block, cache in zip(cfg.layer_kinds, model.layers,
                                  state["layers"]):
        if is_recurrent(kind):
            x, delta = _recurrent_block(kind, block, cfg, cache, x, delta,
                                        lengths)
            continue
        x, h = _add_norm(block.attn_norm, x, delta, cfg.norm_eps)
        y, _ = attn_mod.attention_prefill_chunk(
            block.attn, cfg, cache, h, positions, lengths, rope,
            window=_window(kind, cfg))
        x, delta = _mlp_block(block, cfg, x, y, valid)
    _, x = _add_norm(model.final_norm, x, delta, cfg.norm_eps)
    idx = torch.clamp(lengths - 1, min=0).long()
    x_last = x[torch.arange(b, device=x.device), idx]
    pos0.add_(lengths)
    return model.lm_head(x_last), state


@torch.no_grad()
def decode_step(model: Transformer, cfg, state, tokens,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step. tokens (B,) int; rows with active=False are frozen:
    their position and cache pass through unchanged (a recurrent layer runs
    the step with length 0).

    The residual stream is carried as x and a pending delta (the last
    block's attention, FFN or mixer output): each norm that follows a
    residual add takes both (``add_rms_norm``, one launch on the card), as
    ``prefill_chunk`` and ``forward`` do; the sums are the reference's."""
    x = _embed(model, cfg, tokens)
    pos = state["pos"]
    steps = (active.to(torch.int32) if active is not None
             else torch.ones_like(pos))
    rope = (rope_tables(pos, cfg.head_dim, cfg.rope_theta)
            if has_attention(cfg) else None)
    delta = None
    for kind, block, cache in zip(cfg.layer_kinds, model.layers,
                                  state["layers"]):
        if is_recurrent(kind):
            x, delta = _recurrent_block(
                kind, block, cfg, cache, x[:, None],
                None if delta is None else delta[:, None], steps)
            x, delta = x[:, 0], delta[:, 0]
            continue
        x, h = _add_norm(block.attn_norm, x, delta, cfg.norm_eps)
        y, _ = attn_mod.attention_decode(
            block.attn, cfg, cache, h, pos, rope, window=_window(kind, cfg),
            active=active)
        x, delta = _mlp_block(block, cfg, x, y)
    _, x = _add_norm(model.final_norm, x, delta, cfg.norm_eps)
    pos.add_(steps)
    return model.lm_head(x), state
