"""Meta-device stand-ins for every model input of the dry run: shapes and
dtypes, no storage (the reference's ``ShapeDtypeStruct`` specs).

``batch_specs(cfg, shape_name)`` and ``decode_state_specs`` cover the four
shapes of ``configs.SHAPES``:

  train_4k     {"tokens"/"embeddings", "labels"}           (loss_fn)
  prefill_32k  {"tokens"/"embeddings"}                     (prefill)
  decode_32k   (state, tokens): one new token, 32k cache   (decode_step)
  long_500k    (state, tokens): one new token, 512k cache  (decode_step)

Stub-frontend archs (``embed_inputs`` False) take (B, S, d_model) frame or
patch embeddings instead of token ids. ``params_specs`` is the port's
``Transformer`` on the meta device; ``quantized_params_specs`` gives every
layer that ``quantize_tree`` would quantize its planes and scales as meta
tensors, shaped from the layer's d_in, d_out and G, without running the
quantizer.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.device import dtype_of

META = torch.device("meta")


def batch_specs(cfg, shape_name: str, rows: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Train/prefill batch stand-ins; ``rows`` overrides the batch."""
    info = SHAPES[shape_name]
    b, s = rows or info["global_batch"], info["seq_len"]
    if cfg.embed_inputs:
        batch = {"tokens": torch.empty((b, s), dtype=torch.int32,
                                       device=META)}
    else:
        batch = {"embeddings": torch.empty(
            (b, s, cfg.d_model), dtype=dtype_of(cfg.activation_dtype),
            device=META)}
    if info["kind"] == "train":
        batch["labels"] = torch.empty((b, s), dtype=torch.int32, device=META)
    return batch


def decode_state_specs(cfg, shape_name: str, rows: Optional[int] = None
                       ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """(state, tokens) stand-ins of one decode step at the shape's cache
    capacity; ``rows`` overrides the batch."""
    from repro_torch.models.transformer import init_decode_state

    info = SHAPES[shape_name]
    if info["kind"] != "decode":
        raise ValueError(f"{shape_name} is a {info['kind']} shape")
    b, s = rows or info["global_batch"], info["seq_len"]
    state = init_decode_state(cfg, b, s, device=META)
    if cfg.embed_inputs:
        tokens = torch.empty((b,), dtype=torch.int32, device=META)
    else:
        tokens = torch.empty((b, cfg.d_model),
                             dtype=dtype_of(cfg.activation_dtype),
                             device=META)
    return state, tokens


def params_specs(cfg):
    """The port's model of ``cfg`` on the meta device (parameter dtype)."""
    from repro_torch.models.transformer import Transformer

    return Transformer(cfg, dtype=dtype_of(cfg.param_dtype), device=META)


def quantized_params_specs(cfg, group_size: Optional[int] = None):
    """The meta model with every weight ``quantize_tree`` would quantize
    (``default_predicate``) replaced by planes (…, d_out, d_in // 4) uint8
    and scales (…, d_out, d_in // G, 2) f32."""
    from repro_torch.core.ptqtp import PTQTPConfig
    from repro_torch.core.quantize_model import (QuantizedKernel,
                                                 default_predicate)

    g = group_size or PTQTPConfig().group_size
    model = params_specs(cfg)
    for name, module in model.named_modules():
        weight = getattr(module, "weight", None)
        if (not hasattr(module, "set_quantized") or weight is None
                or not default_predicate(f"{name}.weight", weight, g)):
            continue
        *lead, d_out, d_in = weight.shape
        plane = torch.empty((*lead, d_out, d_in // 4), dtype=torch.uint8,
                            device=META)
        module.set_quantized(QuantizedKernel(
            plane, torch.empty_like(plane),
            torch.empty((*lead, d_out, d_in // g, 2), dtype=torch.float32,
                        device=META), d_in, d_out, g))
    return model
