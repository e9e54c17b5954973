"""Model quantization: walk a module tree, quantize every linear weight.

The paper's deployment recipe ("all linear layers were quantized", Sec.
4.1): every dense weight becomes a ``QuantizedKernel`` (two packed
trit-planes + group scales); embeddings, norms and biases stay floating
point. The walk needs no architecture knowledge: it visits every module
that carries a dense ``weight`` and can take a quantized one
(``set_quantized``), and the predicate decides by path and shape.

Weights are stored output-major, ``(d_out, d_in)`` as in ``torch.nn.Linear``,
which is already the quantizer's layout (rows = outputs, groups along the
contraction dim), so no transpose happens here. A MoE layer's expert stack
``(E, d_out, d_in)`` is quantized into stacked planes by one stacked
quantizer call, each expert stopping on its own (the reference vmaps its
quantizer over the leading axes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import ptqtp
from repro_torch.core.packing import (pack_trits, ptqtp_weight_bytes,
                                      unpack_trits)

EXCLUDE_SUBSTRINGS = ("embed", "router", "norm", "decay", "lora", "conv", "rglru")

# weights per stacked quantizer call (an expert stack is quantized at once,
# in pieces of at most this many weights: ~1 GiB per f32 working tensor)
_STACK_ELEMS = 1 << 28


@dataclasses.dataclass
class QuantizedKernel:
    """PTQTP replacement of a dense weight of logical shape (d_in, d_out).

      t1p, t2p : (..., d_out, d_in // 4) uint8 packed trit-planes
      alpha    : (..., d_out, d_in // G, 2) f32 group scales

    with the weight's leading axes (an expert stack's E) in front.
    """

    t1p: torch.Tensor
    t2p: torch.Tensor
    alpha: torch.Tensor
    d_in: int
    d_out: int
    group_size: int


def quantize_kernel(weight: torch.Tensor,
                    cfg: ptqtp.PTQTPConfig) -> QuantizedKernel:
    """Quantize a (..., d_out, d_in) weight on the device that holds it,
    matrix by matrix over the leading axes (each stops on its own, as the
    reference's vmapped quantizer)."""
    *lead, d_out, d_in = weight.shape
    if lead:
        flat = weight.reshape(-1, d_out, d_in)
        per = max(1, _STACK_ELEMS // max(d_out * d_in, 1))
        parts = [ptqtp.ptqtp_quantize_stack(flat[i:i + per], cfg)
                 for i in range(0, flat.shape[0], per)]
        t1p, t2p = (torch.cat([pack_trits(getattr(q, f).reshape(-1, d_in))
                               .reshape(-1, d_out, d_in // 4)
                               for q in parts]).reshape(
                                   tuple(lead) + (d_out, d_in // 4))
                    for f in ("t1", "t2"))
        alpha = torch.cat([q.alpha for q in parts]).reshape(
            tuple(lead) + parts[0].alpha.shape[1:])
        return QuantizedKernel(t1p, t2p, alpha, int(d_in), int(d_out),
                               cfg.group_size)
    q = ptqtp.ptqtp_quantize(weight, cfg)
    return QuantizedKernel(pack_trits(q.t1), pack_trits(q.t2), q.alpha,
                           int(d_in), int(d_out), cfg.group_size)


def dequantize_kernel(qk: QuantizedKernel, dtype=torch.float32) -> torch.Tensor:
    """Back to a dense (..., d_out, d_in) weight (tests and library
    yardsticks)."""
    if qk.t1p.dim() > 2:
        lead = tuple(qk.t1p.shape[:-2])
        flat = [dequantize_kernel(QuantizedKernel(
            a, b, c, qk.d_in, qk.d_out, qk.group_size), dtype)
            for a, b, c in zip(qk.t1p.reshape((-1,) + qk.t1p.shape[-2:]),
                               qk.t2p.reshape((-1,) + qk.t2p.shape[-2:]),
                               qk.alpha.reshape((-1,) + qk.alpha.shape[-3:]))]
        return torch.stack(flat).reshape(lead + flat[0].shape)
    return ptqtp.ptqtp_dequantize(ptqtp.QuantizedTensor(
        unpack_trits(qk.t1p), unpack_trits(qk.t2p), qk.alpha, qk.group_size,
        0), dtype)


def default_predicate(path: str, leaf: Any, group_size: int) -> bool:
    """The reference's rule on the port's layout: a (..., d_out, d_in)
    weight of 2-4 dims outside embeddings, routers and norms, d_in
    divisible by G and 4."""
    if not isinstance(leaf, torch.Tensor) or not 2 <= leaf.dim() <= 4:
        return False
    lowered = path.lower()
    if any(s in lowered for s in EXCLUDE_SUBSTRINGS):
        return False
    if not lowered.endswith("weight"):
        return False
    d_in = leaf.shape[-1]
    return d_in % group_size == 0 and d_in % 4 == 0


def quantize_tree(
    model: torch.nn.Module,
    cfg: Optional[ptqtp.PTQTPConfig] = None,
    predicate: Optional[Callable[[str, Any, int], bool]] = None,
) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Quantize every matching dense weight of ``model`` in place.

    The floating-point weight of each quantized layer is released as soon
    as its planes exist, so peak memory stays near one copy of the model.
    Returns (model, report); report maps path -> byte counts and
    report["__total__"] aggregates them, as in the reference.
    """
    cfg = cfg or ptqtp.PTQTPConfig()
    predicate = predicate or default_predicate
    report: Dict[str, Any] = {}
    tot_before = tot_after = tot_eq13 = 0
    for name, module in model.named_modules():
        weight = getattr(module, "weight", None)
        if not hasattr(module, "set_quantized") or weight is None:
            continue
        path = f"{name}.weight"
        if not predicate(path, weight, cfg.group_size):
            continue
        with torch.no_grad():
            qk = quantize_kernel(weight, cfg)
        module.set_quantized(qk)
        before = weight.numel() * 2  # vs fp16 storage
        # leading axes (an expert stack) multiply the per-matrix bytes
        lead = weight[..., 0, 0].numel()
        layout = tuple(weight.shape[-2:])  # (d_out, d_in)
        after = lead * ptqtp_weight_bytes(layout, cfg.group_size,
                                          scale_bytes=qk.alpha.element_size())
        after_eq13 = lead * ptqtp_weight_bytes(layout, cfg.group_size)
        report[path] = {"before_bytes": before, "after_bytes": after,
                        "after_bytes_eq13": after_eq13,
                        "shape": tuple(weight.shape[:-2])
                        + (qk.d_in, qk.d_out)}
        tot_before += before
        tot_after += after
        tot_eq13 += after_eq13
        del weight
    report["__total__"] = {
        "before_bytes": tot_before,
        "after_bytes": tot_after,
        "after_bytes_eq13": tot_eq13,
        "compression": (tot_before / tot_after) if tot_after else float("nan"),
        "compression_eq13":
            (tot_before / tot_eq13) if tot_eq13 else float("nan"),
        "n_quantized": len(report),
    }
    return model, report
