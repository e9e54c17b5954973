"""Int8 gradient compression with error feedback (the reference's
``repro.optim.compress``, over flat lists of tensors).

Gradients are quantized to int8 with a per-tensor scale, and the
quantization residual is carried to the next step (error feedback):

    err = init_error_feedback(params)
    grads, err = compress_decompress(grads, err)
    opt.update(grads, state, params)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# f32(1/127): the reference's ``max|x| / 127.0`` runs inside its jitted
# train step, where XLA rewrites the division by a constant as a multiply
# by its f32 reciprocal
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def _q8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)) * _INV127, min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error_feedback(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


@torch.no_grad()
def compress_decompress(grads: Sequence[torch.Tensor],
                        err: Sequence[torch.Tensor]
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """(the int8-round-tripped gradients in f32, the new error state)."""
    deq, new_err = [], []
    for g, e in zip(grads, err):
        gf = g.to(torch.float32) + e
        q, scale = _q8(gf)
        d = q.to(torch.float32) * scale
        deq.append(d)
        new_err.append(gf - d)
    return deq, new_err
