"""AdamW with a configurable moment dtype and global-norm gradient clipping:
the reference's ``repro.optim.adamw`` written out in PyTorch (not
``torch.optim.AdamW``, which is another function: it decays every leaf,
clips nothing and keeps no f32 copy of the step).

  opt = AdamW(lr=..., moment_dtype=torch.bfloat16)
  state = opt.init(params)
  opt.update(grads, state, params)      # params and state in place

``params``, ``grads`` and the moments are flat lists of tensors in one
order (``list(model.parameters())``). The arithmetic is the reference's,
in f32: clip by the global norm of the gradients, the bias-corrected
moments, decay of leaves with ndim >= 2 only, each new leaf rounded once
to its dtype and the moments to ``moment_dtype``. The port updates in
place where the reference returns new trees.

"ndim" is the leaf's in the reference's tree, where the layers of the
scanned ``blocks`` are stacked: a block's norm scales and biases are
(L, d) there and decay, the prefix's and suffix's (d,) do not. The train
step passes each parameter's (``convert.reference_ndims``); without it a
tensor's own ndim counts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(t.to(torch.float32))) for t in tensors]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: Any = torch.float32

    def init(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros(p.shape, dtype=self.moment_dtype,  # noqa: E731
                                      device=p.device)
        device = params[0].device if len(params) else "cpu"
        return {"m": [zeros(p) for p in params],
                "v": [zeros(p) for p in params],
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor],
               ndims: Optional[Sequence[int]] = None) -> None:
        """One step: ``params``, ``state["m"]``, ``state["v"]`` and
        ``state["count"]`` updated in place. ``ndims``: each parameter's
        ndim in the reference's tree (None: its own)."""
        if ndims is None:
            ndims = [p.dim() for p in params]
        count = state["count"] + 1
        lr = self.lr(count) if callable(self.lr) else self.lr

        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / torch.clamp(gn, min=1e-9),
                                max=1.0)
            grads = [g * scale.to(g.dtype) for g in grads]

        b1c = 1.0 - self.b1 ** count.to(torch.float32)
        b2c = 1.0 - self.b2 ** count.to(torch.float32)
        for p, g, m, v, nd in zip(params, grads, state["m"], state["v"],
                                  ndims):
            gf = g.to(torch.float32)
            mf = self.b1 * m.to(torch.float32) + (1 - self.b1) * gf
            vf = self.b2 * v.to(torch.float32) + (1 - self.b2) * gf * gf
            mhat = mf / b1c
            vhat = vf / b2c
            step = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay and nd >= 2:  # decay matrices only
                step = step + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
            m.copy_(mf.to(m.dtype))
            v.copy_(vf.to(v.dtype))
        state["count"].copy_(count)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup then cosine decay to floor·peak (f32, as the
    reference's)."""

    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        warm = peak_lr * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(c < warmup, warm, cos)

    return lr
