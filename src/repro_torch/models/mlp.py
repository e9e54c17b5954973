"""Feed-forward variants: SwiGLU (llama/qwen/phi), GeGLU (gemma), GELU."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.common import Dense


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, mlp_type: str, *,
                 dtype=torch.float32, device="cpu"):
        super().__init__()
        if mlp_type not in ("swiglu", "geglu", "gelu"):
            raise ValueError(mlp_type)
        self.mlp_type = mlp_type
        self.wi = Dense(d_model, d_ff, dtype=dtype, device=device)
        self.wg = (Dense(d_model, d_ff, dtype=dtype, device=device)
                   if mlp_type != "gelu" else None)
        self.wo = Dense(d_ff, d_model, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mlp_type == "swiglu":
            h = nn.functional.silu(self.wg(x)) * self.wi(x)
        elif self.mlp_type == "geglu":
            h = nn.functional.gelu(self.wg(x), approximate="tanh") * self.wi(x)
        else:
            h = nn.functional.gelu(self.wi(x), approximate="tanh")
        return self.wo(h)
