"""Model configuration schema (a copy of the reference package's, minus the
dry-run bookkeeping the port does not use).

A model is a block pattern: an optional prefix, a repeating period and an
automatic remainder. The port runs ``"attn+mlp"``, ``"local+mlp"``,
``"attn+moe"``, ``"rglru+mlp"`` and ``"rwkv"`` blocks; other kinds are
carried as data and rejected when a model is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    mlp_type: str = "swiglu"
    block_pattern: Tuple[str, ...] = ("attn+mlp",)
    prefix_pattern: Tuple[str, ...] = ()
    window: Optional[int] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    embed_inputs: bool = True
    moe: Optional[MoEConfig] = None
    rwkv_head_dim: int = 64
    rglru_width: Optional[int] = None
    rglru_blocks: Optional[int] = None
    conv_width: int = 4
    scan_layers: bool = True
    remat: str = "full"
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8
    attn_backend: str = "auto"
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    optimizer_dtype: str = "float32"
    microbatches: int = 1
    q_chunk: int = 1024
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        return (self.n_layers - len(self.prefix_pattern)) // self.period

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        rem = (self.n_layers - len(self.prefix_pattern)) % self.period
        return self.block_pattern[:rem]

    @property
    def layer_kinds(self):
        """Flat list of all n_layers block kinds, in order."""
        full = list(self.prefix_pattern)
        full += list(self.block_pattern) * self.n_periods
        full += list(self.remainder_pattern)
        return full

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
