"""Model configuration schema (a copy of the reference package's): the
configs, the dry run's input shapes ``SHAPES`` and the analytic parameter
counts ``ModelConfig.param_counts`` (MODEL_FLOPS = 6·N·D).

A model is a block pattern: an optional prefix, a repeating period and an
automatic remainder. The port runs ``"attn+mlp"``, ``"local+mlp"``,
``"attn+moe"``, ``"rglru+mlp"`` and ``"rwkv"`` blocks; other kinds are
carried as data and rejected when a model is built.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the dry run's four input shapes (``launch/specs.py``)
SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}


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

    def param_counts(self):
        """(total_params, active_params) analytic counts: the reference's
        arithmetic (a MoE layer's active count takes its top-k experts)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlps = {"swiglu": 3, "geglu": 3, "gelu": 2}[self.mlp_type]
        mlp = mlps * d * self.d_ff
        rwkv = 5 * d * d + d * self.d_ff * 2 + d * d  # time (5 proj) + channel
        rg = self.rglru_width or d
        nb = self.rglru_blocks or 1
        rglru = 2 * d * rg + rg * d + 2 * nb * (rg // nb) ** 2 + 4 * rg

        total = active = 0
        for kind in self.layer_kinds:
            if kind == "rwkv":
                total += rwkv
                active += rwkv
            elif kind.startswith("rglru"):
                total += rglru + mlp
                active += rglru + mlp
            else:
                total += attn
                active += attn
                if kind.endswith("moe"):
                    m = self.moe
                    e_p = 3 * d * m.d_expert
                    total += m.n_experts * e_p + d * m.n_experts
                    active += m.top_k * e_p + d * m.n_experts
                    if m.n_shared:
                        total += 3 * d * m.n_shared * m.d_expert
                        active += 3 * d * m.n_shared * m.d_expert
                else:
                    total += mlp
                    active += mlp
        emb = self.vocab_size * d
        total += emb * 2  # embed + lm_head
        active += emb * 2
        return total, active
