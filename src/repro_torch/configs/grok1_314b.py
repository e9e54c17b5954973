"""grok-1-314b — MoE 8 experts top-2, GQA kv=8 [hf:xai-org/grok-1; unverified]."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    block_pattern=("attn+moe",),
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, capacity_factor=1.25),
    microbatches=8,
    optimizer_dtype="bfloat16",
)

SMOKE = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, capacity_factor=-1.0),
    param_dtype="float32", activation_dtype="float32", remat="none",
    q_chunk=16, microbatches=1, optimizer_dtype="float32",
)
