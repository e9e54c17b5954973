"""gemma3-27b — 5 local : 1 global GQA, 262k vocab [hf:google/gemma-3-1b-pt; unverified]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    mlp_type="geglu",
    block_pattern=("local+mlp",) * 5 + ("attn+mlp",),   # 5:1 local:global
    window=1024,
    rope_theta=1e6,
    microbatches=4,
    # only 1/6 layers carry a full-context KV cache; local layers hold a
    # 1024-slot ring → long_500k decode runs (DESIGN.md §4)
    supports_long_context=True,
)

SMOKE = CONFIG.scaled(
    n_layers=8,   # one scanned period (6) + remainder (2 local)
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512, window=8,
    param_dtype="float32", activation_dtype="float32", remat="none",
    q_chunk=16, microbatches=1,
)
