"""recurrentgemma-2b — Griffin: 2× RG-LRU : 1 local-attn, kv=1
[arXiv:2402.19427; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="geglu",
    block_pattern=("rglru+mlp", "rglru+mlp", "local+mlp"),
    window=2048,
    rglru_width=2560,
    rglru_blocks=10,
    conv_width=4,
    supports_long_context=True,    # O(1) state for 2/3 layers, ring for attn
)

SMOKE = CONFIG.scaled(
    n_layers=5,    # one period (3) + remainder (2 rglru)
    d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=512, window=8, rglru_width=64, rglru_blocks=4,
    param_dtype="float32", activation_dtype="float32", remat="none", q_chunk=16,
)
