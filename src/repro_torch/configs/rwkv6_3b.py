"""rwkv6-3b — Finch, attention-free data-dependent-decay SSM [arXiv:2404.05892; hf]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,            # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    supports_long_context=True,   # O(T) recurrence → long_500k runs
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=512, rwkv_head_dim=16, param_dtype="float32",
    activation_dtype="float32", remat="none", q_chunk=16,
)
